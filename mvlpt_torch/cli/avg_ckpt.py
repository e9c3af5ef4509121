"""Average prompt checkpoints across seeds (the reference's
scripts/avg_ckpt.py:21-66): the tensor-wise mean of the seed-1/2/3 best
checkpoints into one model-best.pth.tar, the multitask init used for
transfer. The counterpart of ``mvlpt_tpu/cli/avg_ckpt.py``, with the same
flags and files.

Usage:
    python -m mvlpt_torch.cli.avg_ckpt --dirs <run_dir> [<run_dir> ...] \\
        --output-dir <dir> [--epoch N] [--format numpy|torch]
"""

from __future__ import annotations

import argparse
import os
import pickle

from mvlpt_torch.checkpoint.prompt_io import (
    MODEL_BEST,
    average_checkpoints,
    checkpoint_path,
    export_reference_checkpoint,
    find_checkpoint,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="average prompt checkpoints")
    p.add_argument("--dirs", nargs="+", required=True,
                   help="run output dirs (one per seed)")
    p.add_argument("--epoch", type=int, default=None,
                   help="load model.pth.tar-<epoch> instead of model-best")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--format", choices=("numpy", "torch"), default="numpy",
                   help="output format: this repo's numpy pickle (default) "
                        "or the reference trainer's torch archive (key "
                        "names per trainers/mvlpt.py:1090-1125), directly "
                        "consumable by the reference's --model-dir and "
                        "avg_ckpt.py")
    return p


def main(args) -> str:
    """Average the runs ``args.dirs`` name; returns the written path."""
    # find_checkpoint: the same resolution as --model-dir (model-best, or
    # the newest epoch checkpoint of a last_step run that wrote none)
    paths = [find_checkpoint(d, args.epoch) for d in args.dirs]
    for d, path in zip(args.dirs, paths):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        # The resolution is printed: on best_val runs a fallback to the
        # newest epoch checkpoint (a seed that crashed before its first
        # val improvement) would otherwise slip near-random weights into
        # the average.
        print(f"  {d} -> {path}")
        if args.epoch is None and os.path.basename(path) != MODEL_BEST:
            print(f"  WARNING: {d} has no {MODEL_BEST}; averaged its "
                  f"newest epoch checkpoint instead")
    avg = average_checkpoints(paths)
    out = checkpoint_path(args.output_dir)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if args.format == "torch":
        export_reference_checkpoint(out, avg["state_dict"], epoch=avg["epoch"],
                                    val_result=avg["val_result"])
    else:
        with open(out, "wb") as f:
            pickle.dump(avg, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"averaged {len(paths)} checkpoints -> {out} ({args.format})")
    return out


def cli(argv=None):
    main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
