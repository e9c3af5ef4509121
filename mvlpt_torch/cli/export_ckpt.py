"""Convert a prompt checkpoint to the reference's torch format.

The counterpart of ``mvlpt_tpu/cli/export_ckpt.py``, with the same flags
and file. The load direction (reference torch archive -> this package)
lives in ``checkpoint/prompt_io.load_prompt_checkpoint``; this CLI is the
return trip: any checkpoint (this repo's numpy pickle or an already-torch
archive) re-emitted as the reference trainer's own ``torch.save`` payload
(keys ``state_dict``/``epoch``/``val_result`` with the reference learner's
tensor names, the reference's trainers/mvlpt.py:1090-1125), so prompts
trained here warm-start the reference's runs (``--model-dir``) and feed
its ``avg_ckpt.py`` unchanged.

Usage:
    python -m mvlpt_torch.cli.export_ckpt --input <run_dir_or_file> \\
        --output <file.pth.tar> [--epoch N]
"""

from __future__ import annotations

import argparse
import os

from mvlpt_torch.checkpoint.prompt_io import (
    MODEL_BEST,
    export_reference_checkpoint,
    find_checkpoint,
    load_prompt_checkpoint,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="export a prompt checkpoint in the reference's torch format")
    p.add_argument("--input", required=True,
                   help="run output dir (resolved like --model-dir) or a "
                        "checkpoint file path")
    p.add_argument("--epoch", type=int, default=None,
                   help="with a dir input: load model.pth.tar-<epoch> "
                        "instead of model-best")
    p.add_argument("--output", required=True,
                   help="destination .pth.tar (torch archive)")
    return p


def main(args) -> str:
    """Export ``args.input``; returns the checkpoint it read."""
    src = args.input
    if os.path.isdir(src):
        src = find_checkpoint(src, args.epoch)
        if args.epoch is None and os.path.exists(src) and os.path.basename(src) != MODEL_BEST:
            # As avg_ckpt and the trainer's load_model warn: a best_val run
            # that wrote no model-best would export its newest epoch.
            print(f'WARNING: no {MODEL_BEST} in "{args.input}"; exporting the newest '
                  f'epoch checkpoint "{src}" instead')
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    payload = load_prompt_checkpoint(src)
    export_reference_checkpoint(args.output, payload["state_dict"], epoch=payload["epoch"],
                                val_result=payload.get("val_result"))
    print(f"exported {src} -> {args.output} (reference torch format)")
    return src


def cli(argv=None):
    main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
