#!/usr/bin/env python3
"""End-to-end learnability soak of the port's training CLI on synthetic data.

The counterpart of ``scripts/soak_synthetic.py``. It drives the whole
production path of ``python -m mvlpt_torch.cli.train``: argument parsing,
ELEVATER multitask manifests, the val split, the input pipeline, the
trainer, per-task evaluation and best-val selection, on two 10-class
tasks whose images carry a class-dependent colour (the class-colour
fixtures of tests/util_fixtures.py), so the task can be learnt from the
pixels. The towers are random and tiny (the JAX script's override of
ViT-B/32 and of the 16-wide text tower), so this checks that the CLI
learns, not what a model reaches: the final average test accuracy over
the packed label space of 20 classes (chance 0.05) must reach
``--min-acc``.

The CLI options are the JAX script's with one change: DATALOADER.BACKEND
"native" (the port's C++ decode) in place of "tf", the one backend the
port refuses (``config/defaults.validate_support``). A native core that
does not build makes the run fail; it never falls back to "python".

The tokenizer reads ``MVLPT_TORCH_BPE_PATH`` when it names a file, else
the synthetic merges file that ``chip_smoke.setup_vocab`` writes under
build/ (the real CLIP vocab is not in the repository). ``run(argv,
device="cpu")`` runs it on the CPU in process (the tests do); the default
is the card, and without one it raises.

Usage:
    python scripts/torch_port_soak_synthetic.py [--epochs 40] [--n-train 200]
        [--n-test 60] [--min-acc 0.2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import tempfile
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TASKS = ("cifar-10", "mnist")
N_CLASSES = 10
# The JAX script's tiny towers: the plumbing is under test, not capacity.
TINY_VIT = dict(embed_dim=16, image_resolution=32, vision_layers=2, vision_width=64,
                vision_patch_size=8)
TINY_TEXT = dict(transformer_width=32, transformer_heads=2, transformer_layers=2)


def _write_image(path: str, seed: int = 0, size=(32, 32), class_signal=None) -> None:
    """tests/util_fixtures.py's ``_write_image``: noise from ``seed``, plus
    a class-dependent colour when ``class_signal`` is an int."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.RandomState(seed)
    arr = rng.randint(0, 100, (*size, 3)).astype(np.int64)
    if class_signal is not None:
        color = np.array([(class_signal * 97) % 156, (class_signal * 57) % 156,
                          (class_signal * 37) % 156])
        arr = arr + color[None, None, :]
    Image.fromarray(arr.astype(np.uint8)).save(path)


def write_task(root: str, task: str, n_classes: int, n_train: int, n_test: int) -> str:
    """<root>/<task>/manifest.json and its JPEGs as tests/util_fixtures.py's
    ``make_elevater_task`` writes a multiclass task: ``train_{i}.jpg`` and
    ``test_{i}.jpg`` of class i % n_classes, image seeds counting up over
    both splits. (``data.elevater.write_task_manifest`` names and orders
    its items otherwise.)"""
    tdir = os.path.join(root, task)
    manifest = {"type": "classification_multiclass", "num_classes": n_classes,
                "splits": {"train": [], "test": []}}
    seed = 0
    for part, count in (("train", n_train), ("test", n_test)):
        for i in range(count):
            rel, label = f"{part}_{i}.jpg", i % n_classes
            _write_image(os.path.join(tdir, rel), seed=seed, class_signal=label)
            seed += 1
            manifest["splits"][part].append([rel, [label]])
    with open(os.path.join(tdir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return tdir


def cli_argv(root: str, out: str, epochs: int, backend: str = "native", flags=()) -> list:
    """The JAX script's CLI arguments, DATALOADER.BACKEND ``backend``;
    ``flags`` go before the config options."""
    return [
        "--root", root, "--output-dir", out,
        "--trainer", "MVLPT", "--dataset", ",".join(TASKS),
        "--multi-task", "--multi-task-label_pertask",
        "--seed", "1", "--cut-contextlen", *flags,
        "OPTIM.MAX_EPOCH", str(epochs), "OPTIM.LR", "0.05",
        "OPTIM.WARMUP_EPOCH", "0", "OPTIM.LR_SCHEDULER", "cosine",
        "DATALOADER.TRAIN_X.BATCH_SIZE", "8",
        "DATALOADER.TEST.BATCH_SIZE", "8",
        "DATALOADER.NUM_WORKERS", "0", "DATALOADER.BACKEND", backend,
        "INPUT.SIZE", "(32, 32)",
        "INPUT.TRANSFORMS", "('random_resized_crop', 'random_flip', 'normalize')",
        "MODEL.BACKBONE.NAME", "ViT-B/32",
        "TRAINER.MVLPT.COOP.N_CTX", "2", "TRAINER.MVLPT.VPT.N_CTX", "2",
        "TRAINER.MVLPT.PROJECT_DIM", "8",
        "TEST.FINAL_MODEL", "best_val", "TRAIN.PRINT_FREQ", "5",
    ]


@contextlib.contextmanager
def tiny_towers():
    """The JAX script's tower override on ``core.clip``'s tables (ViT-B/32
    and a 16-wide text tower) and a random init (MVLPT_TPU_RANDOM_CLIP),
    undone on exit."""
    from mvlpt_torch.core import clip as cc

    saved = (cc.VIT_ARCHS.get("ViT-B/32"), cc._TEXT_ARCHS.get(16),
             os.environ.get("MVLPT_TPU_RANDOM_CLIP"))
    cc.VIT_ARCHS["ViT-B/32"], cc._TEXT_ARCHS[16] = dict(TINY_VIT), dict(TINY_TEXT)
    os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
    try:
        yield
    finally:
        cc.VIT_ARCHS["ViT-B/32"] = saved[0]
        if saved[1] is None:
            cc._TEXT_ARCHS.pop(16, None)
        else:
            cc._TEXT_ARCHS[16] = saved[1]
        if saved[2] is None:
            os.environ.pop("MVLPT_TPU_RANDOM_CLIP", None)
        else:
            os.environ["MVLPT_TPU_RANDOM_CLIP"] = saved[2]


def final_average(log_path: str) -> float:
    """The last ``results {'average': ...}`` of log.txt: the final test
    evaluation's multitask average."""
    avgs = re.findall(r"results \{'average': ([0-9.]+)\}", Path(log_path).read_text())
    if not avgs:
        raise AssertionError(f"no multitask average in {log_path}")
    return float(avgs[-1])


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--n-train", type=int, default=200)
    ap.add_argument("--n-test", type=int, default=60)
    ap.add_argument("--min-acc", type=float, default=0.2,
                    help="fail below this average test accuracy "
                         "(chance is 0.05 on the packed label space)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def run(argv=None, device=None, workdir: str | None = None) -> dict:
    """Write the two tasks, train through the CLI on ``device`` (else
    ``--device``: the card by default), and hold the final average test
    accuracy to ``--min-acc``. Returns {"final": the average, "min_acc",
    "trainer": the CLI's trainer, "root", "out"}. Data and output go under
    ``workdir`` (a new temporary directory when None)."""
    from mvlpt_torch.cli.train import build_parser, main as train_main
    from mvlpt_torch.utils.device import resolve_device

    args = _parser().parse_args(argv)
    device = resolve_device(device or args.device)
    work = workdir or tempfile.mkdtemp(prefix="soak_")
    root, out = os.path.join(work, "data"), os.path.join(work, "out")
    for task in TASKS:
        write_task(root, task, N_CLASSES, args.n_train, args.n_test)
    with tiny_towers():
        trainer = train_main(build_parser().parse_args(cli_argv(root, out, args.epochs)),
                             device=device)
    final = final_average(os.path.join(out, "log.txt"))
    print(f"final test average accuracy: {final:.3f} (chance 0.05, min {args.min_acc})",
          flush=True)
    if final < args.min_acc:
        raise AssertionError(f"soak FAILED: {final:.3f} < {args.min_acc}")
    print("SOAK OK", flush=True)
    return {"final": final, "min_acc": args.min_acc, "trainer": trainer, "root": root,
            "out": out}


def main() -> None:
    from chip_smoke import setup_vocab

    print(setup_vocab(), flush=True)
    run()


if __name__ == "__main__":
    main()
