#!/usr/bin/env python3
"""The data side of two checkouts in turns, on one card.

    python3 scripts/torch_port_loader_ab.py [--other /path/to/checkout] [--epochs 3]

Runs, each in its own process: one pass of the CLI's train loader alone
(decode and transform, nothing on the card), the training CLI as
chip_smoke.py's ``trainer_cli`` runs it (its dataset, flags and cuts,
``--epochs`` epochs, no test), and lpclip's random-RN50 extraction as
``drive_lpclip`` runs it; in the order other, this, this (native), this
(native), this, other: ``--other`` on DATALOADER.BACKEND "python", this
checkout on "python" and on "native". One dataset serves every run
(written once by this checkout's ``write_cli_dataset``). Each run prints
one JSON line: the loader's img/s alone; its epochs' wall, img/s with
the loading and the shares of the wall spent waiting on the loader and
staging (where the checkout records it); and each split's extraction
img/s with the loading. Without ``--other`` the other runs are left
out. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# Run inside a checkout: that checkout's chip_smoke.py and mvlpt_torch.
CHILD = r'''
import json, os, sys, time
from pathlib import Path
root, data, backend, epochs = Path(sys.argv[1]), Path(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, str(root))
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from mvlpt_torch.ops import _build
cs.setup_vocab()
_build.build_kernels()
cs.write_cli_dataset(data)
opts = ["DATALOADER.BACKEND", backend] if backend != "python" else []
os.environ["MVLPT_TPU_RANDOM_CLIP"] = "1"
out_dir = root / "build" / "loader_ab" / backend
trainer, _ = cs._cli_run(["--root", str(data), "--trainer", "MVLPT", "--dataset-coop",
                          "--dataset", "OxfordPets", "--shots", str(cs.CLI_SHOTS), "--seed",
                          "1", "--cut-contextlen", "--config-file",
                          str(root / "configs/trainers/MVLPT/vit_b16_tpu_fast.yaml"),
                          "--output-dir", str(out_dir / "train"), *cs.CLI_OPTS,
                          "OPTIM.MAX_EPOCH", epochs, "TEST.NO_TEST", "True", *opts])
torch.cuda.synchronize()
epochs = trainer.timings["epochs"]
t0 = time.perf_counter()
n_alone = sum(len(b["image"]) for b in trainer.train_loader_x)
loader_alone = n_alone / (time.perf_counter() - t0)
from mvlpt_torch.cli import lpclip
from mvlpt_torch.utils import pipeline
dump, seconds = pipeline.dump_split_features, []
def timed(*a, **k):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = dump(*a, **k)
    torch.cuda.synchronize()
    seconds.append((n, time.perf_counter() - t0))
    return n
pipeline.dump_split_features = timed
cfg = out_dir / "lpclip.yaml"
cfg.write_text(f'DATALOADER:\n  BACKEND: "{backend}"\n')
lpclip.cli(["extract-features", "--root", str(data), "--dataset-coop", "--dataset", "OxfordPets",
            "--output-dir", str(out_dir / "feats"), "--batch-size", str(cs.LP_BATCH),
            "--num-workers", "8", "--config-file", str(cfg)])
print("AB " + json.dumps(dict(
    card=cs.card_line(), backend=backend, loader_alone_img_per_s=loader_alone,
    epoch_wall_s=[e["wall_s"] for e in epochs],
    img_per_s=[e["images"] / e["wall_s"] for e in epochs],
    loader_wait_share=[e["loader_s"] / e["wall_s"] for e in epochs],
    staging_share=[e["stage_s"] / e["wall_s"] for e in epochs if "stage_s" in e],
    extract_img_per_s=[n / s for n, s in seconds])), flush=True)
'''


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", default=None, help="another checkout, run on 'python'")
    p.add_argument("--epochs", default="3")
    args = p.parse_args()
    data = HERE / "build" / "trainer_cli_data"
    this = [(HERE, "python"), (HERE, "native"), (HERE, "native"), (HERE, "python")]
    runs = this if args.other is None else (
        [(Path(args.other).resolve(), "python"), *this, (Path(args.other).resolve(), "python")])
    for root, backend in runs:
        out = subprocess.run([sys.executable, "-c", CHILD, str(root), str(data), backend,
                              args.epochs], cwd=root, capture_output=True, text=True,
                             timeout=900)
        line = next((x for x in out.stdout.splitlines() if x.startswith("AB ")), None)
        if out.returncode != 0 or line is None:
            print(out.stdout[-3000:], out.stderr[-3000:], file=sys.stderr)
            return 1
        row = dict(json.loads(line[3:]), checkout="other" if root != HERE else "this")
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
