"""ELEVATER leaderboard prediction dump + submission validation
(rebuild of trainers/vision_benchmark/commands/prepare_submit.py and
common/prediction_submission.py:46-109): per-task prediction JSONs with
6-decimal probabilities, shape/prob-sum checks, zipped for upload. The
counterpart of ``mvlpt_tpu/cli/prepare_submit.py``, with the same flags,
files and default model name."""

from __future__ import annotations

import argparse
import json
import os
import zipfile

import numpy as np


def validate_predictions(probs: np.ndarray, n_classes: int):
    """Submission sanity checks (prediction_submission.py:72-93)."""
    if probs.ndim != 2 or probs.shape[1] != n_classes:
        raise ValueError(f"predictions must be (N, {n_classes}), got {probs.shape}")
    if not np.isfinite(probs).all():
        raise ValueError("non-finite prediction values")
    sums = probs.sum(axis=1)
    if not np.allclose(sums, 1.0, atol=1e-3):
        raise ValueError(f"probabilities must sum to 1 (max dev {abs(sums - 1).max()})")


def dump_predictions(logits: np.ndarray, task: str, out_dir: str,
                     model_name: str = "mvlpt_tpu") -> str:
    """Softmax logits -> 6-decimal prediction JSON
    (commands/linear_probe.py:111-135 format)."""
    x = logits.astype(np.float64)
    x = np.exp(x - x.max(axis=1, keepdims=True))
    probs = x / x.sum(axis=1, keepdims=True)
    # validate against the task's KNOWN class count (the reference
    # checks the dataset's, prediction_submission.py:72-93) — checking
    # against probs' own width would be tautological
    try:
        from mvlpt_torch.data.elevater import class_map

        n_classes = len(class_map(task))
    except (KeyError, FileNotFoundError):
        n_classes = probs.shape[1]  # unknown task: shape checks only
    validate_predictions(probs, n_classes)
    payload = {
        "model_name": model_name,
        "dataset_name": task,
        "predictions": [[round(float(p), 6) for p in row] for row in probs],
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{task}.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def cli(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--predictions-dir", required=True,
                   help="dir of <task>.npz files with 'logits' arrays")
    p.add_argument("--output-zip", required=True)
    p.add_argument("--model-name", default="mvlpt_tpu")
    args = p.parse_args(argv)

    json_dir = os.path.join(os.path.dirname(args.output_zip), "submit_json")
    paths = []
    for fname in sorted(os.listdir(args.predictions_dir)):
        if not fname.endswith(".npz"):
            continue
        task = fname[:-4]
        logits = np.load(os.path.join(args.predictions_dir, fname))["logits"]
        paths.append(dump_predictions(logits, task, json_dir, args.model_name))
        print(f"validated + dumped {task}")
    with zipfile.ZipFile(args.output_zip, "w", zipfile.ZIP_DEFLATED) as z:
        for path in paths:
            z.write(path, os.path.basename(path))
    print(f"submission: {args.output_zip} ({len(paths)} tasks)")


if __name__ == "__main__":
    cli()
