"""CLIP linear probe (the reference's lpclip/), in two stages with a file
handoff, as ``mvlpt_tpu/cli/lpclip.py`` runs it:

  1. ``extract-features``: the frozen CLIP visual tower in bf16 over the
     train, val and test splits, each dumped to ``<out>/<split>.npz``
     (lpclip/feat_extractor.py:105-167). RN50 by default, as the
     reference probes it (feat_extractor.py:145). The tower runs its plain
     path, a ViT's too: no kernel selection, as in the JAX package.
  2. ``probe``: logistic regression by the CLIP paper's appendix A3
     protocol (lpclip/linear_probe.py:27-129): shots 1/2/4/8/16 x num_run
     seeds, a 7-point coarse grid on C, then num_step rounds of binary
     search on log C against a few-shot val set; mean and std test
     accuracy to the report files. The fits are
     ``evaluation.logreg.LogisticRegression``, the port's copy of
     scikit-learn's lbfgs fit (the GPU host has no scikit-learn).

    python -m mvlpt_torch.cli.lpclip extract-features --root DATA --dataset cifar-10 \\
        --output-dir feats/cifar-10
    python -m mvlpt_torch.cli.lpclip probe --feature-dir feats/cifar-10 --dataset cifar-10

Both run on the card; ``extract_features(args, device="cpu")`` and
``probe(args, device="cpu")`` run on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

VAL_SHOTS = {1: 1, 2: 2, 4: 4, 8: 4, 16: 4}  # lpclip val_shot_list
C_GRID = [1e6, 1e4, 1e2, 1, 1e-2, 1e-4, 1e-6]  # the coarse grid on C (stage 1)


def extract_features(args, device="cuda"):
    import torch

    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.core import clip as clip_core
    from mvlpt_torch.data.managers import build_data_manager
    from mvlpt_torch.data.transforms import device_normalize
    from mvlpt_torch.train.trainer import load_clip_backbone
    from mvlpt_torch.utils.device import resolve_device
    from mvlpt_torch.utils.pipeline import dump_split_features

    device = resolve_device(device)
    cfg = get_cfg_default()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.DATASET.ROOT = args.root
    cfg.DATASET.DATASET = args.dataset
    cfg.DATASET.COOP = args.dataset_coop
    if args.dataset_coop:
        cfg.DATASET.NAME = args.dataset
    cfg.SEED = args.seed
    cfg.DATALOADER.NUM_WORKERS = args.num_workers
    cfg.DATALOADER.TEST.BATCH_SIZE = args.batch_size
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = args.batch_size
    cfg.INPUT.TRANSFORMS = ()  # the eval transform everywhere (feat_extractor.py)
    cfg.MODEL.BACKBONE.NAME = args.backbone
    cfg.freeze()

    backbone, clip_cfg = load_clip_backbone(cfg, torch.bfloat16, device)
    dm = build_data_manager(cfg)
    mean, std = tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)

    @torch.no_grad()
    def encode(images):
        # a uint8 batch (TPU.DEVICE_NORMALIZE) is normalised on the device
        return clip_core.encode_image(backbone, device_normalize(images, mean, std), clip_cfg)

    os.makedirs(args.output_dir, exist_ok=True)
    splits = {"train": dm.train_loader_x, "val": dm.val_loader, "test": dm.test_loader}
    for split, loader in splits.items():
        if loader is None:
            continue
        path = os.path.join(args.output_dir, f"{split}.npz")
        n = dump_split_features(
            loader, lambda b: encode(torch.from_numpy(b["image"]).to(device)), path)
        print(f"{split}: {n} features -> {path}")


def probe(args, device="cuda") -> dict:
    """Runs the sweep and writes the report files; returns, for each shot
    count, its fits' count, their L-BFGS iterations and objective
    evaluations, and the host seconds of the fits and of their objective
    (``{shot: {"fits", "iterations", "evaluations", "fit_s",
    "objective_s"}}``)."""
    from mvlpt_torch.evaluation.logreg import LogisticRegression
    from mvlpt_torch.utils.device import resolve_device

    device = resolve_device(device)

    def load(split):
        d = np.load(os.path.join(args.feature_dir, f"{split}.npz"))
        return d["feature_list"], d["label_list"]

    train_x, train_y = load("train")
    val_x, val_y = load("val") if os.path.exists(
        os.path.join(args.feature_dir, "val.npz")) else load("test")
    test_x, test_y = load("test")

    os.makedirs(args.report_dir, exist_ok=True)
    tag = os.path.basename(os.path.normpath(args.feature_dir))
    detail_path = os.path.join(
        args.report_dir, f"{tag}_s{args.num_step}r{args.num_run}_details.txt")
    summary_path = os.path.join(
        args.report_dir, f"{tag}_s{args.num_step}r{args.num_run}.txt")

    stats = {}

    def fit_acc(c, x, y, ex, ey):
        # l2 penalty (scikit-learn's default), C swept per the CLIP A3 protocol
        clf = LogisticRegression(C=c, max_iter=1000, device=device).fit(x, y)
        shot["fits"] += 1
        shot["iterations"] += int(clf.n_iter_[0])
        for key in ("evaluations", "fit_s", "objective_s"):
            shot[key] += clf.timing_[key]
        return clf, float((clf.predict(ex) == ey).mean())

    for num_shot in args.shots:
        shot = stats[num_shot] = {"fits": 0, "iterations": 0, "evaluations": 0, "fit_s": 0.0,
                                  "objective_s": 0.0}
        accs = np.zeros(args.num_run)
        for seed in range(1, args.num_run + 1):
            rng = np.random.RandomState(seed)
            classes = np.unique(train_y)

            def sample(x, y, k):
                idx = np.concatenate([
                    rng.choice(np.where(y == c)[0], size=min(k, (y == c).sum()), replace=False)
                    for c in classes])
                return x[idx], y[idx]

            fs_x, fs_y = sample(train_x, train_y, num_shot)
            fv_x, fv_y = sample(val_x, val_y, VAL_SHOTS.get(num_shot, 4))

            # stage 1: the coarse grid on log C
            grid_acc = [fit_acc(c, fs_x, fs_y, fv_x, fv_y)[1] for c in C_GRID]
            c_peak = C_GRID[int(np.argmax(grid_acc))]
            c_left, c_right = 0.1 * c_peak, 10 * c_peak

            # stage 2: binary search on log C
            test_acc = 0.0
            for _ in range(args.num_step):
                clf_l, acc_l = fit_acc(c_left, fs_x, fs_y, fv_x, fv_y)
                clf_r, acc_r = fit_acc(c_right, fs_x, fs_y, fv_x, fv_y)
                if acc_l < acc_r:
                    c_final, clf = c_right, clf_r
                    c_left = 10 ** (0.5 * (np.log10(c_right) + np.log10(c_left)))
                else:
                    c_final, clf = c_left, clf_l
                    c_right = 10 ** (0.5 * (np.log10(c_right) + np.log10(c_left)))
                test_acc = 100.0 * float((clf.predict(test_x) == test_y).mean())
            accs[seed - 1] = test_acc
            with open(detail_path, "a+") as f:
                f.write(f"{args.dataset}, seed {seed}, {num_shot} shot, "
                        f"weight {c_final}, test_acc {test_acc:.2f}\n")
        line = (f"{args.dataset}, {num_shot} Shot, Test acc stat: "
                f"{accs.mean():.2f} ({accs.std():.2f})\n")
        print(line, end="")
        with open(summary_path, "a+") as f:
            f.write(line)
    return stats


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="CLIP linear probe")
    sub = parser.add_subparsers(dest="cmd", required=True)
    fe = sub.add_parser("extract-features")
    fe.add_argument("--root", required=True)
    fe.add_argument("--dataset", required=True)
    fe.add_argument("--dataset-coop", action="store_true")
    # The reference probes RN50 features (lpclip/feat_extractor.py:145).
    fe.add_argument("--backbone", default="RN50")
    fe.add_argument("--config-file", default="")
    fe.add_argument("--output-dir", required=True)
    fe.add_argument("--batch-size", type=int, default=128)
    fe.add_argument("--num-workers", type=int, default=4)
    fe.add_argument("--seed", type=int, default=1)
    pr = sub.add_parser("probe")
    pr.add_argument("--feature-dir", required=True)
    pr.add_argument("--dataset", default="")
    pr.add_argument("--report-dir", default="./report")
    pr.add_argument("--num-step", type=int, default=8)
    pr.add_argument("--num-run", type=int, default=10)
    pr.add_argument("--shots", type=int, nargs="+", default=[1, 2, 4, 8, 16])
    return parser


def cli(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    if args.cmd == "extract-features":
        extract_features(args, device=device)
    else:
        probe(args, device=device)


if __name__ == "__main__":
    cli()
