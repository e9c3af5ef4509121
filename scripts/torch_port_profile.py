#!/usr/bin/env python3
"""Where the time of the port's flagship train step, or of its eval, goes,
on one card.

    python3 scripts/torch_port_profile.py [--path train|eval|window|rn50|logreg] [--steps 3]
                                          [--k 120] [--out DIR]

Runs the flagship MVLPT UPT train step (ViT-B/16, batch 32, 100
classes, bf16, fused half-block kernels on both towers), or with
``--path eval`` the cached-text eval's image tower at batch 100 (the
no-grad half-block kernels; the text features computed once before), or
with ``--path window`` windows of ``--k`` train steps replayed from the
windowed step's CUDA graph (``make_train_step_multi``, pre_embed, uint8
images with normalize; a step here is a train step, ``--steps`` counts
windows), or with ``--path rn50`` the lpclip extraction's RN50 tower
(random weights, bf16, a batch of 128 float images; no kernel of the
repo: cuDNN's convolutions and plain ops), or with ``--path logreg`` one
fit of the lpclip probe's logistic regression at its 16-shot shape
(``evaluation.logreg.LogisticRegression``, C = 1, on seeded features of
100 classes x 16 shots, 1024 wide, as RN50 gives them; a step is a fit,
and the untraced warm-up fit's host time is split into the objective's
and scipy's solver's), for two warm-up steps (windows), then traces
``--steps`` steps (windows) with torch.profiler. Prints the
card (nvidia-smi name and power limit), ms/step on the host clock, the
device time a step summed over kernels, the device's idle share, the
host's stream synchronizations (``cudaStreamSynchronize``) and the
host-to-device copies (``Memcpy HtoD``) a step, and device time by
kernel name; writes the Chrome trace to ``--out``.
Needs a card; uses the synthetic vocab unless MVLPT_TORCH_BPE_PATH names
a file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# --path logreg: the probe's 16-shot fit on 100 classes of RN50 features.
LOGREG_CLASSES, LOGREG_SHOTS, LOGREG_DIM, LOGREG_C = 100, 16, 1024, 1.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("train", "eval", "window", "rn50", "logreg"), default="train")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--k", type=int, default=120, help="steps a window (--path window)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "torch_port_profile"))
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_port_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, setup_vocab
    from mvlpt_torch.config import optim_config
    from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, flagship
    from mvlpt_torch.train import (
        init_train_state, make_cached_text_eval, make_train_step,
        make_train_step_multi)

    print(card_line())  # name, power limit (nvidia-smi)
    print(setup_vocab())
    torch.backends.cuda.matmul.allow_tf32 = False

    norm = (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)
    rng = np.random.RandomState(0)
    per_call = args.k if args.path == "window" else 1
    if args.path == "rn50":
        from mvlpt_torch.core import resnet
        from mvlpt_torch.utils.tree import tree_map

        rn_cfg = resnet.RN_ARCHS["RN50"]
        visual = tree_map(lambda t: t.to(torch.bfloat16),
                          resnet.init_rn_params(torch.Generator().manual_seed(0), rn_cfg))
        images = torch.from_numpy(rng.randn(128, 224, 224, 3).astype(np.float32)).cuda()

        @torch.no_grad()
        def step():
            resnet.encode_image_rn(visual, images, rn_cfg)
    elif args.path == "logreg":
        from mvlpt_torch.evaluation.logreg import LogisticRegression

        centers = rng.randn(LOGREG_CLASSES, LOGREG_DIM).astype(np.float32)
        labels = np.arange(LOGREG_CLASSES * LOGREG_SHOTS) % LOGREG_CLASSES
        feats = (centers[labels] + 4.0 * rng.randn(len(labels), LOGREG_DIM)).astype(np.float32)
        fits = []

        def step():
            fits.append(LogisticRegression(C=LOGREG_C, device="cuda").fit(feats, labels))
    else:
        model, backbone, pp, consts, _, clip_cfg = flagship(device="cuda", kernels="auto")
        size = 100 if args.path == "eval" else 32
        lead = (args.k, size) if args.path == "window" else (size,)
        batch = {"image": torch.from_numpy(rng.randint(0, 256, (*lead, 224, 224, 3)).astype(
                     np.uint8)).cuda(),
                 "label": torch.from_numpy(rng.randint(0, 100, lead)).cuda()}
        ocfg = optim_config(LR=0.002, LR_SCHEDULER="cosine", MAX_EPOCH=200)
    if args.path == "window":
        state = init_train_state(pp, ocfg, 100)
        window_step = make_train_step_multi(model, pre_embed=True, normalize=norm)

        def step():
            window_step(state, backbone, consts, batch)
    elif args.path == "train":
        state = init_train_state(pp, ocfg, 100)
        train_step = make_train_step(model, normalize=norm)

        def step():
            train_step(state, backbone, consts, batch)
    elif args.path == "eval":
        text_fn, eval_fn = make_cached_text_eval(model, normalize=norm)
        text_features = text_fn(backbone, pp, consts)

        def step():
            eval_fn(backbone, pp, text_features, batch)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    if args.path == "logreg":
        t, its = fits[-1].timing_, int(fits[-1].n_iter_[0])
        print(json.dumps({"fit_s": t["fit_s"], "iterations": its,
                          "evaluations": t["evaluations"],
                          "objective_ms_per_evaluation": t["objective_s"] / t["evaluations"] * 1e3,
                          "solver_ms_per_iteration": (t["fit_s"] - t["objective_s"]) / its * 1e3}))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))

    # Device-side events only: a host op's entry repeats the time of the
    # kernels it launched.
    rows = [(ev.self_device_time_total, ev.count, ev.key) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    steps = args.steps * per_call
    calls = {ev.key: ev.count for ev in prof.key_averages()}
    syncs = calls.get("cudaStreamSynchronize", 0)
    htod = sum(n for key, n in calls.items() if "Memcpy HtoD" in key)
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    step_ms = wall * 1e3 / steps
    print(json.dumps({"path": args.path, "ms_per_step_host": step_ms,
                      "device_ms_per_step": busy_ms,
                      "device_idle_share": max(0.0, 1 - busy_ms / step_ms),
                      "stream_syncs_per_step": syncs / steps,
                      "htod_copies_per_step": htod / steps, "steps": steps}))
    for dev_us, count, key in rows[:30]:
        print(f"{dev_us / 1e3 / steps:9.3f} ms/step {count // steps:6d} calls/step  "
              f"{key[:140]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
