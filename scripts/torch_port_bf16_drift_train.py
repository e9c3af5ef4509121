#!/usr/bin/env python3
"""Production-path training drift of the port against its fp32 path.

The counterpart of ``scripts/bf16_drift_train.py``, function by function.
N SGD steps of the production path (bf16 compute, the fused half-block
kernels, the windowed step replayed from a CUDA graph) must land inside
the fp32 plain path's own spread under a benign perturbation: a fresh
stream of data from the same distribution. Four trajectories from one
prompt init on streams of one shape:

  A. fp32 plain, one step a call (``make_train_step``), stream s0
  B. production: bf16, kernels, the windowed step, the SAME stream s0
  C. fp32 plain, one step a call, a fresh stream s1: the yardstick
  D. bf16 plain, the windowed step, stream s0: isolates the kernels
     (B - D) from the dtype (A - D)

Reported (one JSON line; ``measure`` returns it):
  loss_mae_dtype  = mean_t |loss_B(t) - loss_A(t)|
  loss_mae_seed   = mean_t |loss_C(t) - loss_A(t)|
  param_dist_*    = global L2 distance between final prompt trees (fp64)
  *_ratio         = dtype distance / seed-spread distance (< 1: the
                    production path sits inside benign-perturbation noise)
plus, beside the JAX script's keys, the card (``nvidia-smi``'s name and
power limit), each leg's seconds and ms a step (host clock, ending in a
synchronize; a windowed leg's first window includes its capture), and
the kernel launches of leg B (``ops._build.LAUNCHES``: a wrapper counts
where it launches, so the replayed steps, which call no wrapper, add
nothing; ``captures`` and ``replays`` say how the window ran).

The tiny towers (``flagship.tiny_flagship``) take the half-block kernels
as 'block', as the JAX script forces its fused marker on them; ViT-B/16
takes them through 'auto', the production selection. The file also holds
the port's copies of ``tests/test_bf16_drift.py``'s zero-shot helpers
(``_mid_clip``, ``_mid_clip_inputs``, ``_zeroshot_logits``,
``_check_drift``), which the tests and ``chip_smoke.py`` import.

It runs on the card; ``measure(..., device="cpu")`` runs it on the CPU
(the kernels' plain twins), and without a card the default raises. The
command line reads the vocab as ``chip_smoke.setup_vocab`` does
(``MVLPT_TORCH_BPE_PATH``, else a synthetic merges file under build/).

Usage:
    # the CPU analogue (tiny towers):
    python scripts/torch_port_bf16_drift_train.py --backbone tiny --device cpu
    # the measurement on the card (ViT-B/16, the MVLPT UPT flagship):
    python scripts/torch_port_bf16_drift_train.py --backbone b16 --window 120
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# tests/test_bf16_drift.py's bounds on the zero-shot logits' drift, as
# fractions of the fp32 logits' std: bf16 against fp32, and the fused
# kernels against the plain path, both in bf16.
BF16_REL_TOL = 0.12
FUSED_REL_TOL = 0.14


def _stream(seed: int, steps: int, batch: int, res: int, n_cls: int,
            unique: int | None = None) -> dict:
    """A uint8 pixel and label stream, the JAX script's draws bit for bit.

    ``unique`` < steps makes only U distinct pixel batches, which the
    runners cycle (step t reads image[t % U]); the labels stay fresh each
    step. Both compared trajectories see the same stream either way."""
    unique = unique or steps
    rng = np.random.RandomState(seed)
    return {
        "image": rng.randint(0, 256, (unique, batch, res, res, 3)).astype(np.uint8),
        "label": rng.randint(0, n_cls, (steps, batch)).astype(np.int32),
    }


def _build(backbone: str, compute_dtype, kernels: bool, n_cls: int, batch: int, device,
           weights: tuple | None = None):
    """(model, backbone params, prompt params, consts, resolution).
    ``kernels``: the half-block kernels ('block' on the tiny towers,
    'auto' on ViT-B/16), else the plain path ('off'). ``weights`` (tiny
    only): fp32 (backbone, prompt params) in place of the seeded init."""
    from mvlpt_torch.flagship import flagship, tiny_flagship

    if backbone == "tiny":
        model, bb, pp, consts, clip_cfg = tiny_flagship(
            n_cls=n_cls, compute_dtype=compute_dtype, kernels="block" if kernels else "off",
            device=device, weights=weights)
    else:
        if weights is not None:
            raise ValueError("weights are taken for the tiny towers only")
        model, bb, pp, consts, _, clip_cfg = flagship(
            n_cls=n_cls, batch=batch, compute_dtype=compute_dtype, backbone_name="ViT-B/16",
            kernels="auto" if kernels else "off", device=device)
    return model, bb, pp, consts, clip_cfg.image_resolution


def _plain(model):
    """The same model on the plain path (leg D: the dtype without the
    kernels)."""
    from mvlpt_torch.models import MVLPTModel

    return MVLPTModel(model.clip_cfg, model.spec, kernels=None,
                      compute_dtype=model.compute_dtype)


def _params(state) -> dict:
    from mvlpt_torch.utils.tree import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy(), state.prompt_params)


def _run_single(model, bb, pp, consts, stream, lr_steps, device):
    """The fp32 reference's semantics: one step a call. -> (losses,
    final prompt params as numpy, {})."""
    import torch

    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.train import init_train_state, make_train_step

    state = init_train_state(pp, get_cfg_default().OPTIM, lr_steps)
    step = make_train_step(model, normalize=(CLIP_MEAN, CLIP_STD))
    imgs = torch.from_numpy(stream["image"]).to(device)    # (U, B, ...) uploaded once
    labels = torch.from_numpy(stream["label"]).to(device)  # (steps, B)
    u = imgs.shape[0]
    losses = []
    for i in range(labels.shape[0]):
        state, m = step(state, bb, consts, {"image": imgs[i % u], "label": labels[i]})
        losses.append(m["loss"])
    return torch.stack(losses).cpu().numpy().astype(np.float64), _params(state), {}


def _run_windowed(model, bb, pp, consts, stream, lr_steps, window, device):
    """The production semantics: ``make_train_step_multi`` with the stem
    run once a window over its images (``pre_embed``), the CLIP
    normalisation folded into it; on the card one captured step replayed.
    -> (losses, final prompt params as numpy, {"captures", "replays"})."""
    import torch

    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.train import init_train_state, make_train_step_multi

    state = init_train_state(pp, get_cfg_default().OPTIM, lr_steps)
    step = make_train_step_multi(model, pre_embed=True, normalize=(CLIP_MEAN, CLIP_STD))
    imgs = torch.from_numpy(stream["image"]).to(device)  # (U, B, ...) uploaded once
    labels = torch.from_numpy(stream["label"]).to(device)
    u, n = imgs.shape[0], labels.shape[0]
    if n % window:
        raise ValueError(f"{n} steps do not split into windows of {window}")
    # Step t must read image[t % U] as the single-step runner does, so
    # every window starts phase-aligned on the U-cycle.
    if u != n and window % u:
        raise ValueError(f"a window of {window} is not a whole number of {u}-batch cycles")
    win_imgs = imgs.repeat(window // u, 1, 1, 1, 1) if u != n else None
    losses = []
    for i in range(0, n, window):
        imgs_i = imgs[i:i + window] if u == n else win_imgs
        state, ms = step(state, bb, consts, {"image": imgs_i, "label": labels[i:i + window]})
        losses.append(ms["loss"])
    info = {"captures": step.captures, "replays": step.replays}
    return torch.cat(losses).cpu().numpy().astype(np.float64), _params(state), info


def _dist(a, b) -> float:
    """Global L2 distance between two prompt trees (fp64 sums)."""
    from mvlpt_torch.utils.tree import tree_leaves

    return float(np.sqrt(sum(
        np.sum((np.asarray(x, np.float64) - np.asarray(y, np.float64)) ** 2)
        for x, y in zip(tree_leaves(a), tree_leaves(b)))))


def measure(backbone: str = "tiny", steps: int = 24, window: int = 4, batch: int = 8,
            n_cls: int = 8, unique: int | None = None, device="cuda",
            weights: tuple | None = None) -> dict:
    """The four legs and their distances (the module docstring). Runs on
    the card unless ``device="cpu"``; ``weights`` as ``_build``'s."""
    import torch

    from chip_smoke import card_line
    from mvlpt_torch.ops import _build as kbuild
    from mvlpt_torch.utils.device import resolve_device

    device = resolve_device(device)
    model32, bb32, pp, consts32, res = _build(backbone, torch.float32, False, n_cls, batch,
                                              device, weights)
    prod_dtype = torch.bfloat16
    modelP, bbP, _, constsP, _ = _build(backbone, prod_dtype, True, n_cls, batch, device,
                                        weights)
    modelD = _plain(modelP)

    s0 = _stream(0, steps, batch, res, n_cls, unique=unique)
    s1 = _stream(1000, steps, batch, res, n_cls, unique=unique)
    legs, launches = {}, {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(tag, fn, *a):
        sync()
        kbuild.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        seconds = time.perf_counter() - t0
        launches[tag] = {k: v for k, v in kbuild.LAUNCHES.items() if v}
        legs[tag] = dict(seconds=seconds, ms_per_step=1e3 * seconds / steps,
                         final_loss=float(out[0][-1]), **out[2])
        print(f"[drift] {tag}: {seconds:.1f}s ({legs[tag]['ms_per_step']:.2f} ms/step, "
              f"final loss {out[0][-1]:.4f})", flush=True)
        return out[:2]

    loss_a, p_a = timed("A fp32-plain-single s0", _run_single, model32, bb32, pp, consts32,
                        s0, steps, device)
    loss_b, p_b = timed("B prod-windowed s0", _run_windowed, modelP, bbP, pp, constsP, s0,
                        steps, window, device)
    loss_c, p_c = timed("C fp32-plain-single s1", _run_single, model32, bb32, pp, consts32,
                        s1, steps, device)
    loss_d, p_d = timed("D bf16-plain-window s0", _run_windowed, modelD, bbP, pp, constsP, s0,
                        steps, window, device)

    d_dtype, d_seed, d_kern = _dist(p_a, p_b), _dist(p_a, p_c), _dist(p_b, p_d)
    mae_dtype = float(np.mean(np.abs(loss_b - loss_a)))
    mae_seed = float(np.mean(np.abs(loss_c - loss_a)))
    return {
        "metric": "production-path training drift vs fp32 reference",
        "backbone": backbone, "n_steps": steps, "window": window,
        "batch": batch, "n_cls": n_cls, "prod_dtype": "bfloat16",
        "loss_mae_dtype": mae_dtype,
        "loss_mae_seed": mae_seed,
        "final_loss_fp32": float(loss_a[-1]),
        "final_loss_prod": float(loss_b[-1]),
        "param_dist_dtype": d_dtype,
        "param_dist_seed": d_seed,
        "param_dist_kernels_only": d_kern,
        "param_ratio": d_dtype / d_seed if d_seed else float("inf"),
        "loss_ratio": mae_dtype / max(mae_seed, 1e-12),
        "device": str(device), "card": card_line() if device.type == "cuda" else "cpu",
        "legs": legs,
        "launches_B": launches["B prod-windowed s0"],
        "losses": {"A": loss_a.tolist(), "B": loss_b.tolist(), "C": loss_c.tolist(),
                   "D": loss_d.tolist()},
    }


# ------------------------------------------------- zero-shot logit drift
#
# The port's copies of tests/test_bf16_drift.py:37-80.

def _mid_clip():
    """tests/test_bf16_drift.py's ``_mid_clip``: deep enough for drift to
    accumulate, small enough for the CPU (4 heads of 32 in each tower)."""
    from mvlpt_torch.core.clip import CLIPConfig

    return CLIPConfig(
        embed_dim=64, image_resolution=64, vision_layers=4, vision_width=128,
        vision_patch_size=16, transformer_width=128, transformer_heads=4,
        transformer_layers=4, vision_heads_override=4)


def _mid_clip_inputs(n_images: int = 48, res: int = 64,
                     n_rows: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """That test's inputs, from RandomState(0): ``n_images`` images of
    ``res`` px from N(0, 1), then ``n_rows`` random token rows of 13 whose
    first id is 40000 and last the largest (the EOT by argmax)."""
    rng = np.random.RandomState(0)
    images = rng.randn(n_images, res, res, 3).astype(np.float32)
    ids = rng.randint(1, 1000, (n_rows, 13)).astype(np.int32)
    ids[:, 0] = 40000
    ids[:, -1] = 49407
    return images, ids


def _zeroshot_logits(backbone, cfg, images, token_ids, kernels=None) -> np.ndarray:
    """CLIP's zero-shot logits (both towers, ``core.clip.clip_logits``)
    under ``kernels`` (a ``select_attn_fn`` result), without grad, as
    fp32 numpy."""
    import torch

    from mvlpt_torch.core import clip as clip_core

    with torch.no_grad():
        img = clip_core.encode_image(backbone, images, cfg, kernels=kernels)
        txt = clip_core.encode_text(backbone, token_ids, cfg, kernels=kernels)
        return clip_core.clip_logits(img, txt, backbone["logit_scale"]).cpu().numpy()


def _check_drift(ref: np.ndarray, got: np.ndarray, rel_tol: float) -> dict:
    """max|got - ref| within ``rel_tol`` x std(ref), and the same top-1 on
    every sample whose ref margin (top-1 minus top-2) exceeds twice that
    drift, with at least one such sample. Raises AssertionError, else
    returns {"drift": the drift as a fraction of std(ref), "logit_std",
    "confident": the samples held to the top-1 rule, "margin_median": the
    median margin as a fraction of std(ref)}."""
    spread = float(np.std(ref))
    drift = float(np.abs(got - ref).max())
    if drift > rel_tol * spread:
        raise AssertionError(f"logit drift {drift:.4f} exceeds {rel_tol} * spread {spread:.4f}")
    top = np.sort(ref, axis=-1)
    margin = top[:, -1] - top[:, -2]
    confident = margin > 2 * drift
    if not confident.any():
        raise AssertionError("degenerate fixture: no confident samples")
    agree = np.argmax(ref[confident], -1) == np.argmax(got[confident], -1)
    if not agree.all():
        raise AssertionError(f"top-1 flipped on {(~agree).sum()} confident samples "
                             f"(margin > {2 * drift:.4f})")
    return {"drift": drift / spread, "logit_std": spread, "confident": int(confident.sum()),
            "margin_median": float(np.median(margin)) / spread}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--backbone", choices=("tiny", "b16"), default="tiny")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--window", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--n-cls", type=int, default=None)
    p.add_argument("--unique", type=int, default=None,
                   help="make only U distinct pixel batches (must divide --window)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    tiny = args.backbone == "tiny"
    steps = args.steps or (24 if tiny else 120)
    window = args.window or (4 if tiny else 60)
    batch = args.batch or (8 if tiny else 32)
    n_cls = args.n_cls or (8 if tiny else 100)
    unique = args.unique if args.unique else (None if tiny else 6)
    from chip_smoke import setup_vocab

    print(setup_vocab(), flush=True)
    out = measure(args.backbone, steps, window, batch, n_cls, unique, device=args.device)
    print(json.dumps(out))
    if out["param_ratio"] >= 1.0:
        raise SystemExit(f"production trajectory drifted OUTSIDE the data-stream spread: "
                         f"param_ratio={out['param_ratio']:.3f}")


if __name__ == "__main__":
    main()
