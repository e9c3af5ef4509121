#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mvlpt_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

1. Builds the six kernel sources of mvlpt_torch/csrc with nvcc (sm_90a),
   one process a source, and prints the build time, the vocab in use and
   the card.
2. Holds each kernel against its plain PyTorch twin on the card, in fp32
   and bf16: the half-block kernels at the flagship shapes (ViT-B/16
   image tower at batch 32, and at the eval batch 100 for the
   no-residual forwards; class-packed text tower with its block-causal
   mask), and the standalone attention (forward and backward) at the
   image train and eval shapes, the packed text rows and CLIP's full
   text context. Times
   kernel, twin and a library call computing the same function
   (scaled_dot_product_attention on the attention core).
3. Drives the port's paths, each with the launch counts set to 0 just
   before it and read just after, against the plain path ('off') on the
   same inputs:
   - the flagship MVLPT UPT train step (ViT-B/16, batch 32, 100 classes,
     bf16) for a few SGD steps under 'auto' (half-block kernels) and
     'on' (standalone attention), first loss within 1e-2;
   - eval of the prompt through the cached-text fast path at batch 100
     under 'auto' (the no-grad half-block forwards) and 'on', its
     logits equal to the full eval step's, its soft-CE within 1e-2 of
     the plain path's;
   - zero-shot CLIP over the 100 class names and the 7 select templates,
     at batch 100 under 'auto' and 'on', held as eval is.
4. Prints a summary line (img/s, ms/step, peak memory), one JSON line of
   kernel numbers, then, as the last line, {"ok": true, "device": {...}}.

Any failure raises and exits non-zero without the last line. Without a
card, or outside a checkout, it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STEPS = 6                 # SGD steps a train path (the first one warms up)
EVAL_BATCH = 100          # the reference TEST batch
EVAL_BATCHES = 4          # eval and zero-shot batches a path (the first one warms up)
HBM_BYTES_S = 3.35e12     # H100 SXM memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; fp32 CUDA cores
# max|kernel - twin| <= TOL x max|twin|. The kernels sum in another order
# than the twins' fp32 products, so a bf16 output can differ by one ulp
# where a value lands near a rounding boundary.
TOL = {"float32": 1e-4, "bfloat16": 5e-3}
# Each kernel of the path, in ops._build.LAUNCHES' names: (source,
# TPU kernel it replaces, the check row whose numbers it reports as
# (name, mode, shape, dtype)).
KERNELS = {
    "attn_fwd": ("attn_fwd", "mvlpt_tpu/ops/block.py:149", ("attn_fwd", "train", "image")),
    "attn_bwd": ("attn_bwd", "mvlpt_tpu/ops/block.py:226", ("attn_bwd", "train", "image")),
    "mlp_fwd": ("mlp_fwd", "mvlpt_tpu/ops/block.py:486", ("mlp_fwd", "train", "image")),
    "mlp_bwd": ("mlp_bwd", "mvlpt_tpu/ops/block.py:532", ("mlp_bwd", "train", "image")),
    "attn_fwd_infer": ("attn_fwd", "mvlpt_tpu/ops/block.py:449",
                       ("attn_fwd", "no-residual", "image_eval")),
    "mlp_fwd_infer": ("mlp_fwd", "mvlpt_tpu/ops/block.py:626",
                      ("mlp_fwd", "no-residual", "image_eval")),
    "attend_fwd": ("attend_fwd", "mvlpt_tpu/ops/attention.py:69",
                   ("attend_fwd", "core", "image_eval")),
    "attend_bwd": ("attend_bwd", "mvlpt_tpu/ops/attention.py:81",
                   ("attend_bwd", "core", "image_train")),
}
# Kernels each path must launch, and how many times per unit of work
# (per train step or per layer-tower pass); every other kernel, 0 times.
TRAIN_KERNELS = {"auto": ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd"),
                 "on": ("attend_fwd", "attend_bwd")}
EVAL_KERNELS = {"auto": ("attn_fwd_infer", "mlp_fwd_infer"), "on": ("attend_fwd",)}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def setup_vocab() -> str:
    from mvlpt_torch.tokenizer import write_synthetic_vocab

    path = os.environ.get("MVLPT_TORCH_BPE_PATH", "")
    if path and os.path.isfile(path):
        return f"vocab: real at {path}"
    path = str(ROOT / "build" / "mvlpt_torch_vocab" / "synthetic_bpe_vocab.txt.gz")
    write_synthetic_vocab(path, seed=0)
    os.environ["MVLPT_TORCH_BPE_PATH"] = path
    return f"vocab: synthetic at {path}"


def cuda_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def layer_params(w: int, dtype, gen):
    """One block's params at CLIP's init scale, with non-trivial LN and biases."""
    import torch

    from mvlpt_torch.core.clip import init_block_stack
    from mvlpt_torch.core.layers import layer_params as take
    from mvlpt_torch.utils.tree import tree_map

    p = take(init_block_stack(gen, 1, w), 0)
    for ln in ("ln_1", "ln_2"):
        p[ln]["scale"] = 1 + 0.1 * torch.randn(w, generator=gen)
        p[ln]["bias"] = 0.02 * torch.randn(w, generator=gen)
    for grp, key in (("attn", "qkv_b"), ("attn", "out_b"), ("mlp", "fc_b"), ("mlp", "proj_b")):
        p[grp][key] = 0.02 * torch.randn(p[grp][key].shape, generator=gen)
    return tree_map(lambda t: t.to("cuda", dtype).contiguous(), p)


def bound(flops: float, nbytes: float, dtype: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_kernels(shapes: dict) -> list[dict]:
    """Every half-block kernel and mode against its plain twin; returns
    result rows."""
    import torch
    import torch.nn.functional as F

    from mvlpt_torch.ops import block

    rows = []
    # shapes[tower] = (B, S, W, H, mask, seg, n_seq, modes): n_seq sequences
    # of seg tokens hold data (images; or classes packed G to a row);
    # ``modes`` are the kernel modes checked at that shape.
    for (tower, dtype_name), (b, s, w, h, mask, seg, n_seq, modes) in (
            ((t, d), shapes[t]) for t in shapes for d in ("bfloat16", "float32")):
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator().manual_seed(7)
        p = layer_params(w, dtype, gen)
        x = torch.randn((b, s, w), generator=gen).to("cuda", dtype)
        gy = torch.randn((b, s, w), generator=gen).to("cuda", dtype)
        esz = torch.finfo(dtype).bits // 8
        m, d, w4 = b * s, w // h, 4 * w
        ln1, ln2, at, ml = p["ln_1"], p["ln_2"], p["attn"], p["mlp"]
        attn_args = (x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], at["out_w"],
                     at["out_b"], mask, h)
        mlp_args = (x, ln2["scale"], ln2["bias"], ml["fc_w"], ml["fc_b"], ml["proj_w"],
                    ml["proj_b"])
        _, (qkv, probs, mu, rstd) = block.attn_fwd_plain(*attn_args)
        _, (hpre, mu2, rstd2) = block.mlp_fwd_plain(*mlp_args)
        attn_bwd_args = (x, mu, rstd, qkv, probs, ln1["scale"], at["qkv_w"], at["out_w"], gy, h)
        mlp_bwd_args = (x, mu2, rstd2, hpre, ln2["scale"], ml["fc_w"], ml["proj_w"], gy)

        q, k, v = qkv.view(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        sdpa_mask = mask.to(dtype) if mask is not None else None

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)

        # Bytes: each input read once, each output written once. Operations:
        # what this run's data needs; for the packed text rows only the real
        # classes' tokens and the causal part of each class's own block.
        n_tok = n_seq * seg
        core = 4 * h * d * n_seq * (seg * seg if mask is None else seg * (seg + 1) // 2)
        gemm_attn, gemm_mlp = 2 * n_tok * w * 4 * w, 4 * n_tok * w * w4
        act, stats = m * w * esz, 8 * m                  # a (B, S, W) tensor; mu + rstd
        probs_b = b * h * s * s * esz
        mask_b = 0 if mask is None else s * s * 4
        attn_w = (4 * w * w + 6 * w) * esz               # LN, qkv and out weights and biases
        mlp_w = (2 * w * w4 + w4 + 3 * w) * esz          # LN, fc and proj weights and biases
        cases = [
            ("attn_fwd", "train", lambda: block.attn_fwd(*attn_args)[0],
             lambda: block.attn_fwd_plain(*attn_args)[0], gemm_attn + core,
             act + attn_w + mask_b + act + 3 * act + probs_b + stats, sdpa),
            ("attn_fwd", "no-residual",
             lambda: block.attn_fwd(*attn_args, save_residuals=False)[0],
             lambda: block.attn_fwd_plain(*attn_args, save_residuals=False)[0],
             gemm_attn + core, act + attn_w + mask_b + act, sdpa),
            ("attn_bwd", "train", lambda: block.attn_bwd(*attn_bwd_args),
             lambda: block.attn_bwd_plain(*attn_bwd_args), gemm_attn + 2 * core,
             act + stats + 3 * act + probs_b + (4 * w * w + w) * esz + act + act, None),
            ("mlp_fwd", "train", lambda: block.mlp_fwd(*mlp_args)[0],
             lambda: block.mlp_fwd_plain(*mlp_args)[0], gemm_mlp,
             act + mlp_w + act + m * w4 * esz + stats, None),
            ("mlp_fwd", "no-residual",
             lambda: block.mlp_fwd(*mlp_args, save_residuals=False)[0],
             lambda: block.mlp_fwd_plain(*mlp_args, save_residuals=False)[0], gemm_mlp,
             act + mlp_w + act, None),
            ("mlp_bwd", "train", lambda: block.mlp_bwd(*mlp_bwd_args),
             lambda: block.mlp_bwd_plain(*mlp_bwd_args), gemm_mlp,
             act + stats + m * w4 * esz + (2 * w * w4 + w) * esz + act + act, None),
        ]
        for name, mode, kern, plain, flops, nbytes, lib in (c for c in cases if c[1] in modes):
            got = kern()
            torch.cuda.synchronize()
            ref = plain()
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            ok = math.isfinite(err) and err <= TOL[dtype_name] * scale
            bound_ms, bound_by = bound(flops, nbytes, dtype_name)
            row = dict(name=name, mode=mode, tower=tower, dtype=dtype_name,
                       shape=[b, s, w, h], masked=mask is not None, max_abs_err=err,
                       max_abs_ref=scale, tol=TOL[dtype_name] * scale, ok=ok,
                       ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
                       library_ms=None if lib is None else cuda_ms(lib),
                       bound_ms=bound_ms, bound_by=bound_by)
            rows.append(row)
            print("kernel-check " + json.dumps(row), flush=True)
    return _fail_on_disagreement(rows)


def _fail_on_disagreement(rows: list[dict]) -> list[dict]:
    bad = [f"{r['name']} ({r['mode']}, {r['tower']}, {r['dtype']}): max|err| "
           f"{r['max_abs_err']} > {r['tol']}" for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("kernels disagree with their plain twins: " + "; ".join(bad))
    return rows


def check_attend(shapes: dict) -> list[dict]:
    """The standalone attention, forward and backward, against its plain
    twins; returns result rows. ``shapes[name] = (N, S, D, mask)``, N =
    batch x heads."""
    import torch
    import torch.nn.functional as F

    from mvlpt_torch.ops import attention

    rows = []
    for (path, dtype_name), (n, s, d, mask) in (
            ((p, t), shapes[p]) for p in shapes for t in ("bfloat16", "float32")):
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator().manual_seed(11)
        q, k, v, do = (torch.randn((n, s, d), generator=gen).to("cuda", dtype) for _ in range(4))
        sdpa_mask = None if mask is None else mask.to(dtype)
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

        # The library on (1, N, S, D): its fused backends take 4-D inputs.
        def lib_fwd():
            return F.scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=sdpa_mask)

        def lib_bwd():  # forward and backward through autograd
            o = F.scaled_dot_product_attention(qg[None], kg[None], vg[None], attn_mask=sdpa_mask)
            return torch.autograd.grad(o, (qg, kg, vg), do[None])

        # Bytes: each input read once, each output written once. Operations:
        # the (query, key) pairs the mask leaves, for the score and value
        # products (and, backward, the recomputed scores, dv, dp, dq, dk).
        pairs = s * s if mask is None else int((mask > torch.finfo(torch.float32).min / 2).sum())
        rows_b = n * s * d * (torch.finfo(dtype).bits // 8)  # one (N, S, D) tensor
        mask_b = 0 if mask is None else s * s * 4
        cases = [
            ("attend_fwd", lambda: (attention.attend_fwd(q, k, v, mask),),
             lambda: (attention.attend_fwd_plain(q, k, v, mask),), 4 * n * d * pairs,
             4 * rows_b + mask_b, lib_fwd),
            ("attend_bwd", lambda: attention.attend_bwd(q, k, v, mask, do),
             lambda: attention.attend_bwd_plain(q, k, v, mask, do), 10 * n * d * pairs,
             7 * rows_b + mask_b, lib_bwd),
        ]
        for name, kern, plain, flops, nbytes, lib in cases:
            got = kern()
            torch.cuda.synchronize()
            ref = plain()
            errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(got, ref)]
            scales = [r.float().abs().max().item() for r in ref]
            ok = all(math.isfinite(e) and e <= TOL[dtype_name] * sc for e, sc in zip(errs, scales))
            worst = max(range(len(errs)), key=lambda i: errs[i] / scales[i])
            bound_ms, bound_by = bound(flops, nbytes, dtype_name)
            row = dict(name=name, mode="core", tower=path, dtype=dtype_name, shape=[n, s, d],
                       masked=mask is not None, max_abs_err=errs[worst],
                       max_abs_ref=scales[worst], tol=TOL[dtype_name] * scales[worst], ok=ok,
                       ms=cuda_ms(kern), plain_ms=cuda_ms(plain), library_ms=cuda_ms(lib),
                       bound_ms=bound_ms, bound_by=bound_by)
            rows.append(row)
            print("kernel-check " + json.dumps(row), flush=True)
    return _fail_on_disagreement(rows)


def _launches(path: str, kernels: tuple, per: int) -> dict:
    """The launch counts of the path just driven; each of ``kernels``
    must have launched ``per`` times, every other kernel never."""
    from mvlpt_torch.ops import _build

    got = dict(_build.LAUNCHES)
    want = {name: (per if name in kernels else 0) for name in got}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, want {want}")
    return got


def _near(path: str, what: str, got: float, want: float) -> None:
    if not (math.isfinite(got) and abs(got - want) <= 1e-2 * abs(want)):
        raise AssertionError(f"{path}: {what} {got} vs plain path {want} (1e-2 relative)")


def _peak_gib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2 ** 30


def drive_train(selection: str, batches: list, loss_plain: float, ocfg, norm) -> dict:
    """The flagship train step under ``selection``, one step a batch."""
    import torch

    from mvlpt_torch.flagship import flagship
    from mvlpt_torch.ops import _build
    from mvlpt_torch.train import init_train_state, make_train_step

    path = f"train[{selection}]"
    model, backbone, pp, consts, _, clip_cfg = flagship(device="cuda", kernels=selection)
    state = init_train_state(pp, ocfg, 100)
    step = make_train_step(model, normalize=norm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, times = [], []
    for bt in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, backbone, consts, bt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
    layers = clip_cfg.vision_layers + clip_cfg.transformer_layers
    launches = _launches(path, TRAIN_KERNELS[selection], layers * len(batches))
    ms_step = 1e3 * sum(times[1:]) / len(times[1:])
    out = dict(path=path, losses=losses, loss_plain_first=loss_plain, launches=launches,
               ms_per_step=ms_step, img_per_s=len(batches[0]["label"]) * 1e3 / ms_step,
               step_ms=[1e3 * t for t in times], peak_mem_gib=_peak_gib(),
               grad_norm_last=metrics["grad_norm"].item())
    print("main-path " + json.dumps(out), flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{path}: non-finite loss {losses}")
    _near(path, "first loss", losses[0], loss_plain)
    return out


def drive_eval(selection: str, model, backbone, pp, consts, batches: list, ce_plain, norm):
    """The cached-text eval under ``selection``: text features once, then
    the image tower per batch; each batch's logits against the full eval
    step's, the soft-CE against the plain path's."""
    import torch

    from mvlpt_torch.ops import _build
    from mvlpt_torch.train import make_cached_text_eval, make_eval_step, soft_cross_entropy

    path = f"eval[{selection}]"
    text_fn, eval_fn = make_cached_text_eval(model, normalize=norm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    text_features = text_fn(backbone, pp, consts)
    torch.cuda.synchronize()
    text_ms = 1e3 * (time.perf_counter() - t0)
    logits, times = [], []
    for bt in batches:
        t0 = time.perf_counter()
        logits.append(eval_fn(backbone, pp, text_features, bt))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    cfg = model.clip_cfg
    launches = _launches(path, EVAL_KERNELS.get(selection, ()), cfg.vision_layers * len(batches)
                         + cfg.transformer_layers)
    peak = _peak_gib()
    full_step = make_eval_step(model, normalize=norm)
    for i, bt in enumerate(batches):
        full = full_step(backbone, pp, consts, bt)
        if not torch.equal(full, logits[i]):
            diff = (full - logits[i]).abs().max().item()
            raise AssertionError(f"{path}: batch {i}: cached-text logits differ from the full "
                                 f"eval step's by {diff}")
    ce = soft_cross_entropy(torch.cat(logits), torch.cat([bt["label"] for bt in batches])).item()
    out = dict(path=path, launches=launches, text_ms=text_ms, batch_ms=[1e3 * t for t in times],
               img_per_s=EVAL_BATCH * len(times[1:]) / sum(times[1:]), soft_ce=ce,
               soft_ce_plain=ce_plain, peak_mem_gib=peak)
    print("main-path " + json.dumps(out), flush=True)
    if ce_plain is not None:
        _near(path, "soft-CE", ce, ce_plain)
    return out, ce


def drive_zeroshot(selection: str, backbone, clip_cfg, text_features, batches: list, ce_plain,
                   norm):
    """make_zs_infer under ``selection`` at batch EVAL_BATCH against the
    class text features."""
    import torch

    from mvlpt_torch.models.zsclip import make_zs_infer
    from mvlpt_torch.ops import _build
    from mvlpt_torch.train import soft_cross_entropy

    path = f"zeroshot[{selection}]"
    infer = make_zs_infer(clip_cfg, *norm, use_pallas=selection)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    logits, times = [], []
    for bt in batches:
        t0 = time.perf_counter()
        logits.append(infer(backbone, text_features, bt["image"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = _launches(path, EVAL_KERNELS.get(selection, ()),
                         clip_cfg.vision_layers * len(batches))
    ce = soft_cross_entropy(torch.cat(logits), torch.cat([bt["label"] for bt in batches])).item()
    out = dict(path=path, launches=launches, batch_ms=[1e3 * t for t in times],
               img_per_s=EVAL_BATCH * len(times[1:]) / sum(times[1:]), soft_ce=ce,
               soft_ce_plain=ce_plain, peak_mem_gib=_peak_gib())
    print("main-path " + json.dumps(out), flush=True)
    if not all(tuple(x.shape) == (EVAL_BATCH, text_features.shape[0]) for x in logits):
        raise AssertionError(f"{path}: logits of shape {tuple(logits[0].shape)}")
    if ce_plain is not None:
        _near(path, "soft-CE", ce, ce_plain)
    return out, ce


def drive_paths() -> dict:
    """Every path of the port under 'auto' and 'on', each against the plain
    path ('off') on the same seeded inputs."""
    import numpy as np
    import torch

    from mvlpt_torch.config import OptimConfig
    from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, flagship
    from mvlpt_torch.models import MVLPTModel
    from mvlpt_torch.models.zsclip import IMAGENET_TEMPLATES_SELECT, encode_class_text_features
    from mvlpt_torch.ops import _build
    from mvlpt_torch.ops.attention import select_attn_fn
    from mvlpt_torch.train import init_train_state, make_train_step

    norm = (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)
    plain, backbone, pp, consts, _, clip_cfg = flagship(device="cuda", kernels="off")
    res = clip_cfg.image_resolution
    rng = np.random.RandomState(0)

    def batches(n, size):
        return [{"image": torch.from_numpy(rng.randint(0, 256, (size, res, res, 3)).astype(
                     np.uint8)).cuda(),
                 "label": torch.from_numpy(rng.randint(0, 100, size)).cuda()} for _ in range(n)]

    train_batches, eval_batches = batches(STEPS, 32), batches(EVAL_BATCHES, EVAL_BATCH)
    ocfg = OptimConfig(LR=0.002, LR_SCHEDULER="cosine", MAX_EPOCH=200)
    _, m_plain = make_train_step(plain, normalize=norm)(
        init_train_state(pp, ocfg, 100), backbone, consts, train_batches[0])
    loss_plain = m_plain["loss"].item()
    _, ce_eval_plain = drive_eval("off", plain, backbone, pp, consts, eval_batches, None, norm)

    _build.reset_launch_counts()
    classnames = [f"class number {i}" for i in range(100)]
    text_features = encode_class_text_features(backbone, clip_cfg, classnames,
                                               IMAGENET_TEMPLATES_SELECT)
    _launches("zeroshot class text", (), 0)
    if not (text_features.shape == (100, clip_cfg.embed_dim)
            and torch.isfinite(text_features).all()):
        raise AssertionError(f"class text features: {tuple(text_features.shape)}, not finite")
    _, ce_zs_plain = drive_zeroshot("off", backbone, clip_cfg, text_features, eval_batches, None,
                                    norm)

    out = {}
    for sel in ("auto", "on"):
        out[f"train[{sel}]"] = drive_train(sel, train_batches, loss_plain, ocfg, norm)
        model = MVLPTModel(clip_cfg, plain.spec, kernels=select_attn_fn(sel),
                           compute_dtype=plain.compute_dtype)
        out[f"eval[{sel}]"] = drive_eval(sel, model, backbone, pp, consts, eval_batches,
                                         ce_eval_plain, norm)[0]
        out[f"zeroshot[{sel}]"] = drive_zeroshot(sel, backbone, clip_cfg, text_features,
                                                 eval_batches, ce_zs_plain, norm)[0]
    return out


def kernel_entries(results: list[dict], paths: dict) -> list[dict]:
    """One entry a kernel of KERNELS: its bf16 check row's numbers and its
    launches on each path."""
    out = []
    for name, (source, replaces, (kname, mode, shape)) in KERNELS.items():
        r = next(x for x in results if (x["name"], x["mode"], x["tower"], x["dtype"])
                 == (kname, mode, shape, "bfloat16"))
        by_path = {path: p["launches"][name] for path, p in paths.items() if p["launches"][name]}
        out.append({"name": name, "route": "cuda", "source": f"mvlpt_torch/csrc/{source}.cu",
                    "replaces": replaces, "launches": sum(by_path.values()),
                    "launches_by_path": by_path, "shape": r["shape"],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "mvlpt_torch" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout (mvlpt_torch/ is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mvlpt_torch.core.layers import causal_mask
    from mvlpt_torch.core.text import block_causal_mask, packing
    from mvlpt_torch.ops import _build
    from mvlpt_torch.prompts import compute_cut_context_length

    print(card_line(), flush=True)  # name, power limit (nvidia-smi)
    print(setup_vocab(), flush=True)
    t0 = time.perf_counter()
    info = _build.build_kernels()
    for name in _build.SOURCES:
        _build.library(name)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, one process "
          f"a source): {', '.join(info['built']) or 'none, all cached'}", flush=True)
    for name, log in info["ptxas"].items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
        print(f"ptxas {name}: {len(regs)} kernels, at most {max(regs, default=0)} registers "
              f"a thread, {spill} bytes of spills", flush=True)

    s = compute_cut_context_length([f"class number {i}" for i in range(100)], 4)
    g, rows = packing(100, s)
    s_img = 1 + 14 * 14 + 4  # CLS + patches + VPT rows
    packed_mask = block_causal_mask(g, s, device="cuda")
    every, no_residual = ("train", "no-residual"), ("no-residual",)
    results = check_kernels({
        "image": (32, s_img, 768, 12, None, s_img, 32, every),
        "image_eval": (EVAL_BATCH, s_img, 768, 12, None, s_img, EVAL_BATCH, no_residual),
        "text": (rows, g * s, 512, 8, packed_mask, s, 100, every)})
    results += check_attend({
        "image_train": (32 * 12, s_img, 64, None),
        "image_eval": (EVAL_BATCH * 12, s_img, 64, None),
        "text_packed": (rows * 8, g * s, 64, packed_mask),
        "text_clip": (100 * 8, 77, 64, causal_mask(77, device="cuda"))})
    print(f"text tower: s={s}, G={g}, {rows} packed rows of {g * s} tokens", flush=True)
    paths = drive_paths()

    summary = {"card": card_line()}
    for path, out in paths.items():
        summary[path] = {k: out[k] for k in ("ms_per_step", "img_per_s", "peak_mem_gib")
                         if k in out}
    print("summary " + json.dumps(summary), flush=True)

    print(json.dumps({"kernels": kernel_entries(results, paths)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
