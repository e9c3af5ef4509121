#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mvlpt_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

1. Builds the six kernel sources of mvlpt_torch/csrc with nvcc (sm_90a),
   one process a source, and prints the build time, the vocab in use and
   the card.
2. Holds each kernel against its plain PyTorch twin on the card, in fp32
   and bf16: the tensor-parallel parts at tp = 2 on rank 0's shard of
   the image train and packed text shapes, and the tp shards' partials
   summed and finished as the single-device kernels' outputs; the
   half-block kernels at the flagship shapes (ViT-B/16
   image tower at batch 32, and at the eval batch 100 for the
   no-residual forwards; class-packed text tower with its block-causal
   mask), and the standalone attention (forward and backward) at the
   image train and eval shapes, the packed text rows, CLIP's full text
   context and the edges of the tensor-core tiling (S = 1, 17, 261 and
   each route's largest S), each row naming its route (bf16 on the
   tensor cores, fp32 on the CUDA cores; the MLP forwards' rows too:
   bf16 through the wgmma GEMM); in bf16 each standalone-attention
   wrapper may request nothing beyond its outputs (and the backward's
   row statistics), and mlp_fwd nothing beyond its outputs and its xh
   and act scratch. ptxas must report no spills for any tensor-core
   kernel (the attention's and the wgmma GEMM's), in this run's build or
   the cached one's, and mlp_fwd's library must hold HGMMA in its SASS.
   Times kernel, twin and a library call computing the same function
   (scaled_dot_product_attention on the attention core), and, as a
   yardstick for the MLP forwards' products alone, cuBLAS's two
   products on the same xh and act (gemm_library_ms).
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
     at batch 100 under 'auto' and 'on', held as eval is;
   - the tensor-parallel train step, train[tp2]: two ranks in two spawned
     processes share the one card as a (data=1, model=2) mesh, each with
     its Megatron shard of the flagship, for a few SGD steps under
     'block'. Rank 0's first loss and grad norm held to train[auto]'s on
     the same batch (TP_REL), in bf16 and, for one more step, in fp32;
     each rank's layer 0 of both towers (y and dx, through the
     all-reduce) against #1-#4 on the full weights within TOL, in bf16
     and fp32, and equal across the ranks; the prompt params bit-equal
     across the ranks afterwards; and on each rank only the four
     tensor-parallel kernels launched, 24 times a step.
     Its step time is that of two processes time-slicing one card with
     all-reduces through the host: it is not a tensor-parallel speed.
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
TP = 2                    # model ranks of the tensor-parallel phases
TP_STEPS = 4              # SGD steps of train[tp2]
TP_TIMEOUT_S = 420        # the spawned ranks' deadline
# train[tp2]'s first loss and grad norm against train[auto]'s on the same
# batch, relative. In bf16 another summation order alone moves them by up
# to 3e-4 and 1.1e-2 on an H100 (scripts/torch_port_tp_drift.py), and
# uniform logits would move the loss by 4.8e-3; in fp32 the same
# comparisons agree within 1e-6.
TP_REL = {"bfloat16": {"loss": 1e-3, "grad_norm": 2e-2},
          "float32": {"loss": 1e-5, "grad_norm": 1e-5}}
OPTIM = dict(LR=0.002, LR_SCHEDULER="cosine", MAX_EPOCH=200)
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
    "attn_fwd_tp": ("attn_fwd", "mvlpt_tpu/ops/block.py:902", ("attn_fwd_tp", "part", "image")),
    "attn_bwd_tp": ("attn_bwd", "mvlpt_tpu/ops/block.py:966", ("attn_bwd_tp", "part", "image")),
    "mlp_fwd_tp": ("mlp_fwd", "mvlpt_tpu/ops/block.py:1024", ("mlp_fwd_tp", "part", "image")),
    "mlp_bwd_tp": ("mlp_bwd", "mvlpt_tpu/ops/block.py:1072", ("mlp_bwd_tp", "part", "image")),
}
# Kernels each path must launch, and how many times per unit of work
# (per train step or per layer-tower pass); every other kernel, 0 times.
TRAIN_KERNELS = {"auto": ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd"),
                 "on": ("attend_fwd", "attend_bwd")}
EVAL_KERNELS = {"auto": ("attn_fwd_infer", "mlp_fwd_infer"), "on": ("attend_fwd",)}
TP_KERNELS = ("attn_fwd_tp", "attn_bwd_tp", "mlp_fwd_tp", "mlp_bwd_tp")


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
        gemm_lib = mlp_gemm_library(*mlp_args[:6])
        for name, mode, kern, plain, flops, nbytes, lib in (c for c in cases if c[1] in modes):
            got, alloc = requested(kern)
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
            if name == "mlp_fwd":
                # The bf16 route's wrapper requests its outputs and the xh
                # and act scratch, nothing more.
                train = mode == "train"
                want = act + (m * w4 * esz + stats if train else 0) + act + m * w4 * esz
                row.update(route=block.MLP_ROUTES[dtype], gemm_library_ms=cuda_ms(gemm_lib),
                           requested_bytes=alloc, want_bytes=want)
                if dtype == torch.bfloat16 and alloc != want:
                    raise AssertionError(f"mlp_fwd ({mode}, {tower}, bf16): requested {alloc} "
                                         f"bytes, not those of its outputs and scratch ({want})")
            rows.append(row)
            print("kernel-check " + json.dumps(row), flush=True)
    return _fail_on_disagreement(rows)


def requested(fn):
    """fn()'s result and the bytes it asked the caching allocator for at
    its peak. Its block counts (memory_allocated) would add whatever a
    cached free block holds beyond the request when it is reused unsplit."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    got = fn()
    torch.cuda.synchronize()
    return got, torch.cuda.memory_stats()["requested_bytes.all.peak"] - before


def mlp_gemm_library(x, ln_scale, ln_bias, fc_w, fc_b, proj_w):
    """A yardstick for the MLP forwards' two products alone, not the same
    function (no LayerNorm, epilogues or rounding between): cuBLAS
    (torch.matmul) in x's dtype on the twin's xh and act, which the port
    never calls. Returns the callable that gemm_library_ms times."""
    import torch

    from mvlpt_torch.ops import block

    xh = block._ln2d(x.float(), ln_scale.float(), ln_bias.float(), 1e-5)[0].to(x.dtype)
    act = block._mlp_hidden_plain(x, ln_scale, ln_bias, fc_w, fc_b, 1e-5)[0]
    w, w4 = fc_w.shape
    return lambda: (torch.matmul(xh.view(-1, w), fc_w), torch.matmul(act.view(-1, w4), proj_w))


def _fail_on_disagreement(rows: list[dict]) -> list[dict]:
    bad = [f"{r['name']} ({r['mode']}, {r['tower']}, {r['dtype']}): max|err| "
           f"{r['max_abs_err']} > {r['tol']}" for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("kernels disagree with their plain twins: " + "; ".join(bad))
    return rows


def check_tp_kernels(shapes: dict) -> list[dict]:
    """The tensor-parallel parts (#7-#10) against their plain twins on
    rank 0's shard at tp = TP; then the TP shards' partials summed in fp32
    and finished (bias, rounding, residual; or the LayerNorm backward)
    against the single-device kernels #1-#4. Returns result rows."""
    import torch

    from mvlpt_torch.ops import block
    from mvlpt_torch.parallel import shard_blocks

    rows, joined = [], []
    for (tower, dtype_name), (b, s, w, h, mask, seg, n_seq) in (
            ((t, d), shapes[t]) for t in shapes for d in ("bfloat16", "float32")):
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator().manual_seed(13)
        p = layer_params(w, dtype, gen)
        x = torch.randn((b, s, w), generator=gen).to("cuda", dtype)
        gy = torch.randn((b, s, w), generator=gen).to("cuda", dtype)
        esz = torch.finfo(dtype).bits // 8
        m, d, hl, wl, w4l = b * s, w // h, h // TP, w // TP, 4 * w // TP
        ln1, ln2 = p["ln_1"], p["ln_2"]
        shards = [shard_blocks(p, h, TP, r) for r in range(TP)]

        def attn_args(r):
            at = shards[r]["attn"]
            return (x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], at["out_w"], mask, hl)

        def mlp_args(r):
            ml = shards[r]["mlp"]
            return (x, ln2["scale"], ln2["bias"], ml["fc_w"], ml["fc_b"], ml["proj_w"])

        fwd_res = [block.attn_fwd_part_plain(*attn_args(r))[1] for r in range(TP)]
        mlp_res = [block.mlp_fwd_part_plain(*mlp_args(r))[1] for r in range(TP)]

        def attn_bwd_args(r):
            at = shards[r]["attn"]
            return (fwd_res[r][0], fwd_res[r][1], at["qkv_w"], at["out_w"], gy, hl)

        def mlp_bwd_args(r):
            ml = shards[r]["mlp"]
            return (mlp_res[r][0], ml["fc_w"], ml["proj_w"], gy)

        # Bytes: each input read once, each output written once, on rank
        # 0's shard. Operations: what this run's data needs (see
        # check_kernels).
        n_tok = n_seq * seg
        core = 4 * hl * d * n_seq * (seg * seg if mask is None else seg * (seg + 1) // 2)
        gemm_attn, gemm_mlp = 2 * n_tok * w * 4 * wl, 4 * n_tok * w * w4l
        act, part, stats = m * w * esz, m * w * 4, 8 * m  # (B, S, W); fp32 partial; mu + rstd
        probs_b, qkv_b = b * hl * s * s * esz, m * 3 * wl * esz
        mask_b = 0 if mask is None else s * s * 4
        attn_w, mlp_w = 4 * w * wl * esz, 2 * w * w4l * esz
        cases = [
            ("attn_fwd_tp", lambda: block.attn_fwd_part(*attn_args(0))[0],
             lambda: block.attn_fwd_part_plain(*attn_args(0))[0], gemm_attn + core,
             act + attn_w + (3 * wl + 2 * w) * esz + mask_b + part + qkv_b + probs_b + stats),
            ("attn_bwd_tp", lambda: block.attn_bwd_part(*attn_bwd_args(0)),
             lambda: block.attn_bwd_part_plain(*attn_bwd_args(0)), gemm_attn + 2 * core,
             qkv_b + probs_b + attn_w + act + part),
            ("mlp_fwd_tp", lambda: block.mlp_fwd_part(*mlp_args(0))[0],
             lambda: block.mlp_fwd_part_plain(*mlp_args(0))[0], gemm_mlp,
             act + mlp_w + (w4l + 2 * w) * esz + part + m * w4l * esz + stats),
            ("mlp_bwd_tp", lambda: block.mlp_bwd_part(*mlp_bwd_args(0)),
             lambda: block.mlp_bwd_part_plain(*mlp_bwd_args(0)), gemm_mlp,
             m * w4l * esz + mlp_w + act + part),
        ]
        for name, kern, plain, flops, nbytes in cases:
            got = kern()
            torch.cuda.synchronize()
            ref = plain()
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            bound_ms, bound_by = bound(flops, nbytes, dtype_name)
            row = dict(name=name, mode="part", tower=tower, dtype=dtype_name,
                       shape=[b, s, w, hl if "attn" in name else w4l], tp=TP,
                       masked=mask is not None, max_abs_err=err, max_abs_ref=scale,
                       tol=TOL[dtype_name] * scale,
                       ok=math.isfinite(err) and err <= TOL[dtype_name] * scale,
                       ms=cuda_ms(kern), plain_ms=cuda_ms(plain), library_ms=None,
                       bound_ms=bound_ms, bound_by=bound_by)
            if name == "mlp_fwd_tp":
                row.update(route=block.MLP_ROUTES[dtype],
                           gemm_library_ms=cuda_ms(mlp_gemm_library(*mlp_args(0))))
            rows.append(row)
            print("kernel-check " + json.dumps(row), flush=True)

        # The TP shards' kernels, summed and finished, against #1-#4.
        at, ml = p["attn"], p["mlp"]
        y_attn, (qkv, probs, mu, rstd) = block.attn_fwd(
            x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], at["out_w"], at["out_b"],
            mask, h)
        y_mlp, (hpre, mu2, rstd2) = block.mlp_fwd(
            x, ln2["scale"], ln2["bias"], ml["fc_w"], ml["fc_b"], ml["proj_w"], ml["proj_b"])
        fa = [block.attn_fwd_part(*attn_args(r)) for r in range(TP)]
        fm = [block.mlp_fwd_part(*mlp_args(r)) for r in range(TP)]
        ya, ym = sum(y for y, _ in fa), sum(y for y, _ in fm)
        parts, mparts = [res for _, res in fa], [res for _, res in fm]
        dxa = sum(block.attn_bwd_part(parts[r][0], parts[r][1], shards[r]["attn"]["qkv_w"],
                                      shards[r]["attn"]["out_w"], gy, hl) for r in range(TP))
        dxm = sum(block.mlp_bwd_part(mparts[r][0], shards[r]["mlp"]["fc_w"],
                                     shards[r]["mlp"]["proj_w"], gy) for r in range(TP))
        pairs = [
            ("attn_fwd_tp", x + (ya + at["out_b"].float()).to(dtype), y_attn),
            ("mlp_fwd_tp", x + (ym + ml["proj_b"].float()).to(dtype), y_mlp),
            ("attn_bwd_tp", block._ln_bwd(x, parts[0][2], parts[0][3], ln1["scale"], dxa, gy),
             block.attn_bwd(x, mu, rstd, qkv, probs, ln1["scale"], at["qkv_w"], at["out_w"], gy,
                            h)),
            ("mlp_bwd_tp", block._ln_bwd(x, mparts[0][1], mparts[0][2], ln2["scale"], dxm, gy),
             block.mlp_bwd(x, mu2, rstd2, hpre, ln2["scale"], ml["fc_w"], ml["proj_w"], gy)),
        ]
        for name, got, ref in pairs:
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            row = dict(name=name, mode="reassembled", tower=tower, dtype=dtype_name, tp=TP,
                       max_abs_err=err, max_abs_ref=scale, tol=TOL[dtype_name] * scale,
                       ok=math.isfinite(err) and err <= TOL[dtype_name] * scale)
            joined.append(row)
            print("tp-reassembly " + json.dumps(row), flush=True)
    _fail_on_disagreement(joined)
    return _fail_on_disagreement(rows)


def check_attend(shapes: dict) -> list[dict]:
    """The standalone attention, forward and backward, against its plain
    twins; returns result rows, each with the route its dtype took
    (``attention.ROUTES``). ``shapes[name] = (N, S, D, mask, dtypes,
    kernels)``, N = batch x heads. On the bf16 route each wrapper must
    request from the allocator its outputs (and the backward its (3, N, S)
    row statistics) and nothing more: no (N, S, S) tensor."""
    import torch
    import torch.nn.functional as F

    from mvlpt_torch.ops import attention

    rows = []
    for (path, dtype_name), (n, s, d, mask, _, names) in (
            ((p, t), shapes[p]) for p in shapes for t in shapes[p][4]):
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
        for name, kern, plain, flops, nbytes, lib in (c for c in cases if c[0] in names):
            got, alloc = requested(kern)
            ref = plain()
            errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(got, ref)]
            scales = [r.float().abs().max().item() for r in ref]
            ok = all(math.isfinite(e) and e <= TOL[dtype_name] * sc for e, sc in zip(errs, scales))
            worst = max(range(len(errs)), key=lambda i: errs[i] / max(scales[i], 1e-30))
            bound_ms, bound_by = bound(flops, nbytes, dtype_name)
            # In bf16: the outputs and, backward, the row statistics; nothing
            # more, so no (N, S, S) tensor.
            want = len(got) * rows_b
            if name == "attend_bwd" and dtype == torch.bfloat16:
                want += 3 * n * s * 4
            row = dict(name=name, mode="core", tower=path, dtype=dtype_name, shape=[n, s, d],
                       route=attention.ROUTES[dtype], masked=mask is not None,
                       max_abs_err=errs[worst], max_abs_ref=scales[worst],
                       tol=TOL[dtype_name] * scales[worst], ok=ok, requested_bytes=alloc,
                       ms=cuda_ms(kern), plain_ms=cuda_ms(plain), library_ms=cuda_ms(lib),
                       bound_ms=bound_ms, bound_by=bound_by)
            rows.append(row)
            print("kernel-check " + json.dumps(row), flush=True)
            if dtype == torch.bfloat16 and alloc != want:
                raise AssertionError(f"{name} ({path}, bf16): requested {alloc} bytes, not "
                                     f"those of its outputs and row statistics ({want})")
    return _fail_on_disagreement(rows)


# The tensor-core kernels of each source, by their mangled names: the
# bf16 route of attend_fwd.cu / attend_bwd.cu (one kernel a register
# bucket NT) and mlp_fwd.cu's wgmma GEMM (one an epilogue EPI and tile
# width BN).
TC_KERNELS = {"attend_fwd": r"attend_fwd_tc", "attend_bwd": r"attend_bwd_(?:dq|dkv)_tc",
              "mlp_fwd": r"wgmma_gemm_kernel"}
# setmaxnreg's split in csrc/wgmma.cuh needs the 168 registers a thread
# that a block of 384 threads holds at entry; with fewer, the consumers'
# request could never be met.
WGMMA_ENTRY_REGS = 168


def tc_ptxas(log: str, pattern: str) -> list[tuple[str, int, int]]:
    """(kernel<template arguments>, registers, bytes of spills) of each
    kernel whose mangled name matches ``pattern`` in one source's ptxas
    -v log, read per kernel because the fp32 routes share the sources."""
    rows = []
    for chunk in log.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        kernel = re.search(pattern, mangled)
        if kernel is None:
            continue
        args = re.search(r"ILi(\d+)E(?:Li(\d+)E)?E", mangled)
        label = ("?" if args is None else
                 f"NT={args.group(1)}" if args.group(2) is None
                 else f"EPI={args.group(1)},BN={args.group(2)}")
        regs = re.search(r"Used (\d+) registers", chunk)
        rows.append((f"{kernel.group(0)}<{label}>", int(regs.group(1)) if regs else -1,
                     sum(int(b) for b in re.findall(r"(\d+) bytes spill", chunk))))
    return rows


def check_tc_spills(logs: dict) -> None:
    """ptxas's registers and spills of each tensor-core kernel
    (TC_KERNELS), printed; any spill fails the run, and so does a source
    whose build log (``_build.build_kernels``: this run's or the cached
    library's) names no such kernel, or a wgmma GEMM kernel holding fewer
    than WGMMA_ENTRY_REGS registers."""
    rows = []
    for src, pattern in TC_KERNELS.items():
        found = tc_ptxas(logs[src], pattern)
        if not found:
            raise AssertionError(f"ptxas: no tensor-core kernel in {src}.cu's build log")
        rows += found
    for label, regs, spill in rows:
        print(f"ptxas {label}: {regs} registers, {spill} bytes of spills", flush=True)
    spilled = [label for label, _, spill in rows if spill]
    if spilled:
        raise AssertionError(f"ptxas: tensor-core kernels spill: {spilled}")
    short = [label for label, regs, _ in rows
             if label.startswith("wgmma") and regs < WGMMA_ENTRY_REGS]
    if short:
        raise AssertionError(f"ptxas: wgmma GEMM kernels below {WGMMA_ENTRY_REGS} registers "
                             f"at entry, which setmaxnreg's split needs: {short}")


def check_hgmma() -> None:
    """The built mlp_fwd library's SASS (the toolkit's cuobjdump) must
    hold HGMMA, the instruction wgmma compiles to: the bf16 route really
    reaches the tensor cores through wgmma."""
    from mvlpt_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(_build._lib_path("mlp_fwd"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    count = len(re.findall(r"\bHGMMA\.", sass))
    print(f"sass mlp_fwd: {count} HGMMA instructions", flush=True)
    if not count:
        raise AssertionError("sass: no HGMMA in mlp_fwd's library: the bf16 route misses wgmma")


def _launches(path: str, kernels: tuple, per: int) -> dict:
    """The launch counts of the path just driven; each of ``kernels``
    must have launched ``per`` times, every other kernel never."""
    from mvlpt_torch.ops import _build

    return _launches_of(path, dict(_build.LAUNCHES), kernels, per)


def _launches_of(path: str, got: dict, kernels: tuple, per: int) -> dict:
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
    losses, grad_norms, times = [], [], []
    for bt in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, backbone, consts, bt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        grad_norms.append(metrics["grad_norm"].item())
    layers = clip_cfg.vision_layers + clip_cfg.transformer_layers
    launches = _launches(path, TRAIN_KERNELS[selection], layers * len(batches))
    ms_step = 1e3 * sum(times[1:]) / len(times[1:])
    out = dict(path=path, losses=losses, loss_plain_first=loss_plain, grad_norms=grad_norms,
               launches=launches, ms_per_step=ms_step,
               img_per_s=len(batches[0]["label"]) * 1e3 / ms_step,
               step_ms=[1e3 * t for t in times], peak_mem_gib=_peak_gib())
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


def _tp_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of train[tp2], in its own spawned process: the flagship on
    a (data=1, model=world) mesh over the one card. First layer 0 of each
    tower, forward and dx, on its shard and the parent's inputs; then
    TP_STEPS SGD steps under 'block' on the parent's batches. Writes
    rank{rank}.json (losses, grad norms, step times, launches, peak
    memory) and rank{rank}.pt (the blocks' y and dx, the prompt params
    after the steps), or rank{rank}.err with the traceback."""
    import traceback

    import torch
    import torch.distributed as dist

    work = Path(workdir)
    try:
        from mvlpt_torch.config import OptimConfig
        from mvlpt_torch.core.layers import layer_params as take
        from mvlpt_torch.core.layers import residual_block
        from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, flagship
        from mvlpt_torch.ops import _build
        from mvlpt_torch.parallel import create_mesh
        from mvlpt_torch.train import init_train_state, make_train_step
        from mvlpt_torch.utils.tree import tree_leaves

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # NCCL refuses two ranks on one device, so the ranks use gloo,
        # whose all_reduce takes CUDA tensors (through host memory); the
        # mesh's groups inherit it.
        dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                                world_size=world)
        mesh = create_mesh(1, world)
        inputs = torch.load(work / "inputs.pt", weights_only=True)
        batches = [{k: v.cuda() for k, v in bt.items()} for bt in inputs["batches"]]
        norm = (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)
        blocks = {}

        def layer0(model, backbone, clip_cfg, dt):
            for tower, (x, gy, mask) in inputs["blocks"].items():
                heads = clip_cfg.vision_heads if tower == "visual" else clip_cfg.transformer_heads
                x = x.to("cuda", getattr(torch, dt)).requires_grad_(True)
                y = residual_block(x, take(backbone[tower]["blocks"], 0), heads,
                                   None if mask is None else mask.cuda(), model.kernels)
                (dx,) = torch.autograd.grad(y, x, gy.to("cuda", x.dtype))
                blocks[f"{tower}/{dt}"] = (y.detach().cpu(), dx.cpu())

        model, backbone, pp, consts, _, clip_cfg = flagship(device="cuda", kernels="block",
                                                            mesh=mesh)
        layer0(model, backbone, clip_cfg, "bfloat16")
        state = init_train_state(pp, OptimConfig(**OPTIM), 100)
        step = make_train_step(model, normalize=norm, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        losses, grad_norms, times = [], [], []
        for bt in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, backbone, consts, bt)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(metrics["loss"].item())
            grad_norms.append(metrics["grad_norm"].item())
        launches, peak = dict(_build.LAUNCHES), _peak_gib()
        # After the path's counts, in fp32, where no bf16 rounding flips:
        # layer 0 again, and one step on the first batch, which holds the
        # path to fp32 'auto' tightly.
        model, backbone, pp, consts, _, _ = flagship(device="cuda", compute_dtype=torch.float32,
                                                     kernels="block", mesh=mesh)
        layer0(model, backbone, clip_cfg, "float32")
        _, m32 = make_train_step(model, normalize=norm, mesh=mesh)(
            init_train_state(pp, OptimConfig(**OPTIM), 100), backbone, consts, batches[0])
        (work / f"rank{rank}.json").write_text(json.dumps(dict(
            losses=losses, grad_norms=grad_norms, step_ms=[1e3 * t for t in times],
            launches=launches, peak_mem_gib=peak,
            fp32_first={"loss": m32["loss"].item(), "grad_norm": m32["grad_norm"].item()})))
        torch.save({"blocks": blocks,
                    "params": [t.detach().cpu() for t in tree_leaves(state.prompt_params)]},
                   work / f"rank{rank}.pt")
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _tp_block_check(path: str, backbones: dict, clip_cfg, inputs: dict, got: list) -> dict:
    """Each rank's sharded layer 0 of each tower (y and dx, through the
    all-reduce) against kernels #1-#4 on the full weights of
    ``backbones[dtype]``, within TOL; and bit-equal across the ranks."""
    import torch

    from mvlpt_torch.core.layers import layer_params as take
    from mvlpt_torch.ops.block import fused_residual_block

    out = {}
    for dt, backbone in backbones.items():
        for tower, (x, gy, mask) in inputs.items():
            heads = clip_cfg.vision_heads if tower == "visual" else clip_cfg.transformer_heads
            key = f"{tower}/{dt}"
            xr = x.to("cuda", getattr(torch, dt)).requires_grad_(True)
            y = fused_residual_block(xr, take(backbone[tower]["blocks"], 0), heads,
                                     None if mask is None else mask.cuda())
            (dx,) = torch.autograd.grad(y, xr, gy.to("cuda", xr.dtype))
            for name, ref, k in (("y", y.detach().cpu(), 0), ("dx", dx.cpu(), 1)):
                mine = got[0][key][k]
                err = (mine.float() - ref.float()).abs().max().item()
                tol = TOL[dt] * ref.float().abs().max().item()
                out[f"{key}/{name}"] = dict(max_abs_err=err, tol=tol,
                                            differ_share=(mine != ref).float().mean().item())
                if not (math.isfinite(err) and err <= tol):
                    raise AssertionError(f"{path}: {key} layer 0 {name} differs from #1-#4 by "
                                         f"{err} > {tol}")
                if not all(torch.equal(mine, g[key][k]) for g in got[1:]):
                    raise AssertionError(f"{path}: {key} layer 0 {name} differs across ranks")
    return out


def drive_tp_train(batches: list, blocks: dict, backbones: dict, clip_cfg, auto: dict,
                   auto32: dict) -> dict:
    """train[tp2]: TP spawned ranks share the card. The kernels are built
    already, so the ranks only load them; the batches and the block
    inputs go to them in one file under build/. Rank 0's first loss and
    grad norm are held to train[auto]'s on the same batch (``auto32``:
    its first step in fp32), the blocks to #1-#4 on the full weights
    ``backbones[dtype]``."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    path = "train[tp2]"
    work = ROOT / "build" / "chip_smoke_tp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.save({"batches": [{k: v.cpu() for k, v in bt.items()} for bt in batches],
                "blocks": blocks}, work / "inputs.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_tp_rank, args=(r, TP, str(work))) for r in range(TP)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    try:
        for proc in procs:
            proc.join(max(1.0, TP_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    errs = {r: (work / f"rank{r}.err").read_text() for r in range(TP)
            if (work / f"rank{r}.err").is_file()}
    if hung or errs or any(proc.exitcode != 0 for proc in procs):
        raise AssertionError(f"{path}: ranks still running after {TP_TIMEOUT_S} s: {hung}; "
                             f"exit codes {[proc.exitcode for proc in procs]}; errors {errs}")
    wall_s = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(TP)]
    saved = [torch.load(work / f"rank{r}.pt", weights_only=True) for r in range(TP)]
    layers = clip_cfg.vision_layers + clip_cfg.transformer_layers  # a step, on each rank
    launches = [_launches_of(f"{path} rank {r}", ranks[r]["launches"], TP_KERNELS,
                             layers * len(batches)) for r in range(TP)]
    losses, grad_norms, fp32 = ranks[0]["losses"], ranks[0]["grad_norms"], ranks[0]["fp32_first"]
    ms_step = sum(ranks[0]["step_ms"][1:]) / len(ranks[0]["step_ms"][1:])
    out = dict(path=path, mesh={"data": 1, "model": TP}, losses=losses, grad_norms=grad_norms,
               loss_auto_first=auto["losses"][0], grad_norm_auto_first=auto["grad_norms"][0],
               loss_plain_first=auto["loss_plain_first"], fp32_first=fp32,
               fp32_auto_first=auto32, launches=launches[0],
               launches_by_rank=launches, ms_per_step=ms_step,
               img_per_s=len(batches[0]["label"]) * 1e3 / ms_step,
               step_ms=[x["step_ms"] for x in ranks],
               peak_mem_gib=max(x["peak_mem_gib"] for x in ranks),
               peak_mem_gib_by_rank=[x["peak_mem_gib"] for x in ranks], wall_s=wall_s,
               blocks=_tp_block_check(path, backbones, clip_cfg, blocks,
                                      [x["blocks"] for x in saved]))
    print("main-path " + json.dumps(out), flush=True)
    if not all(math.isfinite(v) for x in ranks for v in x["losses"]):
        raise AssertionError(f"{path}: non-finite loss {[x['losses'] for x in ranks]}")
    for dt, what, got, want in (
            ("bfloat16", "loss", losses[0], auto["losses"][0]),
            ("bfloat16", "grad_norm", grad_norms[0], auto["grad_norms"][0]),
            ("float32", "loss", fp32["loss"], auto32["loss"]),
            ("float32", "grad_norm", fp32["grad_norm"], auto32["grad_norm"])):
        if not (math.isfinite(got) and abs(got - want) <= TP_REL[dt][what] * abs(want)):
            raise AssertionError(f"{path}: rank 0's first {what} in {dt} {got} vs "
                                 f"train[auto]'s {want} ({TP_REL[dt][what]} relative)")
    for r in range(1, TP):
        if not all(torch.equal(a, b) for a, b in zip(saved[0]["params"], saved[r]["params"])):
            raise AssertionError(f"{path}: prompt params of rank {r} differ from rank 0's")
    return out


def drive_paths(tp_blocks: dict) -> dict:
    """Every path of the port under 'auto' and 'on', each against the
    plain path ('off') on the same seeded inputs; then the tensor-parallel
    train step against 'auto'. ``tp_blocks[tower] = (B, S, mask)`` are
    the shapes of train[tp2]'s layer-0 checks."""
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
    ocfg = OptimConfig(**OPTIM)
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
    model32, backbone32, pp32, consts32, _, _ = flagship(
        device="cuda", compute_dtype=torch.float32, kernels="auto")
    _, m32 = make_train_step(model32, normalize=norm)(
        init_train_state(pp32, ocfg, 100), backbone32, consts32, train_batches[0])
    auto32 = {"loss": m32["loss"].item(), "grad_norm": m32["grad_norm"].item()}
    gen = torch.Generator().manual_seed(17)
    widths = {"visual": clip_cfg.vision_width, "text": clip_cfg.transformer_width}
    blocks = {tower: (torch.randn((b, s, widths[tower]), generator=gen).to(torch.bfloat16),
                      torch.randn((b, s, widths[tower]), generator=gen).to(torch.bfloat16),
                      None if mask is None else mask.cpu())
              for tower, (b, s, mask) in tp_blocks.items()}
    out["train[tp2]"] = drive_tp_train(train_batches[:TP_STEPS], blocks,
                                       {"bfloat16": backbone, "float32": backbone32}, clip_cfg,
                                       out["train[auto]"], auto32)
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
                    "library_ms": r["library_ms"],
                    # The row's route by dtype (MLP_ROUTES, attention.ROUTES) and
                    # the MLP products' cuBLAS yardstick, where the row has them.
                    **({"dtype_route": r["route"]} if "route" in r else {}),
                    **({"gemm_library_ms": r["gemm_library_ms"]} if "gemm_library_ms" in r
                       else {})})
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
        print(f"ptxas {name}{'' if name in info['built'] else ' (cached build)'}: {len(regs)} "
              f"kernels, at most {max(regs, default=0)} registers a thread, {spill} bytes of "
              f"spills", flush=True)
    check_tc_spills(info["ptxas"])
    check_hgmma()

    s = compute_cut_context_length([f"class number {i}" for i in range(100)], 4)
    g, rows = packing(100, s)
    s_img = 1 + 14 * 14 + 4  # CLS + patches + VPT rows
    packed_mask = block_causal_mask(g, s, device="cuda")
    every, no_residual = ("train", "no-residual"), ("no-residual",)
    results = check_kernels({
        "image": (32, s_img, 768, 12, None, s_img, 32, every),
        "image_eval": (EVAL_BATCH, s_img, 768, 12, None, s_img, EVAL_BATCH, no_residual),
        "text": (rows, g * s, 512, 8, packed_mask, s, 100, every)})
    results += check_tp_kernels({
        "image": (32, s_img, 768, 12, None, s_img, 32),
        "text": (rows, g * s, 512, 8, packed_mask, s, 100)})
    both, fb = ("bfloat16", "float32"), ("attend_fwd", "attend_bwd")
    results += check_attend({
        "image_train": (32 * 12, s_img, 64, None, both, fb),
        "image_eval": (EVAL_BATCH * 12, s_img, 64, None, both, fb),
        "text_packed": (rows * 8, g * s, 64, packed_mask, both, fb),
        "text_clip": (100 * 8, 77, 64, causal_mask(77, device="cuda"), both, fb),
        # The tiling's edges: below one mma tile, ragged, ViT-L/14 with 4
        # VPT rows (8 images x 16 heads), and each route's largest S.
        "edge_s1": (64, 1, 64, None, both, fb),
        "edge_s17": (64, 17, 64, causal_mask(17, device="cuda"), both, fb),
        "vitl_s261": (8 * 16, 1 + 16 * 16 + 4, 64, None, both, fb),
        "max_fwd_bf16": (64, 352, 64, None, ("bfloat16",), ("attend_fwd",)),
        "max_fwd_fp32": (64, 348, 64, None, ("float32",), ("attend_fwd",)),
        "max_bwd_bf16": (64, 280, 64, causal_mask(280, device="cuda"), ("bfloat16",),
                         ("attend_bwd",)),
        "max_bwd_fp32": (64, 278, 64, None, ("float32",), ("attend_bwd",))})
    print(f"text tower: s={s}, G={g}, {rows} packed rows of {g * s} tokens", flush=True)
    paths = drive_paths({"visual": (32, s_img, None), "text": (rows, g * s, packed_mask)})

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
