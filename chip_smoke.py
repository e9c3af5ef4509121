#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mvlpt_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

1. Builds the six kernel sources of mvlpt_torch/csrc with nvcc (sm_90a),
   one process a source, and prints the build time, the vocab in use and
   the card.
2. Holds each kernel against its plain PyTorch twin on the card, in fp32
   and bf16: the tensor-parallel parts at tp = 2 on rank 0's shard of
   the image train and packed text shapes, and the tp shards' partials
   summed and finished against the plain twin on the full weights (the
   single-device kernels' outputs printed beside it); the
   half-block kernels at the flagship shapes (ViT-B/16
   image tower at batch 32, and at the eval batch 100 for the
   no-residual forwards; class-packed text tower with its block-causal
   mask); the attention half-blocks (#1, #2, #5, and #7/#8 at tp = 2) at
   ViT-L/14@336px width and length (W = 1024, H = 16, S = 581, batch 4);
   the attention half-blocks (#1, #2, #5, and #7/#8 at tp = 2) at
   S = 1024 under a causal mask, past the bf16 cores' windows of keys;
   and the standalone attention (forward and backward) at the image
   train and eval shapes, the packed text rows, CLIP's full text context,
   the edges of the tensor-core tiling (S = 1, 17, 261, each bf16
   bucket's largest S and one past it, the fp32 kernels' largest S before
   they streamed their rows) and S = 581 and 1024; and the backwards'
   K-major wgmma GEMM alone (the MLP backward's two epilogues and the
   attention backward's rounding one, both tile widths) at the image, text
   and ViT-L/14@336px rows and a ragged edge. fp32 rows
   hold to 1e-4 x max|twin|; bf16 rows to the rule at TOL, against the
   twin and the fp64-summed twin, each printing the old bound's verdict
   beside it (ok_old). The attention forwards in train mode (#1, #7) are
   held on each output: y (or the fp32 partial), and the residuals qkv,
   probs, mu and rstd that the backward reads. Each row names its route where it has more than
   one: the standalone attention's by dtype and S (attention.route_of:
   bf16 on the tensor cores up to the buckets, on the CUDA cores past
   them; fp32 on the CUDA cores), the MLP and attention half-blocks' by
   dtype (MLP_ROUTES, ATTN_FWD_ROUTES, ATTN_BWD_ROUTES: bf16 through the
   wgmma GEMM, the attention cores on mma.sync). In bf16 each
   standalone-attention wrapper may request nothing beyond its outputs
   and its route's scratch, attn_fwd (and its part) nothing beyond its
   outputs and residuals and its xh and o scratch, attn_bwd (and its
   part) nothing beyond its output and its do, dqkv, fp32 dxh and (B, H,
   S) fp32 t scratch, mlp_fwd nothing beyond its outputs and its xh and
   act scratch, mlp_bwd (and its part) nothing beyond its output and its
   dh and fp32 dxh scratch. ptxas must report no spills for any
   tensor-core kernel (the standalone attention's, the attention
   half-blocks' cores and the wgmma GEMM's), in this run's build or the
   cached one's; the attn_fwd, attn_bwd, mlp_fwd and mlp_bwd libraries
   must hold HGMMA in their SASS, and attn_fwd's and attn_bwd's also HMMA
   (their mma.sync cores). Times kernel, twin and a
   library call computing the same function (scaled_dot_product_attention
   on the attention core; for the attention backwards its forward and
   backward by autograd) as the median of REPS event-timed runs each, the
   kernel's spread [min, max] beside it, and, as a yardstick for the MLP
   and attention half-blocks' products alone, cuBLAS's two products on
   the same inputs (gemm_library_ms).
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
     all-reduce) against the block's plain twin on the full weights under
     the rule at TOL (#1-#4 printed beside it), in bf16 and fp32, and
     equal across the ranks; the prompt params
     bit-equal across the ranks afterwards; and on each rank only the four
     tensor-parallel kernels launched, 24 times a step.
     Its step time is that of two processes time-slicing one card with
     all-reduces through the host: it is not a tensor-parallel speed;
   - ViT-L/14@336px (S = 581 on the image tower) at batch 8: one train
     step under 'auto' and 'on', first loss within 1e-2 of 'off''s, and
     one cached-text eval batch under each, held as eval is;
   - the windowed train step (make_train_step_multi, pre_embed, uint8
     images with normalize) under 'auto' and 'on' (train_window[sel]):
     two windows of 8 steps three ways from the same prompt, one step a
     call, the window run eagerly (capture=False) and the window replayed
     from its CUDA graph; the replay equal to the eager window bit for
     bit; the eager window's losses, grad norms and prompt displacement
     within WINDOW_REL of the per-step path's, and two broken windows
     (a batch index shifted by one, a frozen lr) outside those limits.
     A replay calls no kernel wrapper: the replayed window's launches
     are counted in a torch.profiler trace by kernel name (TRACE_MARKS),
     and it must run the repo's kernels as often as the eager window.
     Then under 'auto' the shipped window of 120 steps
     (train_window_k120[auto]): a warm-up window with the capture, then
     two timed, with ms/step on the host clock and CUDA events, img/s,
     MFU (utils/flops.py at the run's text shape over the dense bf16
     rate) and peak memory, the card's name and power limit on each line;
     then its graph replays 8 of those batches under a trace, which
     counts its launches.
4. Prints a summary line (img/s, ms/step, MFU, peak memory), one JSON
   line of kernel numbers, then, as the last line, {"ok": true,
   "device": {...}}.

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
REPS = 20                 # event-timed runs a kernel, twin or library call (median, spread)
EVAL_BATCHES = 4          # eval and zero-shot batches a path (the first one warms up)
HBM_BYTES_S = 3.35e12     # H100 SXM memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; fp32 CUDA cores
# The rule a check row holds its kernel to (``verdict``). fp32: max|out -
# ref| <= 1e-4 x max|ref|, ref the plain twin (ops/block.py,
# ops/attention.py). bf16: out, ref and ref64, the fp64-summed twin (the
# twin with acc=torch.float64: its rounding points, every sum in fp64), on
# the same inputs; the row passes when
#     max|out - ref64| <= max(TWIN_FACTOR x max|ref - ref64|, 5e-3 x max|ref64|).
# A kernel may sit at most twice as far from exact sums as the twin does
# (the practice of the FlashAttention test suite), with the old bound as
# the floor. The kernels sum in another order than the twins, so where a
# value lands near a rounding boundary a bf16 output can round the other
# way; the twin's own fp32 sums do the same against exact ones. The old
# bf16 bound, 5e-3 x max|ref| against ref, is printed beside the rule
# (tol_old, ok_old) and stops nothing.
TOL = {"float32": 1e-4, "bfloat16": 5e-3}
TWIN_FACTOR = 2
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
# The long-sequence phase: ViT-L/14@336px, whose image tower runs S = 1 +
# 24 x 24 + 4 VPT rows = 581.
VITL336 = dict(backbone_name="ViT-L/14@336px", batch=8)
# The windowed train step (train.make_train_step_multi, pre_embed, uint8
# images with normalize). Its checks run WINDOW_CHECK_WINDOWS windows of
# WINDOW_CHECK_K steps (the first captures the step, the second only
# replays it) under OPTIM's cosine cut to WINDOW_CHECK_EPOCHS epochs of
# WINDOW_CHECK_SPE steps, so the lr falls at every fourth step inside the
# windows; the timing runs the shipped window of WINDOW_K steps
# (configs/trainers/MVLPT/vit_b16_tpu_fast.yaml:34), one warm-up window
# with the capture, then WINDOW_TIMED timed. At WINDOW_SPE steps an epoch
# a window of WINDOW_K crosses an epoch boundary of the lr table.
WINDOW_CHECK_K, WINDOW_CHECK_WINDOWS = 8, 2
WINDOW_CHECK_SPE, WINDOW_CHECK_EPOCHS = 4, 4
WINDOW_K, WINDOW_TIMED = 120, 2
WINDOW_SPE = 100
# The eager window against one make_train_step call a batch, from the same
# prompt (``_window_gaps``): the largest relative gap over the steps of
# the loss and of the grad norm, and the largest gap of the prompt
# leaves' displacement (leaf less its initial value) relative to the
# per-step path's largest displacement. Each limit lies between the sound
# runs' gaps and those of two broken windows the check also runs
# (WINDOW_CONTROLS): step k reading batch k + 1, and the lr frozen at
# its first value. On an H100 the sound windows lie at most 1.04e-3,
# 1.45e-2 and 7.44e-2 from the per-step path ('on'; 'auto' less), the
# shifted ones at least 1.67e-2, 1.555 and 0.490, the frozen lr's
# displacement at least 0.829 (PERF.md).
WINDOW_REL = {"loss": 3e-3, "grad_norm": 5e-2, "displacement": 0.2}
# Which gaps each broken window must exceed: a frozen lr leaves the first
# epoch's steps as they were, so only the displacement is sure to show it.
WINDOW_CONTROLS = {"batch k+1 at step k": tuple(WINDOW_REL),
                   "lr frozen at its first value": ("displacement",)}
# The kernel that each wrapper of the windowed paths launches exactly
# once a call on its bf16 route, by its name in a device trace:
# attn_fwd.cu's core that writes the probabilities, attn_bwd.cu's dq pass,
# the wgmma products with the EPI_BIAS_GELU (4) and EPI_GELU_BWD (5)
# epilogues, which only mlp_fwd.cu and mlp_bwd.cu instantiate, and the
# standalone attention's tensor-core forward and dq pass. A graph replay
# calls no wrapper, so ops._build.LAUNCHES cannot count its launches: the
# replayed window's trace counts them by these names.
TRACE_MARKS = {"attn_fwd": r"[\s:]attn_core_tc<true>\(",
               "attn_bwd": r"[\s:]attn_bwd_dq_tc\(",
               "mlp_fwd": r"[\s:]wgmma_gemm_kernel<4,",
               "mlp_bwd": r"[\s:]wgmma_gemm_kernel<5,",
               "attend_fwd": r"[\s:]attend_fwd_tc[<(]",
               "attend_bwd": r"[\s:]attend_bwd_dq_tc[<(]"}

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


def cuda_times(fn, reps: int = REPS) -> tuple[float, float, float]:
    """(median, min, max) ms of ``reps`` runs of fn, each between its own
    pair of CUDA events. A sleep kernel holds the card while the host
    enqueues every run, so each pair reads the card's time for that run
    alone, not the host's launch gaps."""
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    # Cycles at about 1.5 GHz: longer than the host takes to enqueue them all.
    torch.cuda._sleep(int(min(1.5 * reps * warm_s, 5.0) * 1.5e9))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = sorted(start.elapsed_time(end) for start, end in events)
    return ms[len(ms) // 2], ms[0], ms[-1]


def cuda_ms(fn) -> float:
    return cuda_times(fn)[0]


def timed(kern, plain, lib=None) -> dict:
    """A check row's times: the kernel's median and spread [min, max], the
    plain twin's and the library call's medians (None without one)."""
    med, lo, hi = cuda_times(kern)
    return dict(ms=med, ms_spread=[lo, hi], plain_ms=cuda_ms(plain),
                library_ms=None if lib is None else cuda_ms(lib))


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


def _verdict_one(dtype_name: str, out, ref, ref64) -> dict:
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol_old = TOL[dtype_name] * scale
    ok_old = math.isfinite(err) and err <= tol_old
    row = dict(max_abs_err=err, max_abs_ref=scale,
               differ_share=(out != ref).float().mean().item())
    if dtype_name != "bfloat16":
        return dict(row, tol=tol_old, ok=ok_old)
    err64 = (out.double() - ref64.double()).abs().max().item()
    twin64 = (ref.double() - ref64.double()).abs().max().item()
    scale64 = ref64.double().abs().max().item()
    tol = max(TWIN_FACTOR * twin64, TOL[dtype_name] * scale64)
    return dict(row, max_abs_err64=err64, twin_err64=twin64, max_abs_ref64=scale64, tol=tol,
                ok=math.isfinite(err64) and math.isfinite(tol) and err64 <= tol,
                tol_old=tol_old, ok_old=ok_old,
                differ_share64=(out != ref64.to(out.dtype)).float().mean().item())


def verdict(dtype_name: str, outs, refs, refs64=None, names=None) -> dict:
    """A check row's numbers and verdict (the rule at TOL): the outputs
    ``outs`` (a tensor or a tuple of them) against the twin's ``refs``
    and, in bf16, the fp64-summed twin's ``refs64``. max_abs_err and
    differ_share are against ref; in bf16 also max_abs_err64 and
    differ_share64 against ref64, twin_err64 = max|ref - ref64|, the
    rule's tol, and the old bound as tol_old and ok_old. With several
    outputs: the numbers of the one furthest past its tol, ``ok`` and
    ``ok_old`` only if every output's is; with their ``names`` also each
    output's error, tol and verdict (by_output) and the name of the one
    reported (worst_output)."""
    import torch

    if isinstance(outs, torch.Tensor):
        outs, refs, refs64 = (outs,), (refs,), (refs64,)
    refs64 = refs64 if refs64 is not None else (None,) * len(outs)
    rows = [_verdict_one(dtype_name, o, r, r64) for o, r, r64 in zip(outs, refs, refs64)]
    key = "max_abs_err64" if dtype_name == "bfloat16" else "max_abs_err"

    def past(r):
        ratio = r[key] / max(r["tol"], 1e-30)
        return ratio if math.isfinite(ratio) else math.inf

    worst = max(range(len(rows)), key=lambda i: past(rows[i]))
    out = dict(rows[worst], ok=all(r["ok"] for r in rows))
    if "ok_old" in out:
        out["ok_old"] = all(r["ok_old"] for r in rows)
    if names is not None:
        out["worst_output"] = names[worst]
        out["by_output"] = {n: {k: r[k] for k in (key, "tol", "ok", "differ_share")}
                            for n, r in zip(names, rows)}
    return out


# The attention forwards' outputs in train mode, each held to the rule:
# y (or the part's fp32 partial) and the residuals the backward reads.
ATTN_FWD_OUTPUTS = ("y", "qkv", "probs", "mu", "rstd")


def _with_residuals(result):
    """(y, (qkv, probs, mu, rstd)) -> (y, qkv, probs, mu, rstd)."""
    y, res = result
    return (y, *res)


def check_kernels(shapes: dict) -> list[dict]:
    """Every half-block kernel and mode against its plain twin (in bf16
    also the fp64-summed twin); returns result rows."""
    import torch

    from mvlpt_torch.ops import block

    rows = []
    # shapes[tower] = (B, S, W, H, mask, seg, n_seq, modes): n_seq sequences
    # of seg tokens hold data (images; or classes packed G to a row);
    # ``modes`` are the kernel modes checked at that shape (a mode for
    # every kernel, or a (kernel, mode) pair).
    for (tower, dtype_name), (b, s, w, h, mask, seg, n_seq, modes) in (
            ((t, d), shapes[t]) for t in shapes for d in ("bfloat16", "float32")):
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator().manual_seed(7)
        p = layer_params(w, dtype, gen)
        x = torch.randn((b, s, w), generator=gen).to("cuda", dtype)
        gy = torch.randn((b, s, w), generator=gen).to("cuda", dtype)
        esz = torch.finfo(dtype).bits // 8
        m, d, w4 = b * s, w // h, 4 * w
        do = torch.randn((b, h, s, d), generator=gen).to("cuda", dtype)
        ln1, ln2, at, ml = p["ln_1"], p["ln_2"], p["attn"], p["mlp"]
        attn_args = (x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], at["out_w"],
                     at["out_b"], mask, h)
        mlp_args = (x, ln2["scale"], ln2["bias"], ml["fc_w"], ml["fc_b"], ml["proj_w"],
                    ml["proj_b"])
        _, (qkv, probs, mu, rstd) = block.attn_fwd_plain(*attn_args)
        _, (hpre, mu2, rstd2) = block.mlp_fwd_plain(*mlp_args)
        attn_bwd_args = (x, mu, rstd, qkv, probs, ln1["scale"], at["qkv_w"], at["out_w"], gy, h)
        mlp_bwd_args = (x, mu2, rstd2, hpre, ln2["scale"], ml["fc_w"], ml["proj_w"], gy)

        sdpa, sdpa_bwd = sdpa_library(qkv, mask, h, do)

        # Bytes: each input read once, each output written once. Operations:
        # what this run's data needs; for the packed text rows only the real
        # classes' tokens and the causal part of each class's own block.
        # Each case's twin takes the dtype of its sums (acc).
        f32 = torch.float32
        n_tok = n_seq * seg
        core = 4 * h * d * n_seq * (seg * seg if mask is None else seg * (seg + 1) // 2)
        gemm_attn, gemm_mlp = 2 * n_tok * w * 4 * w, 4 * n_tok * w * w4
        act, stats = m * w * esz, 8 * m                  # a (B, S, W) tensor; mu + rstd
        probs_b = b * h * s * s * esz
        mask_b = 0 if mask is None else s * s * 4
        attn_w = (4 * w * w + 6 * w) * esz               # LN, qkv and out weights and biases
        mlp_w = (2 * w * w4 + w4 + 3 * w) * esz          # LN, fc and proj weights and biases
        cases = [
            ("attn_fwd", "train", lambda: _with_residuals(block.attn_fwd(*attn_args)),
             lambda acc=f32: _with_residuals(block.attn_fwd_plain(*attn_args, acc=acc)),
             gemm_attn + core,
             act + attn_w + mask_b + act + 3 * act + probs_b + stats, sdpa),
            ("attn_fwd", "no-residual",
             lambda: block.attn_fwd(*attn_args, save_residuals=False)[0],
             lambda acc=f32: block.attn_fwd_plain(*attn_args, save_residuals=False, acc=acc)[0],
             gemm_attn + core, act + attn_w + mask_b + act, sdpa),
            ("attn_bwd", "train", lambda: block.attn_bwd(*attn_bwd_args),
             lambda acc=f32: block.attn_bwd_plain(*attn_bwd_args, acc=acc), gemm_attn + 2 * core,
             act + stats + 3 * act + probs_b + (4 * w * w + w) * esz + act + act, sdpa_bwd),
            ("mlp_fwd", "train", lambda: block.mlp_fwd(*mlp_args)[0],
             lambda acc=f32: block.mlp_fwd_plain(*mlp_args, acc=acc)[0], gemm_mlp,
             act + mlp_w + act + m * w4 * esz + stats, None),
            ("mlp_fwd", "no-residual",
             lambda: block.mlp_fwd(*mlp_args, save_residuals=False)[0],
             lambda acc=f32: block.mlp_fwd_plain(*mlp_args, save_residuals=False, acc=acc)[0],
             gemm_mlp, act + mlp_w + act, None),
            ("mlp_bwd", "train", lambda: block.mlp_bwd(*mlp_bwd_args),
             lambda acc=f32: block.mlp_bwd_plain(*mlp_bwd_args, acc=acc), gemm_mlp,
             act + stats + m * w4 * esz + (2 * w * w4 + w) * esz + act + act, None),
        ]
        gemm_lib = {"attn_fwd": attn_gemm_library(*attn_args[:5], at["out_w"], mask, h),
                    "attn_bwd": attn_bwd_gemm_library(qkv, probs, at["qkv_w"], at["out_w"], gy,
                                                      h),
                    "mlp_fwd": mlp_gemm_library(*mlp_args[:6]),
                    "mlp_bwd": mlp_bwd_gemm_library(hpre, ml["fc_w"], ml["proj_w"], gy)}
        for name, mode, kern, twin, flops, nbytes, lib in (
                c for c in cases if c[1] in modes or (c[0], c[1]) in modes):
            got, alloc = requested(kern)
            ref64 = twin(torch.float64) if dtype == torch.bfloat16 else None
            bound_ms, bound_by = bound(flops, nbytes, dtype_name)
            outputs = ATTN_FWD_OUTPUTS if (name, mode) == ("attn_fwd", "train") else None
            row = dict(name=name, mode=mode, tower=tower, dtype=dtype_name,
                       shape=[b, s, w, h], masked=mask is not None,
                       **verdict(dtype_name, got, twin(), ref64, outputs),
                       **timed(kern, twin, lib), bound_ms=bound_ms, bound_by=bound_by)
            if name in gemm_lib:
                # The bf16 route's wrappers request their outputs and scratch,
                # nothing more: attn_fwd y, qkv (a residual, or scratch
                # without residuals), probs, mu and rstd, and its xh and o;
                # attn_bwd dx, its do and dqkv, the fp32 dxh and the core's
                # (B, H, S) fp32 t, no (B, H, S, S) tensor; mlp_fwd its xh
                # and act, mlp_bwd its dh and fp32 dxh.
                train = mode == "train"
                if name == "attn_fwd":
                    want = act + m * 3 * w * esz + (probs_b + stats if train else 0) + 2 * act
                elif name == "attn_bwd":
                    want = act + act + m * 3 * w * esz + m * w * 4 + b * h * s * 4
                elif name == "mlp_fwd":
                    want = act + (m * w4 * esz + stats if train else 0) + act + m * w4 * esz
                else:
                    want = act + m * w4 * esz + m * w * 4
                routes = {"attn_fwd": block.ATTN_FWD_ROUTES,
                          "attn_bwd": block.ATTN_BWD_ROUTES}.get(name, block.MLP_ROUTES)
                row.update(route=routes[dtype], gemm_library_ms=cuda_ms(gemm_lib[name]),
                           requested_bytes=alloc, want_bytes=want)
                if dtype == torch.bfloat16 and alloc != want:
                    raise AssertionError(f"{name} ({mode}, {tower}, bf16): requested {alloc} "
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


def sdpa_library(qkv, mask, n_heads, do):
    """The attention core's library calls on the twin's qkv (B, S, 3Wl)
    over ``n_heads`` heads: scaled_dot_product_attention forward, and its
    forward and backward by autograd against ``do`` (B, H, S, D). The
    yardsticks of the attention half-blocks' cores (library_ms), which the
    port never calls."""
    import torch
    import torch.nn.functional as F

    b, s, wl3 = qkv.shape
    q, k, v = qkv.view(b, s, 3, n_heads, wl3 // 3 // n_heads).permute(2, 0, 3, 1, 4)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa_mask = mask.to(qkv.dtype) if mask is not None else None

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=sdpa_mask)
        return torch.autograd.grad(o, (qg, kg, vg), do)

    return fwd, fwd_bwd


def attn_gemm_library(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, mask, n_heads):
    """A yardstick for the attention half-block forwards' two products
    alone, as mlp_gemm_library is the MLP's: cuBLAS (torch.matmul) in x's
    dtype, xh W_qkv and o W_out on the twin's xh and o (over qkv_w's
    heads), with no LayerNorm, core or epilogue."""
    import torch

    from mvlpt_torch.ops import block

    xh = block._ln2d(x.float(), ln_scale.float(), ln_bias.float(), 1e-5)[0].to(x.dtype)
    o = block._attn_core_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, mask, n_heads, 1e-5)[0]
    w, wl = x.shape[-1], out_w.shape[0]
    return lambda: (torch.matmul(xh.view(-1, w), qkv_w), torch.matmul(o.view(-1, wl), out_w))


def attn_bwd_gemm_library(qkv, probs, qkv_w, out_w, gy, n_heads):
    """The attention backwards' yardstick for their two products alone, as
    mlp_bwd_gemm_library is the MLP's: cuBLAS (torch.matmul) in gy's
    dtype, gy W_out^T and dqkv W_qkv^T on the twin's dqkv (over qkv's
    ``n_heads`` heads), with no attention core or LayerNorm backward."""
    import torch

    from mvlpt_torch.ops import block

    dqkv = block._attn_dqkv_plain(qkv, probs, out_w, gy, n_heads)
    gy2, dqkv2 = gy.reshape(-1, gy.shape[-1]), dqkv.reshape(-1, dqkv.shape[-1])
    return lambda: (torch.matmul(gy2, out_w.t()), torch.matmul(dqkv2, qkv_w.t()))


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


def mlp_bwd_gemm_library(hpre, fc_w, proj_w, gy):
    """The MLP backward's yardstick, as mlp_gemm_library is the forward's:
    cuBLAS's two products in gy's dtype, gy W_proj^T and dh W_fc^T on the
    twin's dh, with no epilogue or LayerNorm backward."""
    import torch

    from mvlpt_torch.ops import block

    w, w4 = fc_w.shape
    gy2 = gy.reshape(-1, w)
    dh = block._gelu_bwd_plain(block._mm(gy2, proj_w.t()), hpre.reshape(-1, w4))
    return lambda: (torch.matmul(gy2, proj_w.t()), torch.matmul(dh, fc_w.t()))


def _compared(dtype_name: str, out, ref, ref64) -> dict:
    """out against ``ref`` (#1-#4, say) under the rule, as numbers to
    print: the row's verdict is taken against the plain twin."""
    r = verdict(dtype_name, out, ref, ref64)
    return {k: r[k] for k in ("max_abs_err", "max_abs_err64", "twin_err64", "tol", "ok",
                              "differ_share") if k in r}


def _fail_on_disagreement(rows: list[dict]) -> list[dict]:
    """Raise if any row fails the rule (``ok``; ``ok_old`` stops nothing)."""
    bad = [f"{r['name']} ({r['mode']}, {r['tower']}, {r['dtype']}): max|err"
           f"{'64' if 'max_abs_err64' in r else ''}| "
           f"{r.get('max_abs_err64', r['max_abs_err'])} > {r['tol']}" for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("kernels disagree with their plain twins: " + "; ".join(bad))
    return rows


def check_tp_kernels(shapes: dict) -> list[dict]:
    """The tensor-parallel parts (#7-#10) against their plain twins on
    rank 0's shard at tp = TP; then the TP shards' partials summed in fp32
    and finished (bias, rounding, residual; or the LayerNorm backward)
    against the plain twin on the full weights (ref; in bf16 ref64 is the
    fp64-summed twin), with the single-device kernels #1-#4 beside it as a
    printed second comparison (vs_kernels). Returns result rows."""
    import torch

    from mvlpt_torch.ops import block
    from mvlpt_torch.parallel import shard_blocks

    rows, joined = [], []
    # shapes[tower] = (B, S, W, H, mask, seg, n_seq, names): as check_kernels',
    # with the part kernels checked at that shape.
    for (tower, dtype_name), (b, s, w, h, mask, seg, n_seq, names) in (
            ((t, d), shapes[t]) for t in shapes for d in ("bfloat16", "float32")):
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator().manual_seed(13)
        p = layer_params(w, dtype, gen)
        x = torch.randn((b, s, w), generator=gen).to("cuda", dtype)
        gy = torch.randn((b, s, w), generator=gen).to("cuda", dtype)
        esz = torch.finfo(dtype).bits // 8
        m, d, hl, wl, w4l = b * s, w // h, h // TP, w // TP, 4 * w // TP
        do = torch.randn((b, hl, s, d), generator=gen).to("cuda", dtype)
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
        f32, bf16 = torch.float32, dtype == torch.bfloat16
        # SDPA on rank 0's local heads: the cores' library calls.
        sdpa, sdpa_bwd = sdpa_library(fwd_res[0][0], mask, hl, do)
        cases = [
            ("attn_fwd_tp", lambda: _with_residuals(block.attn_fwd_part(*attn_args(0))),
             lambda acc=f32: _with_residuals(block.attn_fwd_part_plain(*attn_args(0), acc=acc)),
             gemm_attn + core,
             act + attn_w + (3 * wl + 2 * w) * esz + mask_b + part + qkv_b + probs_b + stats,
             sdpa),
            ("attn_bwd_tp", lambda: block.attn_bwd_part(*attn_bwd_args(0)),
             lambda acc=f32: block.attn_bwd_part_plain(*attn_bwd_args(0), acc=acc),
             gemm_attn + 2 * core, qkv_b + probs_b + attn_w + act + part, sdpa_bwd),
            ("mlp_fwd_tp", lambda: block.mlp_fwd_part(*mlp_args(0))[0],
             lambda acc=f32: block.mlp_fwd_part_plain(*mlp_args(0), acc=acc)[0], gemm_mlp,
             act + mlp_w + (w4l + 2 * w) * esz + part + m * w4l * esz + stats, None),
            ("mlp_bwd_tp", lambda: block.mlp_bwd_part(*mlp_bwd_args(0)),
             lambda acc=f32: block.mlp_bwd_part_plain(*mlp_bwd_args(0), acc=acc), gemm_mlp,
             m * w4l * esz + mlp_w + act + part, None),
        ]
        for name, kern, twin, flops, nbytes, lib in (c for c in cases if c[0] in names):
            got, alloc = requested(kern)
            bound_ms, bound_by = bound(flops, nbytes, dtype_name)
            row = dict(name=name, mode="part", tower=tower, dtype=dtype_name,
                       shape=[b, s, w, hl if "attn" in name else w4l], tp=TP,
                       masked=mask is not None,
                       **verdict(dtype_name, got, twin(), twin(torch.float64) if bf16 else None,
                                 ATTN_FWD_OUTPUTS if name == "attn_fwd_tp" else None),
                       **timed(kern, twin, lib), bound_ms=bound_ms, bound_by=bound_by)
            if name == "attn_fwd_tp":
                # The bf16 route requests the fp32 partial, the residuals
                # (qkv, probs, mu, rstd) and the xh and o scratch.
                want = part + qkv_b + probs_b + stats + act + m * wl * esz
                row.update(route=block.ATTN_FWD_ROUTES[dtype],
                           gemm_library_ms=cuda_ms(attn_gemm_library(
                               *attn_args(0)[:5], shards[0]["attn"]["out_w"], mask, hl)),
                           requested_bytes=alloc, want_bytes=want)
                if bf16 and alloc != want:
                    raise AssertionError(f"attn_fwd_tp ({tower}, bf16): requested {alloc} bytes, "
                                         f"not those of its outputs and scratch ({want})")
            if name == "attn_bwd_tp":
                # The bf16 route requests the fp32 partial, the do and dqkv
                # scratch and the core's (B, H, S) fp32 t.
                want = part + m * wl * esz + qkv_b + b * hl * s * 4
                row.update(route=block.ATTN_BWD_ROUTES[dtype],
                           gemm_library_ms=cuda_ms(attn_bwd_gemm_library(
                               *attn_bwd_args(0)[:2], shards[0]["attn"]["qkv_w"],
                               shards[0]["attn"]["out_w"], gy, hl)),
                           requested_bytes=alloc, want_bytes=want)
                if bf16 and alloc != want:
                    raise AssertionError(f"attn_bwd_tp ({tower}, bf16): requested {alloc} bytes, "
                                         f"not those of its output and scratch ({want})")
            if name == "mlp_fwd_tp":
                row.update(route=block.MLP_ROUTES[dtype],
                           gemm_library_ms=cuda_ms(mlp_gemm_library(*mlp_args(0))))
            if name == "mlp_bwd_tp":
                # The bf16 route requests the fp32 partial and the dh scratch.
                want = part + m * w4l * esz
                row.update(route=block.MLP_ROUTES[dtype],
                           gemm_library_ms=cuda_ms(mlp_bwd_gemm_library(*mlp_bwd_args(0))),
                           requested_bytes=alloc, want_bytes=want)
                if bf16 and alloc != want:
                    raise AssertionError(f"mlp_bwd_tp ({tower}, bf16): requested {alloc} bytes, "
                                         f"not those of its output and scratch ({want})")
            rows.append(row)
            print("kernel-check " + json.dumps(row), flush=True)

        # The TP shards' kernels, summed and finished, against the twin on
        # the full weights (ref) and, in bf16, the fp64-summed twin (ref64);
        # the backwards' twins take #1's and #3's residuals. #1-#4 on the
        # full weights are printed beside them and decide nothing.
        at, ml = p["attn"], p["mlp"]
        full_attn = (x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], at["out_w"],
                     at["out_b"], mask, h)
        full_mlp = (x, ln2["scale"], ln2["bias"], ml["fc_w"], ml["fc_b"], ml["proj_w"],
                    ml["proj_b"])
        f64 = torch.float64
        pairs = []
        if "attn_fwd_tp" in names:
            y_attn, (qkv, probs, mu, rstd) = block.attn_fwd(*full_attn)
            fa = [block.attn_fwd_part(*attn_args(r)) for r in range(TP)]
            parts = [res for _, res in fa]
            pairs.append(("attn_fwd_tp",
                          x + (sum(y for y, _ in fa) + at["out_b"].float()).to(dtype), y_attn,
                          lambda acc: block.attn_fwd_plain(*full_attn, acc=acc)[0]))
        if "attn_bwd_tp" in names:
            dxa = sum(block.attn_bwd_part(parts[r][0], parts[r][1], shards[r]["attn"]["qkv_w"],
                                          shards[r]["attn"]["out_w"], gy, hl) for r in range(TP))
            attn_bwd_full = (x, mu, rstd, qkv, probs, ln1["scale"], at["qkv_w"], at["out_w"],
                             gy, h)
            pairs.append(("attn_bwd_tp",
                          block._ln_bwd(x, parts[0][2], parts[0][3], ln1["scale"], dxa, gy),
                          block.attn_bwd(*attn_bwd_full),
                          lambda acc: block.attn_bwd_plain(*attn_bwd_full, acc=acc)))
        if "mlp_fwd_tp" in names:
            y_mlp, (hpre, mu2, rstd2) = block.mlp_fwd(*full_mlp)
            fm = [block.mlp_fwd_part(*mlp_args(r)) for r in range(TP)]
            mparts = [res for _, res in fm]
            pairs.append(("mlp_fwd_tp",
                          x + (sum(y for y, _ in fm) + ml["proj_b"].float()).to(dtype), y_mlp,
                          lambda acc: block.mlp_fwd_plain(*full_mlp, acc=acc)[0]))
        if "mlp_bwd_tp" in names:
            dxm = sum(block.mlp_bwd_part(mparts[r][0], shards[r]["mlp"]["fc_w"],
                                         shards[r]["mlp"]["proj_w"], gy) for r in range(TP))
            mlp_bwd_full = (x, mu2, rstd2, hpre, ln2["scale"], ml["fc_w"], ml["proj_w"], gy)
            pairs.append(("mlp_bwd_tp",
                          block._ln_bwd(x, mparts[0][1], mparts[0][2], ln2["scale"], dxm, gy),
                          block.mlp_bwd(*mlp_bwd_full),
                          lambda acc: block.mlp_bwd_plain(*mlp_bwd_full, acc=acc)))
        for name, got, kernels, twin in pairs:
            ref64 = twin(f64) if bf16 else None
            row = dict(name=name, mode="reassembled", tower=tower, dtype=dtype_name, tp=TP,
                       ref="the plain twin on the full weights",
                       **verdict(dtype_name, got, twin(f32), ref64),
                       vs_kernels=_compared(dtype_name, got, kernels, ref64))
            joined.append(row)
            print("tp-reassembly " + json.dumps(row), flush=True)
    _fail_on_disagreement(joined)
    return _fail_on_disagreement(rows)


def check_attend(shapes: dict) -> list[dict]:
    """The standalone attention, forward and backward, against its plain
    twins; returns result rows, each with the route its dtype and S took
    (``attention.route_of``). ``shapes[name] = (N, S, D, mask, dtypes,
    kernels)``, N = batch x heads. In bf16 each wrapper must request from
    the allocator its outputs and its route's scratch and nothing more: on
    the tensor cores the backward's (3, N, S) row statistics and no
    (N, S, S) tensor; past the buckets, on the CUDA cores, the backward's
    two (N, S, S) bf16 tensors."""
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
        esz = torch.finfo(dtype).bits // 8
        rows_b = n * s * d * esz  # one (N, S, D) tensor
        mask_b = 0 if mask is None else s * s * 4
        f32 = torch.float32
        cases = [
            ("attend_fwd", lambda: (attention.attend_fwd(q, k, v, mask),),
             lambda acc=f32: (attention.attend_fwd_plain(q, k, v, mask, acc=acc),),
             4 * n * d * pairs, 4 * rows_b + mask_b, lib_fwd),
            ("attend_bwd", lambda: attention.attend_bwd(q, k, v, mask, do),
             lambda acc=f32: attention.attend_bwd_plain(q, k, v, mask, do, acc=acc),
             10 * n * d * pairs, 7 * rows_b + mask_b, lib_bwd),
        ]
        for name, kern, twin, flops, nbytes, lib in (c for c in cases if c[0] in names):
            got, alloc = requested(kern)
            ref64 = twin(torch.float64) if dtype == torch.bfloat16 else None
            agree = verdict(dtype_name, got, twin(), ref64)
            bound_ms, bound_by = bound(flops, nbytes, dtype_name)
            # The outputs and the backward's scratch of the route taken.
            route = attention.route_of(name, dtype, s)
            want = len(got) * rows_b
            if name == "attend_bwd":
                want += 3 * n * s * 4 if route == "mma" else 2 * n * s * s * esz
            row = dict(name=name, mode="core", tower=path, dtype=dtype_name, shape=[n, s, d],
                       route=attention.ROUTES[route], masked=mask is not None, **agree,
                       requested_bytes=alloc, **timed(kern, twin, lib), bound_ms=bound_ms,
                       bound_by=bound_by)
            rows.append(row)
            print("kernel-check " + json.dumps(row), flush=True)
            if dtype == torch.bfloat16 and alloc != want:
                raise AssertionError(f"{name} ({path}, bf16): requested {alloc} bytes, not "
                                     f"those of its outputs and its route's scratch ({want})")
    return _fail_on_disagreement(rows)


# The epilogues of the backwards' K-major GEMM (csrc/common.cuh
# Epilogue): the rounding one of the attention backward's do, the fp32 one
# of dxh, the QuickGELU' one of the MLP backward's da.
EPI_ROUND, EPI_F32, EPI_GELU_BWD = 0, 1, 5


def check_gemm_kmajor(shapes: dict) -> list[dict]:
    """The backwards' bf16 GEMM on its own (wgmma.cuh with B read K-major,
    through csrc/mlp_bwd.cu's mvlpt_gemm_kmajor), at #4's two products:
    da = gy W_proj^T through the QuickGELU' epilogue into dh (bf16), and
    dxh = dh W_fc^T through the fp32 one; and at #2's do = gy W_out^T
    through the rounding one (bf16; W_out (W, W) read K-major). Each
    against the twin's product (ops/block._mm, _gelu_bwd_plain) under the
    bf16 rule,
    in both tile widths and as the backward picks one, so the K-major
    layout is guarded apart from the half-block around it; timed beside
    torch.matmul (cuBLAS) of the same product, each tile width apart
    (``ms_by_tile``). The first row is also launched first from a new
    thread, as autograd's backward thread launches #4: it must give the
    main thread's result. ``shapes[name] = (M, W)``; returns result
    rows."""
    import threading

    import torch

    from mvlpt_torch.ops import _build, block

    rows = []
    bf, f32, f64 = torch.bfloat16, torch.float32, torch.float64
    for tower, (m, w) in shapes.items():
        gen = torch.Generator().manual_seed(19)
        w4 = 4 * w
        gy = torch.randn((m, w), generator=gen).to("cuda", bf)
        hpre = torch.randn((m, w4), generator=gen).to("cuda", bf)
        proj_w = (0.02 * torch.randn((w4, w), generator=gen)).to("cuda", bf)
        fc_w = (0.02 * torch.randn((w, w4), generator=gen)).to("cuda", bf)
        out_w = (0.02 * torch.randn((w, w), generator=gen)).to("cuda", bf)
        dh_in = block._gelu_bwd_plain(block._mm(gy, proj_w.t()), hpre)
        products = [
            ("da", EPI_GELU_BWD, gy, proj_w, hpre, bf, w4, w,
             lambda acc=f32: block._gelu_bwd_plain(block._mm(gy, proj_w.t(), acc), hpre, acc),
             lambda: torch.matmul(gy, proj_w.t())),
            ("dxh", EPI_F32, dh_in, fc_w, None, f32, w, w4,
             lambda acc=f32: block._mm(dh_in, fc_w.t(), acc),
             lambda: torch.matmul(dh_in, fc_w.t())),
            ("do", EPI_ROUND, gy, out_w, None, bf, w, w,
             lambda acc=f32: block._mm(gy, out_w.t(), acc).to(bf),
             lambda: torch.matmul(gy, out_w.t()))]
        for name, epi, a, b_t, aux, out_dtype, n, k, twin, lib in products:
            out = torch.empty((m, n), dtype=out_dtype, device="cuda")

            def kern(bn, epi=epi, a=a, b_t=b_t, aux=aux, out=out, n=n, k=k):
                _build.call("gemm_kmajor", epi, bn, a.data_ptr(), b_t.data_ptr(),
                            None if aux is None else aux.data_ptr(), out.data_ptr(), m, n, k,
                            torch.cuda.current_stream().cuda_stream)
                return out

            ref, ref64 = twin(), twin(f64)
            tiles = {bn: verdict("bfloat16", kern(bn).clone(), ref, ref64) for bn in (128, 256)}
            agree = verdict("bfloat16", kern(0).clone(), ref, ref64)
            aux_b = 0 if aux is None else m * n * 2
            bound_ms, bound_by = bound(2 * m * n * k, (m * k + n * k) * 2 + aux_b
                                       + m * n * out.element_size(), "bfloat16")
            row = dict(name="gemm_kmajor", mode=name, tower=tower, dtype="bfloat16",
                       shape=[m, n, k], epilogue=epi, **agree,
                       ok_by_tile={bn: t["ok"] for bn, t in tiles.items()},
                       **timed(lambda: kern(0), twin, lib),
                       ms_by_tile={bn: cuda_ms(lambda bn=bn: kern(bn)) for bn in (128, 256)},
                       bound_ms=bound_ms, bound_by=bound_by)
            row["ok"] = agree["ok"] and all(t["ok"] for t in tiles.values())
            if not rows:
                want, got, err = kern(0).clone(), [], []

                def first_launch():
                    try:
                        got.append(kern(0).clone())
                    except Exception as e:  # re-raised below, on the main thread
                        err.append(e)

                t = threading.Thread(target=first_launch)
                t.start()
                t.join()
                if err or not torch.equal(got[0], want):
                    raise AssertionError(f"gemm_kmajor: a new thread's first launch failed or "
                                         f"differs from the main thread's: {err}")
                row["new_thread"] = "equal"
            rows.append(row)
            print("kernel-check " + json.dumps(row), flush=True)
    return _fail_on_disagreement(rows)


# The tensor-core kernels of each source, by their mangled names: the
# bf16 route of attend_fwd.cu / attend_bwd.cu (one kernel a register
# bucket NT), the wgmma GEMM in attn_fwd.cu, attn_bwd.cu, mlp_fwd.cu and
# mlp_bwd.cu (one an epilogue EPI, tile width BN and B layout, KMAJOR 1 for
# a B read transposed), attn_fwd.cu's mma.sync core (PROBS 1 where it
# writes the probabilities) and attn_bwd.cu's two mma.sync core launches.
# Each pattern of a source must name at least one kernel.
TC_KERNELS = {"attend_fwd": (r"attend_fwd_tc",), "attend_bwd": (r"attend_bwd_(?:dq|dkv)_tc",),
              "attn_fwd": (r"attn_core_tc", r"wgmma_gemm_kernel"),
              "attn_bwd": (r"attn_bwd_(?:dq|dkv)_tc", r"wgmma_gemm_kernel"),
              "mlp_fwd": (r"wgmma_gemm_kernel",), "mlp_bwd": (r"wgmma_gemm_kernel",)}
# The template arguments of each tensor-core kernel, in order (none for a
# plain function).
TC_TEMPLATE_ARGS = {"attend_fwd_tc": ("NT",), "attend_bwd_dq_tc": ("NT",),
                    "attend_bwd_dkv_tc": ("NT",), "attn_core_tc": ("PROBS",),
                    "attn_bwd_dq_tc": (), "attn_bwd_dkv_tc": (),
                    "wgmma_gemm_kernel": ("EPI", "BN", "KMAJOR")}
# Sources whose bf16 products must reach wgmma (HGMMA in their SASS), and
# whose bf16 attention core must reach mma.sync (HMMA).
HGMMA_SOURCES = ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd")
HMMA_SOURCES = ("attn_fwd", "attn_bwd")
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
        args = re.search(r"I((?:L[ib]\d+E)+)E", mangled)
        values = re.findall(r"L[ib](\d+)E", args.group(1)) if args else []
        names = TC_TEMPLATE_ARGS[kernel.group(0)]
        label = ",".join(f"{n}={v}" for n, v in zip(names, values)) or "?"
        regs = re.search(r"Used (\d+) registers", chunk)
        rows.append((f"{kernel.group(0)}<{label}>" if names else kernel.group(0),
                     int(regs.group(1)) if regs else -1,
                     sum(int(b) for b in re.findall(r"(\d+) bytes spill", chunk))))
    return rows


def check_tc_spills(logs: dict) -> None:
    """ptxas's registers and spills of each tensor-core kernel
    (TC_KERNELS), printed; any spill fails the run, and so does a source
    whose build log (``_build.build_kernels``: this run's or the cached
    library's) names no kernel of one of its patterns, or a wgmma GEMM
    kernel holding fewer than WGMMA_ENTRY_REGS registers."""
    rows = []
    for src, patterns in TC_KERNELS.items():
        for pattern in patterns:
            found = tc_ptxas(logs[src], pattern)
            if not found:
                raise AssertionError(f"ptxas: no tensor-core kernel in {src}.cu's build log "
                                     f"matches {pattern}")
            rows += [(f"{src} {label}", regs, spill) for label, regs, spill in found]
    for label, regs, spill in rows:
        print(f"ptxas {label}: {regs} registers, {spill} bytes of spills", flush=True)
    spilled = [label for label, _, spill in rows if spill]
    if spilled:
        raise AssertionError(f"ptxas: tensor-core kernels spill: {spilled}")
    short = [label for label, regs, _ in rows
             if " wgmma" in label and regs < WGMMA_ENTRY_REGS]
    if short:
        raise AssertionError(f"ptxas: wgmma GEMM kernels below {WGMMA_ENTRY_REGS} registers "
                             f"at entry, which setmaxnreg's split needs: {short}")


def check_hgmma() -> None:
    """The SASS (the toolkit's cuobjdump) of each library in HGMMA_SOURCES
    must hold HGMMA, the instruction wgmma compiles to, and of each in
    HMMA_SOURCES HMMA, mma.sync's: their bf16 routes really reach the
    tensor cores through them."""
    from mvlpt_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    for src in dict.fromkeys(HGMMA_SOURCES + HMMA_SOURCES):
        sass = subprocess.run([str(cuobjdump), "--dump-sass", str(_build._lib_path(src))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        for op, sources, what in (("HGMMA", HGMMA_SOURCES, "wgmma"),
                                  ("HMMA", HMMA_SOURCES, "mma.sync")):
            if src not in sources:
                continue
            count = len(re.findall(rf"\b{op}\.", sass))
            print(f"sass {src}: {count} {op} instructions", flush=True)
            if not count:
                raise AssertionError(f"sass: no {op} in {src}'s library: its bf16 route misses "
                                     f"{what}")


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


def drive_train(selection: str, batches: list, loss_plain: float, ocfg, norm, name="train",
                **flagship_kw) -> dict:
    """The flagship train step under ``selection``, one step a batch
    (``flagship_kw``: another backbone and batch). With more than one
    step the first is a warm-up, left out of ms_per_step."""
    import torch

    from mvlpt_torch.flagship import flagship
    from mvlpt_torch.ops import _build
    from mvlpt_torch.train import init_train_state, make_train_step

    path = f"{name}[{selection}]"
    model, backbone, pp, consts, _, clip_cfg = flagship(device="cuda", kernels=selection,
                                                        **flagship_kw)
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
    ms_step = 1e3 * sum(times[1:]) / len(times[1:]) if len(times) > 1 else None
    out = dict(path=path, losses=losses, loss_plain_first=loss_plain, grad_norms=grad_norms,
               launches=launches, ms_per_step=ms_step,
               img_per_s=len(batches[0]["label"]) * 1e3 / ms_step if ms_step else None,
               step_ms=[1e3 * t for t in times], peak_mem_gib=_peak_gib())
    print("main-path " + json.dumps(out), flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{path}: non-finite loss {losses}")
    _near(path, "first loss", losses[0], loss_plain)
    return out


def drive_eval(selection: str, model, backbone, pp, consts, batches: list, ce_plain, norm,
               name="eval"):
    """The cached-text eval under ``selection``: text features once, then
    the image tower per batch; each batch's logits against the full eval
    step's, the soft-CE against the plain path's. With more than one
    batch the first is a warm-up, left out of img_per_s."""
    import torch

    from mvlpt_torch.ops import _build
    from mvlpt_torch.train import make_cached_text_eval, make_eval_step, soft_cross_entropy

    path = f"{name}[{selection}]"
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
               img_per_s=(len(batches[0]["label"]) * len(times[1:]) / sum(times[1:])
                          if len(times) > 1 else None),
               soft_ce=ce, soft_ce_plain=ce_plain, peak_mem_gib=peak)
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


def residual_block_twin(x, p, n_heads, mask, gy, acc):
    """y and dx of one residual block through the half-block twins
    (ops/block.py) with sums in ``acc``: the forward's residuals feed the
    backward, as the fused block's kernels #1-#4 do."""
    from mvlpt_torch.ops import block

    ln1, at, ln2, ml = p["ln_1"], p["attn"], p["ln_2"], p["mlp"]
    y1, (qkv, probs, mu, rstd) = block.attn_fwd_plain(
        x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], at["out_w"], at["out_b"], mask,
        n_heads, acc=acc)
    y, (hpre, mu2, rstd2) = block.mlp_fwd_plain(y1, ln2["scale"], ln2["bias"], ml["fc_w"],
                                                ml["fc_b"], ml["proj_w"], ml["proj_b"], acc=acc)
    g1 = block.mlp_bwd_plain(y1, mu2, rstd2, hpre, ln2["scale"], ml["fc_w"], ml["proj_w"], gy,
                             acc=acc)
    dx = block.attn_bwd_plain(x, mu, rstd, qkv, probs, ln1["scale"], at["qkv_w"], at["out_w"],
                              g1, n_heads, acc=acc)
    return y, dx


def _tp_block_check(path: str, backbones: dict, clip_cfg, inputs: dict, got: list) -> dict:
    """Each rank's sharded layer 0 of each tower (y and dx, through the
    all-reduce) against the block's plain twin on the full weights of
    ``backbones[dtype]`` (ref; in bf16 ref64 is its fp64-summed twin),
    under the rule at TOL, with kernels #1-#4 on the same weights beside
    it as a printed second comparison (vs_kernels); and bit-equal across
    the ranks."""
    import torch

    from mvlpt_torch.core.layers import layer_params as take
    from mvlpt_torch.ops.block import fused_residual_block

    out, rows = {}, []
    for dt, backbone in backbones.items():
        for tower, (x, gy, mask) in inputs.items():
            heads = clip_cfg.vision_heads if tower == "visual" else clip_cfg.transformer_heads
            key = f"{tower}/{dt}"
            p = take(backbone[tower]["blocks"], 0)
            mask = None if mask is None else mask.cuda()
            xr = x.to("cuda", getattr(torch, dt)).requires_grad_(True)
            gyr = gy.to("cuda", xr.dtype)
            y = fused_residual_block(xr, p, heads, mask)
            (dx,) = torch.autograd.grad(y, xr, gyr)
            kernels = (y.detach().cpu(), dx.cpu())
            refs = tuple(t.cpu() for t in residual_block_twin(xr.detach(), p, heads, mask, gyr,
                                                              torch.float32))
            refs64 = (None, None)
            if dt == "bfloat16":
                refs64 = tuple(t.cpu() for t in residual_block_twin(
                    xr.detach(), p, heads, mask, gyr, torch.float64))
            for k, name in enumerate(("y", "dx")):
                mine = got[0][key][k]
                row = dict(name=f"{path} layer 0 {name}", mode="rank 0", tower=tower, dtype=dt,
                           **verdict(dt, mine, refs[k], refs64[k]),
                           vs_kernels=_compared(dt, mine, kernels[k], refs64[k]))
                out[f"{key}/{name}"] = row
                rows.append(row)
                if not all(torch.equal(mine, g[key][k]) for g in got[1:]):
                    raise AssertionError(f"{path}: {key} layer 0 {name} differs across ranks")
    _fail_on_disagreement(rows)
    return out


def drive_tp_train(batches: list, blocks: dict, backbones: dict, clip_cfg, auto: dict,
                   auto32: dict) -> dict:
    """train[tp2]: TP spawned ranks share the card. The kernels are built
    already, so the ranks only load them; the batches and the block
    inputs go to them in one file under build/. Rank 0's first loss and
    grad norm are held to train[auto]'s on the same batch (``auto32``:
    its first step in fp32), the blocks to the plain twin on the full
    weights ``backbones[dtype]``."""
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


def _window_batches(k: int, seed: int, res: int) -> dict:
    """A staged window of k flagship batches made on the card: uint8
    (k, 32, res, res, 3) images and (k, 32) labels of 100 classes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"image": torch.randint(0, 256, (k, 32, res, res, 3), dtype=torch.uint8,
                                   device="cuda", generator=gen),
            "label": torch.randint(0, 100, (k, 32), device="cuda", generator=gen)}


def _traced(fn) -> tuple:
    """fn()'s result and the device kernels it ran, counted by their names
    in a torch.profiler trace (CUPTI records each kernel of a graph
    replay too)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    counts = collections.Counter()
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            counts[ev.key] += ev.count
    return out, counts


def _repo_kernels(counts: dict) -> dict:
    """The counts of a trace's kernels that this repo's sources define (the
    __global__ functions under mvlpt_torch/csrc)."""
    names = set()
    for src in (ROOT / "mvlpt_torch" / "csrc").glob("*.cu*"):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                src.read_text()))
    ours = re.compile(r"[\s:](?:%s)[<(]" % "|".join(sorted(names)))
    return {key: n for key, n in counts.items() if ours.search(key)}


def _marked(counts: dict) -> dict:
    """Each TRACE_MARKS wrapper's launches in a trace's counts."""
    return {name: sum(n for key, n in counts.items() if re.search(mark, key))
            for name, mark in TRACE_MARKS.items()}


def _replayed_launches(path: str, counts: dict, kernels: tuple, per: int) -> dict:
    """The launches of a window replayed from its graph, counted in its
    trace by TRACE_MARKS: each of ``kernels`` ``per`` times, every other
    marked kernel never. The replay must have called no wrapper, else a
    step ran eagerly."""
    from mvlpt_torch.ops import _build

    called = {name: n for name, n in _build.LAUNCHES.items() if n}
    if called:
        raise AssertionError(f"{path}: the replayed window called the kernel wrappers {called}")
    return _launches_of(path, _marked(counts), kernels, per)


def _window_gaps(per_step: dict, metrics: list, init: list, leaves: list) -> dict:
    """The gaps of a window run from one make_train_step call a batch
    (``per_step``: its losses, grad norms and final prompt leaves), as
    WINDOW_REL reads them; ``init`` are the prompt leaves both started
    from."""
    import torch

    out = {}
    for name in ("loss", "grad_norm"):
        got = torch.cat([m[name] for m in metrics]).double().cpu()
        want = torch.tensor(per_step[name], dtype=torch.float64)
        out[name] = ((got - want).abs() / want.abs()).max().item()
    moved = [(p - p0).double() for p, p0 in zip(per_step["leaves"], init)]
    gap = max(((q - q0).double() - d).abs().max().item()
              for q, q0, d in zip(leaves, init, moved))
    out["displacement"] = gap / max(d.abs().max().item() for d in moved)
    return out


def _timed_window(step, state, backbone, consts, window) -> tuple[float, float, dict]:
    """(host ms, device ms, metrics) of one window: the host clock around
    the call, ending in torch.cuda.synchronize(); the card's time between
    two CUDA events around it."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    _, metrics = step(state, backbone, consts, window)
    end.record()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), start.elapsed_time(end), metrics


def drive_window(selection: str, ocfg, norm, text_shape: tuple[int, int]) -> dict:
    """The windowed train step under ``selection`` on the flagship (ViT-B/16,
    batch 32, 100 classes, bf16, uint8 images, normalize, pre_embed).

    Check (train_window[sel]): WINDOW_CHECK_WINDOWS windows of
    WINDOW_CHECK_K steps from the same initial prompt three ways: (a) one
    make_train_step call a batch, (b) make_train_step_multi with
    capture=False, (c) make_train_step_multi replayed from its CUDA graph.
    (c) must equal (b) bit for bit (every loss, accuracy and grad norm,
    every prompt leaf after the windows), (b) lie within WINDOW_REL of
    (a), every value be finite, and each broken window of WINDOW_CONTROLS,
    run as (b) is, lie outside the limits it names. The last window of
    (b) and of (c) runs under a device trace: (c)'s launches are counted
    there by TRACE_MARKS, with no wrapper called, and (c) must run the
    same kernels of the repo, each as many times, as (b), whose wrappers
    count its launches. One more replayed window, untraced, is timed.

    Timing (train_window_k120[auto], 'auto' only): one warm-up window of
    WINDOW_K steps, the capture included, then WINDOW_TIMED timed windows:
    ms/step on the host clock and on CUDA events, img/s, peak memory, and
    MFU as utils.flops.flagship_step_flops at this run's text shape (s, G)
    over ms/step, against the dense bf16 rate (PEAK_FLOPS); then the
    graph replays a window of its first WINDOW_CHECK_K batches under a
    device trace, which counts the path's launches."""
    import torch

    from mvlpt_torch.config import OptimConfig
    from mvlpt_torch.flagship import flagship
    from mvlpt_torch.ops import _build
    from mvlpt_torch.train import (
        init_train_state, init_window_state, make_train_step, make_train_step_multi)
    from mvlpt_torch.train.train_step import WINDOW_METRICS
    from mvlpt_torch.utils import flops
    from mvlpt_torch.utils.tree import tree_leaves

    path, card = f"train_window[{selection}]", card_line()
    model, backbone, pp, consts, _, clip_cfg = flagship(device="cuda", kernels=selection)
    res, k = clip_cfg.image_resolution, WINDOW_CHECK_K
    layers = clip_cfg.vision_layers + clip_cfg.transformer_layers
    per_window = layers * k
    check_cfg = OptimConfig(**dict(OPTIM, MAX_EPOCH=WINDOW_CHECK_EPOCHS))
    windows = [_window_batches(k, 40 + i, res) for i in range(WINDOW_CHECK_WINDOWS)]
    init = [t.detach().clone() for t in tree_leaves(pp)]

    state = init_train_state(pp, check_cfg, WINDOW_CHECK_SPE)
    step_a = make_train_step(model, normalize=norm)
    per_step = {"loss": [], "grad_norm": []}
    for w in windows:
        for i in range(k):
            state, m = step_a(state, backbone, consts, {name: t[i] for name, t in w.items()})
            for name, values in per_step.items():
                values.append(m[name].item())
    per_step["leaves"] = [t.detach() for t in tree_leaves(state.prompt_params)]

    eager = make_train_step_multi(model, pre_embed=True, normalize=norm, capture=False)
    eager_state = init_window_state(pp, check_cfg, WINDOW_CHECK_SPE)
    eager_m = [eager(eager_state, backbone, consts, w)[1] for w in windows[:-1]]
    _build.reset_launch_counts()
    (_, m), eager_trace = _traced(lambda: eager(eager_state, backbone, consts, windows[-1]))
    eager_m.append(m)
    eager_calls = _launches(f"{path} eager", TRAIN_KERNELS[selection], per_window)
    marked = _marked(eager_trace)
    if any(marked[name] != eager_calls[name] for name in marked):
        raise AssertionError(f"{path}: the eager window's trace marks {marked}, its wrappers "
                             f"count {eager_calls}")
    controls = {}
    for name in WINDOW_CONTROLS:
        st = init_window_state(pp, check_cfg, WINDOW_CHECK_SPE)
        ws = windows
        if name.startswith("batch"):
            ws = [{n: t.roll(-1, 0) for n, t in w.items()} for w in windows]
        else:
            st.sgd.lr_table.fill_(float(st.sgd.lr_table[0]))
        ms = [eager(st, backbone, consts, w)[1] for w in ws]
        controls[name] = _window_gaps(per_step, ms, init, tree_leaves(st.prompt_params))

    graph_state = init_window_state(pp, check_cfg, WINDOW_CHECK_SPE)
    replayed = make_train_step_multi(model, pre_embed=True, normalize=norm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = [_timed_window(replayed, graph_state, backbone, consts, w) for w in windows[:-1]]
    graph_m = [t[2] for t in timed]
    _build.reset_launch_counts()
    (_, m), trace = _traced(lambda: replayed(graph_state, backbone, consts, windows[-1]))
    graph_m.append(m)
    launches = _replayed_launches(path, trace, TRAIN_KERNELS[selection], per_window)
    if replayed.captures != 1:
        raise AssertionError(f"{path}: {replayed.captures} captures, want 1")
    ours, ours_eager = _repo_kernels(trace), _repo_kernels(eager_trace)
    if ours != ours_eager:
        diff = {key: (ours.get(key, 0), ours_eager.get(key, 0))
                for key in set(ours) | set(ours_eager) if ours.get(key) != ours_eager.get(key)}
        raise AssertionError(f"{path}: the replayed window ran the repo's kernels other times "
                             f"than the eager window (replayed, eager): {diff}")
    for i, (mb, mc) in enumerate(zip(eager_m, graph_m)):
        for name in WINDOW_METRICS:
            if not torch.equal(mb[name], mc[name]):
                raise AssertionError(f"{path}: window {i}: the replayed {name} "
                                     f"{mc[name].tolist()} differs from the eager window's "
                                     f"{mb[name].tolist()}")
    for j, (pb, pc) in enumerate(zip(tree_leaves(eager_state.prompt_params),
                                     tree_leaves(graph_state.prompt_params))):
        if not torch.equal(pb, pc):
            raise AssertionError(f"{path}: prompt leaf {j} after the windows differs from the "
                                 f"eager window's by {(pb - pc).abs().max().item()}")
    values = torch.cat([m[name] for m in eager_m for name in WINDOW_METRICS])
    if not bool(torch.isfinite(values).all()):
        raise AssertionError(f"{path}: non-finite metrics {values.tolist()}")
    gaps = _window_gaps(per_step, eager_m, init, tree_leaves(eager_state.prompt_params))
    for what, limit in WINDOW_REL.items():
        if not gaps[what] <= limit:
            raise AssertionError(f"{path}: the eager window's {what} lies {gaps[what]} from one "
                                 f"step a call's, over {limit} relative")
    for name, caught_by in WINDOW_CONTROLS.items():
        passed = [what for what in caught_by if not controls[name][what] > WINDOW_REL[what]]
        if passed:
            raise AssertionError(f"{path}: a window with the {name} passes the {passed} limits "
                                 f"{controls[name]}: they cannot tell it from a sound one")
    peak = _peak_gib()
    host_ms, device_ms, _ = _timed_window(replayed, graph_state, backbone, consts, windows[0])
    out = {path: dict(
        path=path, card=card, k=k, windows=len(windows), steps_per_epoch=WINDOW_CHECK_SPE,
        captures=replayed.captures, replays=replayed.replays, launches=launches,
        launches_counted="the last check window, replayed, in its device trace",
        eager_wrapper_launches={n: c for n, c in eager_calls.items() if c},
        repo_kernels_per_step={key[:80]: n // k for key, n in sorted(ours.items())},
        losses_per_step=per_step["loss"], losses_eager_window=torch.cat(
            [m["loss"] for m in eager_m]).tolist(),
        grad_norms_per_step=per_step["grad_norm"], grad_norms_eager_window=torch.cat(
            [m["grad_norm"] for m in eager_m]).tolist(),
        acc_eager_window=torch.cat([m["acc"] for m in eager_m]).tolist(),
        gaps=gaps, limits=WINDOW_REL, control_gaps=controls, replay_equals_eager=True,
        capture_window_host_ms=timed[0][0], window_host_ms=host_ms, window_device_ms=device_ms,
        ms_per_step=host_ms / k, device_ms_per_step=device_ms / k,
        img_per_s=32 * k * 1e3 / host_ms, peak_mem_gib=peak)}
    print("main-path " + json.dumps(out[path]), flush=True)
    if selection != "auto":
        return out

    path = f"train_window_k{WINDOW_K}[{selection}]"
    window = _window_batches(WINDOW_K, 50, res)
    state = init_window_state(pp, ocfg, WINDOW_SPE)
    step = make_train_step_multi(model, pre_embed=True, normalize=norm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = [_timed_window(step, state, backbone, consts, window)
             for _ in range(1 + WINDOW_TIMED)]
    peak = _peak_gib()
    # A trace of a whole window of WINDOW_K steps (about 130,000 kernels)
    # loses records: the graph replays the first WINDOW_CHECK_K batches
    # under the trace instead.
    _build.reset_launch_counts()
    (_, m), trace = _traced(lambda: step(state, backbone, consts,
                                         {name: t[:k] for name, t in window.items()}))
    launches = _replayed_launches(path, trace, TRAIN_KERNELS[selection], per_window)
    values = torch.cat([x[name] for x in [t[2] for t in timed] + [m] for name in WINDOW_METRICS])
    if not bool(torch.isfinite(values).all()):
        raise AssertionError(f"{path}: non-finite metrics")
    s, g = text_shape
    step_flops = flops.flagship_step_flops(batch=32, n_cls=100, text_tokens_per_cls=s,
                                           text_pack_classes=g)
    host_ms = sum(t[0] for t in timed[1:]) / (WINDOW_TIMED * WINDOW_K)
    device_ms = sum(t[1] for t in timed[1:]) / (WINDOW_TIMED * WINDOW_K)
    peak_flops = PEAK_FLOPS["bfloat16"]
    out[path] = dict(
        path=path, card=card, k=WINDOW_K, steps_per_epoch=WINDOW_SPE, text_s=s, text_g=g,
        captures=step.captures, replays=step.replays, launches=launches,
        launches_counted=f"a window of its first {k} batches replayed through its graph, in "
                         "its device trace",
        warmup_window_host_ms=timed[0][0], window_host_ms=[t[0] for t in timed[1:]],
        window_device_ms=[t[1] for t in timed[1:]], ms_per_step=host_ms,
        device_ms_per_step=device_ms, img_per_s=32 * 1e3 / host_ms,
        flops_per_step=step_flops, peak_tflops=peak_flops / 1e12,
        mfu_host=step_flops / (host_ms * 1e-3) / peak_flops,
        mfu_device=step_flops / (device_ms * 1e-3) / peak_flops,
        first_losses=timed[0][2]["loss"][:4].tolist(), peak_mem_gib=peak)
    print("main-path " + json.dumps(out[path]), flush=True)
    return out


def drive_paths(tp_blocks: dict, text_shape: tuple[int, int]) -> dict:
    """Every path of the port under 'auto' and 'on', each against the
    plain path ('off') on the same seeded inputs, and the windowed train
    step under each against its eager self and the per-step path; then the
    tensor-parallel train step against 'auto'. ``tp_blocks[tower] = (B, S,
    mask)`` are the shapes of train[tp2]'s layer-0 checks; ``text_shape``
    is (s, G), the packed text tower's."""
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
        out.update(drive_window(sel, ocfg, norm, text_shape))
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
    out.update(drive_vitl336(norm))
    return out


def drive_vitl336(norm) -> dict:
    """ViT-L/14@336px (``VITL336``; its image tower has S = 581, past every
    tensor-core bucket of #11/#12): one train step under 'auto' and 'on',
    the first loss held to 'off''s (1e-2), and one cached-text eval batch
    under each, its soft-CE held the same way."""
    import numpy as np
    import torch

    from mvlpt_torch.config import OptimConfig
    from mvlpt_torch.flagship import flagship
    from mvlpt_torch.models import MVLPTModel
    from mvlpt_torch.ops.attention import select_attn_fn
    from mvlpt_torch.train import init_train_state, make_train_step

    plain, backbone, pp, consts, _, clip_cfg = flagship(device="cuda", kernels="off", **VITL336)
    res, n = clip_cfg.image_resolution, VITL336["batch"]
    rng = np.random.RandomState(2)
    batch = [{"image": torch.from_numpy(rng.randint(0, 256, (n, res, res, 3)).astype(
                  np.uint8)).cuda(),
              "label": torch.from_numpy(rng.randint(0, 100, n)).cuda()}]
    ocfg = OptimConfig(**OPTIM)
    _, m_plain = make_train_step(plain, normalize=norm)(
        init_train_state(pp, ocfg, 100), backbone, consts, batch[0])
    loss_plain = m_plain["loss"].item()
    out = {}
    _, ce_plain = drive_eval("off", plain, backbone, pp, consts, batch, None, norm,
                             name="eval_vitl336")
    for sel in ("auto", "on"):
        out[f"train_vitl336[{sel}]"] = drive_train(sel, batch, loss_plain, ocfg, norm,
                                                   name="train_vitl336", **VITL336)
        model = MVLPTModel(clip_cfg, plain.spec, kernels=select_attn_fn(sel),
                           compute_dtype=plain.compute_dtype)
        out[f"eval_vitl336[{sel}]"] = drive_eval(sel, model, backbone, pp, consts, batch,
                                                 ce_plain, norm, name="eval_vitl336")[0]
    return out


def kernel_entries(results: list[dict], paths: dict) -> list[dict]:
    """One entry a kernel of KERNELS: its bf16 check row's numbers and its
    launches on each path."""
    out = []
    for name, (source, replaces, (kname, mode, shape)) in KERNELS.items():
        r = next(x for x in results if (x["name"], x["mode"], x["tower"], x["dtype"])
                 == (kname, mode, shape, "bfloat16"))
        by_path = {path: p["launches"].get(name, 0) for path, p in paths.items()
                   if p["launches"].get(name, 0)}
        out.append({"name": name, "route": "cuda", "source": f"mvlpt_torch/csrc/{source}.cu",
                    "replaces": replaces, "launches": sum(by_path.values()),
                    "launches_by_path": by_path, "shape": r["shape"],
                    "max_abs_err": r["max_abs_err"],
                    # The bf16 rule's numbers (verdict).
                    **{k: r[k] for k in ("max_abs_err64", "twin_err64", "tol", "ok_old")
                       if k in r},
                    "ms": r["ms"], "ms_spread": r["ms_spread"],
                    "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    # The row's route by dtype (block's *_ROUTES, attention.ROUTES)
                    # and its products' cuBLAS yardstick, where the row has them.
                    **({"dtype_route": r["route"]} if "route" in r else {}),
                    **({"gemm_library_ms": r["gemm_library_ms"]} if "gemm_library_ms" in r
                       else {})})
    return out


def text_and_image_shapes():
    """(text length s, classes a packed row G, packed rows, the image
    tower's S at ViT-B/16 and at ViT-L/14@336px, the packed rows' mask)."""
    from mvlpt_torch.core.text import block_causal_mask, packing
    from mvlpt_torch.prompts import compute_cut_context_length

    s = compute_cut_context_length([f"class number {i}" for i in range(100)], 4)
    g, rows = packing(100, s)
    s_img = 1 + 14 * 14 + 4  # CLS + patches + VPT rows
    s_l336 = 1 + 24 * 24 + 4  # ViT-L/14@336px: the same, 24 x 24 patches
    return s, g, rows, s_img, s_l336, block_causal_mask(g, s, device="cuda")


def half_block_shapes() -> tuple[dict, dict]:
    """The shapes of check_kernels' and check_tp_kernels' rows."""
    from mvlpt_torch.core.layers import causal_mask

    s, g, rows, s_img, s_l336, packed_mask = text_and_image_shapes()
    every, no_residual = ("train", "no-residual"), ("no-residual",)
    attn_only = (("attn_fwd", "train"), ("attn_fwd", "no-residual"), ("attn_bwd", "train"))
    kernel_shapes = {
        "image": (32, s_img, 768, 12, None, s_img, 32, every),
        "image_eval": (EVAL_BATCH, s_img, 768, 12, None, s_img, EVAL_BATCH, no_residual),
        "text": (rows, g * s, 512, 8, packed_mask, s, 100, every),
        # ViT-L/14@336px's attention half-blocks at batch 4.
        "vitl336": (4, s_l336, 1024, 16, None, s_l336, 4, attn_only),
        # The attention half-blocks at S = 1024 (causal), four windows of
        # the bf16 cores' keys (or queries).
        "s1024": (2, 1024, 768, 12, causal_mask(1024, device="cuda"), 1024, 2, attn_only)}
    tp_shapes = {
        "image": (32, s_img, 768, 12, None, s_img, 32, TP_KERNELS),
        "text": (rows, g * s, 512, 8, packed_mask, s, 100, TP_KERNELS),
        "vitl336": (4, s_l336, 1024, 16, None, s_l336, 4, ("attn_fwd_tp", "attn_bwd_tp")),
        "s1024": (2, 1024, 768, 12, causal_mask(1024, device="cuda"), 1024, 2,
                  ("attn_fwd_tp", "attn_bwd_tp"))}
    return kernel_shapes, tp_shapes


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
    from mvlpt_torch.ops import _build

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

    s, g, rows, s_img, s_l336, packed_mask = text_and_image_shapes()
    kernel_shapes, tp_shapes = half_block_shapes()
    results = check_kernels(kernel_shapes)
    results += check_tp_kernels(tp_shapes)
    # The MLP backward's K-major GEMM alone: the image and packed text
    # rows, ViT-L/14@336px at its train batch of 8, and a ragged edge
    # below one tile.
    results += check_gemm_kmajor({"image": (32 * s_img, 768), "text": (rows * g * s, 512),
                                  "vitl336": (VITL336["batch"] * s_l336, 1024),
                                  "edge": (51, 64)})
    both, fb = ("bfloat16", "float32"), ("attend_fwd", "attend_bwd")
    results += check_attend({
        "image_train": (32 * 12, s_img, 64, None, both, fb),
        "image_eval": (EVAL_BATCH * 12, s_img, 64, None, both, fb),
        "text_packed": (rows * 8, g * s, 64, packed_mask, both, fb),
        "text_clip": (100 * 8, 77, 64, causal_mask(77, device="cuda"), both, fb),
        # The tiling's edges: below one mma tile, ragged, ViT-L/14 with 4
        # VPT rows (8 images x 16 heads); the bf16 buckets' largest S and
        # one past it (the CUDA-core route), the fp32 route's largest S
        # before this PR; ViT-L/14@336px (4 images x 16 heads) and S = 1024.
        "edge_s1": (64, 1, 64, None, both, fb),
        "edge_s17": (64, 17, 64, causal_mask(17, device="cuda"), both, fb),
        "vitl_s261": (8 * 16, 1 + 16 * 16 + 4, 64, None, both, fb),
        "max_fwd_bf16": (64, 352, 64, None, ("bfloat16",), ("attend_fwd",)),
        "past_fwd_bf16": (64, 353, 64, None, ("bfloat16",), ("attend_fwd",)),
        "max_fwd_fp32": (64, 348, 64, None, ("float32",), ("attend_fwd",)),
        "max_bwd_bf16": (64, 280, 64, causal_mask(280, device="cuda"), ("bfloat16",),
                         ("attend_bwd",)),
        "past_bwd_bf16": (64, 281, 64, causal_mask(281, device="cuda"), ("bfloat16",),
                          ("attend_bwd",)),
        "max_bwd_fp32": (64, 278, 64, None, ("float32",), ("attend_bwd",)),
        "vitl336_s581": (4 * 16, s_l336, 64, None, both, fb),
        "s1024": (64, 1024, 64, causal_mask(1024, device="cuda"), both, fb)})
    print(f"text tower: s={s}, G={g}, {rows} packed rows of {g * s} tokens", flush=True)
    paths = drive_paths({"visual": (32, s_img, None), "text": (rows, g * s, packed_mask)},
                        (s, g))

    summary = {"card": card_line()}
    for path, out in paths.items():
        summary[path] = {k: out[k] for k in ("ms_per_step", "device_ms_per_step", "img_per_s",
                                             "mfu_host", "mfu_device", "peak_mem_gib")
                         if k in out}
    print("summary " + json.dumps(summary), flush=True)

    print(json.dumps({"kernels": kernel_entries(results, paths)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
