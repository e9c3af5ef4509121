#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mvlpt_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

1. Builds the four half-block kernels from mvlpt_torch/csrc with nvcc
   (sm_90a), prints the build time, the vocab in use and the card.
2. Holds each kernel against its plain PyTorch twin on the card at the
   flagship shapes (ViT-B/16 image tower; class-packed text tower with its
   block-causal mask), in fp32 and bf16, including the no-residual
   forwards, and times kernel, twin and, for attention, the library's
   scaled_dot_product_attention on the attention core.
3. Drives the flagship MVLPT UPT train step (ViT-B/16, batch 32, 100
   classes, bf16, kernels on both towers) for a few SGD steps on seeded
   uint8 images, checks the launch counts and the first loss against
   the plain path on the card.
4. Prints one JSON line of kernel numbers, then, as the last line,
   {"ok": true, "device": {...}}.

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
STEPS = 6                 # SGD steps on the main path (the first one warms up)
HBM_BYTES_S = 3.35e12     # H100 SXM memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; fp32 CUDA cores
# max|kernel - twin| <= TOL x max|twin|. The kernels sum in another order
# than the twins' fp32 products, so a bf16 output can differ by one ulp
# where a value lands near a rounding boundary.
TOL = {"float32": 1e-4, "bfloat16": 5e-3}
REPLACES = {
    "attn_fwd": "mvlpt_tpu/ops/block.py:149",
    "attn_bwd": "mvlpt_tpu/ops/block.py:226",
    "mlp_fwd": "mvlpt_tpu/ops/block.py:486",
    "mlp_bwd": "mvlpt_tpu/ops/block.py:532",
}


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
    """Every kernel and mode against its plain twin; returns result rows."""
    import torch
    import torch.nn.functional as F

    from mvlpt_torch.ops import block

    rows = []
    # shapes[tower] = (B, S, W, H, mask, seg, n_seq): n_seq sequences of
    # seg tokens hold data (images; or classes packed G to a row).
    for (tower, dtype_name), (b, s, w, h, mask, seg, n_seq) in (
            ((t, d), shapes[t]) for t in ("image", "text") for d in ("bfloat16", "float32")):
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
        for name, mode, kern, plain, flops, nbytes, lib in cases:
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
    bad = [f"{r['name']} ({r['mode']}, {r['tower']}, {r['dtype']}): max|err| "
           f"{r['max_abs_err']} > {r['tol']}" for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("kernels disagree with their plain twins: " + "; ".join(bad))
    return rows


def drive_main_path() -> dict:
    """The flagship train step with kernels on both towers, against the
    plain layer path's first step on the same inputs."""
    import numpy as np
    import torch

    from mvlpt_torch.config import OptimConfig
    from mvlpt_torch.core.text import packing
    from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, flagship
    from mvlpt_torch.models import MVLPTModel
    from mvlpt_torch.ops import block
    from mvlpt_torch.train import init_train_state, make_train_step

    model, backbone, pp, consts, _, clip_cfg = flagship(device="cuda", kernels="auto")
    if model.kernels is None:
        raise AssertionError("kernels='auto' did not select the fused kernels on the card")
    ocfg = OptimConfig(LR=0.002, LR_SCHEDULER="cosine", MAX_EPOCH=200)
    rng = np.random.RandomState(0)
    res = clip_cfg.image_resolution
    batches = [{"image": torch.from_numpy(rng.randint(0, 256, (32, res, res, 3)).astype(np.uint8)),
                "label": torch.from_numpy(rng.randint(0, 100, 32))} for _ in range(STEPS)]
    batches = [{k: v.cuda() for k, v in bt.items()} for bt in batches]
    norm = (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)

    plain = MVLPTModel(clip_cfg, model.spec, kernels=None, compute_dtype=model.compute_dtype)
    _, m_plain = make_train_step(plain, normalize=norm)(
        init_train_state(pp, ocfg, 100), backbone, consts, batches[0])
    loss_plain = m_plain["loss"].item()

    state = init_train_state(pp, ocfg, 100)
    step = make_train_step(model, normalize=norm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    block.reset_launch_counts()
    losses, times = [], []
    for bt in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, backbone, consts, bt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
    launches = dict(block.LAUNCHES)
    s = consts.token_suffix.shape[1] + 1 + model.spec.coop_n_ctx
    g, rows = packing(model.spec.n_cls, s)
    ms_step = 1e3 * sum(times[1:]) / len(times[1:])
    out = dict(losses=losses, loss_plain_first=loss_plain, launches=launches,
               ms_per_step=ms_step, img_per_s=32 * 1e3 / ms_step, step_ms=[1e3 * t for t in times],
               text_s=s, text_G=g, text_rows=rows, text_row_len=g * s,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               grad_norm_last=metrics["grad_norm"].item())
    print("main-path " + json.dumps(out), flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss on the main path: {losses}")
    want = clip_cfg.vision_layers + clip_cfg.transformer_layers
    for name, n in launches.items():
        if n != want * STEPS:
            raise AssertionError(f"{name}: {n} launches in {STEPS} steps, want {want} a step")
    if abs(losses[0] - loss_plain) > 1e-2 * abs(loss_plain):
        raise AssertionError(f"first loss {losses[0]} vs plain path {loss_plain}")
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
    shapes = {"image": (32, s_img, 768, 12, None, s_img, 32),
              "text": (rows, g * s, 512, 8, block_causal_mask(g, s, device="cuda"), s, 100)}
    results = check_kernels(shapes)
    main_out = drive_main_path()

    kernels = []
    for name in _build.SOURCES:
        r = next(x for x in results if x["name"] == name and x["mode"] == "train"
                 and x["tower"] == "image" and x["dtype"] == "bfloat16")
        kernels.append({"name": name, "route": "cuda", "source": f"mvlpt_torch/csrc/{name}.cu",
                        "replaces": REPLACES[name], "launches": main_out["launches"][name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
