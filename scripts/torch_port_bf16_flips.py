#!/usr/bin/env python3
"""Where the bf16 attention half-block forward (#5, no residuals) parts
from its plain twin, stage by stage, on one card.

    python3 scripts/torch_port_bf16_flips.py [--batch 100]

At chip_smoke.py's image_eval inputs (ViT-B/16 widths, S = 201, its
seed) it runs the kernel once with its scratch kept (xh, qkv, o) and
prints, for each rounding point, the share of bf16 elements that land on
the other side of a rounding from:

  * the twin's value (xh, qkv, o, y), and, where the stage's inputs are
    the kernel's own, the twin's function of them (qkv from the kernel's
    xh, o from its qkv, y from its o): the stage's own share;
  * the same function with fp64 sums ("exact"), for the kernel and the
    twin (qkv, o; and y through the whole chain): how far each one's sums
    sit from exact. Every stage is the twin's own (ops/block.py
    _affine_plain, _mha_plain, _add), with acc=torch.float32 for the
    twin and torch.float64 for the fp64-summed twin.

Also y's elements in the top binade of max|ref| that differ (each is
one bf16 ulp there, which is above the old bf16 bound of 5e-3 x max|ref|
when max|ref| is below 6.25 x its binade's base), each traced to its
token's o row, its image's qkv and xh and its heads' probability rows;
and the same counts for the MLP forward (#6). Prints the card
(nvidia-smi name and power limit) and one JSON line. Needs a card.

    python3 scripts/torch_port_bf16_flips.py --rows

runs chip_smoke.py's half-block check rows (#1-#10 at its shapes and
seeds, both dtypes) untimed and without stopping at a row past its bound,
and ends with one JSON line of every row's numbers under the bf16 rule
(chip_smoke.verdict) and the old bound.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--rows", action="store_true",
                    help="chip_smoke.py's half-block check rows instead")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_port_bf16_flips: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, layer_params
    from mvlpt_torch.ops import _build, block

    print(card_line())  # name, power limit (nvidia-smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.rows:
        return check_rows()
    bf = torch.bfloat16
    b, s, w, h = args.batch, 1 + 14 * 14 + 4, 768, 12
    gen = torch.Generator().manual_seed(7)  # chip_smoke.check_kernels' seed
    p = layer_params(w, bf, gen)
    x = torch.randn((b, s, w), generator=gen).to("cuda", bf)
    ln1, at, ml = p["ln_1"], p["attn"], p["mlp"]

    def new(*shape):
        return torch.empty(shape, dtype=bf, device="cuda")

    xh, qkv, o, y = new(b, s, w), new(b, s, 3 * w), new(b, s, w), new(b, s, w)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.call("attn_fwd", 1, ptr(x), ptr(ln1["scale"]), ptr(ln1["bias"]), ptr(at["qkv_w"]),
                ptr(at["qkv_b"]), ptr(at["out_w"]), ptr(at["out_b"]), None, ptr(xh), ptr(qkv),
                ptr(o), None, None, None, ptr(y), b, s, w, h, 1e-5,
                torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()

    def share(got, ref):
        return (got != ref).float().mean().item()

    # The twin's stages, their sums in dt.
    def core(qkv_in, dt):
        return block._mha_plain(qkv_in, None, h, dt)[0]

    def qkv_of(xh_in, dt):
        return block._affine_plain(xh_in, at["qkv_w"], at["qkv_b"], dt)

    def hb_of(o_in, dt):
        return block._affine_plain(o_in, at["out_w"], at["out_b"], dt)

    def y_of(o_in, dt):
        return block._add(x, hb_of(o_in, dt), dt)

    def top(got, ref):
        """Elements of ref's top binade that differ, and how many it has."""
        big = ref.float().abs() >= 2.0 ** math.floor(math.log2(ref.float().abs().max().item()))
        return int(((got != ref) & big).sum().item()), int(big.sum().item())

    f32, f64 = torch.float32, torch.float64
    xh_t = block._ln2d(x.float(), ln1["scale"].float(), ln1["bias"].float(), 1e-5)[0].to(bf)
    qkv_t = qkv_of(xh_t, f32)
    y_t = block.attn_fwd_plain(x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"],
                               at["out_w"], at["out_b"], None, h, save_residuals=False)[0]
    mlp_args = (x, p["ln_2"]["scale"], p["ln_2"]["bias"], ml["fc_w"], ml["fc_b"], ml["proj_w"],
                ml["proj_b"])
    ym = block.mlp_fwd(*mlp_args, save_residuals=False)[0]
    ym_t = block.mlp_fwd_plain(*mlp_args, save_residuals=False)[0]
    # The whole chain with fp64 sums, rounded at the same points.
    y_x = y_of(core(qkv_of(xh_t, f64), f64), f64)
    out = {
        "shape": [b, s, w, h],
        "y_vs_fp64_chain": {"kernel": share(y, y_x), "twin": share(y_t, y_x),
                            "kernel_top_binade": top(y, y_x), "twin_top_binade": top(y_t, y_x)},
        "xh": {"vs_twin": share(xh, xh_t)},
        "qkv": {"vs_twin": share(qkv, qkv_t), "vs_twin_of_kernel_xh": share(qkv, qkv_of(xh, f32)),
                "kernel_vs_exact": share(qkv, qkv_of(xh, f64)),
                "twin_vs_exact": share(qkv_of(xh, f32), qkv_of(xh, f64))},
        "o": {"vs_twin_of_kernel_qkv": share(o, core(qkv, f32)),
              "kernel_vs_exact": share(o, core(qkv, f64)),
              "twin_vs_exact": share(core(qkv, f32), core(qkv, f64))},
        "y": {"vs_twin": share(y, y_t), "vs_twin_of_kernel_o": share(y, y_of(o, f32)),
              "max_abs_err": (y.float() - y_t.float()).abs().max().item(),
              "max_abs_ref": y_t.float().abs().max().item(), "top_binade": top(y, y_t)},
        "mlp_y": {"vs_twin": share(ym, ym_t),
                  "max_abs_err": (ym.float() - ym_t.float()).abs().max().item(),
                  "max_abs_ref": ym_t.float().abs().max().item(), "top_binade": top(ym, ym_t)},
    }
    out["y_top_binade_flips"] = trace_flips(
        y, y_t, y_x, x, xh, xh_t, qkv, qkv_t, o, probs_of(x, p), core, hb_of, (b, s, w, h))
    print(json.dumps(out))
    return 0


def probs_of(x, p):
    """The kernel's probabilities on the same inputs (its training form)."""
    from mvlpt_torch.ops import block

    ln1, at = p["ln_1"], p["attn"]
    return block.attn_fwd(x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], at["out_w"],
                          at["out_b"], None, at["qkv_w"].shape[0] // 64)[1][1]


def trace_flips(y, y_t, y_x, x, xh, xh_t, qkv, qkv_t, o, probs, core, hb_of, dims, limit=8):
    """Where each element of y_t's top binade that the kernel rounds the
    other way comes from: the values around its rounding, and how many
    elements of its token's o row, its image's qkv and xh, and its heads'
    probability rows differ from the twin's (the core's share: from the
    twin's core on the kernel's own qkv)."""
    import torch

    from mvlpt_torch.ops import block

    b, s, w, h = dims
    d = w // h
    f32 = torch.float32
    top = y_t.float().abs() >= 2.0 ** math.floor(math.log2(y_t.float().abs().max().item()))
    o_t, o_kq = core(qkv_t, f32), core(qkv, f32)
    p_kq = block._mha_plain(qkv, None, h)[1]  # the twin's probabilities on the kernel's qkv
    hb_t, hb_k = hb_of(o_t, f32), hb_of(o, f32)
    rows = []
    for bi, si, ci in ((y != y_t) & top).nonzero().tolist()[:limit]:
        heads = sorted({c // d for c in (o[bi, si] != o_t[bi, si]).nonzero().flatten().tolist()})
        rows.append({
            "at": [bi, si, ci], "x": x[bi, si, ci].item(), "y": y[bi, si, ci].item(),
            "y_twin": y_t[bi, si, ci].item(), "y_fp64_chain": y_x[bi, si, ci].item(),
            "hb_twin": hb_t[bi, si, ci].item(), "hb_of_kernel_o": hb_k[bi, si, ci].item(),
            "o_row_differs": int((o[bi, si] != o_t[bi, si]).sum()),
            "o_row_differs_from_core": int((o[bi, si] != o_kq[bi, si]).sum()),
            "o_row_heads": heads,
            "probs_rows_differ_from_core": [int((probs[bi, hh, si] != p_kq[bi, hh, si]).sum())
                                            for hh in heads],
            "qkv_image_differs": int((qkv[bi] != qkv_t[bi]).sum()),
            "xh_image_differs": int((xh[bi] != xh_t[bi]).sum()),
            "xh_row_differs": int((xh[bi, si] != xh_t[bi, si]).sum())})
    return rows


def check_rows() -> int:
    """chip_smoke's check_kernels and check_tp_kernels rows, untimed, each
    reported against its bound however many are past it."""
    import chip_smoke

    print(chip_smoke.setup_vocab())
    chip_smoke.timed = lambda kern, plain, lib=None: dict(ms=None, ms_spread=None, plain_ms=None,
                                                         library_ms=None)
    chip_smoke.cuda_ms = lambda fn: None
    chip_smoke._fail_on_disagreement = lambda rows: rows
    kernel_shapes, tp_shapes = chip_smoke.half_block_shapes()
    rows = chip_smoke.check_kernels(kernel_shapes) + chip_smoke.check_tp_kernels(tp_shapes)
    print(json.dumps({"rows": [
        {k: r.get(k) for k in ("name", "mode", "tower", "dtype", "max_abs_err", "max_abs_err64",
                               "twin_err64", "tol", "ok", "tol_old", "ok_old", "differ_share",
                               "differ_share64")} for r in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
