"""The half-blocks' share of their roofline in a step of the cell: each
launch's least time (``roofline.least_ms`` at its shape), summed over the
step's launches, over the same launches' CUDA-event times. Each shape is
timed through the port's public half-block entry points
(``ops/block.py``: ``attn_fwd``, ``attn_bwd``, ``mlp_fwd``, ``mlp_bwd``)
on layer 0's weights of its tower and random activations.

The launches of a step come from the cell's shapes
(``roofline.step_launches``) and are held to the port's launch counters
over one eager step: where they differ, the step no longer runs these
half-blocks as counted, and the metric reads nothing.
"""

from __future__ import annotations

import sys

import torch

from portbench import roofline

REPS = 20
# The port's counter of each half-block's launches (ops._build.LAUNCHES).
COUNTERS = {("attn_fwd", True): "attn_fwd", ("attn_fwd", False): "attn_fwd_infer",
            ("mlp_fwd", True): "mlp_fwd", ("mlp_fwd", False): "mlp_fwd_infer",
            ("attn_bwd", True): "attn_bwd", ("mlp_bwd", True): "mlp_bwd"}


def _layer0(blocks: dict) -> dict:
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in blocks.items()}


def _mask(s: roofline.Shape, device):
    """The additive fp32 mask of a packed text row: causal within each
    class's block, closed across blocks."""
    if not s.causal:
        return None
    neg = torch.finfo(torch.float32).min
    pos = torch.arange(s.tokens, device=device)
    same = (pos[:, None] // s.block_len) == (pos[None, :] // s.block_len)
    keep = same & (pos[None, :] <= pos[:, None])
    return torch.where(keep, 0.0, neg)


def launch_ms(kind: str, s: roofline.Shape, blocks: dict, train: bool, gen) -> float:
    """Median CUDA-event ms of one launch of ``kind`` at shape ``s``."""
    from mvlpt_torch.ops import block

    p = _layer0(blocks)
    dtype, dev = p["attn"]["qkv_w"].dtype, p["attn"]["qkv_w"].device
    x = torch.randn((s.rows, s.tokens, s.width), generator=gen, device=dev, dtype=dtype)
    mask = _mask(s, dev)
    ln1, at, ln2, ml = p["ln_1"], p["attn"], p["ln_2"], p["mlp"]

    def attn_fwd():
        return block.attn_fwd(x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], at["out_w"],
                              at["out_b"], mask, s.heads, save_residuals=train)

    def mlp_fwd():
        return block.mlp_fwd(x, ln2["scale"], ln2["bias"], ml["fc_w"], ml["fc_b"], ml["proj_w"],
                             ml["proj_b"], save_residuals=train)

    if kind == "attn_fwd":
        fn = attn_fwd
    elif kind == "mlp_fwd":
        fn = mlp_fwd
    else:
        gy = torch.randn_like(x)
        if kind == "attn_bwd":
            qkv, probs, mu, rstd = attn_fwd()[1]
            fn = lambda: block.attn_bwd(x, mu, rstd, qkv, probs, ln1["scale"],  # noqa: E731
                                        at["qkv_w"], at["out_w"], gy, s.heads)
        else:
            hpre, mu, rstd = mlp_fwd()[1]
            fn = lambda: block.mlp_bwd(x, mu, rstd, hpre, ln2["scale"], ml["fc_w"],  # noqa: E731
                                       ml["proj_w"], gy)
    with torch.no_grad():
        return roofline.median(roofline.cuda_times(fn, REPS))


def counted(run) -> dict:
    """The port's half-block launch counters over one step of the cell,
    eager (the loop's ``eager_step``)."""
    from mvlpt_torch.ops import _build

    _build.reset_launch_counts()
    run.loop.eager_step()
    torch.cuda.synchronize()
    out = dict(_build.LAUNCHES)
    _build.reset_launch_counts()
    return out


def roofline_pct(run, train: bool) -> float | None:
    """100 x the step's least half-block time over its measured time."""
    cfg, prog = run.cell.config, run.prog
    batch = run.cell.traffic["batch"]
    launches = roofline.step_launches(cfg, batch, prog.text_len, train)
    want: dict = {}
    for (kind, _, _), n in launches.items():
        want[COUNTERS[(kind, train)]] = want.get(COUNTERS[(kind, train)], 0) + n
    got = counted(run)
    if any(got.get(name, 0) != n for name, n in want.items()):
        print(f"halfblock_roofline: the step launched {got}, the cell's shapes count {want}; "
              "not read", file=sys.stderr)
        return None
    gen = torch.Generator(device=run.device).manual_seed(0)
    least = spent = 0.0
    for (kind, tower, shape), n in launches.items():
        ms = launch_ms(kind, shape, prog.backbone[tower]["blocks"], train, gen)
        least += n * roofline.least_ms(kind, shape, cfg["compute_dtype"])
        spent += n * ms
        print(f"halfblock {kind} {shape.rows}x{shape.tokens}x{shape.width} x{n}: {ms:.4f} ms, "
              f"least {roofline.least_ms(kind, shape, cfg['compute_dtype']):.4f}", file=sys.stderr)
    return 100.0 * least / spent
