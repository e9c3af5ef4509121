"""The yardstick of the kernel metrics: the H100's peaks, the operations
and bytes of a transformer half-block from its math, the half-block
launches of a step at the cell's shapes, and CUDA-event timing.

Operations and bytes count what the half-block's math needs, whatever
kernel implements it: each input byte read once (the activations, the
weights, the mask), each output byte written once (y, or dx), no scratch
and no residual a kernel chooses to keep; products only, two operations
a multiply-add. Attention counts the (query, key) pairs its mask leaves:
every pair without a mask, s (s + 1) / 2 for each class's causal block of
s tokens in a packed text row. A backward counts its own products (the
dx-only backward of a frozen block: dO, the four attention products, dx
through both projections), not a forward recomputed.
"""

from __future__ import annotations

import dataclasses
import time

# NVIDIA H100 SXM, dense, without sparsity (NVIDIA's data sheet), at its
# full 700 W; the card's power limit is printed beside every run.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_S = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}


@dataclasses.dataclass(frozen=True)
class Shape:
    """One half-block launch: (rows, tokens a row, width, heads), and
    the attention blocks of a row: ``blocks`` classes of ``block_len``
    tokens each under a causal mask, or one unmasked block of all the
    row's tokens (``causal`` False)."""

    rows: int
    tokens: int
    width: int
    heads: int
    causal: bool
    blocks: int = 1

    @property
    def block_len(self) -> int:
        return self.tokens // self.blocks

    @property
    def pairs(self) -> int:
        """(query, key) pairs the mask leaves, over all rows."""
        t = self.block_len
        per_block = t * (t + 1) // 2 if self.causal else t * t
        return self.rows * self.blocks * per_block


def attn_weights(w: int) -> int:
    """Elements of the attention half-block's parameters."""
    return w * 3 * w + 3 * w + w * w + w + 2 * w


def mlp_weights(w: int) -> int:
    return w * 4 * w + 4 * w + 4 * w * w + w + 2 * w


def ops_bytes(kind: str, s: Shape, dtype: str = "bfloat16") -> tuple[int, int]:
    """(operations, bytes) of one launch of half-block ``kind``:
    "attn_fwd", "mlp_fwd" (with or without residuals kept: the same
    math), "attn_bwd", "mlp_bwd"."""
    e = BYTES[dtype]
    t, w = s.rows * s.tokens, s.width
    act = t * w * e
    mask = s.tokens * s.tokens * 4 if s.causal else 0
    if kind == "attn_fwd":
        return 8 * t * w * w + 4 * s.pairs * w, 2 * act + attn_weights(w) * e + mask
    if kind == "attn_bwd":
        return 8 * t * w * w + 8 * s.pairs * w, 3 * act + attn_weights(w) * e + mask
    if kind == "mlp_fwd":
        return 16 * t * w * w, 2 * act + mlp_weights(w) * e
    if kind == "mlp_bwd":
        return 16 * t * w * w, 3 * act + mlp_weights(w) * e
    raise ValueError(f"unknown half-block {kind!r}")


def least_ms(kind: str, s: Shape, dtype: str = "bfloat16") -> float:
    """The least time one launch could take on the card: the larger of
    operations over the peak rate and bytes over the memory rate."""
    ops, nbytes = ops_bytes(kind, s, dtype)
    return max(ops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_S) * 1e3


def packing(n_cls: int, s: int, target_tokens: int = 128) -> tuple[int, int]:
    """(G, rows) of the class-packed text tower: G = 128 // s classes a
    row (1: no packing), a frozen copy of the port's rule."""
    g = max(1, target_tokens // s)
    if g <= 1 or n_cls <= g:
        return 1, n_cls
    return g, -(-n_cls // g)


def image_tokens(clip: dict, prompt: dict) -> int:
    return 1 + (clip["image_resolution"] // clip["vision_patch_size"]) ** 2 + prompt["vpt_n_ctx"]


def step_launches(cfg: dict, batch: int, text_len: int, train: bool) -> dict:
    """{(kind, tower, Shape): launches a step} of the cell's half-blocks,
    tower "visual" or "text": a train step runs both towers forward
    (twice under remat: the backward runs each block's forward again) and
    backward; the cached-text eval runs the image tower forward only."""
    from portbench.program import classnames

    clip, n_cls = cfg["clip"], len(classnames(cfg))
    image = Shape(batch, image_tokens(clip, cfg["prompt"]), clip["vision_width"],
                  clip["vision_heads"], causal=False)
    layers = clip["vision_layers"]
    if not train:
        return {("attn_fwd", "visual", image): layers, ("mlp_fwd", "visual", image): layers}
    g, rows = packing(n_cls, text_len)
    text = Shape(rows, g * text_len, clip["transformer_width"], clip["transformer_heads"],
                 causal=True, blocks=g)
    fwd = 2 if cfg["remat"] else 1
    out = {}
    for tower, shape, layers in (("visual", image, clip["vision_layers"]),
                                 ("text", text, clip["transformer_layers"])):
        out[("attn_fwd", tower, shape)] = fwd * layers
        out[("mlp_fwd", tower, shape)] = fwd * layers
        out[("attn_bwd", tower, shape)] = layers
        out[("mlp_bwd", tower, shape)] = layers
    return out


def cuda_times(fn, reps: int) -> list[float]:
    """The sorted ms of ``reps`` runs of fn, each between its own pair of
    CUDA events. A sleep kernel holds the card while the host enqueues
    every run, so each pair reads the card's time for that run alone, not
    the host's launch gaps; the sleep is sized from the host's time to
    enqueue a warm-up run. (The arithmetic of chip_smoke.py's cuda_times.)"""
    import torch

    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    # Cycles at about 1.5 GHz: twice what the host took to enqueue as many
    # runs, plus a millisecond.
    torch.cuda._sleep(int(min(2 * reps * enqueue_s + 1e-3, 5.0) * 1.5e9))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(start.elapsed_time(end) for start, end in events)


def median(values: list[float]) -> float:
    values = sorted(values)
    return values[len(values) // 2]
