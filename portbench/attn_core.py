"""The yardstick of the attention core metrics: the operations and bytes
of the attention core alone, from its math, and the core launches of a
train step at the cell's shapes, against ``roofline.py``'s peaks.

The core is what lies between the qkv product and the out-projection of
an attention half-block: the scores, the softmax and the product with V
(forward), or dV, dP, dS, dQ and dK (backward). It counts by
``roofline.py``'s rules: products only, two operations a multiply-add,
the (query, key) pairs the mask leaves (every pair without a mask, a
causal block's s (s + 1) / 2 in a packed text row), each input byte read
once and each output byte written once.

* The forward with probabilities: S = Q Kᵀ and O = P V, 4 D operations a
  pair a head; it reads qkv (and a packed text row's fp32 (S, S) mask)
  and writes o and the probabilities of the pairs.
* The backward: dV = Pᵀ dO, dP = dO Vᵀ, dQ = dS K and dK = dSᵀ Q, 8 D
  operations a pair a head; it reads qkv, the probabilities and dO, and
  writes dqkv and the fp32 (B, H, S) scratch t = rowsum(dP P).
"""

from __future__ import annotations

from portbench import roofline

# The core of each attention half-block of roofline.step_launches.
CORE_OF = {"attn_fwd": "fwd", "attn_bwd": "bwd"}


def ops_bytes(kind: str, s: roofline.Shape, dtype: str = "bfloat16") -> tuple[int, int]:
    """(operations, bytes) of one core launch of ``kind`` ("fwd": with
    probabilities; "bwd") over shape ``s``."""
    e = roofline.BYTES[dtype]
    tokens, w = s.rows * s.tokens, s.width
    qkv, o = 3 * tokens * w * e, tokens * w * e
    probs = s.pairs * s.heads * e
    if kind == "fwd":
        mask = s.tokens * s.tokens * 4 if s.causal else 0
        return 4 * s.pairs * w, qkv + mask + o + probs
    if kind == "bwd":
        dout, dqkv, scratch = o, qkv, s.rows * s.heads * s.tokens * 4
        return 8 * s.pairs * w, qkv + probs + dout + dqkv + scratch
    raise ValueError(f"unknown core {kind!r}")


def least_ms(kind: str, s: roofline.Shape, dtype: str = "bfloat16") -> float:
    """The least time one core launch could take on the card: the larger
    of operations over the peak rate and bytes over the memory rate."""
    ops, nbytes = ops_bytes(kind, s, dtype)
    return max(ops / roofline.PEAK_FLOPS[dtype], nbytes / roofline.HBM_BYTES_S) * 1e3


def step_cores(cfg: dict, batch: int, text_len: int) -> dict:
    """{(kind, tower, Shape): launches a train step} of the cores: one for
    each attention half-block launch of ``roofline.step_launches``, remat's
    second forwards included."""
    return {(CORE_OF[half], tower, shape): n
            for (half, tower, shape), n in roofline.step_launches(cfg, batch, text_len,
                                                                  train=True).items()
            if half in CORE_OF}


def step_least_ms(cfg: dict, batch: int, text_len: int) -> float:
    """The least time of a train step's core launches, summed."""
    return sum(n * least_ms(kind, shape, cfg["compute_dtype"])
               for (kind, _, shape), n in step_cores(cfg, batch, text_len).items())
