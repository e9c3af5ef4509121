"""Transformer building blocks as functions over parameter trees.

The counterpart of ``mvlpt_tpu/core/layers.py``, with the same rounding
points:
  * LayerNorm computes in fp32 with eps 1e-5 and casts back.
  * QuickGELU ``x * sigmoid(1.702 x)``, not exact GELU.
  * Matmuls accumulate in fp32 and round to the input dtype, with the
    weight first cast to that dtype (``_matmul``).
  * Attention scales q before the score product, takes the softmax in
    fp32 and keeps the probabilities in the compute dtype.

Layout is batch-major ``(B, S, W)``; per-layer parameters are stacked on
a leading layer axis and the stack runs as a Python loop. Gradients of
the plain path come from torch autograd. ``remat`` recomputes each
block's forward in the backward instead of keeping its activations
(``torch.utils.checkpoint``; the JAX package's ``jax.checkpoint`` a
layer, TRAINER.ACT_CKPT > 1).

``kernels`` is what ``ops.attention.select_attn_fn`` returns: an
``ops.block.BlockKernels`` routes each block to the fused half-block
kernels (their tensor-parallel parts under a mesh with a model axis);
an attention function (``ops.attention.fused_attention``)
replaces the attention core between the qkv and out-projection
products; None keeps the plain path.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from mvlpt_torch.ops import block as block_ops


def layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """fp32-island LayerNorm."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _matmul(x: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w (+ b) with fp32 accumulation, output in x.dtype. The weight
    is cast to x.dtype first, as ``jnp.dot(x, w.astype(x.dtype))``."""
    y = torch.matmul(x.float(), w.to(x.dtype).float())
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _sdpa(q, k, v, mask):
    """softmax((q * scale) k^T + mask) v over (B, H, S, D): q scaled in
    the compute dtype, fp32 logits and softmax, probabilities rounded to
    the compute dtype, fp32 accumulation of p v."""
    dtype = v.dtype
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.matmul(probs.float(), v.float()).to(dtype)


def attention(x: torch.Tensor, p: dict, n_heads: int,
              mask: torch.Tensor | None = None, attn_fn=None) -> torch.Tensor:
    """Multi-head self-attention. ``mask`` is additive fp32 (S, S) or None.
    ``attn_fn(q, k, v, mask)`` on (B, H, S, D) replaces the plain core."""
    b, s, w = x.shape
    head_dim = w // n_heads
    qkv = _matmul(x, p["qkv_w"], p["qkv_b"])  # (B, S, 3W)
    q, k, v = qkv.view(b, s, 3, n_heads, head_dim).permute(2, 0, 3, 1, 4)
    o = (attn_fn or _sdpa)(q, k, v, mask)     # (B, H, S, D)
    o = o.transpose(1, 2).reshape(b, s, w)
    return _matmul(o, p["out_w"], p["out_b"])


def mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    h = quick_gelu(_matmul(x, p["fc_w"], p["fc_b"]))
    return _matmul(h, p["proj_w"], p["proj_b"])


def residual_block(x: torch.Tensor, p: dict, n_heads: int,
                   mask: torch.Tensor | None = None, kernels=None) -> torch.Tensor:
    """Pre-LN residual block under a kernel selection (see the module
    docstring)."""
    if isinstance(kernels, block_ops.BlockKernels):
        mesh = kernels.mesh
        if mesh is not None and mesh.n_model > 1:
            return block_ops.fused_residual_block_sharded(x, p, n_heads, mask, mesh)
        # Without a model axis each data rank runs the fused block on its
        # own rows.
        return block_ops.fused_residual_block(
            x, p, n_heads, mask, inference=kernels.inference)
    x = x + attention(layer_norm(x, p["ln_1"]), p["attn"], n_heads, mask, kernels)
    x = x + mlp(layer_norm(x, p["ln_2"]), p["mlp"])
    return x


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i`` of a stacked block tree (views, no copies)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def transformer(x: torch.Tensor, blocks: dict, n_heads: int,
                mask: torch.Tensor | None = None, *,
                inject: torch.Tensor | None = None, kernels=None,
                remat: bool = False) -> torch.Tensor:
    """Run a stacked-parameter transformer.

    ``inject``, of shape (L, n_ctx, W), holds deep-VPT rows: before
    layer i >= 1, token positions [1, 1+n_ctx) are replaced by row i,
    broadcast over the batch. Layer 0 is never injected, so row 0 is a
    dummy. ``remat`` checkpoints every block, layer 0 included, when
    autograd records: the backward runs the block's forward again
    (kernels included) and reads the recomputed residuals; the
    injection stays outside the checkpoint. The block is deterministic,
    so the values equal those without remat bit for bit."""
    n_layers = blocks["ln_1"]["scale"].shape[0]
    remat = remat and torch.is_grad_enabled()
    for i in range(n_layers):
        if inject is not None and i >= 1:
            n_ctx = inject.shape[1]
            rows = inject[i].to(x.dtype)[None].expand(x.shape[0], n_ctx, x.shape[2])
            x = torch.cat([x[:, :1], rows, x[:, 1 + n_ctx:]], dim=1)
        p = layer_params(blocks, i)
        if remat:
            # No RNG runs in a block, so none is saved (saving it would
            # read the generator's state, which a CUDA-graph capture
            # forbids).
            x = checkpoint(residual_block, x, p, n_heads, mask, kernels,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = residual_block(x, p, n_heads, mask, kernels)
    return x


def causal_mask(size: int, device=None) -> torch.Tensor:
    """Additive causal mask: fp32 ``finfo.min`` above the diagonal
    (not -inf, so a fully masked row stays finite)."""
    mask = torch.full((size, size), torch.finfo(torch.float32).min,
                      dtype=torch.float32, device=device)
    return torch.triu(mask, diagonal=1)


# The dropout masks are counter-based: a hash of (the step's key, the
# stream, the element's index), computed in int64 tensor arithmetic on the
# key's device. No generator state is read or advanced, so a step draws
# the same mask eagerly, in a window and in a CUDA graph's replay, and a
# checkpointed recompute would draw it again unchanged.
_M32 = 0xFFFFFFFF
# Odd multipliers below 2^31, so that every product of a 32-bit value
# fits in int64.
_MIX = (0x7FEB352D, 0x2C1B3C6D, 0x297A2D39)
_STREAM = 0x5BD1E995
_WEYL = 0x61C88647


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of int64 values in [0, 2^32)."""
    for mult in _MIX:
        x = x ^ (x >> 16)
        x = (x * mult) & _M32
    return x ^ (x >> 16)


def dropout_key(seed: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The () int64 key of one train step, from the epoch's seed and the
    update count, both tensors on the device."""
    return _mix32((_mix32(seed & _M32) + (count & _M32)) & _M32)


def keep_mask(key: torch.Tensor, stream: int, shape, keep: float) -> torch.Tensor:
    """A bool mask of ``shape`` on the key's device, each element kept with
    probability ``keep``: element i is kept when the hash of (key, stream,
    i) falls below keep x 2^32. ``stream`` separates the draws one key
    serves (VPT's shallow and deep rows)."""
    n = math.prod(shape)
    base = _mix32((key + stream * _STREAM) & _M32)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    u = _mix32((base + idx * _WEYL) & _M32)
    return (u < int(keep * 2 ** 32)).reshape(shape)


def dropout(x: torch.Tensor, rate: float, key: torch.Tensor | None,
            stream: int = 0) -> torch.Tensor:
    """Inverted dropout as the JAX package's: each element kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else 0. The mask is
    ``keep_mask(key, stream, ...)``; no key (eval) or rate 0 is the
    identity."""
    if rate <= 0.0 or key is None:
        return x
    keep = 1.0 - rate
    mask = keep_mask(key, stream, tuple(x.shape), keep)
    return torch.where(mask, x / keep, torch.zeros_like(x))
