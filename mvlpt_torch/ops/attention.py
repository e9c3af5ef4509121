"""Standalone fused attention and the port's kernel selection.

The counterpart of ``mvlpt_tpu/ops/attention.py``. ``fused_attention``
is the counterpart of ``pallas_attention``: o = softmax(q k^T * scale +
mask) v over (B, H, S, D), whose backward recomputes the probabilities,
so its only residuals are q, k, v and the mask (the JAX custom VJP,
attention.py:112-148). Its two kernels work on (N, S, D) rows, N = B*H:

  * ``attend_fwd`` (``_fwd_kernel``): s = q k^T on the unscaled q in
    fp32, then ``s * scale + mask``; fp32 softmax; p rounded to the
    compute dtype; o = p v accumulated in fp32 and rounded. (The
    half-block kernel of ``ops/block.py`` scales and rounds q before the
    product instead.)
  * ``attend_bwd`` (``_bwd_kernel``): p recomputed in fp32 as above;
    dv = round(p)^T do; dp = do v^T kept in fp32; ds = round(p (dp -
    rowsum(dp p)) * scale) from the unrounded p; dq = ds k, dk = ds^T q,
    accumulated in fp32 and rounded.

The JAX side pads S to a multiple of 128 with ``finfo.min`` on the
padded keys. They take no probability there, so the real rows equal an
unpadded call's, and the port does not pad. Each wrapper runs its CUDA
kernel (``csrc/attend_{fwd,bwd}.cu``) on a CUDA tensor, or raises; it
runs the plain twin beside it only on a CPU tensor.
"""

from __future__ import annotations

import torch

from mvlpt_torch.ops import _build
from mvlpt_torch.ops.block import _DTYPE_CODE, BlockKernels, _ptr, _stream

# Shared memory of one block, in fp32 words, as csrc/attend_{fwd,bwd}.cu
# lay it out (32-row query and key tiles); a shape past it is refused.
_TILE = 32
_SMEM_WORDS = 232448 // 4


def _smem_words(kind: str, s: int, d: int) -> int:
    if kind == "attend_fwd":
        return s * (d + 1) + s * d + _TILE * d + _TILE * s
    return max(2 * s * (d + 1) + 2 * _TILE * d + 2 * _TILE * s, 2 * s * d + 2 * _TILE * s)


# ------------------------------------------------------------ plain twins

def _scores(q, k, mask):
    """fp32 probabilities softmax(q k^T * scale + mask) on (N, S, D)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        s = s + mask.float()
    return torch.softmax(s, dim=-1)


def attend_fwd_plain(q, k, v, mask=None):
    p = _scores(q, k, mask).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def attend_bwd_plain(q, k, v, mask, do):
    dtype = q.dtype
    do = do.to(dtype)
    p = _scores(q, k, mask)
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), do.float()).to(dtype)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = (ds * q.shape[-1] ** -0.5).to(dtype).float()
    dq = torch.matmul(ds, k.float()).to(dtype)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()).to(dtype)
    return dq, dk, dv


# --------------------------------------------------------------- wrappers

def _rows(name, q, others, mask):
    """(N, S, D) of the CUDA rows the kernels take: ``others`` must match
    q's shape, dtype and device, ``mask`` be an fp32 (S, S) tensor or
    None, all contiguous, and the shape fit one block's shared memory."""
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (N, S, D), got {tuple(q.shape)}")
    n, s, d = q.shape
    want = [(t, tuple(q.shape), q.dtype) for t in (q, *others)]
    if mask is not None:
        want.append((mask, (s, s), torch.float32))
    for t, shape, dtype in want:
        if (t.device != q.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: got a {tuple(t.shape)} {t.dtype} tensor on {t.device}, "
                             f"want a contiguous {shape} {dtype} tensor on {q.device}")
    if _smem_words(name, s, d) > _SMEM_WORDS:
        raise ValueError(f"{name}: S={s}, D={d} needs more shared memory than one block has")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    return n, s, d


def attend_fwd(q, k, v, mask=None):
    """Fused attention forward on (N, S, D) rows -> o."""
    if q.device.type == "cpu":
        return attend_fwd_plain(q, k, v, mask)
    n, s, d = _rows("attend_fwd", q, (k, v), mask)
    o = torch.empty_like(q)
    _build.call("attend_fwd", _DTYPE_CODE[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(mask),
                _ptr(o), n, s, d, _stream())
    _build.LAUNCHES["attend_fwd"] += 1
    return o


def attend_bwd(q, k, v, mask, do):
    """Fused attention backward on (N, S, D) rows -> (dq, dk, dv)."""
    if q.device.type == "cpu":
        return attend_bwd_plain(q, k, v, mask, do)
    do = do.to(q.dtype).contiguous()
    n, s, d = _rows("attend_bwd", q, (k, v, do), mask)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    p = torch.empty((n, s, s), dtype=q.dtype, device=q.device)  # scratch: T(p), ds
    ds = torch.empty_like(p)
    _build.call("attend_bwd", _DTYPE_CODE[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(mask),
                _ptr(do), _ptr(p), _ptr(ds), _ptr(dq), _ptr(dk), _ptr(dv), n, s, d, _stream())
    _build.LAUNCHES["attend_bwd"] += 1
    return dq, dk, dv


class _Attend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return attend_fwd(q, k, v, mask)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        return (*attend_bwd(q, k, v, mask, do), None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Drop-in attention core for ``core.layers.attention``: the
    counterpart of ``pallas_attention``. q, k, v: (B, H, S, D); mask:
    additive fp32 (S, S) or None. The backward recomputes the
    probabilities; the residuals are q, k, v and the mask."""
    b, h, s, d = q.shape
    q, k, v = (t.reshape(b * h, s, d).contiguous() for t in (q, k, v))
    if mask is not None:
        mask = mask.float().contiguous()
    return _Attend.apply(q, k, v, mask).view(b, h, s, d)


def select_attn_fn(use_pallas: str = "auto", inference: bool = False):
    """Resolve ``TPU.USE_PALLAS`` for the port, the counterpart of
    ``mvlpt_tpu/ops/attention.py:select_attn_fn``. Returns what
    ``core.layers`` takes as ``kernels``:

      * "block", "auto": ``BlockKernels(inference=...)``, the fused
        half-block kernels on both towers (the JAX "auto" downgrade of
        the text tower is a TPU measurement and does not carry over);
        ``inference=True`` selects their no-grad forwards;
      * "on": ``fused_attention``, the standalone fused attention (one
        forward for training and eval);
      * "off": None, the plain layer path (torch autograd).

    On a card the kernels run, on the CPU their plain twins."""
    if use_pallas in ("block", "auto"):
        return BlockKernels(inference=inference)
    if use_pallas == "on":
        return fused_attention
    if use_pallas == "off":
        return None
    raise ValueError(f"unknown kernel selection {use_pallas!r}")
