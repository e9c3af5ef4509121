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
runs the plain twin beside it only on a CPU tensor. The kernels take one
of two routes (``ROUTES``), by dtype and S, chosen openly by shape
(``route_of``), never as a fallback:

  * bfloat16 rows up to the tensor-core buckets' largest S (352 forward,
    280 backward) on the tensor cores (``mma.sync``, ``csrc/mma.cuh``);
    the backward keeps only a (3, N, S) fp32 scratch of row statistics;
  * float32 rows, and bfloat16 rows past the buckets, on the CUDA cores,
    with the same rounding points: K and V (and, backward, q and do)
    stream through shared memory in chunks, so any S whose fp32 score
    row fits one block (``_fma_words``: up to 49,728 forward and 24,800
    backward at D = 64); the backward moves T(p) and ds through two
    (N, S, S) scratch tensors in the dtype.

The bf16 rows take D = 64 only, on either route.
"""

from __future__ import annotations

import torch

from mvlpt_torch.ops import _build
from mvlpt_torch.ops.block import _DTYPE_CODE, BlockKernels, _ptr, _stream

ROUTES = {"mma": "tensor cores (mma.sync, bf16)",
          "fma": "CUDA cores (FMA, fp32 accumulation)"}

# The bf16 rows' head width (the tensor-core fragments'), and the largest
# S of the tensor-core buckets (csrc/attend_fwd.cu FWD_NT, attend_bwd.cu
# BWD_NT).
_TC_D = 64
_TC_MAX_S = {"attend_fwd": 352, "attend_bwd": 280}

# The CUDA-core route's shared memory of one block, in fp32 words, as
# csrc/fma_attn.cuh and attend_bwd.cu lay it out with one query row:
# K and V chunks of 64 keys (K, and backward V, padded a column), the
# query row's q (and do) and accumulators, and its S-long fp32 score row
# (backward: p and dp); the backward's dk/dv kernel, q and do chunks of
# 64 queries beside 32 keys' p, ds and accumulators.
_CHUNK, _KEYS = 64, 32
_SMEM_WORDS = 232448 // 4


def _fma_words(kind: str, s: int, d: int) -> int:
    if kind == "attend_fwd":
        return _CHUNK * (d + 1) + _CHUNK * d + 2 * d + s
    dq = 2 * _CHUNK * (d + 1) + 3 * d + 2 * s
    dkv = 2 * _CHUNK * d + 2 * _KEYS * (_CHUNK + 1) + 2 * _KEYS * d
    return max(dq, dkv)


def route_of(name: str, dtype: torch.dtype, s: int) -> str:
    """The ``ROUTES`` key of kernel ``name`` for rows of ``dtype`` and S."""
    return "mma" if dtype == torch.bfloat16 and s <= _TC_MAX_S[name] else "fma"


def _check_route(name: str, dtype: torch.dtype, s: int, d: int) -> None:
    """Raise if no route takes an (S, D) row of ``dtype``."""
    if dtype == torch.bfloat16 and d != _TC_D:
        raise ValueError(f"{name}: bf16 rows take D = {_TC_D} (the tensor-core route takes "
                         f"D = {_TC_D}), got D = {d}")
    if route_of(name, dtype, s) == "fma" and _fma_words(name, s, d) > _SMEM_WORDS:
        raise ValueError(f"{name}: S={s}, D={d}: one query's score row needs more shared memory "
                         f"than one block has")


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
    None, all contiguous, and the shape within its route's limits."""
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
    _check_route(name, q.dtype, s, d)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, *others)):
        raise ValueError(f"{name}: the bf16 route copies rows in 16-byte pieces; "
                         f"q, k, v and do must start on a 16-byte boundary")
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


def _bwd_scratch(q):
    """The backward's scratch for (N, S, D) rows q, as (p, ds, stats):
    the tensor-core route keeps only the row statistics (max, sum,
    rowsum(dp p)) as one (3, N, S) fp32 tensor; the CUDA-core route moves
    T(p) and ds through two (N, S, S) tensors in q's dtype."""
    n, s, _ = q.shape
    if route_of("attend_bwd", q.dtype, s) == "mma":
        return None, None, torch.empty((3, n, s), dtype=torch.float32, device=q.device)
    p = torch.empty((n, s, s), dtype=q.dtype, device=q.device)
    return p, torch.empty_like(p), None


def attend_bwd(q, k, v, mask, do):
    """Fused attention backward on (N, S, D) rows -> (dq, dk, dv)."""
    if q.device.type == "cpu":
        return attend_bwd_plain(q, k, v, mask, do)
    do = do.to(q.dtype).contiguous()
    n, s, d = _rows("attend_bwd", q, (k, v, do), mask)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    p, ds, stats = _bwd_scratch(q)  # named locals: they must outlive the launch
    _build.call("attend_bwd", _DTYPE_CODE[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(mask),
                _ptr(do), _ptr(p), _ptr(ds), _ptr(stats), _ptr(dq), _ptr(dk), _ptr(dv), n, s,
                d, _stream())
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


# ``TPU.USE_PALLAS`` values the reference reads as 'on' and as 'off':
# yaml.safe_load turns an unquoted on/off into True/False, and 1 == True,
# 0 == False (mvlpt_tpu/ops/attention.py:select_attn_fn).
_AS_ON = (True, "1")
_AS_OFF = (False, "0", None)


def select_attn_fn(use_pallas="auto", inference: bool = False, mesh=None):
    """Resolve ``TPU.USE_PALLAS`` for the port, the counterpart of
    ``mvlpt_tpu/ops/attention.py:select_attn_fn``. Returns what
    ``core.layers`` takes as ``kernels``:

      * "block", "auto": ``BlockKernels(inference=..., mesh=mesh)``, the
        fused half-block kernels on both towers (the JAX "auto" downgrade
        of the text tower is a TPU measurement and does not carry over);
        ``inference=True`` selects their no-grad forwards. Under a
        ``mesh`` (``parallel.Mesh``) with a model axis they run as the
        tensor-parallel kernels. The JAX "auto" keeps the XLA path on a
        tensor-parallel mesh because of a TPU measurement; no TPU
        selection carries over, so here "auto" is "block" there too;
      * "on": ``fused_attention``, the standalone fused attention (one
        forward for training and eval);
      * "off": None, the plain layer path (torch autograd).

    As on the JAX side, True, 1 and "1" select "on", and False, 0, "0" and
    None select "off". Any other value raises, where the JAX side falls
    back to the plain path: a mistyped selection fails loudly here.

    "on" and "off" take a mesh without a model axis only: on the JAX side
    they reach a tensor-parallel mesh through GSPMD's sharding of the
    plain layers, which the port does not have, and the port's sharded
    weights would give wrong results on them. On a card the kernels run,
    on the CPU their plain twins."""
    if use_pallas in ("block", "auto"):
        return BlockKernels(inference=inference, mesh=mesh)
    if use_pallas in _AS_ON:
        use_pallas = "on"
    elif use_pallas in _AS_OFF:
        use_pallas = "off"
    if use_pallas not in ("on", "off"):
        raise ValueError(f"unknown kernel selection {use_pallas!r}")
    if mesh is not None and mesh.n_model > 1:
        raise ValueError(f"kernel selection {use_pallas!r} does not run on a mesh with a model "
                         f"axis ({mesh.n_model} ranks) yet; select 'block' or 'auto'")
    return fused_attention if use_pallas == "on" else None
