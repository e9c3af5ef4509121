"""Fused transformer half-block kernels and their plain twins.

The counterpart of ``mvlpt_tpu/ops/block.py``. Each half-block of a
pre-LN residual block is one kernel call:

  * ``attn_fwd``: y = x + OutProj(MHA(LN1 x)) + b, keeping qkv, the
    compute-dtype probabilities and the LN mu/rstd for the backward;
  * ``attn_bwd``: dx only (the backbone is frozen);
  * ``mlp_fwd``: y = x + Proj(QuickGELU(FC(LN2 x))) + b, keeping the
    rounded pre-activation hpre and mu/rstd;
  * ``mlp_bwd``: dx only.

Under a tensor-parallel mesh (``fused_residual_block_sharded``) each
model rank runs the ``*_part`` kernels on its Megatron shard of the
weights (H/tp heads, 4W/tp hidden units; ``parallel.shard_blocks``):
``attn_fwd_part``/``mlp_fwd_part`` emit the fp32 partial projection
without bias or residual, ``attn_bwd_part``/``mlp_bwd_part`` the fp32
partial dxh without the LayerNorm backward. An all-reduce over the
model group sums the partials; the bias and residual, or the LayerNorm
backward (``_ln_bwd``), follow in plain PyTorch, as the JAX package
finishes its ``part=True`` kernels in plain XLA.

Each wrapper runs its hand-written CUDA kernel (``mvlpt_torch/csrc``)
for a CUDA tensor, or raises; it runs the plain PyTorch twin beside it
only for a CPU tensor. The twins state the kernels' math with the same
rounding points as the Pallas bodies: LN statistics and softmax in
fp32, fp32 accumulation, activations rounded to the compute dtype at
the same places. ``save_residuals=False`` is the no-grad forward (the
eval kernels ``attn_block_infer``/``mlp_block_infer``): same values,
the backward's residuals are not written.

Layouts are the port's own: qkv is (B, S, 3W) with q | k | v column
blocks and head h at [h*D, (h+1)*D); probabilities are (B, H, S, S);
mu/rstd are (B, S) fp32. Weights keep the JAX schema, (in, out).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from mvlpt_torch.ops import _build
from mvlpt_torch.utils import profiler

_EPS = 1e-5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The routes of the MLP half-blocks' two products (mlp_fwd, mlp_fwd_part;
# mlp_bwd, mlp_bwd_part, whose products read the weights transposed), by
# dtype: bf16 on the tensor cores (csrc/wgmma.cuh), fp32 on the CUDA cores
# (csrc/common.cuh).
MLP_ROUTES = {torch.bfloat16: "tensor cores (wgmma + TMA, bf16)",
              torch.float32: "CUDA cores (fp32 FMA)"}
# The routes of the attention half-block forwards (attn_fwd, its no-grad
# form, attn_fwd_part), by dtype: in bf16 the qkv and out-projection
# products on csrc/wgmma.cuh's GEMM and the attention core on mma.sync
# (csrc/attn_fwd.cu: attn_core_res up to RESIDENT_KEYS keys, attn_core_tc
# past them); in fp32 csrc/common.cuh's GEMM and csrc/fma_attn.cuh's core.
ATTN_FWD_ROUTES = {torch.bfloat16: "tensor cores (wgmma + TMA products, mma.sync core, bf16)",
                   torch.float32: "CUDA cores (fp32 FMA)"}
# The routes of the attention half-block backwards (attn_bwd,
# attn_bwd_part), by dtype: in bf16 the do and dxh products on
# csrc/wgmma.cuh's GEMM (the weights read K-major) and the core on
# mma.sync, reading the forward's probabilities, with a (B, H, S) fp32
# scratch (csrc/attn_bwd.cu, attn_bwd_dq_tc / attn_bwd_dkv_tc); in fp32
# csrc/common.cuh's GEMM and a CUDA-core core with a (B, H, S, S) scratch.
ATTN_BWD_ROUTES = {torch.bfloat16: "tensor cores (wgmma + TMA products, mma.sync core reading "
                                   "the probabilities, bf16)",
                   torch.float32: "CUDA cores (fp32 FMA)"}
# The bf16 route's TMA tiles: K and N in slabs of 64 values.
_WG_MULTIPLE = 64
# The head width of the bf16 attention core's fragments.
_TC_HEAD = 64
# The bf16 attention core's route by the row's keys (csrc/attn_fwd.cu's
# launch_core, whose res::MAX_KEYS is the same number): up to this many
# the one-pass core over a row held whole on the chip, past it the
# two-pass core over windows of keys. _count_core counts each launch's.
RESIDENT_KEYS = 256
# bf16 at the shapes the tensor cores' routes above do not take (W, Wl or
# 4W off the multiples of 64, a head width other than 64) runs on the CUDA
# cores as fp32 does: the same GEMM and attention cores on bf16 operands,
# every sum in fp32, the same rounding points (the twins'). Its C dtype code.
BF16_CUDA_CORES = "CUDA cores (fp32 FMA on bf16 operands)"
_BF16_CUDA_CORES_CODE = 2


@dataclasses.dataclass(frozen=True)
class BlockKernels:
    """Selects the fused half-block kernels for ``core.layers.residual_block``
    (``ops.attention.select_attn_fn``). ``inference=True`` selects the
    no-grad forward (no residuals kept). ``mesh`` (a ``parallel.Mesh``)
    runs the blocks under that mesh: with a model axis, through the
    tensor-parallel kernels (``fused_residual_block_sharded``)."""

    inference: bool = False
    mesh: object = None


# ------------------------------------------------------------ plain twins
#
# Every twin takes ``acc``, the dtype its sums and elementwise math run in
# (products, LayerNorm mean and variance, softmax, the backward's row
# sums, QuickGELU and its derivative, the residual adds). The default,
# fp32, is the twin each kernel is held to. ``acc=torch.float64`` is the
# fp64-summed twin: the same function at the same rounding points to the
# compute dtype, with every sum in fp64, so it tells how far the fp32
# twin's own sums sit from exact ones (chip_smoke.py's bf16 criterion).
# Its fp32 outputs (mu, rstd, the parts' partials) stay in fp64.

_F32 = torch.float32


def _ln2d(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (x - mu) * rstd * scale + bias, mu, rstd


def _ln_in_cot(x, mu, rstd, scale, dxh):
    """LayerNorm input cotangent with frozen scale/bias, in the inputs' dtype."""
    xn = (x - mu) * rstd
    g = dxh * scale
    m1 = g.mean(-1, keepdim=True)
    m2 = (g * xn).mean(-1, keepdim=True)
    return rstd * (g - m1 - xn * m2)


def _mm(a, b, acc=_F32):
    """``acc``-accumulated product of (possibly bf16) operands."""
    return torch.matmul(a.to(acc), b.to(acc))


def _add(x, h, acc=_F32):
    """T(x + h), the sum in ``acc``: a residual add."""
    return (x.to(acc) + h.to(acc)).to(x.dtype)


def _affine_plain(a, w, bias, acc=_F32):
    """T(a w + bias) in a's dtype: the qkv, FC and output products."""
    return (_mm(a, w, acc) + bias.to(acc)).to(a.dtype)


def _mha_plain(qkv, mask, n_heads, acc=_F32):
    """Multi-head attention over qkv (B, S, 3Wl) with ``n_heads`` heads ->
    (o (B, S, Wl), probs (B, H, S, S)), both in qkv's dtype: q scaled and
    rounded before the product, p rounded before p v."""
    b, s, wl3 = qkv.shape
    wl = wl3 // 3
    d = wl // n_heads
    dtype, scale = qkv.dtype, d ** -0.5
    q, k, v = qkv.view(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)
    qs = (q.to(acc) * scale).to(dtype)
    logits = _mm(qs, k.transpose(-1, -2), acc)
    if mask is not None:
        logits = logits + mask.to(acc)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return _mm(probs, v, acc).to(dtype).transpose(1, 2).reshape(b, s, wl), probs


def _attn_core_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, mask, n_heads, eps, acc=_F32):
    """LN -> qkv -> MHA over the heads of ``qkv_w`` (W, 3Wl): -> (o (B, S,
    Wl), qkv, probs, mu, rstd)."""
    xh, mu, rstd = _ln2d(x.to(acc), ln_scale.to(acc), ln_bias.to(acc), eps)
    qkv = _affine_plain(xh.to(x.dtype), qkv_w, qkv_b, acc)
    o, probs = _mha_plain(qkv, mask, n_heads, acc)
    return o, qkv, probs, mu[..., 0], rstd[..., 0]


def attn_fwd_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b, mask,
                   n_heads, eps=_EPS, save_residuals=True, acc=_F32):
    o, qkv, probs, mu, rstd = _attn_core_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, mask,
                                               n_heads, eps, acc)
    y = _add(x, _affine_plain(o, out_w, out_b, acc), acc)
    if not save_residuals:
        return y, None
    return y, (qkv, probs, mu, rstd)


def attn_fwd_part_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, mask, n_heads, eps=_EPS,
                        acc=_F32):
    """The tensor-parallel part over ``n_heads`` local heads: -> (fp32
    partial out-projection (B, S, W), (qkv, probs, mu, rstd))."""
    o, *res = _attn_core_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, mask, n_heads, eps, acc)
    return _mm(o, out_w, acc), tuple(res)


def _ln_bwd(x, mu, rstd, ln_scale, dxh32, gy, acc=_F32):
    """LayerNorm input cotangent (frozen scale/bias) of the fp32 ``dxh32``
    plus the residual: gy + T(...). The tail of every half-block
    backward; the tensor-parallel backward runs it after the all-reduce,
    as the JAX package's ``_ln_bwd``."""
    dx = _ln_in_cot(x.to(acc), mu[..., None].to(acc), rstd[..., None].to(acc),
                    ln_scale.to(acc), dxh32.to(acc))
    return _add(gy, dx.to(x.dtype), acc)


def _attn_dqkv_plain(qkv, probs, out_w, gy, n_heads, acc=_F32):
    """[dq | dk | dv] (B, S, 3Wl) in qkv's dtype over the heads of ``qkv``:
    the attention backward up to its dxh product."""
    b, s, wl3 = qkv.shape
    wl = wl3 // 3
    d = wl // n_heads
    dtype, scale = qkv.dtype, d ** -0.5
    gy = gy.to(dtype)
    do = _mm(gy, out_w.t(), acc).to(dtype).view(b, s, n_heads, d).transpose(1, 2)
    q, k, v = qkv.view(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)
    p = probs.to(acc)
    dv = _mm(p.transpose(-1, -2), do, acc).to(dtype)
    dp = _mm(do, v.transpose(-1, -2), acc)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dtype)
    dq = _mm(ds, k, acc).to(dtype)
    dk = _mm(ds.transpose(-1, -2), q, acc).to(dtype)
    return torch.stack([dq, dk, dv], 0).permute(1, 3, 0, 2, 4).reshape(b, s, wl3)


def attn_bwd_part_plain(qkv, probs, qkv_w, out_w, gy, n_heads, acc=_F32):
    """fp32 dxh over the heads of ``qkv`` (B, S, 3Wl), without the
    LayerNorm backward (the tensor-parallel part)."""
    return _mm(_attn_dqkv_plain(qkv, probs, out_w, gy, n_heads, acc), qkv_w.t(), acc)


def attn_bwd_plain(x, mu, rstd, qkv, probs, ln_scale, qkv_w, out_w, gy, n_heads, acc=_F32):
    gy = gy.to(x.dtype)
    return _ln_bwd(x, mu, rstd, ln_scale,
                   attn_bwd_part_plain(qkv, probs, qkv_w, out_w, gy, n_heads, acc), gy, acc)


def _mlp_hidden_plain(x, ln_scale, ln_bias, fc_w, fc_b, eps, acc=_F32):
    """LN -> FC -> QuickGELU: -> (act, hpre, mu, rstd)."""
    dtype = x.dtype
    xh, mu, rstd = _ln2d(x.to(acc), ln_scale.to(acc), ln_bias.to(acc), eps)
    hpre = _affine_plain(xh.to(dtype), fc_w, fc_b, acc)
    # QuickGELU on the rounded pre-activation, as the backward's
    # derivative is taken at the saved (rounded) hpre.
    h = hpre.to(acc)
    act = (h * torch.sigmoid(1.702 * h)).to(dtype)
    return act, hpre, mu[..., 0], rstd[..., 0]


def mlp_fwd_plain(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b, eps=_EPS,
                  save_residuals=True, acc=_F32):
    act, *res = _mlp_hidden_plain(x, ln_scale, ln_bias, fc_w, fc_b, eps, acc)
    y = _add(x, _affine_plain(act, proj_w, proj_b, acc), acc)
    if not save_residuals:
        return y, None
    return y, tuple(res)


def mlp_fwd_part_plain(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, eps=_EPS, acc=_F32):
    """The tensor-parallel part over the hidden units of ``fc_w``: ->
    (fp32 partial projection (B, S, W), (hpre, mu, rstd))."""
    act, *res = _mlp_hidden_plain(x, ln_scale, ln_bias, fc_w, fc_b, eps, acc)
    return _mm(act, proj_w, acc), tuple(res)


def _gelu_bwd_plain(da, hpre, acc=_F32):
    """dh = T(da QuickGELU'(hpre)) in hpre's dtype, the derivative at the
    saved, rounded hpre: the epilogue of the backward's first product."""
    h = hpre.to(acc)
    sig = torch.sigmoid(1.702 * h)
    return (da.to(acc) * (sig + 1.702 * h * sig * (1.0 - sig))).to(hpre.dtype)


def mlp_bwd_part_plain(hpre, fc_w, proj_w, gy, acc=_F32):
    """fp32 dxh over the hidden units of ``hpre``, without the LayerNorm
    backward (the tensor-parallel part)."""
    dh = _gelu_bwd_plain(_mm(gy.to(hpre.dtype), proj_w.t(), acc), hpre, acc)
    return _mm(dh, fc_w.t(), acc)


def mlp_bwd_plain(x, mu, rstd, hpre, ln_scale, fc_w, proj_w, gy, acc=_F32):
    gy = gy.to(x.dtype)
    return _ln_bwd(x, mu, rstd, ln_scale, mlp_bwd_part_plain(hpre, fc_w, proj_w, gy, acc), gy,
                   acc)


# --------------------------------------------------------------- wrappers

def _dims(name, x):
    """(B, S, W) of a CUDA activation the kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, S, W), got {tuple(x.shape)}")
    return x.shape


def _check(name, x, operands, stats=(), mask=None):
    """Each operand must be a contiguous tensor on x's device: ``operands``
    are (tensor, shape) pairs in x's dtype, ``stats`` fp32 (B, S) rows,
    ``mask`` an fp32 (S, S) mask or None."""
    b, s, _ = x.shape
    want = [(x, tuple(x.shape), x.dtype)] + [(t, shape, x.dtype) for t, shape in operands]
    want += [(t, (b, s), torch.float32) for t in stats]
    if mask is not None:
        want.append((mask, (s, s), torch.float32))
    for t, shape, dtype in want:
        if (t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: got a {tuple(t.shape)} {t.dtype} tensor on {t.device}, "
                             f"want a contiguous {shape} {dtype} tensor on {x.device}")


def _local_width(name, qkv_width, n_heads):
    """Wl of a (.., 3Wl) qkv over ``n_heads`` heads."""
    if qkv_width % 3 or (qkv_width // 3) % n_heads:
        raise ValueError(f"{name}: qkv width {qkv_width} does not split into q, k, v of "
                         f"{n_heads} heads")
    return qkv_width // 3


def tensor_core_shapes(x, wl: int, n_heads: int | None = None) -> bool:
    """Whether the tensor cores' route takes a bf16 half-block over x
    (B, S, W) with this rank's width ``wl`` (the attention's Wl, or the
    MLP's hidden width) and, for the attention, its ``n_heads`` heads: W
    and wl in multiples of 64 and a head width of 64."""
    w = x.shape[-1]
    return (x.dtype == torch.bfloat16 and w % _WG_MULTIPLE == 0 and wl % _WG_MULTIPLE == 0
            and (n_heads is None or wl == _TC_HEAD * n_heads))


def _attn_code(name, x, wl, n_heads, operands) -> int:
    """The C entries' dtype code of an attention half-block: fp32 (0); bf16
    on the tensor cores (1, its operands checked by ``_check_attn_route``)
    where ``tensor_core_shapes`` takes it; else bf16 on the CUDA cores."""
    if x.dtype == torch.bfloat16 and not tensor_core_shapes(x, wl, n_heads):
        return _BF16_CUDA_CORES_CODE
    _check_attn_route(name, x, wl, n_heads, operands)
    return _DTYPE_CODE[x.dtype]


def _mlp_code(name, x, w4, operands) -> int:
    """``_attn_code`` for an MLP half-block of hidden width ``w4``."""
    if x.dtype == torch.bfloat16 and not tensor_core_shapes(x, w4):
        return _BF16_CUDA_CORES_CODE
    _check_mlp_route(name, x, w4, operands)
    return _DTYPE_CODE[x.dtype]


def _check_mlp_route(name, x, w4, operands):
    """The bf16 route (MLP_ROUTES) reads its operands by TMA and writes
    16-byte pieces: W and W4 must be multiples of 64 and every base
    16-byte aligned. It raises rather than take another route (the
    wrappers send other widths to BF16_CUDA_CORES before it, so from them
    only a misaligned base raises)."""
    w = x.shape[-1]
    if x.dtype != torch.bfloat16:
        return
    if w % _WG_MULTIPLE or w4 % _WG_MULTIPLE:
        raise ValueError(f"{name}: the bf16 tensor-core route takes W and 4W in multiples of "
                         f"{_WG_MULTIPLE}, got W = {w}, 4W = {w4}")
    if any(t.data_ptr() % 16 for t in (x, *operands)):
        raise ValueError(f"{name}: the bf16 tensor-core route needs 16-byte-aligned tensors")


def _check_attn_route(name, x, wl, n_heads, operands):
    """The bf16 route (ATTN_FWD_ROUTES, ATTN_BWD_ROUTES) reads its
    products' operands by TMA and the core's rows in 16-byte pieces, with
    the core's fragments D = 64 wide:
    the head width must be 64, W and Wl multiples of 64 and every base
    16-byte aligned. It raises rather than take another route (the
    wrappers send other shapes to BF16_CUDA_CORES before it, so from them
    only a misaligned base raises)."""
    if x.dtype != torch.bfloat16:
        return
    w = x.shape[-1]
    if w % _WG_MULTIPLE or wl % _WG_MULTIPLE:
        raise ValueError(f"{name}: the bf16 tensor-core route takes W and Wl in multiples of "
                         f"{_WG_MULTIPLE}, got W = {w}, Wl = {wl}")
    if wl != _TC_HEAD * n_heads:
        raise ValueError(f"{name}: the bf16 tensor-core route takes a head width of "
                         f"{_TC_HEAD}, got D = {wl / n_heads:g}")
    if any(t.data_ptr() % 16 for t in (x, *operands)):
        raise ValueError(f"{name}: the bf16 tensor-core route needs 16-byte-aligned tensors")


def _count_core(code, s):
    """Counts the attention core's route (RESIDENT_KEYS) of a forward
    launched on the bf16 tensor cores' route (dtype code 1)."""
    if code == 1:
        _build.LAUNCHES["attn_core_resident" if s <= RESIDENT_KEYS else "attn_core_windowed"] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _empty(shape, like, dtype=None):
    return torch.empty(shape, dtype=dtype or like.dtype, device=like.device)


def _attn_bwd_scratch(like, b, n_heads, s, code=None):
    """The attention backward core's fp32 scratch on route ``code``
    (``like``'s dtype code by default; ATTN_BWD_ROUTES): t = rowsum(dp p),
    (B, H, S), on the tensor cores; ds, (B, H, S, S), on the CUDA cores."""
    if (_DTYPE_CODE[like.dtype] if code is None else code) == 1:
        return _empty((b, n_heads, s), like, torch.float32)
    return _empty((b, n_heads, s, s), like, torch.float32)


def attn_fwd(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b, mask, n_heads,
             eps=_EPS, save_residuals=True):
    """Attention half-block forward -> (y, (qkv, probs, mu, rstd) or None).
    On the card it takes the dtype's route in ``ATTN_FWD_ROUTES``: bf16 on
    the tensor cores (D = 64), fp32 on the CUDA cores; bf16 off the tensor
    cores' shapes on the CUDA cores (``BF16_CUDA_CORES``)."""
    with profiler.span("block.attn_fwd" if save_residuals else "block.attn_infer", kernel=True):
        if x.device.type == "cpu":
            return attn_fwd_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b,
                                  mask, n_heads, eps, save_residuals)
        b, s, w = _dims("attn_fwd", x)
        if w % n_heads:
            raise ValueError(f"attn_fwd: width {w} does not split into {n_heads} heads")
        _check("attn_fwd", x, [(ln_scale, (w,)), (ln_bias, (w,)), (qkv_w, (w, 3 * w)),
                               (qkv_b, (3 * w,)), (out_w, (w, w)), (out_b, (w,))], mask=mask)
        code = _attn_code("attn_fwd", x, w, n_heads,
                          (ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b))
        f32 = torch.float32
        qkv = _empty((b, s, 3 * w), x)
        probs = _empty((b, n_heads, s, s), x) if save_residuals else None
        mu = _empty((b, s), x, f32) if save_residuals else None
        rstd = _empty((b, s), x, f32) if save_residuals else None
        y = torch.empty_like(x)
        xh, o = _empty((b, s, w), x), _empty((b, s, w), x)  # scratch
        _build.call("attn_fwd", code, _ptr(x), _ptr(ln_scale), _ptr(ln_bias),
                    _ptr(qkv_w), _ptr(qkv_b), _ptr(out_w), _ptr(out_b), _ptr(mask),
                    _ptr(xh), _ptr(qkv), _ptr(o), _ptr(probs), _ptr(mu), _ptr(rstd), _ptr(y),
                    b, s, w, n_heads, eps, *profiler.core_marks_args("core.attn_fwd"), _stream())
        _build.LAUNCHES["attn_fwd" if save_residuals else "attn_fwd_infer"] += 1
        _count_core(code, s)
        return y, ((qkv, probs, mu, rstd) if save_residuals else None)


def attn_bwd(x, mu, rstd, qkv, probs, ln_scale, qkv_w, out_w, gy, n_heads):
    """Attention half-block backward -> dx. On the card it takes the
    dtype's route in ``ATTN_BWD_ROUTES``: bf16 on the tensor cores
    (D = 64), fp32 on the CUDA cores; bf16 off the tensor cores' shapes
    on the CUDA cores (``BF16_CUDA_CORES``)."""
    with profiler.span("block.attn_bwd", kernel=True):
        if x.device.type == "cpu":
            return attn_bwd_plain(x, mu, rstd, qkv, probs, ln_scale, qkv_w, out_w, gy, n_heads)
        b, s, w = _dims("attn_bwd", x)
        gy = gy.to(x.dtype).contiguous()
        _check("attn_bwd", x, [(qkv, (b, s, 3 * w)), (probs, (b, n_heads, s, s)),
                               (ln_scale, (w,)), (qkv_w, (w, 3 * w)), (out_w, (w, w)),
                               (gy, (b, s, w))], stats=(mu, rstd))
        code = _attn_code("attn_bwd", x, w, n_heads, (qkv, probs, ln_scale, qkv_w, out_w, gy))
        dx = torch.empty_like(x)
        # scratch: do, dqkv, fp32 dxh, the core's
        dout, dqkv = _empty((b, s, w), x), _empty((b, s, 3 * w), x)
        dxh, core = _empty((b, s, w), x, torch.float32), _attn_bwd_scratch(x, b, n_heads, s, code)
        _build.call("attn_bwd", code, _ptr(x), _ptr(mu), _ptr(rstd), _ptr(qkv),
                    _ptr(probs), _ptr(ln_scale), _ptr(qkv_w), _ptr(out_w), _ptr(gy),
                    _ptr(dout), _ptr(core), _ptr(dqkv), _ptr(dxh), _ptr(dx), b, s, w, n_heads,
                    *profiler.core_marks_args("core.attn_bwd"), _stream())
        _build.LAUNCHES["attn_bwd"] += 1
        return dx


def mlp_fwd(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b, eps=_EPS,
            save_residuals=True):
    """MLP half-block forward -> (y, (hpre, mu, rstd) or None). On the
    card its two products take the dtype's route in ``MLP_ROUTES``: bf16
    on the tensor cores (wgmma fed by TMA), fp32 on the CUDA cores; bf16
    off the tensor cores' widths on the CUDA cores (``BF16_CUDA_CORES``)."""
    with profiler.span("block.mlp_fwd" if save_residuals else "block.mlp_infer", kernel=True):
        if x.device.type == "cpu":
            return mlp_fwd_plain(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b, eps,
                                 save_residuals)
        b, s, w = _dims("mlp_fwd", x)
        w4 = fc_b.shape[0]
        _check("mlp_fwd", x, [(ln_scale, (w,)), (ln_bias, (w,)), (fc_w, (w, w4)), (fc_b, (w4,)),
                              (proj_w, (w4, w)), (proj_b, (w,))])
        code = _mlp_code("mlp_fwd", x, w4, (fc_w, fc_b, proj_w, proj_b))
        f32 = torch.float32
        hpre = _empty((b, s, w4), x) if save_residuals else None
        mu = _empty((b, s), x, f32) if save_residuals else None
        rstd = _empty((b, s), x, f32) if save_residuals else None
        y = torch.empty_like(x)
        xh, act = _empty((b, s, w), x), _empty((b, s, w4), x)  # scratch
        _build.call("mlp_fwd", code, _ptr(x), _ptr(ln_scale), _ptr(ln_bias),
                    _ptr(fc_w), _ptr(fc_b), _ptr(proj_w), _ptr(proj_b), _ptr(xh), _ptr(hpre),
                    _ptr(act), _ptr(mu), _ptr(rstd), _ptr(y), b * s, w, w4, eps, _stream())
        _build.LAUNCHES["mlp_fwd" if save_residuals else "mlp_fwd_infer"] += 1
        return y, ((hpre, mu, rstd) if save_residuals else None)


def mlp_bwd(x, mu, rstd, hpre, ln_scale, fc_w, proj_w, gy):
    """MLP half-block backward -> dx; its two products route as
    ``mlp_fwd``'s (``MLP_ROUTES``)."""
    with profiler.span("block.mlp_bwd", kernel=True):
        if x.device.type == "cpu":
            return mlp_bwd_plain(x, mu, rstd, hpre, ln_scale, fc_w, proj_w, gy)
        b, s, w = _dims("mlp_bwd", x)
        w4 = hpre.shape[-1]
        gy = gy.to(x.dtype).contiguous()
        _check("mlp_bwd", x, [(hpre, (b, s, w4)), (ln_scale, (w,)), (fc_w, (w, w4)),
                              (proj_w, (w4, w)), (gy, (b, s, w))], stats=(mu, rstd))
        code = _mlp_code("mlp_bwd", x, w4, (hpre, ln_scale, fc_w, proj_w, gy))
        dx = torch.empty_like(x)
        dh, dxh = _empty((b, s, w4), x), _empty((b, s, w), x, torch.float32)  # scratch
        _build.call("mlp_bwd", code, _ptr(x), _ptr(mu), _ptr(rstd), _ptr(hpre),
                    _ptr(ln_scale), _ptr(fc_w), _ptr(proj_w), _ptr(gy), _ptr(dh), _ptr(dxh),
                    _ptr(dx), b * s, w, w4, _stream())
        _build.LAUNCHES["mlp_bwd"] += 1
        return dx


def attn_fwd_part(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, mask, n_heads, eps=_EPS):
    """Tensor-parallel attention part over ``n_heads`` local heads (qkv_w
    (W, 3Wl), qkv_b (3Wl), out_w (Wl, W)) -> (fp32 partial (B, S, W),
    (qkv, probs, mu, rstd)); routes as ``attn_fwd``."""
    with profiler.span("block.attn_fwd", kernel=True):
        if x.device.type == "cpu":
            return attn_fwd_part_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, mask, n_heads,
                                       eps)
        b, s, w = _dims("attn_fwd_part", x)
        wl = _local_width("attn_fwd_part", qkv_w.shape[-1], n_heads)
        _check("attn_fwd_part", x, [(ln_scale, (w,)), (ln_bias, (w,)), (qkv_w, (w, 3 * wl)),
                                    (qkv_b, (3 * wl,)), (out_w, (wl, w))], mask=mask)
        code = _attn_code("attn_fwd_part", x, wl, n_heads,
                          (ln_scale, ln_bias, qkv_w, qkv_b, out_w))
        f32 = torch.float32
        ypart = _empty((b, s, w), x, f32)
        qkv, probs = _empty((b, s, 3 * wl), x), _empty((b, n_heads, s, s), x)
        mu, rstd = _empty((b, s), x, f32), _empty((b, s), x, f32)
        xh, o = _empty((b, s, w), x), _empty((b, s, wl), x)  # scratch
        _build.call("attn_fwd_part", code, _ptr(x), _ptr(ln_scale), _ptr(ln_bias),
                    _ptr(qkv_w), _ptr(qkv_b), _ptr(out_w), _ptr(mask), _ptr(xh), _ptr(qkv),
                    _ptr(o), _ptr(probs), _ptr(mu), _ptr(rstd), _ptr(ypart), b, s, w, n_heads,
                    wl // n_heads, eps, *profiler.core_marks_args("core.attn_fwd"), _stream())
        _build.LAUNCHES["attn_fwd_tp"] += 1
        _count_core(code, s)
        return ypart, (qkv, probs, mu, rstd)


def attn_bwd_part(qkv, probs, qkv_w, out_w, gy, n_heads):
    """Tensor-parallel attention backward part -> fp32 partial dxh (B, S,
    W); routes as ``attn_bwd``."""
    with profiler.span("block.attn_bwd", kernel=True):
        if qkv.device.type == "cpu":
            return attn_bwd_part_plain(qkv, probs, qkv_w, out_w, gy, n_heads)
        gy = gy.to(qkv.dtype).contiguous()
        b, s, w = _dims("attn_bwd_part", gy)
        wl = _local_width("attn_bwd_part", qkv.shape[-1], n_heads)
        _check("attn_bwd_part", gy, [(qkv, (b, s, 3 * wl)), (probs, (b, n_heads, s, s)),
                                     (qkv_w, (w, 3 * wl)), (out_w, (wl, w))])
        code = _attn_code("attn_bwd_part", gy, wl, n_heads, (qkv, probs, qkv_w, out_w))
        dxh = _empty((b, s, w), gy, torch.float32)
        # scratch: do, dqkv, the core's
        dout, dqkv = _empty((b, s, wl), gy), _empty((b, s, 3 * wl), gy)
        core = _attn_bwd_scratch(gy, b, n_heads, s, code)
        _build.call("attn_bwd_part", code, _ptr(qkv), _ptr(probs), _ptr(qkv_w),
                    _ptr(out_w), _ptr(gy), _ptr(dout), _ptr(core), _ptr(dqkv), _ptr(dxh), b, s, w,
                    n_heads, wl // n_heads, *profiler.core_marks_args("core.attn_bwd"), _stream())
        _build.LAUNCHES["attn_bwd_tp"] += 1
        return dxh


def mlp_fwd_part(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, eps=_EPS):
    """Tensor-parallel MLP part over the hidden units of fc_w (W, W4) ->
    (fp32 partial (B, S, W), (hpre, mu, rstd)); routes as ``mlp_fwd``."""
    with profiler.span("block.mlp_fwd", kernel=True):
        if x.device.type == "cpu":
            return mlp_fwd_part_plain(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, eps)
        b, s, w = _dims("mlp_fwd_part", x)
        w4 = fc_b.shape[0]
        _check("mlp_fwd_part", x, [(ln_scale, (w,)), (ln_bias, (w,)), (fc_w, (w, w4)),
                                   (fc_b, (w4,)), (proj_w, (w4, w))])
        code = _mlp_code("mlp_fwd_part", x, w4, (fc_w, fc_b, proj_w))
        f32 = torch.float32
        ypart, hpre = _empty((b, s, w), x, f32), _empty((b, s, w4), x)
        mu, rstd = _empty((b, s), x, f32), _empty((b, s), x, f32)
        xh, act = _empty((b, s, w), x), _empty((b, s, w4), x)  # scratch
        _build.call("mlp_fwd_part", code, _ptr(x), _ptr(ln_scale), _ptr(ln_bias),
                    _ptr(fc_w), _ptr(fc_b), _ptr(proj_w), _ptr(xh), _ptr(hpre), _ptr(act),
                    _ptr(mu), _ptr(rstd), _ptr(ypart), b * s, w, w4, eps, _stream())
        _build.LAUNCHES["mlp_fwd_tp"] += 1
        return ypart, (hpre, mu, rstd)


def mlp_bwd_part(hpre, fc_w, proj_w, gy):
    """Tensor-parallel MLP backward part -> fp32 partial dxh (B, S, W);
    routes as ``mlp_bwd``."""
    with profiler.span("block.mlp_bwd", kernel=True):
        if hpre.device.type == "cpu":
            return mlp_bwd_part_plain(hpre, fc_w, proj_w, gy)
        gy = gy.to(hpre.dtype).contiguous()
        b, s, w = _dims("mlp_bwd_part", gy)
        w4 = hpre.shape[-1]
        _check("mlp_bwd_part", gy, [(hpre, (b, s, w4)), (fc_w, (w, w4)), (proj_w, (w4, w))])
        code = _mlp_code("mlp_bwd_part", gy, w4, (hpre, fc_w, proj_w))
        dxh = _empty((b, s, w), gy, torch.float32)
        dh = _empty((b, s, w4), gy)  # scratch
        _build.call("mlp_bwd_part", code, _ptr(hpre), _ptr(fc_w), _ptr(proj_w),
                    _ptr(gy), _ptr(dh), _ptr(dxh), b * s, w, w4, _stream())
        _build.LAUNCHES["mlp_bwd_tp"] += 1
        return dxh


# ------------------------------------------------------- autograd glue

def _no_grad_error(kind):
    return NotImplementedError(
        f"{kind} is a no-grad eval kernel (no backward residuals are kept); "
        "differentiate the training kernel instead (BlockKernels(inference=False)).")


class _AttnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b, mask, n_heads,
                eps, inference):
        y, res = attn_fwd(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b, mask, n_heads,
                          eps, save_residuals=not inference)
        ctx.n_heads, ctx.inference = n_heads, inference
        if not inference:
            ctx.save_for_backward(x, ln_scale, qkv_w, out_w, *res)
        return y

    @staticmethod
    def backward(ctx, gy):
        if ctx.inference:
            raise _no_grad_error("attn_block_infer")
        x, ln_scale, qkv_w, out_w, qkv, probs, mu, rstd = ctx.saved_tensors
        dx = attn_bwd(x, mu, rstd, qkv, probs, ln_scale, qkv_w, out_w, gy, ctx.n_heads)
        # Frozen backbone: no weight cotangents.
        return (dx,) + (None,) * 10


class _MlpBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b, eps, inference):
        y, res = mlp_fwd(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b, eps,
                         save_residuals=not inference)
        ctx.inference = inference
        if not inference:
            ctx.save_for_backward(x, ln_scale, fc_w, proj_w, *res)
        return y

    @staticmethod
    def backward(ctx, gy):
        if ctx.inference:
            raise _no_grad_error("mlp_block_infer")
        x, ln_scale, fc_w, proj_w, hpre, mu, rstd = ctx.saved_tensors
        return (mlp_bwd(x, mu, rstd, hpre, ln_scale, fc_w, proj_w, gy),) + (None,) * 8


def attn_block(x, ln_p, attn_p, mask, n_heads, eps=_EPS, inference=False):
    """y = x + OutProj(MHA(LN(x))); mask is additive fp32 (S, S) or None."""
    return _AttnBlock.apply(x, ln_p["scale"], ln_p["bias"], attn_p["qkv_w"],
                            attn_p["qkv_b"], attn_p["out_w"], attn_p["out_b"], mask,
                            n_heads, eps, inference)


def mlp_block(x, ln_p, mlp_p, eps=_EPS, inference=False):
    """y = x + Proj(QuickGELU(FC(LN(x))))."""
    return _MlpBlock.apply(x, ln_p["scale"], ln_p["bias"], mlp_p["fc_w"], mlp_p["fc_b"],
                           mlp_p["proj_w"], mlp_p["proj_b"], eps, inference)


def fused_residual_block(x, p, n_heads, mask=None, inference=False):
    """Drop-in ``residual_block`` through the two half-block kernels.
    ``inference=True`` runs the no-grad forwards; differentiating
    through them raises ``NotImplementedError``."""
    x = attn_block(x, p["ln_1"], p["attn"], mask, n_heads, inference=inference)
    return mlp_block(x, p["ln_2"], p["mlp"], inference=inference)


# ------------------------------------------------- tensor-parallel blocks
#
# Megatron sharding of the fused half-blocks (mvlpt_tpu/ops/block.py:
# attn_block_tp / mlp_block_tp). Every model rank runs the part kernel
# on its shard, an all-reduce over the model group sums the fp32
# partials, and the bias, rounding and residual follow. The backward
# runs the part backward, all-reduces the fp32 dxh and finishes with the
# LayerNorm backward, which needs the full sum. Only dx comes back. Both
# ranks build the same autograd graph, so they make the backward's
# all-reduces in the same order.


class _AttnBlockTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b, mask, n_heads, group):
        ypart, res = attn_fwd_part(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, mask, n_heads)
        dist.all_reduce(ypart, group=group)
        ctx.n_heads, ctx.group = n_heads, group
        ctx.save_for_backward(x, ln_scale, qkv_w, out_w, *res)
        return x + (ypart + out_b.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, ln_scale, qkv_w, out_w, qkv, probs, mu, rstd = ctx.saved_tensors
        gy = gy.to(x.dtype)
        dxh = attn_bwd_part(qkv, probs, qkv_w, out_w, gy, ctx.n_heads)
        dist.all_reduce(dxh, group=ctx.group)
        return (_ln_bwd(x, mu, rstd, ln_scale, dxh, gy),) + (None,) * 9


class _MlpBlockTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b, group):
        ypart, res = mlp_fwd_part(x, ln_scale, ln_bias, fc_w, fc_b, proj_w)
        dist.all_reduce(ypart, group=group)
        ctx.group = group
        ctx.save_for_backward(x, ln_scale, fc_w, proj_w, *res)
        return x + (ypart + proj_b.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, ln_scale, fc_w, proj_w, hpre, mu, rstd = ctx.saved_tensors
        gy = gy.to(x.dtype)
        dxh = mlp_bwd_part(hpre, fc_w, proj_w, gy)
        dist.all_reduce(dxh, group=ctx.group)
        return (_ln_bwd(x, mu, rstd, ln_scale, dxh, gy),) + (None,) * 7


def fused_residual_block_sharded(x, p, n_heads, mask, mesh):
    """The fused block under a mesh with a model axis, chosen by the
    weights' shapes: a shard (``parallel.shard_blocks``) runs the
    tensor-parallel kernels, with ``n_heads`` the tower's full head
    count; full weights, which a tower whose heads or hidden units do
    not divide by the model axis keeps, run the whole fused block on
    every model rank, with the same x and the same result on each and no
    collective. The tensor-parallel kernels have no no-grad forward:
    they run their training forwards at eval too, as on the JAX side."""
    tp, w = mesh.n_model, x.shape[-1]
    at, ml = p["attn"], p["mlp"]
    if at["qkv_w"].shape[-1] == 3 * w:
        return fused_residual_block(x, p, n_heads, mask)
    if at["qkv_w"].shape[-1] * tp != 3 * w or n_heads % tp:
        raise ValueError(f"fused_residual_block_sharded: qkv_w {tuple(at['qkv_w'].shape)} is "
                         f"not a {tp}-way shard of a {n_heads}-head tower of width {w}")
    x = _AttnBlockTP.apply(x, p["ln_1"]["scale"], p["ln_1"]["bias"], at["qkv_w"], at["qkv_b"],
                           at["out_w"], at["out_b"], mask, n_heads // tp, mesh.model_group)
    return _MlpBlockTP.apply(x, p["ln_2"]["scale"], p["ln_2"]["bias"], ml["fc_w"], ml["fc_b"],
                             ml["proj_w"], ml["proj_b"], mesh.model_group)
