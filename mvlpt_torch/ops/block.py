"""Fused transformer half-block kernels and their plain twins.

The counterpart of ``mvlpt_tpu/ops/block.py``. Each half-block of a
pre-LN residual block is one kernel call:

  * ``attn_fwd``: y = x + OutProj(MHA(LN1 x)) + b, keeping qkv, the
    compute-dtype probabilities and the LN mu/rstd for the backward;
  * ``attn_bwd``: dx only (the backbone is frozen);
  * ``mlp_fwd``: y = x + Proj(QuickGELU(FC(LN2 x))) + b, keeping the
    rounded pre-activation hpre and mu/rstd;
  * ``mlp_bwd``: dx only.

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

from mvlpt_torch.ops import _build

_EPS = 1e-5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class BlockKernels:
    """Selects the fused half-block kernels for ``core.layers.residual_block``
    (``ops.attention.select_attn_fn``). ``inference=True`` selects the
    no-grad forward (no residuals kept)."""

    inference: bool = False


# ------------------------------------------------------------ plain twins

def _ln2d(x32, scale32, bias32, eps):
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (x32 - mu) * rstd * scale32 + bias32, mu, rstd


def _ln_in_cot(x32, mu, rstd, scale32, dxh32):
    """LayerNorm input cotangent with frozen scale/bias, fp32."""
    xn = (x32 - mu) * rstd
    g = dxh32 * scale32
    m1 = g.mean(-1, keepdim=True)
    m2 = (g * xn).mean(-1, keepdim=True)
    return rstd * (g - m1 - xn * m2)


def _mm(a, b):
    """fp32-accumulated product of (possibly bf16) operands."""
    return torch.matmul(a.float(), b.float())


def attn_fwd_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b, mask,
                   n_heads, eps=_EPS, save_residuals=True):
    b, s, w = x.shape
    d = w // n_heads
    dtype, scale = x.dtype, d ** -0.5
    xh32, mu, rstd = _ln2d(x.float(), ln_scale.float(), ln_bias.float(), eps)
    qkv = (_mm(xh32.to(dtype), qkv_w) + qkv_b.float()).to(dtype)
    q, k, v = qkv.view(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)
    qs = (q.float() * scale).to(dtype)
    logits = _mm(qs, k.transpose(-1, -2))
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(dtype)
    o = _mm(probs, v).to(dtype).transpose(1, 2).reshape(b, s, w)
    y = x + (_mm(o, out_w) + out_b.float()).to(dtype)
    if not save_residuals:
        return y, None
    return y, (qkv, probs, mu[..., 0], rstd[..., 0])


def attn_bwd_plain(x, mu, rstd, qkv, probs, ln_scale, qkv_w, out_w, gy, n_heads):
    b, s, w = x.shape
    d = w // n_heads
    dtype, scale = x.dtype, d ** -0.5
    gy = gy.to(dtype)
    do = _mm(gy, out_w.t()).to(dtype).view(b, s, n_heads, d).transpose(1, 2)
    q, k, v = qkv.view(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)
    p32 = probs.float()
    dv = _mm(p32.transpose(-1, -2), do).to(dtype)
    dp = _mm(do, v.transpose(-1, -2))
    ds = (p32 * (dp - (dp * p32).sum(-1, keepdim=True)) * scale).to(dtype)
    dq = _mm(ds, k).to(dtype)
    dk = _mm(ds.transpose(-1, -2), q).to(dtype)
    dqkv = torch.stack([dq, dk, dv], 0).permute(1, 3, 0, 2, 4).reshape(b, s, 3 * w)
    dxh = _mm(dqkv, qkv_w.t())
    dx = _ln_in_cot(x.float(), mu[..., None], rstd[..., None], ln_scale.float(), dxh)
    return gy + dx.to(dtype)


def mlp_fwd_plain(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b, eps=_EPS,
                  save_residuals=True):
    dtype = x.dtype
    xh32, mu, rstd = _ln2d(x.float(), ln_scale.float(), ln_bias.float(), eps)
    hpre = (_mm(xh32.to(dtype), fc_w) + fc_b.float()).to(dtype)
    # QuickGELU on the rounded pre-activation, as the backward's
    # derivative is taken at the saved (rounded) hpre.
    h32 = hpre.float()
    act = (h32 * torch.sigmoid(1.702 * h32)).to(dtype)
    y = x + (_mm(act, proj_w) + proj_b.float()).to(dtype)
    if not save_residuals:
        return y, None
    return y, (hpre, mu[..., 0], rstd[..., 0])


def mlp_bwd_plain(x, mu, rstd, hpre, ln_scale, fc_w, proj_w, gy):
    dtype = x.dtype
    gy = gy.to(dtype)
    h32 = hpre.float()
    da = _mm(gy, proj_w.t())
    sig = torch.sigmoid(1.702 * h32)
    dh = (da * (sig + 1.702 * h32 * sig * (1.0 - sig))).to(dtype)
    dxh = _mm(dh, fc_w.t())
    dx = _ln_in_cot(x.float(), mu[..., None], rstd[..., None], ln_scale.float(), dxh)
    return gy + dx.to(dtype)


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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _empty(shape, like, dtype=None):
    return torch.empty(shape, dtype=dtype or like.dtype, device=like.device)


def attn_fwd(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b, mask, n_heads,
             eps=_EPS, save_residuals=True):
    """Attention half-block forward -> (y, (qkv, probs, mu, rstd) or None)."""
    if x.device.type == "cpu":
        return attn_fwd_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b,
                              mask, n_heads, eps, save_residuals)
    b, s, w = _dims("attn_fwd", x)
    if w % n_heads:
        raise ValueError(f"attn_fwd: width {w} does not split into {n_heads} heads")
    _check("attn_fwd", x, [(ln_scale, (w,)), (ln_bias, (w,)), (qkv_w, (w, 3 * w)),
                           (qkv_b, (3 * w,)), (out_w, (w, w)), (out_b, (w,))], mask=mask)
    f32 = torch.float32
    qkv = _empty((b, s, 3 * w), x)
    probs = _empty((b, n_heads, s, s), x) if save_residuals else None
    mu = _empty((b, s), x, f32) if save_residuals else None
    rstd = _empty((b, s), x, f32) if save_residuals else None
    y = torch.empty_like(x)
    xh, o = _empty((b, s, w), x), _empty((b, s, w), x)  # scratch
    _build.call("attn_fwd", _DTYPE_CODE[x.dtype], _ptr(x), _ptr(ln_scale), _ptr(ln_bias),
                _ptr(qkv_w), _ptr(qkv_b), _ptr(out_w), _ptr(out_b), _ptr(mask),
                _ptr(xh), _ptr(qkv), _ptr(o), _ptr(probs), _ptr(mu), _ptr(rstd), _ptr(y),
                b, s, w, n_heads, eps, _stream())
    _build.LAUNCHES["attn_fwd" if save_residuals else "attn_fwd_infer"] += 1
    return y, ((qkv, probs, mu, rstd) if save_residuals else None)


def attn_bwd(x, mu, rstd, qkv, probs, ln_scale, qkv_w, out_w, gy, n_heads):
    """Attention half-block backward -> dx."""
    if x.device.type == "cpu":
        return attn_bwd_plain(x, mu, rstd, qkv, probs, ln_scale, qkv_w, out_w, gy, n_heads)
    b, s, w = _dims("attn_bwd", x)
    gy = gy.to(x.dtype).contiguous()
    _check("attn_bwd", x, [(qkv, (b, s, 3 * w)), (probs, (b, n_heads, s, s)),
                           (ln_scale, (w,)), (qkv_w, (w, 3 * w)), (out_w, (w, w)),
                           (gy, (b, s, w))], stats=(mu, rstd))
    dx = torch.empty_like(x)
    # scratch: do, ds, dqkv, fp32 dxh
    dout, ds = _empty((b, s, w), x), _empty((b, n_heads, s, s), x)
    dqkv, dxh = _empty((b, s, 3 * w), x), _empty((b, s, w), x, torch.float32)
    _build.call("attn_bwd", _DTYPE_CODE[x.dtype], _ptr(x), _ptr(mu), _ptr(rstd), _ptr(qkv),
                _ptr(probs), _ptr(ln_scale), _ptr(qkv_w), _ptr(out_w), _ptr(gy),
                _ptr(dout), _ptr(ds), _ptr(dqkv), _ptr(dxh), _ptr(dx), b, s, w, n_heads,
                _stream())
    _build.LAUNCHES["attn_bwd"] += 1
    return dx


def mlp_fwd(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b, eps=_EPS,
            save_residuals=True):
    """MLP half-block forward -> (y, (hpre, mu, rstd) or None)."""
    if x.device.type == "cpu":
        return mlp_fwd_plain(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b, eps,
                             save_residuals)
    b, s, w = _dims("mlp_fwd", x)
    w4 = fc_b.shape[0]
    _check("mlp_fwd", x, [(ln_scale, (w,)), (ln_bias, (w,)), (fc_w, (w, w4)), (fc_b, (w4,)),
                          (proj_w, (w4, w)), (proj_b, (w,))])
    f32 = torch.float32
    hpre = _empty((b, s, w4), x) if save_residuals else None
    mu = _empty((b, s), x, f32) if save_residuals else None
    rstd = _empty((b, s), x, f32) if save_residuals else None
    y = torch.empty_like(x)
    xh, act = _empty((b, s, w), x), _empty((b, s, w4), x)  # scratch
    _build.call("mlp_fwd", _DTYPE_CODE[x.dtype], _ptr(x), _ptr(ln_scale), _ptr(ln_bias),
                _ptr(fc_w), _ptr(fc_b), _ptr(proj_w), _ptr(proj_b), _ptr(xh), _ptr(hpre),
                _ptr(act), _ptr(mu), _ptr(rstd), _ptr(y), b * s, w, w4, eps, _stream())
    _build.LAUNCHES["mlp_fwd" if save_residuals else "mlp_fwd_infer"] += 1
    return y, ((hpre, mu, rstd) if save_residuals else None)


def mlp_bwd(x, mu, rstd, hpre, ln_scale, fc_w, proj_w, gy):
    """MLP half-block backward -> dx."""
    if x.device.type == "cpu":
        return mlp_bwd_plain(x, mu, rstd, hpre, ln_scale, fc_w, proj_w, gy)
    b, s, w = _dims("mlp_bwd", x)
    w4 = hpre.shape[-1]
    gy = gy.to(x.dtype).contiguous()
    _check("mlp_bwd", x, [(hpre, (b, s, w4)), (ln_scale, (w,)), (fc_w, (w, w4)),
                          (proj_w, (w4, w)), (gy, (b, s, w))], stats=(mu, rstd))
    dx = torch.empty_like(x)
    dh, dxh = _empty((b, s, w4), x), _empty((b, s, w), x, torch.float32)  # scratch
    _build.call("mlp_bwd", _DTYPE_CODE[x.dtype], _ptr(x), _ptr(mu), _ptr(rstd), _ptr(hpre),
                _ptr(ln_scale), _ptr(fc_w), _ptr(proj_w), _ptr(gy), _ptr(dh), _ptr(dxh),
                _ptr(dx), b * s, w, w4, _stream())
    _build.LAUNCHES["mlp_bwd"] += 1
    return dx


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
