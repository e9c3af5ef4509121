"""The plain twins of ops/block.py and ops/attention.py as they stood
before they took ``acc`` (the dtype of their sums), kept verbatim: the
fp32 twins every kernel is held to must stay bit for bit these
(tests/test_torch_port_twin64.py)."""

import torch

_EPS = 1e-5


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


def _attn_core_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, mask, n_heads, eps):
    """LN -> qkv -> MHA over the heads of ``qkv_w`` (W, 3Wl): -> (o (B, S,
    Wl), qkv, probs, mu, rstd)."""
    b, s, _ = x.shape
    wl = qkv_w.shape[-1] // 3
    d = wl // n_heads
    dtype, scale = x.dtype, d ** -0.5
    xh32, mu, rstd = _ln2d(x.float(), ln_scale.float(), ln_bias.float(), eps)
    qkv = (_mm(xh32.to(dtype), qkv_w) + qkv_b.float()).to(dtype)
    q, k, v = qkv.view(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)
    qs = (q.float() * scale).to(dtype)
    logits = _mm(qs, k.transpose(-1, -2))
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(dtype)
    o = _mm(probs, v).to(dtype).transpose(1, 2).reshape(b, s, wl)
    return o, qkv, probs, mu[..., 0], rstd[..., 0]


def attn_fwd_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, out_b, mask,
                   n_heads, eps=_EPS, save_residuals=True):
    o, qkv, probs, mu, rstd = _attn_core_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, mask,
                                               n_heads, eps)
    y = x + (_mm(o, out_w) + out_b.float()).to(x.dtype)
    if not save_residuals:
        return y, None
    return y, (qkv, probs, mu, rstd)


def attn_fwd_part_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, out_w, mask, n_heads, eps=_EPS):
    """The tensor-parallel part over ``n_heads`` local heads: -> (fp32
    partial out-projection (B, S, W), (qkv, probs, mu, rstd))."""
    o, *res = _attn_core_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, mask, n_heads, eps)
    return _mm(o, out_w), tuple(res)


def _ln_bwd(x, mu, rstd, ln_scale, dxh32, gy):
    """LayerNorm input cotangent (frozen scale/bias) of the fp32 ``dxh32``
    plus the residual: gy + T(...). The tail of every half-block
    backward; the tensor-parallel backward runs it after the all-reduce,
    as the JAX package's ``_ln_bwd``."""
    dx = _ln_in_cot(x.float(), mu[..., None], rstd[..., None], ln_scale.float(), dxh32)
    return gy + dx.to(x.dtype)


def attn_bwd_part_plain(qkv, probs, qkv_w, out_w, gy, n_heads):
    """fp32 dxh over the heads of ``qkv`` (B, S, 3Wl), without the
    LayerNorm backward (the tensor-parallel part)."""
    b, s, wl3 = qkv.shape
    wl = wl3 // 3
    d = wl // n_heads
    dtype, scale = qkv.dtype, d ** -0.5
    gy = gy.to(dtype)
    do = _mm(gy, out_w.t()).to(dtype).view(b, s, n_heads, d).transpose(1, 2)
    q, k, v = qkv.view(b, s, 3, n_heads, d).permute(2, 0, 3, 1, 4)
    p32 = probs.float()
    dv = _mm(p32.transpose(-1, -2), do).to(dtype)
    dp = _mm(do, v.transpose(-1, -2))
    ds = (p32 * (dp - (dp * p32).sum(-1, keepdim=True)) * scale).to(dtype)
    dq = _mm(ds, k).to(dtype)
    dk = _mm(ds.transpose(-1, -2), q).to(dtype)
    dqkv = torch.stack([dq, dk, dv], 0).permute(1, 3, 0, 2, 4).reshape(b, s, wl3)
    return _mm(dqkv, qkv_w.t())


def attn_bwd_plain(x, mu, rstd, qkv, probs, ln_scale, qkv_w, out_w, gy, n_heads):
    gy = gy.to(x.dtype)
    return _ln_bwd(x, mu, rstd, ln_scale, attn_bwd_part_plain(qkv, probs, qkv_w, out_w, gy,
                                                             n_heads), gy)


def _mlp_hidden_plain(x, ln_scale, ln_bias, fc_w, fc_b, eps):
    """LN -> FC -> QuickGELU: -> (act, hpre, mu, rstd)."""
    dtype = x.dtype
    xh32, mu, rstd = _ln2d(x.float(), ln_scale.float(), ln_bias.float(), eps)
    hpre = (_mm(xh32.to(dtype), fc_w) + fc_b.float()).to(dtype)
    # QuickGELU on the rounded pre-activation, as the backward's
    # derivative is taken at the saved (rounded) hpre.
    h32 = hpre.float()
    act = (h32 * torch.sigmoid(1.702 * h32)).to(dtype)
    return act, hpre, mu[..., 0], rstd[..., 0]


def mlp_fwd_plain(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b, eps=_EPS,
                  save_residuals=True):
    act, *res = _mlp_hidden_plain(x, ln_scale, ln_bias, fc_w, fc_b, eps)
    y = x + (_mm(act, proj_w) + proj_b.float()).to(x.dtype)
    if not save_residuals:
        return y, None
    return y, tuple(res)


def mlp_fwd_part_plain(x, ln_scale, ln_bias, fc_w, fc_b, proj_w, eps=_EPS):
    """The tensor-parallel part over the hidden units of ``fc_w``: ->
    (fp32 partial projection (B, S, W), (hpre, mu, rstd))."""
    act, *res = _mlp_hidden_plain(x, ln_scale, ln_bias, fc_w, fc_b, eps)
    return _mm(act, proj_w), tuple(res)


def mlp_bwd_part_plain(hpre, fc_w, proj_w, gy):
    """fp32 dxh over the hidden units of ``hpre``, without the LayerNorm
    backward (the tensor-parallel part)."""
    gy = gy.to(hpre.dtype)
    h32 = hpre.float()
    da = _mm(gy, proj_w.t())
    sig = torch.sigmoid(1.702 * h32)
    dh = (da * (sig + 1.702 * h32 * sig * (1.0 - sig))).to(hpre.dtype)
    return _mm(dh, fc_w.t())


def mlp_bwd_plain(x, mu, rstd, hpre, ln_scale, fc_w, proj_w, gy):
    gy = gy.to(x.dtype)
    return _ln_bwd(x, mu, rstd, ln_scale, mlp_bwd_part_plain(hpre, fc_w, proj_w, gy), gy)



def _scores_attend(q, k, mask):
    """fp32 probabilities softmax(q k^T * scale + mask) on (N, S, D)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        s = s + mask.float()
    return torch.softmax(s, dim=-1)


def attend_fwd_plain(q, k, v, mask=None):
    p = _scores_attend(q, k, mask).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def attend_bwd_plain(q, k, v, mask, do):
    dtype = q.dtype
    do = do.to(dtype)
    p = _scores_attend(q, k, mask)
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), do.float()).to(dtype)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = (ds * q.shape[-1] ** -0.5).to(dtype).float()
    dq = torch.matmul(ds, k.float()).to(dtype)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()).to(dtype)
    return dq, dk, dv
