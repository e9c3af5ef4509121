"""The port's standalone fused attention (plain twins on the CPU) against
the JAX package's ``pallas_attention`` in interpret mode: fp32 forward
to 2e-6 and dq/dk/dv to 5e-6 x max|ref|, as tests/test_fused_block.py
holds the Pallas kernels; one bf16 case at 5e-3 x max|ref|. S = 37, 128
and 129 cover the JAX side's padding to a multiple of 128; S = 201 and
126 at D = 64 are the image and packed text rows at CLIP's head width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlpt_tpu.ops.attention import pallas_attention

from mvlpt_torch.ops import attention

B, H, D = 2, 3, 16
NEG = np.finfo(np.float32).min


def _mask(kind, s):
    """Additive fp32 (s, s) mask as numpy, or None: causal, or causal
    within classes of 9 tokens and masked across them (the packed text
    rows' block-causal mask; the last class is ragged)."""
    if kind == "none":
        return None
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    keep = j <= i
    if kind == "packed":
        keep &= (i // 9) == (j // 9)
    return np.where(keep, 0.0, NEG).astype(np.float32)


def _inputs(s, seed, b=B, h=H, d=D):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(4)]  # q, k, v, do


def _run_both(q, k, v, do, mask, dtype):
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jm = None if mask is None else jnp.asarray(mask)
    jo, vjp = jax.vjp(lambda a, b, c: pallas_attention(a, b, c, jm),
                      *(jnp.asarray(t, jd) for t in (q, k, v)))
    jgrads = vjp(jnp.asarray(do, jd))
    tq, tk, tv = (torch.from_numpy(t).to(dtype).requires_grad_(True) for t in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    to = attention.fused_attention(tq, tk, tv, tm)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do).to(dtype))
    f32 = [np.asarray(t, np.float32) for t in (jo, *jgrads)]
    return f32, [t.detach().float().numpy() for t in (to, *tgrads)]


@pytest.mark.parametrize("s", [37, 128, 129])
@pytest.mark.parametrize("kind", ["none", "causal", "packed"])
def test_fused_attention_matches_pallas(kind, s):
    q, k, v, do = _inputs(s, seed=s)
    (jo, *jg), (to, *tg) = _run_both(q, k, v, do, _mask(kind, s), torch.float32)
    np.testing.assert_allclose(to, jo, atol=2e-6)
    for name, want, got in zip(("dq", "dk", "dv"), jg, tg):
        np.testing.assert_allclose(got, want, atol=5e-6 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("s,kind", [(201, "none"), (126, "packed"), (581, "causal")])
def test_fused_attention_matches_pallas_at_clip_head_width(s, kind):
    """D = 64, the only head width of CLIP's towers and the one the bf16
    tensor-core route takes: ViT-B/16 with 4 VPT rows, and the packed
    text rows with their block-causal mask."""
    q, k, v, do = _inputs(s, seed=s, b=1, h=2, d=64)
    (jo, *jg), (to, *tg) = _run_both(q, k, v, do, _mask(kind, s), torch.float32)
    np.testing.assert_allclose(to, jo, atol=2e-6 * np.abs(jo).max())
    for name, want, got in zip(("dq", "dk", "dv"), jg, tg):
        np.testing.assert_allclose(got, want, atol=5e-6 * np.abs(want).max(), err_msg=name)


def test_fused_attention_bf16_matches_pallas():
    q, k, v, do = _inputs(129, seed=3)
    want, got = _run_both(q, k, v, do, _mask("causal", 129), torch.bfloat16)
    for name, w, g in zip(("o", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(g, w, atol=5e-3 * np.abs(w).max(), err_msg=name)


def test_fused_attention_bf16_matches_pallas_past_the_buckets():
    """bf16 at the ViT-L/14@336px length, where the card's bf16 rows leave
    the tensor-core buckets for the CUDA-core route: the twin it is held
    to, against the Pallas kernels."""
    q, k, v, do = _inputs(581, seed=4, b=1, h=2, d=64)
    want, got = _run_both(q, k, v, do, None, torch.bfloat16)
    for name, w, g in zip(("o", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(g, w, atol=5e-3 * np.abs(w).max(), err_msg=name)


def test_twins_state_the_pallas_rounding_points():
    """In bf16 the scale goes on the fp32 scores after the product (not on
    a rounded q, as the half-block core does) and dp stays fp32: the
    twins equal a direct transcription of _fwd_kernel/_bwd_kernel."""
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rng.randn(4, 19, 24).astype(np.float32)).bfloat16()
                   for _ in range(4))
    mask = torch.from_numpy(_mask("causal", 19))
    scale = 24 ** -0.5
    s = (q.float() @ k.float().transpose(-1, -2)) * scale + mask
    p = torch.softmax(s, -1)
    o = (p.bfloat16().float() @ v.float()).bfloat16()
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = ((p * (dp - (dp * p).sum(-1, keepdim=True))) * scale).bfloat16().float()
    torch.testing.assert_close(attention.attend_fwd_plain(q, k, v, mask), o, rtol=0, atol=0)
    dq, dk, dv = attention.attend_bwd_plain(q, k, v, mask, do)
    torch.testing.assert_close(dq, (ds @ k.float()).bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(dk, (ds.transpose(-1, -2) @ q.float()).bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(
        dv, (p.bfloat16().float().transpose(-1, -2) @ do.float()).bfloat16(), rtol=0, atol=0)


def test_residuals_are_q_k_v_and_mask():
    """Like the JAX custom VJP, the backward keeps q, k, v and the mask
    and recomputes the probabilities; no (S, S) probability tensor per
    row is saved."""
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    q, k, v = (torch.randn(B, H, 21, D, requires_grad=True) for _ in range(3))
    mask = torch.from_numpy(_mask("causal", 21))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        attention.fused_attention(q, k, v, mask).sum().backward()
    assert sorted(saved) == sorted([(B * H, 21, D)] * 3 + [(21, 21)])


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Off the CPU a wrapper launches its kernel or raises: another
    device is refused, not sent to the plain twin; so are operands of
    the wrong shape, dtype or layout, and a bf16 head width that the
    tensor-core route does not take (it is never sent to the fp32
    kernel)."""
    q = _meta(6, 9, D)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        attention.attend_fwd(q, q, q)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        attention.attend_bwd(q, q, q, _meta(9, 9), q)
    for k, mask in ((_meta(6, 9, 8), None),                      # shape
                    (_meta(6, 9, D, dtype=torch.float64), None),  # dtype
                    (_meta(6, D, 9).transpose(1, 2), None),       # not contiguous
                    (q, _meta(9, 9, dtype=torch.bfloat16))):      # mask dtype
        with pytest.raises(ValueError, match="want a contiguous"):
            attention.attend_fwd(q, k, q, mask)
    for d in (D, 32, 128):  # CLIP's heads are 64 wide
        r = _meta(6, 9, d, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="tensor-core route takes D = 64"):
            attention.attend_fwd(r, r, r)
        with pytest.raises(ValueError, match="tensor-core route takes D = 64"):
            attention.attend_bwd(r, r, r, None, r)


@pytest.mark.parametrize("name,most", [("attend_fwd", 49728), ("attend_bwd", 24800)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_each_route_takes_clip_rows_and_refuses_past_its_limit(name, most, dtype):
    """Both dtypes take CLIP text (77), the packed text rows (126),
    ViT-B/16 + 4 VPT rows (201), ViT-L/14 + 4 VPT rows (261), ViT-L/14@336px
    + 4 VPT rows (581) and S = 1024 at D = 64, each on the route route_of
    names: bf16 on the tensor cores up to the buckets' largest S (352
    forward, 280 backward, csrc/attend_{fwd,bwd}.cu) and on the CUDA cores
    past it, fp32 on the CUDA cores. The CUDA-core route's one limit is a
    query's fp32 score row (backward: p and dp) beside the key chunks in
    one block's shared memory; one row past it is refused."""
    fn = getattr(attention, name)
    tc_max = {"attend_fwd": 352, "attend_bwd": 280}[name]

    def call(s):
        r = _meta(2, s, 64, dtype=dtype)
        return fn(r, r, r) if name == "attend_fwd" else fn(r, r, r, None, r)

    for s in (1, 17, 77, 126, 201, 261, tc_max, tc_max + 1, 581, 1024, most):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call(s)  # past the route's checks, refused only for the device
        want = "mma" if dtype == torch.bfloat16 and s <= tc_max else "fma"
        assert attention.route_of(name, dtype, s) == want, s
    with pytest.raises(ValueError, match="more shared memory"):
        call(most + 1)
    words, limit = attention._fma_words, attention._SMEM_WORDS
    assert words(name, most, 64) <= limit < words(name, most + 1, 64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_scratch_of_each_route(dtype):
    """The tensor-core route (bf16 up to S = 280) allocates no (N, S, S)
    tensor: only the (3, N, S) fp32 row statistics (max, sum, rowsum(dp
    p)) pass between its two launches. The CUDA-core route (fp32; bf16
    past S = 280) moves T(p) and ds through (N, S, S) tensors in the
    dtype."""
    n, s = 384, 201  # the image train shape: 32 images x 12 heads
    p, ds, stats = attention._bwd_scratch(_meta(n, s, 64, dtype=dtype))
    if dtype == torch.bfloat16:
        assert p is None and ds is None
        assert (tuple(stats.shape), stats.dtype) == ((3, n, s), torch.float32)
    else:
        assert stats is None
        assert [(tuple(t.shape), t.dtype) for t in (p, ds)] == [((n, s, s), dtype)] * 2
    n, s = 64, 581  # ViT-L/14@336px: 4 images x 16 heads
    p, ds, stats = attention._bwd_scratch(_meta(n, s, 64, dtype=dtype))
    assert stats is None
    assert [(tuple(t.shape), t.dtype) for t in (p, ds)] == [((n, s, s), dtype)] * 2


def test_cpu_calls_launch_no_kernel():
    from mvlpt_torch.ops import _build

    _build.reset_launch_counts()
    q, k, v = (torch.randn(B, H, 9, D, requires_grad=True) for _ in range(3))
    attention.fused_attention(q, k, v).sum().backward()
    assert _build.LAUNCHES["attend_fwd"] == _build.LAUNCHES["attend_bwd"] == 0
