"""The port's fused half-block kernels (plain twins on the CPU) against
the JAX package's Pallas kernels in interpret mode, fp32: forward to
2e-6 and dx to 5e-6, as tests/test_fused_block.py holds the Pallas
kernels to the XLA path. The MLP forwards' twins, which the card's bf16
kernels are held to, are also held to the Pallas bodies in bf16."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mvlpt_tpu.core import layers as jlayers
from mvlpt_tpu.core import text as jtext
from mvlpt_tpu.ops import block as jblock
from tests.torch_port_util import block_params_np

from mvlpt_torch.core import layers
from mvlpt_torch.core import text as ttext
from mvlpt_torch.ops import block

S, W, H = 9, 32, 4


def _masks(kind, s):
    """(jax mask, torch mask) for an (s, s) attention."""
    if kind == "none":
        return None, None
    if kind == "causal":
        return jlayers.causal_mask(s), layers.causal_mask(s)
    g, seg = 3, s // 3  # packed text rows: block-causal over 3 classes
    return _packed_mask_jax(g, seg), ttext.block_causal_mask(g, seg)


def _packed_mask_jax(g, s):
    """The block-diagonal causal mask exactly as core/text.py:97-101 builds it."""
    base = jlayers.causal_mask(s)
    mask = jnp.full((g * s, g * s), jnp.finfo(jnp.float32).min, jnp.float32)
    for i in range(g):
        mask = jax.lax.dynamic_update_slice(mask, base, (i * s, i * s))
    return mask


def _tree(p):
    return jax.tree_util.tree_map(jnp.asarray, p), jax.tree_util.tree_map(torch.from_numpy, p)


def test_packed_mask_matches_text_tower():
    np.testing.assert_array_equal(ttext.block_causal_mask(4, 5).numpy(),
                                  np.asarray(_packed_mask_jax(4, 5)))


@pytest.mark.parametrize("half,kind", [("attn", "none"), ("attn", "causal"),
                                       ("attn", "packed"), ("mlp", "none")])
def test_half_block_forward_and_dx_match(half, kind):
    rng = np.random.RandomState(0)
    b = 3
    p_np = block_params_np(rng, W)
    x_np = rng.randn(b, S, W).astype(np.float32)
    gy_np = rng.randn(b, S, W).astype(np.float32)
    jp, tp = _tree(p_np)
    jm, tm = _masks(kind, S)
    if half == "attn":
        def jf(x):
            return jblock.attn_block(x, jp["ln_1"], jp["attn"], jm, H)

        def tf(x):
            return block.attn_block(x, tp["ln_1"], tp["attn"], tm, H)
    else:
        def jf(x):
            return jblock.mlp_block(x, jp["ln_2"], jp["mlp"])

        def tf(x):
            return block.mlp_block(x, tp["ln_2"], tp["mlp"])

    jy, vjp = jax.vjp(jf, jnp.asarray(x_np))
    (jdx,) = vjp(jnp.asarray(gy_np))
    x = torch.from_numpy(x_np).requires_grad_(True)
    y = tf(x)
    (dx,) = torch.autograd.grad(y, x, torch.from_numpy(gy_np))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=2e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=5e-6)


@pytest.mark.parametrize("kind", ["none", "causal", "packed"])
def test_residual_block_matches_including_inference(kind):
    """fused_residual_block, training and inference forwards, against the
    JAX fused block and the port's plain layer path."""
    rng = np.random.RandomState(1)
    p_np = block_params_np(rng, W)
    x_np = rng.randn(4, S, W).astype(np.float32)
    jp, tp = _tree(p_np)
    jm, tm = _masks(kind, S)
    ref = np.asarray(jblock.fused_residual_block(jnp.asarray(x_np), jp, H, jm))
    x = torch.from_numpy(x_np)
    train = block.fused_residual_block(x, tp, H, tm)
    infer = block.fused_residual_block(x, tp, H, tm, inference=True)
    plain = layers.residual_block(x, tp, H, tm)
    np.testing.assert_allclose(train.numpy(), ref, atol=2e-6)
    np.testing.assert_array_equal(infer.numpy(), train.numpy())
    np.testing.assert_allclose(plain.numpy(), ref, atol=2e-6)


def test_residuals_match_pallas_layouts():
    """The saved residuals hold the Pallas kernel's values in the port's
    layouts: qkv (B, S, 3W) is the transpose of qkv^T (B, 3W, S)."""
    rng = np.random.RandomState(2)
    p_np = block_params_np(rng, W)
    x_np = rng.randn(2, S, W).astype(np.float32)
    jp, tp = _tree(p_np)
    _, (_, _, _, jqkvt, jprobs, jmu, jrstd) = jblock._attn_fwd(
        jnp.asarray(x_np), jp["ln_1"], jp["attn"], None, H, 1e-5)
    _, (qkv, probs, mu, rstd) = block.attn_fwd(
        torch.from_numpy(x_np), *(tp["ln_1"][k] for k in ("scale", "bias")),
        *(tp["attn"][k] for k in ("qkv_w", "qkv_b", "out_w", "out_b")), None, H)
    np.testing.assert_allclose(qkv.numpy(), np.asarray(jqkvt).transpose(0, 2, 1), atol=2e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=2e-6)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu)[..., 0], atol=2e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[..., 0], rtol=2e-6)


def test_inference_block_grad_fails_loudly():
    rng = np.random.RandomState(3)
    tp = jax.tree_util.tree_map(torch.from_numpy, block_params_np(rng, W))
    x = torch.from_numpy(rng.randn(2, S, W).astype(np.float32)).requires_grad_(True)
    y = block.fused_residual_block(x, tp, H, None, inference=True)
    with pytest.raises(NotImplementedError, match="no-grad eval kernel"):
        y.sum().backward()


def test_wrappers_check_operands_and_never_fall_back():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device is refused, not sent to the plain twin; operands of
    the wrong shape, dtype or layout are refused before any launch."""
    p = jax.tree_util.tree_map(torch.from_numpy, block_params_np(np.random.RandomState(5), W))
    ln, at = p["ln_1"], p["attn"]
    meta = torch.empty((2, S, W), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        block.attn_fwd(meta, ln["scale"], ln["bias"], at["qkv_w"], at["qkv_b"],
                       at["out_w"], at["out_b"], None, H)
    x = torch.zeros(2, S, W)
    ok = [(ln["scale"], (W,)), (at["qkv_w"], (W, 3 * W))]
    block._check("t", x, ok, stats=(torch.zeros(2, S),), mask=torch.zeros(S, S))
    for bad in ([(at["qkv_w"], (W, W))],                       # shape
                [(at["qkv_w"].double(), (W, 3 * W))],          # dtype
                [(at["qkv_w"].t(), (3 * W, W))]):              # not contiguous
        with pytest.raises(ValueError, match="want a contiguous"):
            block._check("t", x, bad)
    with pytest.raises(ValueError, match="want a contiguous"):
        block._check("t", x, ok, mask=torch.zeros(S, S, dtype=torch.float64))


def test_kernel_selection_and_cpu_launch_counts():
    from mvlpt_torch.ops import _build
    from mvlpt_torch.ops.attention import fused_attention, select_attn_fn

    assert select_attn_fn("auto") == block.BlockKernels()
    assert select_attn_fn("block") == block.BlockKernels()
    assert select_attn_fn("block", inference=True).inference
    assert select_attn_fn("off") is None
    # 'on' selects the standalone fused attention, with one forward for
    # training and eval.
    assert select_attn_fn("on") is fused_attention
    assert select_attn_fn("on", inference=True) is fused_attention
    with pytest.raises(ValueError):
        select_attn_fn("fast")
    # CPU calls run the plain twins and launch no kernel.
    _build.reset_launch_counts()
    rng = np.random.RandomState(4)
    tp = jax.tree_util.tree_map(torch.from_numpy, block_params_np(rng, W))
    x = torch.from_numpy(rng.randn(2, S, W).astype(np.float32)).requires_grad_(True)
    block.fused_residual_block(x, tp, H).sum().backward()
    block.fused_residual_block(x.detach(), tp, H, inference=True)
    assert _build.LAUNCHES == {"attn_fwd": 0, "attn_fwd_infer": 0, "attn_bwd": 0, "mlp_fwd": 0,
                               "mlp_fwd_infer": 0, "mlp_bwd": 0, "attend_fwd": 0,
                               "attend_bwd": 0, "attn_fwd_tp": 0, "attn_bwd_tp": 0,
                               "mlp_fwd_tp": 0, "mlp_bwd_tp": 0, "attn_core_resident": 0,
                               "attn_core_windowed": 0}


# --------------------------------------------------- MLP forwards in bf16

def _bf16_close(got, want, name):
    """5e-3 x max|ref|, the card's bf16 TOL: the products sum in another
    order, so an output on a rounding boundary moves by one bf16 ulp."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-3 * np.abs(want).max(),
                               err_msg=name)


def _mlp_bf16_inputs(seed, b=3, s=17, w=64):
    """A ragged row count (B S = 51 rows, not a multiple of a tile), as
    (jax x, jax params, torch x, torch params) in bf16."""
    rng = np.random.RandomState(seed)
    p_np = block_params_np(rng, w)
    x_np = rng.randn(b, s, w).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p_np)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).bfloat16(), p_np)
    return jnp.asarray(x_np, jnp.bfloat16), jp, torch.from_numpy(x_np).bfloat16(), tp


def _mlp_twin_args(tp):
    ln, ml = tp["ln_2"], tp["mlp"]
    return ln["scale"], ln["bias"], ml["fc_w"], ml["fc_b"], ml["proj_w"], ml["proj_b"]


def test_mlp_fwd_twin_matches_pallas_in_bf16():
    """mlp_fwd_plain in bf16 against _mlp_fwd (y and the residuals hpre,
    mu, rstd) and mlp_block_infer, in interpret mode."""
    jx, jp, tx, tp = _mlp_bf16_inputs(8)
    jy, (_, _, _, jhpre, jmu, jrstd) = jblock._mlp_fwd(jx, jp["ln_2"], jp["mlp"], 1e-5)
    y, (hpre, mu, rstd) = block.mlp_fwd_plain(tx, *_mlp_twin_args(tp))
    assert y.dtype == hpre.dtype == torch.bfloat16
    _bf16_close(y, jy, "y")
    _bf16_close(hpre, jhpre, "hpre")
    # The LayerNorm statistics are fp32 of the same bf16 x.
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu)[..., 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[..., 0], rtol=1e-5)
    jyi = jblock.mlp_block_infer(jx, jp["ln_2"], jp["mlp"])
    yi, res = block.mlp_fwd_plain(tx, *_mlp_twin_args(tp), save_residuals=False)
    assert res is None
    _bf16_close(yi, jyi, "y (no residuals)")


def _jax_mlp_part(x, ln_p, fc_w, fc_b, proj_w):
    """The JAX package's part kernel (_mlp_fwd_kernel, part=True) as
    _mlp_tp_fwd calls it on one model rank's shard, one image a program."""
    b, s, w = x.shape
    w4l = fc_w.shape[1]
    row2 = pl.BlockSpec((1, s, 1), lambda i: (i, 0, 0), memory_space=jblock.pltpu.VMEM)
    f32 = jnp.float32
    return pl.pallas_call(
        functools.partial(jblock._mlp_fwd_kernel, eps=1e-5, g_imgs=1, part=True),
        grid=(b,),
        in_specs=[jblock._row3(1, s, w), jblock._full(w), jblock._full(w),
                  jblock._full(w, w4l), jblock._full(w4l), jblock._full(w4l, w)],
        out_specs=(jblock._row3(1, s, w), jblock._row3(1, s, w4l), row2, row2),
        out_shape=(jax.ShapeDtypeStruct((b, s, w), f32),
                   jax.ShapeDtypeStruct((b, s, w4l), x.dtype),
                   jax.ShapeDtypeStruct((b, s, 1), f32), jax.ShapeDtypeStruct((b, s, 1), f32)),
        interpret=jblock._interpret(),
    )(x, ln_p["scale"], ln_p["bias"], fc_w, fc_b, proj_w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mlp_fwd_part_twin_matches_pallas_part_kernel(dtype):
    """mlp_fwd_part_plain on the second of two hidden-unit shards against
    the Pallas part kernel: the fp32 partial, hpre, mu and rstd. bf16 at
    the card's TOL, fp32 at the block tolerance."""
    jx, jp, tx, tp = _mlp_bf16_inputs(9)
    if dtype == torch.float32:
        jx, tx = jx.astype(jnp.float32), tx.float()
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
        tp = jax.tree_util.tree_map(lambda t: t.float(), tp)
    w4l = tp["mlp"]["fc_b"].shape[0] // 2
    cols = slice(w4l, 2 * w4l)
    jm, tm = jp["mlp"], tp["mlp"]
    want = _jax_mlp_part(jx, jp["ln_2"], jm["fc_w"][:, cols], jm["fc_b"][cols],
                         jm["proj_w"][cols])
    ypart, (hpre, mu, rstd) = block.mlp_fwd_part_plain(
        tx, tp["ln_2"]["scale"], tp["ln_2"]["bias"], tm["fc_w"][:, cols].contiguous(),
        tm["fc_b"][cols].contiguous(), tm["proj_w"][cols].contiguous())
    assert ypart.dtype == torch.float32 and hpre.dtype == dtype
    if dtype == torch.bfloat16:
        _bf16_close(ypart, want[0], "ypart")
        _bf16_close(hpre, want[1], "hpre")
    else:
        np.testing.assert_allclose(ypart.numpy(), np.asarray(want[0]), atol=2e-6)
        np.testing.assert_allclose(hpre.numpy(), np.asarray(want[1]), atol=2e-6)
    np.testing.assert_allclose(mu.numpy(), np.asarray(want[2])[..., 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(want[3])[..., 0], rtol=1e-5)


def test_mlp_bf16_route_checks_widths_and_alignment():
    """The bf16 route (MLP_ROUTES) takes W and 4W in multiples of 64 and
    16-byte-aligned tensors, and raises on anything else; fp32 keeps the
    CUDA-core GEMM and takes any width."""
    assert set(block.MLP_ROUTES) == {torch.bfloat16, torch.float32}
    assert "wgmma" in block.MLP_ROUTES[torch.bfloat16]
    bf = torch.bfloat16
    x, fc_w = torch.zeros(2, 3, 64, dtype=bf), torch.zeros(64, 256, dtype=bf)
    block._check_mlp_route("t", x, 256, (fc_w,))
    with pytest.raises(ValueError, match="multiples of 64"):
        block._check_mlp_route("t", torch.zeros(2, 3, 96, dtype=bf), 384, ())
    with pytest.raises(ValueError, match="multiples of 64"):
        block._check_mlp_route("t", x, 224, ())
    with pytest.raises(ValueError, match="16-byte-aligned"):
        block._check_mlp_route("t", x, 256, (torch.zeros(64 * 256 + 1, dtype=bf)[1:],))
    block._check_mlp_route("t", torch.zeros(2, 3, 96), 384, ())  # fp32: any width


@pytest.mark.parametrize("w, heads, takes", [(64, 1, True), (128, 2, True), (32, 2, False),
                                              (128, 4, False), (96, 1, False)])
def test_bf16_blocks_take_the_tensor_cores_or_the_cuda_cores_by_shape(w, heads, takes,
                                                                      monkeypatch):
    """``tensor_core_shapes``: widths in multiples of 64 and a head width
    of 64. Under 'auto' every block runs the half-block kernels, whatever
    its shapes: on the CPU their twins, equal to fused_residual_block
    (not to the plain layers); on the card each of the four wrappers
    launches bf16 on the tensor cores (dtype code 1) at the shapes they
    take and on the CUDA cores (code 2) at the others, fp32 on the CUDA
    cores (code 0). (Meta tensors with _dims lifted and _build.call
    recorded stand for the card.)"""
    from mvlpt_torch.ops.attention import select_attn_fn

    rng = np.random.RandomState(3)
    p_np = block_params_np(rng, w)
    tp = {k: {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in v.items()}
          for k, v in p_np.items()}
    x = torch.from_numpy(rng.randn(2, 5, w).astype(np.float32)).to(torch.bfloat16)
    assert block.tensor_core_shapes(x, w, heads) is takes
    assert block.tensor_core_shapes(x, 4 * w) is (w % 64 == 0)
    assert not block.tensor_core_shapes(x.float(), w, heads)
    fused = block.fused_residual_block(x, tp, heads, None)
    assert not torch.equal(layers.residual_block(x, tp, heads), fused)
    assert torch.equal(layers.residual_block(x, tp, heads, kernels=select_attn_fn("auto")), fused)

    monkeypatch.setattr(block, "_dims", lambda name, t: t.shape)
    monkeypatch.setattr(block._build, "LAUNCHES", dict(block._build.LAUNCHES))
    monkeypatch.setattr(block, "_stream", lambda: None)
    calls = []
    monkeypatch.setattr(block._build, "call", lambda name, code, *args: calls.append((name, code)))
    for dtype, attn_code, mlp_code in ((torch.bfloat16, 1 if takes else 2,
                                        1 if w % 64 == 0 else 2), (torch.float32, 0, 0)):
        def z(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device="meta")

        xm, stats = z(2, 5, w), z(2, 5, dt=torch.float32)
        block.attn_fwd(xm, z(w), z(w), z(w, 3 * w), z(3 * w), z(w, w), z(w), None, heads)
        block.attn_bwd(xm, stats, stats, z(2, 5, 3 * w), z(2, heads, 5, 5), z(w), z(w, 3 * w),
                       z(w, w), xm, heads)
        block.mlp_fwd(xm, z(w), z(w), z(w, 4 * w), z(4 * w), z(4 * w, w), z(w))
        block.mlp_bwd(xm, stats, stats, z(2, 5, 4 * w), z(w), z(w, 4 * w), z(4 * w, w), xm)
        assert calls == [("attn_fwd", attn_code), ("attn_bwd", attn_code), ("mlp_fwd", mlp_code),
                         ("mlp_bwd", mlp_code)]
        calls.clear()


# --------------------------------------------------- MLP backward twins

def _jax_mlp_bwd_part(hpre, fc_w, proj_w, gy):
    """The JAX package's part kernel (_mlp_bwd_kernel, part=True) as
    _mlp_tp_bwd calls it on one model rank's shard, one image a program:
    the fp32 partial dxh."""
    b, s, w = gy.shape
    w4l = fc_w.shape[1]
    return pl.pallas_call(
        functools.partial(jblock._mlp_bwd_kernel, eps=1e-5, g_imgs=1, part=True),
        grid=(b,),
        in_specs=[jblock._row3(1, s, w4l), jblock._full(w, w4l), jblock._full(w4l, w),
                  jblock._row3(1, s, w)],
        out_specs=jblock._row3(1, s, w),
        out_shape=jax.ShapeDtypeStruct((b, s, w), jnp.float32),
        interpret=jblock._interpret(),
    )(hpre, fc_w, proj_w, gy)


def _mlp_bwd_inputs(seed, dtype):
    """_mlp_bf16_inputs in ``dtype``, a seeded gy, and the JAX forward's
    residuals (hpre, mu, rstd) on both sides."""
    jx, jp, tx, tp = _mlp_bf16_inputs(seed)
    if dtype == torch.float32:
        jx, tx = jx.astype(jnp.float32), tx.float()
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
        tp = jax.tree_util.tree_map(lambda t: t.float(), tp)
    gy_np = np.random.RandomState(seed + 100).randn(*tx.shape).astype(np.float32)
    jgy, tgy = jnp.asarray(gy_np, jx.dtype), torch.from_numpy(gy_np).to(dtype)
    _, (_, _, _, jhpre, jmu, jrstd) = jblock._mlp_fwd(jx, jp["ln_2"], jp["mlp"], 1e-5)

    def torch_of(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32)))

    res = (torch_of(jhpre).to(dtype), torch_of(jmu)[..., 0], torch_of(jrstd)[..., 0])
    return (jx, jp, jgy, (jhpre, jmu, jrstd)), (tx, tp, tgy, res)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mlp_bwd_twin_matches_pallas(dtype):
    """mlp_bwd_plain against _mlp_bwd (dx) on the same residuals of
    _mlp_fwd, in interpret mode: bf16 at the card's old bound (5e-3 x
    max|ref|), fp32 at the block tolerance."""
    (jx, jp, jgy, (jhpre, jmu, jrstd)), (tx, tp, tgy, (hpre, mu, rstd)) = \
        _mlp_bwd_inputs(11, dtype)
    jdx = jblock._mlp_bwd(1e-5, (jx, jp["ln_2"], jp["mlp"], jhpre, jmu, jrstd), jgy)[0]
    dx = block.mlp_bwd_plain(tx, mu, rstd, hpre, tp["ln_2"]["scale"], tp["mlp"]["fc_w"],
                             tp["mlp"]["proj_w"], tgy)
    assert dx.dtype == dtype
    if dtype == torch.bfloat16:
        _bf16_close(dx, jdx.astype(jnp.float32), "dx")
    else:
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=5e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mlp_bwd_part_twin_matches_pallas_part_kernel(dtype):
    """mlp_bwd_part_plain on the second of two hidden-unit shards against
    the Pallas part kernel (_mlp_bwd_kernel, part=True): the fp32 partial
    dxh; bf16 at the card's old bound, fp32 at the block tolerance."""
    (_, jp, jgy, (jhpre, _, _)), (_, tp, tgy, (hpre, _, _)) = _mlp_bwd_inputs(12, dtype)
    w4l = tp["mlp"]["fc_b"].shape[0] // 2
    cols = slice(w4l, 2 * w4l)
    jm, tm = jp["mlp"], tp["mlp"]
    want = _jax_mlp_bwd_part(jhpre[..., cols], jm["fc_w"][:, cols], jm["proj_w"][cols], jgy)
    got = block.mlp_bwd_part_plain(hpre[..., cols].contiguous(), tm["fc_w"][:, cols].contiguous(),
                                   tm["proj_w"][cols].contiguous(), tgy)
    assert got.dtype == torch.float32
    if dtype == torch.bfloat16:
        _bf16_close(got, want, "dxh")
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_mlp_bwd_wrappers_check_the_bf16_route(monkeypatch):
    """mlp_bwd and mlp_bwd_part pick the bf16 route as the forwards do,
    before any launch: a bf16 width off the multiple of 64 launches the
    CUDA cores' route on bf16 operands (dtype code 2), not the twin; at
    the tensor cores' widths a misaligned base raises, with nothing
    launched. (Meta tensors, with the wrappers' device check lifted,
    reach the launch without a card; it is recorded, not made.)"""
    monkeypatch.setattr(block, "_dims", lambda name, x: x.shape)
    monkeypatch.setattr(block._build, "LAUNCHES", dict(block._build.LAUNCHES))
    monkeypatch.setattr(block, "_stream", lambda: None)
    calls = []
    monkeypatch.setattr(block._build, "call", lambda name, code, *args: calls.append((name, code)))
    b, s = 2, 3

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    def run(w, w4, fc_w=None):
        x, gy, hpre = meta(b, s, w), meta(b, s, w), meta(b, s, w4)
        stats = meta(b, s, dtype=torch.float32)
        fc_w = meta(w, w4) if fc_w is None else fc_w
        block.mlp_bwd(x, stats, stats, hpre, meta(w), fc_w, meta(w4, w), gy)
        block.mlp_bwd_part(hpre, fc_w, meta(w4, w), gy)

    run(96, 384)
    assert calls == [("mlp_bwd", 2), ("mlp_bwd_part", 2)]
    calls.clear()
    with pytest.raises(ValueError, match="mlp_bwd: the bf16 tensor-core route needs 16-byte"):
        run(128, 512, meta(128 * 512 + 1)[1:].view(128, 512))
    assert calls == []