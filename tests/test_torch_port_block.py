"""The port's fused half-block kernels (plain twins on the CPU) against
the JAX package's Pallas kernels in interpret mode, fp32: forward to
2e-6 and dx to 5e-6, as tests/test_fused_block.py holds the Pallas
kernels to the XLA path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
                               "mlp_fwd_tp": 0, "mlp_bwd_tp": 0}
