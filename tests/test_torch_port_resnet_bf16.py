"""The bf16 ModifiedResNet tower, the port's against the JAX package's, on
the CPU (the check ROADMAP Queue 3 queued for PERF.md §2's failed bf16
feature bound).

One random OpenAI-layout RN state_dict goes through each package's
converter; each tower's bf16 copy runs its trunk (the map the attention
pool reads) on the same images. Against the fp32 trunk (the port's, held
to the JAX package's at 1e-4 x max in tests/test_torch_port_resnet.py),
the port's bf16 trunk sits within §2's bf16 rule: at most twice the JAX
package's bf16 distance, with a floor of 5e-3 x max|ref|. Then the two
bf16 attention pools read one shared bf16 trunk and are held the same
way against the fp32 pool on that trunk."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import openai_rn_state_dict

CASES = {"tiny-64px": dict(layers=(1, 1, 1, 1), width=8, resolution=64, embed=16),
         "deeper-96px": dict(layers=(2, 2, 2, 2), width=16, resolution=96, embed=32)}
FLOOR = 5e-3
TWIN_FACTOR = 2


def _jax_trunk(visual, images):
    """The JAX package's encode_image_rn up to the pool (NHWC)."""
    from mvlpt_tpu.core import resnet as jr

    x = images.astype(visual["stem"]["conv1"]["kernel"].dtype)
    stem = visual["stem"]
    x = jax.nn.relu(jr._bn(jr._conv(x, stem["conv1"]["kernel"], stride=2), stem["bn1"]))
    x = jax.nn.relu(jr._bn(jr._conv(x, stem["conv2"]["kernel"]), stem["bn2"]))
    x = jax.nn.relu(jr._bn(jr._conv(x, stem["conv3"]["kernel"]), stem["bn3"]))
    x = jr._avgpool(x, 2)
    for stage_idx in range(4):
        for block_idx, block in enumerate(visual[f"layer{stage_idx + 1}"]):
            x = jr._bottleneck(x, block, (1 if stage_idx == 0 else 2) if block_idx == 0 else 1)
    return x


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=sorted(CASES))
def towers(request):
    from mvlpt_tpu.checkpoint import convert as jconv
    from mvlpt_torch.checkpoint.convert import convert_openai_rn_state_dict
    from mvlpt_torch.core.clip import cast_backbone

    dims = CASES[request.param]
    sd = openai_rn_state_dict(3, **dims)
    j32, j_cfg, _ = jconv.convert_openai_rn_state_dict(sd)
    j16, _, _ = jconv.convert_openai_rn_state_dict(sd, dtype=jnp.bfloat16)
    t32, t_cfg, _ = convert_openai_rn_state_dict(sd, device="cpu")
    t16 = cast_backbone(t32, torch.bfloat16)
    images = np.random.RandomState(4).randn(4, dims["resolution"], dims["resolution"], 3)
    return dict(j32=j32, j16=j16, t32=t32, t16=t16, cfg=t_cfg, j_cfg=j_cfg,
                images=images.astype(np.float32))


def _rule(got, jax_got, ref):
    """(port distance, JAX distance, bound) under §2's bf16 rule."""
    d_port = float(np.abs(got - ref).max())
    d_jax = float(np.abs(jax_got - ref).max())
    return d_port, d_jax, max(TWIN_FACTOR * d_jax, FLOOR * float(np.abs(ref).max()))


def test_bf16_trunks_within_the_rule(towers):
    from mvlpt_torch.core.resnet import trunk_rn

    images = towers["images"]
    ref = trunk_rn(towers["t32"]["visual"], torch.from_numpy(images)).permute(0, 2, 3, 1)
    ref = ref.numpy()
    j_ref = _f32(_jax_trunk(towers["j32"]["visual"], jnp.asarray(images)))
    np.testing.assert_allclose(ref, j_ref, rtol=0, atol=1e-4 * np.abs(j_ref).max())
    port = trunk_rn(towers["t16"]["visual"], torch.from_numpy(images))
    assert port.dtype == torch.bfloat16
    port = _f32(port.permute(0, 2, 3, 1))
    jax_b16 = _jax_trunk(towers["j16"]["visual"], jnp.asarray(images))
    assert jax_b16.dtype == jnp.bfloat16
    d_port, d_jax, bound = _rule(port, _f32(jax_b16), ref)
    assert d_port <= bound, (d_port, d_jax, bound)
    assert d_jax > 0  # bf16 rounds: the check is not vacuous


def test_bf16_pools_on_one_shared_trunk(towers):
    """Both packages' bf16 attention pools read the port's bf16 trunk; each
    is held to the fp32 pool on that trunk (upcast) by the same rule, and
    their features' cosine to each other is at least 0.9999."""
    from mvlpt_tpu.core.resnet import attention_pool as j_pool
    from mvlpt_torch.core.resnet import attention_pool, trunk_rn

    heads = towers["cfg"].heads
    trunk = trunk_rn(towers["t16"]["visual"], torch.from_numpy(towers["images"]))
    tokens = trunk.flatten(2).transpose(1, 2).contiguous()  # (B, S, C) bf16
    ref = attention_pool(tokens.float(), towers["t32"]["visual"]["attnpool"], heads).numpy()
    port = attention_pool(tokens, towers["t16"]["visual"]["attnpool"], heads)
    assert port.dtype == torch.bfloat16
    jax_b16 = j_pool(jnp.asarray(tokens.float().numpy()).astype(jnp.bfloat16),
                     towers["j16"]["visual"]["attnpool"], towers["j_cfg"].heads)
    port, jax_b16 = _f32(port), _f32(jax_b16)
    d_port, d_jax, bound = _rule(port, jax_b16, ref)
    assert d_port <= bound, (d_port, d_jax, bound)
    cos = (port * jax_b16).sum(-1) / (np.linalg.norm(port, axis=-1) *
                                       np.linalg.norm(jax_b16, axis=-1))
    assert cos.min() >= 0.9999, cos
