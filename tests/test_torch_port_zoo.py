"""The port's model zoo (core/zoo.py, core/efficientnet.py and
resnet._conv's groups) against the JAX package's, on the CPU.

Weights go through the JAX package's converter or init and come across
with ``checkpoint.zoo_params_from_jax``; the same seeded images go
through both sides. Cases: the standard ViT (2 layers, width 64, patch 16,
32 px) pooling the class token, MAE's average pool and distilled DeiT's
two prefix tokens; the torchvision ResNet with Basic and Bottleneck
blocks, layers (1, 1, 1, 1) at width 8, 64 px; EfficientNet on a reduced
config (a DS block and two IR blocks, k 3 and 5, strides 1 and 2, stem 8,
head 32, BatchNorm statistics drawn away from identity) at 64 px and on
efficientnet_b0's at 32 px. fp32 features within 1e-5 x max|ref|; bf16
under PERF.md §2's rule (tests/test_torch_port_resnet_bf16.py): the
port's distance from the fp32 features at most twice the JAX package's,
with a floor of 5e-3 x max|ref|. The port's own random inits give the
JAX inits' trees, key for key and shape for shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import timm_effnet_state_dict, timm_vit_state_dict, tv_resnet_state_dict

FP32_REL = 1e-5
FLOOR = 5e-3
TWIN_FACTOR = 2
# A DS block (stride 1, residual), an IR block (k 3, stride 1, residual)
# and an IR block (k 5, stride 2): (blocks, kernel, stride, expansion, out).
REDUCED_STAGES = ((1, 3, 1, 1, 8), (1, 3, 1, 4, 8), (1, 5, 2, 4, 16))


def _np_tree(tree):
    """A JAX tree (dicts and lists) with numpy leaves."""
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed: int, n: int, res: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, res, res, 3).astype(np.float32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _perturb_bn(tree, rng):
    """Every BatchNorm of a JAX zoo tree (its scale, bias, mean, var) and
    every bias drawn away from the inits' identity and zeros."""
    if isinstance(tree, list):
        return [_perturb_bn(v, rng) for v in tree]
    if set(tree) == {"scale", "bias", "mean", "var"}:
        c = np.asarray(tree["scale"]).shape[0]
        return {"scale": 1 + 0.1 * rng.randn(c).astype(np.float32),
                "bias": 0.05 * rng.randn(c).astype(np.float32),
                "mean": 0.1 * rng.randn(c).astype(np.float32),
                "var": (0.5 + rng.rand(c)).astype(np.float32)}
    return {k: (0.05 * rng.randn(*np.asarray(v).shape).astype(np.float32)
                if k.endswith("_b") else _perturb_bn(v, rng) if isinstance(v, (dict, list))
                else np.asarray(v)) for k, v in tree.items()}


def _jax_side(case: str):
    """(family, JAX fp32 tree as numpy, its config, the port's config, the
    JAX features function, the port's, the image size) of a case."""
    from mvlpt_tpu.checkpoint import zoo_convert as jconv
    from mvlpt_tpu.core import efficientnet as jeff
    from mvlpt_tpu.core import zoo as jzoo

    from mvlpt_torch.core import efficientnet as teff
    from mvlpt_torch.core import zoo as tzoo

    if case.startswith("vit"):
        kw = {"vit_cls": {}, "vit_avg": {"wrapper": "mae_finetune"},
              "vit_distilled": {"distilled": True}}[case]
        tree, cfg = jconv.convert_std_vit(timm_vit_state_dict(3, **kw))
        t_cfg = tzoo.StdViTConfig(**cfg.__dict__)
        return ("std_vit", _np_tree(tree), cfg, t_cfg, jzoo.std_vit_features,
                tzoo.std_vit_features, 32)
    if case.startswith("resnet"):
        sd = tv_resnet_state_dict(4, bottleneck=case == "resnet_bottleneck")
        tree, cfg = jconv.convert_tv_resnet(sd)
        return ("tv_resnet", _np_tree(tree), cfg, tzoo.TVResNetConfig(**cfg.__dict__),
                jzoo.tv_resnet_features, tzoo.tv_resnet_features, 64)
    if case == "effnet_reduced":
        cfg = jeff.EffNetConfig(stages=REDUCED_STAGES, stem_ch=8, head_ch=32)
        tree = _perturb_bn(_np_tree(jeff.init_effnet_params(jax.random.PRNGKey(5), cfg)),
                           np.random.RandomState(6))
        res = 64
    else:
        b0 = jeff.EFFNET_CONFIGS["efficientnet_b0"]
        tree, cfg = jconv.convert_effnet(timm_effnet_state_dict(7, b0.stages, b0.stem_ch,
                                                                b0.head_ch))
        assert cfg.stages == b0.stages and cfg.head_ch == 1280
        tree, res = _np_tree(tree), 32
    return ("effnet", tree, cfg, teff.EffNetConfig(**cfg.__dict__), jeff.effnet_features,
            teff.effnet_features, res)


CASES = ["vit_cls", "vit_avg", "vit_distilled", "resnet_basic", "resnet_bottleneck",
         "effnet_reduced", "effnet_b0"]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    from mvlpt_torch.checkpoint import zoo_params_from_jax

    family, tree, cfg, t_cfg, j_fn, t_fn, res = _jax_side(request.param)
    images = _images(CASES.index(request.param), 3, res)
    j32 = jax.tree_util.tree_map(jnp.asarray, tree)
    j16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    want32 = _f32(j_fn(j32, jnp.asarray(images), cfg))
    want16 = j_fn(j16, jnp.asarray(images), cfg)
    assert want16.dtype == jnp.bfloat16
    return dict(name=request.param, family=family, cfg=t_cfg, fn=t_fn, images=images,
                want32=want32, want16=_f32(want16),
                t32=zoo_params_from_jax(tree, family, "cpu"),
                t16=zoo_params_from_jax(jax.tree_util.tree_map(np.asarray, j16), family, "cpu"))


def test_fp32_features_match_jax(case):
    got = case["fn"](case["t32"], torch.from_numpy(case["images"]), case["cfg"])
    assert got.dtype == torch.float32 and got.shape == case["want32"].shape
    want = case["want32"]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_REL * np.abs(want).max())


def test_bf16_features_within_the_rule(case):
    got = case["fn"](case["t16"], torch.from_numpy(case["images"]), case["cfg"])
    assert got.dtype == torch.bfloat16
    ref = case["want32"]
    d_port = float(np.abs(_f32(got) - ref).max())
    d_jax = float(np.abs(case["want16"] - ref).max())
    bound = max(TWIN_FACTOR * d_jax, FLOOR * float(np.abs(ref).max()))
    assert d_port <= bound, (case["name"], d_port, d_jax, bound)
    assert d_jax > 0  # bf16 rounds: the check is not vacuous


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("groups", [1, 2, 12])
def test_conv_groups_matches_lax(stride, groups):
    """resnet._conv with ``groups`` against lax.conv_general_dilated's
    feature_group_count (the JAX _conv), 3x3 and 5x5, fp32; groups = C is
    the depthwise conv."""
    from mvlpt_tpu.core.zoo import _conv as j_conv

    from mvlpt_torch.core.resnet import _conv, from_hwio

    rng = np.random.RandomState(10 * stride + groups)
    c_in, c_out = 12, 12 if groups == 12 else 8
    x = rng.randn(2, 11, 11, c_in).astype(np.float32)
    for k in (3, 5):
        hwio = rng.randn(k, k, c_in // groups, c_out).astype(np.float32)
        want = np.asarray(j_conv(jnp.asarray(x), jnp.asarray(hwio), stride, groups=groups))
        kernel = from_hwio({"k": torch.from_numpy(hwio)})["k"]
        assert kernel.shape == (c_out, c_in // groups, k, k)
        got = _conv(torch.from_numpy(x).permute(0, 3, 1, 2), kernel, stride, groups=groups)
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=FP32_REL * np.abs(want).max())


@pytest.mark.parametrize("family", ["std_vit", "tv_resnet_basic", "tv_resnet", "effnet"])
def test_random_inits_have_the_jax_trees(family):
    """init_std_vit_params, init_tv_resnet_params and init_effnet_params
    give the JAX inits' trees after zoo_params_from_jax, key for key and
    shape for shape, in the dtype asked for (the draws differ by design)."""
    from mvlpt_tpu.core import efficientnet as jeff
    from mvlpt_tpu.core import zoo as jzoo

    from mvlpt_torch.checkpoint import zoo_params_from_jax
    from mvlpt_torch.core import efficientnet as teff
    from mvlpt_torch.core import zoo as tzoo
    from mvlpt_torch.utils.tree import tree_keys, tree_leaves

    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    if family == "std_vit":
        cfg = jzoo.StdViTConfig(16, 64, 2, 2, input_resolution=32, n_prefix=2)
        j = jzoo.init_std_vit_params(key, cfg)
        t = tzoo.init_std_vit_params(gen, tzoo.StdViTConfig(**cfg.__dict__), torch.bfloat16,
                                     "cpu")
    elif family.startswith("tv_resnet"):
        cfg = jzoo.TVResNetConfig((1, 2, 1, 1), bottleneck=family == "tv_resnet", width=8)
        j = jzoo.init_tv_resnet_params(key, cfg)
        t = tzoo.init_tv_resnet_params(gen, tzoo.TVResNetConfig(**cfg.__dict__),
                                       torch.bfloat16, "cpu")
    else:
        cfg = jeff.EffNetConfig(stages=REDUCED_STAGES, stem_ch=8, head_ch=32)
        j = jeff.init_effnet_params(key, cfg)
        t = teff.init_effnet_params(gen, teff.EffNetConfig(**cfg.__dict__), torch.bfloat16,
                                    "cpu")
    want = zoo_params_from_jax(_np_tree(j), family.replace("_basic", ""), "cpu")
    assert tree_keys(t) == tree_keys(want)
    for a, b in zip(tree_leaves(t), tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        assert a.is_contiguous(memory_format=torch.channels_last) or a.dim() != 4
