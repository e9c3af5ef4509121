"""The port's zoo converters (checkpoint/zoo_convert.py) and ``get_model``
(models/zoo.py) against the JAX package's, on the CPU.

The state dicts are written in timm's, torchvision's, MAE's and MoCo-v3's
key layouts by tests/torch_port_util.py. Both converters give equal
configs, and the port's tree equals the JAX tree carried across by
``checkpoint.zoo_params_from_jax``, leaf for leaf, so the features are
equal too. A foreign key raises the same message in both, as does every
refusal of ``get_model``'s dispatch. ``get_model`` loads each family's
files (MoCo-v3's with its non-tensor objects) into models whose fields
equal the JAX package's and whose fp32 features agree within 1e-5 x
max|ref|; its CLIP branch reads a tiny OpenAI ``.pt`` (image and text
features within 1e-4 x max|ref|). Without CUDA it raises unless asked
for the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import timm_effnet_state_dict, timm_vit_state_dict, tv_resnet_state_dict

# A narrow 7-stage EfficientNet (the converters read the 7-stage layout):
# (blocks, kernel, stride, expansion, out channels) a stage.
EFF_STAGES = ((1, 3, 1, 1, 8), (2, 3, 2, 6, 8), (1, 5, 2, 6, 16), (1, 3, 2, 6, 16),
              (2, 5, 1, 6, 24), (1, 5, 2, 6, 24), (1, 3, 1, 6, 32))
EFF = dict(stages=EFF_STAGES, stem_ch=8, head_ch=64)

STATE_DICTS = {
    "vit": lambda: timm_vit_state_dict(0),
    "vit_distilled": lambda: timm_vit_state_dict(1, distilled=True),
    "mae": lambda: timm_vit_state_dict(2, wrapper="mae"),
    "mae_finetune": lambda: timm_vit_state_dict(3, wrapper="mae_finetune"),
    "mocov3": lambda: timm_vit_state_dict(4, wrapper="mocov3"),
    "resnet_bottleneck": lambda: tv_resnet_state_dict(5),
    "resnet_basic_module": lambda: tv_resnet_state_dict(6, layers=(2, 1, 1, 1),
                                                        bottleneck=False, wrapper="module"),
    "resnet_state_dict": lambda: tv_resnet_state_dict(7, wrapper="state_dict"),
    "effnet": lambda: timm_effnet_state_dict(8, **EFF),
}
FAMILY = {"vit": "std_vit", "mae": "std_vit", "moc": "std_vit", "res": "tv_resnet",
          "eff": "effnet"}


def _converters(family):
    from mvlpt_tpu.checkpoint import zoo_convert as jconv

    from mvlpt_torch.checkpoint import zoo_convert as tconv

    name = {"std_vit": "convert_std_vit", "tv_resnet": "convert_tv_resnet",
            "effnet": "convert_effnet"}[family]
    return getattr(jconv, name), getattr(tconv, name)


def _features(family):
    from mvlpt_tpu.core import efficientnet as jeff
    from mvlpt_tpu.core import zoo as jzoo

    from mvlpt_torch.core import efficientnet as teff
    from mvlpt_torch.core import zoo as tzoo

    return {"std_vit": (jzoo.std_vit_features, tzoo.std_vit_features),
            "tv_resnet": (jzoo.tv_resnet_features, tzoo.tv_resnet_features),
            "effnet": (jeff.effnet_features, teff.effnet_features)}[family]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("layout", sorted(STATE_DICTS))
def test_converters_agree(layout):
    from mvlpt_torch.checkpoint import zoo_params_from_jax
    from mvlpt_torch.utils.tree import tree_keys, tree_leaves

    family = FAMILY[layout[:3]]
    j_convert, t_convert = _converters(family)
    j_tree, j_cfg = j_convert(STATE_DICTS[layout]())
    t_tree, t_cfg = t_convert(STATE_DICTS[layout](), device="cpu")
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    want = zoo_params_from_jax(_np_tree(j_tree), family, "cpu")
    assert tree_keys(t_tree) == tree_keys(want)
    for key, a, b in zip(tree_keys(t_tree), tree_leaves(t_tree), tree_leaves(want)):
        assert a.dtype == torch.float32 and torch.equal(a, b), key
    if layout == "mae_finetune":
        assert t_cfg.pool == "avg"
    if layout == "vit_distilled":
        assert t_cfg.n_prefix == 2
    if family != "std_vit":
        j_fn, t_fn = _features(family)
        images = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
        got = t_fn(t_tree, torch.from_numpy(images), t_cfg)
        assert torch.equal(got, t_fn(want, torch.from_numpy(images), t_cfg))
        _close(got.numpy(), j_fn(j_tree, jnp.asarray(images), j_cfg), 1e-5)


@pytest.mark.parametrize("layout", ["vit", "resnet_bottleneck", "effnet"])
def test_bf16_conversion_equals_the_cast(layout):
    """dtype=torch.bfloat16 gives the fp32 tree cast to bf16 (one rounding,
    as jnp.asarray(x, bfloat16)), equal to the JAX converter's bf16 tree."""
    from mvlpt_torch.checkpoint import zoo_params_from_jax
    from mvlpt_torch.utils.tree import tree_leaves

    family = FAMILY[layout[:3]]
    j_convert, t_convert = _converters(family)
    j_tree, _ = j_convert(STATE_DICTS[layout](), jnp.bfloat16)
    t_tree, _ = t_convert(STATE_DICTS[layout](), torch.bfloat16, "cpu")
    want = zoo_params_from_jax(_np_tree(j_tree), family, "cpu")
    for a, b in zip(tree_leaves(t_tree), tree_leaves(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def _foreign(sd: dict, key: str) -> dict:
    sd = dict(sd)
    sd[key] = torch.zeros(3)
    return sd


@pytest.mark.parametrize("case", ["vit_foreign", "resnet_foreign", "effnet_foreign",
                                  "effnet_six_stages"])
def test_leftover_keys_raise_the_same(case):
    family = FAMILY[case[:3]]
    j_convert, t_convert = _converters(family)
    if case == "effnet_six_stages":
        sd = timm_effnet_state_dict(9, EFF_STAGES[:6], 8, 64)
    else:
        layout = {"vit": "vit", "resnet": "resnet_bottleneck", "effnet": "effnet"}[
            case.split("_")[0]]
        sd = _foreign(STATE_DICTS[layout](), "extra_branch.0.weight")
    with pytest.raises(ValueError) as want:
        j_convert(sd)
    with pytest.raises(ValueError) as got:
        t_convert(sd, device="cpu")
    assert str(got.value) == str(want.value)
    assert "unconsumed" in str(got.value) or "7-stage" in str(got.value)


REFUSED = ["tf_efficientnet_b0", "resnest50d", "regnety_040", "mixnet_s",
           "mobilenetv3_large_100", "convnext_tiny", "declip_vitb32", "slip_vitb16",
           "filip_vitb32", "defilip_vitb32", "cls_vitb32", "clip_yfcc_vitb32",
           "vit_huge_patch14_224", "mae_vit_giant", "efficientnet_b7"]


@pytest.mark.parametrize("name", REFUSED)
def test_get_model_refusals_match_jax(name):
    from mvlpt_tpu.models.zoo import get_model as j_get

    from mvlpt_torch.models.zoo import get_model

    with pytest.raises(ValueError) as want:
        j_get(name)
    with pytest.raises(ValueError) as got:
        get_model(name, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_files")
    out = {}
    for layout in ("vit_distilled", "mae_finetune", "mocov3", "resnet_basic_module",
                   "resnet_bottleneck", "effnet"):
        out[layout] = str(root / f"{layout}.pth")
        torch.save(STATE_DICTS[layout](), out[layout])
    return out


@pytest.mark.parametrize("name, layout", [
    ("deit_base_distilled_patch16_224", "vit_distilled"),
    ("mae_vit_base_patch16", "mae_finetune"),
    ("mocov3_vit_base", "mocov3"),
    ("resnet18", "resnet_basic_module"),
    ("resnet50", "resnet_bottleneck"),
    ("efficientnet_b0", "effnet")])
def test_get_model_loads_each_family_as_jax(files, name, layout):
    from mvlpt_tpu.models.zoo import get_model as j_get

    from mvlpt_torch.models.zoo import get_model

    if layout == "mocov3":  # a namespace beside the tensors: weights_only=True refuses it
        with pytest.raises(Exception):
            torch.load(files[layout], map_location="cpu", weights_only=True)
    want = j_get(name, checkpoint=files[layout])
    got = get_model(name, checkpoint=files[layout], device="cpu")
    for field in ("name", "input_resolution", "feature_dim", "pixel_mean", "pixel_std"):
        assert getattr(got, field) == getattr(want, field), field
    images = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    feats = got.features(torch.from_numpy(images))
    assert feats.shape == (2, got.feature_dim) and feats.dtype == torch.float32
    _close(feats.numpy(), want.features(jnp.asarray(images)), 1e-5)


@pytest.mark.parametrize("name", ["resnet18", "deit_tiny_patch16_224", "efficientnet_b0"])
def test_get_model_random_init_as_jax(name):
    """checkpoint=None: a random tree of the JAX init's shapes, the same
    fields, finite features."""
    from mvlpt_tpu.models.zoo import get_model as j_get

    from mvlpt_torch.models.zoo import get_model
    from mvlpt_torch.utils.tree import tree_leaves

    want = j_get(name)
    got = get_model(name, dtype=torch.bfloat16, device="cpu")
    for field in ("input_resolution", "feature_dim", "pixel_mean", "pixel_std"):
        assert getattr(got, field) == getattr(want, field), field
    shapes = [tuple(a.shape) for a in jax.tree_util.tree_leaves(want.params)]
    got_shapes = [tuple(t.shape) for t in tree_leaves(got.params)]
    if name != "deit_tiny_patch16_224":  # conv kernels: HWIO there, (O, I, KH, KW) here
        shapes = [(s[3], s[2], s[0], s[1]) if len(s) == 4 else s for s in shapes]
    assert got_shapes == shapes
    res = got.input_resolution
    images = torch.from_numpy(np.random.RandomState(2).randn(1, res, res, 3).astype(np.float32))
    feats = got.features(images)
    assert feats.dtype == torch.bfloat16 and feats.shape == (1, got.feature_dim)
    assert torch.isfinite(feats.float()).all()


def test_get_model_clip_branch_matches_jax(tmp_path, monkeypatch):
    """A CLIP name loads an OpenAI .pt (the checkpoint given, else
    MVLPT_TPU_CLIP_CKPT): image and text features within 1e-4 x max|ref|
    of the JAX package's, CLIP's pixel statistics, and the same error for
    an unknown feature type."""
    from mvlpt_tpu.models.zoo import get_model as j_get

    from mvlpt_torch.models.zoo import get_model
    from tests.test_torch_port_checkpoint import _OPENAI, _openai_state_dict

    path = str(tmp_path / "tiny_vit.pt")
    torch.save(_openai_state_dict(0), path)
    res = _OPENAI["patch"] * _OPENAI["grid"]
    images = np.random.RandomState(3).randn(2, res, res, 3).astype(np.float32)
    want = j_get("ViT-B/32", checkpoint=path)
    got = get_model("ViT-B/32", checkpoint=path, device="cpu")
    for field in ("input_resolution", "feature_dim", "pixel_mean", "pixel_std"):
        assert getattr(got, field) == getattr(want, field), field
    _close(got.features(torch.from_numpy(images)).numpy(),
           want.features(jnp.asarray(images)), 1e-4)

    monkeypatch.setenv("MVLPT_TPU_CLIP_CKPT", path)
    tokens = np.random.RandomState(4).randint(1, _OPENAI["vocab"], (3, _OPENAI["context"]))
    want = j_get("clip_ViT-B/32", feature_type="text")
    got = get_model("clip_ViT-B/32", feature_type="text", device="cpu")
    assert got.feature_dim == want.feature_dim == _OPENAI["embed"]
    _close(got.features(torch.from_numpy(tokens)).numpy(), want.features(jnp.asarray(tokens)),
           1e-4)
    with pytest.raises(ValueError) as j_err:
        j_get("ViT-B/32", feature_type="video")
    with pytest.raises(ValueError) as t_err:
        get_model("ViT-B/32", feature_type="video", device="cpu")
    assert str(t_err.value) == str(j_err.value)


def test_get_model_runs_on_the_card_unless_asked(monkeypatch, files):
    from mvlpt_torch.models.zoo import get_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("resnet50", checkpoint=files["resnet_bottleneck"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("resnet18")
