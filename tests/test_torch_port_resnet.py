"""The port's ModifiedResNet tower and its OpenAI converter against the
JAX package's, on the CPU in fp32.

One random OpenAI-layout RN state_dict (``openai_rn_state_dict``: a tiny
RNConfig (1, 1, 1, 1) at width 8, 64 px, BatchNorm statistics away from
identity) goes through the JAX converter, whose tree the port takes with
``checkpoint.from_jax``, and through the port's own converter. Holds:
the features within 1e-4 x max|ref|, a stride-2 stem conv row, the
attention pool alone within 1e-5 x max|ref|, the configs' fields equal,
``load_clip`` sending RN and ViT files to their converters, and
``find_cached_clip`` knowing the RN names by file and sha256.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import calibrate_rn_bn, openai_rn_state_dict

TINY = dict(layers=(1, 1, 1, 1), width=8, resolution=64, embed=16)


def _images(seed=0, n=3, res=64):
    return np.random.RandomState(seed).randn(n, res, res, 3).astype(np.float32)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.fixture(scope="module")
def sides():
    """The JAX converter's backbone and RNConfig, and the port's backbone
    carried from that tree by from_jax (fp32, CPU)."""
    from mvlpt_tpu.checkpoint import convert as jconv

    from mvlpt_torch.checkpoint import backbone_from_jax

    sd = openai_rn_state_dict(0, **TINY)
    j_params, j_cfg, _ = jconv.convert_openai_rn_state_dict(sd)
    t_params = backbone_from_jax(jax.tree_util.tree_map(np.asarray, j_params), "cpu")
    return sd, j_params, j_cfg, t_params


def test_rn_tower_matches_jax(sides):
    from mvlpt_tpu.core.resnet import encode_image_rn as j_encode

    from mvlpt_torch.core import clip as tclip
    from mvlpt_torch.core.resnet import RNConfig, encode_image_rn

    _, j_params, j_cfg, t_params = sides
    cfg = RNConfig(**dataclasses.asdict(j_cfg))
    images = _images()
    want = j_encode(j_params["visual"], jnp.asarray(images), j_cfg)
    got = encode_image_rn(t_params["visual"], torch.from_numpy(images), cfg)
    assert got.shape == (3, TINY["embed"]) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-4)
    # core.clip's dispatch sends an RNConfig to the same tower
    assert torch.equal(tclip.encode_image(t_params, torch.from_numpy(images), cfg), got)


def test_stride2_stem_conv_matches_jax(sides):
    """The stem's stride-2 3x3 conv pads k // 2 on each side (torch's rule,
    not XLA's SAME), so every row lines up with the JAX package's."""
    from mvlpt_tpu.core.resnet import _conv as j_conv

    from mvlpt_torch.core.resnet import _conv

    _, j_params, _, t_params = sides
    images = _images(1)
    want = np.asarray(j_conv(jnp.asarray(images), j_params["visual"]["stem"]["conv1"]["kernel"],
                             stride=2))
    got = _conv(torch.from_numpy(images).permute(0, 3, 1, 2),
                t_params["visual"]["stem"]["conv1"]["kernel"], stride=2)
    assert got.shape == (3, 4, 32, 32)
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)
    # the first output row reads the padding row above the image
    _close(got[:, :, 0].permute(0, 2, 1).numpy(), want[:, 0], 1e-5)


def test_attention_pool_matches_jax(sides):
    from mvlpt_tpu.core.resnet import attention_pool as j_pool

    from mvlpt_torch.core.resnet import attention_pool

    _, j_params, j_cfg, t_params = sides
    c = 32 * TINY["width"]
    x = np.random.RandomState(2).randn(3, 4, c).astype(np.float32)
    want = j_pool(jnp.asarray(x), j_params["visual"]["attnpool"], j_cfg.heads)
    got = attention_pool(torch.from_numpy(x), t_params["visual"]["attnpool"], j_cfg.heads)
    _close(got.numpy(), want, 1e-5)


def test_conv_kernels_are_stored_channels_last(sides):
    """The conv kernels are turned to (O, I, KH, KW) channels_last once, when
    the weights are carried or converted, not per call."""
    from mvlpt_torch.checkpoint import convert_openai_rn_state_dict
    from mvlpt_torch.utils.tree import tree_keys, tree_leaves

    sd, _, _, t_params = sides
    converted, _, _ = convert_openai_rn_state_dict(sd, device="cpu")
    for params in (t_params, converted):
        kernels = [t for t in tree_leaves(params["visual"]) if t.dim() == 4]
        assert len(kernels) == 3 + 4 * 4  # the stem's 3; 3 and a downsample a block
        assert all(t.is_contiguous(memory_format=torch.channels_last) for t in kernels)
    assert torch.equal(t_params["visual"]["layer2"][0]["conv2"]["kernel"],
                       sd["visual.layer2.0.conv2.weight"])
    assert tree_keys(t_params) == tree_keys(converted)


def test_rn_converter_matches_jax(sides):
    from mvlpt_tpu.checkpoint import convert as jconv
    from mvlpt_tpu.core.clip import encode_image as j_encode

    from mvlpt_torch.checkpoint import convert as tconv
    from mvlpt_torch.core.clip import encode_image
    from mvlpt_torch.utils.tree import tree_keys, tree_leaves

    sd, j_params, j_cfg, t_params = sides
    t_cfg = tconv.rn_config_from_state_dict(sd)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert (t_cfg.layers, t_cfg.width, t_cfg.input_resolution, t_cfg.heads,
            t_cfg.output_dim) == ((1, 1, 1, 1), 8, 64, 4, 16)
    params, cfg, text_cfg = tconv.convert_openai_rn_state_dict(sd, device="cpu")
    _, _, j_text_cfg = jconv.convert_openai_rn_state_dict(sd)
    assert cfg == t_cfg
    assert dataclasses.asdict(text_cfg) == dataclasses.asdict(j_text_cfg)
    assert tree_keys(params) == tree_keys(t_params)
    for key, a, b in zip(tree_keys(params), tree_leaves(params), tree_leaves(t_params)):
        assert torch.equal(a, b), key
    images = _images(3)
    want = j_encode(j_params, jnp.asarray(images), j_cfg)
    _close(encode_image(params, torch.from_numpy(images), cfg).numpy(), want, 1e-4)


def test_load_clip_dispatches_rn_and_vit(tmp_path):
    from mvlpt_torch.checkpoint.convert import load_clip
    from mvlpt_torch.core.clip import CLIPConfig
    from mvlpt_torch.core.resnet import RNConfig
    from tests.test_torch_port_checkpoint import _openai_state_dict

    rn, vit = tmp_path / "RN-tiny.pt", tmp_path / "ViT-tiny.pt"
    torch.save(openai_rn_state_dict(1, **TINY), str(rn))
    torch.save(_openai_state_dict(0), str(vit))
    params, cfg = load_clip(str(rn), device="cpu")
    assert isinstance(cfg, RNConfig) and "stem" in params["visual"]
    assert params["text"]["blocks"]["attn"]["qkv_w"].shape == (2, 64, 192)
    params, cfg = load_clip(str(vit), device="cpu")
    assert isinstance(cfg, CLIPConfig) and "patch_embed" in params["visual"]


def test_find_cached_clip_knows_the_rn_names(tmp_path):
    """RN50-RN50x64 by their OpenAI file names and sha256 (the JAX package's
    download URLs): a missing file raises, nothing is fetched, and a file
    whose sha256 differs is refused."""
    from mvlpt_tpu.checkpoint.convert import OPENAI_MODELS

    from mvlpt_torch.checkpoint.convert import OPENAI_RN_FILES, find_cached_clip

    assert sorted(OPENAI_RN_FILES) == sorted(k for k in OPENAI_MODELS if k.startswith("RN"))
    for name, (fname, sha) in OPENAI_RN_FILES.items():
        assert OPENAI_MODELS[name].split("/")[-2:] == [sha, fname]
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        find_cached_clip("RN50", root=str(tmp_path))
    (tmp_path / "RN50.pt").write_bytes(b"not the checkpoint")
    with pytest.raises(RuntimeError, match="sha256"):
        find_cached_clip("RN50", root=str(tmp_path))


def test_random_rn_backbone_and_the_prompt_trainers_refusal(monkeypatch):
    """MVLPT_TPU_RANDOM_CLIP with an RN name: RN_ARCHS' tower beside
    ViT-B/16's text tower, as the JAX package pairs them; the prompt
    trainers refuse it with the JAX package's error."""
    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.core.resnet import RN_ARCHS, RNConfig
    from mvlpt_torch.train import trainer as t_trainer

    monkeypatch.setenv("MVLPT_TPU_RANDOM_CLIP", "1")
    monkeypatch.setitem(RN_ARCHS, "RN50", RNConfig(layers=(1, 1, 1, 1), width=8,
                                                   output_dim=16, input_resolution=64, heads=4))
    cfg = get_cfg_default()
    cfg.MODEL.BACKBONE.NAME = "RN50"
    backbone, rn_cfg = t_trainer.load_clip_backbone(cfg, torch.bfloat16, "cpu")
    assert rn_cfg is RN_ARCHS["RN50"]
    assert backbone["visual"]["stem"]["conv1"]["kernel"].dtype == torch.bfloat16
    assert backbone["text"]["blocks"]["attn"]["qkv_w"].shape == (12, 512, 1536)
    assert backbone["logit_scale"].dtype == torch.float32

    trainer = t_trainer.PromptTrainer.__new__(t_trainer.PromptTrainer)
    trainer.cfg, trainer.device = cfg, torch.device("cpu")
    monkeypatch.setattr(trainer, "check_cfg", lambda: None, raising=False)
    monkeypatch.setattr(trainer, "_dtypes", lambda: (torch.float32, torch.float32),
                        raising=False)
    trainer.dm = type("DM", (), {"classnames": ["a", "b"]})()
    with pytest.raises(ValueError, match="Prompt tuning requires a ViT backbone"):
        trainer.build_model()


def test_rn_image_encoder_matches_jax(sides):
    """make_image_encoder's RN branch: device_normalize of a uint8 batch,
    then the plain tower, as the JAX package's does."""
    from mvlpt_tpu.models.zsclip import make_image_encoder as j_make

    from mvlpt_torch.core.resnet import RNConfig
    from mvlpt_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
    from mvlpt_torch.models.zsclip import make_image_encoder

    _, j_params, j_cfg, t_params = sides
    u8 = np.random.RandomState(4).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    want = j_make(j_cfg, CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)(j_params, jnp.asarray(u8))
    encode = make_image_encoder(RNConfig(**dataclasses.asdict(j_cfg)), CLIP_PIXEL_MEAN,
                                CLIP_PIXEL_STD)
    _close(encode(t_params, torch.from_numpy(u8)).numpy(), want, 1e-4)


def test_rn_text_step_raises_the_reference_side_gap(sides):
    """The JAX package's RNConfig has no text fields, so its zero-shot and
    text-feature paths fail on an RN backbone; the port raises there, with
    an error that says so."""
    from mvlpt_torch.core.resnet import RNConfig
    from mvlpt_torch.models.zsclip import encode_class_text_features

    _, _, j_cfg, t_params = sides
    with pytest.raises(ValueError, match="image features only"):
        encode_class_text_features(t_params, RNConfig(**dataclasses.asdict(j_cfg)), ["a"],
                                   ["a photo of a {}."])


def test_calibrated_bn_statistics_give_the_towers_trunk():
    """``calibrate_rn_bn`` (the smoke's calibrated RN50): it rewrites every
    BatchNorm's running statistics, and its own OpenAI-layout pass gives
    the trunk that the port's tower computes from the calibrated
    state_dict, within 1e-4 x max|ref|."""
    from mvlpt_torch.checkpoint.convert import convert_openai_rn_state_dict
    from mvlpt_torch.core.resnet import trunk_rn

    sd = openai_rn_state_dict(1, **TINY)
    images = torch.from_numpy(_images(seed=2, n=4))
    before = {k: v.clone() for k, v in sd.items() if ".running_" in k}
    want = calibrate_rn_bn(sd, images.permute(0, 3, 1, 2))
    assert before and all(not torch.equal(v, sd[k]) for k, v in before.items())
    backbone, _, _ = convert_openai_rn_state_dict(sd, device="cpu")
    got = trunk_rn(backbone["visual"], images)
    assert got.shape == want.shape == (4, 8 * 32, 2, 2)
    _close(got, want, 1e-4)
