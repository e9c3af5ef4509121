"""The port's zero-shot path against the JAX package, fp32 on the CPU:
class text features over templates, and the zero-shot step on uint8
and float batches under each kernel selection (the JAX side in
interpret mode, with the selection passed explicitly). Features and
logits are held to 1e-5 and 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)

from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD

DIMS = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
            vision_patch_size=8, transformer_width=64, transformer_heads=2,
            transformer_layers=2, vision_heads_override=2)
CLASSNAMES = [f"class_{i}" for i in range(5)]
TEMPLATES = ["a photo of a {}.", "a bad photo of the {}."]


@pytest.fixture(scope="module")
def clips(synthetic_vocab):  # noqa: F811
    from mvlpt_tpu.core.clip import CLIPConfig as JCfg, init_clip_params
    from mvlpt_torch.checkpoint import backbone_from_jax
    from mvlpt_torch.core.clip import CLIPConfig

    j_backbone = init_clip_params(jax.random.PRNGKey(0), JCfg(**DIMS))
    backbone = backbone_from_jax(jax.tree_util.tree_map(np.asarray, j_backbone), "cpu")
    return (j_backbone, JCfg(**DIMS)), (backbone, CLIPConfig(**DIMS))


def test_templates_match():
    from mvlpt_tpu.models import zsclip as jzs
    from mvlpt_torch.models import zsclip

    assert zsclip.CUSTOM_TEMPLATES == jzs.CUSTOM_TEMPLATES
    assert zsclip.IMAGENET_TEMPLATES_SELECT == jzs.IMAGENET_TEMPLATES_SELECT


def test_class_text_features_match(clips):
    from mvlpt_tpu.models.zsclip import encode_class_text_features as j_encode
    from mvlpt_torch.models.zsclip import encode_class_text_features

    (j_backbone, j_cfg), (backbone, cfg) = clips
    want = np.asarray(j_encode(j_backbone, j_cfg, CLASSNAMES, TEMPLATES))
    got = encode_class_text_features(backbone, cfg, CLASSNAMES, TEMPLATES, batch_classes=3)
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)


def test_encode_text_takes_eot_at_the_argmax(clips):
    from mvlpt_tpu.core import clip as jclip
    from mvlpt_torch.core import clip as tclip
    from mvlpt_torch.tokenizer import tokenize

    (j_backbone, j_cfg), (backbone, cfg) = clips
    ids = tokenize([t.format("dog") for t in TEMPLATES])
    want = np.asarray(jclip.encode_text(j_backbone, jnp.asarray(ids), j_cfg))
    got = tclip.encode_text(backbone, torch.from_numpy(ids), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_device_normalize_matches():
    from mvlpt_tpu.data.transforms import device_normalize as j_norm
    from mvlpt_torch.data import device_normalize

    u8 = np.random.RandomState(2).randint(0, 256, (2, 4, 4, 3)).astype(np.uint8)
    want = np.asarray(j_norm(jnp.asarray(u8), CLIP_PIXEL_MEAN, CLIP_PIXEL_STD))
    got = device_normalize(torch.from_numpy(u8), CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    x = torch.zeros(2, 3)
    assert device_normalize(x, CLIP_PIXEL_MEAN, CLIP_PIXEL_STD) is x


@pytest.mark.parametrize("pixels", ["uint8", "float"])
@pytest.mark.parametrize("selection", ["block", "on", "off"])
def test_zs_infer_matches(clips, selection, pixels):
    from mvlpt_tpu.models.zsclip import make_zs_infer as j_make
    from mvlpt_torch.data import device_normalize
    from mvlpt_torch.models.zsclip import make_zs_infer

    (j_backbone, j_cfg), (backbone, cfg) = clips
    rng = np.random.RandomState(3)
    text = rng.randn(len(CLASSNAMES), DIMS["embed_dim"]).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    u8 = torch.from_numpy(rng.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8))
    images = u8 if pixels == "uint8" else device_normalize(u8, CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)
    want = np.asarray(j_make(j_cfg, CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, use_pallas=selection)(
        j_backbone, jnp.asarray(text), jnp.asarray(images.numpy())))
    infer = make_zs_infer(cfg, CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, use_pallas=selection)
    got = infer(backbone, torch.from_numpy(text), images)
    assert got.shape == (3, len(CLASSNAMES)) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_only_vit_is_ported():
    from mvlpt_torch.core import clip as tclip
    from mvlpt_torch.models.zsclip import make_zs_infer

    class RNLike:
        pass

    with pytest.raises(NotImplementedError, match="only ViT"):
        make_zs_infer(RNLike(), CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)
    with pytest.raises(NotImplementedError, match="only ViT"):
        tclip.encode_image({}, torch.zeros(1, 8, 8, 3), RNLike())
