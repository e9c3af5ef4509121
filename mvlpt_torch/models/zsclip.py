"""Zero-shot CLIP: class text features from prompt templates, and the
image path that scores a batch against them.

The counterpart of ``mvlpt_tpu/models/zsclip.py:22-140``. The class
text features run through the plain text tower once (no kernel
selection, as on the JAX side) and are averaged over the templates; the
image tower runs under the ``USE_PALLAS`` selection in its no-grad form.
The trainers around them (``ZeroshotCLIP``, ``ZeroshotCLIP2``) and the
80-template pool wait for the port's trainer and data manager.
"""

from __future__ import annotations

import torch

from mvlpt_torch.core import clip as clip_core
from mvlpt_torch.core import vit as vit_mod
from mvlpt_torch.core.clip import CLIPConfig
from mvlpt_torch.ops.attention import select_attn_fn
from mvlpt_torch.tokenizer import tokenize

# The standard public CLIP evaluation templates.
CUSTOM_TEMPLATES = {
    "OxfordPets": "a photo of a {}, a type of pet.",
    "OxfordFlowers": "a photo of a {}, a type of flower.",
    "FGVCAircraft": "a photo of a {}, a type of aircraft.",
    "DescribableTextures": "{} texture.",
    "EuroSAT": "a centered satellite photo of {}.",
    "StanfordCars": "a photo of a {}.",
    "Food101": "a photo of {}, a type of food.",
    "SUN397": "a photo of a {}.",
    "Caltech101": "a photo of a {}.",
    "UCF101": "a photo of a person doing {}.",
    "ImageNet": "a photo of a {}.",
    "ImageNetSketch": "a photo of a {}.",
    "ImageNetV2": "a photo of a {}.",
    "ImageNetA": "a photo of a {}.",
    "ImageNetR": "a photo of a {}.",
}

IMAGENET_TEMPLATES_SELECT = [
    "itap of a {}.",
    "a bad photo of the {}.",
    "a origami {}.",
    "a photo of the large {}.",
    "a {} in a video game.",
    "art of the {}.",
    "a photo of the small {}.",
]


@torch.no_grad()
def encode_class_text_features(backbone: dict, clip_cfg: CLIPConfig, classnames, templates,
                               batch_classes: int = 512) -> torch.Tensor:
    """(n_cls, embed_dim) fp32 class text features: each template's
    features L2-normalised, averaged over the templates, normalised
    again."""
    device = backbone["text"]["token_embedding"].device
    mean_features = 0.0
    for temp in templates:
        prompts = [temp.format(c.replace("_", " ")) for c in classnames]
        ids = torch.from_numpy(tokenize(prompts, context_length=clip_cfg.context_length))
        ids = ids.to(device)
        f = torch.cat([clip_core.encode_text(backbone, ids[i:i + batch_classes], clip_cfg)
                       for i in range(0, len(ids), batch_classes)]).float()
        mean_features = mean_features + f / torch.linalg.norm(f, dim=-1, keepdim=True)
    mean_features = mean_features / len(templates)
    return mean_features / torch.linalg.norm(mean_features, dim=-1, keepdim=True)


def make_image_encoder(clip_cfg: CLIPConfig, mean, std, use_pallas="auto"):
    """``encode(backbone, images) -> image features`` for no-grad callers
    (the encoder's output dtype, not normalised). A uint8 batch has
    CLIP's normalisation folded into the patch embedding; a float batch
    is taken as normalised already. The tower runs under the
    ``use_pallas`` selection with the no-grad kernels."""
    if not isinstance(clip_cfg, CLIPConfig):
        raise NotImplementedError(
            f"zero-shot for {type(clip_cfg).__name__} is not ported; only ViT (CLIPConfig)")
    norm = (tuple(mean), tuple(std))
    kernels = select_attn_fn(use_pallas, inference=True)
    stems = vit_mod.FoldedStems()

    @torch.no_grad()
    def encode(backbone, images):
        if images.dtype == torch.uint8:
            tokens = vit_mod.embed_image(backbone["visual"], images,
                                         patch_size=clip_cfg.vision_patch_size, normalize=norm,
                                         stems=stems)
            return clip_core.encode_image(backbone, tokens, clip_cfg, pre_embedded=True,
                                          kernels=kernels)
        return clip_core.encode_image(backbone, images, clip_cfg, kernels=kernels)

    return encode


def make_zs_infer(clip_cfg: CLIPConfig, mean, std, use_pallas="auto"):
    """``infer(backbone, text_features, images) -> fp32 logits``: the
    zero-shot step, through :func:`make_image_encoder`."""
    encode = make_image_encoder(clip_cfg, mean, std, use_pallas)

    @torch.no_grad()
    def infer(backbone, text_features, images):
        img = encode(backbone, images).float()
        img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
        return torch.exp(backbone["logit_scale"].float()) * img @ text_features.t()

    return infer
