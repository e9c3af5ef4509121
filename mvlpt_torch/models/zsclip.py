"""Zero-shot CLIP trainers (the reference's trainers/zsclip.py:32-99):
class text features from prompt templates, and the image path that
scores a batch against them.

The counterpart of ``mvlpt_tpu/models/zsclip.py``. The class text
features run through the plain text tower once (no kernel selection, as
on the JAX side) and are averaged over the templates; the image tower
runs under the ``USE_PALLAS`` selection in its no-grad form. The
trainers (``ZeroshotCLIP``: one hand-crafted template a dataset;
``ZeroshotCLIP2``: the 7 select templates and the dataset's own) test on
either universe's test split, through the classification evaluator.
An RN backbone serves image features only (``make_image_encoder``'s RN
branch); its text step raises, as the JAX package's fails (``text_config``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mvlpt_torch.core import clip as clip_core
from mvlpt_torch.core import vit as vit_mod
from mvlpt_torch.core.clip import CLIPConfig
from mvlpt_torch.core.resnet import RNConfig
from mvlpt_torch.data.loader import DeviceStager
from mvlpt_torch.data.transforms import device_normalize
from mvlpt_torch.data.elevater import load_metadata, template_map
from mvlpt_torch.evaluation import ClassificationEvaluator
from mvlpt_torch.ops.attention import select_attn_fn
from mvlpt_torch.tokenizer import tokenize
from mvlpt_torch.utils.device import resolve_device
from mvlpt_torch.utils.pipeline import pipelined_inference
from mvlpt_torch.utils.registry import TRAINER_REGISTRY

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


def imagenet_templates_full() -> list[str]:
    """The 80-template CLIP ImageNet pool (from this package's
    metadata.json)."""
    return list(template_map("imagenet-1k"))


def text_config(clip_cfg) -> CLIPConfig:
    """``clip_cfg`` where it configures a text tower. An RN backbone's
    ``RNConfig`` has no text fields, in the JAX package as here: there its
    text step fails on the missing attribute (``models/zsclip.py:72``,
    ``core/clip.py:182-184``); here it raises this error at the same point."""
    if isinstance(clip_cfg, RNConfig):
        raise ValueError(
            "an RN backbone gives image features only: its RNConfig has no text fields, as in "
            "the JAX package, whose text step fails at the same point (ROADMAP.md Queue 3, "
            "the reference-side RN text gap)")
    return clip_cfg


@torch.no_grad()
def encode_class_text_features(backbone: dict, clip_cfg: CLIPConfig, classnames, templates,
                               batch_classes: int = 512) -> torch.Tensor:
    """(n_cls, embed_dim) fp32 class text features: each template's
    features L2-normalised, averaged over the templates, normalised
    again."""
    clip_cfg = text_config(clip_cfg)
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


def make_image_encoder(clip_cfg, mean, std, use_pallas="auto"):
    """``encode(backbone, images) -> image features`` for no-grad callers
    (the encoder's output dtype, not normalised). On a ViT a uint8 batch
    has CLIP's normalisation folded into the patch embedding, a float
    batch is taken as normalised already, and the tower runs under the
    ``use_pallas`` selection with the no-grad kernels. An RN tower takes
    ``device_normalize`` (a uint8 batch normalised, a float one as it is),
    then its plain path: it has no kernels, in either package."""
    norm = (tuple(mean), tuple(std))
    if isinstance(clip_cfg, RNConfig):
        @torch.no_grad()
        def encode_rn(backbone, images):
            return clip_core.encode_image(backbone, device_normalize(images, *norm), clip_cfg)

        return encode_rn
    if not isinstance(clip_cfg, CLIPConfig):
        raise NotImplementedError(f"no image encoder for {type(clip_cfg).__name__}; only ViT "
                                  "(CLIPConfig) and ModifiedResNet (RNConfig)")
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


def make_zs_infer(clip_cfg, mean, std, use_pallas="auto"):
    """``infer(backbone, text_features, images) -> fp32 logits``: the
    zero-shot step, through :func:`make_image_encoder`."""
    encode = make_image_encoder(clip_cfg, mean, std, use_pallas)

    @torch.no_grad()
    def infer(backbone, text_features, images):
        img = encode(backbone, images).float()
        img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
        return torch.exp(backbone["logit_scale"].float()) * img @ text_features.t()

    return infer


class _ZeroshotBase:
    """The zero-shot trainer's surface (``train``, ``load_model``,
    ``test``), on ``device`` (the card unless the caller asks for the
    CPU). ``timings["tests"]`` records each test() pass's wall time and
    images on the host clock."""

    def __init__(self, cfg, device="cuda"):
        from mvlpt_torch.data.managers import build_data_manager
        from mvlpt_torch.train.trainer import load_clip_backbone

        self.cfg = cfg
        self.device = resolve_device(device)
        self._stager = DeviceStager(self.device)
        self.dm = build_data_manager(cfg)
        self.test_loader = self.dm.test_loader
        self.timings = {"tests": []}
        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.backbone, self.clip_cfg = load_clip_backbone(
            cfg, getattr(torch, cfg.TPU.PARAM_DTYPE), self.device)
        classnames = self.dm.classnames
        self.text_features = encode_class_text_features(
            self.backbone, self.clip_cfg, classnames, self.templates(classnames))
        self._infer = make_zs_infer(self.clip_cfg, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
                                    use_pallas=cfg.TPU.USE_PALLAS)

    def templates(self, classnames) -> list[str]:
        raise NotImplementedError

    def model_inference(self, images) -> torch.Tensor:
        images = self._stager({"image": np.asarray(images)})["image"]
        return self._infer(self.backbone, self.text_features, images)

    def train(self):
        print("ZeroshotCLIP has no training; running test()")
        return self.test()

    def load_model(self, directory, epoch=None):
        pass

    def test(self, split=None) -> float:
        evaluator = ClassificationEvaluator(self.dm.lab2cname)
        t0, images = time.perf_counter(), 0
        for logits, batch in pipelined_inference(
                self.test_loader, lambda b: self.model_inference(b["image"])):
            n_valid = batch.get("n_valid", len(batch["image"]))
            images += n_valid
            evaluator.process(logits[:n_valid], np.asarray(batch["label"])[:n_valid])
        self.timings["tests"].append({"split": "test", "wall_s": time.perf_counter() - t0,
                                      "images": images})
        results = evaluator.evaluate()
        print("results", results)
        return results["accuracy"]


@TRAINER_REGISTRY.register()
class ZeroshotCLIP(_ZeroshotBase):
    """Hand-crafted template zero-shot eval (zsclip.py:32-60): the CoOp
    dataset's template, else the ELEVATER task's first, else a photo."""

    def templates(self, classnames):
        name = self.cfg.DATASET.NAME or self.cfg.DATASET.DATASET
        if name in CUSTOM_TEMPLATES:
            return [CUSTOM_TEMPLATES[name]]
        if name in load_metadata():
            return [template_map(name)[0]]
        return ["a photo of a {}."]


@TRAINER_REGISTRY.register()
class ZeroshotCLIP2(_ZeroshotBase):
    """Template-ensembled zero-shot eval (zsclip.py:63-99): the 7 select
    templates, plus the dataset's own outside ImageNet."""

    def templates(self, classnames):
        temps = list(IMAGENET_TEMPLATES_SELECT)
        name = self.cfg.DATASET.NAME or self.cfg.DATASET.DATASET
        if name != "ImageNet" and name in CUSTOM_TEMPLATES:
            temps.append(CUSTOM_TEMPLATES[name])
        return temps
