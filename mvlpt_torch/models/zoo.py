"""``get_model``: the feature-extraction model zoo by name.

The counterpart of ``mvlpt_tpu/models/zoo.py`` (the reference's
trainers/vision_benchmark/evaluation/feature.py:245-321), with its
dispatch order and error messages, returning a frozen feature extractor:

* torchvision ResNet names (``resnet18/34/50/101/152``): the pooled
  ``EvalModel`` cut, classifier dropped (core/zoo.py).
* ``vit_*`` / ``deit_*``: timm ``forward_features``; ``mae_*`` /
  ``mocov3_*`` load their checkpoints into the same module (the
  reference's own branches for them name modules that are never
  imported).
* ``efficientnet*``: timm's native efficientnets (core/efficientnet.py);
  ``tf_efficientnet*`` is refused (TensorFlow's asymmetric padding).
* Other timm families raise the reference's "Please define ..."; the
  ``declip_``/``slip_``/``filip_``/``defilip_``/``cls_``/``clip_yfcc_``
  branches, dead in the reference, are refused.
* Anything else is a CLIP name (``ViT-B/32``, ``clip_*``): the CLIP
  towers through ``checkpoint.convert.load_clip``, ``feature_type``
  choosing the image or the text encoder.

Checkpoints are local ``torch.save`` files (nothing is downloaded);
``checkpoint=None`` gives a random tree of the right shapes, drawn from
``torch.Generator().manual_seed(0)`` (not the JAX package's draws). The
zoo runs no kernel of the repo, as no Pallas runs in the JAX zoo.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch

from mvlpt_torch.core import zoo as zoo_core
from mvlpt_torch.utils.device import resolve_device

__all__ = ["ZooModel", "get_model"]


@dataclasses.dataclass(frozen=True)
class ZooModel:
    """A frozen feature extractor: ``features(images)`` maps (B, H, W, 3)
    preprocessed floats on the model's device to (B, D) features."""
    name: str
    features: Callable
    params: dict
    input_resolution: int
    feature_dim: int
    # torchvision/timm models use ImageNet's normalization, CLIP its own
    pixel_mean: tuple
    pixel_std: tuple


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _load_torch_checkpoint(path: str) -> dict:
    # weights_only=False, as the JAX package loads them: MoCo-v3 files hold
    # non-tensor objects (the args namespace, the optimizer's state).
    return torch.load(path, map_location="cpu", weights_only=False)


def _std_vit_model(name, checkpoint, dtype, device):
    from mvlpt_torch.checkpoint.zoo_convert import convert_std_vit

    base = name
    for prefix in ("mae_", "mocov3_"):
        if base.startswith(prefix):
            base = base[len(prefix):]
    if checkpoint is not None:
        params, cfg = convert_std_vit(_load_torch_checkpoint(checkpoint), dtype, device)
    else:
        if base not in zoo_core.STD_VIT_CONFIGS:
            raise ValueError(f"unknown ViT variant {name!r}; known: "
                             f"{sorted(zoo_core.STD_VIT_CONFIGS)} (or pass checkpoint=)")
        cfg = zoo_core.STD_VIT_CONFIGS[base]
        params = zoo_core.init_std_vit_params(torch.Generator().manual_seed(0), cfg, dtype,
                                              device)

    def features(images, params=params, cfg=cfg):
        return zoo_core.std_vit_features(params, images, cfg)

    return ZooModel(name, features, params, cfg.input_resolution, cfg.width,
                    _IMAGENET_MEAN, _IMAGENET_STD)


def _tv_resnet_model(name, checkpoint, dtype, device):
    from mvlpt_torch.checkpoint.zoo_convert import convert_tv_resnet

    if checkpoint is not None:
        params, cfg = convert_tv_resnet(_load_torch_checkpoint(checkpoint), dtype, device)
    else:
        cfg = zoo_core.TV_RESNET_CONFIGS[name]
        params = zoo_core.init_tv_resnet_params(torch.Generator().manual_seed(0), cfg, dtype,
                                                device)
    dim = cfg.width * 8 * (4 if cfg.bottleneck else 1)

    def features(images, params=params, cfg=cfg):
        return zoo_core.tv_resnet_features(params, images, cfg)

    return ZooModel(name, features, params, 224, dim, _IMAGENET_MEAN, _IMAGENET_STD)


def _effnet_model(name, checkpoint, dtype, device):
    from mvlpt_torch.checkpoint.zoo_convert import convert_effnet
    from mvlpt_torch.core import efficientnet as eff

    if checkpoint is not None:
        params, cfg = convert_effnet(_load_torch_checkpoint(checkpoint), dtype, device)
    else:
        if name not in eff.EFFNET_CONFIGS:
            raise ValueError(f"unknown efficientnet variant {name!r}; known: "
                             f"{sorted(eff.EFFNET_CONFIGS)} (or pass checkpoint=)")
        cfg = eff.EFFNET_CONFIGS[name]
        params = eff.init_effnet_params(torch.Generator().manual_seed(0), cfg, dtype, device)

    def features(images, params=params, cfg=cfg):
        return eff.effnet_features(params, images, cfg)

    return ZooModel(name, features, params, cfg.input_resolution, cfg.head_ch,
                    _IMAGENET_MEAN, _IMAGENET_STD)


def _clip_model(name, checkpoint, dtype, feature_type, device):
    from mvlpt_torch.checkpoint.convert import load_clip
    from mvlpt_torch.core import clip as clip_core
    from mvlpt_torch.data.transforms import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD

    clip_name = name[len("clip_"):] if name.startswith("clip_") else name
    source = checkpoint or os.environ.get("MVLPT_TPU_CLIP_CKPT") or clip_name
    params, cfg = load_clip(source, dtype=dtype, device=device)

    if feature_type == "image":
        def features(images, params=params, cfg=cfg):
            return clip_core.encode_image(params, images, cfg)
    elif feature_type == "text":
        def features(tokens, params=params, cfg=cfg):
            return clip_core.encode_text(params, tokens, cfg)
    else:
        raise ValueError(f"Incorrect model type {feature_type!r}.")
    return ZooModel(name, features, params, cfg.image_resolution, cfg.embed_dim,
                    CLIP_PIXEL_MEAN, CLIP_PIXEL_STD)


def get_model(name: str, checkpoint: str | None = None, dtype=torch.float32,
              feature_type: str = "image", device="cuda") -> ZooModel:
    """Dispatch by name (feature.py:245-321's contract), the model's
    weights in ``dtype`` on ``device`` (the card unless the CPU is asked
    for)."""
    device = resolve_device(device)
    if name in zoo_core.TV_RESNET_CONFIGS:
        return _tv_resnet_model(name, checkpoint, dtype, device)
    if (name.startswith("vit_") or name.startswith("deit_")
            or name.startswith("mae_") or name.startswith("mocov3_")):
        return _std_vit_model(name, checkpoint, dtype, device)
    if name.startswith("efficientnet"):
        return _effnet_model(name, checkpoint, dtype, device)
    if name.startswith("tf_efficientnet"):
        raise ValueError(
            f"{name!r}: TF-padded efficientnet checkpoints use asymmetric "
            "SAME padding — load the native timm 'efficientnet_*' "
            "checkpoints instead")
    if any(name.startswith(p) for p in
           ("resnest", "regnet", "mixnet", "mobilenet", "convnext")):
        raise ValueError(
            "Please define a Timm feature-extraction model "
            f"({name!r}: the reference's timm branch raises the same for "
            "families outside efficientnet/vit/deit, feature.py:258)")
    if (name.startswith("declip_") or name.startswith("slip_")
            or name.startswith("filip_") or name.startswith("defilip_")
            or name.startswith("cls_") or name.startswith("clip_yfcc_")):
        raise ValueError(
            f"{name!r}: the reference's branch for this family references "
            "modules that are never imported (feature.py:263-287, dead "
            "in-tree); DeCLIP-family CLIP-architecture checkpoints can be "
            "loaded through the CLIP path instead")
    return _clip_model(name, checkpoint, dtype, feature_type, device)
