"""CLIP model: config, parameter schema, initialization, and logits.

The counterpart of ``mvlpt_tpu/core/clip.py``, with the same parameter
schema (every linear kernel is right-multiplied, (in, out); block
parameters are stacked on a leading layer axis L):

  params = {
    "visual": {
      "patch_embed": {"kernel": (P*P*3, W)},
      "class_embedding": (W,), "pos_embedding": (1+N, W),
      "ln_pre": {"scale","bias"},
      "blocks": {stacked over L:
        "ln_1"/"ln_2": {"scale": (L,W), "bias": (L,W)},
        "attn": {"qkv_w": (L,W,3W), "qkv_b": (L,3W),
                  "out_w": (L,W,W), "out_b": (L,W)},
        "mlp": {"fc_w": (L,W,4W), "fc_b": (L,4W),
                 "proj_w": (L,4W,W), "proj_b": (L,W)}},
      "ln_post": {"scale","bias"}, "proj": (W, E),
    },
    "text": {
      "token_embedding": (V, Wt), "pos_embedding": (77, Wt),
      "blocks": {... stacked over Lt ...},
      "ln_final": {"scale","bias"}, "text_projection": (Wt, E),
    },
    "logit_scale": (),   # ln(1/0.07) at init
  }
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mvlpt_torch.core import text as text_mod
from mvlpt_torch.core import vit as vit_mod
from mvlpt_torch.utils.device import resolve_device
from mvlpt_torch.utils.tree import tree_map

# Architecture tables for the released CLIP ViT models.
VIT_ARCHS = {
    "ViT-B/32": dict(embed_dim=512, image_resolution=224, vision_layers=12,
                     vision_width=768, vision_patch_size=32),
    "ViT-B/16": dict(embed_dim=512, image_resolution=224, vision_layers=12,
                     vision_width=768, vision_patch_size=16),
    "ViT-L/14": dict(embed_dim=768, image_resolution=224, vision_layers=24,
                     vision_width=1024, vision_patch_size=14),
    "ViT-L/14@336px": dict(embed_dim=768, image_resolution=336, vision_layers=24,
                           vision_width=1024, vision_patch_size=14),
}
_TEXT_ARCHS = {
    512: dict(transformer_width=512, transformer_heads=8, transformer_layers=12),
    768: dict(transformer_width=768, transformer_heads=12, transformer_layers=12),
}


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 16
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    # 0 = OpenAI rule (width // 64); HF checkpoints carry an explicit count.
    vision_heads_override: int = 0

    @property
    def vision_heads(self) -> int:
        return self.vision_heads_override or self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @staticmethod
    def for_backbone(name: str, **overrides) -> "CLIPConfig":
        if name not in VIT_ARCHS:
            raise KeyError(f"Unknown/unsupported backbone {name!r}; ViT backbones: "
                           f"{sorted(VIT_ARCHS)}")
        arch = dict(VIT_ARCHS[name])
        arch.update(_TEXT_ARCHS[arch["embed_dim"]])
        arch.update(overrides)
        return CLIPConfig(**arch)


def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def init_block_stack(gen: torch.Generator, n_layers: int, width: int) -> dict:
    """CLIP's transformer init: normal weights with width-dependent std,
    zero biases, unit LN scales."""
    proj_std = (width ** -0.5) * ((2 * n_layers) ** -0.5)
    attn_std = width ** -0.5
    fc_std = (2 * width) ** -0.5

    def ln():
        return {"scale": torch.ones(n_layers, width), "bias": torch.zeros(n_layers, width)}

    return {
        "ln_1": ln(),
        "attn": {
            "qkv_w": _normal(gen, (n_layers, width, 3 * width), attn_std),
            "qkv_b": torch.zeros(n_layers, 3 * width),
            "out_w": _normal(gen, (n_layers, width, width), proj_std),
            "out_b": torch.zeros(n_layers, width),
        },
        "ln_2": ln(),
        "mlp": {
            "fc_w": _normal(gen, (n_layers, width, 4 * width), fc_std),
            "fc_b": torch.zeros(n_layers, 4 * width),
            "proj_w": _normal(gen, (n_layers, 4 * width, width), proj_std),
            "proj_b": torch.zeros(n_layers, width),
        },
    }


def init_clip_params(gen: torch.Generator, cfg: CLIPConfig, dtype=torch.float32,
                     device="cuda") -> dict:
    """Random-init CLIP params, drawn on the host from ``gen`` (so a seed
    gives the same weights on every device) and moved to ``device``."""
    device = resolve_device(device)
    vw, tw = cfg.vision_width, cfg.transformer_width
    n_patches = cfg.grid_size ** 2
    params = {
        "visual": {
            "patch_embed": {"kernel": _normal(gen, (cfg.vision_patch_size ** 2 * 3, vw),
                                              vw ** -0.5)},
            "class_embedding": _normal(gen, (vw,), vw ** -0.5),
            "pos_embedding": _normal(gen, (1 + n_patches, vw), vw ** -0.5),
            "ln_pre": {"scale": torch.ones(vw), "bias": torch.zeros(vw)},
            "blocks": init_block_stack(gen, cfg.vision_layers, vw),
            "ln_post": {"scale": torch.ones(vw), "bias": torch.zeros(vw)},
            "proj": _normal(gen, (vw, cfg.embed_dim), vw ** -0.5),
        },
        "text": {
            "token_embedding": _normal(gen, (cfg.vocab_size, tw), 0.02),
            "pos_embedding": _normal(gen, (cfg.context_length, tw), 0.01),
            "blocks": init_block_stack(gen, cfg.transformer_layers, tw),
            "ln_final": {"scale": torch.ones(tw), "bias": torch.zeros(tw)},
            "text_projection": _normal(gen, (tw, cfg.embed_dim), tw ** -0.5),
        },
        "logit_scale": torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32),
    }
    return tree_map(lambda t: t.to(device=device, dtype=dtype), params)


def cast_backbone(params: dict, dtype) -> dict:
    """Cast backbone params to a storage dtype, keeping logit_scale fp32."""
    out = tree_map(lambda t: t.to(dtype), params)
    out["logit_scale"] = params["logit_scale"].float()
    return out


def encode_image(params: dict, images: torch.Tensor, cfg: CLIPConfig, **kw) -> torch.Tensor:
    """Visual-tower dispatch. ViT only: the ModifiedResNet tower of the JAX
    package (its ``RNConfig``) is not ported yet (ROADMAP.md Queue 1)."""
    if not isinstance(cfg, CLIPConfig):
        raise NotImplementedError(
            f"visual tower for {type(cfg).__name__} is not ported; only ViT (CLIPConfig)")
    return vit_mod.encode_image(params["visual"], images, patch_size=cfg.vision_patch_size,
                                n_heads=cfg.vision_heads, **kw)


def encode_text(params: dict, token_ids: torch.Tensor, cfg: CLIPConfig, **kw) -> torch.Tensor:
    return text_mod.encode_text(params["text"], token_ids, n_heads=cfg.transformer_heads, **kw)


def clip_logits(image_features, text_features, logit_scale) -> torch.Tensor:
    """L2-normalize both sides, scale by exp(logit_scale). fp32."""
    img = image_features.float()
    txt = text_features.float()
    img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
    return torch.exp(logit_scale.float()) * img @ txt.t()
