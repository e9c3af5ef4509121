"""The flagship model: MVLPT UPT (CoOp + deep VPT + coupler) on a frozen
ViT-B/16 CLIP, the counterpart of ``_flagship`` in the JAX package's
``__graft_entry__.py``, and its tiny rehearsal towers (``tiny_flagship``,
the counterpart of ``_tiny_flagship`` there).

CoOp context 4 with the class token in the middle, deep VPT context 4,
a 1-layer fp32 coupler at dim 128; random weights from fixed seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from mvlpt_torch.core.clip import CLIPConfig, cast_backbone, init_clip_params
from mvlpt_torch.models.custom_clip import MVLPTModel
from mvlpt_torch.ops.attention import select_attn_fn
from mvlpt_torch.parallel.mesh import local_batch, shard_backbone
from mvlpt_torch.prompts import (
    PromptSpec,
    build_prompt_consts,
    compute_cut_context_length,
    init_prompt_params,
)
from mvlpt_torch.utils.device import resolve_device

# CLIP's pixel normalisation, (mean, std) per RGB channel.
CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


def flagship(n_cls: int = 100, batch: int = 32, compute_dtype=torch.bfloat16,
             backbone_name: str = "ViT-B/16", kernels: str = "auto",
             device="cuda", mesh=None, clip_cfg: CLIPConfig | None = None):
    """-> (model, backbone, prompt_params, consts, images, clip_cfg).

    ``kernels`` is the ``USE_PALLAS`` selection ('auto', 'block', 'on'
    or 'off'; ``ops.attention.select_attn_fn``). ``images`` are (batch,
    224, 224, 3) fp32 from a fixed numpy seed. Runs on the card unless
    ``device='cpu'``. Under ``mesh`` (``parallel.Mesh``) the backbone is
    this rank's shard, the images its data rank's rows, and the model's
    kernels run under the mesh. ``clip_cfg`` replaces ``backbone_name``'s
    configuration (a smaller tower of the same UPT model)."""
    device = resolve_device(device)
    clip_cfg = clip_cfg or CLIPConfig.for_backbone(backbone_name)
    backbone = cast_backbone(
        init_clip_params(torch.Generator().manual_seed(0), clip_cfg, device=device),
        compute_dtype)
    classnames = [f"class number {i}" for i in range(n_cls)]
    spec = PromptSpec(
        n_cls=n_cls, coop_n_ctx=4, vpt_n_ctx=4, vpt_deep=True,
        class_token_position="middle", project_method="transformer", project_dim=128,
        context_length=compute_cut_context_length(classnames, 4),
        vision_layers=clip_cfg.vision_layers, vision_width=clip_cfg.vision_width,
        text_width=clip_cfg.transformer_width, embed_dim=clip_cfg.embed_dim,
        vision_patch_size=clip_cfg.vision_patch_size)
    prompt_params = init_prompt_params(torch.Generator().manual_seed(1), spec, device=device)
    consts = build_prompt_consts(classnames, spec, backbone, compute_dtype)
    model = MVLPTModel(clip_cfg, spec, kernels=select_attn_fn(kernels, mesh=mesh),
                       compute_dtype=compute_dtype)
    res = clip_cfg.image_resolution
    images = torch.from_numpy(
        np.random.RandomState(0).randn(batch, res, res, 3).astype(np.float32)).to(device)
    if mesh is not None:
        backbone, images = shard_backbone(backbone, clip_cfg, mesh), local_batch(images, mesh)
    return model, backbone, prompt_params, consts, images, clip_cfg


def tiny_flagship(n_cls: int = 8, compute_dtype=torch.float32, l14_shaped: bool = False,
                  kernels: str = "off", device="cuda", weights: tuple | None = None):
    """-> (model, backbone, prompt_params, consts, clip_cfg): the tiny CLIP
    and UPT towers of the JAX package's rehearsals, with its dims: a
    2-layer ViT (patch 8 at 32 px, width 64 and 2 heads, or with
    ``l14_shaped`` width 256 and 4 heads, head width 64 like ViT-L/14), a
    2-layer text tower of width 64 (128) and 2 heads, embed 32; CoOp 2
    'middle', deep VPT 2, a coupler at dim 16, context length 8, class
    names "c0", "c1", .... The backbone stays fp32 (the model casts each
    weight to ``compute_dtype`` where it is used) and the consts are in
    ``compute_dtype``. ``kernels`` is the ``USE_PALLAS`` selection
    (``ops.attention.select_attn_fn``; the JAX function leaves its model
    on the plain path, 'off'). ``weights`` = (backbone, prompt_params),
    fp32 trees in place of the port's seeded init: the JAX package's,
    carried across by ``checkpoint.from_jax``. Runs on the card unless
    ``device='cpu'``."""
    device = resolve_device(device)
    vw, tw, heads = (256, 128, 4) if l14_shaped else (64, 64, 2)
    seed = 2 if l14_shaped else 0
    clip_cfg = CLIPConfig(
        embed_dim=32, image_resolution=32, vision_layers=2, vision_width=vw,
        vision_patch_size=8, transformer_width=tw, transformer_heads=2,
        transformer_layers=2, vision_heads_override=heads)
    classnames = [f"c{i}" for i in range(n_cls)]
    spec = PromptSpec(
        n_cls=n_cls, coop_n_ctx=2, vpt_n_ctx=2, vpt_deep=True,
        class_token_position="middle", project_method="transformer", project_dim=16,
        context_length=8, vision_layers=2, vision_width=vw, text_width=tw, embed_dim=32,
        vision_patch_size=8)
    if weights is None:
        backbone = init_clip_params(torch.Generator().manual_seed(seed), clip_cfg, device=device)
        prompt_params = init_prompt_params(torch.Generator().manual_seed(seed + 1), spec,
                                           device=device)
    else:
        backbone, prompt_params = weights
    consts = build_prompt_consts(classnames, spec, backbone, compute_dtype)
    model = MVLPTModel(clip_cfg, spec, kernels=select_attn_fn(kernels),
                       compute_dtype=compute_dtype)
    return model, backbone, prompt_params, consts, clip_cfg
