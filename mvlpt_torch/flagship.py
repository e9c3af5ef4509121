"""The flagship model: MVLPT UPT (CoOp + deep VPT + coupler) on a frozen
ViT-B/16 CLIP, the counterpart of ``_flagship`` in the JAX package's
``__graft_entry__.py``.

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
