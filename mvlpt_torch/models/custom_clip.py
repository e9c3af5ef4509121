"""The MVLPT model forward: frozen CLIP + prompt params -> logits.

The counterpart of ``mvlpt_tpu/models/custom_clip.py`` on its
non-CoCoOp branch: UPT coupling -> image tower with VPT injection ->
CoOp prompt assembly -> class-packed text tower -> normalised cosine
logits -> optional per-task logit masking. Gradients reach the prompt
params only: the backbone tensors do not require grad.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mvlpt_torch.core import clip as clip_core
from mvlpt_torch.core import text as text_mod
from mvlpt_torch.core import vit as vit_mod
from mvlpt_torch.core.clip import CLIPConfig
from mvlpt_torch.prompts import PromptConsts, PromptSpec, coop_assemble, upt_couple, vpt_prepare


@dataclasses.dataclass(frozen=True)
class TaskClassRanges:
    """Per-task class index ranges for multitask logit masking, indexed
    by task id."""

    start: torch.Tensor  # (n_tasks,)
    end: torch.Tensor    # (n_tasks,)

    def to(self, device) -> "TaskClassRanges":
        return TaskClassRanges(self.start.to(device), self.end.to(device))


class MVLPTModel(nn.Module):
    """Architecture + prompt spec + kernel selection (what
    ``ops.attention.select_attn_fn`` returns). Holds no tensors: the
    backbone, prompt params and consts are passed to each call."""

    def __init__(self, clip_cfg: CLIPConfig, spec: PromptSpec, kernels=None,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if spec.has_cocoop:
            raise NotImplementedError("CoCoOp is not ported yet (ROADMAP.md Queue 1)")
        self.clip_cfg = clip_cfg
        self.spec = spec
        self.kernels = kernels
        self.compute_dtype = compute_dtype

    def embed_image(self, backbone, images, normalize=None):
        """Frozen ViT stem only: (B, H, W, 3) -> (B, 1+N, width) tokens.
        ``normalize=(mean, std)`` folds uint8 -> CLIP normalisation into
        the patch-embed product."""
        return vit_mod.embed_image(backbone["visual"], images,
                                   patch_size=self.clip_cfg.vision_patch_size,
                                   normalize=normalize)

    def encode_image(self, backbone, prompt_params, images, vpt_shallow=None,
                     vpt_deep=None, pre_embedded=False):
        vpt_shallow, vpt_deep = vpt_prepare(prompt_params, self.spec, vpt_shallow, vpt_deep)
        if vpt_shallow is not None:
            vpt_shallow = vpt_shallow.to(self.compute_dtype)
        if vpt_deep is not None:
            vpt_deep = vpt_deep.to(self.compute_dtype)
        return vit_mod.encode_image(
            backbone["visual"], images, patch_size=self.clip_cfg.vision_patch_size,
            n_heads=self.clip_cfg.vision_heads, vpt_shallow=vpt_shallow,
            vpt_deep=vpt_deep, kernels=self.kernels, pre_embedded=pre_embedded)

    def encode_text_prompts(self, backbone, prompts, eot_idx):
        return text_mod.encode_text_embeds_packed(
            backbone["text"], prompts.to(self.compute_dtype), eot_idx,
            n_heads=self.clip_cfg.transformer_heads, kernels=self.kernels)

    def compute_text_features(self, backbone, prompt_params, consts: PromptConsts):
        """(n_cls, embed_dim) text features for the current prompts."""
        coop_ctx, _, _ = upt_couple(prompt_params, self.spec)
        prompts = coop_assemble(coop_ctx, consts, self.spec)
        return self.encode_text_prompts(backbone, prompts, consts.eot_idx)

    def forward_with_text(self, backbone: dict, prompt_params: dict, images: torch.Tensor,
                          text_features: torch.Tensor, tasks: torch.Tensor | None = None,
                          task_ranges: TaskClassRanges | None = None,
                          pre_embedded: bool = False) -> torch.Tensor:
        """Forward with precomputed text features (the eval fast path):
        the image tower and the logits only."""
        _, vpt_sh, vpt_dp = upt_couple(prompt_params, self.spec)
        image_features = self.encode_image(backbone, prompt_params, images, vpt_sh, vpt_dp,
                                           pre_embedded=pre_embedded)
        logits = clip_core.clip_logits(image_features, text_features, backbone["logit_scale"])
        return _apply_task_mask(logits, tasks, task_ranges)

    def forward(self, backbone: dict, prompt_params: dict, consts: PromptConsts,
                images: torch.Tensor, tasks: torch.Tensor | None = None,
                task_ranges: TaskClassRanges | None = None,
                pre_embedded: bool = False) -> torch.Tensor:
        """Full forward -> (B, n_cls) fp32 logits. ``pre_embedded``:
        ``images`` is the (B, 1+N, width) output of :meth:`embed_image`."""
        coop_ctx, vpt_sh, vpt_dp = upt_couple(prompt_params, self.spec)
        image_features = self.encode_image(backbone, prompt_params, images, vpt_sh, vpt_dp,
                                           pre_embedded=pre_embedded)
        prompts = coop_assemble(coop_ctx, consts, self.spec)
        text_features = self.encode_text_prompts(backbone, prompts, consts.eot_idx)
        logits = clip_core.clip_logits(image_features, text_features, backbone["logit_scale"])
        return _apply_task_mask(logits, tasks, task_ranges)


def _apply_task_mask(logits, tasks, task_ranges):
    """Zero logits outside each row's task class range (a multiply). The
    ranges must lie on the logits' device: the step builders put them
    there once (``train.train_step``), so no step copies them."""
    if tasks is None or task_ranges is None:
        return logits
    cls_idx = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    lo = task_ranges.start[tasks][:, None]
    hi = task_ranges.end[tasks][:, None]
    select = ((cls_idx >= lo) & (cls_idx < hi)).to(logits.dtype)
    return logits * select
