"""The MVLPT model forward: frozen CLIP + prompt params -> logits.

The counterpart of ``mvlpt_tpu/models/custom_clip.py``: UPT coupling ->
image tower with VPT injection -> CoOp prompt assembly -> class-packed
text tower -> normalised cosine logits -> optional per-task logit
masking. CoCoOp conditions the prompts on each image instead: the text
tower runs B x n_cls prompts, ``chunk`` images' class grids a call.
Gradients reach the prompt params only: the backbone tensors do not
require grad.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mvlpt_torch.core import clip as clip_core
from mvlpt_torch.core import text as text_mod
from mvlpt_torch.core import vit as vit_mod
from mvlpt_torch.core.clip import CLIPConfig
from mvlpt_torch.prompts import (
    PromptConsts,
    PromptSpec,
    cocoop_assemble,
    cocoop_condition,
    coop_assemble,
    upt_couple,
    vpt_prepare,
)


@dataclasses.dataclass(frozen=True)
class TaskClassRanges:
    """Per-task class index ranges for multitask logit masking, indexed
    by task id."""

    start: torch.Tensor  # (n_tasks,)
    end: torch.Tensor    # (n_tasks,)

    def to(self, device) -> "TaskClassRanges":
        return TaskClassRanges(self.start.to(device), self.end.to(device))


# CoCoOp's text-tower calls take at most this many conditioned rows
# (``_auto_chunk``), and each chunk's tower is checkpointed past
# COCOOP_REMAT_ROWS conditioned rows a batch (or under ``remat``), as the
# JAX package does.
COCOOP_CHUNK_ROWS = 4096
COCOOP_REMAT_ROWS = 8192


def _auto_chunk(batch: int, n_cls: int) -> int:
    """The largest divisor of ``batch`` with chunk * n_cls <=
    COCOOP_CHUNK_ROWS (1 when none is): CoCoOp's images a text-tower
    call."""
    best = 1
    for c in range(1, batch + 1):
        if batch % c == 0 and c * n_cls <= COCOOP_CHUNK_ROWS:
            best = c
    return best


class MVLPTModel(nn.Module):
    """Architecture + prompt spec + kernel selection (what
    ``ops.attention.select_attn_fn`` returns). Holds no tensors: the
    backbone, prompt params and consts are passed to each call.
    ``remat``: both towers checkpoint every block (TRAINER.ACT_CKPT > 1),
    and CoCoOp each chunk's text tower."""

    def __init__(self, clip_cfg: CLIPConfig, spec: PromptSpec, kernels=None,
                 compute_dtype: torch.dtype = torch.bfloat16, remat: bool = False):
        super().__init__()
        self.clip_cfg = clip_cfg
        self.spec = spec
        self.kernels = kernels
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.stems = vit_mod.FoldedStems()

    def embed_image(self, backbone, images, normalize=None):
        """Frozen ViT stem only: (B, H, W, 3) -> (B, 1+N, width) tokens.
        ``normalize=(mean, std)`` folds uint8 -> CLIP normalisation into
        the patch-embed product, folded once for each backbone
        (``vit.FoldedStems``)."""
        return vit_mod.embed_image(backbone["visual"], images,
                                   patch_size=self.clip_cfg.vision_patch_size,
                                   normalize=normalize, stems=self.stems)

    def encode_image(self, backbone, prompt_params, images, vpt_shallow=None,
                     vpt_deep=None, pre_embedded=False, rng=None):
        vpt_shallow, vpt_deep = vpt_prepare(prompt_params, self.spec, vpt_shallow, vpt_deep, rng)
        if vpt_shallow is not None:
            vpt_shallow = vpt_shallow.to(self.compute_dtype)
        if vpt_deep is not None:
            vpt_deep = vpt_deep.to(self.compute_dtype)
        return vit_mod.encode_image(
            backbone["visual"], images, patch_size=self.clip_cfg.vision_patch_size,
            n_heads=self.clip_cfg.vision_heads, vpt_shallow=vpt_shallow,
            vpt_deep=vpt_deep, kernels=self.kernels, pre_embedded=pre_embedded,
            remat=self.remat)

    def encode_text_prompts(self, backbone, prompts, eot_idx):
        return text_mod.encode_text_embeds_packed(
            backbone["text"], prompts.to(self.compute_dtype), eot_idx,
            n_heads=self.clip_cfg.transformer_heads, kernels=self.kernels, remat=self.remat)

    def compute_text_features(self, backbone, prompt_params, consts: PromptConsts):
        """(n_cls, embed_dim) text features for the current prompts. Not
        for CoCoOp, whose text features depend on the image."""
        if self.spec.has_cocoop:
            raise ValueError("CoCoOp text features are image-conditioned")
        coop_ctx, _, _ = upt_couple(prompt_params, self.spec)
        prompts = coop_assemble(coop_ctx, consts, self.spec)
        return self.encode_text_prompts(backbone, prompts, consts.eot_idx)

    def forward_with_text(self, backbone: dict, prompt_params: dict, images: torch.Tensor,
                          text_features: torch.Tensor, tasks: torch.Tensor | None = None,
                          task_ranges: TaskClassRanges | None = None,
                          pre_embedded: bool = False, rng=None) -> torch.Tensor:
        """Forward with precomputed text features: the image tower and the
        logits only (the eval fast path with ``rng`` None, and a pure-VPT
        window's train steps)."""
        _, vpt_sh, vpt_dp = upt_couple(prompt_params, self.spec)
        image_features = self.encode_image(backbone, prompt_params, images, vpt_sh, vpt_dp,
                                           pre_embedded=pre_embedded, rng=rng)
        logits = clip_core.clip_logits(image_features, text_features, backbone["logit_scale"])
        return _apply_task_mask(logits, tasks, task_ranges)

    def forward(self, backbone: dict, prompt_params: dict, consts: PromptConsts,
                images: torch.Tensor, tasks: torch.Tensor | None = None,
                task_ranges: TaskClassRanges | None = None,
                pre_embedded: bool = False, rng=None) -> torch.Tensor:
        """Full forward -> (B, n_cls) fp32 logits. ``pre_embedded``:
        ``images`` is the (B, 1+N, width) output of :meth:`embed_image`.
        ``rng``: the train step's VPT dropout key (``layers.dropout_key``),
        None at eval."""
        coop_ctx, vpt_sh, vpt_dp = upt_couple(prompt_params, self.spec)
        image_features = self.encode_image(backbone, prompt_params, images, vpt_sh, vpt_dp,
                                           pre_embedded=pre_embedded, rng=rng)
        if self.spec.has_cocoop:
            logits = self._cocoop_logits(backbone, prompt_params, consts, image_features)
        else:
            prompts = coop_assemble(coop_ctx, consts, self.spec)
            text_features = self.encode_text_prompts(backbone, prompts, consts.eot_idx)
            logits = clip_core.clip_logits(image_features, text_features,
                                           backbone["logit_scale"])
        return _apply_task_mask(logits, tasks, task_ranges)

    def _cocoop_logits(self, backbone, prompt_params, consts, image_features):
        """CoCoOp's (B, n_cls) fp32 logits: every image shifts the context
        by its meta-net bias, and the text tower runs that image's whole
        class grid. ``_auto_chunk``'s images' grids go through one
        text-tower call of chunk x n_cls prompts, a Python loop over the
        B / chunk chunks.
        Past COCOOP_REMAT_ROWS conditioned rows (or under ``remat``) each
        chunk's tower is checkpointed whole: the backward runs the chunk's
        forward again, so at most one chunk's residuals are alive. The
        recompute is deterministic, so the values equal those without
        checkpointing bit for bit."""
        spec = self.spec
        img = image_features.float()
        img_n = img / torch.linalg.norm(img, dim=-1, keepdim=True)
        ctx = cocoop_condition(prompt_params, spec, img_n)  # (B, n_ctx, Wt)
        b, n_cls = ctx.shape[0], spec.n_cls
        chunk = _auto_chunk(b, n_cls)
        eot = consts.eot_idx.repeat(chunk)

        def chunk_features(ctx_c):
            prompts = cocoop_assemble(ctx_c, consts)
            tf = self.encode_text_prompts(backbone, prompts, eot).float()
            tf = tf / torch.linalg.norm(tf, dim=-1, keepdim=True)
            return tf.reshape(chunk, n_cls, -1)

        remat = torch.is_grad_enabled() and (b * n_cls > COCOOP_REMAT_ROWS or self.remat)
        feats = []
        for ctx_c in ctx.split(chunk):
            if remat:
                # No RNG runs in the tower, so none is saved (a CUDA-graph
                # capture may not read the generator's state).
                feats.append(checkpoint(chunk_features, ctx_c, use_reentrant=False,
                                        preserve_rng_state=False))
            else:
                feats.append(chunk_features(ctx_c))
        text_features = torch.cat(feats)  # (B, n_cls, E)
        scale = torch.exp(backbone["logit_scale"].float())
        return scale * torch.einsum("be,bce->bc", img_n, text_features)


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
