"""The train step: forward both towers, soft-label cross-entropy,
backward into the prompt params only, SGD update.

The counterpart of ``make_train_step`` in
``mvlpt_tpu/train/train_step.py``. Multi-label targets are normalised to
distributions; accuracy is taken against the argmax of the labels.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mvlpt_torch.models.custom_clip import MVLPTModel, TaskClassRanges
from mvlpt_torch.train.optim import build_lr_schedule, build_optimizer
from mvlpt_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    prompt_params: dict          # nested dict of fp32 leaves that require grad
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0


def init_train_state(prompt_params: dict, ocfg, steps_per_epoch: int) -> TrainState:
    """Copy ``prompt_params`` into trainable leaves and build SGD over them."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), prompt_params)
    return TrainState(params, build_optimizer(tree_leaves(params), ocfg),
                      build_lr_schedule(ocfg, steps_per_epoch))


def soft_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CE with int labels (B,) or multi-label k-hot / soft labels (B, C)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if labels.dim() == 1:
        nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    else:
        soft = labels.float()
        soft = soft / soft.sum(-1, keepdim=True).clamp_min(1e-8)
        nll = -(soft * logp).sum(-1)
    return nll.mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    pred = logits.argmax(-1)
    want = labels if labels.dim() == 1 else labels.argmax(-1)
    return (pred == want).float().mean()


def _prep_images(model, backbone, images, normalize):
    """(images_or_tokens, pre_embedded): uint8 batches go through the
    frozen stem with CLIP normalisation folded into the patch embedding;
    float batches pass through."""
    if normalize is not None and images.dtype == torch.uint8:
        return model.embed_image(backbone, images, normalize=normalize), True
    return images, False


def make_train_step(model: MVLPTModel, task_ranges: TaskClassRanges | None = None,
                    normalize: tuple | None = None) -> Callable:
    """step(state, backbone, consts, batch) -> (state, metrics).

    batch = {"image": (B,H,W,3) float (or uint8 with ``normalize``),
    "label": (B,) int or (B,C), and optionally "task": (B,) int}. The
    state's params and optimizer are updated in place. Metrics are
    0-dim tensors (loss, acc, grad_norm); reading them waits for the
    device."""

    def step_fn(state: TrainState, backbone, consts, batch):
        params = state.prompt_params
        leaves = tree_leaves(params)
        imgs, pre = _prep_images(model, backbone, batch["image"], normalize)
        logits = model(backbone, params, consts, imgs, tasks=batch.get("task"),
                       task_ranges=task_ranges, pre_embedded=pre)
        loss = soft_cross_entropy(logits, batch["label"])
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            grad_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            for p, g in zip(leaves, grads):
                p.grad = g
            lr = state.schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
            metrics = {"loss": loss.detach(), "acc": accuracy(logits, batch["label"]),
                       "grad_norm": grad_norm}
        state.step += 1
        return state, metrics

    return step_fn
