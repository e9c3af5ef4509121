"""The train step (forward both towers, soft-label cross-entropy,
backward into the prompt params only, SGD update) and the eval steps.

The counterpart of ``make_train_step``, ``make_eval_step`` and
``make_cached_text_eval`` in ``mvlpt_tpu/train/train_step.py``.
Multi-label targets are normalised to distributions; accuracy is taken
against the argmax of the labels. Eval runs under ``torch.no_grad()``
with the fused half-block kernels in their no-grad forwards.

Under a mesh (``parallel.Mesh``) the train step takes the global batch,
runs this data rank's rows, and takes the mean of the prompt gradients,
the loss and the accuracy over the data group, so that every rank makes
the global-batch step. The text tower runs whole on every data rank (the
JAX package pads and splits its rows instead; the values are the same).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from mvlpt_torch.models.custom_clip import MVLPTModel, TaskClassRanges
from mvlpt_torch.ops.block import BlockKernels
from mvlpt_torch.parallel.mesh import local_batch
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


def _data_mean(tensors, mesh) -> None:
    """In place: the mean of each tensor over the mesh's data group."""
    if mesh is None or mesh.n_data == 1:
        return
    for t in tensors:
        dist.all_reduce(t, group=mesh.data_group)
        t.div_(mesh.n_data)


def make_train_step(model: MVLPTModel, task_ranges: TaskClassRanges | None = None,
                    normalize: tuple | None = None, mesh=None) -> Callable:
    """step(state, backbone, consts, batch) -> (state, metrics).

    batch = {"image": (B,H,W,3) float (or uint8 with ``normalize``),
    "label": (B,) int or (B,C), and optionally "task": (B,) int}. The
    state's params and optimizer are updated in place. Metrics are
    0-dim tensors (loss, acc, grad_norm); reading them waits for the
    device. Under ``mesh`` the batch is the global one and must divide
    over the data ranks; ``backbone`` is this rank's shard
    (``parallel.shard_backbone``) and the model's kernels carry the mesh."""

    def step_fn(state: TrainState, backbone, consts, batch):
        if mesh is not None:
            batch = local_batch(batch, mesh)
        params = state.prompt_params
        leaves = tree_leaves(params)
        imgs, pre = _prep_images(model, backbone, batch["image"], normalize)
        logits = model(backbone, params, consts, imgs, tasks=batch.get("task"),
                       task_ranges=task_ranges, pre_embedded=pre)
        loss = soft_cross_entropy(logits, batch["label"])
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            loss, acc = loss.detach(), accuracy(logits, batch["label"])
            _data_mean(grads + (loss, acc), mesh)
            grad_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            for p, g in zip(leaves, grads):
                p.grad = g
            lr = state.schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
            metrics = {"loss": loss, "acc": acc, "grad_norm": grad_norm}
        state.step += 1
        return state, metrics

    return step_fn


def _inference_model(model: MVLPTModel) -> MVLPTModel:
    """A new model whose fused half-block kernels run their no-grad
    forwards (the JAX package's attn_block_infer / mlp_block_infer): the
    same values, no backward residuals written. ``model`` itself is left
    as it is. The standalone attention ('on') and the plain path ('off')
    have no such variant: ``model`` comes back unchanged. The kernels'
    mesh carries over."""
    if not isinstance(model.kernels, BlockKernels) or model.kernels.inference:
        return model
    return MVLPTModel(model.clip_cfg, model.spec,
                      kernels=dataclasses.replace(model.kernels, inference=True),
                      compute_dtype=model.compute_dtype)


def make_eval_step(model: MVLPTModel, task_ranges: TaskClassRanges | None = None,
                   normalize: tuple | None = None) -> Callable:
    """eval_step(backbone, prompt_params, consts, batch) -> fp32 logits,
    both towers each call, no gradient."""
    model = _inference_model(model)

    @torch.no_grad()
    def eval_fn(backbone, prompt_params, consts, batch):
        imgs, pre = _prep_images(model, backbone, batch["image"], normalize)
        return model(backbone, prompt_params, consts, imgs, tasks=batch.get("task"),
                     task_ranges=task_ranges, pre_embedded=pre)

    return eval_fn


def make_cached_text_eval(model: MVLPTModel, task_ranges: TaskClassRanges | None = None,
                          normalize: tuple | None = None):
    """(text_fn, eval_fn) for the cached-text eval fast path: the prompts
    are frozen at eval, so ``text_fn(backbone, prompt_params, consts)``
    computes the text features once and ``eval_fn(backbone,
    prompt_params, text_features, batch)`` runs the image tower and the
    logits per batch, with the same values as :func:`make_eval_step`."""
    model = _inference_model(model)

    @torch.no_grad()
    def text_fn(backbone, prompt_params, consts):
        return model.compute_text_features(backbone, prompt_params, consts)

    @torch.no_grad()
    def eval_fn(backbone, prompt_params, text_features, batch):
        imgs, pre = _prep_images(model, backbone, batch["image"], normalize)
        return model.forward_with_text(backbone, prompt_params, imgs, text_features,
                                       tasks=batch.get("task"), task_ranges=task_ranges,
                                       pre_embedded=pre)

    return text_fn, eval_fn
