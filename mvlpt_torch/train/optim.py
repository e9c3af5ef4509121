"""Optimizer + LR schedule factory.

The counterpart of ``mvlpt_tpu/train/optim.py``: Dassl's per-epoch
schedules (cosine, single/multi-step, constant) with a constant or
linear warmup, looked up from a per-epoch table by the optimizer step
count, and SGD, Adam, AdamW and RMSprop with the JAX package's optax
semantics, their whole state on the device (``DeviceOptimizer``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


def lr_table(ocfg) -> list[float]:
    """The lr of each epoch 0..MAX_EPOCH under Dassl's schedule with its
    warmup, as the fp32 values the JAX package looks up on the device."""
    base_lr = float(ocfg.LR)
    max_epoch = int(ocfg.MAX_EPOCH)
    name = ocfg.LR_SCHEDULER
    warmup_epoch = int(ocfg.WARMUP_EPOCH)
    # Dassl's WARMUP_RECOUNT: the wrapped scheduler is not stepped during
    # warmup and (when True, the default) restarts its epoch count at the
    # end of warmup, so epoch e >= W trains at schedule(e - W).
    recount = bool(getattr(ocfg, "WARMUP_RECOUNT", True)) and warmup_epoch > 0

    def epoch_lr(epoch: int) -> float:
        if recount:
            epoch = max(0, epoch - warmup_epoch)
        if name == "cosine":
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / max_epoch))
        if name == "single_step":
            step_size = ocfg.STEPSIZE[0] if ocfg.STEPSIZE[0] > 0 else max_epoch
            return base_lr * (ocfg.GAMMA ** (epoch // step_size))
        if name == "multi_step":
            n = sum(1 for s in ocfg.STEPSIZE if epoch >= s)
            return base_lr * (ocfg.GAMMA ** n)
        if name == "constant":
            return base_lr
        raise ValueError(f"unknown LR_SCHEDULER {name!r}")

    table = []
    for e in range(max_epoch + 1):
        if e < warmup_epoch:
            if ocfg.WARMUP_TYPE == "constant":
                table.append(float(ocfg.WARMUP_CONS_LR))
            else:  # linear
                lo = float(ocfg.WARMUP_MIN_LR)
                table.append(lo + (base_lr - lo) * e / max(1, warmup_epoch))
        else:
            table.append(epoch_lr(e))
    # The JAX package looks the table up in fp32 on the device.
    return [float(torch.tensor(v, dtype=torch.float32)) for v in table]


def build_lr_schedule(ocfg, steps_per_epoch: int) -> Callable[[int], float]:
    """Return lr(step) implementing Dassl's per-epoch schedule."""
    table, max_epoch = lr_table(ocfg), int(ocfg.MAX_EPOCH)

    def schedule(step: int) -> float:
        return table[min(max(step // steps_per_epoch, 0), max_epoch)]

    return schedule


# The state slots of each optimizer kind, one tensor a parameter each.
SLOTS = {"sgd": ("momentum",), "adam": ("mu", "nu"), "rmsprop": ("nu",)}
# optax's defaults, which the JAX package's chains keep.
ADAM_EPS = 1e-8
RMS_EPS = 1e-8


def optimizer_kind(ocfg) -> str:
    """The update rule OPTIM.NAME names: "sgd", "adam" (adam and adamw, one
    optax chain: scale_by_adam, add_decayed_weights, -lr) or "rmsprop"."""
    name = ocfg.NAME.lower()
    if name == "sgd":
        if float(getattr(ocfg, "SGD_DAMPNING", 0.0)) and bool(ocfg.SGD_NESTEROV):
            raise ValueError("SGD_DAMPNING > 0 with nesterov is invalid")
        return "sgd"
    if name in ("adam", "adamw"):
        return "adam"
    if name == "rmsprop":
        return "rmsprop"
    raise ValueError(f"unknown optimizer {name!r}")


@dataclasses.dataclass
class DeviceOptimizer:
    """An optimizer whose whole state lives on the device, so that its
    update (``device_update_``) can be captured in a CUDA graph: the slots
    of its kind (SGD's momentum buffers, Adam's mu and nu, RMSprop's nu),
    the count of updates made, and the per-epoch lr tables that the count
    indexes, one row a parameter group. ``torch.optim``'s optimizers take
    their lr as a host float, which a captured step would freeze at one
    step's value, and torch Adam's weight decay is an L2 term where the
    JAX package's chain decays after the moments."""

    kind: str                    # optimizer_kind
    lr_table: torch.Tensor       # (groups, MAX_EPOCH + 1) fp32
    group: tuple                 # each parameter's row of lr_table
    steps_per_epoch: int
    weight_decay: float
    momentum: float              # SGD
    dampening: float             # SGD
    nesterov: bool               # SGD
    b1: float                    # Adam
    b2: float                    # Adam
    alpha: float                 # RMSprop's decay
    slots: dict                  # SLOTS[kind] -> one fp32 tensor a parameter
    count: torch.Tensor          # () int64, the updates made so far

    def tensors(self) -> list:
        """Every tensor of the state, which a captured update reads or
        writes in place."""
        return [t for name in SLOTS[self.kind] for t in self.slots[name]] + [self.count,
                                                                              self.lr_table]


def build_device_optimizer(params, ocfg, steps_per_epoch: int, group=None) -> DeviceOptimizer:
    """A ``DeviceOptimizer`` over ``params`` (a list of tensors), with its
    state on their device. ``ocfg`` is one OPTIM config, or a list of them
    that differ in their LR only (parameter groups, FinetuneCLIP's
    STAGED_LR); ``group[i]`` is parameter i's index in that list."""
    ocfgs = list(ocfg) if isinstance(ocfg, (list, tuple)) else [ocfg]
    group = tuple(group) if group is not None else (0,) * len(params)
    first = ocfgs[0]
    kind = optimizer_kind(first)
    device = params[0].device
    table = torch.tensor([lr_table(c) for c in ocfgs], dtype=torch.float32, device=device)
    return DeviceOptimizer(
        kind=kind, lr_table=table, group=group, steps_per_epoch=int(steps_per_epoch),
        weight_decay=float(first.WEIGHT_DECAY), momentum=float(first.MOMENTUM),
        dampening=float(getattr(first, "SGD_DAMPNING", 0.0)),
        nesterov=bool(first.SGD_NESTEROV), b1=float(first.ADAM_BETA1),
        b2=float(first.ADAM_BETA2), alpha=float(first.RMSPROP_ALPHA),
        slots={name: [torch.zeros_like(p, dtype=torch.float32,
                                       memory_format=torch.contiguous_format) for p in params]
               for name in SLOTS[kind]},
        count=torch.zeros((), dtype=torch.int64, device=device))


@torch.no_grad()
def device_update_(params, grads, opt: DeviceOptimizer) -> None:
    """One update of ``params`` in place, with no host value read, by the
    JAX package's optax chain for OPTIM.NAME; lr(count) is the table's
    entry of the parameter's group for epoch count // steps_per_epoch,
    with count the number of earlier updates (scale_by_learning_rate).

    SGD: g += wd p (add_decayed_weights before the trace); buf = g on the
    first update, then momentum buf + (1 - dampening) g (optax.trace, and
    the JAX package's dampened trace); the Nesterov form g + momentum buf
    where asked; p -= lr buf. It is also torch.optim.SGD's update with the
    lr set to lr(count) before each step.

    Adam and AdamW (scale_by_adam with eps 1e-8 and eps_root 0, then
    add_decayed_weights, then -lr): mu = b1 mu + (1 - b1) g, nu = b2 nu +
    (1 - b2) g^2, u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) with
    t = count + 1, u += wd p, p -= lr u.

    RMSprop (scale_by_rms with decay RMSPROP_ALPHA, eps 1e-8 inside the
    square root, initial scale 0, no bias correction, no momentum; then
    add_decayed_weights, then -lr): nu = alpha nu + (1 - alpha) g^2,
    u = g / sqrt(nu + eps), u += wd p, p -= lr u."""
    epoch = torch.clamp(torch.div(opt.count, opt.steps_per_epoch, rounding_mode="floor"),
                        0, opt.lr_table.shape[1] - 1)
    # index_select, not indexing: a 0-dim index tensor would be read back
    # to the host.
    neg_lr = -opt.lr_table.index_select(1, epoch.reshape(1))[:, 0]
    wd = opt.weight_decay
    if opt.kind == "sgd":
        scale = torch.where(opt.count == 0, 1.0, 1.0 - opt.dampening).to(torch.float32)
    elif opt.kind == "adam":
        t = (opt.count + 1).to(torch.float32)
        c1, c2 = 1.0 - torch.pow(opt.b1, t), 1.0 - torch.pow(opt.b2, t)
    for i, (p, g) in enumerate(zip(params, grads)):
        if opt.kind == "sgd":
            buf = opt.slots["momentum"][i]
            if wd:
                g = g + wd * p
            buf.copy_(opt.momentum * buf + scale * g)
            u = g + opt.momentum * buf if opt.nesterov else buf
        elif opt.kind == "adam":
            mu, nu = opt.slots["mu"][i], opt.slots["nu"][i]
            mu.copy_((1.0 - opt.b1) * g + opt.b1 * mu)
            nu.copy_((1.0 - opt.b2) * g.square() + opt.b2 * nu)
            u = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
            if wd:
                u = u + wd * p
        else:
            nu = opt.slots["nu"][i]
            nu.copy_((1.0 - opt.alpha) * g.square() + opt.alpha * nu)
            u = torch.rsqrt(nu + RMS_EPS) * g
            if wd:
                u = u + wd * p
        p.add_(u * neg_lr[opt.group[i]])
    opt.count.add_(1)
