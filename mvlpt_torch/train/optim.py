"""Optimizer + LR schedule factory.

The counterpart of ``mvlpt_tpu/train/optim.py`` for SGD: Dassl's
per-epoch schedules (cosine, single/multi-step, constant) with a
constant or linear warmup, looked up from a per-epoch table by the
optimizer step count.
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


def build_optimizer(params, ocfg) -> torch.optim.Optimizer:
    """SGD over ``params`` with the OPTIM config's momentum, dampening,
    nesterov and coupled weight decay; the caller sets each step's lr
    from ``build_lr_schedule``.

    torch.optim.SGD matches the JAX package's optax chain exactly:
    add_decayed_weights(wd) makes g + wd * p, which is SGD's coupled
    weight decay; optax.trace keeps buf = g on the first step, then
    momentum * buf + g, and the dampened trace (optim.py:71-92) keeps
    buf = g first, then momentum * buf + (1 - damp) * g, which is SGD's
    momentum buffer with dampening; scale_by_learning_rate makes the
    update -lr(count) * buf with count the number of earlier updates,
    which is the lr this port sets on the param group before each step."""
    damp = _sgd_dampening(ocfg)
    return torch.optim.SGD(params, lr=float(ocfg.LR), momentum=float(ocfg.MOMENTUM),
                           dampening=damp, weight_decay=float(ocfg.WEIGHT_DECAY),
                           nesterov=bool(ocfg.SGD_NESTEROV))


def _sgd_dampening(ocfg) -> float:
    """SGD_DAMPNING, once the config is checked to name SGD with a valid
    dampening and nesterov pair."""
    name = ocfg.NAME.lower()
    if name != "sgd":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (SGD only)")
    damp = float(getattr(ocfg, "SGD_DAMPNING", 0.0))
    if damp and bool(ocfg.SGD_NESTEROV):
        raise ValueError("SGD_DAMPNING > 0 with nesterov is invalid")
    return damp


@dataclasses.dataclass
class DeviceSGD:
    """SGD whose whole state lives on the device, so that its update can
    be captured in a CUDA graph (``device_sgd_update_``): the momentum
    buffers, the count of updates made, and the per-epoch lr table that
    the count indexes. ``torch.optim.SGD`` takes its lr as a host float,
    which a captured step would freeze at one step's value."""

    lr_table: torch.Tensor       # (MAX_EPOCH + 1,) fp32
    steps_per_epoch: int
    momentum: float
    dampening: float
    nesterov: bool
    weight_decay: float
    buffers: list                # one fp32 momentum buffer a parameter
    count: torch.Tensor          # () int64, the updates made so far


def build_device_sgd(params, ocfg, steps_per_epoch: int) -> DeviceSGD:
    """A ``DeviceSGD`` over ``params`` (a list of tensors), with its state
    on their device."""
    damp = _sgd_dampening(ocfg)
    device = params[0].device
    return DeviceSGD(
        lr_table=torch.tensor(lr_table(ocfg), dtype=torch.float32, device=device),
        steps_per_epoch=int(steps_per_epoch), momentum=float(ocfg.MOMENTUM), dampening=damp,
        nesterov=bool(ocfg.SGD_NESTEROV), weight_decay=float(ocfg.WEIGHT_DECAY),
        buffers=[torch.zeros_like(p, memory_format=torch.contiguous_format) for p in params],
        count=torch.zeros((), dtype=torch.int64, device=device))


@torch.no_grad()
def device_sgd_update_(params, grads, opt: DeviceSGD) -> None:
    """One SGD update of ``params`` in place, with no host value read:
    g += wd p (coupled weight decay); buf = g on the first update, then
    momentum buf + (1 - dampening) g; the Nesterov form g + momentum buf
    where asked; p += -lr(count) x that, with lr(count) the table's entry
    for epoch count // steps_per_epoch. The same arithmetic as the JAX
    package's optax chain (``build_optimizer``'s docstring)."""
    epoch = torch.clamp(torch.div(opt.count, opt.steps_per_epoch, rounding_mode="floor"),
                        0, opt.lr_table.shape[0] - 1)
    # index_select, not indexing: a 0-dim index tensor would be read back
    # to the host.
    neg_lr = -opt.lr_table.index_select(0, epoch.reshape(1)).reshape(())
    scale = torch.where(opt.count == 0, 1.0, 1.0 - opt.dampening).to(torch.float32)
    for p, g, buf in zip(params, grads, opt.buffers):
        if opt.weight_decay:
            g = g + opt.weight_decay * p
        buf.copy_(opt.momentum * buf + scale * g)
        step = g + opt.momentum * buf if opt.nesterov else buf
        p.add_(step * neg_lr)
    opt.count.add_(1)
