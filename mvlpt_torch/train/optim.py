"""Optimizer + LR schedule factory.

The counterpart of ``mvlpt_tpu/train/optim.py`` for SGD: Dassl's
per-epoch schedules (cosine, single/multi-step, constant) with a
constant or linear warmup, looked up from a per-epoch table by the
optimizer step count.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def build_lr_schedule(ocfg, steps_per_epoch: int) -> Callable[[int], float]:
    """Return lr(step) implementing Dassl's per-epoch schedule."""
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
    table = [float(torch.tensor(v, dtype=torch.float32)) for v in table]

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
    name = ocfg.NAME.lower()
    if name != "sgd":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (SGD only)")
    damp = float(getattr(ocfg, "SGD_DAMPNING", 0.0))
    if damp and bool(ocfg.SGD_NESTEROV):
        raise ValueError("SGD_DAMPNING > 0 with nesterov is invalid")
    return torch.optim.SGD(params, lr=float(ocfg.LR), momentum=float(ocfg.MOMENTUM),
                           dampening=damp, weight_decay=float(ocfg.WEIGHT_DECAY),
                           nesterov=bool(ocfg.SGD_NESTEROV))
