"""The OPTIM settings the port's train path reads, with the JAX package's
defaults (``mvlpt_tpu/config/defaults.py``). A plain, dependency-free
namespace: no yaml, no yacs."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class OptimConfig:
    NAME: str = "sgd"
    LR: float = 0.0003
    WEIGHT_DECAY: float = 5e-4
    MOMENTUM: float = 0.9
    SGD_DAMPNING: float = 0.0
    SGD_NESTEROV: bool = False
    LR_SCHEDULER: str = "single_step"
    STEPSIZE: tuple = (-1,)
    GAMMA: float = 0.1
    MAX_EPOCH: int = 10
    WARMUP_EPOCH: int = -1
    WARMUP_TYPE: str = "linear"
    WARMUP_CONS_LR: float = 1e-5
    WARMUP_MIN_LR: float = 1e-5
    WARMUP_RECOUNT: bool = True
