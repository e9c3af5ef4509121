"""Deterministic seeding of the host RNGs and torch.

The counterpart of ``mvlpt_tpu/utils/seeding.py`` (Dassl's
``set_random_seed``, reference train.py:196-198).
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int) -> torch.Generator:
    """Seed python's, numpy's and torch's global RNGs; return a
    ``torch.Generator`` seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
