"""Device-side image transforms.

The counterpart of ``device_normalize`` in ``mvlpt_tpu/data/transforms.py``.
"""

from __future__ import annotations

import torch


def device_normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    """CLIP normalisation of a raw uint8 batch on its device,
    ``(x - 255 mean) / (255 std)`` in fp32; float batches pass through
    untouched."""
    if images.dtype != torch.uint8:
        return images
    m = torch.as_tensor(mean, dtype=torch.float32, device=images.device) * 255.0
    s = torch.as_tensor(std, dtype=torch.float32, device=images.device) * 255.0
    return (images.float() - m) / s
