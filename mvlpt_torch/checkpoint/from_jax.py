"""Carry weights from the JAX package's trees into the port.

The JAX backbone and prompt trees, given as nested dicts of numpy
arrays (``np.asarray`` of each leaf), follow the schema of
``mvlpt_tpu/core/clip.py:8-29``: linear kernels stored (in, out), block
parameters stacked on a leading layer axis. The port keeps that schema,
so the conversion is leaf for leaf and both sides compute the same
thing from the same numbers. A ModifiedResNet visual tree (``stem``,
``layer1``-``layer4`` as lists of blocks, ``attnpool``) comes across with
its HWIO conv kernels turned into ``core/resnet.py``'s (O, I, KH, KW).
The model zoo's trees (``mvlpt_tpu/core/zoo.py``, ``core/efficientnet.py``)
come across the same way (``zoo_params_from_jax``).
"""

from __future__ import annotations

import numpy as np
import torch

from mvlpt_torch.core.resnet import from_hwio
from mvlpt_torch.utils.device import resolve_device
from mvlpt_torch.utils.tree import tree_map


def _to_tensor(a, device, dtype=None) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: numpy-only, go through fp32
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def backbone_from_jax(tree: dict, device="cuda") -> dict:
    """JAX backbone tree -> frozen port backbone. Dtypes are kept, so a
    bf16-cast backbone stays bf16; ``logit_scale`` is fp32."""
    device = resolve_device(device)
    out = tree_map(lambda a: _to_tensor(a, device), tree)
    if "stem" in out["visual"]:
        out["visual"] = from_hwio(out["visual"])
    out["logit_scale"] = out["logit_scale"].float()
    return out


def prompt_params_from_jax(tree: dict, device="cuda") -> dict:
    """JAX prompt tree -> fp32 port prompt params, every subtree as it is
    (coop, vpt, mvlpt_proj, and cocoop's ctx and meta_net)."""
    device = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, device, torch.float32), tree)


def finetune_params_from_jax(tree: dict, device="cuda") -> dict:
    """A JAX ``FinetuneCLIP`` params tree ({"visual": the ViT tower in fp32,
    "head": {"kernel", "bias"}}) -> the port's trainable fp32 tree. The ViT
    tower keeps the JAX schema, so the conversion is leaf for leaf."""
    if "stem" in tree["visual"]:
        raise ValueError("FinetuneCLIP finetunes the ViT tower; this tree holds a ResNet")
    device = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, device, torch.float32), tree)


ZOO_FAMILIES = ("std_vit", "tv_resnet", "effnet")


def zoo_params_from_jax(tree: dict, family: str, device="cuda") -> dict:
    """A JAX zoo tree (its converters' or inits', numpy leaves) -> the
    port's, dtypes kept: ``family`` "std_vit" (core/zoo.py's ViT, no conv)
    leaf for leaf; "tv_resnet" and "effnet" with every HWIO conv kernel
    (a depthwise one (k, k, 1, C)) turned into (O, I, KH, KW) ((C, 1, k, k)),
    channels_last."""
    if family not in ZOO_FAMILIES:
        raise ValueError(f"unknown zoo family {family!r}; known: {ZOO_FAMILIES}")
    device = resolve_device(device)
    out = tree_map(lambda a: _to_tensor(a, device), tree)
    return out if family == "std_vit" else from_hwio(out)
