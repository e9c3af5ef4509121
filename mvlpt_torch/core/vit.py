"""CLIP vision transformer with VPT prompt-injection hooks.

The counterpart of ``mvlpt_tpu/core/vit.py``: patchify -> prepend CLS
-> +pos -> ln_pre -> blocks -> ln_post on CLS -> @ proj, with shallow
VPT prompts inserted between CLS and the patch tokens after ln_pre and
deep prompts replacing positions [1, 1+n_ctx) before each block >= 1.
The patch embedding is an unfold + matmul, as on the JAX side.
"""

from __future__ import annotations

import torch

from mvlpt_torch.core import layers


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, patch*patch*C) with (ph, pw, c) flatten order."""
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, gh, gw, ph, pw, C)
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


def fold_normalize(kernel: torch.Tensor, patch_size: int, normalize: tuple):
    """(scaled kernel, bias) of the patch embedding with CLIP's
    ``(x/255 - mean) / std`` folded in: per channel it is ``a*x + b``, so
    ``x @ (a*K) + b_flat @ K``. Computed from the frozen weights on their
    device."""
    compute_dtype = kernel.dtype
    mean, std = (torch.as_tensor(v, dtype=torch.float32, device=kernel.device)
                 for v in normalize)
    a = 1.0 / (255.0 * std)       # (C,)
    shift = -mean / std           # (C,)
    c = mean.shape[0]
    k32 = kernel.float().reshape(patch_size * patch_size, c, -1)
    k_scaled = (k32 * a[None, :, None]).reshape(patch_size * patch_size * c, -1).to(compute_dtype)
    bias = (k32 * shift[None, :, None]).sum(dim=(0, 1))  # (W,)
    return k_scaled, bias


class FoldedStems:
    """:func:`fold_normalize`'s results, made once for each (patch
    kernel, normalize) pair: building mean and std on the card from
    Python floats is a host-to-device copy, which synchronises the stream,
    so no call after the first may do it. Keyed on the kernel's
    ``data_ptr()`` and the normalize tuple; an entry holds its kernel, so
    the address cannot be reused by another tensor while it lives."""

    def __init__(self):
        self._entries: dict = {}

    def get(self, kernel: torch.Tensor, patch_size: int, normalize: tuple):
        normalize = tuple(tuple(float(x) for x in v) for v in normalize)
        key = (kernel.data_ptr(), kernel.device, patch_size, normalize)
        entry = self._entries.get(key)
        if entry is None or entry[0] is not kernel or entry[1] != kernel._version:
            entry = (kernel, kernel._version, fold_normalize(kernel, patch_size, normalize))
            self._entries[key] = entry
        return entry[2]


def embed_image(params: dict, images: torch.Tensor, patch_size: int,
                normalize: tuple | None = None, stems: FoldedStems | None = None) -> torch.Tensor:
    """Frozen ViT stem: (B, H, W, 3) -> (B, 1+N, width) tokens after
    ln_pre, before any VPT prompt insertion.

    ``normalize=(mean, std)``: ``images`` are raw uint8 pixels and CLIP's
    ``(x/255 - mean) / std`` is folded into the patch-embed product
    (:func:`fold_normalize`), taken from ``stems`` when given."""
    kernel = params["patch_embed"]["kernel"]  # (P*P*C, W)
    compute_dtype = kernel.dtype
    if normalize is not None:
        k_scaled, bias = (stems.get(kernel, patch_size, normalize) if stems is not None
                          else fold_normalize(kernel, patch_size, normalize))
        x = patchify(images, patch_size).to(compute_dtype)
        x = layers._matmul(x, k_scaled, bias)
    else:
        x = patchify(images.to(compute_dtype), patch_size)
        x = layers._matmul(x, kernel)  # (B, N, W)

    b = x.shape[0]
    cls = params["class_embedding"].to(compute_dtype)[None, None, :].expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embedding"].to(compute_dtype)[None]
    return layers.layer_norm(x, params["ln_pre"])


def encode_image(params: dict, images: torch.Tensor, *, patch_size: int, n_heads: int,
                 vpt_shallow: torch.Tensor | None = None,
                 vpt_deep: torch.Tensor | None = None, kernels=None,
                 pre_embedded: bool = False, remat: bool = False) -> torch.Tensor:
    """Encode NHWC images to (B, output_dim) features.

    ``vpt_shallow``: (1 or B, n_ctx, width) prompt tokens inserted after
    ln_pre. ``vpt_deep``: (L-1, n_ctx, width) per-layer replacement rows.
    ``pre_embedded``: ``images`` is already the (B, 1+N, width) output of
    :func:`embed_image`. ``remat``: per-layer activation checkpointing
    (``layers.transformer``)."""
    x = images if pre_embedded else embed_image(params, images, patch_size)
    b, compute_dtype = x.shape[0], x.dtype

    if vpt_shallow is not None:
        ctx = vpt_shallow.to(compute_dtype).expand(b, vpt_shallow.shape[-2], x.shape[-1])
        x = torch.cat([x[:, :1], ctx, x[:, 1:]], dim=1)

    inject = None
    if vpt_deep is not None:
        # Row 0 is a dummy: layer 0 is never injected.
        inject = torch.cat([torch.zeros_like(vpt_deep[:1]), vpt_deep], dim=0)

    x = layers.transformer(x, params["blocks"], n_heads, mask=None, inject=inject,
                           kernels=kernels, remat=remat)
    x = layers.layer_norm(x[:, 0], params["ln_post"])
    if params.get("proj") is not None:
        x = layers._matmul(x, params["proj"])
    return x
