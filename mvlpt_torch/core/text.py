"""CLIP text transformer over pre-assembled prompt embeddings.

The counterpart of ``mvlpt_tpu/core/text.py``: add positional
embeddings sliced to the prompt length, run the causal-masked
transformer, fp32 LayerNorm, gather the feature at each row's EOT
position (precomputed as ``eot_idx``) and project. ``encode_text`` is
the plain CLIP path from raw token ids (zero-shot), with the EOT at the
argmax of the ids.
"""

from __future__ import annotations

import torch

from mvlpt_torch.core import layers


def _eot_gather(x: torch.Tensor, eot_idx: torch.Tensor) -> torch.Tensor:
    return x[torch.arange(x.shape[0], device=x.device), eot_idx.to(x.device).long()]


def encode_text_embeds(params: dict, prompt_embeds: torch.Tensor, eot_idx: torch.Tensor,
                       *, n_heads: int, kernels=None) -> torch.Tensor:
    """(N, S, W) prompt embeddings + (N,) EOT indices -> (N, embed_dim)."""
    compute_dtype = prompt_embeds.dtype
    s = prompt_embeds.shape[1]
    x = prompt_embeds + params["pos_embedding"].to(compute_dtype)[None, :s]
    mask = layers.causal_mask(s, device=x.device)
    x = layers.transformer(x, params["blocks"], n_heads, mask=mask, kernels=kernels)
    x = layers.layer_norm(x, params["ln_final"])
    return layers._matmul(_eot_gather(x, eot_idx), params["text_projection"])


def packing(n_cls: int, s: int, target_tokens: int = 128) -> tuple[int, int]:
    """(G, rows): G = target_tokens // S classes per packed row, over
    ``rows`` rows. G == 1 means no packing."""
    g = max(1, target_tokens // s)
    if g <= 1 or n_cls <= g:
        return 1, n_cls
    return g, -(-n_cls // g)


def block_causal_mask(g: int, s: int, device=None) -> torch.Tensor:
    """(G*S, G*S) additive mask: causal within each of the G classes,
    fp32 ``finfo.min`` across classes."""
    base = layers.causal_mask(s, device=device)
    mask = torch.full((g * s, g * s), torch.finfo(torch.float32).min,
                      dtype=torch.float32, device=device)
    for i in range(g):
        mask[i * s:(i + 1) * s, i * s:(i + 1) * s] = base
    return mask


def encode_text_embeds_packed(params: dict, prompt_embeds: torch.Tensor,
                              eot_idx: torch.Tensor, *, n_heads: int, kernels=None,
                              target_tokens: int = 128) -> torch.Tensor:
    """Class-packed text encoding: G = target_tokens // S class rows per
    sequence under a block-diagonal causal mask, zero-padded to whole
    rows. Attention is blocked per class and every other op works per
    token, so the math equals :func:`encode_text_embeds`. Falls back to
    it when packing would not help."""
    n_cls, s, w = prompt_embeds.shape
    g, rows = packing(n_cls, s, target_tokens)
    if g == 1:
        return encode_text_embeds(params, prompt_embeds, eot_idx, n_heads=n_heads,
                                  kernels=kernels)
    n_pad = rows * g - n_cls
    if n_pad:
        prompt_embeds = torch.cat(
            [prompt_embeds, prompt_embeds.new_zeros((n_pad, s, w))], dim=0)
    pos = params["pos_embedding"].to(prompt_embeds.dtype)[:s]
    x = prompt_embeds.reshape(rows, g * s, w) + pos.repeat(g, 1)[None]
    mask = block_causal_mask(g, s, device=x.device)
    x = layers.transformer(x, params["blocks"], n_heads, mask=mask, kernels=kernels)
    x = layers.layer_norm(x, params["ln_final"])
    x = x.reshape(rows * g, s, w)[:n_cls]
    return layers._matmul(_eot_gather(x, eot_idx), params["text_projection"])


def embed_tokens(params: dict, token_ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Token-embedding lookup (N, S) -> (N, S, W)."""
    emb = params["token_embedding"]
    if dtype is not None:
        emb = emb.to(dtype)
    return emb[token_ids.to(emb.device).long()]


def encode_text(params: dict, token_ids: torch.Tensor, *, n_heads: int,
                kernels=None) -> torch.Tensor:
    """Plain CLIP text encoding from (N, S) token ids (the zero-shot path)."""
    x = embed_tokens(params, token_ids, dtype=params["pos_embedding"].dtype)
    eot_idx = token_ids.to(x.device).long().argmax(-1)
    return encode_text_embeds(params, x, eot_idx, n_heads=n_heads, kernels=kernels)
