"""Matmul FLOPs of the train and eval steps, for MFU: a frozen copy.

Copied from the port's ``mvlpt_torch/utils/flops.py``, so that no later
change to the program moves the yardstick; a test holds the two equal
at the cells' shapes as they stood when the copy was made.

Matmul FLOPs only (the usual MFU convention: LayerNorm, softmax and
elementwise work left out), forward plus the dx-only backward. The
backbone is frozen, so no weight-gradient product exists anywhere:

* a projection ``y = x W``: forward ``2·T·in·out``; the backward is the
  one product ``dx = dy Wᵀ``, the same count again;
* an attention pair ``S = q kᵀ`` / ``o = P v``: forward ``2·T²·W`` each;
  the backward needs two products a pair (dq, dk / dP, dv), twice the
  forward.

The benchmark passes every shape of its cell (the text length s, the
classes a packed text row G, the image tokens); the defaults are never
used by it.
"""

from __future__ import annotations


def transformer_matmul_flops(
    n_tokens: int,
    width: int,
    n_layers: int,
    mlp_ratio: int = 4,
    attn_token_blocks: list[int] | None = None,
    bwd: bool = True,
) -> int:
    """Matmul FLOPs of a pre-LN transformer stack over ``n_tokens`` tokens
    in all (forward + dx-only backward).

    ``attn_token_blocks``: the sizes of block-diagonal attention blocks
    (the packed text tower attends within each class's block). Default:
    one full block of ``n_tokens``."""
    blocks = attn_token_blocks or [n_tokens]
    proj = (
        2 * n_tokens * width * (3 * width)          # qkv
        + 2 * n_tokens * width * width              # out
        + 2 * 2 * n_tokens * width * (mlp_ratio * width)  # fc + proj
    )
    attn = sum(4 * t * t * width for t in blocks)   # scores + context
    per_layer = proj + attn
    if bwd:
        per_layer += proj + 2 * attn
    return n_layers * per_layer


def flagship_step_flops(
    batch: int = 32,
    n_cls: int = 100,
    image_tokens: int = 201,     # 1 CLS + 196 patches + 4 VPT
    vision_width: int = 768,
    vision_layers: int = 12,
    text_tokens_per_cls: int = 11,
    text_width: int = 512,
    text_layers: int = 12,
    text_pack_classes: int = 10,   # classes packed a text row (G)
    patch_tokens: int = 196,
    patch_dim: int = 768,          # 16*16*3
) -> int:
    """Matmul FLOPs of one train step of the ViT-B/16 UPT flagship.

    Counted: the image tower forward and backward (per image), the frozen
    stem forward only (pre-embedded; its input takes no gradient), the
    packed text tower forward and backward (once a step: the prompts are
    shared across the batch), and the logit head. Left out (under 1%
    together): the UPT coupler (one layer over about 52 tokens of width
    128), the prompt projections, LN, softmax, elementwise work."""
    image = batch * transformer_matmul_flops(
        image_tokens, vision_width, vision_layers)
    stem = batch * 2 * patch_tokens * patch_dim * vision_width
    packed = text_pack_classes * text_tokens_per_cls
    text = transformer_matmul_flops(
        n_cls * text_tokens_per_cls, text_width, text_layers,
        attn_token_blocks=[packed] * -(-n_cls // text_pack_classes))
    # logit head: (B, E) @ (E, C) forward + dx backward on the text side only
    embed = text_width  # CLIP ViT-B/16 embed dim = 512
    logits = 2 * 2 * batch * embed * n_cls
    # image and text projections to the shared space
    proj = (batch * 2 * vision_width * embed * 2
            + n_cls * 2 * text_width * embed * 2)
    return image + stem + text + logits + proj


def eval_step_flops(
    batch: int = 100,
    n_cls: int = 100,
    image_tokens: int = 201,
    vision_width: int = 768,
    vision_layers: int = 12,
    patch_tokens: int = 196,
    patch_dim: int = 768,
    embed: int = 512,
) -> int:
    """Matmul FLOPs of one eval batch of the cached-text path
    (``make_cached_text_eval``): the image tower forward only (the text
    tower runs once a split and is cached), plus the stem, the image
    projection and the logit product. No backward."""
    image = batch * transformer_matmul_flops(
        image_tokens, vision_width, vision_layers, bwd=False)
    stem = batch * 2 * patch_tokens * patch_dim * vision_width
    logits = 2 * batch * embed * n_cls
    proj = batch * 2 * vision_width * embed
    return image + stem + logits + proj
