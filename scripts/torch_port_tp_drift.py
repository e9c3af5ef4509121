#!/usr/bin/env python3
"""How far the port's tensor-parallel numbers drift from the single-device
kernels', and why, on one card.

    python3 scripts/torch_port_tp_drift.py

At tp = 2 the out-projection and the MLP projection are two fp32 partial
products of K/2 each (one a model rank), summed by the all-reduce; the
single-device kernels (#1, #3) and the plain path run one K loop. In bf16
a changed summation order can flip the rounding of an output element by
one ulp. This script measures that at two levels:

  * one block at the flagship's image train shape (ViT-B/16, batch 32,
    201 tokens, bf16, CLIP-scale random weights): the share of elements
    of each half-block's bf16 output that differ bit-wise between kernel
    #1/#3 and the plain twin, between the tp shards' parts (#7/#9) summed
    and #1/#3, and between the plain twin with its last product split in
    K halves ("plain-split", the order of tp = 2) and the twin;
  * the flagship's first train step (chip_smoke's first train batch): loss
    and gradient norm of the plain path ('off'), of 'auto' (#1-#4) and of
    the plain path with every bf16 out-projection and MLP projection split
    as at tp = 2; and of 'off' and 'auto' in fp32, where no bf16 rounding
    flips.

Prints the card (nvidia-smi name and power limit) and one JSON line each.
Needs a card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TP = 2


def _split_matmul(x, w, b):
    """``layers._matmul`` with K cut in TP halves, each accumulated in
    fp32 and then summed, as the tensor-parallel partials are."""
    import torch

    k = w.shape[0] // TP
    parts = [torch.matmul(x[..., r * k:(r + 1) * k].float(),
                          w[r * k:(r + 1) * k].to(x.dtype).float()) for r in range(TP)]
    return (sum(parts) + b.float()).to(x.dtype)


def _split_layers():
    """Patch core.layers so that its bf16 out-projection and MLP projection
    sum TP partials; returns the undo."""
    from mvlpt_torch.core import layers

    attention, mlp = layers.attention, layers.mlp

    def split_attention(x, p, n_heads, mask=None, attn_fn=None):
        if x.element_size() == 4:
            return attention(x, p, n_heads, mask, attn_fn)
        b, s, w = x.shape
        qkv = layers._matmul(x, p["qkv_w"], p["qkv_b"])
        q, k, v = qkv.view(b, s, 3, n_heads, w // n_heads).permute(2, 0, 3, 1, 4)
        o = layers._sdpa(q, k, v, mask).transpose(1, 2).reshape(b, s, w)
        return _split_matmul(o, p["out_w"], p["out_b"])

    def split_mlp(x, p):
        if x.element_size() == 4:
            return mlp(x, p)
        h = layers.quick_gelu(layers._matmul(x, p["fc_w"], p["fc_b"]))
        return _split_matmul(h, p["proj_w"], p["proj_b"])

    layers.attention, layers.mlp = split_attention, split_mlp

    def undo():
        layers.attention, layers.mlp = attention, mlp

    return undo


def block_shares() -> dict:
    import torch

    from chip_smoke import layer_params
    from mvlpt_torch.ops import block
    from mvlpt_torch.parallel import shard_blocks

    b, s, w, h = 32, 201, 768, 12
    gen = torch.Generator().manual_seed(13)
    p = layer_params(w, torch.bfloat16, gen)
    x = torch.randn((b, s, w), generator=gen).to("cuda", torch.bfloat16)
    shards = [shard_blocks(p, h, TP, r) for r in range(TP)]
    ln1, ln2, at, ml = p["ln_1"], p["ln_2"], p["attn"], p["mlp"]
    wl, w4l = w // TP, 4 * w // TP

    def shares(kernel, twin, tp, split):
        def differ(a, c):
            return (a != c).float().mean().item()

        return {"kernel_vs_twin": differ(kernel, twin), "tp_vs_kernel": differ(tp, kernel),
                "tp_vs_plain_split": differ(tp, split), "plain_split_vs_twin": differ(split, twin)}

    out = {}
    # Attention half.
    k1 = block.attn_fwd(x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], at["out_w"],
                        at["out_b"], None, h)[0]
    twin = block.attn_fwd_plain(x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"],
                                at["out_w"], at["out_b"], None, h)[0]
    parts = sum(block.attn_fwd_part(x, ln1["scale"], ln1["bias"], sh["attn"]["qkv_w"],
                                    sh["attn"]["qkv_b"], sh["attn"]["out_w"], None, h // TP)[0]
                for sh in shards)
    tp = x + (parts + at["out_b"].float()).to(x.dtype)
    o = block._attn_core_plain(x, ln1["scale"], ln1["bias"], at["qkv_w"], at["qkv_b"], None, h,
                               block._EPS)[0]
    split = x + (sum(block._mm(o[..., r * wl:(r + 1) * wl], at["out_w"][r * wl:(r + 1) * wl])
                     for r in range(TP)) + at["out_b"].float()).to(x.dtype)
    out["attn"] = shares(k1, twin, tp, split)
    # MLP half.
    k3 = block.mlp_fwd(x, ln2["scale"], ln2["bias"], ml["fc_w"], ml["fc_b"], ml["proj_w"],
                       ml["proj_b"])[0]
    twin = block.mlp_fwd_plain(x, ln2["scale"], ln2["bias"], ml["fc_w"], ml["fc_b"], ml["proj_w"],
                               ml["proj_b"])[0]
    parts = sum(block.mlp_fwd_part(x, ln2["scale"], ln2["bias"], sh["mlp"]["fc_w"],
                                   sh["mlp"]["fc_b"], sh["mlp"]["proj_w"])[0] for sh in shards)
    tp = x + (parts + ml["proj_b"].float()).to(x.dtype)
    act = block._mlp_hidden_plain(x, ln2["scale"], ln2["bias"], ml["fc_w"], ml["fc_b"],
                                  block._EPS)[0]
    split = x + (sum(block._mm(act[..., r * w4l:(r + 1) * w4l],
                               ml["proj_w"][r * w4l:(r + 1) * w4l]) for r in range(TP))
                 + ml["proj_b"].float()).to(x.dtype)
    out["mlp"] = shares(k3, twin, tp, split)
    return out


def first_steps() -> dict:
    import numpy as np
    import torch

    from chip_smoke import OPTIM
    from mvlpt_torch.config import optim_config
    from mvlpt_torch.flagship import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, flagship
    from mvlpt_torch.train import init_train_state, make_train_step

    rng = np.random.RandomState(0)  # chip_smoke's first train batch
    res = 224
    batch = {"image": torch.from_numpy(rng.randint(0, 256, (32, res, res, 3)).astype(
                 np.uint8)).cuda(),
             "label": torch.from_numpy(rng.randint(0, 100, 32)).cuda()}
    out = {}
    for name, sel, dtype in (("plain", "off", torch.bfloat16), ("auto", "auto", torch.bfloat16),
                             ("plain_split", "off", torch.bfloat16),
                             ("plain_fp32", "off", torch.float32),
                             ("auto_fp32", "auto", torch.float32)):
        undo = _split_layers() if name == "plain_split" else (lambda: None)
        try:
            model, backbone, pp, consts, _, _ = flagship(device="cuda", compute_dtype=dtype,
                                                         kernels=sel)
            step = make_train_step(model, normalize=(CLIP_PIXEL_MEAN, CLIP_PIXEL_STD))
            _, m = step(init_train_state(pp, optim_config(**OPTIM), 100), backbone, consts, batch)
            out[name] = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()}
        finally:
            undo()
    for name, ref in (("auto", "plain"), ("plain_split", "plain"), ("auto_fp32", "plain_fp32")):
        for key in ("loss", "grad_norm"):
            out[name][f"{key}_rel_vs_{ref}"] = abs(out[name][key] / out[ref][key] - 1)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_port_tp_drift: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import card_line, setup_vocab

    print(card_line())  # name, power limit (nvidia-smi)
    print(setup_vocab())
    print("block-differ-share " + json.dumps(block_shares()), flush=True)
    print("first-step " + json.dumps(first_steps()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
