"""Nearest-vocabulary interpretation of learned context vectors.

The counterpart of ``mvlpt_tpu/cli/interpret_prompt.py`` (the
reference's scripts/interpret_prompt.py:27-63): for each learned ctx
vector, the closest token embeddings by euclidean distance, taken in
fp32 on the run's device.

    python -m mvlpt_torch.cli.interpret_prompt CKPT 5 [--backbone ViT-B/16]

The CLIP weights resolve as the trainer's do (``MVLPT_TPU_RANDOM_CLIP``,
``MVLPT_TPU_CLIP_CKPT``, the local cache). Runs on the card;
``cli(argv, device="cpu")`` on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mvlpt_torch.checkpoint.prompt_io import load_prompt_checkpoint
from mvlpt_torch.tokenizer import get_tokenizer


def interpret(ctx, token_embedding, topk: int = 5) -> list:
    """For each context set and each of its vectors, the ``topk`` nearest
    rows of ``token_embedding`` (V, D) as [(word, distance), ...], the
    distances in fp32 on ``token_embedding``'s device (an array goes to the
    CPU). ``ctx`` is (n, D) or (M, n, D)."""
    tok = get_tokenizer()
    emb = torch.as_tensor(token_embedding).float()
    ctx = torch.as_tensor(ctx).to(device=emb.device, dtype=torch.float32)
    if ctx.dim() == 2:
        ctx = ctx[None]
    out = []
    for m in range(ctx.shape[0]):
        d = torch.stack([torch.linalg.norm(emb - vec[None], dim=-1) for vec in ctx[m]])
        dist, idx = torch.sort(d, dim=-1, stable=True)
        dist, idx = dist[:, :topk].cpu().tolist(), idx[:, :topk].cpu().tolist()
        out.append([[(tok.decoder[i], v) for i, v in zip(ii, dd)] for ii, dd in zip(idx, dist)])
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("fpath", help="prompt checkpoint path")
    p.add_argument("topk", type=int, nargs="?", default=5)
    p.add_argument("--backbone", default="ViT-B/16")
    return p


def cli(argv=None, device="cuda") -> list:
    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.train.trainer import load_clip_backbone
    from mvlpt_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    sd = load_prompt_checkpoint(args.fpath)["state_dict"]
    key = next((k for k in ("coop.ctx", "cocoop.ctx", "ctx") if k in sd), None)
    assert key, f"no ctx tensor in checkpoint; keys: {sorted(sd)}"
    ctx = torch.as_tensor(np.asarray(sd[key], np.float32))
    print(f"Size of context: {tuple(ctx.shape)}")

    # the weights resolve as the trainer's (env ckpt path / local cache)
    cfg = get_cfg_default()
    cfg.MODEL.BACKBONE.NAME = args.backbone
    params, _ = load_clip_backbone(cfg, torch.float32, device)
    rows = interpret(ctx, params["text"]["token_embedding"], args.topk)
    for m, set_rows in enumerate(rows):
        print(f"--- context set {m} ---")
        for i, row in enumerate(set_rows):
            words = ", ".join(f"{w!r} ({d:.4f})" for w, d in row)
            print(f"ctx[{i}]: {words}")
    return rows


if __name__ == "__main__":
    cli()
