"""The system under test, built from a configuration file and the seed.

The benchmark makes the inputs of both sides itself: the frozen CLIP
weights in the port's parameter schema (drawn on the device, in the
compute dtype, a few large calls), the fp32 prompt leaves, and the class
names. From the port it takes only its entry points: ``MVLPTModel``,
``build_prompt_consts`` (which tokenizes and embeds the class prompts),
the train state and the step builders.
"""

from __future__ import annotations

import dataclasses
import math
import types

import numpy as np
import torch

# The streams drawn from one --seed.
STREAMS = ("weights", "prompts", "data")


def seeds(seed: int) -> dict:
    """One independent 63-bit seed a stream, from any whole number."""
    state = np.random.SeedSequence(abs(int(seed))).generate_state(len(STREAMS), np.uint64)
    return {name: int(s) >> 1 for name, s in zip(STREAMS, state)}


def classnames(cfg: dict) -> list:
    cls = cfg["classes"]
    if "numbered" in cls:
        return [f"{cls['prefix']} {i}" for i in range(cls["numbered"])]
    return [name for task in cls["tasks"] for name in task["classes"]]


def task_bounds(cfg: dict) -> list | None:
    """[(start, end)] of each task's classes in the global order, or None
    for a single task."""
    tasks = cfg["classes"].get("tasks")
    if tasks is None:
        return None
    out, start = [], 0
    for task in tasks:
        out.append((start, start + len(task["classes"])))
        start += len(task["classes"])
    return out


def _randn(gen, shape, std, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(std)


def _block_stack(gen, n_layers: int, width: int, dtype, device) -> dict:
    """CLIP's block init (normal weights, width-dependent stds), with the
    LayerNorm scales and every bias perturbed so that the comparison sees
    them."""
    def ln():
        return {"scale": 1 + _randn(gen, (n_layers, width), 0.1, dtype, device),
                "bias": _randn(gen, (n_layers, width), 0.02, dtype, device)}

    proj_std = width ** -0.5 * (2 * n_layers) ** -0.5
    return {
        "ln_1": ln(),
        "attn": {"qkv_w": _randn(gen, (n_layers, width, 3 * width), width ** -0.5, dtype, device),
                 "qkv_b": _randn(gen, (n_layers, 3 * width), 0.02, dtype, device),
                 "out_w": _randn(gen, (n_layers, width, width), proj_std, dtype, device),
                 "out_b": _randn(gen, (n_layers, width), 0.02, dtype, device)},
        "ln_2": ln(),
        "mlp": {"fc_w": _randn(gen, (n_layers, width, 4 * width), (2 * width) ** -0.5, dtype,
                               device),
                "fc_b": _randn(gen, (n_layers, 4 * width), 0.02, dtype, device),
                "proj_w": _randn(gen, (n_layers, 4 * width, width), proj_std, dtype, device),
                "proj_b": _randn(gen, (n_layers, width), 0.02, dtype, device)},
    }


def make_backbone(clip: dict, seed: int, dtype, device) -> dict:
    """The frozen CLIP tower weights in the port's schema, from the seed,
    drawn on ``device`` in ``dtype`` (logit_scale fp32)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    vw, tw, p = clip["vision_width"], clip["transformer_width"], clip["vision_patch_size"]
    grid = clip["image_resolution"] // p
    ln = lambda w: {"scale": 1 + _randn(gen, (w,), 0.1, dtype, device),  # noqa: E731
                    "bias": _randn(gen, (w,), 0.02, dtype, device)}
    return {
        "visual": {
            "patch_embed": {"kernel": _randn(gen, (p * p * 3, vw), vw ** -0.5, dtype, device)},
            "class_embedding": _randn(gen, (vw,), vw ** -0.5, dtype, device),
            "pos_embedding": _randn(gen, (1 + grid * grid, vw), vw ** -0.5, dtype, device),
            "ln_pre": ln(vw),
            "blocks": _block_stack(gen, clip["vision_layers"], vw, dtype, device),
            "ln_post": ln(vw),
            "proj": _randn(gen, (vw, clip["embed_dim"]), vw ** -0.5, dtype, device),
        },
        "text": {
            "token_embedding": _randn(gen, (clip["vocab_size"], tw), 0.02, dtype, device),
            "pos_embedding": _randn(gen, (clip["context_length"], tw), 0.01, dtype, device),
            "blocks": _block_stack(gen, clip["transformer_layers"], tw, dtype, device),
            "ln_final": ln(tw),
            "text_projection": _randn(gen, (tw, clip["embed_dim"]), tw ** -0.5, dtype, device),
        },
        "logit_scale": torch.tensor(math.log(1 / 0.07), dtype=torch.float32, device=device),
    }


def make_prompt_params(cfg: dict, seed: int, device) -> dict:
    """The UPT prompt leaves (fp32) in the port's schema, from the seed,
    with MVLPT's init distributions: VPT xavier-uniform, the CoOp context
    N(0, 0.02), nn.Linear's default for the coupler's projections, CLIP's
    block init for its transformer."""
    clip, pr = cfg["clip"], cfg["prompt"]
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = torch.float32
    vw, tw, d = clip["vision_width"], clip["transformer_width"], pr["project_dim"]
    n_vpt = pr["vpt_n_ctx"]

    def uniform(shape, bound):
        return torch.rand(shape, generator=gen, device=device).mul_(2 * bound).sub_(bound)

    def linear(n_in, n_out):
        bound = n_in ** -0.5
        return {"kernel": uniform((n_in, n_out), bound), "bias": uniform((n_out,), bound)}

    val = math.sqrt(6.0 / (3 * clip["vision_patch_size"] ** 2 + vw))
    coupler = _block_stack(gen, 1, d, f32, device)
    return {
        "vpt": {"embeddings": uniform((1, n_vpt, vw), val),
                "embeddings_deep": uniform((clip["vision_layers"] - 1, n_vpt, vw), val)},
        "coop": {"ctx": _randn(gen, (pr["coop_n_ctx"], tw), 0.02, f32, device)},
        "mvlpt_proj": {"coop_pre": linear(tw, d), "coop_post": linear(d, tw),
                       "vpt_pre": linear(vw, d), "vpt_post": linear(d, vw),
                       "transformer": coupler},
    }


@dataclasses.dataclass
class Program:
    """The port's objects for one cell: model, frozen weights, the class
    prompts' consts, the initial prompt leaves, and the step inputs."""

    cfg: dict
    model: object
    backbone: dict
    consts: object
    prompt_params: dict
    task_ranges: object          # custom_clip.TaskClassRanges or None
    normalize: tuple
    optim: types.SimpleNamespace
    text_len: int                # s: the class prompts' token count
    device: torch.device


def build(cfg: dict, seed: int, device) -> Program:
    """The port's model and inputs for ``cfg`` from ``seed``."""
    from mvlpt_torch.core.clip import CLIPConfig
    from mvlpt_torch.models.custom_clip import MVLPTModel, TaskClassRanges
    from mvlpt_torch.ops.attention import select_attn_fn
    from mvlpt_torch.prompts import PromptSpec, build_prompt_consts, compute_cut_context_length

    device = torch.device(device)
    clip, pr = cfg["clip"], cfg["prompt"]
    dtype = getattr(torch, cfg["compute_dtype"])
    streams = seeds(seed)
    clip_cfg = CLIPConfig(
        embed_dim=clip["embed_dim"], image_resolution=clip["image_resolution"],
        vision_layers=clip["vision_layers"], vision_width=clip["vision_width"],
        vision_patch_size=clip["vision_patch_size"], context_length=clip["context_length"],
        vocab_size=clip["vocab_size"], transformer_width=clip["transformer_width"],
        transformer_heads=clip["transformer_heads"], transformer_layers=clip["transformer_layers"],
        vision_heads_override=clip["vision_heads"])
    names = classnames(cfg)
    spec = PromptSpec(
        n_cls=len(names), coop_n_ctx=pr["coop_n_ctx"], vpt_n_ctx=pr["vpt_n_ctx"],
        vpt_deep=pr["vpt_deep"], class_token_position=pr["class_token_position"],
        project_method=pr["project_method"], project_dim=pr["project_dim"],
        context_length=compute_cut_context_length(names, pr["coop_n_ctx"],
                                                  clip["context_length"]),
        vision_layers=clip["vision_layers"], vision_width=clip["vision_width"],
        text_width=clip["transformer_width"], embed_dim=clip["embed_dim"],
        vision_patch_size=clip["vision_patch_size"])
    backbone = make_backbone(clip, streams["weights"], dtype, device)
    bounds = task_bounds(cfg)
    ranges = None if bounds is None else TaskClassRanges(
        start=torch.tensor([b[0] for b in bounds], device=device),
        end=torch.tensor([b[1] for b in bounds], device=device))
    return Program(
        cfg=cfg,
        model=MVLPTModel(clip_cfg, spec, kernels=select_attn_fn(cfg["kernels"]),
                         compute_dtype=dtype, remat=cfg["remat"]),
        backbone=backbone,
        consts=build_prompt_consts(names, spec, backbone, dtype),
        prompt_params=make_prompt_params(cfg, streams["prompts"], device),
        task_ranges=ranges,
        normalize=(tuple(cfg["normalize"]["mean"]), tuple(cfg["normalize"]["std"])),
        optim=types.SimpleNamespace(**cfg["optim"]),
        text_len=spec.context_length,
        device=device)
