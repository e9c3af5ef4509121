"""OpenAI CLIP checkpoint -> the port's backbone.

The counterpart of the OpenAI-format half of ``mvlpt_tpu/checkpoint/
convert.py``: the config is inferred from the tensor shapes alone (ViT
detected by ``visual.proj``, layers counted by key prefixes, as CLIP's
own ``build_model`` does), every linear kernel is transposed to the
right-multiplied (in, out) layout, and the patch convolution becomes a
(P*P*3, W) matmul kernel in ``core.vit.patchify``'s (ph, pw, c) row
order. The result is the schema ``checkpoint/from_jax.py`` gives, so
both packages hold the same numbers.

``load_clip`` reads a local file only: nothing here fetches a file. The
HuggingFace and ModifiedResNet converters are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mvlpt_torch.core.clip import CLIPConfig
from mvlpt_torch.utils.device import resolve_device
from mvlpt_torch.utils.tree import tree_map


def _np(t) -> np.ndarray:
    """torch tensor / array-like -> numpy, fp16 and bf16 upcast to fp32
    (numpy has no bfloat16)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        t = t.numpy()
    t = np.asarray(t)
    if t.dtype == np.float16:
        t = t.astype(np.float32)
    return t


def config_from_state_dict(sd: dict) -> CLIPConfig:
    """The ViT CLIP config of an OpenAI-format state_dict, from its shapes."""
    if "visual.proj" not in sd:
        raise ValueError("only ViT CLIP backbones are supported by the prompt-tuning towers; "
                         "this state_dict has no 'visual.proj' (a ModifiedResNet checkpoint?)")
    conv1 = _np(sd["visual.conv1.weight"])
    vision_width = conv1.shape[0]
    vision_patch_size = conv1.shape[-1]
    vision_layers = len({
        k.split(".")[3] for k in sd
        if k.startswith("visual.transformer.resblocks.") and k.endswith(".ln_1.weight")
    })
    grid = int(round((_np(sd["visual.positional_embedding"]).shape[0] - 1) ** 0.5))
    return CLIPConfig(
        embed_dim=_np(sd["text_projection"]).shape[1],
        image_resolution=vision_patch_size * grid,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=_np(sd["positional_embedding"]).shape[0],
        vocab_size=_np(sd["token_embedding.weight"]).shape[0],
        transformer_width=_np(sd["ln_final.weight"]).shape[0],
        transformer_heads=_np(sd["ln_final.weight"]).shape[0] // 64,
        transformer_layers=len({
            k.split(".")[2] for k in sd
            if k.startswith("transformer.resblocks.") and k.endswith(".ln_1.weight")
        }),
    )


def _stack_openai_blocks(sd: dict, prefix: str, n_layers: int) -> dict:
    """``prefix.resblocks.{i}.*`` -> the stacked block tree of
    ``core.clip.init_block_stack`` (numpy, kernels (in, out))."""
    def g(i, name):
        return _np(sd[f"{prefix}.resblocks.{i}.{name}"])

    def stack(name, transpose=False):
        return np.stack([g(i, name).T if transpose else g(i, name) for i in range(n_layers)])

    return {
        "ln_1": {"scale": stack("ln_1.weight"), "bias": stack("ln_1.bias")},
        "attn": {
            "qkv_w": stack("attn.in_proj_weight", True),
            "qkv_b": stack("attn.in_proj_bias"),
            "out_w": stack("attn.out_proj.weight", True),
            "out_b": stack("attn.out_proj.bias"),
        },
        "ln_2": {"scale": stack("ln_2.weight"), "bias": stack("ln_2.bias")},
        "mlp": {
            "fc_w": stack("mlp.c_fc.weight", True),
            "fc_b": stack("mlp.c_fc.bias"),
            "proj_w": stack("mlp.c_proj.weight", True),
            "proj_b": stack("mlp.c_proj.bias"),
        },
    }


def convert_openai_state_dict(sd: dict, dtype=torch.float32, device="cuda"):
    """OpenAI-format state_dict -> (backbone, CLIPConfig): the backbone on
    ``device`` (the card unless the caller asks for the CPU) in ``dtype``,
    ``logit_scale`` fp32."""
    device = resolve_device(device)
    cfg = config_from_state_dict(sd)
    conv1 = _np(sd["visual.conv1.weight"])  # (W, 3, P, P)
    patch_kernel = conv1.transpose(2, 3, 1, 0).reshape(-1, conv1.shape[0])
    params = {
        "visual": {
            "patch_embed": {"kernel": patch_kernel},
            "class_embedding": _np(sd["visual.class_embedding"]),
            "pos_embedding": _np(sd["visual.positional_embedding"]),
            "ln_pre": {"scale": _np(sd["visual.ln_pre.weight"]),
                       "bias": _np(sd["visual.ln_pre.bias"])},
            "blocks": _stack_openai_blocks(sd, "visual.transformer", cfg.vision_layers),
            "ln_post": {"scale": _np(sd["visual.ln_post.weight"]),
                        "bias": _np(sd["visual.ln_post.bias"])},
            "proj": _np(sd["visual.proj"]),
        },
        "text": {
            "token_embedding": _np(sd["token_embedding.weight"]),
            "pos_embedding": _np(sd["positional_embedding"]),
            "blocks": _stack_openai_blocks(sd, "transformer", cfg.transformer_layers),
            "ln_final": {"scale": _np(sd["ln_final.weight"]),
                         "bias": _np(sd["ln_final.bias"])},
            "text_projection": _np(sd["text_projection"]),
        },
        "logit_scale": _np(sd["logit_scale"]),
    }
    params = tree_map(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype),
        params)
    params["logit_scale"] = params["logit_scale"].float()
    return params, cfg


def load_clip(path: str, dtype=torch.float32, device="cuda"):
    """(backbone, CLIPConfig) from a local OpenAI CLIP ``.pt`` file: a
    TorchScript archive or a plain state_dict (under ``state_dict`` or
    bare). Nothing is fetched: a model name or a missing file raises."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no CLIP checkpoint at {path!r}; give the path of a local "
                                "OpenAI .pt file (nothing is downloaded)")
    try:
        sd = torch.jit.load(path, map_location="cpu").eval().state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
    return convert_openai_state_dict(sd, dtype=dtype, device=device)
