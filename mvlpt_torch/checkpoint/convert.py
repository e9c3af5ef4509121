"""OpenAI CLIP checkpoint -> the port's backbone.

The counterpart of the OpenAI-format half of ``mvlpt_tpu/checkpoint/
convert.py``: the config is inferred from the tensor shapes alone (ViT
detected by ``visual.proj``, layers counted by key prefixes, as CLIP's
own ``build_model`` does), every linear kernel is transposed to the
right-multiplied (in, out) layout, and the patch convolution becomes a
(P*P*3, W) matmul kernel in ``core.vit.patchify``'s (ph, pw, c) row
order. The result is the schema ``checkpoint/from_jax.py`` gives, so
both packages hold the same numbers.

A ModifiedResNet checkpoint (no ``visual.proj``) converts through
``convert_openai_rn_state_dict``: its visual tree follows
``core/resnet.py``'s schema, conv kernels kept (O, I, KH, KW) in
channels_last memory, and its text tower converts as a ViT's does.

``convert_hf_clip`` converts a transformers ``CLIPModel`` (q, k and v
projections concatenated into the fused qkv kernel). ``load_clip``
reads a local file, or an OpenAI model name from the local cache
(``find_cached_clip``, sha256-checked): nothing here fetches a file.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from mvlpt_torch.core import resnet
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
        image_resolution=vision_patch_size * grid,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        **_text_fields(sd),
    )


def _text_fields(sd: dict) -> dict:
    """The text tower's CLIPConfig fields (and embed_dim), from its shapes."""
    return dict(
        embed_dim=_np(sd["text_projection"]).shape[1],
        context_length=_np(sd["positional_embedding"]).shape[0],
        vocab_size=_np(sd["token_embedding.weight"]).shape[0],
        transformer_width=_np(sd["ln_final.weight"]).shape[0],
        transformer_heads=_np(sd["ln_final.weight"]).shape[0] // 64,
        transformer_layers=len({
            k.split(".")[2] for k in sd
            if k.startswith("transformer.resblocks.") and k.endswith(".ln_1.weight")
        }),
    )


def _text_tree(sd: dict, n_layers: int) -> dict:
    """The text tower and logit_scale of an OpenAI-format state_dict (numpy)."""
    return {
        "text": {
            "token_embedding": _np(sd["token_embedding.weight"]),
            "pos_embedding": _np(sd["positional_embedding"]),
            "blocks": _stack_openai_blocks(sd, "transformer", n_layers),
            "ln_final": {"scale": _np(sd["ln_final.weight"]),
                         "bias": _np(sd["ln_final.bias"])},
            "text_projection": _np(sd["text_projection"]),
        },
        "logit_scale": _np(sd["logit_scale"]),
    }


def _to_device(params: dict, dtype, device) -> dict:
    """numpy leaves -> tensors on ``device`` in ``dtype``, logit_scale an
    fp32 scalar, as the schema has it (core/clip.py)."""
    params = tree_map(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype),
        params)
    params["logit_scale"] = params["logit_scale"].float().reshape(())
    return params


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
        **_text_tree(sd, cfg.transformer_layers),
    }
    return _to_device(params, dtype, device), cfg


def _stack_hf_blocks(sd: dict, prefix: str, n_layers: int) -> dict:
    """``prefix.layers.{i}.*`` of a transformers CLIP tower -> the stacked
    block tree of ``core.clip.init_block_stack`` (numpy, kernels (in, out),
    q, k and v concatenated in that order)."""
    def g(i, name):
        return _np(sd[f"{prefix}.layers.{i}.{name}"])

    def stack(fn):
        return np.stack([fn(i) for i in range(n_layers)])

    return {
        "ln_1": {"scale": stack(lambda i: g(i, "layer_norm1.weight")),
                 "bias": stack(lambda i: g(i, "layer_norm1.bias"))},
        "attn": {
            "qkv_w": stack(lambda i: np.concatenate(
                [g(i, f"self_attn.{p}_proj.weight").T for p in ("q", "k", "v")], axis=1)),
            "qkv_b": stack(lambda i: np.concatenate(
                [g(i, f"self_attn.{p}_proj.bias") for p in ("q", "k", "v")])),
            "out_w": stack(lambda i: g(i, "self_attn.out_proj.weight").T),
            "out_b": stack(lambda i: g(i, "self_attn.out_proj.bias")),
        },
        "ln_2": {"scale": stack(lambda i: g(i, "layer_norm2.weight")),
                 "bias": stack(lambda i: g(i, "layer_norm2.bias"))},
        "mlp": {
            "fc_w": stack(lambda i: g(i, "mlp.fc1.weight").T),
            "fc_b": stack(lambda i: g(i, "mlp.fc1.bias")),
            "proj_w": stack(lambda i: g(i, "mlp.fc2.weight").T),
            "proj_b": stack(lambda i: g(i, "mlp.fc2.bias")),
        },
    }


def convert_hf_clip(model_or_sd, dtype=torch.float32, device="cuda"):
    """A transformers ``CLIPModel`` -> (backbone, CLIPConfig), the
    counterpart of ``mvlpt_tpu/checkpoint/convert.py:convert_hf_clip``:
    the backbone on ``device`` (the card unless the caller asks for the
    CPU) in ``dtype``, ``logit_scale`` fp32. As there, only a model
    instance is taken (its config names the shapes)."""
    if not hasattr(model_or_sd, "state_dict"):
        raise TypeError("pass a transformers CLIPModel instance")
    device = resolve_device(device)
    hf_cfg = model_or_sd.config
    sd = model_or_sd.state_dict()
    v, t = hf_cfg.vision_config, hf_cfg.text_config
    cfg = CLIPConfig(
        embed_dim=hf_cfg.projection_dim,
        image_resolution=v.image_size,
        vision_layers=v.num_hidden_layers,
        vision_width=v.hidden_size,
        vision_patch_size=v.patch_size,
        context_length=t.max_position_embeddings,
        vocab_size=t.vocab_size,
        transformer_width=t.hidden_size,
        transformer_heads=t.num_attention_heads,
        transformer_layers=t.num_hidden_layers,
        vision_heads_override=v.num_attention_heads,
    )
    conv = _np(sd["vision_model.embeddings.patch_embedding.weight"])
    params = {
        "visual": {
            "patch_embed": {"kernel": conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0])},
            "class_embedding": _np(sd["vision_model.embeddings.class_embedding"]),
            "pos_embedding": _np(sd["vision_model.embeddings.position_embedding.weight"]),
            "ln_pre": {"scale": _np(sd["vision_model.pre_layrnorm.weight"]),
                       "bias": _np(sd["vision_model.pre_layrnorm.bias"])},
            "blocks": _stack_hf_blocks(sd, "vision_model.encoder", cfg.vision_layers),
            "ln_post": {"scale": _np(sd["vision_model.post_layernorm.weight"]),
                        "bias": _np(sd["vision_model.post_layernorm.bias"])},
            "proj": _np(sd["visual_projection.weight"]).T,
        },
        "text": {
            "token_embedding": _np(sd["text_model.embeddings.token_embedding.weight"]),
            "pos_embedding": _np(sd["text_model.embeddings.position_embedding.weight"]),
            "blocks": _stack_hf_blocks(sd, "text_model.encoder", cfg.transformer_layers),
            "ln_final": {"scale": _np(sd["text_model.final_layer_norm.weight"]),
                         "bias": _np(sd["text_model.final_layer_norm.bias"])},
            "text_projection": _np(sd["text_projection.weight"]).T,
        },
        "logit_scale": _np(sd["logit_scale"]),
    }
    return _to_device(params, dtype, device), cfg


def _bn_params(sd: dict, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"]),
            "mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])}


def rn_config_from_state_dict(sd: dict) -> resnet.RNConfig:
    """The ModifiedResNet config of an OpenAI-format state_dict, from its
    shapes."""
    counts = tuple(len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}.")})
                   for b in (1, 2, 3, 4))
    width = _np(sd["visual.layer1.0.conv1.weight"]).shape[0]
    out_dim = _np(sd["visual.attnpool.c_proj.weight"]).shape[0]
    grid = int(round((_np(sd["visual.attnpool.positional_embedding"]).shape[0] - 1) ** 0.5))
    return resnet.RNConfig(layers=counts, output_dim=out_dim, width=width,
                           input_resolution=grid * 32, heads=width * 32 // 64)


def convert_openai_rn_state_dict(sd: dict, dtype=torch.float32, device="cuda"):
    """OpenAI RN* state_dict -> (backbone, RNConfig, text CLIPConfig): the
    visual tree in ``core/resnet.py``'s schema, the text tower as a ViT
    checkpoint's, on ``device`` (the card unless the caller asks for the
    CPU) in ``dtype``, ``logit_scale`` fp32."""
    device = resolve_device(device)
    rn_cfg = rn_config_from_state_dict(sd)

    def proj(name):
        return {"kernel": _np(sd[f"visual.attnpool.{name}.weight"]).T,
                "bias": _np(sd[f"visual.attnpool.{name}.bias"])}

    def convs_and_bns(prefix):
        # conv weights stay (O, I, KH, KW): the JAX package turns them HWIO
        out = {}
        for i in (1, 2, 3):
            out[f"conv{i}"] = {"kernel": _np(sd[f"{prefix}.conv{i}.weight"])}
            out[f"bn{i}"] = _bn_params(sd, f"{prefix}.bn{i}")
        return out

    def bottleneck(prefix):
        p = convs_and_bns(prefix)
        if f"{prefix}.downsample.0.weight" in sd:
            p["downsample"] = {"conv": {"kernel": _np(sd[f"{prefix}.downsample.0.weight"])},
                               "bn": _bn_params(sd, f"{prefix}.downsample.1")}
        return p

    visual = {"stem": convs_and_bns("visual"),
              "attnpool": {"pos_embedding": _np(sd["visual.attnpool.positional_embedding"]),
                           "q_proj": proj("q_proj"), "k_proj": proj("k_proj"),
                           "v_proj": proj("v_proj"), "c_proj": proj("c_proj")}}
    for b, n in zip((1, 2, 3, 4), rn_cfg.layers):
        visual[f"layer{b}"] = [bottleneck(f"visual.layer{b}.{i}") for i in range(n)]
    text_cfg = CLIPConfig(**_text_fields(sd))
    params = _to_device({"visual": visual, **_text_tree(sd, text_cfg.transformer_layers)},
                        dtype, device)
    params["visual"] = resnet.conv_layout(params["visual"])
    return params, rn_cfg, text_cfg


def load_clip(name_or_path: str, dtype=torch.float32, device="cuda"):
    """(backbone, config) from an OpenAI CLIP ``.pt`` file: a TorchScript
    archive or a plain state_dict (under ``state_dict`` or bare), given by
    its path or by its OpenAI model name (``find_cached_clip``: the local
    cache, sha256-checked). A ViT gives its ``CLIPConfig``, a
    ModifiedResNet (no ``visual.proj``) its ``RNConfig``, as the JAX
    package's does. Nothing is fetched: where the JAX package would
    download a named model, and for a missing file, this raises."""
    path = name_or_path
    if name_or_path in {**OPENAI_RN_FILES, **OPENAI_VIT_FILES}:
        path = find_cached_clip(name_or_path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no CLIP checkpoint at {path!r}; give the path of a local "
                                "OpenAI .pt file (nothing is downloaded)")
    try:
        sd = torch.jit.load(path, map_location="cpu").eval().state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
    if "visual.proj" not in sd:
        params, rn_cfg, _ = convert_openai_rn_state_dict(sd, dtype=dtype, device=device)
        return params, rn_cfg
    return convert_openai_state_dict(sd, dtype=dtype, device=device)


# The OpenAI checkpoints by model name: the file name the reference's
# loader caches under ~/.cache/clip and its sha256 (clip/clip.py:29-38).
OPENAI_RN_FILES = {
    "RN50": ("RN50.pt", "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762"),
    "RN101": ("RN101.pt", "8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599"),
    "RN50x4": ("RN50x4.pt", "7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd"),
    "RN50x16": ("RN50x16.pt",
                "52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa"),
    "RN50x64": ("RN50x64.pt",
                "be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c"),
}
OPENAI_VIT_FILES = {
    "ViT-B/32": ("ViT-B-32.pt", "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af"),
    "ViT-B/16": ("ViT-B-16.pt", "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f"),
    "ViT-L/14": ("ViT-L-14.pt", "b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836"),
    "ViT-L/14@336px": ("ViT-L-14-336px.pt",
                       "3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02"),
}


def find_cached_clip(name: str, root: str | None = None) -> str:
    """The path of model ``name``'s OpenAI checkpoint in the local cache
    (``~/.cache/clip``), checked against its sha256. Where the JAX package
    would download it, this raises: the port fetches nothing."""
    files = {**OPENAI_RN_FILES, **OPENAI_VIT_FILES}
    if name not in files:
        raise FileNotFoundError(f"no OpenAI checkpoint is known by the name {name!r}; "
                                f"known: {sorted(files)}")
    fname, sha = files[name]
    path = os.path.join(root or os.path.expanduser("~/.cache/clip"), fname)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{name}: no checkpoint at {path!r}, and nothing is downloaded (the port downloads "
            "nothing where the JAX package would fetch the file): put the OpenAI file there, "
            "or name a local file with MVLPT_TPU_CLIP_CKPT")
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    if digest.hexdigest() != sha:
        raise RuntimeError(f"{path!r} does not have the sha256 of the OpenAI {name} checkpoint")
    return path
