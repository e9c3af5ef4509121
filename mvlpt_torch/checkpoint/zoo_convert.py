"""Torch state-dict converters for the non-CLIP model zoo.

The counterpart of ``mvlpt_tpu/checkpoint/zoo_convert.py``, straight
into the port's trees (core/zoo.py, core/efficientnet.py) with no JAX in
between. The layouts the reference's ``get_model`` branches name
(trainers/vision_benchmark/evaluation/feature.py:245-321):

* timm ViT / DeiT (``vit_*``, ``deit_*``): ``patch_embed.proj``,
  ``cls_token`` (+ ``dist_token``), ``pos_embed``, ``blocks.N.{norm1,
  attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}``, ``norm``.
* MAE: the same keys under a ``model`` dict; the fine-tuned variants
  replace ``norm`` with ``fc_norm`` and pool the patch tokens (pool
  'avg' is inferred from that).
* MoCo-v3: timm keys under ``state_dict`` / ``module.base_encoder.``;
  the projection head (``head.*``) is dropped like every classifier.
* torchvision ResNet: ``conv1/bn1``, ``layer{1..4}.{j}.conv*/bn*/
  downsample``; the classifier ``fc`` dropped.
* timm EfficientNet: ``conv_stem``, ``blocks.S.J.*``, ``conv_head``; the
  ``classifier`` dropped.

Every converter is strict: leftover keys raise, with the JAX package's
messages. Hyperparameters come from tensor shapes, not names. Torch
layouts carry over as they are: linear kernels transposed to (in, out),
conv kernels kept (O, I, KH, KW) and put in channels_last memory, and
the tensors moved to the run's device and dtype.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from mvlpt_torch.core.zoo import StdViTConfig, TVResNetConfig
from mvlpt_torch.utils.device import resolve_device

# width -> canonical head count for timm/MAE/MoCo-v3 ViTs (heads are not
# recoverable from tensor shapes; this is the published table)
_VIT_HEADS = {192: 3, 384: 6, 768: 12, 1024: 16, 1280: 16}


def _t(v) -> torch.Tensor:
    return v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def _unwrap_cnn_state_dict(sd: dict) -> dict:
    """Peel 'state_dict' / DataParallel 'module.' wrappers (the
    EfficientNet and torchvision-ResNet converters share it)."""
    sd = dict(sd)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = dict(sd["state_dict"])
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items() if k.startswith("module.")}
    return sd


def _conv_bn_readers(sd: dict, dtype, device):
    """Consuming readers of conv kernels (OIHW, channels_last) and
    BatchNorm statistics, the one definition both CNN converters share."""
    def conv(key):
        return _t(sd.pop(key)).to(device=device, dtype=dtype).contiguous(
            memory_format=torch.channels_last)

    def bn(prefix):
        out = {name: _t(sd.pop(f"{prefix}.{key}")).to(device=device, dtype=dtype)
               for name, key in (("scale", "weight"), ("bias", "bias"),
                                 ("mean", "running_mean"), ("var", "running_var"))}
        sd.pop(f"{prefix}.num_batches_tracked", None)
        return out

    return conv, bn


def _unwrap_vit_state_dict(sd: dict) -> dict:
    """Peel MAE ('model') / MoCo-v3 ('state_dict' + 'module.base_encoder.')
    wrappers down to bare timm keys."""
    for wrapper in ("model", "state_dict"):
        if wrapper in sd and isinstance(sd[wrapper], dict):
            sd = sd[wrapper]
    for prefix in ("module.base_encoder.", "base_encoder.", "module."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


def std_vit_config_from_state_dict(sd: dict) -> StdViTConfig:
    """Shape-driven config inference (the zoo's analogue of CLIP's
    ``build_model`` rules)."""
    sd = _unwrap_vit_state_dict(sd)
    width, _, patch, _ = _t(sd["patch_embed.proj.weight"]).shape  # (W, C, P, P)
    n_layers = 1 + max(int(m.group(1)) for k in sd if (m := re.match(r"blocks\.(\d+)\.", k)))
    n_prefix = 2 if "dist_token" in sd else 1
    n_patches = _t(sd["pos_embed"]).shape[1] - n_prefix
    res = int(round(n_patches ** 0.5)) * patch
    mlp_ratio = _t(sd["blocks.0.mlp.fc1.weight"]).shape[0] // width
    pool = "avg" if ("fc_norm.weight" in sd and "norm.weight" not in sd) else "cls"
    # heads: the published table, else the width // 64 rule every one of
    # these families follows (head_dim 64)
    return StdViTConfig(patch_size=patch, width=width, layers=n_layers,
                        heads=_VIT_HEADS.get(width, max(1, width // 64)), input_resolution=res,
                        mlp_ratio=mlp_ratio, n_prefix=n_prefix, pool=pool)


def convert_std_vit(sd: dict, dtype=torch.float32, device="cuda"):
    """timm/MAE/MoCo-v3 ViT state dict -> (params, StdViTConfig) for
    core/zoo.py:std_vit_features."""
    device = resolve_device(device)
    sd = dict(_unwrap_vit_state_dict(sd))
    cfg = std_vit_config_from_state_dict(sd)
    w = cfg.width

    def take(key):
        return _t(sd.pop(key))

    def put(t):
        return t.to(device=device, dtype=dtype).contiguous()

    def lin(prefix):
        return put(take(f"{prefix}.weight").t()), put(take(f"{prefix}.bias"))

    def ln(prefix):
        return {"scale": put(take(f"{prefix}.weight")), "bias": put(take(f"{prefix}.bias"))}

    pw = take("patch_embed.proj.weight")  # (W, C, P, P) -> (P*P*C, W), (ph, pw, c) rows
    prefix_tokens = [take("cls_token").reshape(1, w)]
    if "dist_token" in sd:
        prefix_tokens.append(take("dist_token").reshape(1, w))
    params = {
        "patch_embed": {"kernel": put(pw.permute(2, 3, 1, 0).reshape(-1, w)),
                        "bias": put(take("patch_embed.proj.bias"))},
        "prefix_tokens": put(torch.cat(prefix_tokens)),
        "pos_embed": put(take("pos_embed")[0]),
        "norm": ln("fc_norm" if cfg.pool == "avg" else "norm"),
        "blocks": [],
    }
    for i in range(cfg.layers):
        qkv_w, qkv_b = lin(f"blocks.{i}.attn.qkv")
        out_w, out_b = lin(f"blocks.{i}.attn.proj")
        fc_w, fc_b = lin(f"blocks.{i}.mlp.fc1")
        pr_w, pr_b = lin(f"blocks.{i}.mlp.fc2")
        params["blocks"].append({
            "ln_1": ln(f"blocks.{i}.norm1"),
            "attn": {"qkv_w": qkv_w, "qkv_b": qkv_b, "out_w": out_w, "out_b": out_b},
            "ln_2": ln(f"blocks.{i}.norm2"),
            "mlp": {"fc_w": fc_w, "fc_b": fc_b, "proj_w": pr_w, "proj_b": pr_b},
        })
    leftover = [k for k in sd
                if not (k.startswith("head") or k.startswith("pre_logits")
                        or k == "norm.weight" or k == "norm.bias"
                        or k.startswith("fc_norm") or k.startswith("mask_token")
                        or k.startswith("decoder") or k == "dist_token")]
    if leftover:
        raise ValueError(f"unconsumed ViT checkpoint keys: {leftover[:8]}")
    return params, cfg


def convert_effnet(sd: dict, dtype=torch.float32, device="cuda"):
    """timm EfficientNet state dict -> (params, EffNetConfig) for
    core/efficientnet.py:effnet_features. Shape-driven: block counts,
    kernel sizes, expansion and widths come from the tensors; only the
    stage strides (1, 2, 2, 2, 1, 2, 1) are an architecture constant
    (the same across B0-B7)."""
    from mvlpt_torch.core.efficientnet import EffNetConfig

    device = resolve_device(device)
    sd = _unwrap_cnn_state_dict(sd)
    conv, bn = _conv_bn_readers(sd, dtype, device)

    def se(prefix):
        def lin(name):
            return _t(sd.pop(f"{prefix}.{name}.weight"))[:, :, 0, 0].t().to(
                device=device, dtype=dtype).contiguous()

        def bias(name):
            return _t(sd.pop(f"{prefix}.{name}.bias")).to(device=device, dtype=dtype)

        return {"reduce_w": lin("conv_reduce"), "reduce_b": bias("conv_reduce"),
                "expand_w": lin("conv_expand"), "expand_b": bias("conv_expand")}

    n_stages = 1 + max(int(m.group(1)) for k in sd if (m := re.match(r"blocks\.(\d+)\.", k)))
    strides = (1, 2, 2, 2, 1, 2, 1)
    if n_stages != len(strides):
        raise ValueError(f"expected the 7-stage EfficientNet layout, got {n_stages}")

    params = {"conv_stem": conv("conv_stem.weight"), "bn1": bn("bn1"), "stages": []}
    stem_ch = params["conv_stem"].shape[0]
    cfg_stages = []
    c_in = stem_ch
    for s_idx in range(n_stages):
        n = 1 + max(int(m.group(1)) for k in sd
                    if (m := re.match(rf"blocks\.{s_idx}\.(\d+)\.", k)))
        stage = []
        for j in range(n):
            base = f"blocks.{s_idx}.{j}"
            if f"{base}.conv_pwl.weight" in sd:  # InvertedResidual
                p = {"conv_pw": conv(f"{base}.conv_pw.weight"), "bn1": bn(f"{base}.bn1"),
                     "conv_dw": conv(f"{base}.conv_dw.weight"), "bn2": bn(f"{base}.bn2"),
                     "se": se(f"{base}.se"),
                     "conv_pwl": conv(f"{base}.conv_pwl.weight"), "bn3": bn(f"{base}.bn3")}
                expand = p["conv_pw"].shape[0] // c_in
                c_out = p["conv_pwl"].shape[0]
            else:  # DepthwiseSeparableConv (stage 0)
                p = {"conv_dw": conv(f"{base}.conv_dw.weight"), "bn1": bn(f"{base}.bn1"),
                     "se": se(f"{base}.se"),
                     "conv_pw": conv(f"{base}.conv_pw.weight"), "bn2": bn(f"{base}.bn2")}
                expand = 1
                c_out = p["conv_pw"].shape[0]
            stage.append(p)
            if j == 0:
                stage_spec = [n, p["conv_dw"].shape[-1], strides[s_idx], expand, None]
            c_in = c_out
        stage_spec[4] = c_in
        cfg_stages.append(tuple(stage_spec))
        params["stages"].append(stage)
    params["conv_head"] = conv("conv_head.weight")
    params["bn2"] = bn("bn2")
    head_ch = params["conv_head"].shape[0]

    leftover = [k for k in sd if not k.startswith("classifier.")]
    if leftover:
        raise ValueError(f"unconsumed EfficientNet checkpoint keys: {leftover[:8]}")
    # the input resolution is not recoverable from shapes; 224 is only a
    # preprocessing default (the forward takes any resolution)
    return params, EffNetConfig(stages=tuple(cfg_stages), stem_ch=stem_ch, head_ch=head_ch)


def tv_resnet_config_from_state_dict(sd: dict) -> TVResNetConfig:
    bottleneck = "layer1.0.conv3.weight" in sd
    counts = []
    for stage in range(1, 5):
        counts.append(1 + max(int(m.group(1)) for k in sd
                              if (m := re.match(rf"layer{stage}\.(\d+)\.", k))))
    width = _t(sd["conv1.weight"]).shape[0]
    return TVResNetConfig(tuple(counts), bottleneck=bottleneck, width=width)


def convert_tv_resnet(sd: dict, dtype=torch.float32, device="cuda"):
    """torchvision ResNet state dict -> (params, TVResNetConfig) for
    core/zoo.py:tv_resnet_features."""
    device = resolve_device(device)
    sd = _unwrap_cnn_state_dict(sd)
    cfg = tv_resnet_config_from_state_dict(sd)
    conv, bn = _conv_bn_readers(sd, dtype, device)

    params = {"conv1": conv("conv1.weight"), "bn1": bn("bn1"), "stages": []}
    n_convs = 3 if cfg.bottleneck else 2
    for stage_idx, n in enumerate(cfg.layers):
        stage = []
        for j in range(n):
            base = f"layer{stage_idx + 1}.{j}"
            p = {}
            for c in range(1, n_convs + 1):
                p[f"conv{c}"] = conv(f"{base}.conv{c}.weight")
                p[f"bn{c}"] = bn(f"{base}.bn{c}")
            if f"{base}.downsample.0.weight" in sd:
                p["downsample"] = {"conv": conv(f"{base}.downsample.0.weight"),
                                   "bn": bn(f"{base}.downsample.1")}
            stage.append(p)
        params["stages"].append(stage)
    leftover = [k for k in sd if not k.startswith("fc.")]
    if leftover:
        raise ValueError(f"unconsumed ResNet checkpoint keys: {leftover[:8]}")
    return params, cfg
