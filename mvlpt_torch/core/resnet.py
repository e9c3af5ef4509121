"""CLIP's ModifiedResNet visual tower (functional, inference mode).

The counterpart of ``mvlpt_tpu/core/resnet.py`` (the reference's
clip/model.py:10-150): a 3-conv stem, Bottleneck blocks whose strides
are anti-aliased (avgpool, then the 1x1 conv), and QKV attention pooling
where the mean token queries the spatial ones. An RN tower serves image
features only (the linear probe and feature extraction); prompt tuning
is ViT-only, as in the reference (mvlpt.py:47).

The tower is frozen wherever it runs, so BatchNorm is the inference
affine of the checkpoint's running statistics, folded in fp32. It has
no kernel of its own on either side: the JAX package runs XLA's
convolutions, this one cuDNN's (``torch.nn.functional.conv2d``).

Layout: the loader's batches are NHWC, and ``images.permute(0, 3, 1,
2)`` is already a channels_last NCHW view, which cuDNN takes as it is.
Conv kernels are stored (O, I, KH, KW) in channels_last memory
(``conv_layout``), converted once when the weights are made or loaded
and never per call; the JAX tree's HWIO kernels become these in
``from_hwio``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from mvlpt_torch.core import layers
from mvlpt_torch.utils.device import resolve_device
from mvlpt_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class RNConfig:
    layers: tuple[int, int, int, int] = (3, 4, 6, 3)  # RN50
    output_dim: int = 1024
    width: int = 64
    input_resolution: int = 224
    heads: int = 32  # width * 32 // 64


# Architecture table for the released RN checkpoints (a checkpoint's own
# comes from checkpoint.convert.rn_config_from_state_dict).
RN_ARCHS = {
    "RN50": RNConfig(layers=(3, 4, 6, 3), output_dim=1024, width=64,
                     input_resolution=224, heads=32),
    "RN101": RNConfig(layers=(3, 4, 23, 3), output_dim=512, width=64,
                      input_resolution=224, heads=32),
}


def conv_layout(visual: dict) -> dict:
    """Every conv kernel of an RN visual tree in channels_last memory, the
    layout cuDNN reads beside channels_last activations without a copy."""
    return tree_map(lambda t: t.contiguous(memory_format=torch.channels_last)
                    if t.dim() == 4 else t, visual)


def from_hwio(visual: dict) -> dict:
    """The JAX package's RN visual tree (conv kernels HWIO) -> this
    module's (O, I, KH, KW), channels_last."""
    return conv_layout(tree_map(lambda t: t.permute(3, 2, 0, 1) if t.dim() == 4 else t,
                                visual))


def _bn(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm over NCHW: scale and bias folded in fp32 from
    the params as they are stored, then ``x * scale + bias`` in x's dtype.
    Shared by every converted backbone, as ``_conv`` is."""
    inv = torch.rsqrt(p["var"].float() + eps)
    scale = (p["scale"].float() * inv).to(x.dtype)
    bias = (p["bias"].float() - p["mean"].float() * p["scale"].float() * inv).to(x.dtype)
    return x * scale[:, None, None] + bias[:, None, None]


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """torch's symmetric padding (k // 2 each side, not XLA's SAME), fp32
    accumulation, the result in x's dtype. ``groups`` splits the channels
    as XLA's ``feature_group_count``: a depthwise conv over C channels
    takes groups = C and a (C, 1, k, k) kernel. Shared by every converted
    backbone (this tower, core/zoo.py's ResNet, core/efficientnet.py)."""
    return F.conv2d(x, kernel.to(x.dtype), stride=stride, padding=kernel.shape[-1] // 2,
                    groups=groups)


def _avgpool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k windows summed in fp32, cast to x's dtype, then divided by k²."""
    s = F.avg_pool2d(x.float(), k, divisor_override=1)
    return s.to(x.dtype) / (k * k)


def _bottleneck(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    out = F.relu(_bn(_conv(x, p["conv1"]["kernel"]), p["bn1"]))
    out = F.relu(_bn(_conv(out, p["conv2"]["kernel"]), p["bn2"]))
    if stride > 1:  # anti-aliased stride: avgpool, then the 1x1 conv
        out = _avgpool(out, stride)
    out = _bn(_conv(out, p["conv3"]["kernel"]), p["bn3"])
    if "downsample" in p:
        identity = _avgpool(x, stride) if stride > 1 else x
        identity = _bn(_conv(identity, p["downsample"]["conv"]["kernel"]),
                       p["downsample"]["bn"])
    else:
        identity = x
    return F.relu(out + identity)


def attention_pool(x: torch.Tensor, p: dict, n_heads: int) -> torch.Tensor:
    """QKV attention pooling (clip/model.py:56-90) over (B, S, C) spatial
    tokens in h-major order: the mean token first, q scaled by d^-0.5
    before the product, the softmax in fp32. Returns (B, output_dim)."""
    b, s, c = x.shape
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)  # (B, 1+S, C)
    x = x + p["pos_embedding"].to(x.dtype)[None]
    q = layers._matmul(x[:, :1], p["q_proj"]["kernel"], p["q_proj"]["bias"])
    k = layers._matmul(x, p["k_proj"]["kernel"], p["k_proj"]["bias"])
    v = layers._matmul(x, p["v_proj"]["kernel"], p["v_proj"]["bias"])
    d = c // n_heads
    q = q.reshape(b, 1, n_heads, d)
    k = k.reshape(b, s + 1, n_heads, d)
    v = v.reshape(b, s + 1, n_heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", (q * d ** -0.5).float(), k.float())
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(x.dtype)
    return layers._matmul(o.reshape(b, c), p["c_proj"]["kernel"], p["c_proj"]["bias"])


def trunk_rn(params: dict, images: torch.Tensor) -> torch.Tensor:
    """NHWC images -> the (B, 32 width, H/32, W/32) map that the attention
    pool reads: the stem and the four stages, in the dtype of the tower's
    weights."""
    stem = params["stem"]
    x = images.permute(0, 3, 1, 2).to(stem["conv1"]["kernel"].dtype)
    x = F.relu(_bn(_conv(x, stem["conv1"]["kernel"], stride=2), stem["bn1"]))
    x = F.relu(_bn(_conv(x, stem["conv2"]["kernel"]), stem["bn2"]))
    x = F.relu(_bn(_conv(x, stem["conv3"]["kernel"]), stem["bn3"]))
    x = _avgpool(x, 2)
    for stage_idx in range(4):
        stride = 1 if stage_idx == 0 else 2
        for block_idx, block in enumerate(params[f"layer{stage_idx + 1}"]):
            x = _bottleneck(x, block, stride if block_idx == 0 else 1)
    return x


def encode_image_rn(params: dict, images: torch.Tensor, cfg: RNConfig) -> torch.Tensor:
    """NHWC images -> (B, output_dim) features (clip/model.py:138-150), in
    the dtype of the tower's weights."""
    x = trunk_rn(params, images)
    return attention_pool(x.flatten(2).transpose(1, 2), params["attnpool"], cfg.heads)


def init_rn_params(gen: torch.Generator, cfg: RNConfig, device="cuda") -> dict:
    """A random ModifiedResNet visual tree, drawn on the host from ``gen``
    and moved to ``device``: He-normal conv kernels, BatchNorm at identity
    (mean 0, var 1), the schema ``checkpoint.convert`` gives."""
    device = resolve_device(device)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=torch.float32) * std

    def conv(kh, kw, cin, cout):
        return {"kernel": normal((cout, cin, kh, kw), (2.0 / (kh * kw * cin)) ** 0.5)}

    def bn(c):
        return {"scale": torch.ones(c), "bias": torch.zeros(c),
                "mean": torch.zeros(c), "var": torch.ones(c)}

    def proj(cin, cout):
        return {"kernel": normal((cin, cout), cin ** -0.5), "bias": torch.zeros(cout)}

    w = cfg.width
    visual = {"stem": {"conv1": conv(3, 3, 3, w // 2), "bn1": bn(w // 2),
                       "conv2": conv(3, 3, w // 2, w // 2), "bn2": bn(w // 2),
                       "conv3": conv(3, 3, w // 2, w), "bn3": bn(w)}}
    inplanes = w
    for b, n_blocks in zip((1, 2, 3, 4), cfg.layers):
        planes = w * 2 ** (b - 1)
        blocks = []
        for i in range(n_blocks):
            p = {"conv1": conv(1, 1, inplanes if i == 0 else planes * 4, planes),
                 "bn1": bn(planes),
                 "conv2": conv(3, 3, planes, planes), "bn2": bn(planes),
                 "conv3": conv(1, 1, planes, planes * 4), "bn3": bn(planes * 4)}
            if i == 0:  # stride > 1 (layers 2-4) or a change of channels (layer 1)
                p["downsample"] = {"conv": conv(1, 1, inplanes, planes * 4),
                                   "bn": bn(planes * 4)}
            blocks.append(p)
        visual[f"layer{b}"] = blocks
        inplanes = planes * 4
    c = w * 32
    spacial = cfg.input_resolution // 32
    visual["attnpool"] = {"pos_embedding": normal((spacial ** 2 + 1, c), c ** -0.5),
                          "q_proj": proj(c, c), "k_proj": proj(c, c), "v_proj": proj(c, c),
                          "c_proj": proj(c, cfg.output_dim)}
    return conv_layout(tree_map(lambda t: t.to(device), visual))
