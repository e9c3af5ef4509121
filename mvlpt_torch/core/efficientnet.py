"""EfficientNet feature extractor (timm layout).

The counterpart of ``mvlpt_tpu/core/efficientnet.py``: the reference's
timm branch wraps efficientnets in ``EvalModel`` and returns pooled
features (trainers/vision_benchmark/evaluation/feature.py:251-255). The
native-torch timm variant: symmetric conv padding, BatchNorm eps 1e-5,
SiLU. The ``tf_*`` checkpoints (TensorFlow's asymmetric SAME padding)
are another family, refused by name in models/zoo.py.

B0's table compound-scaled: MBConv inverted residuals with depthwise
k x k convs and squeeze-excitation (ratio 0.25 of the block's INPUT
channels), stage strides (1, 2, 2, 2, 1, 2, 1), a 3x3/2 stem, a 1x1 head
conv to 1280 x width, global average pooling. The JAX package's rounding
points: each conv sums in fp32 and rounds once (``resnet._conv``), the
BatchNorm folds in fp32 (``resnet._bn``), the SE products and their
bias adds run in the compute dtype. NHWC images read as channels_last
NCHW views; kernels (O, I/groups, KH, KW) channels_last, the depthwise
ones (C, 1, k, k); the SE's linear kernels (in, out).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mvlpt_torch.core.resnet import _bn, _conv, conv_layout
from mvlpt_torch.core.zoo import _mean
from mvlpt_torch.utils.device import resolve_device
from mvlpt_torch.utils.tree import tree_map

__all__ = ["EffNetConfig", "EFFNET_CONFIGS", "effnet_features", "init_effnet_params"]

# per stage: (n_blocks, kernel, stride, expand_ratio, c_out) — B0 table
_B0_STAGES = ((1, 3, 1, 1, 16), (2, 3, 2, 6, 24), (2, 5, 2, 6, 40),
              (3, 3, 2, 6, 80), (3, 5, 1, 6, 112), (4, 5, 2, 6, 192),
              (1, 3, 1, 6, 320))


def _round_channels(c: float, divisor: int = 8) -> int:
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def _scaled(width_mult: float, depth_mult: float, res: int) -> "EffNetConfig":
    stages = tuple((int(math.ceil(n * depth_mult)), k, s, t, _round_channels(c * width_mult))
                   for (n, k, s, t, c) in _B0_STAGES)
    return EffNetConfig(stages=stages, stem_ch=_round_channels(32 * width_mult),
                        head_ch=_round_channels(1280 * width_mult), input_resolution=res)


@dataclasses.dataclass(frozen=True)
class EffNetConfig:
    stages: tuple = _B0_STAGES
    stem_ch: int = 32
    head_ch: int = 1280
    se_ratio: float = 0.25
    input_resolution: int = 224


EFFNET_CONFIGS = {
    "efficientnet_b0": _scaled(1.0, 1.0, 224),
    "efficientnet_b1": _scaled(1.0, 1.1, 240),
    "efficientnet_b2": _scaled(1.1, 1.2, 260),
    "efficientnet_b3": _scaled(1.2, 1.4, 300),
    "efficientnet_b4": _scaled(1.4, 1.8, 380),
}


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _se(x: torch.Tensor, p: dict) -> torch.Tensor:
    pooled = _mean(x, (2, 3))  # (B, C)
    r = _silu(pooled @ p["reduce_w"].to(x.dtype) + p["reduce_b"].to(x.dtype))
    gate = torch.sigmoid(r @ p["expand_w"].to(x.dtype) + p["expand_b"].to(x.dtype))
    return x * gate[:, :, None, None]


def _ds_block(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    """DepthwiseSeparableConv (stage 0): dw -> SE -> pw-linear."""
    out = _silu(_bn(_conv(x, p["conv_dw"], stride, groups=x.shape[1]), p["bn1"]))
    out = _se(out, p["se"])
    out = _bn(_conv(out, p["conv_pw"]), p["bn2"])
    if out.shape == x.shape and stride == 1:
        out = out + x
    return out


def _ir_block(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    """InvertedResidual: pw-expand -> dw -> SE -> pw-linear."""
    out = _silu(_bn(_conv(x, p["conv_pw"]), p["bn1"]))
    out = _silu(_bn(_conv(out, p["conv_dw"], stride, groups=out.shape[1]), p["bn2"]))
    out = _se(out, p["se"])
    out = _bn(_conv(out, p["conv_pwl"]), p["bn3"])
    if out.shape == x.shape and stride == 1:
        out = out + x
    return out


def effnet_features(params: dict, images: torch.Tensor, cfg: EffNetConfig) -> torch.Tensor:
    """(B, H, W, 3) preprocessed floats -> (B, head_ch) pooled features
    (EvalModel children()[:-1]: the classifier dropped), in the dtype of
    the weights."""
    x = images.permute(0, 3, 1, 2).to(params["conv_stem"].dtype)
    x = _silu(_bn(_conv(x, params["conv_stem"], stride=2), params["bn1"]))
    for stage_params, (_, _, s, _, _) in zip(params["stages"], cfg.stages):
        for j, p in enumerate(stage_params):
            block = _ds_block if "conv_pwl" not in p else _ir_block
            x = block(x, p, s if j == 0 else 1)
    x = _silu(_bn(_conv(x, params["conv_head"]), params["bn2"]))
    return _mean(x, (2, 3))


def init_effnet_params(gen: torch.Generator, cfg: EffNetConfig, dtype=torch.float32,
                       device="cuda") -> dict:
    """A random tree with timm's shapes (offline use), drawn on the host
    from ``gen`` (not the JAX package's draws: tests carry weights across
    with ``checkpoint.zoo_params_from_jax``), on ``device`` in ``dtype``."""
    device = resolve_device(device)

    def conv(kh, kw, cin, cout):
        return torch.randn((cout, cin, kh, kw), generator=gen) * (kh * kw * cin) ** -0.5

    def bn(c):
        return {"scale": torch.ones(c), "bias": torch.zeros(c), "mean": torch.zeros(c),
                "var": torch.ones(c)}

    def se(mid, rd):
        return {"reduce_w": torch.randn((mid, rd), generator=gen) * mid ** -0.5,
                "reduce_b": torch.zeros(rd),
                "expand_w": torch.randn((rd, mid), generator=gen) * rd ** -0.5,
                "expand_b": torch.zeros(mid)}

    params = {"conv_stem": conv(3, 3, 3, cfg.stem_ch), "bn1": bn(cfg.stem_ch), "stages": []}
    c_in = cfg.stem_ch
    for (n, k, _, t, c_out) in cfg.stages:
        stage = []
        for _ in range(n):
            rd = max(1, int(c_in * cfg.se_ratio))
            if t == 1:
                p = {"conv_dw": conv(k, k, 1, c_in), "bn1": bn(c_in), "se": se(c_in, rd),
                     "conv_pw": conv(1, 1, c_in, c_out), "bn2": bn(c_out)}
            else:
                mid = c_in * t
                p = {"conv_pw": conv(1, 1, c_in, mid), "bn1": bn(mid),
                     "conv_dw": conv(k, k, 1, mid), "bn2": bn(mid), "se": se(mid, rd),
                     "conv_pwl": conv(1, 1, mid, c_out), "bn3": bn(c_out)}
            stage.append(p)
            c_in = c_out
        params["stages"].append(stage)
    params["conv_head"] = conv(1, 1, c_in, cfg.head_ch)
    params["bn2"] = bn(cfg.head_ch)
    return conv_layout(tree_map(lambda t: t.to(device=device, dtype=dtype), params))
