"""Non-CLIP feature-extraction backbones (the ``get_model`` zoo).

The counterpart of ``mvlpt_tpu/core/zoo.py``: the runnable branches of
the reference's model zoo (trainers/vision_benchmark/evaluation/
feature.py:245-321) as functions over parameter trees.

* torchvision ResNet (``resnet18/34/50/101/152``, the "v1.5" layout with
  the stride on the 3x3 conv), through global average pooling: the
  reference's ``EvalModel`` (children()[:-1], classifier dropped).
* timm ``vit_*``/``deit_*`` ``forward_features``: the standard ViT with
  exact GELU, LayerNorm eps 1e-6, a positional embedding that covers the
  prefix tokens, no LayerNorm before the blocks; the class token's
  feature, or MAE's fc_norm over the mean of the patch tokens. MAE and
  MoCo-v3 checkpoints load into the same module
  (checkpoint/zoo_convert.py).

Frozen inference-mode extractors with the JAX package's rounding points.
No kernel of the repo runs here, as no Pallas runs on the JAX side: the
ViT runs ``layers.attention`` and ``layers._matmul`` (the plain path),
the CNNs cuDNN's convolutions. Images come in NHWC; the CNNs read them
as channels_last NCHW views, their conv kernels stored (O, I, KH, KW) in
channels_last memory (``resnet.conv_layout``). The ViT keeps its blocks
as a list, one dict a layer, as the JAX tree does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from mvlpt_torch.core import layers
from mvlpt_torch.core.resnet import _bn, _conv, conv_layout
from mvlpt_torch.core.vit import patchify
from mvlpt_torch.utils.device import resolve_device
from mvlpt_torch.utils.tree import tree_map

__all__ = [
    "StdViTConfig", "std_vit_features", "init_std_vit_params",
    "TVResNetConfig", "tv_resnet_features", "init_tv_resnet_params",
    "STD_VIT_CONFIGS", "TV_RESNET_CONFIGS",
]


# ---------------------------------------------------------------------------
# Standard ViT (timm layout): vit_*/deit_* forward_features
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StdViTConfig:
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    input_resolution: int = 224
    mlp_ratio: int = 4
    ln_eps: float = 1e-6          # timm ViT pins eps=1e-6
    n_prefix: int = 1             # 1 = cls; 2 = cls + dist (distilled deit)
    pool: str = "cls"             # "cls" | "avg" (MAE fine-tune global pool)


STD_VIT_CONFIGS = {
    "vit_small_patch16_224": StdViTConfig(16, 384, 12, 6),
    "vit_base_patch16_224": StdViTConfig(16, 768, 12, 12),
    "vit_base_patch32_224": StdViTConfig(32, 768, 12, 12),
    "vit_large_patch16_224": StdViTConfig(16, 1024, 24, 16),
    "deit_tiny_patch16_224": StdViTConfig(16, 192, 12, 3),
    "deit_small_patch16_224": StdViTConfig(16, 384, 12, 6),
    "deit_base_patch16_224": StdViTConfig(16, 768, 12, 12),
    "deit_base_distilled_patch16_224": StdViTConfig(16, 768, 12, 12, n_prefix=2),
}


def _gelu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    # exact GELU (timm/MAE/MoCo-v3), not CLIP's QuickGELU
    h = F.gelu(layers._matmul(x, p["fc_w"], p["fc_b"]), approximate="none")
    return layers._matmul(h, p["proj_w"], p["proj_b"])


def _std_block(x: torch.Tensor, p: dict, n_heads: int, eps: float) -> torch.Tensor:
    x = x + layers.attention(layers.layer_norm(x, p["ln_1"], eps=eps), p["attn"], n_heads)
    return x + _gelu_mlp(layers.layer_norm(x, p["ln_2"], eps=eps), p["mlp"])


def _mean(x: torch.Tensor, dim) -> torch.Tensor:
    """A mean summed in fp32 and rounded once to x's dtype, as jnp.mean."""
    return x.float().mean(dim=dim).to(x.dtype)


def std_vit_features(params: dict, images: torch.Tensor, cfg: StdViTConfig) -> torch.Tensor:
    """timm ``forward_features``: patchify -> prefix tokens -> +pos (over
    the prefix too) -> blocks -> final norm -> the class token, or for
    ``pool='avg'`` the fc_norm (stored as ``norm``) of the patch tokens'
    mean. (B, H, W, 3) preprocessed floats -> (B, width), in the dtype of
    the weights."""
    kernel = params["patch_embed"]["kernel"]  # (P*P*C, W)
    dtype = kernel.dtype
    x = patchify(images.to(dtype), cfg.patch_size)
    x = layers._matmul(x, kernel, params["patch_embed"]["bias"])
    prefix = params["prefix_tokens"].to(dtype)[None].expand(x.shape[0], cfg.n_prefix, cfg.width)
    x = torch.cat([prefix, x], dim=1)
    x = x + params["pos_embed"].to(dtype)[None]
    for p in params["blocks"]:
        x = _std_block(x, p, cfg.heads, cfg.ln_eps)
    if cfg.pool == "avg":
        return layers.layer_norm(_mean(x[:, cfg.n_prefix:], 1), params["norm"], eps=cfg.ln_eps)
    return layers.layer_norm(x, params["norm"], eps=cfg.ln_eps)[:, 0]


def init_std_vit_params(gen: torch.Generator, cfg: StdViTConfig, dtype=torch.float32,
                        device="cuda") -> dict:
    """A random tree with the converter's shapes (offline use; real use
    loads a converted state dict), drawn on the host from ``gen`` in fp32,
    then cast to ``dtype`` on ``device``. The draws cannot equal the JAX
    package's ``jax.random`` ones: tests carry weights across instead
    (``checkpoint.zoo_params_from_jax``)."""
    device = resolve_device(device)
    n_patches = (cfg.input_resolution // cfg.patch_size) ** 2
    w = cfg.width

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    def lin(i, o):
        return normal((i, o), i ** -0.5), torch.zeros(o)

    def ln():
        return {"scale": torch.ones(w), "bias": torch.zeros(w)}

    pk, pb = lin(cfg.patch_size * cfg.patch_size * 3, w)
    params = {"patch_embed": {"kernel": pk, "bias": pb},
              "prefix_tokens": normal((cfg.n_prefix, w), 0.02),
              "pos_embed": normal((cfg.n_prefix + n_patches, w), 0.02),
              "norm": ln(), "blocks": []}
    for _ in range(cfg.layers):
        qkv_w, qkv_b = lin(w, 3 * w)
        out_w, out_b = lin(w, w)
        fc_w, fc_b = lin(w, cfg.mlp_ratio * w)
        pr_w, pr_b = lin(cfg.mlp_ratio * w, w)
        params["blocks"].append({
            "ln_1": ln(), "attn": {"qkv_w": qkv_w, "qkv_b": qkv_b, "out_w": out_w,
                                   "out_b": out_b},
            "ln_2": ln(), "mlp": {"fc_w": fc_w, "fc_b": fc_b, "proj_w": pr_w, "proj_b": pr_b}})
    return tree_map(lambda t: t.to(device=device, dtype=dtype), params)


# ---------------------------------------------------------------------------
# torchvision ResNet (v1.5): EvalModel children()[:-1] semantics
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TVResNetConfig:
    layers: tuple = (3, 4, 6, 3)
    bottleneck: bool = True       # False = BasicBlock (resnet18/34)
    width: int = 64


TV_RESNET_CONFIGS = {
    "resnet18": TVResNetConfig((2, 2, 2, 2), bottleneck=False),
    "resnet34": TVResNetConfig((3, 4, 6, 3), bottleneck=False),
    "resnet50": TVResNetConfig((3, 4, 6, 3)),
    "resnet101": TVResNetConfig((3, 4, 23, 3)),
    "resnet152": TVResNetConfig((3, 8, 36, 3)),
}


def _downsample(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    if "downsample" in p:
        return _bn(_conv(x, p["downsample"]["conv"], stride), p["downsample"]["bn"])
    return x


def _basic_block(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    out = F.relu(_bn(_conv(x, p["conv1"], stride), p["bn1"]))
    out = _bn(_conv(out, p["conv2"]), p["bn2"])
    return F.relu(out + _downsample(x, p, stride))


def _bottleneck_block(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    # torchvision v1.5: the stride sits on the 3x3 conv2
    out = F.relu(_bn(_conv(x, p["conv1"]), p["bn1"]))
    out = F.relu(_bn(_conv(out, p["conv2"], stride), p["bn2"]))
    out = _bn(_conv(out, p["conv3"]), p["bn3"])
    return F.relu(out + _downsample(x, p, stride))


def tv_resnet_features(params: dict, images: torch.Tensor, cfg: TVResNetConfig) -> torch.Tensor:
    """torchvision ResNet through global average pooling (the reference's
    ``EvalModel``, the classifier ``fc`` dropped). (B, H, W, 3) ->
    (B, 512 x expansion), in the dtype of the weights."""
    x = images.permute(0, 3, 1, 2).to(params["conv1"].dtype)
    x = F.relu(_bn(_conv(x, params["conv1"], stride=2), params["bn1"]))
    x = F.max_pool2d(x, 3, stride=2, padding=1)  # padded by -inf, as reduce_window's init
    block = _bottleneck_block if cfg.bottleneck else _basic_block
    for stage_idx, stage in enumerate(params["stages"]):
        for block_idx, p in enumerate(stage):
            x = block(x, p, 2 if (stage_idx > 0 and block_idx == 0) else 1)
    return _mean(x, (2, 3))


def init_tv_resnet_params(gen: torch.Generator, cfg: TVResNetConfig, dtype=torch.float32,
                          device="cuda") -> dict:
    """A random tree with torchvision's shapes (offline use), He-normal
    kernels and BatchNorm at identity, drawn on the host from ``gen`` (not
    the JAX package's draws, see ``init_std_vit_params``), on ``device``
    in ``dtype``, kernels channels_last."""
    device = resolve_device(device)
    expansion = 4 if cfg.bottleneck else 1

    def conv(kh, kw, cin, cout):
        return torch.randn((cout, cin, kh, kw), generator=gen) * (kh * kw * cin) ** -0.5

    def bn(c):
        return {"scale": torch.ones(c), "bias": torch.zeros(c), "mean": torch.zeros(c),
                "var": torch.ones(c)}

    params = {"conv1": conv(7, 7, 3, cfg.width), "bn1": bn(cfg.width), "stages": []}
    c_in = cfg.width
    for stage_idx, n in enumerate(cfg.layers):
        planes = cfg.width * (2 ** stage_idx)
        c_out = planes * expansion
        stage = []
        for block_idx in range(n):
            if cfg.bottleneck:
                p = {"conv1": conv(1, 1, c_in, planes), "bn1": bn(planes),
                     "conv2": conv(3, 3, planes, planes), "bn2": bn(planes),
                     "conv3": conv(1, 1, planes, c_out), "bn3": bn(c_out)}
            else:
                p = {"conv1": conv(3, 3, c_in, planes), "bn1": bn(planes),
                     "conv2": conv(3, 3, planes, planes), "bn2": bn(planes)}
            if block_idx == 0 and (stage_idx > 0 or c_in != c_out):
                p["downsample"] = {"conv": conv(1, 1, c_in, c_out), "bn": bn(c_out)}
            stage.append(p)
            c_in = c_out
        params["stages"].append(stage)
    return conv_layout(tree_map(lambda t: t.to(device=device, dtype=dtype), params))
