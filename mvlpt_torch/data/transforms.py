"""Host-side image preprocessing (PIL + numpy) and the device-side
normalisation of uint8 batches.

The counterpart of ``mvlpt_tpu/data/transforms.py``, with the same PIL
calls, so the arrays are the JAX package's bit for bit:
  * CLIP eval transform (clip/clip.py:73-80): Resize(shorter side -> n_px,
    bicubic) -> CenterCrop(n_px) -> RGB -> [0,1] -> Normalize(CLIP stats).
  * Dassl train transform for the CoOp universe
    (configs/trainers/MVLPT/vit_b16.yaml:13): RandomResizedCrop
    (scale 0.08-1.0, ratio 3/4-4/3, bicubic) + RandomHorizontalFlip(0.5)
    + Normalize.
  * ELEVATER transform (vision_benchmark/evaluation/feature.py:539-553):
    Resize(size) + CenterCrop when DATASET.CENTER_CROP else a plain
    Resize((H, W)) warp.

Outputs are HWC float32, or HWC uint8 with ``to_uint8``
(TPU.DEVICE_NORMALIZE), which the steps normalise on the device.
DATALOADER.BACKEND "native" swaps in ``data/native_transform.py``'s
subclasses, which run the same geometry on the C++ core.
"""

from __future__ import annotations

import functools
import math
import random

import numpy as np
import torch
from PIL import Image

CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)

_INTERP = {
    "bilinear": Image.BILINEAR,
    "bicubic": Image.BICUBIC,
    "nearest": Image.NEAREST,
}


def _to_array(img: Image.Image, mean, std, to_uint8: bool = False) -> np.ndarray:
    if to_uint8:
        # TPU.DEVICE_NORMALIZE: raw uint8 post-geometry pixels; the steps
        # fold (x/255 - mean)/std into the frozen patch-embed product
        # (core/vit.py:embed_image).
        return np.asarray(img.convert("RGB"), dtype=np.uint8)
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return arr


@functools.lru_cache(maxsize=32)
def device_constant(values: tuple, device: torch.device, scale: float = 1.0) -> torch.Tensor:
    """``scale * values`` as an fp32 tensor on ``device``, made once for
    each argument tuple and shared by every caller (read it, never write
    it): a tensor made from Python floats on the card is a pageable
    host-to-device copy, which synchronises the stream."""
    return torch.tensor(values, dtype=torch.float32).to(device) * scale


def device_normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    """CLIP normalisation of a raw uint8 batch on its device,
    ``(x - 255 mean) / (255 std)`` in fp32; float batches pass through
    untouched."""
    if images.dtype != torch.uint8:
        return images
    m = device_constant(tuple(map(float, mean)), images.device, 255.0)
    s = device_constant(tuple(map(float, std)), images.device, 255.0)
    return (images.float() - m) / s


def resized_shorter_dims(w: int, h: int, size: int) -> tuple[int, int]:
    """Output dims of resize_shorter (Python round(), banker's rounding,
    as in the JAX package)."""
    if (w <= h and w == size) or (h <= w and h == size):
        return w, h
    if w < h:
        return size, max(1, int(round(size * h / w)))
    return max(1, int(round(size * w / h))), size


def resize_shorter(img: Image.Image, size: int, interpolation="bicubic") -> Image.Image:
    w, h = img.size
    new_w, new_h = resized_shorter_dims(w, h, size)
    if (new_w, new_h) == (w, h):
        return img
    return img.resize((new_w, new_h), _INTERP[interpolation])


def center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    if w < size or h < size:  # pad like torchvision center_crop
        canvas = Image.new("RGB", (max(w, size), max(h, size)))
        canvas.paste(img, ((canvas.width - w) // 2, (canvas.height - h) // 2))
        img, (w, h) = canvas, canvas.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


class EvalTransform:
    """CLIP eval preprocessing (clip/clip.py:73-80)."""

    def __init__(self, size=224, interpolation="bicubic", mean=CLIP_PIXEL_MEAN,
                 std=CLIP_PIXEL_STD, center_crop_mode=True, to_uint8=False):
        self.size = size if isinstance(size, int) else size[0]
        # accept int | tuple | list (yacs INPUT.SIZE parses as a list)
        self.full_size = (size, size) if isinstance(size, int) else tuple(size)
        self.interpolation = interpolation
        self.mean, self.std = mean, std
        self.center_crop_mode = center_crop_mode
        self.to_uint8 = to_uint8

    def __call__(self, img: Image.Image) -> np.ndarray:
        if self.center_crop_mode:
            img = resize_shorter(img, self.size, self.interpolation)
            img = center_crop(img, self.size)
        else:
            # ELEVATER default: warp to (H, W) (feature.py:548-553);
            # PIL.resize takes (width, height)
            h, w = self.full_size
            img = img.resize((w, h), _INTERP[self.interpolation])
        return _to_array(img, self.mean, self.std, self.to_uint8)


class TrainTransform:
    """Dassl-style train preprocessing: random_resized_crop + random_flip
    + normalize. Each call draws from the provided python Random."""

    def __init__(self, size=224, interpolation="bicubic", mean=CLIP_PIXEL_MEAN,
                 std=CLIP_PIXEL_STD, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 rng: random.Random | None = None, to_uint8=False):
        self.size = size if isinstance(size, int) else size[0]
        self.interpolation = interpolation
        self.mean, self.std = mean, std
        self.scale, self.ratio = scale, ratio
        self.rng = rng or random.Random()
        self.to_uint8 = to_uint8

    def _sample_crop(self, w: int, h: int, rng: random.Random):
        area = w * h
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target = area * rng.uniform(*self.scale)
            ar = math.exp(rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target * ar)))
            ch = int(round(math.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                x = rng.randint(0, w - cw)
                y = rng.randint(0, h - ch)
                return x, y, cw, ch
        # fallback: center crop at clamped aspect (torchvision semantics)
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            ch, cw = h, int(round(h * self.ratio[1]))
        else:
            cw, ch = w, h
        return (w - cw) // 2, (h - ch) // 2, cw, ch

    def __call__(self, img: Image.Image, rng: random.Random | None = None) -> np.ndarray:
        """``rng`` (when given) makes the draw deterministic per call: the
        DataLoader passes a per-(seed, epoch, index) Random so
        augmentation is reproducible and thread-safe."""
        r = rng if rng is not None else self.rng
        img = img.convert("RGB")
        x, y, cw, ch = self._sample_crop(*img.size, r)
        img = img.resize((self.size, self.size), _INTERP[self.interpolation],
                         box=(x, y, x + cw, y + ch))
        if r.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return _to_array(img, self.mean, self.std, self.to_uint8)


def _transform_classes(cfg):
    """(train_cls, eval_cls) for the configured DATALOADER.BACKEND.
    "native" selects the C++ decode and resample core (bit-identical
    outputs; data/native_transform.py) and raises when it cannot build."""
    backend = cfg.DATALOADER.BACKEND
    if backend not in ("python", "native"):
        raise NotImplementedError(
            f"DATALOADER.BACKEND {backend!r}: only 'python' and 'native' (ROADMAP.md Queue 1: "
            "data/tfdata.py is not ported)")
    if backend == "python":
        return TrainTransform, EvalTransform
    from mvlpt_torch import native
    from mvlpt_torch.data import native_transform as NT

    if not native.available():
        raise RuntimeError(
            "DATALOADER.BACKEND 'native' requested but the C++ imagepipe could not be "
            "built or loaded on this host (needs g++, libjpeg, libpng). Use BACKEND "
            f"'python' or fix the toolchain.\n{native.error()}")
    return NT.NativeTrainTransform, NT.NativeEvalTransform


def build_transform(cfg, is_train: bool):
    """Transform factory from an INPUT config subtree (Dassl
    build_transform, the reference's mvlpt.py:650-658), on the "python"
    or the "native" DATALOADER.BACKEND ("tf" raises)."""
    size = tuple(cfg.INPUT.SIZE) if not isinstance(cfg.INPUT.SIZE, int) else (
        cfg.INPUT.SIZE, cfg.INPUT.SIZE)
    train_cls, eval_cls = _transform_classes(cfg)
    kw = dict(interpolation=cfg.INPUT.INTERPOLATION, mean=tuple(cfg.INPUT.PIXEL_MEAN),
              std=tuple(cfg.INPUT.PIXEL_STD), to_uint8=bool(cfg.TPU.DEVICE_NORMALIZE))
    if cfg.DATALOADER.BACKEND == "native":
        kw["fast_jpeg"] = bool(cfg.DATALOADER.NATIVE_FAST_JPEG)
    if is_train and not cfg.INPUT.NO_TRANSFORM and (
            "random_resized_crop" in cfg.INPUT.TRANSFORMS):
        return train_cls(size=size[0], scale=tuple(cfg.INPUT.RRCROP_SCALE), **kw)
    return eval_cls(size=size[0], **kw)
