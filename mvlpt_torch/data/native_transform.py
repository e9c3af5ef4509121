"""Transforms backed by the native C++ image core (DATALOADER.BACKEND
"native").

The counterpart of ``mvlpt_tpu/data/native_transform.py``. Drop-in
replacements for the PIL transforms in data/transforms.py: same
geometry, same RNG draw order, bit-identical pixels (the native core
reimplements Pillow's convolution resampling exactly; see
native/imagepipe.cpp). The DataLoader hands these raw encoded bytes
(``wants_bytes``) instead of a decoded PIL image, so the whole decode ->
resample pipeline runs in C with the GIL released, across the loader's
worker threads (the reference's torch DataLoader workers: Dassl
DatasetWrapper at mvlpt.py:661-720, seeded workers at feature.py:74-96).

Anything outside the native fast path (palette/alpha PNG, CMYK JPEG,
other containers, "nearest" interpolation) transparently falls back to
the PIL implementation per image, preserving the same output for every
input the PIL backend accepts.
"""

from __future__ import annotations

import io
import random

import numpy as np
from PIL import Image

from mvlpt_torch import native
from mvlpt_torch.data.transforms import (
    _INTERP,
    _to_array,
    EvalTransform,
    TrainTransform,
    resized_shorter_dims,
)


def _finalize(arr: np.ndarray, mean, std, to_uint8: bool) -> np.ndarray:
    """Numpy mirror of transforms._to_array on an already-RGB uint8 array
    (same op order -> bit-identical floats)."""
    if to_uint8:
        # copy: crop/flip views would otherwise pin the full decoded
        # buffer until the whole batch is stacked
        return np.ascontiguousarray(arr)
    a = np.asarray(arr, dtype=np.float32) / 255.0
    return (a - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _scale_num(need_w: float, need_h: float, out_w: int, out_h: int) -> int:
    """Smallest libjpeg scale numerator (of 8) that keeps the decoded
    region at least as large as the output — so the follow-up resample
    only ever downscales and the DCT shortcut costs no sharpness."""
    import math

    if need_w <= 0 or need_h <= 0:
        return 8
    num = max(math.ceil(8 * out_w / need_w), math.ceil(8 * out_h / need_h))
    num = min(8, max(1, num))
    # libjpeg-turbo only has SIMD IDCT at 1/8, 1/4, 1/2 and full scale;
    # intermediate M/8 scales hit slow scalar paths and lose to a full
    # decode, so round up to the next power of two
    for simd in (1, 2, 4):
        if num <= simd:
            return simd
    return 8


def _decode_maybe_scaled(data: bytes, w: int, h: int, num: int):
    """(array, scale) — DCT-scaled decode when num < 8, else exact."""
    if num < 8:
        arr = native.decode_jpeg_scaled(data, num)
        if arr is not None:
            return arr, num / 8.0
    return native.decode(data, w, h), 1.0


class NativeEvalTransform(EvalTransform):
    """CLIP/ELEVATER eval preprocessing on the native core.

    ``fast_jpeg`` (DATALOADER.NATIVE_FAST_JPEG) decodes JPEGs at the
    smallest M/8 DCT scale that still covers the output — a large decode
    speedup for big photos, at the cost of bit-parity with the PIL
    backend."""

    wants_bytes = True

    def __init__(self, *a, fast_jpeg: bool = False, **kw):
        super().__init__(*a, **kw)
        self.fast_jpeg = fast_jpeg

    def _pil(self, data) -> np.ndarray:
        if isinstance(data, (bytes, bytearray)):
            data = Image.open(io.BytesIO(bytes(data)))
        return EvalTransform.__call__(self, data)

    def __call__(self, data) -> np.ndarray:
        if (not isinstance(data, (bytes, bytearray))
                or self.interpolation not in native.FILTER_IDS
                or not native.available()):
            return self._pil(data)
        data = bytes(data)
        probe = native.probe(data)
        if probe is None:
            return self._pil(data)
        w, h = probe
        if self.center_crop_mode:
            target_w = target_h = self.size
        else:
            target_h, target_w = self.full_size
        num = _scale_num(w, h, target_w, target_h) if self.fast_jpeg else 8
        arr, _ = _decode_maybe_scaled(data, w, h, num)
        if arr is None:
            return self._pil(data)
        w, h = arr.shape[1], arr.shape[0]  # scaled dims when num < 8
        if self.center_crop_mode:
            size = self.size
            new_w, new_h = resized_shorter_dims(w, h, size)
            if (new_w, new_h) != (w, h):
                arr = native.resample(arr, (0, 0, w, h), new_w, new_h,
                                      self.interpolation)
            # center crop; resize_shorter guarantees both dims >= size
            left = int(round((new_w - size) / 2.0))
            top = int(round((new_h - size) / 2.0))
            arr = arr[top:top + size, left:left + size]
        else:
            out_h, out_w = self.full_size
            if (out_w, out_h) != (w, h):
                arr = native.resample(arr, (0, 0, w, h), out_w, out_h,
                                      self.interpolation)
        return _finalize(arr, self.mean, self.std, self.to_uint8)


class NativeTrainTransform(TrainTransform):
    """Dassl-style RRC + flip on the native core. Parameter draws happen
    in Python with the same per-(seed, epoch, index) Random and the same
    draw order as the PIL path, so augmentation streams are identical —
    including under ``fast_jpeg`` (crops are sampled in original pixel
    coordinates; only the decode resolution changes)."""

    wants_bytes = True

    def __init__(self, *a, fast_jpeg: bool = False, **kw):
        super().__init__(*a, **kw)
        self.fast_jpeg = fast_jpeg

    def __call__(self, data, rng: random.Random | None = None) -> np.ndarray:
        r = rng if rng is not None else self.rng
        if not isinstance(data, (bytes, bytearray)):
            return TrainTransform.__call__(self, data, rng=r)
        data = bytes(data)
        if (self.interpolation not in native.FILTER_IDS
                or not native.available()):
            return TrainTransform.__call__(
                self, Image.open(io.BytesIO(data)), rng=r)
        probe = native.probe(data)
        if probe is None:
            return TrainTransform.__call__(
                self, Image.open(io.BytesIO(data)), rng=r)
        w, h = probe
        x, y, cw, ch = self._sample_crop(w, h, r)
        num = _scale_num(cw, ch, self.size, self.size) if self.fast_jpeg \
            else 8
        arr, scale = _decode_maybe_scaled(data, w, h, num)
        if arr is not None and scale != 1.0:
            sh, sw = arr.shape[:2]
            box = (min(x * scale, sw), min(y * scale, sh),
                   min((x + cw) * scale, sw), min((y + ch) * scale, sh))
            arr = native.resample(arr, box, self.size, self.size,
                                  self.interpolation)
            if r.random() < 0.5:
                arr = arr[:, ::-1]
            return _finalize(arr, self.mean, self.std, self.to_uint8)
        if arr is None:
            # crop already drawn from r — replay it on PIL so the flip
            # draw that follows stays aligned with the PIL backend
            img = Image.open(io.BytesIO(data)).convert("RGB")
            img = img.resize((self.size, self.size),
                             _INTERP[self.interpolation],
                             box=(x, y, x + cw, y + ch))
            if r.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            return _to_array(img, self.mean, self.std, self.to_uint8)
        arr = native.resample(arr, (x, y, x + cw, y + ch), self.size,
                              self.size, self.interpolation)
        if r.random() < 0.5:
            arr = arr[:, ::-1]
        return _finalize(arr, self.mean, self.std, self.to_uint8)
