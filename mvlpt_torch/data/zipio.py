"""Zip-backed image references: ``/path/to/train.zip@member/img.jpg``.

The counterpart of ``mvlpt_tpu/data/zipio.py``.

The ELEVATER hub (``vision_datasets``) ships task images inside split
zips and its index files reference members as ``train.zip@1.jpg``
(feature.py:555-567 consumes them through the hub library). Rather than
forcing users to extract terabytes, the input pipeline reads members
straight out of the archive: zip stores JPEG/PNG uncompressed or
deflated, and per-thread handles keep decode workers contention-free
(ZipFile.read on a shared handle serializes on a lock).
"""

from __future__ import annotations

import io
import threading
import zipfile

from PIL import Image

SEP = "@"

_local = threading.local()


def is_zip_path(path: str) -> bool:
    return SEP in path and ".zip" in path.split(SEP, 1)[0].lower()


def split_zip_path(path: str) -> tuple[str, str]:
    archive, member = path.split(SEP, 1)
    return archive, member


def _handle(archive: str) -> zipfile.ZipFile:
    cache = getattr(_local, "zips", None)
    if cache is None:
        cache = _local.zips = {}
    zf = cache.get(archive)
    if zf is None:
        zf = cache[archive] = zipfile.ZipFile(archive)
    return zf


def read_bytes(path: str) -> bytes:
    """Raw file bytes from a plain path or a ``zip@member`` reference."""
    if not is_zip_path(path):
        with open(path, "rb") as f:
            return f.read()
    archive, member = split_zip_path(path)
    return _handle(archive).read(member)


def open_image(path: str) -> Image.Image:
    """Open a plain file path or a ``zip@member`` reference."""
    if is_zip_path(path):
        img = Image.open(io.BytesIO(read_bytes(path)))
        img.load()
        return img
    img = Image.open(path)
    img.load()
    return img
