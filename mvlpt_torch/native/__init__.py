"""ctypes binding and on-demand build of the native host cores.

The counterpart of ``mvlpt_tpu/native/__init__.py``. ``imagepipe.cpp``
holds JPEG/PNG entropy decode and Pillow-exact convolution resampling;
``bpetok.cpp`` the CLIP BPE's word split and merges for cleaned ASCII
text. Both are byte copies of the JAX package's sources (a test holds
them equal). Each is compiled once with ``g++ -O3 -fPIC -shared
-std=c++17`` on first use, into a library named by a digest of its
source and its build command, under ``$MVLPT_TORCH_BUILD_DIR`` or
``build/mvlpt_torch_native`` beside the package (git ignores
``build/``); the build writes a temporary file and renames it, so
concurrent builders race safely. Nothing is built at import.

ctypes releases the GIL during each call, so the threaded DataLoader
(``data/loader.py``) decodes across cores. The fast path covers
baseline and progressive JPEG (grey, YCbCr, RGB) and non-interlaced
8-bit grey/RGB PNG; everything else probes as unsupported and the
callers fall back to PIL for that image, so every output is the PIL
backend's bit for bit.

The image core links the host's libjpeg and libpng. ``toolchain()``
says what the build used: the compiler, the route (the system's headers
and ``-ljpeg -lpng``, or, where the system has no headers, those under
``native/include`` against the shared objects found by full path) and
the libraries the built core resolves.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "imagepipe.cpp"
_BPE_SRC = _HERE / "bpetok.cpp"
_CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

OK = 0
UNSUPPORTED = 1
CORRUPT = 2
BADARGS = 3

FILTER_IDS = {"bilinear": 0, "bicubic": 1, "lanczos": 2}

_lib = None
_lib_error: str | None = None
_built: dict[str, dict] = {}  # stem -> what toolchain() reports of its build


class NativeUnavailable(RuntimeError):
    """The native core could not be built or loaded on this host."""


def build_dir() -> Path:
    env = os.environ.get("MVLPT_TORCH_BUILD_DIR")
    return Path(env) if env else _HERE.parent.parent / "build" / "mvlpt_torch_native"


def _image_routes() -> list[tuple[str, list[str]]]:
    """(route, extra g++ arguments) to try in turn for the image core:
    the system's headers and libraries, then the headers kept under
    ``native/include`` against the shared objects by full path."""
    routes = [("system", ["-ljpeg", "-lpng"])]
    include = _HERE / "include"
    if include.is_dir():
        libs = [_find_shared(stem) for stem in ("libjpeg", "libpng16")]
        if all(libs):
            routes.append(("vendored headers", ["-I", str(include), *libs,
                                                *(f"-Wl,-rpath,{Path(p).parent}" for p in libs)]))
    return routes


def _find_shared(stem: str) -> str | None:
    """The full path of a shared object ``stem.so*``: the system's (from
    ``ldconfig -p``), else the one Pillow ships."""
    try:
        out = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    for line in out.splitlines():
        name, _, path = line.strip().partition(" => ")
        if name.startswith(f"{stem}.so") and "x86-64" in name and os.path.isfile(path):
            return path
    try:
        import PIL
    except ImportError:
        return None
    bundled = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    found = sorted(bundled.glob(f"{stem}-*.so*")) if bundled.is_dir() else []
    return str(found[0]) if found else None


def _build(src_path: Path = _SRC, stem: str = "imagepipe",
           routes: list[tuple[str, list[str]]] | None = None) -> Path:
    """The library of ``src_path``, compiled unless a library of the same
    source and command is in the build directory. Tries each route in
    turn; raises NativeUnavailable with every compiler's stderr when none
    builds."""
    if routes is None:
        routes = _image_routes() if stem == "imagepipe" else [("system", [])]
    src = src_path.read_bytes()
    out_dir = build_dir()
    errors = []
    for route, extra in routes:
        tag = hashlib.sha256(src + " ".join((*_CXX_FLAGS, *extra)).encode()).hexdigest()[:16]
        out = out_dir / f"lib{stem}-{tag}.so"
        if not out.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            with tempfile.NamedTemporaryFile(suffix=".so", dir=out_dir, delete=False) as tmp:
                tmp_path = Path(tmp.name)
            cmd = ["g++", *_CXX_FLAGS, str(src_path), "-o", str(tmp_path), *extra]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
            except (OSError, subprocess.TimeoutExpired) as e:
                tmp_path.unlink(missing_ok=True)
                errors.append(f"[{route}] g++ invocation failed: {e}")
                continue
            if proc.returncode != 0:
                tmp_path.unlink(missing_ok=True)
                errors.append(f"[{route}] {' '.join(cmd)}\n{proc.stderr[-2000:]}")
                continue
            os.replace(tmp_path, out)  # atomic: concurrent builders race safely
        _built[stem] = {"route": route, "library": str(out), "command_extra": extra}
        return out
    raise NativeUnavailable(f"native {stem} build failed:\n" + "\n".join(errors))


def _bind(lib):
    """Declare the image core's C functions on ``lib`` and check its ABI."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.mvlpt_probe.argtypes = [u8p, ctypes.c_int64, i32p, i32p, i32p]
    lib.mvlpt_probe.restype = ctypes.c_int
    lib.mvlpt_decode.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int32, ctypes.c_int32]
    lib.mvlpt_decode.restype = ctypes.c_int
    lib.mvlpt_resample.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p,
    ]
    lib.mvlpt_resample.restype = ctypes.c_int
    lib.mvlpt_jpeg_scaled_dims.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32, i32p, i32p]
    lib.mvlpt_jpeg_scaled_dims.restype = ctypes.c_int
    lib.mvlpt_decode_jpeg_scaled.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int32, u8p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.mvlpt_decode_jpeg_scaled.restype = ctypes.c_int
    lib.mvlpt_abi_version.argtypes = []
    lib.mvlpt_abi_version.restype = ctypes.c_int
    if lib.mvlpt_abi_version() != 1:
        raise NativeUnavailable("ABI version mismatch")
    return lib


def _load():
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        raise NativeUnavailable(_lib_error)
    try:
        lib = _bind(ctypes.CDLL(str(_build())))
    except NativeUnavailable as e:
        _lib_error = str(e)
        raise
    except OSError as e:
        _lib_error = f"loading native imagepipe failed: {e}"
        raise NativeUnavailable(_lib_error) from e
    _lib = lib
    return lib


def available() -> bool:
    """True when the native image core builds and loads on this host."""
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def error() -> str | None:
    """Why the image core is unavailable (the compiler's stderr), or None."""
    return None if available() else _lib_error


def toolchain() -> dict:
    """What built the image core: the g++ version line, the route, the
    library and the libjpeg and libpng it resolves (from ``ldd``). Builds
    the core first; raises NativeUnavailable when it cannot."""
    _load()
    info = dict(_built["imagepipe"])
    try:
        info["compiler"] = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                                          timeout=30).stdout.splitlines()[0]
        ldd = subprocess.run(["ldd", info["library"]], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired, IndexError) as e:
        info["compiler"], ldd = f"unknown ({e})", ""
    info["linked"] = [line.strip() for line in ldd.splitlines()
                      if "libjpeg" in line or "libpng" in line]
    return info


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _buf_ptr(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))


def probe(data: bytes) -> tuple[int, int] | None:
    """(width, height) when the fast path decodes ``data`` bit for bit
    as PIL does; None when the caller should fall back to PIL."""
    lib = _load()
    w, h, fmt = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.mvlpt_probe(_buf_ptr(data), len(data), ctypes.byref(w), ctypes.byref(h),
                         ctypes.byref(fmt))
    if rc != OK or w.value <= 0 or h.value <= 0:
        return None
    # PIL's decompression-bomb guard: oversize headers take the PIL path,
    # which warns or raises exactly as the python backend does
    from PIL import Image

    max_pixels = Image.MAX_IMAGE_PIXELS
    if max_pixels is not None and w.value * h.value > max_pixels:
        return None
    return w.value, h.value


def decode(data: bytes, w: int, h: int) -> np.ndarray | None:
    """Decode to an (h, w, 3) uint8 RGB array; None -> PIL fallback."""
    lib = _load()
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.mvlpt_decode(_buf_ptr(data), len(data), _as_u8p(out), w, h)
    return out if rc == OK else None


def decode_jpeg_scaled(data: bytes, num: int) -> np.ndarray | None:
    """DCT-domain scaled JPEG decode at scale num/8 (num in 1..8), the
    path behind DATALOADER.NATIVE_FAST_JPEG: about (num/8)^2 the IDCT
    work of a full decode. Its pixels are libjpeg's scaled IDCT, not a
    full decode resampled, so it is not bit-identical to the PIL backend
    (the JAX package measured a pixel MAE about 1/255 on photo-like
    JPEGs). The augmentation draws are unchanged: crops are drawn in the
    original pixel coordinates. Returns the (h', w', 3) uint8 array or
    None (the caller falls back to the exact path)."""
    lib = _load()
    w, h = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.mvlpt_jpeg_scaled_dims(_buf_ptr(data), len(data), num, ctypes.byref(w),
                                    ctypes.byref(h))
    if rc != OK or w.value <= 0 or h.value <= 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.mvlpt_decode_jpeg_scaled(_buf_ptr(data), len(data), num, _as_u8p(out), w.value,
                                      h.value)
    return out if rc == OK else None


def resample(arr: np.ndarray, box: tuple[float, float, float, float],
             out_w: int, out_h: int, interpolation: str) -> np.ndarray:
    """Pillow-exact ``img.resize((out_w, out_h), filter, box=box)`` on an
    (h, w, 3) uint8 array."""
    lib = _load()
    filter_id = FILTER_IDS[interpolation]
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (h, w, 3) uint8, got {arr.shape} {arr.dtype}")
    arr = np.ascontiguousarray(arr)
    in_h, in_w = arr.shape[:2]
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.mvlpt_resample(_as_u8p(arr), in_w, in_h, float(box[0]), float(box[1]),
                            float(box[2]), float(box[3]), out_w, out_h, filter_id,
                            _as_u8p(out))
    if rc != OK:
        raise ValueError(f"mvlpt_resample failed (rc={rc}) for box={box} "
                         f"out=({out_w}, {out_h})")
    return out


class NativeBpe:
    """The C BPE core (bpetok.cpp): word split and greedy merges for
    cleaned lowercase ASCII text, ids bit-identical to the Python
    encoder's. ``encode`` returns None when the input needs the Python
    path."""

    def __init__(self, merges_text: bytes):
        lib = self._lib = ctypes.CDLL(str(_build(_BPE_SRC, "bpetok")))
        lib.mvlpt_bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.mvlpt_bpe_create.restype = ctypes.c_void_p
        lib.mvlpt_bpe_destroy.argtypes = [ctypes.c_void_p]
        lib.mvlpt_bpe_destroy.restype = None
        lib.mvlpt_bpe_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.mvlpt_bpe_encode.restype = ctypes.c_int32
        for name in ("mvlpt_bpe_sot", "mvlpt_bpe_eot"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int32
        self._h = lib.mvlpt_bpe_create(merges_text, len(merges_text))
        if not self._h:
            raise NativeUnavailable("BPE vocab parse failed in native core")
        self.sot = lib.mvlpt_bpe_sot(self._h)
        self.eot = lib.mvlpt_bpe_eot(self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mvlpt_bpe_destroy(h)
            self._h = None

    def encode(self, cleaned_ascii: str) -> list[int] | None:
        data = cleaned_ascii.encode("ascii", errors="strict")
        cap = max(64, 4 * len(data) + 8)
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.mvlpt_bpe_encode(self._h, data, len(data), buf, cap)
        if n == -1:  # buffer too small (pathological): one retry
            cap = 16 * max(1, len(data))
            buf = (ctypes.c_int32 * cap)()
            n = self._lib.mvlpt_bpe_encode(self._h, data, len(data), buf, cap)
        if n < 0:
            return None
        return list(buf[:n])
