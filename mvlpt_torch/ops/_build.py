"""Build and load the CUDA kernels of ``mvlpt_torch/csrc``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, all sources at once in
parallel, and loaded with ``ctypes``. Libraries are named by a digest of
their sources and flags, so a changed source is rebuilt and an unchanged
one is reused; nvcc's output (ptxas's registers and spills) is kept
beside each library. The build directory is ``$MVLPT_TORCH_BUILD_DIR`` or
``build/mvlpt_torch_kernels`` beside the package (git ignores
``build/``). Nothing is built at import: the first kernel call builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd", "attend_fwd", "attend_bwd", "stamp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The attention entries' core marks (csrc/stamp.cuh's Marks: table, row,
# width, column), before the stream; utils/profiler.py's core_marks_args.
_MARKS = [_P, _P, _I, _I]
# C entry points (see the .cu files): entry name -> (source, C function,
# argument types). The tensor-parallel parts share their source with the
# single-device kernels.
_SIGNATURES = {
    "attn_fwd": ("attn_fwd", "mvlpt_attn_fwd",
                 [_I] + [_P] * 15 + [_I, _I, _I, _I, _F] + _MARKS + [_P]),
    "attn_fwd_part": ("attn_fwd", "mvlpt_attn_fwd_part",
                      [_I] + [_P] * 14 + [_I] * 5 + [_F] + _MARKS + [_P]),
    "attn_bwd": ("attn_bwd", "mvlpt_attn_bwd", [_I] + [_P] * 14 + [_I, _I, _I, _I] + _MARKS + [_P]),
    "attn_bwd_part": ("attn_bwd", "mvlpt_attn_bwd_part",
                      [_I] + [_P] * 9 + [_I] * 5 + _MARKS + [_P]),
    "mlp_fwd": ("mlp_fwd", "mvlpt_mlp_fwd", [_I] + [_P] * 13 + [_I, _I, _I, _F, _P]),
    "mlp_fwd_part": ("mlp_fwd", "mvlpt_mlp_fwd_part", [_I] + [_P] * 12 + [_I] * 3 + [_F, _P]),
    "mlp_bwd": ("mlp_bwd", "mvlpt_mlp_bwd", [_I] + [_P] * 11 + [_I, _I, _I, _P]),
    "mlp_bwd_part": ("mlp_bwd", "mvlpt_mlp_bwd_part", [_I] + [_P] * 6 + [_I] * 3 + [_P]),
    # The backward's K-major wgmma GEMM alone (chip_smoke.py's layout check).
    "gemm_kmajor": ("mlp_bwd", "mvlpt_gemm_kmajor", [_I, _I] + [_P] * 4 + [_I] * 3 + [_P]),
    "attend_fwd": ("attend_fwd", "mvlpt_attend_fwd", [_I] + [_P] * 5 + [_I, _I, _I, _P]),
    "attend_bwd": ("attend_bwd", "mvlpt_attend_bwd", [_I] + [_P] * 11 + [_I, _I, _I, _P]),
    # The spans' device clock (utils/profiler.py); not a kernel of the model.
    "stamp": ("stamp", "mvlpt_stamp", [_P, _P, _I, _I, _P]),
}

# Kernel launches per wrapper (ops/block.py, ops/attention.py): one for
# each call that launches a kernel on the card; CPU calls of the plain
# twins are not counted. The no-residual forwards (the eval kernels
# attn_block_infer / mlp_block_infer of the JAX package) and the
# tensor-parallel parts (attn_block_tp / mlp_block_tp) count apart from
# the single-device training kernels. The last two split the attention
# forwards' launches on the bf16 tensor cores' route by the core they
# take (ops/block.py, RESIDENT_KEYS): the one-pass core over a row held
# whole, or the two-pass core over windows of keys. core_marks counts the
# attention launches (forward or backward) whose launcher stamped its core
# (utils/profiler.py's core marks).
LAUNCHES = {name: 0 for name in ("attn_fwd", "attn_fwd_infer", "attn_bwd", "mlp_fwd",
                                 "mlp_fwd_infer", "mlp_bwd", "attend_fwd", "attend_bwd",
                                 "attn_fwd_tp", "attn_bwd_tp", "mlp_fwd_tp", "mlp_bwd_tp",
                                 "attn_core_resident", "attn_core_windowed", "core_marks")}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("MVLPT_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent.parent / "build" / "mvlpt_torch_kernels"


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_digest(name)}.so"


def _log_path(name: str) -> Path:
    """nvcc's output (ptxas -v) of the library at ``_lib_path(name)``."""
    return _lib_path(name).with_suffix(".log")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _headers() -> list[str]:
    """Every header under csrc/: each keys every library's digest, so no
    header can leave a stale library behind."""
    return sorted(p.name for p in CSRC.glob("*.cuh"))


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [f"{name}.cu"] + _headers():
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    return h.hexdigest()[:16]


def build_kernels() -> dict:
    """Compile every source whose library (or its build log) is missing,
    in parallel. Returns {"built": [names], "ptxas": {name: log}} with the
    log of every source, the cached ones' read back from their build.
    Raises if any compile fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        lib = _lib_path(name)
        if lib.is_file() and _log_path(name).is_file():
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        _log_path(name).write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return dict(built=sorted(procs),
                ptxas={name: _log_path(name).read_text() for name in SOURCES})


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, building on first use."""
    with _lock:
        if name not in _libs:
            if not all(_lib_path(src).is_file() for src in SOURCES):
                build_kernels()
            for src in SOURCES:
                lib = ctypes.CDLL(str(_lib_path(src)))
                lib.mvlpt_error_string.argtypes = [ctypes.c_int]
                lib.mvlpt_error_string.restype = ctypes.c_char_p
                _libs[src] = lib
            for src, fn_name, argtypes in _SIGNATURES.values():
                fn = getattr(_libs[src], fn_name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return _libs[name]


def call(name: str, *args) -> None:
    """Call kernel entry ``name`` and raise on a CUDA error code."""
    src, fn_name, _ = _SIGNATURES[name]
    lib = library(src)
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        msg = lib.mvlpt_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel failed: CUDA error {rc} ({msg})")
