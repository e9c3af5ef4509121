"""The port stands alone: no module of mvlpt_torch, not chip_smoke.py, and
not the entry module of the tensor-parallel tests' spawned ranks imports
JAX, the JAX package, or a package the GPU host lacks (regex, yaml,
optax); entry points refuse to run without CUDA unless asked for the
CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "mvlpt_tpu", "regex", "yaml", "optax", "flax")
SOURCES = sorted((ROOT / "mvlpt_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_port_tp_child.py"]


def _imported(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    bad = {m for m in _imported(path) if m.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_every_module_loads_no_forbidden_package():
    code = (
        "import importlib, pkgutil, sys, mvlpt_torch\n"
        "for m in pkgutil.walk_packages(mvlpt_torch.__path__, 'mvlpt_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from tests import torch_port_tp_child\n"
        # The entry functions of the spawned ranks (chip_smoke's train[tp2]
        # and the CPU tests') are module-level, so a spawned child imports
        # only their modules.
        "assert callable(chip_smoke._tp_rank) and callable(torch_port_tp_child.run)\n"
        "assert 'mvlpt_torch.parallel.mesh' in sys.modules\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('mvlpt_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_or_cpu(no_cuda):
    from mvlpt_torch.core.clip import CLIPConfig, init_clip_params
    from mvlpt_torch.flagship import flagship
    from mvlpt_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = CLIPConfig(embed_dim=8, image_resolution=16, vision_layers=1, vision_width=16,
                     vision_patch_size=8, transformer_width=16, transformer_heads=2,
                     transformer_layers=1, vocab_size=32)
    assert init_clip_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")["text"]["token_embedding"].shape == (32, 16)


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    from mvlpt_torch.ops import _build

    if shutil.which("nvcc") or os.path.isfile("/usr/local/cuda/bin/nvcc"):
        monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
            RuntimeError("nvcc not found")))
    monkeypatch.setenv("MVLPT_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_kernels()


_PTXAS_ENTRY = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{name}' for 'sm_90a'\n"
                "    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
                "ptxas info    : Used {regs} registers, used 1 barriers\n")


def _ptxas_log(*entries) -> str:
    return "".join(_PTXAS_ENTRY.format(name=n, spill=s, regs=r) for n, s, r in entries)


def test_kernel_build_keeps_each_log_beside_its_library(tmp_path, monkeypatch):
    """A cached library comes back with its build's ptxas log, so the spill
    check reads every source however warm the build directory is; a
    library whose log is missing is built again."""
    from mvlpt_torch.ops import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n"
                    "print('ptxas info    : Used 7 registers,', sys.argv[-1].rsplit('/', 1)[-1])\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("MVLPT_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    first = _build.build_kernels()
    assert first["built"] == sorted(_build.SOURCES)
    for name in _build.SOURCES:
        assert first["ptxas"][name].strip() == f"ptxas info    : Used 7 registers, {name}.cu"

    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        AssertionError("a cached library was rebuilt")))
    assert _build.build_kernels() == dict(first, built=[])

    _build._log_path("attend_bwd").unlink()
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    again = _build.build_kernels()
    assert again["built"] == ["attend_bwd"] and again["ptxas"] == first["ptxas"]


_WG = "wgmma_gemm_kernelILi{}ELi{}EEEv14CUtensorMap_stS0_iiiN5mvlpt7EpiArgsE"
_MLP_CLEAN = [(_WG.format(4, 256), 0, 168), (_WG.format(3, 128), 0, 168),
              ("gemm_kernelIfLb0ELi4EEEvPKT_S3_iiiNS_7EpiArgsE", 0, 80)]


@pytest.mark.parametrize("fwd, bwd, mlp, error", [
    ([("attend_fwd_tcILi26EEEv", 0, 230), ("attend_fwd_kernelEPKf", 0, 32)],
     [("attend_bwd_dq_tcILi26EEEv", 0, 127), ("attend_bwd_dkv_tcILi26EEEv", 0, 168)],
     _MLP_CLEAN, None),
    ([("attend_fwd_tcILi26EEEv", 0, 230)],
     [("attend_bwd_dq_tcILi26EEEv", 40, 255)], _MLP_CLEAN, "spill"),
    ([("attend_fwd_kernelEPKf", 0, 32)],
     [("attend_bwd_dq_tcILi26EEEv", 0, 127)], _MLP_CLEAN, "no tensor-core kernel in attend_fwd"),
    ([("attend_fwd_tcILi26EEEv", 0, 230)], [("attend_bwd_dq_tcILi26EEEv", 0, 127)],
     [(_WG.format(4, 256), 24, 168), (_WG.format(3, 128), 0, 168)], "spill"),
    ([("attend_fwd_tcILi26EEEv", 0, 230)], [("attend_bwd_dq_tcILi26EEEv", 0, 127)],
     _MLP_CLEAN[2:], "no tensor-core kernel in mlp_fwd"),
    ([("attend_fwd_tcILi26EEEv", 0, 230)], [("attend_bwd_dq_tcILi26EEEv", 0, 127)],
     [(_WG.format(4, 256), 0, 128)], "below 168 registers"),
], ids=["clean", "spill", "no-tc-kernel", "wgmma-spill", "no-wgmma-kernel", "wgmma-short"])
def test_chip_smoke_spill_check_reads_each_attention_kernel(fwd, bwd, mlp, error, capsys):
    """The spill check reads the tensor-core kernels of each source: the
    standalone attention's and mlp_fwd's wgmma GEMM, which must also hold
    the registers setmaxnreg's split needs."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    logs = {"attend_fwd": _ptxas_log(*fwd), "attend_bwd": _ptxas_log(*bwd),
            "mlp_fwd": _ptxas_log(*mlp)}
    if error is None:
        chip_smoke.check_tc_spills(logs)
        out = capsys.readouterr().out
        assert "attend_fwd_tc<NT=26>: 230 registers, 0 bytes of spills" in out
        assert "wgmma_gemm_kernel<EPI=4,BN=256>: 168 registers, 0 bytes of spills" in out
        assert "gemm_kernelIf" not in out
    else:
        with pytest.raises(AssertionError, match=error):
            chip_smoke.check_tc_spills(logs)


def test_chip_smoke_fails_a_row_past_its_bound():
    """Rows hold to TOL x max|ref| (fp32 1e-4, bf16 5e-3): one bf16 ulp in
    [4, 8) at max|ref| 5.46875 (0.03125 > 0.02734) fails the run."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.TOL == {"float32": 1e-4, "bfloat16": 5e-3}
    row = dict(name="attn_fwd", mode="no-residual", tower="image_eval", dtype="bfloat16",
               max_abs_err=0.02734, tol=5e-3 * 5.46875, ok=True)
    assert chip_smoke._fail_on_disagreement([row]) == [row]
    with pytest.raises(AssertionError, match="0.03125 > 0.02734375"):
        chip_smoke._fail_on_disagreement([dict(row, max_abs_err=0.03125, ok=False)])


def test_every_header_keys_every_library(tmp_path, monkeypatch):
    """A library's digest covers its source and every header under csrc/,
    a header added later included: a change to any header rebuilds every
    library, so none is left stale."""
    from mvlpt_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    headers = sorted(p.name for p in csrc.glob("*.cuh"))
    assert {"common.cuh", "mma.cuh", "wgmma.cuh"} <= set(headers)
    base = {name: _build._digest(name) for name in _build.SOURCES}
    for header in headers + ["later.cuh"]:
        path = csrc / header
        old = path.read_bytes() if path.exists() else None
        path.write_bytes((old or b"") + b"// edited\n")
        after = {name: _build._digest(name) for name in _build.SOURCES}
        assert all(after[n] != base[n] for n in _build.SOURCES), header
        if old is None:
            path.unlink()
        else:
            path.write_bytes(old)
    assert {name: _build._digest(name) for name in _build.SOURCES} == base


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (ROOT, alone):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                             text=True, timeout=120, env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
