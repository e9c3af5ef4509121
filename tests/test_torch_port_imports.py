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
