"""The port stands alone: no module of mvlpt_torch, not chip_smoke.py, not
scripts/torch_port_pod_loss_check.py, scripts/torch_port_bf16_drift_train.py
or scripts/torch_port_soak_synthetic.py, and not the entry modules of the
tensor-parallel and mesh tests' spawned ranks imports
JAX, the JAX package, or a package the GPU host lacks (regex, yaml,
optax, scikit-learn, timm, torchvision: the model zoo holds its own
layers); importing them all loads neither transformers nor
matplotlib (imported where they are used); entry points refuse to run
without CUDA unless asked for the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "mvlpt_tpu", "regex", "yaml", "optax", "flax", "sklearn", "timm",
             "torchvision")
# Imported where they are used, never at import: the GPU host lacks
# matplotlib (cli/draw_curves.py draws with it) and the port must not
# need transformers (tokenizer/hf_adapter.py, checkpoint.convert_hf_clip).
LAZY = ("transformers", "matplotlib")
SOURCES = sorted((ROOT / "mvlpt_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_port_tp_child.py",
    ROOT / "tests" / "torch_port_mesh_child.py", ROOT / "scripts" / "torch_port_pod_loss_check.py",
    ROOT / "scripts" / "torch_port_bf16_drift_train.py",
    ROOT / "scripts" / "torch_port_soak_synthetic.py"]


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
        "import chip_smoke, runpy\n"
        # The accuracy scripts, imported as modules (not run).
        "for script in ('torch_port_bf16_drift_train', 'torch_port_soak_synthetic'):\n"
        "    runpy.run_path(f'scripts/{script}.py', run_name=script)\n"
        "from tests import torch_port_mesh_child, torch_port_tp_child\n"
        # The entry functions of the spawned ranks (chip_smoke's train[tp2]
        # and the CPU tests') are module-level, so a spawned child imports
        # only their modules.
        "assert callable(chip_smoke._tp_rank) and callable(torch_port_tp_child.run)\n"
        "assert callable(chip_smoke._mesh_cli_rank) and callable(torch_port_mesh_child.cli)\n"
        "assert 'mvlpt_torch.parallel.mesh' in sys.modules\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        f"lazy = sorted(m for m in sys.modules if m.split('.')[0] in {LAZY!r})\n"
        "assert not lazy, lazy\n"
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
    from mvlpt_torch.cli.train import build_parser, main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(build_parser().parse_args(["--trainer", "MVLPT"]))
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = CLIPConfig(embed_dim=8, image_resolution=16, vision_layers=1, vision_width=16,
                     vision_patch_size=8, transformer_width=16, transformer_heads=2,
                     transformer_layers=1, vocab_size=32)
    assert init_clip_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")["text"]["token_embedding"].shape == (32, 16)


def test_elevater_and_zeroshot_runs_need_cuda_or_cpu(no_cuda, tmp_path):
    """The ELEVATER trainer (with remat) and the zero-shot trainers raise
    without a card, from the CLI and from their constructors, before they
    read any data: none runs on the CPU unless asked."""
    from mvlpt_torch.cli.train import build_parser, main
    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.models.zsclip import ZeroshotCLIP, ZeroshotCLIP2
    from mvlpt_torch.train.trainer import MVLPT

    for argv in (["--trainer", "ZeroshotCLIP", "--dataset", "cifar-10", "--eval-only",
                  "--no-train"],
                 ["--trainer", "MVLPT", "--multi-task", "--dataset", "cifar-10,mnist",
                  "--act-ckpt", "4"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(build_parser().parse_args(["--root", str(tmp_path), "--output-dir",
                                            str(tmp_path / "out"), *argv]))
    cfg = get_cfg_default()
    cfg.merge_from_list(["DATASET.ROOT", str(tmp_path), "DATASET.DATASET", "cifar-10",
                         "OUTPUT_DIR", str(tmp_path / "out")])
    for trainer in (ZeroshotCLIP, ZeroshotCLIP2, MVLPT):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trainer(cfg)


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


# wgmma_gemm_kernel<EPI, BN, B_KMAJOR>: MN-major in mlp_fwd, K-major in mlp_bwd.
_WG = "wgmma_gemm_kernelILi{}ELi{}ELb{}EEEv14CUtensorMap_stS0_iiiN5mvlpt7EpiArgsE"
_MLP_CLEAN = [(_WG.format(4, 256, 0), 0, 168), (_WG.format(3, 128, 0), 0, 168),
              ("gemm_kernelIfLb0ELi4EEEvPKT_S3_iiiNS_7EpiArgsE", 0, 80)]
_BWD_CLEAN = [(_WG.format(5, 256, 1), 0, 168), (_WG.format(1, 128, 1), 0, 168),
              ("gemm_kernelIfLb1ELi5EEEvPKT_S3_iiiNS_7EpiArgsE", 0, 80)]
_FWD_TC, _BWD_TC = [("attend_fwd_tcILi26EEEv", 0, 230)], [("attend_bwd_dq_tcILi26EEEv", 0, 127)]
# attn_fwd.cu: the mma.sync cores, windowed attn_core_tc<PROBS> and one-pass
# attn_core_res<NT, PROBS>, and the wgmma GEMM of its two products
# (EPI_BIAS, EPI_BIAS_RESID), beside the fp32 route.
_CORE = "4core12attn_core_tcILb{}EEEvPK13__nv_bfloat16PKfPS2_S7_iiii"
_RES = "3res13attn_core_resILi{}ELb{}EEEv14CUtensorMap_stPK13__nv_bfloat16PKfPS4_S9_iii"
_ATTN_CLEAN = [(_CORE.format(0), 0, 125), (_CORE.format(1), 0, 128),
               (_WG.format(2, 256, 0), 0, 168), (_WG.format(3, 128, 0), 0, 168),
               ("gemm_kernelIfLb0ELi2EEEvPKT_S3_iiiNS_7EpiArgsE", 0, 80),
               (_RES.format(26, 0), 0, 154), (_RES.format(26, 1), 0, 168)]
# attn_bwd.cu: the two mma.sync core launches and the wgmma GEMM of its two
# products (EPI_ROUND, EPI_F32; B K-major), beside the fp32 route's core.
_DQ = "2tc14attn_bwd_dq_tcEPK13__nv_bfloat16S3_S3_PfPS1_iiii"
_DKV = "2tc15attn_bwd_dkv_tcEPK13__nv_bfloat16S3_S3_PKfPS1_iiii"
_ATTNB_CLEAN = [(_DQ, 0, 136), (_DKV, 0, 157), (_WG.format(0, 128, 1), 0, 168),
                (_WG.format(1, 256, 1), 0, 168),
                ("10cuda_cores11attn_bwd_dqEPKfS2_S2_PfS3_iiifi", 0, 64)]


@pytest.mark.parametrize("fwd, bwd, mlp, mlp_bwd, attn, error, attn_bwd", [
    ([("attend_fwd_tcILi26EEEv", 0, 230), ("attend_fwd_kernelEPKf", 0, 32)],
     [("attend_bwd_dq_tcILi26EEEv", 0, 127), ("attend_bwd_dkv_tcILi26EEEv", 0, 168)],
     _MLP_CLEAN, _BWD_CLEAN, _ATTN_CLEAN, None, _ATTNB_CLEAN),
    (_FWD_TC, [("attend_bwd_dq_tcILi26EEEv", 40, 255)], _MLP_CLEAN, _BWD_CLEAN, _ATTN_CLEAN,
     "spill", _ATTNB_CLEAN),
    ([("attend_fwd_kernelEPKf", 0, 32)], _BWD_TC, _MLP_CLEAN, _BWD_CLEAN, _ATTN_CLEAN,
     "no tensor-core kernel in attend_fwd", _ATTNB_CLEAN),
    (_FWD_TC, _BWD_TC, [(_WG.format(4, 256, 0), 24, 168), (_WG.format(3, 128, 0), 0, 168)],
     _BWD_CLEAN, _ATTN_CLEAN, "spill", _ATTNB_CLEAN),
    (_FWD_TC, _BWD_TC, _MLP_CLEAN[2:], _BWD_CLEAN, _ATTN_CLEAN,
     "no tensor-core kernel in mlp_fwd", _ATTNB_CLEAN),
    (_FWD_TC, _BWD_TC, [(_WG.format(4, 256, 0), 0, 128)], _BWD_CLEAN, _ATTN_CLEAN,
     "below 168 registers", _ATTNB_CLEAN),
    (_FWD_TC, _BWD_TC, _MLP_CLEAN, [(_WG.format(5, 256, 1), 16, 168)], _ATTN_CLEAN, "spill",
     _ATTNB_CLEAN),
    (_FWD_TC, _BWD_TC, _MLP_CLEAN, _BWD_CLEAN[2:], _ATTN_CLEAN,
     "no tensor-core kernel in mlp_bwd", _ATTNB_CLEAN),
    (_FWD_TC, _BWD_TC, _MLP_CLEAN, _BWD_CLEAN,
     [(_CORE.format(1), 8, 128)] + _ATTN_CLEAN[2:], "spill", _ATTNB_CLEAN),
    (_FWD_TC, _BWD_TC, _MLP_CLEAN, _BWD_CLEAN, _ATTN_CLEAN[2:],
     "no tensor-core kernel in attn_fwd.cu's build log matches attn_core_tc", _ATTNB_CLEAN),
    (_FWD_TC, _BWD_TC, _MLP_CLEAN, _BWD_CLEAN, _ATTN_CLEAN[:2] + _ATTN_CLEAN[4:],
     "no tensor-core kernel in attn_fwd.cu's build log matches wgmma_gemm_kernel", _ATTNB_CLEAN),
    (_FWD_TC, _BWD_TC, _MLP_CLEAN, _BWD_CLEAN,
     _ATTN_CLEAN[:2] + [(_WG.format(2, 256, 0), 0, 160)] + _ATTN_CLEAN[5:], "below 168 registers",
     _ATTNB_CLEAN),
    (_FWD_TC, _BWD_TC, _MLP_CLEAN, _BWD_CLEAN,
     _ATTN_CLEAN[:6] + [(_RES.format(26, 1), 16, 168)], "spill", _ATTNB_CLEAN),
    (_FWD_TC, _BWD_TC, _MLP_CLEAN, _BWD_CLEAN, _ATTN_CLEAN[:5],
     "no tensor-core kernel in attn_fwd.cu's build log matches attn_core_res", _ATTNB_CLEAN),
    (_FWD_TC, _BWD_TC, _MLP_CLEAN, _BWD_CLEAN, _ATTN_CLEAN, "spill",
     [(_DQ, 0, 136), (_DKV, 24, 168)] + _ATTNB_CLEAN[2:]),
    (_FWD_TC, _BWD_TC, _MLP_CLEAN, _BWD_CLEAN, _ATTN_CLEAN,
     "no tensor-core kernel in attn_bwd.cu's build log matches attn_bwd_", _ATTNB_CLEAN[2:]),
    (_FWD_TC, _BWD_TC, _MLP_CLEAN, _BWD_CLEAN, _ATTN_CLEAN,
     "no tensor-core kernel in attn_bwd.cu's build log matches wgmma_gemm_kernel",
     _ATTNB_CLEAN[:2] + _ATTNB_CLEAN[4:]),
], ids=["clean", "spill", "no-tc-kernel", "wgmma-spill", "no-wgmma-kernel", "wgmma-short",
        "kmajor-spill", "no-kmajor-kernel", "attn-core-spill", "no-attn-core",
        "no-attn-wgmma", "attn-wgmma-short", "attn-res-spill", "no-attn-res",
        "attn-bwd-core-spill", "no-attn-bwd-core", "no-attn-bwd-wgmma"])
def test_chip_smoke_spill_check_reads_each_attention_kernel(fwd, bwd, mlp, mlp_bwd, attn, error,
                                                            attn_bwd, capsys):
    """The spill check reads the tensor-core kernels of each source: the
    standalone attention's, the attention half-blocks' mma.sync cores (the
    forward's windowed and one-pass ones) and wgmma GEMMs (forward and
    backward), and the wgmma GEMM's of mlp_fwd and
    mlp_bwd (B read K-major in the backwards); each wgmma GEMM must also
    hold the registers setmaxnreg's split needs, and a source must name a
    kernel of each of its patterns."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    logs = {"attend_fwd": _ptxas_log(*fwd), "attend_bwd": _ptxas_log(*bwd),
            "mlp_fwd": _ptxas_log(*mlp), "mlp_bwd": _ptxas_log(*mlp_bwd),
            "attn_fwd": _ptxas_log(*attn), "attn_bwd": _ptxas_log(*attn_bwd)}
    assert chip_smoke.HGMMA_SOURCES == ("attn_fwd", "attn_bwd", "mlp_fwd", "mlp_bwd")
    assert chip_smoke.HMMA_SOURCES == ("attn_fwd", "attn_bwd")
    if error is None:
        chip_smoke.check_tc_spills(logs)
        out = capsys.readouterr().out
        assert "attend_fwd_tc<NT=26>: 230 registers, 0 bytes of spills" in out
        assert "attn_fwd attn_core_tc<PROBS=1>: 128 registers, 0 bytes of spills" in out
        assert "attn_fwd attn_core_res<NT=26,PROBS=1>: 168 registers, 0 bytes of spills" in out
        assert "attn_fwd attn_core_res<NT=26,PROBS=0>: 154 registers, 0 bytes of spills" in out
        assert ("attn_fwd wgmma_gemm_kernel<EPI=2,BN=256,KMAJOR=0>: 168 registers, 0 bytes of "
                "spills") in out
        assert ("mlp_fwd wgmma_gemm_kernel<EPI=4,BN=256,KMAJOR=0>: 168 registers, 0 bytes of "
                "spills") in out
        assert ("mlp_bwd wgmma_gemm_kernel<EPI=5,BN=256,KMAJOR=1>: 168 registers, 0 bytes of "
                "spills") in out
        assert "attn_bwd attn_bwd_dkv_tc: 157 registers, 0 bytes of spills" in out
        assert ("attn_bwd wgmma_gemm_kernel<EPI=0,BN=128,KMAJOR=1>: 168 registers, 0 bytes of "
                "spills") in out
        assert "gemm_kernelIf" not in out and "cuda_cores" not in out
    else:
        with pytest.raises(AssertionError, match=error):
            chip_smoke.check_tc_spills(logs)


def test_chip_smoke_fails_a_row_past_its_bound():
    """Rows hold to the rule at TOL (fp32 1e-4 x max|ref| against the
    twin; bf16 max|out - ref64| <= max(2 max|ref - ref64|, 5e-3
    max|ref64|)). One bf16 ulp in [4, 8) at max|ref64| 5.46875 (0.03125 >
    0.02734) fails the run where the twin agrees with the fp64-summed twin,
    and passes where the twin sits half an ulp from it; the old bound's
    verdict (ok_old) stops nothing."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.TOL == {"float32": 1e-4, "bfloat16": 5e-3}
    assert chip_smoke.TWIN_FACTOR == 2
    ref64 = torch.tensor([5.46875, 2.5, -1.0], dtype=torch.bfloat16)
    flip = torch.tensor([5.5, 2.5, -1.0], dtype=torch.bfloat16)
    twin_half_ulp = torch.tensor([5.46875, 2.515625, -1.0], dtype=torch.bfloat16)
    head = dict(name="attn_fwd", mode="no-residual", tower="image_eval", dtype="bfloat16")
    row = dict(head, **chip_smoke.verdict("bfloat16", flip, twin_half_ulp, ref64))
    assert row["ok"] and not row["ok_old"] and row["tol"] == 0.03125
    assert chip_smoke._fail_on_disagreement([row]) == [row]
    row = dict(head, **chip_smoke.verdict("bfloat16", flip, ref64, ref64))
    assert not row["ok"] and row["twin_err64"] == 0.0
    with pytest.raises(AssertionError, match=r"max\|err64\| 0.03125 > 0.02734375"):
        chip_smoke._fail_on_disagreement([row])
    ref = torch.tensor([1.0, -2.0])
    row = dict(head, dtype="float32",
               **chip_smoke.verdict("float32", ref + torch.tensor([0.0, 2.5e-4]), ref))
    with pytest.raises(AssertionError, match=r"float32\): max\|err\| .* > 0.0002"):
        chip_smoke._fail_on_disagreement([row])


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
