"""scripts/torch_port_soak_synthetic.py on the CPU.

Its task directories byte-equal to those of tests/util_fixtures.py's
``make_elevater_task`` (which scripts/soak_synthetic.py writes); a short
run through the port's training CLI that reaches its end and reads the
multitask average from log.txt; and the first train batch of the soak's
data the same on DATALOADER.BACKEND "python" and "native" (the native
core built from the checkout, as in tests/test_torch_port_native.py).
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

from tests.torch_port_util import synthetic_vocab  # noqa: F401 (fixture)
from tests.util_fixtures import make_elevater_task

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def soak():
    spec = importlib.util.spec_from_file_location(
        "torch_port_soak_synthetic", ROOT / "scripts" / "torch_port_soak_synthetic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("task", ["cifar-10", "mnist"])
def test_task_dirs_byte_equal_to_the_fixture(soak, tmp_path, task):
    assert task in soak.TASKS
    soak.write_task(str(tmp_path / "port"), task, soak.N_CLASSES, n_train=23, n_test=7)
    make_elevater_task(str(tmp_path / "fixture"), task, n_classes=soak.N_CLASSES,
                       n_train=23, n_test=7)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "fixture")
    assert len(want) == 23 + 7 + 1
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name


def test_short_soak_runs_through_the_cli(soak, synthetic_vocab, tmp_path):  # noqa: F811
    out = soak.run(["--epochs", "2", "--n-train", "16", "--n-test", "8", "--min-acc", "0"],
                   device="cpu", workdir=str(tmp_path))
    log = Path(out["out"]) / "log.txt"
    assert out["final"] == soak.final_average(str(log))
    assert 0.0 <= out["final"] <= 1.0
    trainer = out["trainer"]
    assert trainer.cfg.DATALOADER.BACKEND == "native"
    assert trainer.cfg.OPTIM.MAX_EPOCH == 2
    assert (Path(out["out"]) / "prompt_learner" / "model-best.pth.tar").is_file()
    # The tower override is undone once the run ends.
    from mvlpt_torch.core import clip as cc

    assert cc.VIT_ARCHS["ViT-B/32"]["vision_width"] == 768
    assert 16 not in cc._TEXT_ARCHS and "MVLPT_TPU_RANDOM_CLIP" not in os.environ


def test_python_and_native_give_the_same_first_batch(soak, synthetic_vocab, tmp_path):  # noqa: F811
    from mvlpt_torch.cli.train import build_parser, main

    root = str(tmp_path / "data")
    for task in soak.TASKS:
        soak.write_task(root, task, soak.N_CLASSES, n_train=16, n_test=4)
    batches = {}
    for backend in ("python", "native"):
        argv = soak.cli_argv(root, str(tmp_path / backend), 2, backend=backend,
                             flags=("--no-train",))
        with soak.tiny_towers():
            trainer = main(build_parser().parse_args(argv), device="cpu")
        assert trainer.cfg.DATALOADER.BACKEND == backend
        batches[backend] = next(iter(trainer.train_loader_x))
    from mvlpt_torch.data.native_transform import NativeEvalTransform

    # ELEVATER trains without augmentation (data/managers._elevater_transform).
    assert isinstance(trainer.train_loader_x.dataset.transform, NativeEvalTransform)
    assert batches["python"].keys() == batches["native"].keys()
    for k in batches["python"]:
        np.testing.assert_array_equal(np.asarray(batches["native"][k]),
                                      np.asarray(batches["python"][k]))
    assert np.asarray(batches["python"]["image"]).shape[0] == 8
