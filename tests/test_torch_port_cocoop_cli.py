"""The port's training CLI with the CoCoOp trainer against the JAX
package's, on the CPU in fp32, as scripts/cocoop/ runs it
(configs/trainers/CoCoOp/vit_b16.yaml, --dataset-config-file, the
script's DATASET opts). The shared set-up is
tests/test_torch_port_trainer.py's: one tiny OpenAI-layout checkpoint,
the synthetic vocab, per-step losses recorded by wrapping each package's
step factories; both packages warm-start from a JAX-written initial
prompt (--model-dir), since the two inits draw from different generators.

- base2new_train.sh then base2new_test.sh on a 4-class OxfordPets-layout
  dataset: training on the base half (2 classes), each package then
  evaluating the new half from the OTHER package's run directory, so
  CoCoOp checkpoints load in both directions.
- xd_train.sh then xd_test.sh: training on all 4 classes, then
  --eval-only on a 3-class Caltech101-layout dataset from that run.

Each holds per-step losses within 1e-4 relative, prompt leaves within
1e-4 x max|leaf|, every ``results`` value within one test sample.
"""

import os

import numpy as np
import pytest

from tests.test_torch_port_trainer import (  # noqa: F401 (fixtures)
    _close_prompts, _flat, _results, _run, env, synthetic_vocab, world)
from tests.util_fixtures import make_coop_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COCOOP_OPTS = [
    "OPTIM.MAX_EPOCH", "2", "OPTIM.LR", "0.05", "OPTIM.WARMUP_EPOCH", "0",
    "DATALOADER.TRAIN_X.BATCH_SIZE", "4", "DATALOADER.TEST.BATCH_SIZE", "4",
    "DATALOADER.NUM_WORKERS", "0", "INPUT.SIZE", "(32, 32)", "TRAIN.PRINT_FREQ", "1",
    "TRAINER.COCOOP.N_CTX", "2", "TRAINER.COCOOP.PREC", "fp32",
]
CALTECH = ("face", "leopard", "motorbike")


@pytest.fixture(scope="module")
def caltech(world):
    make_coop_dataset(world["root"] / "data", "caltech-101", CALTECH, n_train=2, n_val=1,
                      n_test=3, split_name="split_zhou_Caltech101.json",
                      image_subdir="101_ObjectCategories")
    return world["data"]


def _argv(env, dataset: str, out, *flags, opts=()):
    """A scripts/cocoop/*.sh command line on ``dataset``'s yaml."""
    return ["--root", env["data"], "--seed", "1", "--trainer", "CoCoOp", "--dataset-coop",
            "--dataset-config-file", os.path.join(ROOT, "configs/datasets", f"{dataset}.yaml"),
            "--config-file", os.path.join(ROOT, "configs/trainers/CoCoOp/vit_b16.yaml"),
            "--output-dir", str(out), *flags, *COCOOP_OPTS, *opts]


@pytest.fixture
def init_dir(env, tmp_path, monkeypatch):
    """The JAX package's initial CoCoOp prompt, as model-best.pth.tar."""
    trainer, _ = _run("jax", _argv(env, "oxford_pets", tmp_path / "init", "--no-train"),
                      monkeypatch)
    trainer.save_checkpoint(best=True)
    return str(tmp_path / "init")


def _close_results(a: list, b: list, n_test: int):
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in y:
            assert abs(x[k] - y[k]) <= 100.0 / n_test + 1e-9, (k, x, y)


def _train_both(env, tmp_path, monkeypatch, init_dir, dataset, opts):
    """The same training command through both CLIs -> {package: trainer}."""
    trainers, losses = {}, {}
    for package in ("jax", "port"):
        trainers[package], losses[package] = _run(
            package, _argv(env, dataset, tmp_path / package, "--model-dir", init_dir,
                           opts=opts), monkeypatch)
    assert len(losses["port"]) == len(losses["jax"]) > 0
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4)
    _close_prompts(_flat(trainers["port"].state.prompt_params),
                   _flat(trainers["jax"].state.prompt_params))
    return trainers, losses


def test_base2new_train_then_test_matches_jax(env, init_dir, tmp_path, monkeypatch):
    """base2new_train.sh: the base classes, two epochs, the final test on
    them; then base2new_test.sh, each package from the other's run."""
    shots = ("DATASET.NUM_SHOTS", "4")
    trainers, losses = _train_both(env, tmp_path, monkeypatch, init_dir, "oxford_pets",
                                   (*shots, "DATASET.SUBSAMPLE_CLASSES", "base"))
    assert trainers["port"].num_classes == trainers["jax"].num_classes == 2
    assert len(losses["port"]) == 2 * 2  # 2 classes x 4 shots / batch 4, two epochs
    assert "cocoop" in trainers["port"].state.prompt_params
    _close_results(_results(tmp_path / "port"), _results(tmp_path / "jax"), 2 * 3)

    tested = {}
    for package, other in (("port", "jax"), ("jax", "port")):
        tested[package], test_losses = _run(
            package, _argv(env, "oxford_pets", tmp_path / f"test_{package}", "--model-dir",
                           str(tmp_path / other), "--eval-only",
                           opts=(*shots, "DATASET.SUBSAMPLE_CLASSES", "new")), monkeypatch)
        assert test_losses == []
        # the other package's checkpoint, loaded leaf for leaf
        np.testing.assert_equal(_flat(tested[package].state.prompt_params),
                                _flat(trainers[other].state.prompt_params))
    assert tested["port"].num_classes == 2
    _close_results(_results(tmp_path / "test_port"), _results(tmp_path / "test_jax"), 2 * 3)


def test_xd_train_then_xd_test_matches_jax(env, caltech, init_dir, tmp_path, monkeypatch):
    """xd_train.sh on all four classes, then xd_test.sh on Caltech101's
    three from that run's directory: the conditioned context carries over
    to other classes."""
    trainers, _ = _train_both(env, tmp_path, monkeypatch, init_dir, "oxford_pets",
                              ("DATASET.NUM_SHOTS", "2"))
    assert trainers["port"].num_classes == 4
    _close_results(_results(tmp_path / "port"), _results(tmp_path / "jax"), 4 * 3)
    for package in ("jax", "port"):
        tested, _ = _run(package, _argv(env, "caltech101", tmp_path / f"xd_{package}",
                                        "--model-dir", str(tmp_path / package), "--eval-only"),
                         monkeypatch)
        assert tested.num_classes == len(CALTECH)
    _close_results(_results(tmp_path / "xd_port"), _results(tmp_path / "xd_jax"),
                   3 * len(CALTECH))
