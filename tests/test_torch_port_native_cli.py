"""The training CLI on DATALOADER.BACKEND "native", the port's against the
JAX package's, on the CPU in fp32 (the shared set-up is
tests/test_torch_port_trainer.py's): a CoOp dataset, and an ELEVATER
task whose train images sit inside a zip (``train.zip@member``, read by
``zipio.read_bytes`` straight into the C core) and whose test images are
files. Per-step losses within 1e-4 relative and prompt leaves within
1e-4 x max|leaf| of the JAX run, every result within one test sample;
and the port's "native" run equal bit for bit to its "python" run
(the core's pixels are PIL's)."""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

from tests.test_torch_port_trainer import (  # noqa: F401 (fixtures)
    CLASSES, TINY_OPTS, _argv, _close_prompts, _flat, _results, _run, env, init_dir,
    synthetic_vocab, world)
from tests.torch_port_util import write_elevater_task

NATIVE = ("DATALOADER.BACKEND", "native")


@pytest.fixture(autouse=True)
def jax_core_in_tmp(tmp_path_factory, monkeypatch):
    """The JAX package's core builds under a tmp dir, not ~/.cache."""
    monkeypatch.setenv("MVLPT_TPU_NATIVE_CACHE", str(tmp_path_factory.getbasetemp() / "jn"))


def _check(runs):
    (jt, j_losses), (tt, t_losses) = runs["jax"], runs["port"]
    assert len(t_losses) == len(j_losses) > 0
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    _close_prompts(_flat(tt.state.prompt_params), _flat(jt.state.prompt_params))
    assert runs["python"][1] == t_losses  # bit for bit
    for a, b in zip(_leaves(runs["python"][0]), _leaves(tt)):
        assert torch.equal(a, b)


def _leaves(trainer):
    from mvlpt_torch.utils.tree import tree_leaves

    return tree_leaves(trainer.state.prompt_params)


def _close_results(out, n_test):
    t_res, j_res = _results(out / "port"), _results(out / "jax")
    assert len(t_res) == len(j_res) > 0
    for a, b in zip(t_res, j_res):
        assert a.keys() == b.keys()
        for k in b:
            assert abs(a[k] - b[k]) <= 100.0 / n_test + 1e-9, (k, a, b)


def test_coop_cli_native_matches_jax(env, init_dir, tmp_path, monkeypatch):
    argv = ["--model-dir", init_dir, "--shots", "4"]
    runs = {p: _run(p, _argv(env, tmp_path / p, *argv, opts=NATIVE), monkeypatch)
            for p in ("jax", "port")}
    runs["python"] = _run("port", _argv(env, tmp_path / "python", *argv), monkeypatch)
    from mvlpt_torch.data.native_transform import NativeEvalTransform, NativeTrainTransform

    tt = runs["port"][0]
    assert isinstance(tt.train_loader_x.dataset.transform, NativeTrainTransform)
    assert isinstance(tt.test_loader.dataset.transform, NativeEvalTransform)
    _check(runs)
    _close_results(tmp_path, 3 * len(CLASSES))


@pytest.fixture(scope="module")
def zipped_task(world):
    """kitti-distance (4 classes): 3 train images a class inside train.zip,
    2 test images a class as files."""
    root = world["root"] / "elevater_zip"
    write_elevater_task(root, "kitti-distance", 4, seed=7, n_train=3, n_test=2)
    task_dir = root / "kitti-distance"
    manifest = json.loads((task_dir / "manifest.json").read_text())
    with zipfile.ZipFile(task_dir / "train.zip", "w") as zf:
        for row in manifest["splits"]["train"]:
            zf.write(task_dir / row[0], row[0])
            os.remove(task_dir / row[0])
            row[0] = f"train.zip@{row[0]}"
    (task_dir / "manifest.json").write_text(json.dumps(manifest))
    return str(root)


def test_elevater_cli_native_from_a_zip_matches_jax(env, zipped_task, tmp_path, monkeypatch):
    argv = ["--root", zipped_task, "--trainer", "MVLPT", "--dataset", "kitti-distance",
            "--shots", "3", "--seed", "1", "--cut-contextlen", *TINY_OPTS,
            "OPTIM.MAX_EPOCH", "1", "TRAIN.STEPS_PER_DISPATCH", "2", "TRAIN.WINDOW_MIN_TAIL",
            "1"]
    # both runs warm-start from the JAX package's initial prompt
    init, _ = _run("jax", ["--output-dir", str(tmp_path / "init"), "--no-train", *argv],
                   monkeypatch)
    init.save_checkpoint(best=True)
    argv = ["--model-dir", str(tmp_path / "init"), *argv]
    runs = {p: _run(p, ["--output-dir", str(tmp_path / p), *argv, *NATIVE], monkeypatch)
            for p in ("jax", "port")}
    runs["python"] = _run("port", ["--output-dir", str(tmp_path / "python"), *argv],
                          monkeypatch)
    tt = runs["port"][0]
    assert all(".zip@" in it.impath for it in tt.train_loader_x.dataset.items)
    assert tt.train_loader_x.dataset.transform.wants_bytes
    _check(runs)
    _close_results(tmp_path, 8)
