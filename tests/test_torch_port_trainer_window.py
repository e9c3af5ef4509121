"""The port's training CLI against the JAX package's on the CPU, in fp32,
over the windowed epoch loop and resume (the shared set-up is
tests/test_torch_port_trainer.py's): a tail of at least
TRAIN.WINDOW_MIN_TAIL batches as one window, a shorter tail a step a
call, a window clamped to the epoch (with uint8 staging), each with the
same calls, per-step losses within 1e-4 relative and prompts within
1e-4 x max|leaf|; resume from a JAX-written checkpoint (its step, and
optax's SGD trace as the momentum) and from the port's own, with the
best-val watermark."""

import os
import shutil

import numpy as np
import pytest

from tests.test_torch_port_trainer import (  # noqa: F401 (fixtures)
    _argv, _close_prompts, _flat, _run, env, init_dir, synthetic_vocab, world)


@pytest.mark.parametrize("opts,want", [
    (("TRAIN.STEPS_PER_DISPATCH", "3", "TRAIN.WINDOW_MIN_TAIL", "1"),
     [("window", 3), ("window", 3), ("window", 1)]),
    (("TRAIN.STEPS_PER_DISPATCH", "3", "TRAIN.WINDOW_MIN_TAIL", "2"),
     [("window", 3), ("window", 3), ("step", 1)]),
    (("TRAIN.STEPS_PER_DISPATCH", "20", "TPU.DEVICE_NORMALIZE", "True"), [("window", 7)]),
], ids=["tail-window", "short-tail", "clamped-uint8"])
def test_windowed_epochs_match_jax(env, init_dir, tmp_path, monkeypatch, opts, want):
    """Two epochs of 7 batches (28 images, batch 4)."""
    opts = (*opts, "TEST.NO_TEST", "True", "TEST.FINAL_MODEL", "last_step")
    runs = {}
    for package in ("jax", "port"):
        calls: list = []
        trainer, losses = _run(package, _argv(env, tmp_path / package, "--model-dir", init_dir,
                                              opts=opts), monkeypatch, calls)
        runs[package] = (trainer, losses, calls)
    (jt, j_losses, j_calls), (tt, t_losses, t_calls) = runs["jax"], runs["port"]
    assert t_calls == j_calls == want * 2
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    _close_prompts(_flat(tt.state.prompt_params), _flat(jt.state.prompt_params))
    assert tt.state.step == 14


def test_resume_matches_jax(env, init_dir, tmp_path, monkeypatch):
    """A two-epoch run of each package with an epoch checkpoint each
    epoch; its model.pth.tar-2 removed, as if it stopped after epoch 1;
    then resumed: the port from the JAX run's checkpoint and from its
    own, the JAX package from its own. The resumed epochs' losses and
    the final prompts agree, and the port takes the JAX run's step and
    momentum (optax's trace) and the best-val watermark."""
    from mvlpt_tpu.checkpoint import prompt_io as j_io

    opts = ("TRAIN.CHECKPOINT_FREQ", "1", "TRAIN.STEPS_PER_DISPATCH", "2",
            "TRAIN.WINDOW_MIN_TAIL", "1")
    argv = ["--model-dir", init_dir, "--shots", "4"]
    first = {p: _run(p, _argv(env, tmp_path / f"{p}_first", *argv, opts=opts), monkeypatch)[0]
             for p in ("jax", "port")}
    dirs = {}
    for name, src in (("jax", "jax"), ("port_from_jax", "jax"), ("port", "port")):
        dirs[name] = tmp_path / f"{name}_resumed"
        shutil.copytree(tmp_path / f"{src}_first", dirs[name])
        os.remove(dirs[name] / "prompt_learner" / "model.pth.tar-2")

    from mvlpt_torch.train.trainer import build_trainer

    resumed = {}
    for name, package in (("jax", "jax"), ("port_from_jax", "port"), ("port", "port")):
        resumed[name] = _run(package, _argv(env, tmp_path / f"{name}_out", "--resume",
                                            str(dirs[name]), *argv, opts=opts), monkeypatch)
    j_trainer, j_losses = resumed["jax"]
    for name in ("port_from_jax", "port"):
        trainer, losses = resumed[name]
        assert trainer.epoch == 1 and len(losses) == 4
        np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
        _close_prompts(_flat(trainer.state.prompt_params), _flat(j_trainer.state.prompt_params))
        assert trainer.best_result == pytest.approx(first["jax"].best_result)

    # the resumed state itself: step 4 (one epoch of 4 batches) and the
    # JAX run's momentum, before any step
    trainer = resumed["port_from_jax"][0]
    payload = j_io.load_prompt_checkpoint(j_io.checkpoint_path(str(dirs["port_from_jax"]), 1))
    trainer.state.opt.count.zero_()
    for buf in trainer.state.opt.slots["momentum"]:
        buf.zero_()
    trainer.resume_from_checkpoint(str(dirs["port_from_jax"]))
    assert trainer.state.step == payload["step"] == 4
    trace = payload["opt_state"][-2].trace if hasattr(payload["opt_state"][-2], "trace") else None
    assert trace is not None
    flat_trace = _flat(trace)
    from mvlpt_torch.utils.tree import tree_keys

    for k, buf in zip(tree_keys(trainer.state.prompt_params), trainer.state.opt.slots["momentum"]):
        np.testing.assert_array_equal(buf.numpy(), flat_trace[k], err_msg=k)
    assert build_trainer  # the entry the CLI uses
