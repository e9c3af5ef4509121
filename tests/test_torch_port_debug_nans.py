"""--debug-nans (``utils.profiler.enable_nan_debugging``) against the JAX
package's (``jax_debug_nans``), on the CPU.

Both training CLIs raise FloatingPointError on the same injected NaN (a
NaN in the CLIP checkpoint's image projection, which every image's
features pass through). The port raises at the first non-finite loss,
gradient or updated parameter, naming the step, in the per-step path and
in a window (which then runs eagerly); the same step without the NaN
runs; the mode turns off again. Also the module's ``trace`` and
``StepTimer``."""

import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_checkpoint import _openai_state_dict
from tests.test_torch_port_trainer import (  # noqa: F401 (fixtures)
    _argv, env, synthetic_vocab, world)
from tests.torch_port_util import two_sides


@pytest.fixture
def nan_debugging():
    """Turns the port's NaN debugging on, and both packages' off after."""
    from mvlpt_torch.utils import profiler

    profiler.enable_nan_debugging()
    try:
        yield profiler
    finally:
        profiler.enable_nan_debugging(False)
        jax.config.update("jax_debug_nans", False)
    assert not torch.is_anomaly_enabled()


def _batch(k=None, nan_at=None):
    rng = np.random.RandomState(0)
    shape = (4, 32, 32, 3) if k is None else (k, 4, 32, 32, 3)
    image = rng.randn(*shape).astype(np.float32)
    if nan_at is not None:
        image[nan_at] = np.nan
    labels = rng.randint(0, 5, shape[:-3])
    return {"image": torch.from_numpy(image), "label": torch.from_numpy(labels)}


def test_step_raises_at_the_first_nan(synthetic_vocab, nan_debugging):  # noqa: F811
    from mvlpt_torch.config import optim_config
    from mvlpt_torch.train import init_train_state, make_train_step, make_train_step_multi

    model, backbone, pp, consts = two_sides(5)["t"]
    step = make_train_step(model)
    state = init_train_state(pp, optim_config(), 1)
    step(state, backbone, consts, _batch())  # no NaN: the step runs
    assert state.step == 1
    with pytest.raises(FloatingPointError, match="step 2: non-finite loss"):
        step(state, backbone, consts, _batch(nan_at=(1, 3, 4, 0)))
    # a window (eager under the mode) names the step of the window
    state = init_train_state(pp, optim_config(), 1)
    window = make_train_step_multi(model)
    with pytest.raises(FloatingPointError, match="step 2: non-finite loss"):
        window(state, backbone, consts, _batch(3, nan_at=(1, 0, 5, 5, 1)))
    assert window.captures == 0


def test_checks_are_off_by_default(synthetic_vocab):  # noqa: F811
    """Without the mode a NaN batch runs (to a NaN loss) and raises nothing."""
    from mvlpt_torch.config import optim_config
    from mvlpt_torch.train import init_train_state, make_train_step
    from mvlpt_torch.utils import profiler

    assert not profiler.nan_debugging()
    model, backbone, pp, consts = two_sides(5)["t"]
    state = init_train_state(pp, optim_config(), 1)
    _, m = make_train_step(model)(state, backbone, consts, _batch(nan_at=(0, 0, 0, 0)))
    assert torch.isnan(m["loss"])


def test_both_clis_raise_on_the_same_nan(env, tmp_path, monkeypatch, nan_debugging):
    sd = _openai_state_dict(0)
    sd["visual.proj"][3, 1] = float("nan")
    ckpt = tmp_path / "ViT-nan.pt"
    torch.save(sd, str(ckpt))
    monkeypatch.setenv("MVLPT_TPU_CLIP_CKPT", str(ckpt))
    saved = sys.stdout
    try:
        from mvlpt_tpu.cli import train as j_cli

        with pytest.raises(FloatingPointError):
            j_cli.main(j_cli.build_parser().parse_args(
                ["--debug-nans", *_argv(env, tmp_path / "jax", "--shots", "2")]))
        from mvlpt_torch.cli import train as t_cli

        with pytest.raises(FloatingPointError, match="step 1: non-finite loss"):
            t_cli.main(t_cli.build_parser().parse_args(
                ["--debug-nans", *_argv(env, tmp_path / "port", "--shots", "2")]),
                device="cpu")
    finally:
        sys.stdout = saved  # both loggers tee stdout into log.txt
    assert nan_debugging.nan_debugging() and torch.is_anomaly_enabled()


def test_trace_and_step_timer(tmp_path):
    """``trace`` writes a Chrome trace of what ran inside it; ``StepTimer``
    skips its warm-up steps and reports items a second, as the JAX
    package's does."""
    import json

    from mvlpt_tpu.utils.profiler import StepTimer as JTimer

    from mvlpt_torch.utils.profiler import StepTimer, trace

    with trace(str(tmp_path / "trace")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    (path,) = (tmp_path / "trace").iterdir()
    assert any("mm" in ev.get("name", "") for ev in json.loads(path.read_text())["traceEvents"])
    for timer in (StepTimer(warmup=1), JTimer(warmup=1)):
        assert timer.throughput() == 0.0
        for _ in range(3):
            timer.start()
            timer.stop(n_items=4)
        assert timer.count == 3 and timer.elapsed > 0
        assert timer.throughput() == pytest.approx(8 / timer.elapsed)
