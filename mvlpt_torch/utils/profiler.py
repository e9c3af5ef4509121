"""Profiling and debug hooks: the counterpart of
``mvlpt_tpu/utils/profiler.py`` (a trace of the device, a step timer, and
fail-fast NaN checking as the analogue of the dormant
TRAIN.DETECT_ANOMALY flag)."""

from __future__ import annotations

import contextlib
import os
import time

import torch

_NAN_DEBUGGING = False


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the host and the card (CPU and
    CUDA activities) into ``logdir`` as a Chrome trace, viewable in
    Perfetto or TensorBoard."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}.json"))


def enable_nan_debugging(enabled: bool = True) -> None:
    """Fail fast on NaNs (debug mode), as ``jax_debug_nans`` does: every
    train step then checks its loss, its gradients and the updated
    parameters, and raises FloatingPointError at the first non-finite one,
    naming the step (``check_finite``); autograd's anomaly mode runs too,
    so a backward that makes a NaN names its op. The checks read the
    device every step, which a CUDA graph cannot capture, so windowed
    steps (``make_train_step_multi``) run eagerly while this is on.
    ``enabled=False`` turns it off again."""
    global _NAN_DEBUGGING
    _NAN_DEBUGGING = bool(enabled)
    torch.autograd.set_detect_anomaly(_NAN_DEBUGGING)


def nan_debugging() -> bool:
    """Whether ``enable_nan_debugging`` is on."""
    return _NAN_DEBUGGING


def check_finite(step: int, what: str, tensors) -> None:
    """Raise FloatingPointError when any of ``tensors`` holds a NaN or an
    infinity (reads the device)."""
    for i, t in enumerate(tensors):
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"step {step}: non-finite {what} (tensor {i} of "
                                     f"{len(tensors)}, shape {tuple(t.shape)})")


class StepTimer:
    """Wall-clock step timer with warmup skip; reports images/sec."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.count = 0
        self.elapsed = 0.0
        self.items = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_items: int = 1):
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.elapsed += dt
            self.items += n_items

    def throughput(self) -> float:
        if self.elapsed == 0:
            return 0.0
        return self.items / self.elapsed
