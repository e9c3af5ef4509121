"""The attention cores' marks over a traced stretch of a train cell,
shared by the metrics that read them (``attn_core_step_ms.train``,
``attn_core_roofline_pct.train``).

The program's tracing runs at the core marks' level alone
(``enable_tracing(True, kernels=False, cores=True)``): the step's, the
towers' and the window's spans as at ``spans.read(run)``'s level, and the
marks that the attention half-blocks' launchers write right before and
after their core (``core.attn_fwd``: the forward core; ``core.attn_bwd``:
the backward's dq and dkv cores), without the half-blocks' own stamps.
One window captures the step with its marks; then whole windows of about
``spans.STEPS`` replayed steps, each giving one sample of the step's
marks. The reading is kept on the run, so both metrics read the same
stretch, and no stretch that another metric reads runs with the marks.

With a program whose tracing has no core marks, or off a train cell or
the card, it reads nothing, and the metrics built on it read None.
"""

from __future__ import annotations

import dataclasses
import sys

from portbench import spans

CORES = frozenset({"core.attn_fwd", "core.attn_bwd"})


def read(run) -> list | None:
    """The span log of the stretch with the core marks (cached on
    ``run``), or None where it holds no core mark."""
    if run.device.type != "cuda" or run.cell.traffic["kind"] != "train_window":
        return None
    if not hasattr(run, "core_marks"):
        log = _stretch(run)
        run.core_marks = log if log and any(s.name in CORES for s in log) else None
        if run.core_marks is not None:
            print(f"core marks: marks a step {sorted(set(marks_per_step(log)))}, core ms a "
                  f"step median {spans.median(step_ms(log))}", file=sys.stderr)
    return run.core_marks


def _stretch(run) -> list | None:
    """The span log of whole windows at the core marks' level, or None
    with a program that has no such level."""
    import torch

    from mvlpt_torch.utils import profiler

    if not hasattr(profiler, "core_marks"):
        return None
    loop = run.loop
    profiler.enable_tracing(True, kernels=False, cores=True)
    try:
        loop.run_window()        # the step's capture with its marks
        profiler.reset_spans()
        for _ in range(max(1, round(spans.STEPS / loop.k))):
            loop.run_window()
        torch.cuda.synchronize()
        return profiler.spans().spans
    finally:
        profiler.enable_tracing(False)
        profiler.reset_spans()


def step_ms(log: list) -> list:
    """The device ms between the core marks, summed a step, a list over
    the steps."""
    return spans.per_step(log, CORES)


def marks_per_step(log: list) -> list:
    """The core marks' spans a step wrote, a list over the steps."""
    ones = [dataclasses.replace(s, device_ms=1.0) if s.name in CORES else s for s in log]
    return [round(n) for n in spans.per_step(ones, CORES)]
