"""The program's own spans (``mvlpt_torch.utils.profiler``) over
traced stretches of the cell, shared by the metrics that read them.

``read(run, kernels)`` turns the program's tracing on (with the kernels'
stamps or without them: ``enable_tracing(kernels=...)``), runs the cell's
stretch twice, takes the span log of each, turns tracing off, and keeps
the reading on ``run``, so that every metric of the run that reads one
level reads the same stretches. A train cell first runs one window with
tracing on (it captures the step again, with its spans); a stretch is
whole windows of about STEPS steps, each replayed step giving one sample
of the captured step's spans (their stamps on the device). An eval
cell's stretch is one pass over its pool.

The first stretch runs alone: its spans' stamps and host times are what
the tower, half-block and eval host metrics read. The second runs under
torch.profiler, whose kernel records slow a replayed graph of many short
kernels (about 4% at c100's shapes), so its stamps read the profiler
too; from it come only the device's busy time of the work that each
top-level span launched (``eval_device_ms.eval``,
``window_prep_ms.train``: busy time leaves out the device's waits for the
host), the check that a step's top-level spans cover its busy time, and
the idle gaps, each put down to the innermost ``mvlpt.*`` span open on
the host when it began, on stderr. The kernels' level has no second
stretch: its 200 more stamps a step at c100's shapes overflow the
profiler's records. Each metric reads the level with the fewest stamps
that holds its spans: only ``halfblock_step_ms.train`` reads the
half-blocks' stamps, which cost a captured step about 2% at c100's
shapes (PERF.md).

With a program that has no spans (no ``enable_tracing``) it reads
nothing, and every metric built on it reads None.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics
import sys

from portbench.trace import gaps, union_length

STRETCH = "portbench.spans"      # the record_function span around the traced stretch
# Replayed steps a train cell's stretch takes, about: whole windows of K.
STEPS = 100
TOP = 8


@dataclasses.dataclass
class Reading:
    spans: list                  # the program's Span records of the stretch run alone
    busy_ms: dict = None         # top-level span name -> [device busy ms of each one's work]
    idle_ms: float = None        # device idle inside the profiled stretch
    window_ms: float = None      # the profiled stretch's length
    idle_by_span: list = None    # [[innermost host span, idle ms]], the most first
    profiled: list = None        # the Span records of the profiled stretch
    captures: dict = None        # graph captures by cause, over the run
    step_busy_ms: float = None   # a train cell's device busy time a replayed step


def read(run, kernels: bool = False) -> Reading | None:
    """The cell's span reading at one level (cached on ``run``), or None
    off the card or with a program that records no spans."""
    if run.device.type != "cuda":
        return None
    if not hasattr(run, "spans_readings"):
        run.spans_readings = {}
    if kernels not in run.spans_readings:
        run.spans_readings[kernels] = _take(run, kernels)
    return run.spans_readings[kernels]


def _take(run, kernels: bool) -> Reading | None:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from mvlpt_torch.utils import profiler

    if not hasattr(profiler, "enable_tracing"):
        return None
    loop = run.loop
    train = run.cell.traffic["kind"] == "train_window"
    windows = max(1, round(STEPS / loop.k)) if train else 0

    def stretch():
        profiler.reset_spans()
        for _ in range(windows):
            loop.run_window()
        if not train:
            loop.stretch()
        torch.cuda.synchronize()
        return profiler.spans()

    profiler.enable_tracing(True, kernels=kernels)
    try:
        if train:
            loop.run_window()    # the instrumented step's capture
        alone = stretch()
        if not kernels:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function(STRETCH):
                    profiled = stretch()
    finally:
        profiler.enable_tracing(False)
        profiler.reset_spans()
    reading = Reading(spans=alone.spans, captures=alone.capture_causes)
    if not kernels:
        reading = dataclasses.replace(reduce(profiled.spans, prof.events()), spans=alone.spans,
                                      profiled=profiled.spans, captures=alone.capture_causes)
        if train:
            reading.step_busy_ms = (sum(reading.busy_ms.get("window.replay", []))
                                    / (windows * loop.k))
    print(f"spans: the stretches with{'' if kernels else 'out'} the kernels' stamps",
          file=sys.stderr)
    report(reading, sys.stderr)
    return reading


def reduce(spans: list, events) -> Reading:
    """The Reading of a span log and the profile's events over the
    STRETCH span: for each top-level span's host range, the device's
    busy time of the work launched inside it (each device operation
    joined to its runtime call by the correlation id, so the kernels of
    the spans inside it, and a graph replay's, count), and the idle gaps
    by the innermost span open on the host."""
    from torch.autograd import DeviceType

    device, launched, host, stretch = [], {}, [], None
    for ev in events:
        a, b = ev.time_range.start, ev.time_range.end
        cuda = ev.device_type == DeviceType.CUDA
        if ev.name == STRETCH and not cuda:
            stretch = (a, b)
        elif getattr(ev, "is_user_annotation", False) or ev.name == STRETCH:
            if not cuda and ev.name.startswith("mvlpt."):
                host.append((a, b, ev.name.removeprefix("mvlpt.")))
        elif cuda:
            device.append((a, b, ev.id))
        elif ev.name.startswith("cu"):        # a CUDA API call: cudaLaunchKernel, a copy
            launched[ev.id] = a
    if stretch is None:
        raise RuntimeError(f"the trace holds no {STRETCH} span")
    lo, hi = stretch
    inside = [(a, b, i) for a, b, i in device if b > lo and a < hi]
    by_launch = sorted((launched[i], a, b) for a, b, i in inside if i in launched)
    starts = [t for t, _, _ in by_launch]
    busy = collections.defaultdict(list)
    for a, b, path in sorted(host):
        if "/" not in path:
            work = by_launch[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]
            busy[path].append(union_length([(x, y) for _, x, y in work], lo, hi) * 1e-3)
    idle = collections.Counter()
    for a, b in gaps([(a, b) for a, b, _ in inside], lo, hi):
        idle[_innermost(host, a)] += (b - a) * 1e-3
    return Reading(spans=spans, busy_ms=dict(busy), idle_ms=sum(idle.values()),
                   window_ms=(hi - lo) * 1e-3,
                   idle_by_span=[[n, ms] for n, ms in idle.most_common(TOP)])


def _innermost(host: list, t: float) -> str:
    best = None
    for a, b, path in host:
        if a <= t < b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, path)
    return best[2] if best else "outside any span"


def per_step(spans: list, names) -> list:
    """The device ms of the spans named in ``names`` (a set, or a
    predicate on the name) under each ``step`` span, a list over steps."""
    keep = names if callable(names) else names.__contains__
    parent = {s.id: s.parent for s in spans}
    step_ids = [s.id for s in spans if s.name == "step"]
    total = dict.fromkeys(step_ids, 0.0)
    for s in spans:
        if s.device_ms is None or not keep(s.name):
            continue
        up = s.parent
        while up is not None and up not in total:
            up = parent.get(up)
        if up is not None:
            total[up] += s.device_ms
    return [total[i] for i in step_ids]


def top_level(spans: list) -> set:
    """The names of the spans directly under a ``step`` span."""
    steps = {s.id for s in spans if s.name == "step"}
    return {s.name for s in spans if s.parent in steps}


def median(values: list) -> float | None:
    return statistics.median(values) if values else None


def host_ms(spans: list, name: str) -> list:
    return [s.host_ms for s in spans if s.name == name and s.host_ms is not None]


def device_ms(spans: list, name: str) -> list:
    return [s.device_ms for s in spans if s.name == name and s.device_ms is not None]


def report(r: Reading, log) -> None:
    """The reading's summary on ``log``: the stretch run alone, and the
    profiled one where there is one."""
    print(f"spans: {len(r.spans)} records, graph captures by cause {r.captures}", file=log)
    for label, log_ in (("alone", r.spans), ("profiled", r.profiled)):
        steps = device_ms(log_ or [], "step")
        if not steps:
            continue
        top = top_level(log_)
        parts = median(per_step(log_, top))
        cover = "" if r.step_busy_ms is None else f", {100 * parts / r.step_busy_ms} %"
        print(f"spans ({label}): step device ms median {median(steps)}, its top-level spans "
              f"{parts}{cover} of the profiled device busy a replayed step "
              f"{r.step_busy_ms} ms", file=log)
        print(f"spans ({label}): ms a step " + ", ".join(
            f"{name} {median(per_step(log_, {name}))}" for name in sorted(top)), file=log)
    for name in ("eval.batch", "eval.read", "window.pre_embed", "window.stage",
                 "window.replay"):
        if host_ms(r.spans, name):
            busy = median((r.busy_ms or {}).get(name, []))
            print(f"spans: {name} host ms median {median(host_ms(r.spans, name))}, device ms "
                  f"median {median(device_ms(r.spans, name))}, profiled device busy ms median "
                  f"{busy}", file=log)
    if r.idle_by_span is not None:
        print(f"spans: idle {r.idle_ms} ms of {r.window_ms} ms profiled, by span "
              f"{r.idle_by_span}", file=log)
