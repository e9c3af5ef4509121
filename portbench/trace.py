"""A torch.profiler trace of a steady stretch of the cell, reduced to the
device's busy time, the stretch's length, the device operations that
took most time and the longest idle gaps by what the host was doing.

Busy time is the union of the device's activity intervals (kernels,
copies, sets), not their sum: a copy on a side stream that overlaps a
kernel counts once.
"""

from __future__ import annotations

import collections
import dataclasses

STRETCH = "portbench.stretch"   # the record_function span around the traced stretch
TOP = 10


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    device_ops: list            # [[name, seconds]] the most time first
    idle_gaps: list             # [[host span, seconds]] the most time first
    kernels: int                # device operations recorded


def union_length(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """The length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def _host_at(spans: list[tuple[float, float, str]], t: float) -> str:
    """The innermost host span open at time t (the shortest that holds t)."""
    best = None
    for a, b, name in spans:
        if a <= t < b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "host idle"


def reduce(events) -> Trace:
    """The Trace of a profile's events (``prof.events()``), over the
    STRETCH span the benchmark opened."""
    from torch.autograd import DeviceType

    device, host, stretch = [], [], None
    for ev in events:
        a, b = ev.time_range.start, ev.time_range.end
        if ev.name == STRETCH and ev.device_type != DeviceType.CUDA:
            stretch = (a, b)
        elif getattr(ev, "is_user_annotation", False) or ev.name == STRETCH:
            # A span's copy on the device's timeline marks a range; it is
            # not work.
            continue
        elif ev.device_type == DeviceType.CUDA:
            device.append((a, b, ev.name))
        else:
            host.append((a, b, ev.name))
    if stretch is None:
        raise RuntimeError(f"the trace holds no {STRETCH} span")
    lo, hi = stretch
    inside = [(a, b) for a, b, _ in device if b > lo and a < hi]
    by_name = collections.Counter()
    for a, b, name in device:
        if b > lo and a < hi:
            by_name[name] += (min(b, hi) - max(a, lo)) * 1e-6
    idle = collections.Counter()
    for a, b in gaps(inside, lo, hi):
        idle[_host_at(host, a)] += (b - a) * 1e-6
    return Trace(busy_s=union_length(inside, lo, hi) * 1e-6, window_s=(hi - lo) * 1e-6,
                 device_ops=[[n, s] for n, s in by_name.most_common(TOP)],
                 idle_gaps=[[n, s] for n, s in idle.most_common(TOP)],
                 kernels=len(inside))


def traced(fn) -> Trace:
    """fn() run under torch.profiler inside a STRETCH span that starts
    and ends with the device idle, reduced to a Trace. (The profiler warns
    that it keeps one cycle's events: there is one.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            fn()
            torch.cuda.synchronize()
    return reduce(prof.events())
