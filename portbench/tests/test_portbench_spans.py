"""The span reader (``spans.py``) on synthetic span logs and profiler
events, and the metrics built on it off the card."""

import io
import types

import pytest
from conftest import EVAL, TRAIN

from portbench import bench, spans

NEW = ("text_tower_step_ms.train", "image_tower_step_ms.train", "halfblock_step_ms.train",
       "window_prep_ms.train", "eval_dispatch_ms.eval", "eval_device_ms.eval",
       "eval_read_wait_ms.eval")


def _span(path, id, parent, host_ms=None, device_ms=None):
    from mvlpt_torch.utils.profiler import Span

    return Span(path, id, parent, host_ms, device_ms)


def _replayed_window(first_id, scale):
    """One window's sample of a captured step: its spans under
    window.replay, device ms times ``scale``."""
    i = first_id
    out = [_span("window.pre_embed", i, None, 1.0, 2.0 * scale),
           _span("window.stage", i + 1, None, 0.1, 0.5 * scale)]
    r, st, bwd, tb = i + 2, i + 3, i + 4, i + 5
    root = "window.replay/step"
    out += [
        _span(f"{root}/step.text.fwd/block.attn_fwd", i + 6, i + 7, None, 1.0 * scale),
        _span(f"{root}/step.text.fwd", i + 7, st, None, 3.0 * scale),
        _span(f"{root}/step.image.fwd/block.mlp_fwd", i + 8, i + 9, None, 4.0 * scale),
        _span(f"{root}/step.image.fwd", i + 9, st, None, 5.0 * scale),
        _span(f"{root}/step.bwd/step.text.bwd/block.attn_bwd", i + 10, tb, None, 2.0 * scale),
        _span(f"{root}/step.bwd/step.text.bwd", tb, bwd, None, 6.0 * scale),
        _span(f"{root}/step.bwd/step.image.bwd", i + 11, bwd, None, 7.0 * scale),
        _span(f"{root}/step.bwd", bwd, st, None, 14.0 * scale),
        _span(f"{root}/step.optim", i + 12, st, None, 1.0 * scale),
        _span(root, st, r, None, 23.5 * scale),
        _span("window.replay", r, None, 0.2, None),
    ]
    return out


def test_per_step_sums_and_medians():
    log = (_replayed_window(0, 1.0) + _replayed_window(100, 2.0)
           + _replayed_window(200, 4.0))
    text = spans.per_step(log, {"step.text.fwd", "step.text.bwd"})
    assert text == [9.0, 18.0, 36.0] and spans.median(text) == 18.0
    blocks = spans.per_step(log, lambda name: name.startswith("block."))
    assert blocks == [7.0, 14.0, 28.0]
    assert spans.top_level(log) == {"step.text.fwd", "step.image.fwd", "step.bwd",
                                    "step.optim"}
    assert spans.median(spans.per_step(log, spans.top_level(log))) == 46.0
    assert spans.device_ms(log, "window.stage") == [0.5, 1.0, 2.0]
    assert spans.host_ms(log, "window.replay") == [0.2] * 3
    assert spans.median([]) is None
    out = io.StringIO()
    spans.report(spans.Reading(spans=log, busy_ms={"window.replay": [2300.0]}, idle_ms=1.0,
                               window_ms=2400.0, idle_by_span=[["window.replay", 1.0]],
                               profiled=log, captures={"tracing": 1}, step_busy_ms=46.0), out)
    assert "top-level spans 46.0, 100.0 %" in out.getvalue()


def _ev(name, a, b, cuda, annotation=False, id=0):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=a, end=b),
                                 device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
                                 is_user_annotation=annotation, id=id)


def test_reduce_busy_by_launch_and_idle_by_span():
    """Times in microseconds, as the profiler's events give them. Device
    work counts for the top-level span whose host range launched it
    (through the runtime call of the same correlation id), whatever
    span inside it launched it."""
    events = [
        _ev(spans.STRETCH, 0, 1000, cuda=False, annotation=True),
        _ev("mvlpt.eval.batch", 0, 300, cuda=False, annotation=True),
        _ev("mvlpt.eval.batch/eval.image", 10, 250, cuda=False, annotation=True),
        _ev("mvlpt.eval.read", 300, 900, cuda=False, annotation=True),
        _ev("mvlpt.eval.batch/eval.image", 100, 700, cuda=True, annotation=True),
        _ev("cudaLaunchKernel", 5, 6, cuda=False, id=1),
        _ev("cudaLaunchKernel", 20, 21, cuda=False, id=2),
        _ev("cudaLaunchKernel", 240, 241, cuda=False, id=3),
        _ev("cudaMemcpyAsync", 310, 311, cuda=False, id=4),
        _ev("kernel", 100, 200, cuda=True, id=1),
        _ev("kernel", 150, 400, cuda=True, id=2),      # overlaps the first: the union counts
        _ev("kernel", 500, 700, cuda=True, id=3),
        _ev("memcpy", 950, 1000, cuda=True, id=4),
    ]
    r = spans.reduce([], events)
    assert r.busy_ms == {"eval.batch": [pytest.approx(0.5)], "eval.read": [pytest.approx(0.05)]}
    assert r.window_ms == pytest.approx(1.0)
    # Idle: [0, 100) begins under eval.batch (eval.image opens at 10),
    # [400, 500) and [700, 950) under eval.read.
    assert r.idle_ms == pytest.approx(0.45)
    assert dict((n, pytest.approx(ms)) for n, ms in r.idle_by_span) == {
        "eval.batch": 0.1, "eval.read": 0.35}


def test_reduce_needs_the_stretch():
    with pytest.raises(RuntimeError):
        spans.reduce([], [])


@pytest.mark.parametrize("traffic", [TRAIN, EVAL])
def test_new_readers_read_nothing_off_the_card(traffic):
    """Off the card, and in a cell of the other kind, each new reader
    returns None (and runs no stretch)."""
    cell = types.SimpleNamespace(traffic=traffic)
    run = types.SimpleNamespace(cell=cell, device=types.SimpleNamespace(type="cpu"))
    for name in NEW:
        assert bench.reader(name)(run) is None
    assert spans.read(run) is None and not hasattr(run, "spans_readings")


def test_new_readers_skip_the_other_kind():
    """On the card a reader of the other kind's cell returns None before
    it would trace."""
    for traffic, names in ((TRAIN, [n for n in NEW if n.endswith(".eval")]),
                           (EVAL, [n for n in NEW if n.endswith(".train")])):
        run = types.SimpleNamespace(cell=types.SimpleNamespace(traffic=traffic),
                                    device=types.SimpleNamespace(type="cuda"))
        for name in names:
            assert bench.reader(name)(run) is None
        assert not hasattr(run, "spans_readings")


def test_a_cached_reading_is_shared():
    run = types.SimpleNamespace(cell=types.SimpleNamespace(traffic=EVAL),
                                device=types.SimpleNamespace(type="cuda"))
    log = [_span("eval.batch", 1, None, 12.0, 13.0), _span("eval.read", 2, None, 0.5, 0.0),
           _span("eval.batch", 3, None, 14.0, 15.0), _span("eval.read", 4, None, 1.5, 0.0)]
    run.spans_readings = {False: spans.Reading(spans=log, busy_ms={"eval.batch": [10.0, 11.0]},
                                               idle_ms=0.0, window_ms=1.0, idle_by_span=[])}
    assert bench.reader("eval_dispatch_ms.eval")(run) == 13.0
    assert bench.reader("eval_device_ms.eval")(run) == 10.5
    assert bench.reader("eval_read_wait_ms.eval")(run) == 1.0
