"""Profiling and debug hooks: the counterpart of
``mvlpt_tpu/utils/profiler.py`` (a trace of the device, and fail-fast
NaN checking as the analogue of the dormant TRAIN.DETECT_ANOMALY flag),
and the port's spans.

Spans mark where the program's work happens: the window's edges, the
step's towers and head, the half-block kernels, the eval's batches and
read-back. ``enable_tracing(True)`` turns them on; off (the default),
``span`` returns one shared no-op and records nothing. On, each span
opens a ``torch.profiler.record_function`` range named ``mvlpt.<path>``
(``<path>`` the chain of open spans, e.g.
``window.replay/step/step.text.fwd/block.attn_fwd``) and an NVTX range,
and times itself on the host clock; on the card it also stamps its start
and end on the device (``csrc/stamp.cu``: a one-thread kernel that writes
the GPU's global timer into a slot of a table when the stream reaches
it). Stamps launched while a CUDA graph is captured are nodes of the
graph, so every replay writes them again, into the row that the windowed
step's index on the device picks: ``capturing`` keeps a captured step's
spans with their table, and ``replayed`` logs one sample of them for
each step a window replayed. A stamp in a captured step costs its
replays about 2 us of idle device, as a timing event's record node does;
the half-blocks' spans (``span(..., kernel=True)``) hold most of a
step's, so ``enable_tracing(kernels=False)`` leaves them to the host.
The attention cores' marks are a level of their own, off unless
``enable_tracing(cores=True)``: a device-only span (``core.attn_fwd``,
``core.attn_bwd``) whose two stamps the half-block's launcher writes
right before and after its attention core (``core_marks_args``), so it
holds the core alone, without the half-block's LayerNorm and products.
``spans()`` returns the log with the device times read (after a
synchronize) and the counters the program already keeps:
``ops._build.LAUNCHES`` and the windowed steps' captures (by cause) and
replays. Spans are kept in memory until ``reset_spans()``;
``trace(logdir)`` writes them into its Chrome trace.

Spans nest on one stack. Open them from the thread that runs the step:
the backward's spans, opened by autograd hooks (``backward_span``), run
on autograd's worker thread while that thread waits in the backward.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import time
import weakref

import torch

_NAN_DEBUGGING = False


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the host and the card (CPU and
    CUDA activities) into ``logdir`` as a Chrome trace, viewable in
    Perfetto or TensorBoard. Tracing is on while it runs, so the
    program's spans (``mvlpt.*``) lie beside the kernels they launched."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = tracing()
    enable_tracing(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        enable_tracing(was)
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


# ------------------------------------------------------------------ spans

_TRACING = False
_KERNELS = False               # whether the kernels' spans stamp the device too
_CORES = False                 # whether the attention launchers stamp their cores
_CUDA = False                  # whether spans stamp the device (a card is present)
_LOG: list = []                # closed spans (Span) and replayed samples (_Samples), in order
_UNREAD: list = []             # logged entries whose stamps are not read yet
_OPEN: list = []               # the open spans (_Open), innermost last
_CAPTURE: list = []            # [depth, [captured spans], _Stamps] during a capture, else empty
_IDS = itertools.count()       # span ids, in the order spans open
_WATCHED = weakref.WeakSet()   # objects whose captures and replays the snapshot reads


@dataclasses.dataclass
class Span:
    """One closed span. ``host_ms`` is None for a replayed sample (no host
    code ran); ``device_ms`` (its duration on the device) and
    ``device_start_ms`` (its start, on the device's global timer, after
    tracing was first turned on) are None off the card and for a span
    that was captured into a graph (its replays log the device samples)."""

    path: str
    id: int
    parent: int | None
    host_ms: float | None
    device_ms: float | None = None
    device_start_ms: float | None = None
    marks: tuple | None = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def name(self) -> str:
        return self.path.rpartition("/")[2]


@dataclasses.dataclass
class Snapshot:
    """What ``spans()`` returns: the closed spans, and the counters of
    launches (``ops._build.LAUNCHES``), graph captures by cause and graph
    replays, summed over the live windowed steps."""

    spans: list
    launches: dict
    captures: int
    capture_causes: dict
    replays: int


class _Stamps:
    """Tables of device stamps: (rows, WIDTH) int64, the row picked on the
    device by ``row`` (a (1,) int64 tensor) or 0, filled WIDTH slots a
    table, one after another. The first table is made with the object,
    before a capture that it serves begins; a later one, if a capture
    needs it, comes from the graph's pool (``empty`` launches nothing)."""

    WIDTH = 1024

    def __init__(self, rows: int = 1, row=None):
        from mvlpt_torch.ops import _build

        self.rows, self.row_ptr = rows, 0 if row is None else row.data_ptr()
        self.device = torch.cuda.current_device()
        self.launch = _build.library("stamp").mvlpt_stamp
        self.tables: list = []
        self.used = self.WIDTH
        self._table()

    def _table(self) -> None:
        self.tables.append(torch.empty((self.rows, self.WIDTH), dtype=torch.int64,
                                       device=self.device))
        self.used = 0

    def reserve(self, n: int = 1) -> tuple:
        """``n`` consecutive slots of one table; returns (table, first
        column)."""
        if self.used + n > self.WIDTH:
            self._table()
        table, col = self.tables[-1], self.used
        self.used += n
        return table, col

    def stamp(self) -> tuple:
        """Stamp the current stream; returns the slot (table, column)."""
        table, col = self.reserve()
        rc = self.launch(table.data_ptr(), self.row_ptr, self.WIDTH, col,
                         torch._C._cuda_getCurrentRawStream(self.device))
        if rc:
            raise RuntimeError(f"the span stamp kernel failed: CUDA error {rc}")
        return table, col


_EAGER: list = []              # [_Stamps] of the spans outside a capture, once on the card
_ORIGIN: list = []             # [(table, col)]: the stamp that device_start_ms counts from


@dataclasses.dataclass(eq=False)
class _Open:
    path: str
    id: int
    parent: int | None
    t0: float
    record: object             # the record_function range
    nvtx: bool                 # whether an NVTX range was pushed
    start: tuple | None        # the start's stamp slot, or None


class _Noop:
    """What ``span`` returns with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "device", "open")

    def __init__(self, name: str, device: bool):
        self.name, self.device, self.open = name, device, None

    def __enter__(self):
        self.open = open_span(self.name, self.device)
        return self

    def __exit__(self, *exc):
        close_span(self.open)
        return False


def enable_tracing(on: bool = True, kernels: bool = True, cores: bool = False) -> None:
    """Turn the spans on or off. Off, ``span`` costs a read of this flag.
    ``kernels=False``: the kernels' spans (``span(..., kernel=True)``, the
    half-blocks) keep their host time only. Each stamp in a captured step
    costs its replays about 2 us of idle device, and the half-blocks take
    most of a step's stamps (at ViT-B/16, about 190 of 210): without
    them a step's spans cost it under 1%. ``cores=True`` adds the
    attention cores' marks (``core_marks_args``), two stamps a core."""
    global _TRACING, _KERNELS, _CORES, _CUDA
    _TRACING, _KERNELS, _CORES = bool(on), bool(on and kernels), bool(on and cores)
    _CUDA = _TRACING and torch.cuda.is_available()
    if _CUDA and not _EAGER:
        _EAGER.append(_Stamps())
        _ORIGIN.append(_EAGER[0].stamp())


def tracing() -> bool:
    """Whether ``enable_tracing`` is on."""
    return _TRACING


def kernel_marks() -> bool:
    """Whether the kernels' spans stamp the device (``enable_tracing``)."""
    return _KERNELS


def core_marks() -> bool:
    """Whether the attention cores' marks are on (``enable_tracing``)."""
    return _CORES


# A launcher's marks arguments when there are none: a null table.
NO_MARKS = (None, None, 0, 0)


def core_marks_args(name: str) -> tuple:
    """The marks of span ``name`` around one attention core, as the
    launcher's C arguments (table, row, width, first column: its start's
    slot, the end's the next): ``NO_MARKS`` unless ``core_marks()`` on the
    card. The span is a child of the innermost open span, with no host
    time; in a capture, of the innermost one that stamps the device, so
    that its replayed samples keep their step."""
    if not (_CORES and _CUDA):
        return NO_MARKS
    from mvlpt_torch.ops import _build

    parent = _OPEN[-1] if _OPEN else None
    path = f"{parent.path}/{name}" if parent else name
    stamps = _CAPTURE[2] if _CAPTURE else _EAGER[0]
    table, col = stamps.reserve(2)
    marks = ((table, col), (table, col + 1))
    if _CAPTURE:
        depth, captured, _ = _CAPTURE
        up = next((o for o in reversed(_OPEN[depth:]) if o.start is not None), None)
        captured.append((path.split("/", depth)[-1], next(_IDS), up.id if up else None, marks))
    else:
        s = Span(path, next(_IDS), parent.id if parent else None, None, marks=(marks, 0))
        _LOG.append(s)
        _UNREAD.append(s)
    _build.LAUNCHES["core_marks"] += 1
    return table.data_ptr(), stamps.row_ptr or None, stamps.WIDTH, col


def span(name: str, device: bool = True, kernel: bool = False):
    """A context manager that records span ``name`` (with tracing on;
    else the shared no-op). ``device=False``: host time only (a span of
    host work, which launches nothing). ``kernel=True``: a kernel's span,
    stamped on the device only when ``kernel_marks()``."""
    if not _TRACING:
        return _NOOP
    return _Span(name, device and (_KERNELS or not kernel))


def _stamp() -> tuple:
    return (_CAPTURE[2] if _CAPTURE else _EAGER[0]).stamp()


def open_span(name: str, device: bool = True) -> _Open:
    """Open span ``name`` inside the innermost open one; close it with
    ``close_span`` (``span`` does both)."""
    parent = _OPEN[-1] if _OPEN else None
    path = f"{parent.path}/{name}" if parent else name
    record = torch.profiler.record_function(f"mvlpt.{path}")
    record.__enter__()
    if _CUDA:
        torch.cuda.nvtx.range_push(path)
    o = _Open(path, next(_IDS), parent.id if parent else None, time.perf_counter(), record,
              _CUDA, _stamp() if _CUDA and device else None)
    _OPEN.append(o)
    return o


def close_span(o: _Open) -> None:
    """Close ``o`` and, first, every span opened inside it that is still
    open. A span closed already is left as it is."""
    if o not in _OPEN:
        return
    while _OPEN[-1] is not o:
        close_span(_OPEN[-1])
    _OPEN.pop()
    marks = None if o.start is None else (o.start, _stamp())
    host_ms = 1e3 * (time.perf_counter() - o.t0)
    if o.nvtx:
        torch.cuda.nvtx.range_pop()
    o.record.__exit__(None, None, None)
    if _CAPTURE and marks is not None:
        depth, captured, _ = _CAPTURE
        captured.append((o.path.split("/", depth)[-1], o.id, o.parent, marks))
        marks = None
    s = Span(o.path, o.id, o.parent, host_ms, marks=None if marks is None else (marks, 0))
    _LOG.append(s)
    if marks is not None:
        _UNREAD.append(s)


def backward_span(name: str, outputs, inputs) -> None:
    """Span ``name`` over a stretch of the backward: it opens when every
    one of ``outputs`` has its gradient and closes when every one of
    ``inputs`` has its gradient (autograd hooks on the tensors that
    require grad; a tensor's hooks run in the order they were
    registered). Nothing with tracing off, or when no gradient flows
    from the outputs to the inputs."""
    if not _TRACING:
        return
    outputs = [t for t in outputs if t is not None and t.requires_grad]
    inputs = [t for t in inputs if t is not None and t.requires_grad]
    if not outputs or not inputs:
        return
    state = {"open": None, "outputs": len(outputs), "inputs": len(inputs)}

    def opened(grad):
        state["outputs"] -= 1
        if not state["outputs"]:
            state["open"] = open_span(name)

    def arrived(grad):
        state["inputs"] -= 1
        if not state["inputs"] and state["open"] is not None:
            close_span(state["open"])

    for t in outputs:
        t.register_hook(opened)
    for t in inputs:
        t.register_hook(arrived)


@contextlib.contextmanager
def capturing(row=None, rows: int = 1):
    """Keep the spans closed inside (a CUDA graph's capture), with their
    paths below the innermost open span, in the list it yields, for
    ``replayed``; their stamps go to a table of ``rows`` rows whose row
    ``row`` (a (1,) int64 tensor on the device, read at each replay)
    picks. The log keeps their host times."""
    global _CAPTURE
    captured: list = []
    saved, _CAPTURE = _CAPTURE, [len(_OPEN), captured, _Stamps(rows, row) if _CUDA else None]
    try:
        yield captured
    finally:
        _CAPTURE = saved


class _Samples:
    """The samples of a captured step's spans that a window's replays
    wrote, one a replayed step (row), inside the span open then: kept as
    the stamp tables' rows until ``spans()`` makes them Span records, so
    a window costs the host one entry and one copy of its table."""

    def __init__(self, captured: list, rows, parent):
        self.captured, self.rows = captured, list(rows)
        self.path = parent.path + "/" if parent else ""
        self.parent = parent.id if parent else None
        self.ids = [[next(_IDS) for _ in captured] for _ in self.rows]
        self.ns = None           # id(table) -> its rows' stamps, once read

    def read(self, read) -> None:
        self.ns = {id(t): read(t)[self.rows] for *_, marks in self.captured
                   for t, _ in marks}

    def records(self, origin: int) -> list:
        index = {old: i for i, (_, old, _, _) in enumerate(self.captured)}
        out = []
        for r, ids in enumerate(self.ids):
            for i, (rel, _, old_parent, ((t0, c0), (t1, c1))) in enumerate(self.captured):
                span = Span(self.path + rel, ids[i],
                            ids[index[old_parent]] if old_parent in index else self.parent, None)
                if self.ns is not None:
                    start = int(self.ns[id(t0)][r, c0])
                    span.device_ms = (int(self.ns[id(t1)][r, c1]) - start) * 1e-6
                    span.device_start_ms = (start - origin) * 1e-6
                out.append(span)
        return out


def replayed(captured: list, rows) -> None:
    """Log a sample of the captured spans (``capturing``) for each of
    ``rows``, the rows of the steps the graph's replays just wrote,
    inside the innermost open span. Read them (``collect``) before the
    graph writes those rows again."""
    if captured and rows:
        samples = _Samples(captured, rows, _OPEN[-1] if _OPEN else None)
        _LOG.append(samples)
        _UNREAD.append(samples)


_ORIGIN_NS: list = []          # the origin stamp's value, once read


def collect() -> None:
    """Read the stamps of the logged spans not read yet (a synchronize
    first): a replayed graph's samples must be read before it replays
    again."""
    if not _UNREAD:
        return
    torch.cuda.synchronize()
    host: dict = {}

    def read(table):
        if id(table) not in host:
            host[id(table)] = table.cpu().numpy()
        return host[id(table)]

    if not _ORIGIN_NS:
        table, col = _ORIGIN[0]
        _ORIGIN_NS.append(int(read(table)[0, col]))
    for s in _UNREAD:
        if isinstance(s, _Samples):
            s.read(read)
            continue
        ((t0, c0), (t1, c1)), row = s.marks
        start = int(read(t0)[row, c0])
        s.device_ms = (int(read(t1)[row, c1]) - start) * 1e-6
        s.device_start_ms = (start - _ORIGIN_NS[0]) * 1e-6
        s.marks = None
    _UNREAD.clear()


def watch(counted) -> None:
    """Report ``counted``'s ``captures``, ``capture_causes`` and
    ``replays`` in every snapshot while it lives (a windowed step)."""
    _WATCHED.add(counted)


def spans() -> Snapshot:
    """The log's spans, their device times read (``collect``), with the
    launch and graph counters."""
    from mvlpt_torch.ops import _build

    collect()
    causes = collections.Counter()
    for w in _WATCHED:
        causes.update(w.capture_causes)
    records = []
    for s in _LOG:
        if isinstance(s, _Samples):
            records += s.records(_ORIGIN_NS[0] if _ORIGIN_NS else 0)
        else:
            records.append(dataclasses.replace(s))
    return Snapshot(spans=records, launches=dict(_build.LAUNCHES),
                    captures=sum(causes.values()), capture_causes=dict(causes),
                    replays=sum(w.replays for w in _WATCHED))


def reset_spans() -> None:
    """Empty the log (open spans stay open)."""
    _LOG.clear()
    _UNREAD.clear()
    for stamps in _EAGER:
        stamps.tables[:-1] = []     # the slots of open spans keep their tables alive
