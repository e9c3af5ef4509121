"""The port's spans (``mvlpt_torch.utils.profiler``): what a windowed
train step and a cached-text eval pass record with tracing on, that they
record nothing and change no number with tracing off, and, on the card,
that a captured step's spans survive its replays.

The model is ``tiny_flagship`` (UPT: CoOp, deep VPT, the coupler; two
layers a tower) on the fused half-block path, whose plain twins run on
the CPU. This file imports no JAX: its ``card`` test runs on the card.
"""

import collections

import pytest
import torch

from mvlpt_torch.utils import profiler

N_CLS, BATCH, K = 8, 3, 2
LAYERS = 2          # tiny_flagship's layers a tower
STEP_SPANS = ("step.coupler.fwd", "step.image.fwd", "step.text.fwd", "step.head", "step.loss",
              "step.bwd", "step.optim")


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    """A generated merges file in place of the real CLIP vocab."""
    from mvlpt_torch.tokenizer import bpe as tbpe

    path = str(tmp_path_factory.mktemp("vocab") / "synthetic_bpe_vocab.txt.gz")
    tbpe.write_synthetic_vocab(path, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbpe, "_DEFAULT", tbpe.ClipBpeTokenizer(path))
        yield path


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and an empty log."""
    profiler.enable_tracing(False)
    profiler.reset_spans()
    yield
    profiler.enable_tracing(False)
    profiler.reset_spans()


def _model(vocab, device="cpu", remat=False, dtype=torch.float32):
    from mvlpt_torch.flagship import tiny_flagship

    model, backbone, params, consts, _ = tiny_flagship(N_CLS, compute_dtype=dtype,
                                                       kernels="block", device=device)
    model.remat = remat
    return model, backbone, params, consts


def _state(params):
    from mvlpt_torch.config import get_cfg_default
    from mvlpt_torch.train.train_step import init_train_state

    ocfg = get_cfg_default().OPTIM
    ocfg.LR, ocfg.MAX_EPOCH = 0.05, 4
    return init_train_state(params, ocfg, steps_per_epoch=K)


def _window(device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"image": torch.randn(K, BATCH, 32, 32, 3, generator=gen).to(device),
            "label": torch.randint(0, N_CLS, (K, BATCH), generator=gen).to(device)}


def _train_window(vocab, remat=False):
    from mvlpt_torch.train.train_step import make_train_step_multi

    model, backbone, params, consts = _model(vocab, remat=remat)
    state = _state(params)
    _, out = make_train_step_multi(model)(state, backbone, consts, _window())
    return state, out


def _eval_pass(vocab, batches=3):
    from mvlpt_torch.train.train_step import make_cached_text_eval
    from mvlpt_torch.utils.pipeline import pipelined_inference

    model, backbone, params, consts = _model(vocab)
    text_fn, eval_fn = make_cached_text_eval(model)
    text = text_fn(backbone, params, consts)
    images = _window()["image"][0]
    loader = ({"image": images} for _ in range(batches))
    return [logits for logits, _ in
            pipelined_inference(loader, lambda b: eval_fn(backbone, params, text, b))]


def _under(spans, name):
    """{id of each span named ``name``: the names of the spans inside it}."""
    parent = {s.id: s.parent for s in spans}
    out = {s.id: collections.Counter() for s in spans if s.name == name}
    for s in spans:
        up = s.parent
        while up is not None and up not in out:
            up = parent.get(up)
        if up is not None:
            out[up][s.name] += 1
    return out


def test_off_records_nothing(vocab):
    assert not profiler.tracing()
    assert profiler.span("step") is profiler.span("eval.batch")
    with profiler.span("step") as s:
        assert s is profiler.span("step")
    _train_window(vocab)
    _eval_pass(vocab)
    assert profiler.spans().spans == []


@pytest.mark.parametrize("remat, kernels", [(False, True), (True, True), (True, False)])
def test_window_spans(vocab, remat, kernels):
    """K of each step span a window; a block span a layer and half-block
    on each tower, remat's forwards twice (inside the backward); the
    towers' backwards inside the step's, apart and in autograd's order.
    Without the kernels' stamps the kernels' spans keep their host time."""
    profiler.enable_tracing(True, kernels=kernels)
    assert profiler.tracing() and profiler.kernel_marks() == kernels
    _train_window(vocab, remat=remat)
    spans = profiler.spans().spans
    names = collections.Counter(s.name for s in spans)
    assert names["window.pre_embed"] == 1 and names["step"] == K
    for name in STEP_SPANS + ("step.text.bwd", "step.image.bwd", "step.coupler.bwd"):
        assert names[name] == K, name
    steps = {s.id for s in spans if s.name == "step"}
    assert {s.name for s in spans if s.parent in steps} == set(STEP_SPANS)
    fwd = 2 if remat else 1
    for tower in ("image", "text"):
        inside_fwd = _under(spans, f"step.{tower}.fwd")
        inside_bwd = _under(spans, f"step.{tower}.bwd")
        for counts in inside_fwd.values():
            assert counts == {"block.attn_fwd": LAYERS, "block.mlp_fwd": LAYERS}
        for counts in inside_bwd.values():
            assert counts == {"block.attn_bwd": LAYERS, "block.mlp_bwd": LAYERS,
                              **({"block.attn_fwd": LAYERS, "block.mlp_fwd": LAYERS}
                                 if fwd == 2 else {})}
    for counts in _under(spans, "step.bwd").values():
        assert counts["step.text.bwd"] == counts["step.image.bwd"] == 1
        assert counts["step.coupler.bwd"] == 1
    # Autograd runs the later forward's backward first: the text tower's,
    # then the image tower's, then the coupler's; each closes before the
    # next opens (ids count opens, the log's order closes).
    order = [s.name for s in spans if s.name.endswith(".bwd") and s.name != "step.bwd"]
    assert order == ["step.text.bwd", "step.image.bwd", "step.coupler.bwd"] * K
    by_id = {s.id: s for s in spans}
    for sid in steps:
        kids = sorted((s for s in spans if s.parent is not None
                       and by_id[s.parent].name == "step.bwd"
                       and by_id[s.parent].parent == sid), key=lambda s: s.id)
        closes = [spans.index(s) for s in kids]
        assert closes == sorted(closes)


def test_eval_spans(vocab):
    profiler.enable_tracing(True)
    _eval_pass(vocab, batches=3)
    spans = profiler.spans().spans
    names = collections.Counter(s.name for s in spans if "/" not in s.path)
    assert names["eval.batch"] == 3 and names["eval.read"] == 3
    for counts in _under(spans, "eval.batch").values():
        assert counts == {"eval.coupler": 1, "eval.image": 1, "eval.head": 1,
                          "block.attn_infer": LAYERS, "block.mlp_infer": LAYERS}


def test_child_host_time_within_parent(vocab):
    profiler.enable_tracing(True)
    _train_window(vocab, remat=True)
    _eval_pass(vocab)
    spans = profiler.spans().spans
    by_id = {s.id: s for s in spans}
    assert all(s.host_ms >= 0 and s.device_ms is None for s in spans)
    for s in spans:
        if s.parent is not None:
            assert s.host_ms <= by_id[s.parent].host_ms, (s.path, by_id[s.parent].path)
            assert s.path.startswith(by_id[s.parent].path + "/")


def test_tracing_changes_no_number(vocab):
    """Losses, gradient norms, leaves and momentum are bit for bit the same
    with tracing on and off."""
    from mvlpt_torch.utils.tree import tree_leaves

    runs = []
    for on in (False, True):
        profiler.enable_tracing(on)
        state, out = _train_window(vocab, remat=True)
        runs.append((out, tree_leaves(state.prompt_params), state.opt.slots["momentum"]))
    (out0, leaves0, mom0), (out1, leaves1, mom1) = runs
    for name in out0:
        assert torch.equal(out0[name], out1[name]), name
    for a, b in zip(leaves0 + list(mom0), leaves1 + list(mom1)):
        assert torch.equal(a, b)


def test_snapshot_counters():
    """The snapshot reads the launch counters and the live windowed steps'
    capture and replay counts where they are kept."""
    from mvlpt_torch.ops import _build
    from mvlpt_torch.train.train_step import CAPTURE_CAUSES, WindowStep

    step = WindowStep(None, None, False, None, capture=True)
    step.capture_causes.update({"shape": 1, "tracing": 2})
    step.replays = 7
    snap = profiler.spans()
    assert snap.launches == _build.LAUNCHES
    assert step.captures == 3 and set(step.capture_causes) <= set(CAPTURE_CAUSES)
    assert snap.captures >= 3 and snap.replays >= 7
    assert snap.capture_causes["tracing"] >= 2


class _CpuStamps:
    """``profiler._Stamps`` on the CPU: each stamp writes the next tick of
    a counter (1 ms in ns) into its slot, at the row that ``row`` holds."""

    WIDTH = 4
    clock = 0
    row_ptr = 0

    def __init__(self, rows=1, row=None):
        self.rows, self.row, self.tables, self.used = rows, row, [], self.WIDTH

    def reserve(self, n=1):
        if self.used + n > self.WIDTH:
            self.tables.append(torch.zeros((self.rows, self.WIDTH), dtype=torch.int64))
            self.used = 0
        table, col = self.tables[-1], self.used
        self.used += n
        return table, col

    def stamp(self):
        _CpuStamps.clock += 1_000_000
        table, col = self.reserve()
        table[0 if self.row is None else int(self.row[0]), col] = _CpuStamps.clock
        return table, col


def _cpu_card(monkeypatch):
    """The profiler's card on the CPU: ``_CpuStamps`` for the stamp
    tables, no synchronize and no NVTX."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "nvtx", type("nvtx", (), {
        "range_push": staticmethod(lambda name: None),
        "range_pop": staticmethod(lambda: None)}))
    monkeypatch.setattr(profiler, "_Stamps", _CpuStamps)
    monkeypatch.setattr(profiler, "_EAGER", [])
    monkeypatch.setattr(profiler, "_ORIGIN", [])
    monkeypatch.setattr(profiler, "_ORIGIN_NS", [])


def test_captured_spans_log_a_sample_each_replayed_step(monkeypatch):
    """A captured step's spans keep their stamps' slots with the graph;
    ``replayed`` logs a sample of them for each row (step) replayed,
    under the span open then and with ids of its own, and ``collect``
    reads each sample's row. (The stamps and the step index run on the
    CPU here, with a counter for the device's timer.)"""
    _cpu_card(monkeypatch)
    profiler.enable_tracing(True)
    index = torch.zeros(1, dtype=torch.int64)
    with profiler.span("window.capture"):
        with profiler.capturing(index, rows=3) as captured:
            with profiler.span("step"):
                with profiler.span("step.text.fwd"):
                    pass
    assert [rel for rel, *_ in captured] == ["step/step.text.fwd", "step"]
    # The graph's replays: each step writes the captured slots at its row,
    # the text tower's taking 1 ms, then 2 ms, then 3 ms.
    (start, end), (step_start, step_end) = [marks for *_, marks in captured]
    for row in range(3):
        for (table, col), ms in ((step_start, 0), (start, 1), (end, 2 + row), (step_end, 5)):
            table[row, col] = 100_000_000 * (row + 1) + 1_000_000 * ms
    with profiler.span("window.replay"):
        profiler.replayed(captured, range(1, 3))
    spans = profiler.spans().spans
    host = [s for s in spans if s.host_ms is not None]
    samples = [s for s in spans if s.host_ms is None]
    assert all(s.device_ms is None for s in host if s.path.startswith("window.capture/"))
    assert [s.path for s in samples] == ["window.replay/step/step.text.fwd",
                                         "window.replay/step"] * 2
    assert [s.device_ms for s in samples] == [2.0, 5.0, 3.0, 5.0]
    by_id = {s.id: s for s in spans}
    for s in samples:
        assert by_id[s.parent].path == s.path.rpartition("/")[0]
    assert len({s.id for s in samples}) == 4
    text = [s for s in samples if s.name == "step.text.fwd"]
    steps = [s for s in samples if s.name == "step"]
    assert [t.device_start_ms - st.device_start_ms for t, st in zip(text, steps)] == [1.0, 1.0]


def test_core_marks_are_a_level_of_their_own():
    """The attention cores' marks are off by default, with tracing off,
    and at every level but their own; off, or without a card, the
    launcher gets no slot and nothing is logged."""
    from mvlpt_torch.ops import _build

    before = _build.LAUNCHES["core_marks"]
    for on, kernels, cores in ((True, True, False), (True, False, False), (False, True, True)):
        profiler.enable_tracing(on, kernels=kernels, cores=cores)
        assert not profiler.core_marks()
        assert profiler.core_marks_args("core.attn_fwd") == profiler.NO_MARKS
    profiler.enable_tracing(True, kernels=False, cores=True)
    assert profiler.core_marks() and not profiler.kernel_marks()
    if not torch.cuda.is_available():
        assert profiler.core_marks_args("core.attn_bwd") == profiler.NO_MARKS
    profiler.enable_tracing(False)
    assert profiler.spans().spans == []
    assert _build.LAUNCHES["core_marks"] == before


def test_core_marks_keep_their_step_in_a_capture(monkeypatch):
    """A core's marks are two consecutive slots that the launcher
    stamps; captured, their span's samples lie under the step's sample
    (the half-block's span, host-only at this level, is no sample), and
    outside a capture the span is read at row 0. Each marked launch is
    counted."""
    from mvlpt_torch.ops import _build

    _cpu_card(monkeypatch)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    profiler.enable_tracing(True, kernels=False, cores=True)
    index = torch.zeros(1, dtype=torch.int64)
    with profiler.span("window.capture"):
        with profiler.capturing(index, rows=2) as captured:
            with profiler.span("step"), profiler.span("block.attn_fwd", kernel=True):
                ptr, row, width, col = profiler.core_marks_args("core.attn_fwd")
    assert [rel for rel, *_ in captured] == ["step/block.attn_fwd/core.attn_fwd", "step"]
    ((core_start, core_end), (step_start, step_end)) = [marks for *_, marks in captured]
    assert core_start[0] is core_end[0] and core_end[1] == core_start[1] + 1 == col + 1
    assert (ptr, width) == (core_start[0].data_ptr(), _CpuStamps.WIDTH)
    assert _build.LAUNCHES["core_marks"] == 1
    for r in range(2):       # the replays: the core takes 1 ms, then 2 ms
        for (table, c), ms in ((step_start, 0), (core_start, 1), (core_end, 2 + r),
                               (step_end, 5)):
            table[r, c] = 100_000_000 * (r + 1) + 1_000_000 * ms
    with profiler.span("window.replay"):
        profiler.replayed(captured, range(2))
    with profiler.span("eager"):
        ptr, row, width, col = profiler.core_marks_args("core.attn_bwd")
        table = next(t for t in profiler._EAGER[0].tables if t.data_ptr() == ptr)
        table[0, col], table[0, col + 1] = 7_000_000, 10_000_000
    assert row is None and _build.LAUNCHES["core_marks"] == 2
    spans = profiler.spans().spans
    by_id = {s.id: s for s in spans}
    cores = [s for s in spans if s.name == "core.attn_fwd"]
    assert [s.device_ms for s in cores] == [1.0, 2.0]
    assert [by_id[s.parent].name for s in cores] == ["step", "step"]
    assert all(s.host_ms is None for s in cores)
    (eager,) = [s for s in spans if s.name == "core.attn_bwd"]
    assert eager.device_ms == 3.0 and by_id[eager.parent].name == "eager"
    assert eager.host_ms is None


def test_trace_writes_the_spans(vocab, tmp_path):
    import json

    with profiler.trace(str(tmp_path / "trace")):
        assert profiler.tracing()
        _eval_pass(vocab, batches=2)
    assert not profiler.tracing()
    (path,) = (tmp_path / "trace").iterdir()
    names = {ev.get("name", "") for ev in json.loads(path.read_text())["traceEvents"]}
    assert {"mvlpt.eval.batch", "mvlpt.eval.batch/eval.image", "mvlpt.eval.read"} <= names


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _busy_ms(prof, span_name):
    """The union of device activity inside the device-side range of the
    one ``span_name`` range of a torch.profiler trace, in ms."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    (lo, hi), = [(ev.time_range.start, ev.time_range.end) for ev in events
                 if ev.name == f"mvlpt.{span_name}" and ev.device_type == DeviceType.CUDA]
    kernels = sorted((max(ev.time_range.start, lo), min(ev.time_range.end, hi))
                     for ev in events if ev.device_type == DeviceType.CUDA
                     and not getattr(ev, "is_user_annotation", False)
                     and ev.time_range.end > lo and ev.time_range.start < hi)
    busy, end = 0.0, lo
    for a, b in kernels:
        a = max(a, end)
        if b > a:
            busy, end = busy + b - a, b
    return busy * 1e-3


@pytest.mark.card
def test_captured_spans_on_the_card(vocab, card):
    """At ViT-B/16's widths (UPT, 100 classes, batch 32, remat): each
    tracing state captures the window's step again (cause "tracing"), in
    place of the other state's graph, and no graph replays in another
    state; each replayed step leaves a
    sample of its spans, every device span positive; the towers'
    backwards do not overlap on the device; with the kernels' stamps every
    half-block of both towers has its sample; without them the steps'
    top-level spans cover 95-102% of their device busy time, which the
    profiler's trace of the next window of the same graph gives (under
    the profiler, whose kernel records slow the replays, the spans read
    that too)."""
    from torch.profiler import ProfilerActivity, profile

    from mvlpt_torch.flagship import flagship
    from mvlpt_torch.train.train_step import make_train_step_multi

    model, backbone, params, consts, images, clip_cfg = flagship(100, batch=32, device=card)
    model.remat = True
    state = _state(params)
    step = make_train_step_multi(model)
    gen = torch.Generator().manual_seed(0)
    batches = {"image": images[None].expand(K, *images.shape).contiguous(),
               "label": torch.randint(0, 100, (K, 32), generator=gen).to(card)}
    step(state, backbone, consts, batches)
    assert dict(step.capture_causes) == {"shape": 1}
    layers = clip_cfg.vision_layers + clip_cfg.transformer_layers
    for n, kernels in enumerate((False, True), start=1):
        profiler.enable_tracing(True, kernels=kernels)
        step(state, backbone, consts, batches)
        assert dict(step.capture_causes) == {"shape": 1, "tracing": n}
        profiler.reset_spans()
        step(state, backbone, consts, batches)
        samples = [s for s in profiler.spans().spans if s.host_ms is None]
        names = collections.Counter(s.name for s in samples)
        assert names["step"] == K and names["step.text.bwd"] == names["step.image.bwd"] == K
        assert names["block.attn_bwd"] == (K * layers if kernels else 0)
        assert names["block.attn_fwd"] == (2 * K * layers if kernels else 0)
        assert all(s.device_ms > 0 for s in samples)
        by_id = {s.id: s for s in samples}
        tops = []
        for sid in _under(samples, "step"):
            tops.append(sum(s.device_ms for s in samples if s.parent == sid))
            bwd = [s for s in samples if s.name in ("step.text.bwd", "step.image.bwd")
                   and by_id[s.parent].parent == sid]
            text, image = sorted(bwd, key=lambda s: s.device_start_ms)
            assert (text.name, image.name) == ("step.text.bwd", "step.image.bwd")
            assert text.device_start_ms + text.device_ms <= image.device_start_ms + 1e-3
        if not kernels:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(state, backbone, consts, batches)
                torch.cuda.synchronize()
            per_step = _busy_ms(prof, "window.replay") / K   # K replays of one graph
            assert 0.95 <= sum(tops) / K / per_step <= 1.02, (tops, per_step)
        profiler.enable_tracing(False)
        profiler.reset_spans()
    replays = step.replays
    step(state, backbone, consts, batches)
    assert dict(step.capture_causes) == {"shape": 1, "tracing": 3}
    assert step.replays == replays + K - 1 and len(step._graphs) == 1


@pytest.mark.card
def test_core_marks_on_the_card(vocab, card):
    """At ViT-B/16's widths (UPT, 100 classes, batch 32): at the level
    with the half-blocks' stamps and the cores' marks, every replayed step
    holds a mark of each attention core, a forward and a backward a layer
    of both towers, each inside its half-block's span and shorter than
    it; the window's eager warm-up step and its capture count each
    marked launch once; with the marks off the launchers get no slot."""
    from mvlpt_torch.flagship import flagship
    from mvlpt_torch.ops import _build
    from mvlpt_torch.train.train_step import make_train_step_multi

    model, backbone, params, consts, images, clip_cfg = flagship(100, batch=32, device=card)
    state = _state(params)
    step = make_train_step_multi(model)
    gen = torch.Generator().manual_seed(0)
    batches = {"image": images[None].expand(K, *images.shape).contiguous(),
               "label": torch.randint(0, 100, (K, 32), generator=gen).to(card)}
    layers = clip_cfg.vision_layers + clip_cfg.transformer_layers
    marked = _build.LAUNCHES["core_marks"]
    step(state, backbone, consts, batches)
    assert _build.LAUNCHES["core_marks"] == marked
    profiler.enable_tracing(True, kernels=True, cores=True)
    step(state, backbone, consts, batches)          # the warm-up and capture, marked
    assert _build.LAUNCHES["core_marks"] == marked + 2 * 2 * layers
    profiler.reset_spans()
    step(state, backbone, consts, batches)
    samples = [s for s in profiler.spans().spans if s.host_ms is None]
    by_id = {s.id: s for s in samples}
    names = collections.Counter(s.name for s in samples)
    assert names["core.attn_fwd"] == names["core.attn_bwd"] == K * layers
    for s in samples:
        if s.name.startswith("core."):
            half = by_id[s.parent]
            assert half.name == "block." + s.name.removeprefix("core."), (s.path, half.path)
            assert 0 < s.device_ms < half.device_ms
            assert half.device_start_ms <= s.device_start_ms
