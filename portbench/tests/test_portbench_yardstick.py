"""The benchmark's frozen arithmetic: FLOP counts, the half-blocks'
operations and bytes, the idle union."""

import json

import pytest
from conftest import ROOT

from portbench import flops, program, roofline, trace


def _cell_shapes():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in bench["configs"]}
    texts = {"upt_vitb16_c100": 18, "upt_vitb16_elevater20": 70}
    for w in bench["workloads"]:
        cfg = json.loads((ROOT / files[w["config"]]).read_text())
        traffic = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        yield w["name"], cfg, traffic, texts[w["config"]]


@pytest.mark.parametrize("name,cfg,traffic,s", list(_cell_shapes()), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_frozen_flops_equal_the_ports(name, cfg, traffic, s):
    from mvlpt_torch.utils import flops as port

    clip = cfg["clip"]
    n = len(program.classnames(cfg))
    g, _ = roofline.packing(n, s)
    kw = dict(batch=traffic["batch"], n_cls=n,
              image_tokens=roofline.image_tokens(clip, cfg["prompt"]),
              vision_width=clip["vision_width"], vision_layers=clip["vision_layers"],
              patch_tokens=196, patch_dim=768)
    train = dict(kw, text_tokens_per_cls=s, text_width=clip["transformer_width"],
                 text_layers=clip["transformer_layers"], text_pack_classes=g)
    assert flops.flagship_step_flops(**train) == port.flagship_step_flops(**train)
    assert flops.eval_step_flops(**kw, embed=512) == port.eval_step_flops(**kw, embed=512)


def test_the_port_packs_text_as_the_copy_does():
    from mvlpt_torch.core.text import packing

    for n, s in ((100, 18), (1151, 70), (5, 18), (10, 64), (1000, 77)):
        assert roofline.packing(n, s) == packing(n, s)


def test_halfblock_ops_and_bytes_by_hand():
    # 2 rows of 4 tokens, width 8, no mask: T = 8 tokens, 16 pairs a row.
    s = roofline.Shape(rows=2, tokens=4, width=8, heads=2, causal=False)
    assert s.pairs == 32
    w, t = 8, 8
    attn_w = 8 * 24 + 24 + 64 + 8 + 16          # qkv, its bias, out, its bias, LN
    assert roofline.ops_bytes("attn_fwd", s) == (
        2 * t * w * 3 * w + 2 * t * w * w + 2 * 2 * 32 * w,
        2 * (t * w * 2) + attn_w * 2)
    assert (roofline.ops_bytes("attn_bwd", s)[0]
            == 2 * t * w * w + 2 * t * 3 * w * w + 4 * 2 * 32 * w)
    assert roofline.ops_bytes("attn_bwd", s)[1] == 3 * (t * w * 2) + attn_w * 2
    mlp_w = 8 * 32 + 32 + 32 * 8 + 8 + 16
    assert roofline.ops_bytes("mlp_fwd", s) == (2 * 2 * t * w * 4 * w, 2 * t * w * 2 + mlp_w * 2)
    assert roofline.ops_bytes("mlp_bwd", s) == (2 * 2 * t * w * 4 * w, 3 * t * w * 2 + mlp_w * 2)
    # Two classes of 3 tokens packed in a row, causal: 6 pairs each, and
    # the (6, 6) fp32 mask is read.
    c = roofline.Shape(rows=1, tokens=6, width=8, heads=1, causal=True, blocks=2)
    assert c.pairs == 12
    ops, nbytes = roofline.ops_bytes("attn_fwd", c)
    assert ops == 8 * 6 * 64 + 4 * 12 * 8
    assert nbytes == 2 * 6 * 8 * 2 + attn_w * 2 + 36 * 4


def test_least_time_is_the_larger_bound():
    s = roofline.Shape(rows=32, tokens=201, width=768, heads=12, causal=False)
    ops, nbytes = roofline.ops_bytes("attn_fwd", s)
    assert roofline.least_ms("attn_fwd", s) == pytest.approx(ops / 989e12 * 1e3)
    assert ops / 989e12 > nbytes / 3.35e12
    tiny = roofline.Shape(rows=1, tokens=1, width=64, heads=1, causal=False)
    ops, nbytes = roofline.ops_bytes("mlp_fwd", tiny)
    assert roofline.least_ms("mlp_fwd", tiny) == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_step_launches_count_remat_twice():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / next(c["file"] for c in bench["configs"]
                                  if c["name"] == "upt_vitb16_elevater20")).read_text())
    got = roofline.step_launches(cfg, 32, 70, train=True)
    by_kind = {}
    for (kind, tower, shape), n in got.items():
        by_kind[(kind, tower)] = (n, shape.rows, shape.tokens)
    assert by_kind[("attn_fwd", "text")] == (24, 1151, 70)
    assert by_kind[("attn_bwd", "visual")] == (12, 32, 213)
    assert by_kind[("mlp_fwd", "visual")] == (24, 32, 213)
    ev = roofline.step_launches(dict(cfg, remat=False), 100, 70, train=False)
    assert sorted(n for n in ev.values()) == [12, 12]


def test_idle_union_of_overlapping_intervals():
    # A kernel and a side-stream copy that overlaps it count once.
    intervals = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 45)]
    assert trace.union_length(intervals, 0, 50) == 12 + 10 + 5
    assert trace.union_length(intervals, 8, 42) == 4 + 10 + 2
    assert trace.gaps(intervals, 0, 50) == [(12, 20), (30, 40), (45, 50)]
    assert trace.gaps([], 0, 5) == [(0, 5)]
    # The sum would read 33 busy of 50; the union reads 27.
    assert sum(b - a for a, b in intervals) == 33


def test_reduce_names_gaps_by_the_host_span():
    from torch.autograd import DeviceType

    class Ev:
        def __init__(self, name, a, b, device):
            self.name, self.device_type = name, device
            self.time_range = type("R", (), {"start": a, "end": b})()

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [Ev(trace.STRETCH, 0, 100, cpu), Ev(trace.STRETCH, 0, 95, cuda),
              Ev("aten::copy_", 10, 30, cpu),
              Ev("cudaStreamSynchronize", 60, 90, cpu),
              Ev("k1", 0, 10, cuda), Ev("k2", 5, 8, cuda), Ev("k1", 30, 60, cuda),
              Ev("k3", 95, 120, cuda)]
    t = trace.reduce(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((10 + 30 + 5) * 1e-6)
    assert t.device_ops[0] == ["k1", pytest.approx(40e-6)]
    gaps = dict(t.idle_gaps)
    assert gaps["aten::copy_"] == pytest.approx(20e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(35e-6)  # the gap from 60 to 95
