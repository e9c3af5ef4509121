"""The benchmark's ViT-L/14@336px cell and the attention cores' metrics
(``portbench/``), on the CPU: a configuration of ViT-L/14@336px's shape
through a whole run against the plain reference, the cores' yardstick by
hand, the two metric readers on a fabricated span log, and the cell as
BENCHMARK.json names it. The runs go through a
child process: the benchmark refuses a process that holds JAX, which
this suite's conftest imports."""

import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import attn_core, bench, cells, core_marks, roofline  # noqa: E402

VITL336 = "upt_vitl14_336_c100"


def _config(name: str) -> dict:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in spec["configs"] if c["name"] == name)
    return json.loads((ROOT / conf["file"]).read_text())


def _tiny_vitl336() -> dict:
    """ViT-L/14@336px's shape at a tiny size: patch 14 over a 3 x 3 grid,
    heads of 64, a vision width above the text width and unequal to the
    embedding, two layers a tower, ten classes; fp32."""
    cfg = _config(VITL336)
    cfg["clip"].update(embed_dim=64, image_resolution=42, vision_layers=2, vision_width=128,
                       vision_heads=2, transformer_width=64, transformer_heads=1,
                       transformer_layers=2)
    cfg["prompt"]["project_dim"] = 16
    cfg["classes"]["numbered"] = 10
    cfg["compute_dtype"] = "float32"
    return cfg


RUN = """
import json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
from portbench import bench
cell = bench.Cell(workload={{"name": "tiny", "chips": 1}}, config={cfg}, traffic={traffic},
                  limits={limits}, end_to_end=[], per_layer=[])
result = bench.run(cell, 2 ** 31 + 29, 0.3, False, device="cpu", root=Path({tmp!r}))
print(json.dumps(result["checks"]))
"""


@pytest.mark.parametrize("traffic, limits", [
    ({"kind": "train_window", "batch": 4, "window": 3, "pool_windows": 2, "shots": 4,
      "labels": "uniform"}, "vitl336_c100.train"),
    ({"kind": "cached_eval", "batch": 5, "pool_batches": 3}, "c100.eval"),
])
def test_vitl336_shape_agrees_with_the_reference_in_fp32(tmp_path, traffic, limits):
    """The port's fp32 path (the plain twins on the CPU) and the reference
    compute the same model at ViT-L/14@336px's shape, one train window
    and one cached eval: every number compared reads float32 round-off."""
    cfg = _tiny_vitl336()
    lim = json.loads((ROOT / "portbench" / "limits" / f"{limits}.json").read_text())
    code = RUN.format(root=str(ROOT), cfg=cfg, traffic=traffic,
                      limits=lim, tmp=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    checks = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(checks) == set(lim)
    for name, c in checks.items():
        assert c["value"] < 1e-4, (name, c)


def test_core_ops_and_bytes_by_hand():
    # ViT-L/14@336px's image rows: (32, 581, 16 heads of 64), no mask.
    s = roofline.Shape(rows=32, tokens=581, width=1024, heads=16, causal=False)
    pairs = 32 * 16 * 581 * 581
    qkv, o = 32 * 581 * 3 * 1024 * 2, 32 * 581 * 1024 * 2
    assert attn_core.ops_bytes("fwd", s) == (4 * pairs * 64, qkv + o + 2 * pairs)
    assert attn_core.ops_bytes("bwd", s) == (8 * pairs * 64,
                                             qkv + 2 * pairs + o + qkv + 32 * 16 * 581 * 4)
    # The probabilities are 346 MB of the forward's 498 MB; byte-bound.
    assert 2 * pairs == 345_662_464 and qkv + o + 2 * pairs == 497_968_128
    assert attn_core.least_ms("fwd", s) == pytest.approx(497_968_128 / 3.35e12 * 1e3)
    # ViT-B/16 at c100: (32, 201, 12 heads of 64).
    b = roofline.Shape(rows=32, tokens=201, width=768, heads=12, causal=False)
    pairs = 32 * 12 * 201 * 201
    qkv, o = 32 * 201 * 3 * 768 * 2, 32 * 201 * 768 * 2
    assert attn_core.ops_bytes("fwd", b) == (4 * pairs * 768 // 12, qkv + o + 2 * pairs)
    assert attn_core.ops_bytes("bwd", b) == (8 * pairs * 64,
                                             2 * qkv + o + 2 * pairs + 32 * 12 * 201 * 4)
    # A packed text row: 2 classes of 3 tokens, causal: 6 pairs a class a
    # head; the forward reads the (6, 6) fp32 mask, the backward does not.
    c = roofline.Shape(rows=1, tokens=6, width=128, heads=2, causal=True, blocks=2)
    qkv, o = 6 * 3 * 128 * 2, 6 * 128 * 2
    assert attn_core.ops_bytes("fwd", c) == (4 * 12 * 128, qkv + 36 * 4 + o + 2 * 12 * 2)
    assert attn_core.ops_bytes("bwd", c) == (8 * 12 * 128, 2 * qkv + o + 2 * 12 * 2 + 2 * 6 * 4)
    with pytest.raises(ValueError):
        attn_core.ops_bytes("attn_fwd", c)


def test_step_cores_follow_the_attention_half_blocks():
    cfg = _config("upt_vitb16_elevater20")      # remat: two forwards a layer
    cores = attn_core.step_cores(cfg, 32, 70)
    by_kind = {(kind, tower): (n, shape.tokens) for (kind, tower, shape), n in cores.items()}
    assert by_kind == {("fwd", "visual"): (24, 213), ("bwd", "visual"): (12, 213),
                       ("fwd", "text"): (24, 70), ("bwd", "text"): (12, 70)}
    assert attn_core.step_least_ms(cfg, 32, 70) == pytest.approx(sum(
        n * attn_core.least_ms(kind, shape) for (kind, _, shape), n in cores.items()))


def _span(path, sid, parent, device_ms=None):
    from mvlpt_torch.utils.profiler import Span

    return Span(path, sid, parent, None, device_ms=device_ms)


def _log(steps: int, marks_a_step: int, ms: float) -> list:
    """``steps`` replayed steps' samples: each a step span, a tower span in
    it and ``marks_a_step`` core marks of ``ms`` each inside the tower."""
    log, sid = [], 0
    for _ in range(steps):
        step, tower = sid, sid + 1
        log += [_span("window.replay/step", step, None, 100.0),
                _span("window.replay/step/step.image.fwd", tower, step, 50.0)]
        for j in range(marks_a_step):
            name = "core.attn_fwd" if j % 2 == 0 else "core.attn_bwd"
            log.append(_span(f"window.replay/step/step.image.fwd/{name}", sid + 2 + j, tower, ms))
        sid += 2 + marks_a_step
    return log


def _run(config: str, log, traffic="train_window"):
    return types.SimpleNamespace(
        device=types.SimpleNamespace(type="cuda"),
        cell=types.SimpleNamespace(config=_config(config), traffic={"kind": traffic,
                                                                   "batch": 32}),
        prog=types.SimpleNamespace(text_len=18), core_marks=log)


def test_core_metric_readers_on_a_fabricated_log(monkeypatch):
    step_ms = bench.reader("attn_core_step_ms.train")
    pct = bench.reader("attn_core_roofline_pct.train")
    cfg = _config("upt_vitb16_c100")
    want = sum(attn_core.step_cores(cfg, 32, 18).values())
    assert want == 48                        # 12 layers a tower, a forward and a backward
    log = _log(3, want, 0.25)
    assert core_marks.marks_per_step(log) == [want] * 3
    run = _run("upt_vitb16_c100", log)
    assert step_ms(run) == pytest.approx(want * 0.25)
    assert pct(run) == pytest.approx(100 * attn_core.step_least_ms(cfg, 32, 18) / (want * 0.25))
    # Another count of marks than the cell's shapes: the share reads nothing.
    assert pct(_run("upt_vitb16_c100", _log(3, want - 2, 0.25))) is None
    # A program without the marks: nothing to read, and no stretch is run
    # again once the run holds its reading.
    for reader in (step_ms, pct):
        assert reader(_run("upt_vitb16_c100", None)) is None
        assert reader(_run("upt_vitb16_c100", log, traffic="cached_eval")) is None
    monkeypatch.setattr(core_marks, "_stretch", lambda run: _log(2, 0, 0.0))
    fresh = _run("upt_vitb16_c100", None)
    del fresh.core_marks
    assert step_ms(fresh) is None and fresh.core_marks is None


def test_vitl336_cell_resolves_with_its_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = spec["end_to_end"] + spec["per_layer"]
    cell = bench.find_cell("vitl336_c100.train")
    assert cell.workload["chips"] == 1 and set(cell.limits) == {"grad_norm_gap", "change_gap"}
    assert cells.loop(cell.traffic["kind"]).FAULTS == ("half_batch",)
    listed = [m["name"] for m in metrics if cell.name in m.get("workloads", [cell.name])]
    assert {"setup_s", "peak_mem_gib", "train_img_s", "mfu_pct.train"} <= set(listed)
    for metric in listed:
        assert (ROOT / "portbench" / "metrics" / f"{metric}.py").is_file(), metric
    assert cell.config["reduced"] == [] and cell.config["remat"] is False
    assert roofline.image_tokens(cell.config["clip"], cell.config["prompt"]) == 581
    launches = roofline.step_launches(cell.config, 32, 18, train=True)
    image = {kind: (n, shape.tokens, shape.heads) for (kind, tower, shape), n in launches.items()
             if tower == "visual"}
    assert image["attn_fwd"] == (24, 581, 16) and image["attn_bwd"] == (24, 581, 16)
    for metric in ("attn_core_step_ms.train", "attn_core_roofline_pct.train"):
        entry = next(m for m in spec["per_layer"] if m["name"] == metric)
        assert entry["workloads"] == ["c100.train", "elevater20.train", "vitl336_c100.train"]
