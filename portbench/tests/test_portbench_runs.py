"""Whole runs of the harness on the CPU at tiny sizes (the card's checks
skipped): the reference against the port's plain path, the result line,
a run with the timed path broken underneath."""

import json
import subprocess
import sys

import pytest
from conftest import EVAL, ROOT, TRAIN, tiny_cell

from portbench import bench


def _run(cell, seed=2 ** 31 + 11, trace=False):
    return bench.run(cell, seed, 0.3, trace, device="cpu", log=sys.stderr)


@pytest.mark.parametrize("config,traffic,limits", [
    ("tiny_upt", TRAIN, "c100.train"),
    ("tiny_upt_multitask", dict(TRAIN, labels="task_proportional"), "elevater20.train"),
    ("tiny_upt", EVAL, "c100.eval"),
])
def test_reference_agrees_with_the_port_in_fp32(config, traffic, limits):
    """The port's fp32 path (the plain twins on the CPU) and the
    reference compute the same model: every number compared reads
    round-off (float32's, compounded over a window's steps at the
    cosine's learning rate: under 1e-4; bfloat16 reads 1e-3 and more)."""
    result = _run(tiny_cell(config, traffic, limits, dtype="float32"))
    for name, c in result["checks"].items():
        assert c["value"] < 1e-4, (name, c)


def test_result_line_keys():
    cell = tiny_cell("tiny_upt", TRAIN, "c100.train",
                     end_to_end=[{"name": "train_img_s", "unit": "img/s"},
                                 {"name": "setup_s", "unit": "s"}])
    result = _run(cell)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["metrics"]) == {"train_img_s", "setup_s"}
    assert result["attempted"] % (TRAIN["batch"] * TRAIN["window"]) == 0
    assert result["failed"] == 0
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    json.dumps(result)


def test_run_without_a_card_prints_no_result(card_absent):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "c100.train",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")


def test_a_dummy_metric_file_is_picked_up(tmp_path):
    """A later PR adds a metric by adding its reader and its entry alone."""
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "dummy_pct.train", "unit": "%", "better": "higher",
                           "source": "program_counter", "layer": "window",
                           "moves": "train_img_s", "workloads": ["c100.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "portbench" / "metrics" / "dummy_pct.train.py").write_text(
        "def read(run):\n    return 42.0 + run.window['steps'] * 0\n")
    code = (
        "import json, sys; sys.path.insert(0, '.'); sys.path.insert(1, %r)\n"
        "from portbench import bench\n"
        "c = bench.find_cell('c100.train')\n"
        "c.config = json.load(open(%r)); c.traffic = %r\n"
        "r = bench.run(c, 3, 0.2, True, device='cpu')\n"
        "print(json.dumps(r['metrics']))\n"
    ) % (str(ROOT), str(ROOT / "portbench" / "tests" / "data" / "tiny_upt.json"), TRAIN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    assert metrics["dummy_pct.train"]["value"] == 42.0
    # The metrics that read nothing on the CPU (no trace, no card) are left out.
    assert "device_idle_pct.train" not in metrics


def test_a_cell_of_files_alone(tmp_path):
    """A later PR adds a cell by files and entries alone: here the
    cached-text eval under multitask routing (each image with its task),
    a traffic file, a limits file and a workload entry, run on the CPU
    with the tiny multitask configuration."""
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "elevater20.eval", "config": "upt_vitb16_elevater20",
                           "traffic": "eval_tasks", "chips": 1, "why": "a test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "c100.eval" in m.get("workloads", ()):
            m["workloads"].append("elevater20.eval")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "portbench" / "traffic" / "eval_tasks.json").write_text(json.dumps(
        dict(EVAL, labels="task_proportional")))
    shutil.copy(ROOT / "portbench" / "limits" / "c100.eval.json",
                tmp_path / "portbench" / "limits" / "elevater20.eval.json")
    code = (
        "import json, sys; sys.path.insert(0, '.'); sys.path.insert(1, %r)\n"
        "from portbench import bench\n"
        "c = bench.find_cell('elevater20.eval')\n"
        "c.config = json.load(open(%r))\n"
        "r = bench.run(c, 5, 0.2, False, device='cpu')\n"
        "print(json.dumps(r))\n"
    ) % (str(ROOT), str(ROOT / "portbench" / "tests" / "data" / "tiny_upt_multitask.json"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["attempted"] > 0, result
    assert set(result["metrics"]) == {"eval_img_s", "peak_mem_gib", "setup_s"}
