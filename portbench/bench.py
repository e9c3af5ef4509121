"""One run of one cell: find the cell's files by the names in
BENCHMARK.json, build the port, warm up, measure, read the metrics,
compare with the reference, and compose the result line.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own: ``configs/<file>`` (named in BENCHMARK.json),
``traffic/<traffic>.json``, whose ``kind`` names the loop that drives it
(``loops/<kind>.py``, see ``cells.py``), ``limits/<workload>.json`` and
``metrics/<metric>.py``, whose ``read(run)`` returns the metric's value,
or None where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# Modules whose presence after the window means the process ran the JAX
# package or JAX itself, compared by their whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "mvlpt_tpu")


class NoCard(RuntimeError):
    """The cell needs more CUDA cards than this host has."""


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.workload["name"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _listed(metrics: list, workload: str) -> list:
    return [m for m in metrics if "workloads" not in m or workload in m["workloads"]]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == workload["config"])
    return Cell(workload=workload, config=_json(root / conf["file"]),
                traffic=_json(HERE / "traffic" / f"{workload['traffic']}.json"),
                limits=_json(HERE / "limits" / f"{name}.json"),
                end_to_end=_listed(bench["end_to_end"], name),
                per_layer=_listed(bench["per_layer"], name))


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    from portbench import cells

    return cells.load(HERE / "metrics" / f"{name}.py", f"portbench.metrics.{name}").read


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    seed: int
    seconds: float
    device: object
    prog: object = None          # program.Program
    loop: object = None          # the cell's loops/<kind>.py Loop
    setup_s: float = 0.0
    window: dict = None          # the measured loop's counts and seconds
    peak_bytes: int = 0
    trace: object = None         # trace.Trace of the traced stretch


def vocab_path(root: Path = ROOT) -> str:
    """The synthetic merges file, written once into the checkout's build
    directory (a fixed path) and read by both the port and the reference."""
    from portbench.reference.tokenizer import write_synthetic_vocab

    path = root / "build" / "portbench" / "synthetic_bpe_vocab.txt.gz"
    if not path.is_file():
        write_synthetic_vocab(str(path), seed=0)
    return str(path)


def environment(root: Path = ROOT) -> None:
    """The port's settings for a run: the synthetic merges file, and the
    Python tokenizer (the native one would build with g++ in the set-up
    of a cell's first run; its ids are the same)."""
    os.environ["MVLPT_TORCH_BPE_PATH"] = vocab_path(root)
    os.environ["MVLPT_TPU_NO_NATIVE_BPE"] = "1"
    os.environ["USE_FLAX"] = "0"


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.strip().splitlines()[0]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float | None = None, root: Path = ROOT, log=sys.stderr) -> dict:
    """One run of ``cell``: the result line's object. On the CPU (the
    tests) the same path runs eagerly, without the card's checks."""
    import time

    t_start = time.perf_counter() if t_start is None else t_start
    environment(root)

    import torch

    from portbench import cells, check, program
    from portbench import trace as tracing

    if device == "cuda":
        chips = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoCard(f"{cell.name} needs {chips} CUDA card(s); this host has "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    dev = torch.device(device)
    r = Run(cell=cell, seed=seed, seconds=seconds, device=dev)
    r.prog = program.build(cell.config, seed, dev)
    r.loop = cells.loop(cell.traffic["kind"])(r.prog, cell.traffic, seed)
    r.loop.setup()
    cells.sync(dev)
    r.setup_s = time.perf_counter() - t_start
    r.window = r.loop.measure(seconds, cells.clock)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"the run loaded {bad}: the benchmark runs the port alone")
    if dev.type == "cuda":
        r.peak_bytes = torch.cuda.max_memory_allocated(dev)
        r.trace = tracing.traced(r.loop.stretch) if trace else None

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = reader(m["name"])(r)
        if value is None and not trace:
            raise RuntimeError(f"{cell.name}: the end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    readings = compare(r, check)
    correct, checks = check.judge(readings, cell.limits)
    correct = correct and r.window["failed"] == 0
    result = {"correct": correct, "attempted": r.window["images"], "failed": r.window["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": cell.workload["chips"], "memory_peak_bytes": r.peak_bytes}}
    if r.trace is not None:
        print(f"trace: {r.trace.kernels} device operations, busy {r.trace.busy_s} s of "
              f"{r.trace.window_s} s", file=log)
        result["device"].update(busy_s=r.trace.busy_s, window_s=r.trace.window_s)
        result["breakdown"] = {"device_ops": r.trace.device_ops, "idle_gaps": r.trace.idle_gaps}
    result["card"] = card_line() if dev.type == "cuda" else "cpu"
    result["checks"] = checks
    print(f"card: {result['card']}", file=log)
    for name, value in readings.items():
        if name not in checks and isinstance(value, float):
            print(f"reading {name}: {value} (not compared)", file=log)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=log)
    return result


def compare(r: Run, check) -> dict:
    """Keep what the program produced and free its state, then have the
    reference follow the same work and return the numbers compared."""
    loop, ref = close(r.loop, r.prog, r.device, check)
    r.prog = r.loop = None
    with _fp32_products():
        return loop.compare(loop.got, loop.follow(ref))


def close(loop, prog, device, check) -> tuple:
    """(loop, reference): the loop closed, the program's objects freed,
    and the float32 reference of the cell on the weights the benchmark
    made."""
    import torch

    backbone, cfg = prog.backbone, prog.cfg
    loop.close()
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return loop, check.Reference(cfg, backbone, os.environ["MVLPT_TORCH_BPE_PATH"], device)


class _fp32_products:
    """float32 products without TF32 while the reference runs."""

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
