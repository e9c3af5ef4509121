"""The general traffic generator and what every loop shares. A traffic
file (``traffic/<name>.json``) gives the parameters and its ``kind``; the
loop that drives the port for that kind is ``loops/<kind>.py`` (its class
``Loop``), found by that name, so a later PR adds a kind of traffic by
adding its file. The inputs come from the seed, on the device, in bulk.

A loop's interface, as ``bench.run`` and ``control.py`` call it:

* ``Loop(prog, traffic, seed)``; ``setup()`` warms up the cell's own
  shapes; ``measure(seconds, clock)`` runs the measured window and
  returns its counts (``seconds``, ``images``, ``failed`` and what the
  metrics read); ``stretch()`` runs one more stretch of the same work
  (the traced one); ``eager_step()`` runs one step of the cell eagerly
  (the half-blocks' launch counters).
* ``close()`` keeps what the program produced for the comparison and
  drops the program's objects; ``follow(ref, fault=None)`` has a
  reference (``check.Reference``, or a lower-precision one: the control)
  follow the same work from the same inputs, optionally with one of the
  loop's ``FAULTS`` planted, and returns its output in the program's
  form; ``compare(got, want)`` gives the numbers compared; ``got`` is the
  program's output.
"""

from __future__ import annotations

import importlib.util
import time
from pathlib import Path

import torch

from portbench.program import classnames, seeds, task_bounds

LOOPS = Path(__file__).resolve().parent / "loops"


def load(path: Path, name: str):
    """The module in file ``path``, under the name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def loop(kind: str):
    """The ``Loop`` class of ``loops/<kind>.py``."""
    return load(LOOPS / f"{kind}.py", f"portbench.loops.{kind}").Loop


def flatten(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) in key-sorted order, the order of the port's
    ``tree_leaves`` and so of its optimizer's slots."""
    out = []
    for key in sorted(tree):
        value, path = tree[key], f"{prefix}{key}"
        out.extend(flatten(value, path + ".") if isinstance(value, dict) else [(path, value)])
    return out


def labels(scheme: str, cfg: dict, shape: tuple, gen, device) -> dict:
    """Labels (and tasks) of ``shape``: "uniform" over the classes of a
    single task; "task_proportional": a class drawn uniformly over every
    task's classes, so each sample's task comes in proportion to its
    class count, and the label is that class's global id."""
    n_cls = len(classnames(cfg))
    label = torch.randint(0, n_cls, shape, generator=gen, device=device)
    if scheme == "uniform":
        return {"label": label}
    if scheme == "task_proportional":
        ends = torch.tensor([b[1] for b in task_bounds(cfg)], device=device)
        return {"label": label, "task": torch.searchsorted(ends, label, right=True)}
    raise ValueError(f"unknown label scheme {scheme!r}")


def make_pool(cfg: dict, shape: tuple, scheme: str | None, seed: int, device) -> dict:
    """A device pool from the seed: uint8 images of ``shape`` (H, W, 3
    after it) and, with a label ``scheme``, their labels (and tasks)."""
    res = cfg["clip"]["image_resolution"]
    gen = torch.Generator(device=device).manual_seed(seeds(seed)["data"])
    pool = {"image": torch.randint(0, 256, (*shape, res, res, 3), dtype=torch.uint8,
                                   generator=gen, device=device)}
    if scheme is not None:
        pool.update(labels(scheme, cfg, shape, gen, device))
    return pool


def steps_per_epoch(cfg: dict, traffic: dict) -> int:
    """The epoch of a few-shot run: shots x classes / batch steps."""
    return traffic["shots"] * len(classnames(cfg)) // traffic["batch"]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clock() -> float:
    return time.perf_counter()
