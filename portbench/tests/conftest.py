"""Fixtures of the benchmark's tests. Run them from the repository's
root with ``python -m pytest portbench/tests -q``; the tests marked
``card`` run on a CUDA card and skip elsewhere."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, at run
    time, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TRAIN = {"kind": "train_window", "batch": 4, "window": 3, "pool_windows": 2, "shots": 4,
         "labels": "uniform"}
EVAL = {"kind": "cached_eval", "batch": 5, "pool_batches": 3}


def tiny_cell(config: str, traffic: dict, limits: str, dtype: str = "bfloat16",
              end_to_end=(), per_layer=()):
    """A cell of the tiny configurations in ``data/`` under a real cell's
    limits, for runs on the CPU."""
    from portbench import bench

    cfg = json.loads((DATA / f"{config}.json").read_text())
    cfg["compute_dtype"] = dtype
    return bench.Cell(workload={"name": f"tiny.{limits}", "chips": 1}, config=cfg,
                      traffic=dict(traffic),
                      limits=json.loads((ROOT / "portbench" / "limits" / f"{limits}.json")
                                        .read_text()),
                      end_to_end=list(end_to_end), per_layer=list(per_layer))
