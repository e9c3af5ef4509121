#!/usr/bin/env python3
"""What the port's spans (``mvlpt_torch.utils.profiler``) cost when on,
in the benchmark's cells, on one card.

    python3 scripts/torch_port_span_cost.py [--cells c100.train,c100.eval,elevater20.train]
                                            [--seconds 8] [--rounds 2] [--seed 1]

Builds each cell as ``portbench/run.py`` does (its configuration, traffic
and seed), warms it up, then measures its loop for ``--seconds`` in three
states in turns, ``--rounds`` of each: tracing off, on without the
kernels' stamps (``kernels=False``), and on with them: images a second on
the host clock, as the benchmark counts them. A train cell keeps one
captured graph, captured again when the state changes, so each timed
window follows an untimed one in its state (the capture). Then it
traces one stretch of each state with torch.profiler and reports the
device's busy time a step (a train cell: a window's union of device
activity over its K steps) or a batch (an eval cell: a pass over the
pool over its batches). One JSON line a cell, with the card's name and
power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _cell_cost(name: str, seconds: float, rounds: int, seed: int) -> dict:
    import torch

    from mvlpt_torch.utils import profiler
    from portbench import bench, cells, program
    from portbench import trace as tracing

    cell = bench.find_cell(name)
    bench.environment()
    prog = program.build(cell.config, seed, torch.device("cuda"))
    loop = cells.loop(cell.traffic["kind"])(prog, cell.traffic, seed)
    loop.setup()
    train = cell.traffic["kind"] == "train_window"
    per = loop.k if train else loop.n_pool
    states = {"off": None, "steps": False, "kernels": True}   # state -> kernels

    def run(state, fn):
        profiler.enable_tracing(states[state] is not None, kernels=bool(states[state]))
        try:
            return fn()
        finally:
            profiler.enable_tracing(False)
            profiler.reset_spans()

    rates = {state: [] for state in states}
    for _ in range(rounds):
        for state in states:
            run(state, loop.stretch)     # a train cell captures this state's step here
            window = run(state, lambda: loop.measure(seconds, cells.clock))
            rates[state].append(window["images"] / window["seconds"])
    unit = "step" if train else "batch"
    out = {"cell": name}
    for state in states:
        run(state, loop.stretch)
        busy = run(state, lambda: 1e3 * tracing.traced(loop.stretch).busy_s / per)
        out[f"img_s_{state}"] = rates[state]
        out[f"img_s_{state}_over_off"] = (statistics.median(rates[state])
                                          / statistics.median(rates["off"]))
        out[f"busy_ms_a_{unit}_{state}"] = busy
    out["card"] = bench.card_line()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="c100.train,c100.eval,elevater20.train")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_span_cost: needs a CUDA card", file=sys.stderr)
        return 3
    for name in args.cells.split(","):
        print(json.dumps(_cell_cost(name, args.seconds, args.rounds, args.seed)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
