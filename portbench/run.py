"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a host with the cell's CUDA cards. It
builds the port from the cell's configuration and the seed, warms up
the cell's own shapes, measures for ``--seconds``, compares what the
timed path produced with the plain reference, and prints one JSON line
last: the cell's end-to-end metrics with ``--trace 0``, its per-layer
metrics with ``--trace 1``. Without the card it exits 3 and prints no
result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = bench.find_cell(args.workload)
    try:
        result = bench.run(cell, args.seed, args.seconds, bool(args.trace), t_start=T0)
    except bench.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    bad = bench.forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad}; the benchmark runs the port alone",
              file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
