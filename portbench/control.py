"""The readings that a cell's limits are set from: the program's numbers
(the lower readings), and those of the stand-ins that bound them from
above: the control (the reference put in the program's place with every
tower product in float8, the precision below the configuration's
bfloat16) and each fault of the cell's loop (a training cell: the loss
taken over half of each batch, the reference again, in float32). Each is
compared with the float32 reference exactly as a run compares the
program, over the same work: the program runs the cell's loop for
``--seconds`` as a run's window does, and the stand-ins follow what it
did from the same starting points.

    python3 portbench/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

Run on the card at the cell's own size; one JSON line a seed. The runs of
the benchmark do not run it. (A state left unchanged reads 1 on the
change by the comparison's measure and needs no run.)
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import bench  # noqa: E402


def readings(cell: bench.Cell, seed: int, seconds: float = 1.0, device: str = "cuda") -> dict:
    """{"program", "control_fp8", and each fault of the loop: its
    numbers} for ``cell`` at ``seed``."""
    import torch

    from portbench import cells, check, program
    from portbench.reference import clip_upt

    bench.environment()
    dev = torch.device(device)
    prog = program.build(cell.config, seed, dev)
    loop = cells.loop(cell.traffic["kind"])(prog, cell.traffic, seed)
    loop.setup()
    loop.measure(seconds, cells.clock)
    backbone = prog.backbone
    loop, ref = bench.close(loop, prog, dev, check)
    del prog
    with bench._fp32_products():
        want = loop.follow(ref)
        low = check.Reference(cell.config, backbone, bench.vocab_path(), dev,
                              mm=clip_upt.matmul_fp8)
        out = {"program": loop.compare(loop.got, want),
               "control_fp8": loop.compare(loop.follow(low), want)}
        for fault in loop.FAULTS:
            out[fault] = loop.compare(loop.follow(ref, fault), want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="the program's window before the comparison (a run's is run_seconds)")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = bench.find_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(cell, seed, args.seconds)
        print(json.dumps({"workload": cell.name, "seed": seed, "readings": out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
