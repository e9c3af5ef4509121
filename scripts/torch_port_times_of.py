#!/usr/bin/env python3
"""Run another checkout's chip_smoke.py with this checkout's kernel timing.

    python3 scripts/torch_port_times_of.py /path/to/other/checkout

Older chip_smoke.py files time each kernel, twin and library call as the
mean of 10 launches after one warm-up, host gaps included; this one's
``cuda_ms`` is the median of REPS event-timed runs with the card held
ahead of the host. This script loads the other checkout's chip_smoke.py
(with that checkout's mvlpt_torch), replaces its ``cuda_ms`` with this
checkout's, and runs its main(), so its rows compare with this
checkout's like for like. Everything else, and the output, is the other
checkout's. Needs a card.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    timing = _load("chip_smoke_timing", HERE / "chip_smoke.py")
    sys.path.insert(0, str(other))
    smoke = _load("chip_smoke", other / "chip_smoke.py")
    sys.modules["chip_smoke"] = smoke
    smoke.cuda_ms = timing.cuda_ms
    return smoke.main()


if __name__ == "__main__":
    sys.exit(main())
