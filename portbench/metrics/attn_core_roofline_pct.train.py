"""attn_core_roofline_pct.train: the share of their roofline that the
attention cores reach in a replayed train step: the least time of the
step's core launches at the cell's shapes (portbench/attn_core.py, the
forward cores with their probabilities and the backward cores of both
towers), over the median of their marked time a step
(attn_core_step_ms.train's reading). Where the step wrote another number
of core marks than the cell's shapes count, it reads nothing."""

import sys

from portbench import attn_core, core_marks, spans


def read(run):
    log = core_marks.read(run)
    if log is None:
        return None
    cfg, batch = run.cell.config, run.cell.traffic["batch"]
    want = sum(attn_core.step_cores(cfg, batch, run.prog.text_len).values())
    got = set(core_marks.marks_per_step(log))
    if got != {want}:
        print(f"attn_core_roofline: the steps wrote {sorted(got)} core marks, the cell's shapes "
              f"count {want}; not read", file=sys.stderr)
        return None
    least = attn_core.step_least_ms(cfg, batch, run.prog.text_len)
    return 100.0 * least / spans.median(core_marks.step_ms(log))
