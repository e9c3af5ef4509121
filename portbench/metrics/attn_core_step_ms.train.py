"""attn_core_step_ms.train: the device time of the attention cores inside
the replayed train step: between the marks that the attention
half-blocks' launchers write around their core (core.attn_fwd, and
core.attn_bwd around the backward's dq and dkv cores), both towers,
remat's second forwards included, summed a step, the median over the
samples of a traced stretch at the core marks' level alone
(portbench/core_marks.py)."""

from portbench import core_marks, spans


def read(run):
    log = core_marks.read(run)
    return None if log is None else spans.median(core_marks.step_ms(log))
