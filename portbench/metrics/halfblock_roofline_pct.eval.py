"""halfblock_roofline_pct.eval: the share of their roofline that the
no-grad half-blocks #5 and #6 reach over a cached-text eval batch
(portbench/halfblocks.py)."""

from portbench import halfblocks


def read(run):
    if run.cell.traffic["kind"] != "cached_eval" or run.device.type != "cuda":
        return None
    return halfblocks.roofline_pct(run, train=False)
