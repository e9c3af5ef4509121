"""halfblock_roofline_pct.train: the share of their roofline that the
half-blocks #1-#4 reach over a train step, image and text towers, remat's
second forwards included (portbench/halfblocks.py)."""

from portbench import halfblocks


def read(run):
    if run.cell.traffic["kind"] != "train_window" or run.device.type != "cuda":
        return None
    return halfblocks.roofline_pct(run, train=True)
