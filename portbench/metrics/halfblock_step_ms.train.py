"""halfblock_step_ms.train: the device time of the half-block kernels
inside the replayed train step: every block.* span of the program
(#1-#4 on both towers, remat's second forwards included), summed a
step, the median over the samples of the traced stretch with the
kernels' stamps (portbench/spans.py)."""

from portbench import spans


def read(run):
    if run.cell.traffic["kind"] != "train_window":
        return None
    r = spans.read(run, kernels=True)
    return None if r is None else spans.median(
        spans.per_step(r.spans, lambda name: name.startswith("block.")))
