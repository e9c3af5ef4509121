"""image_tower_step_ms.train: the device time of the image tower inside
the replayed train step: the program's spans step.image.fwd (the ViT
with the VPT tokens over the pre-embedded batch) and step.image.bwd (its
backward into the VPT tokens, remat's second forwards included), summed
a step, the median over the traced stretch's samples
(portbench/spans.py)."""

from portbench import spans


def read(run):
    if run.cell.traffic["kind"] != "train_window":
        return None
    r = spans.read(run)
    return None if r is None else spans.median(
        spans.per_step(r.spans, {"step.image.fwd", "step.image.bwd"}))
