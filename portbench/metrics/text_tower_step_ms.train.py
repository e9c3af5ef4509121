"""text_tower_step_ms.train: the device time of the text tower inside
the replayed train step: the program's spans step.text.fwd (the prompt
assembly and the class-packed text tower) and step.text.bwd (its
backward into the assembled prompts, remat's second forwards included),
summed a step, the median over the traced stretch's samples (one a
window: the captured step's last replay; portbench/spans.py)."""

from portbench import spans


def read(run):
    if run.cell.traffic["kind"] != "train_window":
        return None
    r = spans.read(run)
    return None if r is None else spans.median(
        spans.per_step(r.spans, {"step.text.fwd", "step.text.bwd"}))
