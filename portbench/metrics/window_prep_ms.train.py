"""window_prep_ms.train: the device time a window spends before its
replays: the device's busy time of the work that the program's spans
window.pre_embed (the frozen stem over the window's K x B images) and
window.stage (the copies into the graph's static tensors) launched, in
the profiled stretch, summed a window, the median over its windows
(portbench/spans.py). The spans' stamps would count the device's waits
for the host's launches and allocations too."""

from portbench import spans


def read(run):
    if run.cell.traffic["kind"] != "train_window":
        return None
    r = spans.read(run)
    if r is None:
        return None
    pre, stage = (r.busy_ms.get(n, []) for n in ("window.pre_embed", "window.stage"))
    return spans.median([a + b for a, b in zip(pre, stage)])
