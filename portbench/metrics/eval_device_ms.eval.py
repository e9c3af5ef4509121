"""eval_device_ms.eval: the device's busy time of an eval batch: the
union of the device activity that the program's span eval.batch launched
(the image tower and the logits; each operation joined to its launch by
the profiler's correlation id), the median over a traced pass over the
pool (portbench/spans.py). The span's own event pair would count the
device's waits for the host's launches too."""

from portbench import spans


def read(run):
    if run.cell.traffic["kind"] != "cached_eval":
        return None
    r = spans.read(run)
    return None if r is None else spans.median(r.busy_ms.get("eval.batch", []))
