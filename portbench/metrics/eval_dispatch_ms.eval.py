"""eval_dispatch_ms.eval: the host's time to enqueue an eval batch: the
program's span eval.batch (the image tower and the logits, launched)
on the host clock, the median over a traced pass over the pool
(portbench/spans.py)."""

from portbench import spans


def read(run):
    if run.cell.traffic["kind"] != "cached_eval":
        return None
    r = spans.read(run)
    return None if r is None else spans.median(spans.host_ms(r.spans, "eval.batch"))
