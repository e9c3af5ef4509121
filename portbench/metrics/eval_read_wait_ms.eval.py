"""eval_read_wait_ms.eval: the host's wait for a batch's logits, one
batch behind its dispatch: the program's span eval.read on the host
clock, the median over a traced pass over the pool (portbench/spans.py)."""

from portbench import spans


def read(run):
    if run.cell.traffic["kind"] != "cached_eval":
        return None
    r = spans.read(run)
    return None if r is None else spans.median(spans.host_ms(r.spans, "eval.read"))
