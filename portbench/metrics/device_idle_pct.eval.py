"""device_idle_pct.eval: 1 minus the union of the device's activity
intervals over the wall time of a traced pass over the eval pool, as a
percentage (portbench/trace.py)."""


def read(run):
    if run.trace is None or run.cell.traffic["kind"] != "cached_eval":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
