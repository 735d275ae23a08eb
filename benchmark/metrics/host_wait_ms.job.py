"""Ms a job the host waits on reads of the device inside
``register_clouds``: the summed lengths of the program's ``read.*``
spans in the traced window, divided by its jobs."""
from benchmark.spans import window_spans


def read(ctx):
    tr = ctx["trace"]
    reads = window_spans(tr, "read.")
    if not reads or not tr.steps:
        return None
    return sum(s.end_ns - s.start_ns for s in reads) * 1e-6 / tr.steps
