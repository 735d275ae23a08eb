"""Host-made device idle inside ``register_clouds``, in ms a job: for each
of the program's ``reg.entry`` spans in the traced window, its length
minus the device-busy time inside it, less the idle that lies inside its
``read.*`` spans; summed and divided by the window's jobs.

Idle inside a read is not the host's doing: there the host waits on work
already queued on the device, so the trace shows idle only where it
leaves device work out (a CUDA graph's WHILE node is recorded on its
first trip alone) or for the wake-up after the last kernel."""
from benchmark.spans import idle_ns, window_spans


def read(ctx):
    tr = ctx["trace"]
    entries = window_spans(tr, "reg.entry")
    if not entries or not tr.steps:
        return None
    busy = tr.busy_intervals()
    reads = {}
    for r in window_spans(tr, "read."):
        reads[r.job] = reads.get(r.job, 0) + idle_ns(busy, r)
    return sum(idle_ns(busy, s) - reads.get(s.job, 0)
               for s in entries) * 1e-6 / tr.steps
