"""95th percentile, in milliseconds, of how late the load generator
handed each batch of the measured window to the step, against its due
time (the harness's own lateness, which the latency includes)."""
import numpy as np


def read(ctx):
    lags = ctx.get("send_lags_s")
    if not lags:
        return None
    return 1e3 * float(np.percentile(lags, 95))
