"""Kernel B1 (``ccl_band``, the connected-component labelling of the
decimated dark mask) against its bound, in percent: the calls' least
time (``benchmark.counts.ccl_bound_s`` at the step's decimated frame
size and the configuration's rounds) over their traced device time."""
from benchmark.counts import ccl_bound_s


def read(ctx):
    calls = [d for n, _, d in ctx["trace"].kernels if "ccl_band" in n]
    if not calls:
        return None
    p = ctx["config"]["pipeline"]
    dec = p["quad_decimate"]
    pixels = ctx["batch"] * (ctx["height"] // dec) * (ctx["width"] // dec)
    bound = len(calls) * ccl_bound_s(pixels, p["ccl_iters"])
    return 100.0 * bound / (sum(calls) * 1e-9)
