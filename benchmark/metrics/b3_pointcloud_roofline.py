"""Kernel B3 (``pointcloud``, depth and colour to the planar cloud)
against its bound, in percent: the calls' least time
(``benchmark.counts.pointcloud_bound_s`` at the step's frames) over
their traced device time."""
import re

from benchmark.counts import pointcloud_bound_s

NAME = re.compile(r"\bpointcloud\(")


def read(ctx):
    calls = [d for n, _, d in ctx["trace"].kernels if NAME.search(n)]
    if not calls:
        return None
    pixels = ctx["batch"] * ctx["height"] * ctx["width"]
    return 100.0 * len(calls) * pointcloud_bound_s(pixels) / (
        sum(calls) * 1e-9)
