"""Seconds the program spent capturing its compiled steps (warm-up and
recording, every function, ``core.jit.CAPTURES``) from process start to
the read: set-up's captures, and any the window or the trace made."""
from benchmark.spans import captures


def read(ctx):
    return captures().get("seconds")
