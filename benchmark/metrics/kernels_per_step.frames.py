"""Device kernels per frame step in the traced run (copies excluded):
every kernel the trace holds over the replays the traced loop
dispatched (``replays``), its output clones with them. The closed loop's
trace holds more replays than its window's steps: the one completed
before the window opens and those drained after it closes."""


def read(ctx):
    n = ctx.get("replays")
    return len(ctx["trace"].kernels) / n if n else None
