"""Device kernels per registration job in the traced window (copies
excluded): every stage's replayed graph and the eager work between."""


def read(ctx):
    tr = ctx["trace"]
    return len(tr.kernels) / tr.steps if tr.steps else None
