"""Milliseconds a step keeps the device busy in the traced open loop:
the union of its kernels and copies over the window, per step."""


def read(ctx):
    tr = ctx["trace"]
    return 1e3 * tr.busy_s() / tr.steps if tr.steps else None
