"""Share of the traced window in which no kernel or copy ran on the
device, in percent."""


def read(ctx):
    tr = ctx["trace"]
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
