"""Seconds of the first call of the cell's compiled step in set-up (the
kernel library's load or build and the graph's capture), host clock."""


def read(ctx):
    return ctx.get("warm_call_s")
