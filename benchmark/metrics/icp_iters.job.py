"""Mean ICP iterations of the window's jobs (``ICPResult.iterations``,
the converging one included): the count the program returns."""


def read(ctx):
    its = ctx.get("icp_iterations")
    return sum(its) / len(its) if its else None
