"""Mean rounds kernel B1's connected-component labelling ran for an image
in the traced run: the program's CCL counter (rounds summed over images,
and images) read before and after it. Nothing for a program without the
counter, or where the traced run launched no B1."""


def read(ctx):
    c = ctx.get("ccl_counts")
    if not c or not c.get("images"):
        return None
    return c["rounds"] / c["images"]
