"""Share (%) of the traced part in which no kernel, copy or set ran on
the device: 1 - (union of their intervals) / the part's length."""


def read(ctx):
    if not getattr(ctx, "window_s", 0):
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
