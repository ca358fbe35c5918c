"""Requests answered in the window, over the window's seconds (a backlog's
window closes with the first batch that ends past ``--seconds``)."""


def read(ctx):
    return ctx.completed / ctx.elapsed_s
