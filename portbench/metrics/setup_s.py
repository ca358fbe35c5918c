"""Seconds from the process's start to the window's first request:
imports, the CUDA context, weights and histories made from the seed, the
engine's build (and a first run's kernel build) and the warm-up."""


def read(ctx):
    return ctx.setup_s
