"""Median latency (ms, the paper's mRT) over every request due in the
window, timed as for ``p95_ms``.  Open loops only."""
import numpy as np


def read(ctx):
    if ctx.latencies_ms is None or not len(ctx.latencies_ms):
        return None
    return float(np.median(ctx.latencies_ms))
