"""95th percentile latency (ms) over every request due in the window, each
timed from when it was due; one still unanswered at the close counts
with its age then.  Open loops only."""
import numpy as np


def read(ctx):
    if ctx.latencies_ms is None or not len(ctx.latencies_ms):
        return None
    return float(np.percentile(ctx.latencies_ms, 95))
