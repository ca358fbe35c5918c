"""Model FLOPs of the requests answered in the window
(``yardstick.request_flops`` over each one's real history length), over
the window's seconds times the float32 peak of 67 TFLOP/s, in %.  Taken
from the untraced window, so the profiler costs it nothing."""


def read(ctx):
    lengths = ctx.request_lengths
    if not len(lengths) or not ctx.elapsed_s:
        return None
    y = ctx.yardstick
    flops = float(y.request_flops(ctx.cfg, lengths).sum())
    return 100.0 * flops / (ctx.elapsed_s * y.F32_FLOP_PER_S)
