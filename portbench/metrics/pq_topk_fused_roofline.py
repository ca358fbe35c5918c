"""The fused PQTopK kernel's share (%) of its roofline in the traced part:
the least time the part's batches' scoring and selection could take
(``yardstick.pq_topk_work`` at each batch's padded rows: float32 adds
against 67 TFLOP/s, or the codes, S and the answers moved once against
3.35 TB/s, whichever is longer), over the device time of every
``pq_topk_fused_kernel`` launch in the part."""


def read(ctx):
    ops = getattr(ctx, "ops", None)
    sizes = getattr(ctx, "traced_batch_sizes", None)
    if not ops or not sizes:
        return None
    took = sum(op.end_ns - op.start_ns for op in ops
               if "pq_topk_fused_kernel" in op.name) / 1e9
    if not took:
        return None
    y, k = ctx.yardstick, int(ctx.mix["k"])
    max_batch = int(ctx.mix["max_batch"])
    least = sum(y.pq_topk_least_seconds(ctx.cfg, ctx.bucket(n, max_batch),
                                        k)[0] for n in sizes)
    return 100.0 * least / took
