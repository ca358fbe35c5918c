"""Device ms a batch of the PQ kernels (``pq_topk_fused_kernel``,
``pq_scores_kernel``) in the traced part; batches are those the harness
served in the part."""
PQ = ("pq_topk_fused_kernel", "pq_scores_kernel")


def read(ctx):
    ops = getattr(ctx, "ops", None)
    batches = len(getattr(ctx, "traced_batch_sizes", ()))
    if not ops or not batches:
        return None
    ns = sum(op.end_ns - op.start_ns for op in ops
             if any(p in op.name for p in PQ))
    if not ns:
        return None
    return ns / 1e6 / batches
