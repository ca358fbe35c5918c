"""Device ms a batch of every kernel but the PQ kernels
(``pq_topk_fused_kernel``, ``pq_scores_kernel``) in the traced part:
the SASRec backbone, and beside it the sub-id score einsum and the merge
of the kernel's per-tile winners (some microseconds).  Copies and sets
are not kernels and are left out.  Batches are those the harness served
in the part."""
PQ = ("pq_topk_fused_kernel", "pq_scores_kernel")


def read(ctx):
    ops = getattr(ctx, "ops", None)
    batches = len(getattr(ctx, "traced_batch_sizes", ()))
    if not ops or not batches:
        return None
    ns = sum(op.end_ns - op.start_ns for op in ops
             if not any(p in op.name for p in PQ)
             and "memcpy" not in op.name.lower()
             and "memset" not in op.name.lower())
    return ns / 1e6 / batches
