"""Mean requests a batch that the engine answered in the window held, over
the mix's ``max_batch``, in %: counted by the harness on the host from
what each ``run_once`` returned, over the untraced window."""


def read(ctx):
    sizes = ctx.batch_sizes
    if not sizes:
        return None
    return 100.0 * sum(sizes) / len(sizes) / int(ctx.mix["max_batch"])
