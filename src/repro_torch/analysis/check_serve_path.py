"""Guard: the pruned engines read the host and launch kernels per batch
exactly as documented, and the analysis tells a host-orchestrated route
apart.

    python -m repro_torch.analysis.check_serve_path [--device cuda|cpu|meta]

The twin of the reference's ``scripts/check_single_dispatch.py``, kept
inside the package.  Eager PyTorch cannot make a serve path one dispatch,
so the port's guard holds each engine to its documented host reads and
launches per batch (``entrypoints.DOCUMENTED``):

1. the ``engine_aot`` and ``engine_aot_grouped`` entrypoints under every
   default pass, and their recorded reads and launches equal to the
   documented ones;
2. the negative control: the host two-pass cascade
   (``pruning.cascade_topk``: ``nonzero`` and a copy of the survivors to
   the host, outside ``cost.host_read``) must fail ``host-reads``, and
   no other pass.

Exits non-zero on any violation.
"""
from __future__ import annotations

import argparse
import sys

ENGINES = ("engine_aot", "engine_aot_grouped")
NEGATIVE = "host_cascade_negative_control"


def build_host_cascade(device: str):
    """The host cascade as an entrypoint, documented as the batch-any
    cascade is (one read, the seed's scores and one fused launch)."""
    from repro_torch.analysis import entrypoints as ep
    from repro_torch.core import retrieval_head
    from repro_torch.models import seqrec as seqrec_lib

    fx = ep.seqrec_fixture()
    cfg = fx.cfg

    def make_args(dev):
        return ep._on(fx.params, dev), ep._seqs(cfg, dev)

    def host_cascade(params, seqs):
        phi = seqrec_lib.sequence_embedding(params, seqs, cfg)
        return retrieval_head.top_items_pruned(params["item_emb"], phi, ep.K)

    return ep.BuiltEntry(host_cascade, make_args,
                         **ep._expect("flat_pruned"),
                         notes="the host two-pass cascade (nonzero, then "
                               "the survivors copied to the host)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check_serve_path",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    choices=("cuda", "cpu", "meta"))
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.analysis import run_default
    from repro_torch.analysis import entrypoints as ep
    from repro_torch.analysis.core import run_analysis
    from repro_torch.analysis.passes import default_passes

    if args.device == "cuda":
        resolve_device("cuda")
    report = run_default(entrypoints=list(ENGINES), device=args.device)
    print(report.render())
    if not report.ok:
        print("FAIL: a pruned engine breaks a serve-path invariant")
        return 1
    for name in ENGINES:
        info = report.result(name, "host-reads").info
        kernels, reads = ep.DOCUMENTED[name][:2]
        if info.get("host_reads") != reads or info.get("launches") != kernels:
            print(f"FAIL: {name} read the host {info.get('host_reads')} "
                  f"time(s) and launched {info.get('launches')}; documented "
                  f"{reads} and {kernels}")
            return 1

    neg = ep.Entrypoint(NEGATIVE, "the host two-pass cascade",
                        build_host_cascade)
    build_on = "cpu" if args.device == "meta" else args.device
    neg_report = run_analysis({NEGATIVE: neg}, default_passes(),
                              lambda _n: build_host_cascade(build_on),
                              args.device)
    failing = neg_report.failing_passes(NEGATIVE)
    if failing != ["host-reads"]:
        print(neg_report.render())
        print(f"FAIL: the host cascade should fail exactly ['host-reads'], "
              f"failed {failing}: the analysis cannot tell it apart")
        return 1
    print("negative control: the host two-pass cascade fails host-reads "
          "(and only host-reads) as expected")
    print("OK: the pruned engines (batch-any and grouped) read the host "
          "and launch their kernels per batch as documented")
    return 0


if __name__ == "__main__":
    sys.exit(main())
