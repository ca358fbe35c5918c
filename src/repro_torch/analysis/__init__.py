"""Serve-path analysis of the PyTorch port: what each registered route
does per batch, held to what it documents (the twin of the reference's
``repro.analysis``).

Quick use::

    python -m repro_torch.analysis                 # on the card
    python -m repro_torch.analysis --device cpu    # or meta
    python -m repro_torch.analysis --list
    python -m repro_torch.analysis -e flat_pruned --json report.json

Programmatic::

    from repro_torch.analysis import run_default
    report = run_default(entrypoints=["flat_pruned"], device="cpu")
    assert report.ok, report.render()

The reference traces each route into a jaxpr; the port runs each route's
batch, once on meta tensors and once on its device (``core.EntryContext``).

The documented counts per batch (``entrypoints.DOCUMENTED``; forms of the
fused kernel: (a)/(b) a 1D slot list, (c) a 2D table, (d) the ``live``
mask; uploads: blocking copies from the host to the device, on meta and
on the card, an engine's or router's pageable upload of the batch;
syncs: the sync-debug warnings on the card, the route's reads + 1 for a
caller's copy of a route's outputs + the uploads; an engine's wait on
its CUDA event is not reported)::

    entry                               launches            reads ups syncs
    flat_fused                          (a) 1               0     0   1
    flat_pruned, sharded_pruned,
      lm_decode_step                    pq_scores 1, (b) 1  1     0   2
    grouped_perquery                    (c) 1               1     0   2
    flat_hier, sharded_hier             pq_scores 1, (b) 1  2     0   3
    pruned_tiles_kernel                 (b) 1               0     0   1
    grouped_tiles_kernel                (c) 1               0     0   1
    engine_aot, router_replicated       pq_scores 1, (b) 1  1     1   2
    engine_aot_grouped                  (c) 1               1     1   2
    flat_tombstone                      pq_scores 1, (d) 1  1     0   2
    tombstone_tiles_kernel              (d) 1               0     0   1
    engine_mutable, router_durable      pq_scores 1, (d) 1  1     1   2

An adaptive seed adds one read per growth stage (no entry seeds
adaptively).

The passes and the reference passes they stand for: ``host-reads`` for
``dispatch-count``, ``host-transfer`` for ``host-transfer``,
``variants`` for ``recompile-hazard``, ``kernel-contract`` for
``kernel-contract``, ``ast-lint`` for ``ast-lint``.  Reference checks
with no counterpart, and why: callback primitives (every line of an
eager route is Python, so nothing compiled re-enters it; what a callback
costs, a synchronization, ``host-reads`` counts), the VMEM budget (the
H100's shared-memory fit replaces it), lane and sublane tiling (the
kernels take any N and B and mask a ragged tile; the plan's 16-byte
offsets replace it), the static grid (a CUDA grid is sized per launch on
the host and keys no compile) and the jaxpr walker (no jaxpr).
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.analysis.core import (AnalysisPass, EntryContext, Finding,
                                       PassResult, Report, RunRecord,
                                       SEV_ERROR, SEV_INFO, STATUS_FAIL,
                                       STATUS_PASS, STATUS_SKIP,
                                       run_analysis)

__all__ = ["AnalysisPass", "EntryContext", "Finding", "PassResult",
           "Report", "RunRecord", "SEV_ERROR", "SEV_INFO", "STATUS_FAIL",
           "STATUS_PASS", "STATUS_SKIP", "run_analysis", "run_default"]


def run_default(entrypoints: Optional[Sequence[str]] = None,
                passes: Optional[Sequence[str]] = None, *,
                device: str = "cuda", fixture=None) -> Report:
    """Run the default pass list over the registry (optionally filtered
    by entrypoint / pass name) on ``device`` ("cuda", "cpu" or "meta";
    meta builds each entry on the CPU and runs it on meta only).
    ``fixture`` (an ``entrypoints.Fixture``) replaces the reduced seqrec
    model."""
    from repro_torch.analysis import entrypoints as ep
    from repro_torch.analysis.passes import default_passes

    names = list(entrypoints) if entrypoints else list(ep.REGISTRY)
    unknown = [n for n in names if n not in ep.REGISTRY]
    if unknown:
        raise KeyError(f"unknown entrypoint(s) {unknown}; registered: "
                       f"{sorted(ep.REGISTRY)}")
    plist = default_passes()
    if passes:
        unknown_p = [p for p in passes
                     if p not in {x.name for x in plist}]
        if unknown_p:
            raise KeyError(f"unknown pass(es) {unknown_p}; available: "
                           f"{sorted(x.name for x in plist)}")
        plist = [x for x in plist if x.name in set(passes)]
    build_on = "cpu" if device == "meta" else device
    return run_analysis({n: ep.REGISTRY[n] for n in names}, plist,
                        lambda n: ep.build(n, build_on, fixture), device)
