"""Serving launcher: paper-mode top-K retrieval over a request stream.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch sasrec-recjpq \
      --reduced --requests 256 --method pqtopk_fused --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --method pqtopk_pruned \
      [--query-grouping] --device cuda

Weights are random, drawn from a fixed seed.  ``--device`` defaults to
``cuda`` and the launcher raises when no card is present.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_reduced
from repro_torch.core.retrieval_head import TOP_ITEMS_METHODS
from repro_torch.models import seqrec
from repro_torch.serving.engine import Request, RetrievalEngine
from repro_torch.training.fault_tolerance import ServeFaultInjector


def _ms(v) -> str:
    """Latency field for humans; None (no traffic) is 'n/a', never 0.00."""
    return "n/a" if v is None else f"{v:.2f}ms"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="sasrec-recjpq")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--method", default=None, choices=TOP_ITEMS_METHODS,
                    help="scoring route; default: the arch config's "
                         "serve_method.  pqtopk_pruned = the pruned cascade "
                         "(upper-bound tile skipping)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--seed-policy", default=None,
                    choices=["greedy", "adaptive"],
                    help="theta-seeding policy for the pruned cascade "
                         "(overrides the arch config's PQConfig)")
    ap.add_argument("--bound-backend", default=None,
                    choices=["bitmask", "range"],
                    help="pruned-cascade bound backend (overrides the arch "
                         "config's PQConfig): bitmask = code-presence "
                         "sets; range = int16 min/max code ranges")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="disable the build-time slot-budget ladder "
                         "calibration for the pruned cascade (serve the "
                         "full-length compacted buffer instead)")
    ap.add_argument("--query-grouping", action="store_true",
                    help="per-query pruned survival (pqtopk_pruned only): "
                         "seed theta per query, bucket queries by "
                         "survivor-set overlap, and score each group's "
                         "compacted tile list")
    ap.add_argument("--n-groups", type=int, default=None,
                    help="query-group count for --query-grouping "
                         "(default: the arch config's PQConfig.n_groups; "
                         "1 recovers the batch-any route)")
    ap.add_argument("--fail-at", type=int, action="append", default=None,
                    help="batch indices whose dispatch raises a "
                         "SimulatedFailure (repeatable); the engine retries "
                         "and sheds after --max-retries")
    ap.add_argument("--fail-repeats", type=int, default=1,
                    help="consecutive failing attempts per --fail-at batch")
    ap.add_argument("--slow-at", type=int, action="append", default=None,
                    help="batch indices delayed by --slow-ms (synthetic "
                         "stragglers; flagged in stats)")
    ap.add_argument("--slow-ms", type=float, default=50.0)
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = arch.model
    pq_overrides = {}
    if args.seed_policy is not None:
        pq_overrides["seed_policy"] = args.seed_policy
    if args.bound_backend is not None:
        pq_overrides["bound_backend"] = args.bound_backend
    if args.query_grouping:
        pq_overrides["query_grouping"] = True
    if args.n_groups is not None:
        pq_overrides["n_groups"] = args.n_groups
    if pq_overrides:
        cfg = replace(cfg, pq=replace(cfg.pq, **pq_overrides))
    params = seqrec.init_seqrec(torch.Generator().manual_seed(0), cfg)
    faults = None
    if args.fail_at or args.slow_at:
        faults = ServeFaultInjector(fail_at_batches=tuple(args.fail_at or ()),
                                    fail_repeats=args.fail_repeats,
                                    slow_at_batches=tuple(args.slow_at or ()),
                                    slow_ms=args.slow_ms)
    engine = RetrievalEngine.for_seqrec(params, cfg, k=args.k,
                                        max_batch=args.max_batch,
                                        method=args.method,
                                        device=args.device, faults=faults,
                                        max_retries=args.max_retries,
                                        calibrate=not args.no_calibrate)
    rng = np.random.default_rng(0)
    # Warm up each padding bucket (first kernel use builds the library).
    for b in (1, args.max_batch):
        for i in range(b):
            engine.submit(Request(-1 - i, rng.integers(1, cfg.n_items + 1, 4),
                                  k=args.k))
        engine.drain()
    engine.latencies_ms.clear()
    engine.timeouts = 0

    t0 = time.monotonic()
    results = []
    for i in range(args.requests):
        hist_len = int(rng.integers(2, cfg.max_seq_len))
        seq = rng.integers(1, cfg.n_items + 1, hist_len)
        engine.submit(Request(i, seq, k=args.k))
        if len(engine.batcher.queue) >= args.max_batch:
            results += engine.drain()
    results += engine.drain()
    wall = time.monotonic() - t0
    stats = engine.stats()
    print(f"served {len(results)} requests in {wall:.2f}s "
          f"({len(results) / wall:.1f} req/s) method={engine.method} "
          f"device={engine.device}")
    print(f"mRT={_ms(stats['mRT_ms'])} p99={_ms(stats['p99_ms'])} "
          f"timeouts={int(stats['timeouts'])} "
          f"n_compiles={int(stats['n_compiles'])} "
          f"retried={int(stats['retried'])} shed={int(stats['shed'])} "
          f"stragglers={int(stats['stragglers'])}")
    if engine.ladder is not None:
        print(f"ladder={engine.ladder} "
              f"rung_hit_fraction={stats['rung_hit_fraction']:.2f} "
              f"rung_counts={stats['rung_counts']}")
    return results


if __name__ == "__main__":
    main()
