"""Serving launcher: paper-mode top-K retrieval over a request stream.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch sasrec-recjpq \
      --reduced --requests 256 --method pqtopk_fused --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --method pqtopk_pruned \
      [--query-grouping | --super-factor 64] --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --mutable \
      --churn-steps 8 [--log-dir DIR [--snapshot-every N] [--recover]] \
      --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --replicas 3 \
      [--chaos] [--no-hedge] --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2 \
      --mutable --churn-steps 4 --log-dir DIR [--crash-replica-at RID:LSN] \
      [--staleness-budget N] --device cuda

Weights are random, drawn from a fixed seed.  ``--device`` defaults to
``cuda`` and the launcher raises when no card is present.  ``--mutable``
serves a catalogue that changes between batches (tombstones, inserts,
re-coded items) through a hot-swapped head, optionally logged to a
durable write-ahead log with snapshots.  ``--replicas K`` serves through
the ``ReplicaRouter`` fabric: K engine replicas on one device, each on
its own worker thread and CUDA stream.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, get_reduced
from repro_torch.core.mutation import MutableHeadState, apply_op
from repro_torch.core.retrieval_head import TOP_ITEMS_METHODS
from repro_torch.models import seqrec
from repro_torch.serving.catalogue_log import CatalogueLog
from repro_torch.serving.engine import Request, RetrievalEngine
from repro_torch.serving.router import ReplicaRouter
from repro_torch.training.fault_tolerance import (ReplicaFaultPlan,
                                                  ServeFaultInjector,
                                                  SimulatedFailure)


def _ms(v) -> str:
    """Latency field for humans; None (no traffic) is 'n/a', never 0.00."""
    return "n/a" if v is None else f"{v:.2f}ms"


def _churn_ops(shadow, rng, n_steps, b):
    """Draw ``n_steps`` valid mutation ops (an update-heavy mix with some
    deletes and inserts), applying each to ``shadow`` as drawn: op i+1's
    validity can depend on op i (no double delete).  The reference
    launcher's mix and draw order, so one seed gives one op stream."""
    ops = []
    for _ in range(n_steps):
        r = rng.random()
        row = rng.integers(0, b, shadow.m)
        live = np.flatnonzero(shadow.live.cpu().numpy())
        live = live[live > 0]                # row 0 is the padding id
        if (r < 0.2 and (shadow.free or shadow.n_rows < shadow.cap)) \
                or live.size <= 1:
            op = ("insert", row)
        elif r < 0.5:
            op = ("delete", int(rng.choice(live)))
        else:
            op = ("update", int(rng.choice(live)), row)
        apply_op(shadow, op)
        ops.append(op)
    return ops


def _print_durable_stats(stats):
    log_st = stats.get("log")
    print(f"durable: committed_lsn={int(stats['committed_lsn'])} "
          f"mutations={int(stats['mutations_applied'])} "
          f"stale_served={int(stats['stale_served'])} "
          f"catchup_events={int(stats['catchup_events'])} "
          f"staleness_budget={int(stats['staleness_budget'])}")
    if log_st is not None:
        print(f"log: lsn={int(log_st['lsn'])} "
              f"bytes={int(log_st['log_bytes'])} "
              f"fsyncs={int(log_st['n_fsyncs'])} "
              f"snapshots={int(log_st['n_snapshots'])} "
              f"latest_snapshot_lsn={int(log_st['latest_snapshot_lsn'])} "
              f"torn_bytes_dropped={int(log_st['torn_bytes_dropped'])}")


def _serve_replicated_mutable(args, params, cfg, dev):
    """K replicas over ONE durable mutable catalogue: mutation batches
    commit through the WAL between request batches, replicas catch up by
    LSN-fenced replay, and the chaos flags exercise replica crash
    (recover-from-log + gated re-admission) and writer crash (torn record;
    the fabric is rebuilt from ``CatalogueLog.recover``)."""
    log = None
    if args.log_dir:
        log = CatalogueLog(args.log_dir, snapshot_every=args.snapshot_every)
    if args.recover:
        mstate, lsn0 = log.recover(device=dev)
        print(f"recovered catalogue from {args.log_dir} at lsn {lsn0} "
              f"(torn bytes dropped: {log.torn_bytes_dropped})")
    else:
        mstate = MutableHeadState.build(
            params["item_emb"]["codes"], cfg.pq.b,
            backend=cfg.pq.bound_backend,
            super_factor=cfg.pq.super_factor, device=dev)
    shadow = mstate.clone()               # the launcher's committed mirror
    crash_plan = []                       # [(lsn, rid)], ascending
    for spec in args.crash_replica_at or []:
        rid, _, lsn = spec.partition(":")
        crash_plan.append((int(lsn), int(rid)))
    crash_plan.sort()

    def mk_router(state, the_log):
        return ReplicaRouter.for_seqrec_mutable(
            params, cfg, state, n_replicas=args.replicas, k=args.k,
            max_batch=args.max_batch, calibrate=not args.no_calibrate,
            log=the_log, hedge=not args.no_hedge,
            staleness_budget=args.staleness_budget, device=dev)

    router = mk_router(mstate, log)
    if args.crash_writer_at is not None:
        log.fail_at_lsn = args.crash_writer_at
    rng = np.random.default_rng(0)
    mrng = np.random.default_rng(1)
    results = []
    t0 = time.monotonic()
    i = 0
    with router:
        router.warmup()
        while i < args.requests:
            hist_len = int(rng.integers(2, cfg.max_seq_len))
            seq = rng.integers(1, cfg.n_items + 1, hist_len)
            router.submit(Request(i, seq, k=args.k))
            i += 1
            if args.churn_steps and i % args.max_batch == 0:
                ops = _churn_ops(shadow, mrng, args.churn_steps, cfg.pq.b)
                try:
                    committed = router.apply_mutations(ops)
                except SimulatedFailure as exc:
                    print(f"chaos: {exc}")
                    break
                while crash_plan and committed >= crash_plan[0][0]:
                    _, rid = crash_plan.pop(0)
                    print(f"chaos: crashing replica {rid} at "
                          f"lsn {committed}")
                    router.crash_replica(rid)
                router.pump()
        results += router.drain()
        if log is not None and not log._crashed:
            log.sync()                    # clean shutdown: nothing buffered
        stats = router.stats()
    if i < args.requests:
        # Writer died mid-append: stand a NEW fabric up from the durable
        # log (torn-tail truncation + snapshot + replay) and finish the
        # stream — the kill-and-recover path, end to end.
        print("rebuilding the fabric from the durable log ...")
        log = CatalogueLog(args.log_dir,
                           snapshot_every=args.snapshot_every)
        state, lsn = log.recover(device=dev)
        print(f"recovered at lsn {lsn} "
              f"(torn bytes dropped: {log.torn_bytes_dropped})")
        shadow = state.clone()
        with mk_router(state, log) as router:
            router.warmup()
            while i < args.requests:
                hist_len = int(rng.integers(2, cfg.max_seq_len))
                seq = rng.integers(1, cfg.n_items + 1, hist_len)
                router.submit(Request(i, seq, k=args.k))
                i += 1
                if args.churn_steps and i % args.max_batch == 0:
                    router.apply_mutations(
                        _churn_ops(shadow, mrng, args.churn_steps,
                                   cfg.pq.b))
                    router.pump()
            results += router.drain()
            log.sync()
            stats = router.stats()
    wall = time.monotonic() - t0
    eng = router.engines[0]
    print(f"served {len(results)} requests in {wall:.2f}s "
          f"({len(results) / wall:.1f} req/s) replicas={args.replicas} "
          f"mutable=True durable={args.log_dir is not None}")
    print(f"p50={_ms(stats['p50_ms'])} p99={_ms(stats['p99_ms'])} "
          f"dup_suppressed={stats['duplicates_suppressed']} "
          f"redispatched={stats['redispatched']} "
          f"degraded={dict(stats['degraded_results'])}")
    _print_durable_stats(stats)
    for rid, rs in stats["replicas"].items():
        print(f"  replica[{rid}] state={rs['state']} "
              f"completed={rs['completed']} "
              f"ejections={rs['ejections']} "
              f"readmissions={rs['readmissions']} "
              f"applied_lsn={rs['applied_lsn']} lag={rs['lag']} "
              f"n_compiles={rs['n_compiles']}")
    if eng.ladder is not None:
        print(f"ladder={eng.ladder} (shared across replicas)")
    return results


def _serve_replicated(args, params, cfg, dev):
    """Drive the ReplicaRouter fabric: K engine replicas behind one
    submit/pump/drain loop, optionally under a deterministic chaos plan."""
    fault_plans = None
    if args.chaos:
        # Replica 1 dies for a few dispatches (ejection + re-dispatch +
        # half-open re-admission); replica 2, when present, straggles
        # (hedging + straggler strikes).  Indices are per-replica dispatch
        # counters, so the schedule is reproducible under any interleaving.
        fault_plans = {1: ReplicaFaultPlan(crash_windows=((1, 4),))}
        if args.replicas > 2:
            fault_plans[2] = ReplicaFaultPlan(slow_windows=((0, 3),),
                                              slow_ms=250.0)
    router = ReplicaRouter.for_seqrec(
        params, cfg, n_replicas=args.replicas, k=args.k,
        max_batch=args.max_batch, method=args.method,
        calibrate=not args.no_calibrate, device=dev,
        fault_plans=fault_plans, hedge=not args.no_hedge)
    rng = np.random.default_rng(0)
    with router:
        router.warmup()
        t0 = time.monotonic()
        for i in range(args.requests):
            hist_len = int(rng.integers(2, cfg.max_seq_len))
            seq = rng.integers(1, cfg.n_items + 1, hist_len)
            router.submit(Request(i, seq, k=args.k))
            router.pump()
        results = router.drain()
        wall = time.monotonic() - t0
        stats = router.stats()
    eng = router.engines[0]
    print(f"served {len(results)} requests in {wall:.2f}s "
          f"({len(results) / wall:.1f} req/s) replicas={args.replicas} "
          f"method={eng.method} chaos={args.chaos}")
    print(f"p50={_ms(stats['p50_ms'])} p99={_ms(stats['p99_ms'])} "
          f"hedges={stats['hedges']} hedge_wins={stats['hedge_wins']} "
          f"dup_suppressed={stats['duplicates_suppressed']} "
          f"redispatched={stats['redispatched']}")
    print(f"degrade_level={stats['degrade_level']} "
          f"degrade_events={stats['degrade_events']} "
          f"recover_events={stats['recover_events']} "
          f"shed_load={stats['shed_load']} "
          f"degraded={dict(stats['degraded_results'])}")
    for rid, rs in stats["replicas"].items():
        print(f"  replica[{rid}] state={rs['state']} "
              f"dispatched={rs['dispatched']} completed={rs['completed']} "
              f"failures={rs['failures']} stragglers={rs['stragglers']} "
              f"ejections={rs['ejections']} "
              f"readmissions={rs['readmissions']} "
              f"n_compiles={rs['n_compiles']}")
    if eng.ladder is not None:
        print(f"ladder={eng.ladder} (shared across replicas)")
    return results


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
    ap.add_argument("--super-factor", type=int, default=None,
                    help="hierarchical super-tile factor for the pruned "
                         "cascade (overrides the arch config's PQConfig): "
                         "groups of this many child tiles get OR-ed/"
                         "hulled pass-0 metadata; 0 disables the level "
                         "(mutually exclusive with --query-grouping)")
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
    ap.add_argument("--mutable", action="store_true",
                    help="serve through a MutableHeadState (power-of-two "
                         "capacity + tombstone mask): the catalogue "
                         "mutates between batches and the engine hot-swaps "
                         "the head without new serve variants (forces the "
                         "pqtopk_pruned route)")
    ap.add_argument("--churn-steps", type=int, default=0,
                    help="with --mutable: catalogue mutations (update/"
                         "delete/insert mix) applied and hot-swapped "
                         "between every served batch")
    ap.add_argument("--log-dir", default=None,
                    help="with --mutable: every mutation commits to a "
                         "checksummed write-ahead log in this directory "
                         "(LSN-keyed snapshots beside it) before the swap")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="with --log-dir: a snapshot every N committed "
                         "mutations (0: only the first one)")
    ap.add_argument("--recover", action="store_true",
                    help="with --log-dir: start from the newest valid "
                         "snapshot + log-tail replay instead of a fresh "
                         "catalogue (torn log tails are cut)")
    ap.add_argument("--crash-writer-at", type=int, default=None,
                    metavar="LSN",
                    help="chaos, with --log-dir: the append of this LSN "
                         "writes half a record and fails; serving goes on "
                         "and a later --recover run replays the log")
    ap.add_argument("--replicas", type=int, default=1,
                    help="> 1 serves through the ReplicaRouter fabric: "
                         "pipelined dispatch over health-checked engine "
                         "replicas (one worker thread and CUDA stream "
                         "each) with hedging and the load-adaptive "
                         "degradation ladder")
    ap.add_argument("--chaos", action="store_true",
                    help="with --replicas: install a deterministic "
                         "ReplicaFaultPlan (a crash window on replica 1, "
                         "a straggle window on replica 2 when present)")
    ap.add_argument("--no-hedge", action="store_true",
                    help="with --replicas: disable hedged dispatch")
    ap.add_argument("--staleness-budget", type=int, default=0,
                    help="with --mutable --replicas: max LSNs a replica may "
                         "lag the committed catalogue before its results "
                         "are tagged stale_catalogue and it is "
                         "deprioritised (and re-admission is gated)")
    ap.add_argument("--crash-replica-at", action="append", default=None,
                    metavar="RID:LSN",
                    help="chaos, with --mutable --replicas --log-dir: crash "
                         "replica RID (drop its in-memory catalogue) once "
                         "the committed LSN reaches LSN; it must recover "
                         "from the log before the health FSM re-admits it "
                         "(repeatable)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.log_dir and not args.mutable:
        raise SystemExit("--log-dir logs catalogue mutations; it needs "
                         "--mutable")
    if args.recover and not args.log_dir:
        raise SystemExit("--recover replays a durable log; it needs "
                         "--log-dir")
    if args.snapshot_every and not args.log_dir:
        raise SystemExit("--snapshot-every needs --log-dir")
    if args.crash_writer_at is not None and not args.log_dir:
        raise SystemExit("--crash-writer-at tears a WAL record; it needs "
                         "--log-dir")
    if args.crash_replica_at and not (args.mutable and args.replicas > 1
                                      and args.log_dir):
        raise SystemExit("--crash-replica-at needs --mutable, --replicas "
                         "> 1 and --log-dir (recovery replays the log)")
    if args.replicas > 1:
        if args.fail_at or args.slow_at:
            raise SystemExit("--fail-at/--slow-at inject inside ONE engine; "
                             "replica-level chaos is --chaos")
        if (args.mutable or args.churn_steps) and args.chaos:
            raise SystemExit("--chaos drives the immutable fabric; durable "
                             "chaos is --crash-replica-at / "
                             "--crash-writer-at")
    elif args.chaos:
        raise SystemExit("--chaos needs --replicas > 1")
    if args.churn_steps and not args.mutable:
        raise SystemExit("--churn-steps requires --mutable")
    if args.mutable and args.method not in (None, "pqtopk_pruned"):
        raise SystemExit("--mutable serves the tombstone-masked pruned "
                         f"cascade; --method {args.method} has no live-"
                         "mask route")
    dev = resolve_device(args.device)
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
    if args.super_factor is not None:
        pq_overrides["super_factor"] = args.super_factor
    if pq_overrides:
        cfg = replace(cfg, pq=replace(cfg.pq, **pq_overrides))
    params = seqrec.init_seqrec(torch.Generator().manual_seed(0), cfg)
    if args.replicas > 1:
        if args.mutable:
            if cfg.pq is None:
                raise SystemExit(f"arch {args.arch!r} has no PQ head; "
                                 "--mutable needs sub-item codes to mutate")
            return _serve_replicated_mutable(args, params, cfg, dev)
        return _serve_replicated(args, params, cfg, dev)
    faults = None
    if args.fail_at or args.slow_at:
        faults = ServeFaultInjector(fail_at_batches=tuple(args.fail_at or ()),
                                    fail_repeats=args.fail_repeats,
                                    slow_at_batches=tuple(args.slow_at or ()),
                                    slow_ms=args.slow_ms)
    mstate, log = None, None
    if args.mutable:
        if cfg.pq is None:
            raise SystemExit(f"arch {args.arch!r} has no PQ head; --mutable "
                             "needs sub-item codes to mutate")
        if args.log_dir:
            log = CatalogueLog(args.log_dir,
                               snapshot_every=args.snapshot_every)
            log.fail_at_lsn = args.crash_writer_at
        if args.recover:
            mstate, lsn0 = log.recover(device=dev)
            print(f"recovered catalogue from {args.log_dir} at lsn {lsn0} "
                  f"(torn bytes dropped: {log.torn_bytes_dropped})")
        else:
            mstate = MutableHeadState.build(
                params["item_emb"]["codes"], cfg.pq.b,
                backend=cfg.pq.bound_backend,
                super_factor=cfg.pq.super_factor, device=dev)
        if log is not None and log.latest_snapshot_lsn() is None:
            log.snapshot(mstate)          # recovery needs a base snapshot
        engine = RetrievalEngine.for_seqrec_mutable(
            params, cfg, mstate, k=args.k, max_batch=args.max_batch,
            device=dev, calibrate=not args.no_calibrate, faults=faults,
            max_retries=args.max_retries)
    else:
        engine = RetrievalEngine.for_seqrec(params, cfg, k=args.k,
                                            max_batch=args.max_batch,
                                            method=args.method, device=dev,
                                            faults=faults,
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

    def churn(step_rng):
        # Mutations only loosen bounds (inserts are exact), so the swapped
        # head stays exact.  With --log-dir the ops commit to the log (and
        # snapshots follow --snapshot-every) before the swap.
        ops = _churn_ops(mstate, step_rng, args.churn_steps, cfg.pq.b)
        if log is not None:
            try:
                log.append_many(ops)
                log.maybe_snapshot(mstate)
            except SimulatedFailure as exc:
                # A torn record on disk: keep serving the in-memory state;
                # a --recover run replays the log up to the tear.
                print(f"chaos: {exc}")
                args.churn_steps = 0
        engine.swap_head_state(mstate)

    t0 = time.monotonic()
    results = []
    for i in range(args.requests):
        hist_len = int(rng.integers(2, cfg.max_seq_len))
        seq = rng.integers(1, cfg.n_items + 1, hist_len)
        engine.submit(Request(i, seq, k=args.k))
        if len(engine.batcher.queue) >= args.max_batch:
            results += engine.drain()
            if mstate is not None and args.churn_steps:
                churn(rng)
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
    if mstate is not None:
        ms = mstate.stats()
        print(f"catalogue: capacity={int(ms['capacity'])} "
              f"n_live={int(ms['n_live'])} "
              f"n_mutations={int(ms['n_mutations'])} "
              f"stale_tiles={int(ms['stale_tiles'])} "
              f"n_swaps={int(stats['n_swaps'])}")
    if log is not None:
        log.close()
        ls = log.stats()
        print(f"log: lsn={int(ls['lsn'])} bytes={int(ls['log_bytes'])} "
              f"fsyncs={int(ls['n_fsyncs'])} "
              f"snapshots={int(ls['n_snapshots'])} "
              f"latest_snapshot_lsn={int(ls['latest_snapshot_lsn'])}")
    if engine.ladder is not None:
        print(f"ladder={engine.ladder} "
              f"rung_hit_fraction={stats['rung_hit_fraction']:.2f} "
              f"rung_counts={stats['rung_counts']}")
    return results


if __name__ == "__main__":
    main()
