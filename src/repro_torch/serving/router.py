"""Replicated serving fabric: a ``ReplicaRouter`` fronts K identical
``RetrievalEngine`` replicas behind the single-engine submit/drain/stats
API — the port of the reference's ``serving/router.py``:

* **Pipelined dispatch** — each replica is owned by one worker thread that
  keeps up to ``dispatch_depth`` batches in flight (the host pads and
  queues batch N+1 while the card still runs batch N), and a partial batch
  dispatches once its oldest request has waited ``max_wait_ms``.
* **Health-checked failover** — a per-replica state machine (healthy ->
  suspect on straggler/failure strikes -> ejected) with half-open probe
  re-admission after an exponentially backed-off cooldown.  Work in
  flight on a dead replica is re-dispatched to a healthy one; a request is
  never lost and never answered twice.
* **Hedged dispatch** — a batch outstanding longer than the observed p99
  job time (floored at ``hedge_floor_ms``) is re-issued to a second
  healthy replica; the first completion wins and the loser's results are
  suppressed by request id.
* **Load-adaptive degradation** — a watermark ladder on total queue depth:
  level 1 caps the batch k, level 2 also pins the pruned cascade to its
  cheapest calibrated rung, level 3 sheds new work.  Every result served
  below full fidelity carries a ``Result.degraded`` tag; recovery waits
  for ``recover_patience`` passes below the low watermark.
* **Durable versioned mutation** — a fabric over a mutable catalogue
  (:meth:`ReplicaRouter.for_seqrec_mutable`) takes mutations through one
  entry, :meth:`ReplicaRouter.apply_mutations`: each op is validated on
  the writer state and appended to the ``CatalogueLog`` before any replica
  applies it; every worker replays the op batches between dispatches,
  LSN-fenced (a duplicate is skipped, a gap recovers snapshot + tail from
  the log).  A ``Result`` carries its replica's applied LSN; a replica
  lagging past ``staleness_budget`` is deprioritised and its results are
  tagged ``stale_catalogue``; a crashed replica is re-admitted only after
  it has caught up.

Threading: each engine is touched by exactly one worker thread, which
makes the engine's CUDA stream current (``RetrievalEngine.stream``), so
its batches, its catalogue's in-place writes and its recoveries are queued
on that stream in the order the worker issues them.  The scheduler (health,
assignment, hedging, the ladder) runs on the caller's thread inside
:meth:`ReplicaRouter.pump` / :meth:`ReplicaRouter.drain`.  The cross-thread
structures are the per-replica job and mutation queues and the shared
completion-event queue.  The replicas share the parameter tensors, read
only.

Where the port differs from the reference: a ``MutableHeadState`` is
written in place (``core/mutation.py``), so each replica owns a full copy
of the catalogue tensors, the writer state is another, and a state a
replica drops after a recovery first has its tensors recorded on the
replica's stream (``Tensor.record_stream``), so the caching allocator does
not hand their memory out while batches queued on that stream still read
it.  ``warmup`` runs each replica's variants once on its worker (the first
kernel use builds and loads the library), where the reference compiles
them.  ``for_seqrec(sharded_mesh=...)`` gives every replica the same
shard mesh and the same read-only per-shard blocks of the catalogue;
sharded replicas have no pinned route, so the load ladder degrades them by
the k cap alone.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.mutation import MutableHeadState, apply_op
from repro_torch.core.pruning import ARRAY_FIELDS
from repro_torch.serving.engine import (InFlightBatch, MicroBatcher, Request,
                                        Result, RetrievalEngine)
from repro_torch.training.fault_tolerance import (ReplicaFaultPlan,
                                                  SimulatedFailure)

_STOP = object()

HEALTHY, SUSPECT, EJECTED, PROBING = "healthy", "suspect", "ejected", "probing"

# Longest a replica's warmup may take (the first kernel use builds the
# library with nvcc) before ``warmup`` raises instead of hanging.
_WARMUP_TIMEOUT_S = 600.0

@dataclass
class _Job:
    """One batch's worth of work as handed to a replica worker.  A hedge
    re-issue is a second ``_Job`` with the same ``job_id`` (duplicate
    results are suppressed by request id at delivery)."""
    job_id: int
    requests: List[Request]
    k_cap: Optional[int]
    rung_pin: bool
    replica: int
    hedged: bool = False


@dataclass
class _Warmup:
    """Run these (bucket, k, pinned) variants once on the worker, then set
    ``done``."""
    keys: List[tuple]
    done: threading.Event = field(default_factory=threading.Event)


@dataclass
class _JobState:
    """Scheduler-side view of one logical job across all its copies."""
    requests: List[Request]
    k_cap: Optional[int]
    rung_pin: bool
    replica: int                      # replica of the primary copy
    copies: int = 1                   # live copies in flight
    hedged: bool = False
    attempts: int = 0                 # failed-and-redispatched count
    first_dispatch_t: float = 0.0


@dataclass
class _Event:
    kind: str                         # "done" | "fail"
    job: _Job
    results: List[Result]
    replica: int
    straggler: bool = False
    lsn: int = -1                     # replica's applied LSN at dispatch
    stale: bool = False               # lag exceeded the staleness budget


@dataclass
class ReplicaState:
    """Health state machine for one replica.  Transitions happen only on
    the scheduler thread:

    healthy --strikes>=suspect_after--> suspect
            --strikes>=eject_after-->   ejected  (in-flight work
                                                  re-dispatched on failure)
    ejected --cooldown elapsed-->       probing  (half-open: ONE job)
    probing --probe succeeds-->         healthy  (re-admitted, cooldown
                                                  reset)
            --probe fails-->            ejected  (cooldown doubles)
    """
    state: str = HEALTHY
    strikes: int = 0
    cooldown_ms: float = 100.0
    ejected_at: float = 0.0
    probe_outstanding: bool = False
    inflight: int = 0                 # jobs assigned, not yet resolved
    dispatched: int = 0
    completed: int = 0
    failures: int = 0
    stragglers: int = 0
    ejections: int = 0
    readmissions: int = 0


def _tensors(mstate: MutableHeadState):
    st = mstate.state
    return [mstate.codes, mstate.live] + [getattr(st, f) for f in ARRAY_FIELDS
                                          if getattr(st, f) is not None]


class ReplicaRouter:
    """Route requests across K ``RetrievalEngine`` replicas (same model,
    same serving route) with failover, hedging and graceful degradation.
    API mirrors the single engine: :meth:`submit`, :meth:`drain`,
    :meth:`stats`; :meth:`pump` runs one scheduling pass for callers
    driving their own loop.  Use as a context manager (or call
    :meth:`close`) to join the worker threads.

    Beside ``stats()`` (the reference's keys), ``readmit_ms`` lists each
    re-admission as (replica, ms since it was ejected), and
    ``recovery_ms`` each log recovery's time (snapshot + replay).  A
    worker that dies on an unexpected error makes the next :meth:`pump`
    raise, instead of :meth:`drain` waiting out its stall timeout."""

    def __init__(self, engines: Sequence[RetrievalEngine], *,
                 dispatch_depth: int = 2,
                 max_batch: Optional[int] = None,
                 max_wait_ms: float = 2.0,
                 fault_plans: Optional[Dict[int, ReplicaFaultPlan]] = None,
                 suspect_after: int = 1, eject_after: int = 3,
                 cooldown_ms: float = 100.0,
                 hedge: bool = True, hedge_floor_ms: float = 50.0,
                 max_redispatch: Optional[int] = None,
                 degrade_high: int = 256, degrade_low: int = 64,
                 degrade_k_cap: Optional[int] = None,
                 degrade_patience: int = 1, recover_patience: int = 3,
                 replica_states: Optional[Sequence[MutableHeadState]] = None,
                 log: Optional[Any] = None,
                 staleness_budget: int = 0):
        if not engines:
            raise ValueError("need at least one replica engine")
        self.engines = list(engines)
        self.n_replicas = len(self.engines)
        self.dispatch_depth = max(1, dispatch_depth)
        mb = max_batch or min(e.batcher.max_batch for e in self.engines)
        self.batcher = MicroBatcher(max_batch=mb, max_wait_ms=max_wait_ms)
        self.fault_plans = dict(fault_plans or {})
        self.suspect_after = suspect_after
        self.eject_after = eject_after
        self.hedge_enabled = hedge and self.n_replicas > 1
        self.hedge_floor_ms = hedge_floor_ms
        self.max_redispatch = (2 * self.n_replicas if max_redispatch is None
                               else max_redispatch)
        self.degrade_high = degrade_high
        self.degrade_low = degrade_low
        self.degrade_k_cap = (degrade_k_cap if degrade_k_cap is not None
                              else min(e.k for e in self.engines))
        self.degrade_patience = max(1, degrade_patience)
        self.recover_patience = max(1, recover_patience)

        self.replicas = [ReplicaState(cooldown_ms=cooldown_ms)
                         for _ in range(self.n_replicas)]
        self._base_cooldown_ms = cooldown_ms
        self._queues: List[queue.Queue] = [queue.Queue()
                                           for _ in range(self.n_replicas)]
        self._events: queue.Queue = queue.Queue()
        self._dispatch_idx = [0] * self.n_replicas   # worker-local counters

        self._jobs: Dict[int, _JobState] = {}
        self._retry: collections.deque[_JobState] = collections.deque()
        self._next_job_id = 0
        self._expected: set = set()
        self._done_ids: set = set()
        self._completed: List[Result] = []
        self._latencies_ms: List[float] = []
        self._job_wall_ms: collections.deque = collections.deque(maxlen=512)
        self._down_since = [0.0] * self.n_replicas
        self.readmit_ms: List[tuple] = []
        self.recovery_ms: List[float] = []
        self._worker_errors: List[tuple] = []

        self.level = 0
        self._over = self._under = 0
        self.degrade_events = 0
        self.recover_events = 0
        self.degraded_results: collections.Counter = collections.Counter()
        self.shed_load = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.duplicates_suppressed = 0
        self.redispatched = 0

        # -- durable mutable catalogue ---------------------------------
        self.mutable = replica_states is not None
        if self.mutable and len(replica_states) != self.n_replicas:
            raise ValueError(
                f"{len(replica_states)} replica states for "
                f"{self.n_replicas} engines — each replica owns exactly "
                "one MutableHeadState")
        if self.mutable and len({id(s) for s in replica_states}) \
                != self.n_replicas:
            raise ValueError("replica states are written in place: each "
                             "replica needs its own (MutableHeadState.clone)")
        if log is not None and not self.mutable:
            raise ValueError("a CatalogueLog needs mutable replicas "
                             "(replica_states / for_seqrec_mutable)")
        self._replica_states: List[Optional[MutableHeadState]] = \
            list(replica_states or [])
        self.log = log
        self.staleness_budget = max(0, int(staleness_budget))
        # The writer state is the scheduler-side authoritative catalogue:
        # apply_mutations validates + applies here first (WAL discipline
        # needs a validated op), and snapshots are cut from it.  A copy:
        # replica 0's state is written by its worker thread.
        self._writer_state = (self._replica_states[0].clone()
                              if self.mutable else None)
        self._committed_lsn = (log.lsn if (self.mutable and log is not None)
                               else 0)
        self._applied_lsn = [self._committed_lsn] * self.n_replicas
        self._mut_queues: List[queue.Queue] = [
            queue.Queue() for _ in range(self.n_replicas)]
        self._paused = [False] * self.n_replicas    # chaos: freeze catch-up
        self._needs_recovery = [False] * self.n_replicas
        self.stale_served = 0
        self.catchup_events = 0
        self.mutations_applied = 0
        if self.mutable and log is not None \
                and log.latest_snapshot_lsn() is None:
            # A log with no snapshot cannot recover (replay needs a base
            # state): cut the genesis snapshot at the current LSN.
            log.snapshot(self._writer_state)
        for eng in self.engines:
            if eng.stream is not None:
                # The states and the writer copy were made on this thread's
                # stream: the replicas' streams read them after that.
                eng.stream.wait_stream(torch.cuda.current_stream(eng.device))

        self._closed = False
        self._threads = [
            threading.Thread(target=self._worker, args=(rid,), daemon=True,
                             name=f"replica-{rid}")
            for rid in range(self.n_replicas)]
        for t in self._threads:
            t.start()

    @classmethod
    def for_seqrec(cls, params, cfg, *, n_replicas: int = 2, k: int = 10,
                   max_batch: int = 64, method: Optional[str] = None,
                   sharded_mesh=None, calibrate: Optional[bool] = None,
                   survival_stats: Optional[Sequence[int]] = None,
                   ladder=None, device="cuda",
                   **router_kw) -> "ReplicaRouter":
        """Stand up K identical replicas of a seqrec serving engine on
        ``device``, sharing one copy of the parameters there.  The pruned
        route's slot-budget ladder is calibrated once (on the first
        replica) and shared, so every replica serves the same function —
        which is what makes the healthy-path bit-parity hold across
        failover.  ``sharded_mesh`` is passed to every replica (its lead
        device must be ``device``)."""
        from repro_torch.interop import to_device
        dev = resolve_device(device)
        params = to_device(params, dev)
        first = RetrievalEngine.for_seqrec(
            params, cfg, k=k, max_batch=max_batch, method=method,
            sharded_mesh=sharded_mesh, device=dev, calibrate=calibrate,
            survival_stats=survival_stats, ladder=ladder)
        engines = [first]
        for _ in range(n_replicas - 1):
            engines.append(RetrievalEngine.for_seqrec(
                params, cfg, k=k, max_batch=max_batch, method=method,
                sharded_mesh=sharded_mesh, device=dev, ladder=first.ladder,
                calibrate=False))
        return cls(engines, **router_kw)

    @classmethod
    def for_seqrec_mutable(cls, params, cfg, mstate, *,
                           n_replicas: int = 2, k: int = 10,
                           max_batch: int = 64,
                           calibrate: Optional[bool] = None,
                           survival_stats: Optional[Sequence[int]] = None,
                           ladder=None, log: Optional[Any] = None,
                           device="cuda",
                           **router_kw) -> "ReplicaRouter":
        """K replicas over ONE logical mutable catalogue.  Replica 0 serves
        ``mstate`` (which must lie on ``device``), each other replica a
        ``clone()`` of it (mutations write in place, so no two replicas
        share a tensor), and all replay the same LSN-ordered op stream, so
        their states — and therefore untagged answers — stay bit-identical
        across the fleet.  The calibrated ladder is shared from the first
        replica exactly like :meth:`for_seqrec`.

        ``log`` (a ``serving.catalogue_log.CatalogueLog``) makes the
        stream durable: :meth:`apply_mutations` appends there first, and
        crashed replicas / a restarted router recover from it.  To stand a
        router back up after a crash::

            log = CatalogueLog(log_dir)           # truncates any torn tail
            state, lsn = log.recover(device=dev)
            router = ReplicaRouter.for_seqrec_mutable(params, cfg, state,
                                                      log=log, ...)
        """
        from repro_torch.interop import to_device
        dev = resolve_device(device)
        params = to_device(params, dev)
        states = [mstate] + [mstate.clone() for _ in range(n_replicas - 1)]
        first = RetrievalEngine.for_seqrec_mutable(
            params, cfg, states[0], k=k, max_batch=max_batch, device=dev,
            calibrate=calibrate, survival_stats=survival_stats,
            ladder=ladder)
        engines = [first]
        for st in states[1:]:
            engines.append(RetrievalEngine.for_seqrec_mutable(
                params, cfg, st, k=k, max_batch=max_batch, device=dev,
                ladder=first.ladder, calibrate=False))
        return cls(engines, replica_states=states, log=log, **router_kw)

    def warmup(self, ks: Sequence[int] = (), buckets: Sequence[int] = ()):
        """Run the hot serve variants once on EVERY replica, on its worker
        and stream (full-bucket batch at the engines' base k plus any extra
        ``ks`` / ``buckets``, and the rung-pinned route where present),
        before traffic arrives: the first kernel use builds and loads the
        library and fills its launch caches, and without warmup the first
        batches straggle behind it and the hedger fires on it.  Launches
        kernels (their counts move); touches no statistic."""
        pending = []
        for rid, eng in enumerate(self.engines):
            bks = set(buckets) | {self.batcher.max_batch}
            kks = {eng.batch_k([k]) for k in set(ks) | {eng.k}}
            keys = []
            for b in sorted(bks):
                bb = MicroBatcher.bucket(b, eng.batcher.max_batch)
                for kk in sorted(kks):
                    keys.append((bb, kk, False))
                    if eng.has_pinned:
                        keys.append((bb, kk, True))
            w = _Warmup(keys)
            self._queues[rid].put(w)
            pending.append(w)
        for w in pending:
            if not w.done.wait(_WARMUP_TIMEOUT_S):
                raise RuntimeError(
                    f"warmup did not finish in {_WARMUP_TIMEOUT_S}s")

    # ------------------------------------------------------------------
    # worker side (one thread per replica; the only code touching engines)
    # ------------------------------------------------------------------

    def _worker(self, rid: int):
        try:
            self._serve_loop(rid)
        except Exception as exc:          # surfaced by the next pump
            self._worker_errors.append((rid, exc))

    def _serve_loop(self, rid: int):
        eng = self.engines[rid]
        if eng.stream is not None:
            torch.cuda.set_stream(eng.stream)
        plan = self.fault_plans.get(rid)
        q = self._queues[rid]
        inflight: collections.deque = collections.deque()
        while True:
            if self.mutable:
                # Catalogue catch-up BETWEEN dispatches, on the thread
                # that owns the engine: apply any pending op batches (in
                # place, on the engine's stream, behind the batches in
                # flight) and swap the head before more work.
                self._apply_pending(rid, eng)
            job = None
            if len(inflight) < self.dispatch_depth:
                try:
                    # Block only when the pipeline is empty; with work in
                    # flight, poll so completions are not starved.
                    job = q.get(block=not inflight, timeout=0.02)
                except queue.Empty:
                    job = None
            if job is _STOP:
                while inflight:           # never abandon in-flight work
                    self._finish(rid, *inflight.popleft())
                break
            if isinstance(job, _Warmup):
                try:
                    for key in job.keys:
                        eng.warm(*key)
                finally:
                    job.done.set()
            elif job is not None:
                if self.mutable:
                    # A job may have queued behind newer mutations:
                    # re-drain so the dispatch serves the freshest state
                    # this replica can reach.
                    self._apply_pending(rid, eng)
                self._start(rid, eng, plan, job, inflight)
            elif inflight:
                self._finish(rid, *inflight.popleft())

    def _apply_pending(self, rid: int, eng: RetrievalEngine):
        """Drain this replica's mutation queue (worker thread only).

        LSN fencing makes delivery idempotent and gap-safe: an op at or
        below the applied watermark is a duplicate (skipped); an op more
        than one ahead means this replica missed a delta — only possible
        after a (simulated) crash — and forces snapshot+replay recovery
        from the durable log.  A "crash" marker drops the in-memory state
        outright; the very next pass recovers it.  The engine sees one
        ``swap_head_state`` per drain, not per op."""
        if self._paused[rid]:
            return
        q = self._mut_queues[rid]
        old = self._replica_states[rid]
        st = old
        applied = self._applied_lsn[rid]
        dirty = False
        while True:
            try:
                kind, payload = q.get_nowait()
            except queue.Empty:
                break
            if kind == "crash":
                st, applied, dirty = None, -1, False
                continue
            for lsn, op in payload:
                if st is None or lsn > applied + 1:
                    st, applied = self._recover_replica(rid, eng)
                    dirty = True
                if lsn <= applied:
                    continue              # duplicate / already recovered
                if lsn > applied + 1:     # still gapped after recovery:
                    raise RuntimeError(   # the log lost acked ops
                        f"replica {rid}: op lsn {lsn} but recovered log "
                        f"ends at {applied} — durable log is missing "
                        "committed entries")
                apply_op(st, op)
                applied = lsn
                dirty = True
        if st is None:                    # crashed with an empty tail
            st, applied = self._recover_replica(rid, eng)
            dirty = True
        if dirty:
            if st is not old and eng.stream is not None:
                # Batches queued on this stream may still read the old
                # state, which may have been allocated on another stream:
                # keep its memory from being handed out before they end.
                for t in _tensors(old):
                    t.record_stream(eng.stream)
            self._replica_states[rid] = st
            eng.swap_head_state(st)
        self._applied_lsn[rid] = applied

    def _recover_replica(self, rid: int, eng: RetrievalEngine):
        """Snapshot+replay from the durable log (worker thread), onto the
        engine's device and stream.  Reads never truncate and tolerate a
        concurrent append's torn tail; any ops past what the read sees are
        still queued behind this drain and land through the normal
        LSN-fenced path."""
        if self.log is None:
            raise RuntimeError(
                f"replica {rid} lost its catalogue state and no durable "
                "log is attached; build the router with a CatalogueLog")
        # Force the committed prefix onto disk first: recover() reads the
        # file, and appends inside the fsync window would otherwise be
        # invisible — the replica would land BELOW the committed LSN with
        # the missing batch already consumed from its queue.  (A crashed
        # writer is left alone: its durable prefix is already fsynced.)
        t0 = time.monotonic()
        if not self.log.read_only and not self.log._crashed:
            self.log.sync()
        st, lsn = self.log.recover(device=eng.device)
        self.recovery_ms.append((time.monotonic() - t0) * 1e3)
        self.catchup_events += 1
        self._needs_recovery[rid] = False
        return st, lsn

    def _start(self, rid: int, eng: RetrievalEngine,
               plan: Optional[ReplicaFaultPlan], job: _Job,
               inflight: collections.deque):
        """Prepare + launch one job; chaos (the replica fault plan) is
        consulted on this replica's own dispatch counter, so a schedule
        replays identically however the router interleaves replicas."""
        d_idx = self._dispatch_idx[rid]
        self._dispatch_idx[rid] = d_idx + 1
        # Catalogue watermark at dispatch: the results of this job were
        # computed against exactly this LSN.  Staleness is judged here,
        # not at delivery.
        lsn = self._applied_lsn[rid] if self.mutable else -1
        stale = (self.mutable
                 and self._committed_lsn - lsn > self.staleness_budget)
        try:
            extra = plan.check(d_idx) if plan is not None else 0.0
            shed, prep = eng.prepare(job.requests, k_cap=job.k_cap,
                                     rung_pin=job.rung_pin)
            if prep is None:
                self._events.put(_Event("done", job, shed, rid,
                                        lsn=lsn, stale=stale))
                return
            if extra:
                time.sleep(extra)         # straggling replica
            inflight.append((job, eng.launch(prep), shed, lsn, stale))
        except SimulatedFailure:
            self._events.put(_Event("fail", job, [], rid))

    def _finish(self, rid: int, job: _Job, inf: InFlightBatch,
                shed: List[Result], lsn: int = -1, stale: bool = False):
        try:
            res = self.engines[rid].complete(inf)
        except SimulatedFailure:
            # Deadline sheds from prepare() are still final answers — only
            # the dispatched rows are retried elsewhere.
            self._events.put(_Event("fail", job, shed, rid))
        else:
            self._events.put(_Event("done", job, shed + res, rid,
                                    straggler=inf.straggler, lsn=lsn,
                                    stale=stale))

    # ------------------------------------------------------------------
    # scheduler side (caller thread only)
    # ------------------------------------------------------------------

    def apply_mutations(self, ops) -> int:
        """The single durable entry for catalogue mutations (caller
        thread).  WAL discipline, in order per op: validate + apply to the
        writer state (an invalid op raises BEFORE anything becomes
        durable), append to the log, and only then fan the batch out to
        the replica workers — so no replica can ever apply an op the log
        does not hold.  Returns the committed LSN.

        A ``SimulatedFailure`` out of the log append is the torn-record
        chaos experiment: the writer "crashed" mid-append.  The durable
        prefix is still consistent (everything already fanned out is on
        disk); close this router and stand a new one up from
        ``CatalogueLog.recover()``."""
        if not self.mutable:
            raise ValueError(
                "router fronts an immutable catalogue; build it with "
                "for_seqrec_mutable (or replica_states=) to mutate")
        entries = []
        try:
            for op in ops:
                apply_op(self._writer_state, op)
                lsn = (self.log.append(op) if self.log is not None
                       else self._committed_lsn + len(entries) + 1)
                entries.append((lsn, op))
        finally:
            if entries:
                self._committed_lsn = entries[-1][0]
                self.mutations_applied += len(entries)
                for q in self._mut_queues:
                    q.put(("ops", entries))
        if self.log is not None:
            self.log.maybe_snapshot(self._writer_state)
        return self._committed_lsn

    def crash_replica(self, rid: int):
        """Chaos hook: simulate process death of one replica.  Its
        in-memory catalogue state is dropped (a "crash" marker its worker
        honours before the next dispatch), it is ejected from rotation,
        and re-admission is gated: the health FSM keeps it out of
        ``healthy`` until it has recovered snapshot+tail from the durable
        log and caught up within the staleness budget."""
        if not self.mutable:
            raise ValueError("crash_replica needs a mutable fabric")
        rs = self.replicas[rid]
        if rs.state != EJECTED:
            rs.state = EJECTED
            rs.ejected_at = time.monotonic()
            rs.ejections += 1
            self._down_since[rid] = rs.ejected_at
        rs.strikes = max(rs.strikes, self.eject_after)
        self._needs_recovery[rid] = True
        self._mut_queues[rid].put(("crash", None))

    def pause_mutations(self, rid: int):
        """Chaos hook: freeze one replica's catalogue catch-up (its worker
        stops draining the mutation queue), so it serves an ever-staler
        state — the deterministic way to exercise the staleness budget,
        the ``stale_catalogue`` tag and the catch-up re-admission gate."""
        self._paused[rid] = True

    def resume_mutations(self, rid: int):
        self._paused[rid] = False

    def _lag(self, rid: int) -> int:
        applied = self._applied_lsn[rid]
        if applied < 0:                   # crashed, recovery pending
            return self._committed_lsn + 1
        return max(0, self._committed_lsn - applied)

    def submit(self, req: Request):
        """Accept a request (or, at ladder level 3, shed it immediately
        with a ``load_shed``-tagged Result — the client still gets exactly
        one answer)."""
        self._expected.add(req.request_id)
        if self.level >= 3:
            now = time.monotonic()
            lat = (now - req.arrival) * 1e3
            self.shed_load += 1
            self.degraded_results["load_shed"] += 1
            self._done_ids.add(req.request_id)
            self._latencies_ms.append(lat)
            self._completed.append(Result(
                req.request_id, np.empty(0, np.int32),
                np.empty(0, np.float32), lat, shed=True,
                degraded="load_shed"))
            return
        self.batcher.submit(req)

    def pump(self, block: bool = False, timeout: float = 0.05) -> bool:
        """One scheduling pass: absorb completion events, update the
        degradation ladder and replica health, assign ready batches, issue
        hedges.  Returns True if any event was processed."""
        if self._worker_errors:
            rid, exc = self._worker_errors[0]
            raise RuntimeError(f"replica {rid}'s worker died: {exc!r}") \
                from exc
        progressed = False
        first = True
        while True:
            try:
                ev = self._events.get(block=block and first, timeout=timeout)
            except queue.Empty:
                break
            first = False
            progressed = True
            self._handle(ev)
        self._update_load()
        self._update_health()
        self._schedule()
        if self.hedge_enabled:
            self._maybe_hedge()
        return progressed

    def drain(self, timeout_s: float = 120.0) -> List[Result]:
        """Pump until every submitted request has exactly one Result; a
        stall (no event for ``timeout_s``) raises rather than hanging — by
        construction (failover + forced probes) that only fires on a
        genuinely wedged fabric."""
        last_progress = time.monotonic()
        while self._expected - self._done_ids:
            if self.pump(block=True, timeout=0.05):
                last_progress = time.monotonic()
            elif time.monotonic() - last_progress > timeout_s:
                missing = sorted(self._expected - self._done_ids)[:10]
                raise RuntimeError(
                    f"router stalled; undelivered request ids {missing}...")
        self.pump()                       # absorb trailing duplicates
        out, self._completed = self._completed, []
        return out

    def close(self):
        if self._closed:
            return
        self._closed = True
        for q in self._queues:
            q.put(_STOP)
        for t in self._threads:
            t.join(timeout=30.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- event handling -------------------------------------------------

    def _handle(self, ev: _Event):
        rs = self.replicas[ev.replica]
        rs.inflight = max(0, rs.inflight - 1)
        st = self._jobs.get(ev.job.job_id)
        if rs.probe_outstanding:
            rs.probe_outstanding = False
        delivered_new = False
        for r in ev.results:
            if r.request_id in self._done_ids:
                self.duplicates_suppressed += 1
                continue
            delivered_new = True
            self._done_ids.add(r.request_id)
            if not r.shed:
                r.replica = ev.replica
                r.hedged = bool(st and st.hedged)
                if self.mutable:
                    r.lsn = ev.lsn
                    if ev.stale:
                        # Served from a catalogue older than the budget
                        # allows: still a correct answer *for its LSN*,
                        # but no longer the exactness contract's answer.
                        self.stale_served += 1
                        r.degraded = (f"{r.degraded}+stale_catalogue"
                                      if r.degraded else "stale_catalogue")
            if r.degraded:
                self.degraded_results[r.degraded] += 1
            self._latencies_ms.append(r.latency_ms)
            self._completed.append(r)
        if ev.kind == "done":
            rs.completed += 1
            if st is not None and st.first_dispatch_t:
                self._job_wall_ms.append(
                    (time.monotonic() - st.first_dispatch_t) * 1e3)
            if ev.job.hedged and delivered_new:
                self.hedge_wins += 1
            if ev.straggler:
                rs.stragglers += 1
                self._strike(ev.replica)
            else:
                self._ok(ev.replica)
        else:
            rs.failures += 1
            self._strike(ev.replica)
        if st is None:
            return
        st.copies -= 1
        if st.copies > 0:
            return
        undone = [r for r in st.requests
                  if r.request_id not in self._done_ids]
        if not undone:
            del self._jobs[ev.job.job_id]
            return
        # Last live copy failed with work undelivered: re-dispatch (the
        # in-flight work of a dead replica is never lost) until the
        # patience budget runs out, then shed — still exactly one Result.
        st.requests = undone
        st.attempts += 1
        del self._jobs[ev.job.job_id]
        if st.attempts <= self.max_redispatch:
            self.redispatched += 1
            self._retry.append(st)
        else:
            now = time.monotonic()
            for r in undone:
                lat = (now - r.arrival) * 1e3
                self._done_ids.add(r.request_id)
                self.degraded_results["redispatch_exhausted"] += 1
                self._latencies_ms.append(lat)
                self._completed.append(Result(
                    r.request_id, np.empty(0, np.int32),
                    np.empty(0, np.float32), lat,
                    timed_out=lat > r.deadline_ms, shed=True,
                    degraded="redispatch_exhausted"))

    # -- health ---------------------------------------------------------

    def _strike(self, rid: int):
        rs = self.replicas[rid]
        now = time.monotonic()
        if rs.state == PROBING:
            # Half-open probe failed: back to ejected, backoff doubled.
            rs.state = EJECTED
            rs.ejected_at = now
            rs.cooldown_ms *= 2.0
            return
        rs.strikes += 1
        if rs.strikes >= self.eject_after and rs.state != EJECTED:
            rs.state = EJECTED
            rs.ejected_at = now
            rs.ejections += 1
            self._down_since[rid] = now
        elif rs.strikes >= self.suspect_after and rs.state == HEALTHY:
            rs.state = SUSPECT

    def _ok(self, rid: int):
        rs = self.replicas[rid]
        if rs.state == PROBING:
            if self.mutable and (self._needs_recovery[rid]
                                 or self._lag(rid) > self.staleness_budget):
                # The probe answered, but the replica has not finished
                # replaying its missed catalogue delta: re-admission is
                # gated on catch-up.  Stay PROBING — the next probe trials
                # it again once the worker has caught up.
                return
            rs.state = HEALTHY
            rs.strikes = 0
            rs.cooldown_ms = self._base_cooldown_ms
            rs.readmissions += 1
            self.readmit_ms.append(
                (rid, (time.monotonic() - self._down_since[rid]) * 1e3))
            return
        if rs.strikes > 0:
            rs.strikes -= 1
            if rs.state == SUSPECT and rs.strikes < self.suspect_after:
                rs.state = HEALTHY

    def _update_health(self):
        now = time.monotonic()
        for rs in self.replicas:
            if rs.state == EJECTED and \
                    (now - rs.ejected_at) * 1e3 >= rs.cooldown_ms:
                rs.state = PROBING
                rs.probe_outstanding = False

    def _eligible(self, exclude: int = -1) -> Optional[int]:
        """Pick the assignable replica: a free half-open probe slot first
        (a probing replica takes at most ONE job, and re-admission can
        only happen by actually trialling it), then healthy before
        suspect, least-loaded within a rank.  When every replica is
        ejected, force the one closest to cooldown into probing — liveness
        must not wait for a timer while requests hold deadlines."""
        rank = {PROBING: 0, HEALTHY: 1, SUSPECT: 2}
        best, best_key = None, None
        for rid, rs in enumerate(self.replicas):
            if rid == exclude or rs.state == EJECTED:
                continue
            if rs.state == PROBING and rs.probe_outstanding:
                continue
            # A replica lagging the committed catalogue past the budget
            # serves stale (tagged) answers: deprioritise it within its
            # health rank — but never exclude it, or a single-replica
            # fabric would deadlock against its own catch-up.
            stale = int(self.mutable
                        and self._lag(rid) > self.staleness_budget)
            key = (rank[rs.state], stale,
                   rs.inflight + self._queues[rid].qsize())
            if best_key is None or key < best_key:
                best, best_key = rid, key
        if best is None:
            ejected = [(self.replicas[rid].ejected_at
                        + self.replicas[rid].cooldown_ms / 1e3, rid)
                       for rid in range(self.n_replicas)
                       if rid != exclude
                       and self.replicas[rid].state == EJECTED]
            if ejected:
                _, rid = min(ejected)
                self.replicas[rid].state = PROBING
                self.replicas[rid].probe_outstanding = False
                return rid
        return best

    # -- assignment / hedging / ladder ----------------------------------

    def _put(self, rid: int, job: _Job):
        rs = self.replicas[rid]
        rs.dispatched += 1
        rs.inflight += 1
        if rs.state == PROBING:
            rs.probe_outstanding = True
        self._queues[rid].put(job)

    def _assign(self, st: _JobState) -> bool:
        rid = self._eligible()
        if rid is None:
            return False
        st.replica = rid
        st.first_dispatch_t = st.first_dispatch_t or time.monotonic()
        jid = self._next_job_id
        self._next_job_id += 1
        self._jobs[jid] = st
        self._put(rid, _Job(jid, st.requests, st.k_cap, st.rung_pin, rid))
        return True

    def _schedule(self):
        while self._retry:
            st = self._retry[0]
            st.copies = 1
            st.hedged = False
            if not self._assign(st):
                return                    # nothing assignable right now
            self._retry.popleft()
        while self.batcher.ready():
            reqs = self.batcher.next_batch()
            st = _JobState(reqs,
                           k_cap=(self.degrade_k_cap if self.level >= 1
                                  else None),
                           rung_pin=self.level >= 2, replica=-1)
            if not self._assign(st):
                # Put them back at the FRONT: arrival order is preserved
                # and the next pump retries.
                for r in reversed(reqs):
                    self.batcher.queue.appendleft(r)
                    self.batcher._enq_t.appendleft(r.arrival)
                return

    def hedge_delay_ms(self) -> float:
        """Current hedge trigger: observed p99 job wall time, floored —
        with few samples the floor dominates so a cold fabric does not
        hedge on start-up noise."""
        if len(self._job_wall_ms) < 16:
            return self.hedge_floor_ms
        return max(self.hedge_floor_ms,
                   float(np.percentile(np.asarray(self._job_wall_ms), 99)))

    def _maybe_hedge(self):
        delay_ms = self.hedge_delay_ms()
        now = time.monotonic()
        for jid, st in list(self._jobs.items()):
            if st.hedged or st.copies != 1:
                continue
            if (now - st.first_dispatch_t) * 1e3 < delay_ms:
                continue
            rid = self._eligible(exclude=st.replica)
            if rid is None or self.replicas[rid].state != HEALTHY:
                continue                  # only hedge onto healthy spares
            st.hedged = True
            st.copies += 1
            self.hedges += 1
            self._put(rid, _Job(jid, st.requests, st.k_cap, st.rung_pin,
                                rid, hedged=True))

    def _load(self) -> int:
        return (len(self.batcher.queue)
                + sum(len(st.requests) for st in self._jobs.values())
                + sum(len(st.requests) for st in self._retry))

    def _update_load(self):
        depth = self._load()
        if depth >= self.degrade_high:
            self._over += 1
            self._under = 0
            if self._over >= self.degrade_patience and self.level < 3:
                self.level += 1
                self.degrade_events += 1
                self._over = 0
        elif depth <= self.degrade_low:
            self._under += 1
            self._over = 0
            if self._under >= self.recover_patience and self.level > 0:
                self.level -= 1
                self.recover_events += 1
                self._under = 0
        else:
            # Hysteresis band between the watermarks: hold the level.
            self._over = self._under = 0

    # -- observability ---------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        lats = self._latencies_ms
        done = len(self._done_ids)
        per_replica = {}
        for rid, rs in enumerate(self.replicas):
            per_replica[rid] = {
                "state": rs.state, "strikes": rs.strikes,
                "ejections": rs.ejections, "readmissions": rs.readmissions,
                "dispatched": rs.dispatched, "completed": rs.completed,
                "failures": rs.failures, "stragglers": rs.stragglers,
                "queue_depth": self._queues[rid].qsize() + rs.inflight,
                "n_compiles": len(self.engines[rid]._variants),
            }
            if self.mutable:
                per_replica[rid]["applied_lsn"] = self._applied_lsn[rid]
                per_replica[rid]["lag"] = self._lag(rid)
        lat = np.asarray(lats) if lats else None
        out: Dict[str, Any] = {
            "count": float(done),
            "pending": float(len(self.batcher.queue)),
            "outstanding": float(sum(len(st.requests)
                                     for st in self._jobs.values())),
            "p50_ms": float(np.percentile(lat, 50)) if lat is not None
            else None,
            "p99_ms": float(np.percentile(lat, 99)) if lat is not None
            else None,
            "hedges": float(self.hedges),
            "hedge_wins": float(self.hedge_wins),
            "hedge_delay_ms": self.hedge_delay_ms(),
            "duplicates_suppressed": float(self.duplicates_suppressed),
            "redispatched": float(self.redispatched),
            "degrade_level": self.level,
            "degrade_events": float(self.degrade_events),
            "recover_events": float(self.recover_events),
            "degraded_results": dict(self.degraded_results),
            "shed_load": float(self.shed_load),
            "replicas": per_replica,
        }
        if self.mutable:
            out.update({
                "committed_lsn": float(self._committed_lsn),
                "mutations_applied": float(self.mutations_applied),
                "stale_served": float(self.stale_served),
                "catchup_events": float(self.catchup_events),
                "staleness_budget": float(self.staleness_budget),
                "log": self.log.stats() if self.log is not None else None,
            })
        return out
