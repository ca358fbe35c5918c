"""Batched retrieval serving: request = user history, response = top-K items.

Backbone -> phi -> PQTopK -> TopK, batched, with deadline shedding,
bounded retry of injected failures and straggler accounting — the
single-device routes of the reference's ``serving/engine.py``, the pruned
cascade's calibrated slot-budget ladder and rung statistics included, and
the mutable catalogue's hot-swappable head (:meth:`RetrievalEngine.
for_seqrec_mutable`, :meth:`RetrievalEngine.swap_head_state`) — and the
LM family's slot-based :class:`DecodeEngine`.

**One CUDA stream per engine.**  Several engines may share one card (the
replicated fabric, ``serving/router.py``, runs each on its own worker
thread).  An engine on the card queues its batches on a stream of its own
(:attr:`RetrievalEngine.stream`): the host-to-device copy of a batch, its
serve function and the copy of its results into pinned host memory, then a
CUDA event.  :meth:`RetrievalEngine.complete` waits on that event alone, so
an engine's latency, straggler strikes and hedges measure its own work,
never another engine's.  Host reads inside a serve function (the pruned
cascade's rung choice) sync the current stream, which is then the engine's.
A batch launched from a thread whose current stream is another one first
makes the engine's stream wait for it, so a catalogue mutation written in
place on the caller's stream lands before the batch reads it.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field, fields
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, tracing
from repro_torch.core.pruning import ARRAY_FIELDS, PrunedHeadState
from repro_torch.kernels import cost
from repro_torch.training.fault_tolerance import (SimulatedFailure,
                                                  StragglerMonitor)


@dataclass
class Request:
    request_id: int
    payload: Any                      # user history (np.ndarray of item ids)
    k: int = 10
    arrival: float = field(default_factory=time.monotonic)
    # Requests past their deadline are shed before dispatch and count as
    # timeouts.  Lenient by default: a request with no latency contract is
    # served late rather than dropped.
    deadline_ms: float = 60_000.0


@dataclass
class Result:
    request_id: int
    items: np.ndarray
    scores: np.ndarray
    latency_ms: float
    timed_out: bool = False
    # A shed request was never scored: past its deadline before dispatch,
    # or its batch exhausted the retry budget.
    shed: bool = False
    # Every step of the router's load ladder that can change what the
    # client receives is tagged ("k_cap", "rung_pin", "k_cap+rung_pin",
    # "load_shed", "stale_catalogue", ...); "" asserts the exact path ran.
    degraded: str = ""
    # Which replica served this result (-1: a single engine, or shed before
    # dispatch) and whether it was raced against a hedge re-issue.
    replica: int = -1
    hedged: bool = False
    # The serving replica's applied catalogue LSN at dispatch (-1: an
    # immutable catalogue).
    lsn: int = -1


class MicroBatcher:
    """Greedy size/timeout batcher with power-of-two padding buckets, so the
    number of serve variants stays bounded.

    ``max_wait_ms`` is the partial-batch deadline: a batch is :meth:`ready`
    once it is full or its oldest request has waited ``max_wait_ms`` (the
    router polls it, so a trickle of requests dispatches instead of waiting
    for a full bucket; the engine's own ``drain`` always flushes)."""

    def __init__(self, max_batch: int = 64, max_wait_ms: float = 2.0):
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.queue: collections.deque[Request] = collections.deque()
        self._enq_t: collections.deque[float] = collections.deque()

    def submit(self, req: Request):
        self.queue.append(req)
        self._enq_t.append(time.monotonic())

    def oldest_wait_ms(self, now: Optional[float] = None) -> float:
        """How long the head-of-queue request has waited (0.0 when empty)."""
        if not self._enq_t:
            return 0.0
        return ((time.monotonic() if now is None else now)
                - self._enq_t[0]) * 1e3

    def ready(self, now: Optional[float] = None) -> bool:
        """True when a batch should dispatch: a full bucket, or the oldest
        request has out-waited ``max_wait_ms``."""
        if len(self.queue) >= self.max_batch:
            return True
        return bool(self.queue) and self.oldest_wait_ms(now) >= self.max_wait_ms

    def next_batch(self) -> List[Request]:
        out = []
        while self.queue and len(out) < self.max_batch:
            out.append(self.queue.popleft())
            if self._enq_t:
                self._enq_t.popleft()
        return out

    @staticmethod
    def bucket(n: int, max_batch: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, max_batch)


@dataclass
class PreparedBatch:
    """Host-side work of one dispatch, done: expired requests shed, the rest
    left-padded into their power-of-two bucket on the device, the serve
    variant resolved."""
    requests: List[Request]           # alive, in batch-row order
    seqs: torch.Tensor                # (bucket, seq_len) int32 on the device
    fn: Callable                      # serve variant (takes seqs)
    kk: int                           # the batch's k bucket
    batch_index: int
    degraded: str = ""                # tag carried into every Result


@dataclass
class InFlightBatch:
    """One dispatched batch.  On the card ``out`` holds pinned host tensors
    that the engine's stream fills; ``event`` is recorded on that stream
    after the copies, and :meth:`RetrievalEngine.complete` waits on it."""
    prep: PreparedBatch
    out: Any
    t0: float
    event: Optional[Any] = None       # torch.cuda.Event on the card
    straggler: bool = False           # set by complete()


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    """Queue a copy of ``t`` into pinned host memory on the current stream."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _read_result(ts) -> List[np.ndarray]:
    """A batch's outputs read to the host as numpy arrays: the engine's
    one result read (``kernels.cost.host_read`` names it ``result``; on
    meta the arrays are zeros of the outputs' shapes)."""
    return cost.host_read(
        "result", lambda: [t.cpu().numpy() for t in ts],
        lambda: [np.zeros(t.shape, str(t.dtype).replace("torch.", ""))
                 for t in ts], of=ts)


def _tensor_sig(t: torch.Tensor):
    return tuple(t.shape), t.dtype, t.device


def _head_signature(head: Dict[str, Any]):
    """What a hot swap must keep: the key set and, per entry, a tensor's
    shape, dtype and device, or a ``PrunedHeadState``'s static fields and
    its tensors' (the reference's treedef and leaf shapes and dtypes).
    -> (structure, {key: static fields}, {(key, field): tensor signature})."""
    structure, static, tensors = [], {}, {}
    for key in sorted(head):
        v = head[key]
        if isinstance(v, PrunedHeadState):
            present = tuple(f for f in ARRAY_FIELDS
                            if getattr(v, f) is not None)
            structure.append((key, present))
            static[key] = {f.name: getattr(v, f.name) for f in fields(v)
                           if f.name not in ARRAY_FIELDS}
            tensors.update(((key, f), _tensor_sig(getattr(v, f)))
                           for f in present)
        else:
            structure.append((key, None))
            tensors[(key, None)] = _tensor_sig(v)
    return tuple(structure), static, tensors


class RetrievalEngine:
    """Paper-mode serving: top-K item retrieval for user sequences."""

    def __init__(self, serve_fn: Callable[[torch.Tensor, int],
                                          Tuple[torch.Tensor, torch.Tensor]],
                 *, seq_len: int, k: int = 10, max_k: Optional[int] = None,
                 max_batch: int = 64, method: Optional[str] = None,
                 device="cuda", faults: Optional[Any] = None,
                 max_retries: int = 2, retry_backoff_ms: float = 1.0,
                 straggler_factor: float = 3.0,
                 ladder: Optional[Sequence[int]] = None,
                 serve_fn_pinned: Optional[Callable] = None,
                 head_state: Optional[Dict[str, Any]] = None):
        """``serve_fn(item_seq (B,S) int32, k)`` -> (ids (B,k), scores) or,
        for a pruned route with a ladder, (ids, scores, rung taken); the
        engine tallies the rung into ``rung_counts``.

        Serve variants are memoised per ``(batch_bucket, k_bucket,
        method, pinned)``; ``stats()["n_compiles"]`` counts them, as the
        reference counts its compiled executables.  ``max_k`` caps client
        k (default ``k``).  ``faults`` (a ``ServeFaultInjector``) with
        ``max_retries`` and ``retry_backoff_ms`` make :meth:`run_once`
        retry failed dispatches and shed a batch whose retries ran out.
        ``ladder`` records the slot-budget ladder baked into a pruned
        ``serve_fn``; ``serve_fn_pinned`` is the same route pinned to its
        cheapest rung (bounded cost, possibly inexact), taken by a batch
        prepared with ``rung_pin=True``.

        ``head_state`` (a dict of head tensors: codes, pruned metadata,
        tombstone mask) makes the engine hot-swappable: ``serve_fn`` then
        takes it as a third argument, each variant reads
        ``self._head_state`` when it is called, and
        :meth:`swap_head_state` replaces it between batches without adding
        a variant."""
        self._serve_fn = serve_fn
        self._serve_fn_pinned = serve_fn_pinned
        self._variants: Dict[Tuple[int, int, Optional[str], bool],
                             Callable] = {}
        self.device = resolve_device(device)
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            # Work queued so far (parameters, a catalogue built on the
            # caller's stream) lands before anything this engine runs.
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self.seq_len = seq_len
        self.k = k
        self.max_k = k if max_k is None else max(max_k, k)
        self.method = method
        self.ladder = None if ladder is None else tuple(ladder)
        self.rung_counts: collections.Counter = collections.Counter()
        self.batcher = MicroBatcher(max_batch=max_batch)
        self.latencies_ms: List[float] = []
        self.timeouts = 0
        self.faults = faults
        self.max_retries = max_retries
        self.retry_backoff_ms = retry_backoff_ms
        self.straggler_monitor = StragglerMonitor(factor=straggler_factor)
        self.retried = 0
        self.shed = 0
        self._head_state = None if head_state is None else dict(head_state)
        self._head_sig = (None if head_state is None
                          else _head_signature(self._head_state))
        self.n_swaps = 0
        self._batch_index = 0

    @classmethod
    def for_seqrec(cls, params, cfg, *, k: int = 10, max_batch: int = 64,
                   method: Optional[str] = None, sharded_mesh=None,
                   device="cuda",
                   calibrate: Optional[bool] = None,
                   survival_stats: Optional[Sequence[int]] = None,
                   ladder: Optional[Tuple[int, ...]] = None,
                   faults: Optional[Any] = None, max_retries: int = 2,
                   retry_backoff_ms: float = 1.0) -> "RetrievalEngine":
        """Stand up an engine on a seqrec model.  ``method=None`` falls
        back to ``cfg.serve_method`` (the recjpq configs serve
        ``"pqtopk_fused"``, the fused CUDA kernel).  The parameters are
        moved to ``device``.

        ``method="pqtopk_pruned"`` serves the pruned cascade with a
        calibrated slot-budget ladder: a calibration pass at build time
        (``calibrate``, default on; or recorded ``survival_stats``, a
        sequence of surviving-tile counts) feeds
        ``pruning.calibrate_ladder``.  With ``cfg.pq.query_grouping`` the
        observable is the largest per-group count, which the grouped
        ladder escalates on.  An explicit ``ladder`` skips calibration;
        ``calibrate=False`` serves without one.

        ``sharded_mesh`` (a ``launch.mesh.ShardMesh`` whose lead device is
        ``device``) serves the item-sharded route: the pruned state is
        aligned to the mesh once here, and calibration observes flat
        counts (rebuilt from a flat state, as the reference's code does)
        spread evenly over the shards against the per-shard tile count.
        A sharded engine has no pinned route."""
        from repro_torch.core import pruning, retrieval_head
        from repro_torch.distributed.sharding import same_device
        from repro_torch.interop import to_device
        from repro_torch.kernels.pqtopk import kernel as pqtopk_kernel
        from repro_torch.models import seqrec as seqrec_lib
        dev = resolve_device(device)
        if sharded_mesh is not None and not same_device(dev,
                                                        sharded_mesh.lead):
            raise ValueError(f"the engine's device {dev} is not the shard "
                             f"mesh's lead device {sharded_mesh.lead}")
        method = method or getattr(cfg, "serve_method", "pqtopk")
        params = to_device(params, dev)
        # Largest k the route can serve: the catalogue, and for the
        # fused-kernel routes also its item tile (k > tile is refused).
        max_k = cfg.n_items
        if method in ("pqtopk_fused", "pqtopk_pruned"):
            max_k = min(max_k, pqtopk_kernel.DEFAULT_TILE)
        if method == "pqtopk_pruned" and sharded_mesh is not None:
            # Align the tile layout to the mesh once, so the sharded
            # cascade never rebuilds its metadata.
            params = {**params, "item_emb":
                      retrieval_head.ensure_sharded_pruned_state(
                          params["item_emb"], sharded_mesh, k_hint=max_k)}
        state = retrieval_head._pruned_state(params["item_emb"])
        if method == "pqtopk_pruned" and ladder is None \
                and calibrate is not False and state is not None:
            counts = (list(survival_stats) if survival_stats is not None
                      else cls._observe_survival(params, cfg, k=k,
                                                 max_batch=max_batch))
            # A sharded state's rungs budget the per-shard tiles.
            counts = [-(-c // state.shards) for c in counts]
            ladder = pruning.calibrate_ladder(counts, state.tiles_per_shard,
                                              k, state.tile)
        with_rung = method == "pqtopk_pruned" and ladder is not None

        def serve_fn(seqs, kk):
            return seqrec_lib.serve_topk(params, seqs, cfg, k=kk,
                                         method=method,
                                         sharded_mesh=sharded_mesh,
                                         ladder=ladder,
                                         return_rung=with_rung)

        # The cascade pinned to its cheapest rung, built only when that
        # rung is below the exhaustive one (flat engines only).
        serve_fn_pinned = None
        if with_rung and sharded_mesh is None \
                and (state is None or min(ladder) < state.n_tiles):
            def serve_fn_pinned(seqs, kk):
                return seqrec_lib.serve_topk(params, seqs, cfg, k=kk,
                                             method=method, ladder=ladder,
                                             pin_rung=True)

        return cls(serve_fn, seq_len=cfg.max_seq_len, k=k, max_k=max_k,
                   max_batch=max_batch, method=method, device=dev,
                   faults=faults, max_retries=max_retries,
                   retry_backoff_ms=retry_backoff_ms, ladder=ladder,
                   serve_fn_pinned=serve_fn_pinned)

    @classmethod
    def for_seqrec_mutable(cls, params, cfg, mstate, *, k: int = 10,
                           max_batch: int = 64, device="cuda",
                           calibrate: Optional[bool] = None,
                           survival_stats: Optional[Sequence[int]] = None,
                           ladder: Optional[Tuple[int, ...]] = None,
                           faults: Optional[Any] = None,
                           max_retries: int = 2,
                           retry_backoff_ms: float = 1.0
                           ) -> "RetrievalEngine":
        """Engine over a mutable catalogue: the pruned cascade served
        against a ``mutation.MutableHeadState`` (or its ``head_arrays()``
        dict), whose codes, pruned metadata and tombstone mask are merged
        over ``params``'s item head at every dispatch and hot-swapped
        between batches with :meth:`swap_head_state`.  The head's tensors
        must already lie on ``device`` (mutations write them in place; the
        engine never copies them).  Calibration runs on the initial head
        with its ``live`` mask."""
        from repro_torch.core import pruning
        from repro_torch.interop import to_device
        from repro_torch.kernels.pqtopk import kernel as pqtopk_kernel
        from repro_torch.models import seqrec as seqrec_lib
        dev = resolve_device(device)
        head0 = (mstate.head_arrays() if hasattr(mstate, "head_arrays")
                 else dict(mstate))
        for (key, attr), (_, _, where) in _head_signature(head0)[2].items():
            if where.type != dev.type or (dev.index is not None
                                          and where.index != dev.index):
                raise ValueError(
                    f"head tensor {key}{'.' + attr if attr else ''} lies "
                    f"on {where}, not on the engine's {dev}; build the "
                    f"MutableHeadState on {dev}")
        params = to_device(params, dev)
        max_k = min(cfg.n_items, pqtopk_kernel.DEFAULT_TILE)

        def merged(head):
            return {**params, "item_emb": {**params["item_emb"],
                                           "codes": head["codes"],
                                           "pruned": head["pruned"],
                                           "live": head["live"]}}

        if ladder is None and calibrate is not False:
            counts = (list(survival_stats) if survival_stats is not None
                      else cls._observe_survival(merged(head0), cfg, k=k,
                                                 max_batch=max_batch))
            state = head0["pruned"]
            ladder = pruning.calibrate_ladder(counts, state.n_tiles, k,
                                              state.tile)
        with_rung = ladder is not None

        def serve_fn(seqs, kk, head):
            return seqrec_lib.serve_topk(merged(head), seqs, cfg, k=kk,
                                         method="pqtopk_pruned",
                                         ladder=ladder, return_rung=with_rung)

        return cls(serve_fn, seq_len=cfg.max_seq_len, k=k, max_k=max_k,
                   max_batch=max_batch, method="pqtopk_pruned", device=dev,
                   ladder=ladder, head_state=head0, faults=faults,
                   max_retries=max_retries,
                   retry_backoff_ms=retry_backoff_ms)

    @staticmethod
    def _observe_survival(params, cfg, *, k: int, max_batch: int,
                          n_batches: int = 3, seed: int = 0) -> List[int]:
        """Build-time calibration: surviving-tile counts of the cascade's
        bounds + theta prefix (no scoring) over ``n_batches`` random
        request batches at 1, 8 and ``max_batch`` queries — the largest
        per-group count when ``cfg.pq.query_grouping`` is on; a mutable
        head's ``live`` mask is honoured.  A shard-aligned state is
        observed through a flat state rebuilt from the codes at its tile
        (the reference's code; its comment speaks of per-shard counts
        summed), without its super level."""
        from repro_torch.core import pruning, retrieval_head, scoring
        from repro_torch.models import seqrec as seqrec_lib
        head = params["item_emb"]
        state = head["pruned"]
        if state.shards > 1:
            state = pruning.build_pruned_state(head["codes"], state.b,
                                               state.tile,
                                               backend=state.backend)
        pq = cfg.pq
        seed_kw = retrieval_head._seed_kwargs(pq)
        grouped = pq.query_grouping and pq.n_groups > 1
        live = head.get("live")
        rng = np.random.default_rng(seed)
        counts = []
        for bsz in dict.fromkeys((1, min(8, max_batch), max_batch)):
            for _ in range(n_batches):
                seqs = torch.from_numpy(rng.integers(
                    1, cfg.n_items + 1, (bsz, cfg.max_seq_len)
                ).astype(np.int32)).to(head["codes"].device)
                with torch.inference_mode():
                    phi = seqrec_lib.sequence_embedding(params, seqs, cfg)
                    s = scoring.subid_scores(head["sub_emb"], phi)
                    if grouped:
                        c = pruning.survival_count_grouped(
                            head["codes"], s, k, state, n_groups=pq.n_groups,
                            live=live, **seed_kw)
                    else:
                        c = pruning.survival_count(head["codes"], s, k, state,
                                                   live=live, **seed_kw)
                counts.append(int(c))
        return counts

    def submit(self, req: Request):
        self.batcher.submit(req)

    def batch_k(self, ks: Sequence[int]) -> int:
        """The k a batch whose client ks are ``ks`` is served at: each
        clamped into [1, max_k], floored at the engine's own k, bucketed to
        a power of two so client values cannot multiply the variants."""
        kk = max(max(min(int(k), self.max_k) for k in ks), self.k, 1)
        return MicroBatcher.bucket(kk, self.max_k)

    def _variant(self, bucket: int, kk: int, pinned: bool = False
                 ) -> Callable:
        """Memoised serve callable for one (batch_bucket, k_bucket, method,
        pinned) key; takes the (bucketed) sequence batch only.  A
        hot-swappable engine's variant reads ``self._head_state`` at each
        call, so a swap adds no variant."""
        if pinned and self._serve_fn_pinned is None:
            raise ValueError("no pinned (degraded) serve fn on this engine")
        key = (bucket, kk, self.method, pinned)
        fn = self._variants.get(key)
        if fn is None:
            sfn = self._serve_fn_pinned if pinned else self._serve_fn
            if self._head_state is not None:
                fn = lambda seqs, _k=kk, _f=sfn: _f(seqs, _k,
                                                    self._head_state)
            else:
                fn = lambda seqs, _k=kk, _f=sfn: _f(seqs, _k)
            self._variants[key] = fn
        return fn

    def swap_head_state(self, head) -> None:
        """Replace the served head between batches, adding no variant.
        Accepts the dict ``head_arrays()`` returns or any object with that
        method (``mutation.MutableHeadState``).  The key set, every
        ``PrunedHeadState`` static field (tile, n_items, b, backend, shards,
        super_factor, ...) and every tensor's shape, dtype and device must
        match the head the engine was built with; a capacity change needs
        a new engine."""
        if self._head_state is None:
            raise ValueError(
                "engine was not built with a swappable head; use "
                "for_seqrec_mutable (or pass head_state=) to enable "
                "hot swapping")
        if hasattr(head, "head_arrays"):
            head = head.head_arrays()
        structure, static, tensors = _head_signature(head)
        want_structure, want_static, want_tensors = self._head_sig
        if structure != want_structure:
            raise ValueError(
                f"swapped head structure {structure} differs from the "
                f"engine's structure {want_structure}; hot swap requires "
                "identical static metadata")
        for key, fields in static.items():
            if fields != want_static[key]:
                raise ValueError(
                    f"hot swap would change {key}'s static fields from "
                    f"{want_static[key]} to {fields}; capacity and layout "
                    "are fixed — rebuild the engine")
        for where, sig in tensors.items():
            if sig != want_tensors[where]:
                raise ValueError(
                    f"hot swap would change head tensor {where} from "
                    f"{want_tensors[where]} to {sig}; capacity, dtypes and "
                    "device are fixed — rebuild the engine to grow the "
                    "catalogue")
        self._head_state = dict(head)
        self.n_swaps += 1

    @property
    def has_pinned(self) -> bool:
        """Whether this engine carries a rung-pinned serve route."""
        return self._serve_fn_pinned is not None

    def _shed_result(self, r: Request, now: float,
                     degraded: str = "") -> Result:
        lat = (now - r.arrival) * 1e3
        timed_out = lat > r.deadline_ms
        self.shed += 1
        self.timeouts += int(timed_out)
        self.latencies_ms.append(lat)
        return Result(r.request_id, np.empty(0, np.int32),
                      np.empty(0, np.float32), lat, timed_out=timed_out,
                      shed=True, degraded=degraded)

    def prepare(self, reqs: List[Request], *, k_cap: Optional[int] = None,
                rung_pin: bool = False
                ) -> Tuple[List[Result], Optional[PreparedBatch]]:
        """Host side of one dispatch: shed expired requests, left-pad the
        rest into their power-of-two bucket (copied to the device on the
        engine's stream), resolve the serve variant.  Returns (shed
        results, prepared batch or None).

        ``k_cap`` and ``rung_pin`` are the router's load-ladder knobs: cap
        the batch k (bucketed into [1, max_k]) below the clients' asks,
        and route through the rung-pinned serve fn when the engine has
        one.  Each one that takes effect is tagged into
        ``PreparedBatch.degraded`` ("k_cap", "rung_pin" or
        "k_cap+rung_pin"), so every result carries it."""
        batch_index = self._batch_index
        self._batch_index += 1
        with tracing.span("engine.prepare", batch_index):
            now = time.monotonic()
            results: List[Result] = []
            alive: List[Request] = []
            for r in reqs:
                if (now - r.arrival) * 1e3 > r.deadline_ms:
                    results.append(self._shed_result(r, now))
                else:
                    alive.append(r)
            if not alive:
                return results, None
            bucket = MicroBatcher.bucket(len(alive),
                                         self.batcher.max_batch)
            # Requests in one batch may disagree on k: score once at the
            # batch k and give each request its own prefix (top-k prefixes
            # nest).
            kk = self.batch_k([r.k for r in alive])
            tags = []
            if k_cap is not None:
                capped = MicroBatcher.bucket(max(1, min(k_cap, self.max_k)),
                                             self.max_k)
                if capped < kk:
                    kk = capped
                    tags.append("k_cap")
            pinned = rung_pin and self.has_pinned
            if pinned:
                tags.append("rung_pin")
            seqs = np.zeros((bucket, self.seq_len), np.int32)
            for i, r in enumerate(alive):
                s = np.asarray(r.payload)[-self.seq_len:]
                seqs[i, -len(s):] = s
            with torch.cuda.stream(self.stream):    # None (the CPU): a no-op
                seqs = torch.from_numpy(seqs).to(self.device)
            return results, PreparedBatch(
                alive, seqs, self._variant(bucket, kk, pinned), kk,
                batch_index, degraded="+".join(tags))

    def launch(self, prep: PreparedBatch) -> InFlightBatch:
        """Dispatch a prepared batch; on the card the serve function and
        the copy of its results to pinned host memory are queued on the
        engine's stream, then an event, which :meth:`complete` waits on.
        Injected faults raise here, before dispatch, so the caller's retry
        loop sees them."""
        if self.faults is not None:
            self.faults.check(prep.batch_index)
        with tracing.span("engine.launch", prep.batch_index):
            t0 = time.monotonic()
            if self.stream is None:
                with torch.inference_mode():
                    out = prep.fn(prep.seqs)
                return InFlightBatch(prep, out, t0)
            caller = torch.cuda.current_stream(self.device)
            if caller != self.stream:
                self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream), torch.inference_mode():
                out = prep.fn(prep.seqs)
                host = tuple(_to_pinned(t) for t in out[:2]) + tuple(out[2:])
                event = torch.cuda.Event()
                event.record(self.stream)
        return InFlightBatch(prep, host, t0, event)

    def warm(self, bucket: int, kk: int, pinned: bool = False) -> None:
        """Resolve the (bucket, k) serve variant and run it once on a batch
        of padding, on the engine's stream, and wait for it: the first use
        of a kernel builds and loads its library and fills its launch
        caches, which a served batch should not pay for.  Touches no
        statistic."""
        fn = self._variant(bucket, kk, pinned)
        with torch.cuda.stream(self.stream), torch.inference_mode():
            fn(torch.zeros((bucket, self.seq_len), dtype=torch.int32,
                           device=self.device))
        if self.stream is not None:
            self.stream.synchronize()

    def complete(self, inflight: InFlightBatch) -> List[Result]:
        """Wait until the batch's device work has finished (its own event,
        not the card), then timestamp it and slice per-request results.
        The wait comes first: CUDA launches return before the card is
        done, and a timestamp taken without it would measure the
        enqueue."""
        prep = inflight.prep
        with tracing.span("engine.complete", prep.batch_index):
            if inflight.event is not None:
                inflight.event.synchronize()
            with tracing.span("engine.results", prep.batch_index):
                return self._results(inflight)

    def _results(self, inflight: InFlightBatch) -> List[Result]:
        """The host's side of a finished batch: the rung tally, the one
        result read, the straggler record and the per-request results."""
        prep = inflight.prep
        out = inflight.out
        if len(out) == 3:
            # A pruned route with a ladder: the third output is the rung.
            self.rung_counts[int(out[2])] += 1
        ids, scores = _read_result(out[:2])
        if self.faults is not None:
            delay = self.faults.delay_s(prep.batch_index)
            if delay:
                time.sleep(delay)      # synthetic straggler, lands in elapsed
        now = time.monotonic()
        inflight.straggler = self.straggler_monitor.record(
            prep.batch_index, now - inflight.t0)
        results: List[Result] = []
        for i, r in enumerate(prep.requests):
            lat = (now - r.arrival) * 1e3
            timed_out = lat > r.deadline_ms
            self.timeouts += int(timed_out)
            self.latencies_ms.append(lat)
            rk = max(1, min(r.k, prep.kk))
            results.append(Result(r.request_id, ids[i, :rk], scores[i, :rk],
                                  lat, timed_out, degraded=prep.degraded))
        return results

    def run_once(self, *, k_cap: Optional[int] = None,
                 rung_pin: bool = False) -> List[Result]:
        """Serve one batch: prepare -> launch (with bounded retry of
        injected failures) -> complete."""
        reqs = self.batcher.next_batch()
        if not reqs:
            return []
        results, prep = self.prepare(reqs, k_cap=k_cap, rung_pin=rung_pin)
        if prep is None:
            return results
        inflight = None
        for attempt in range(self.max_retries + 1):
            try:
                inflight = self.launch(prep)
                break
            except SimulatedFailure:
                if attempt >= self.max_retries:
                    break
                self.retried += 1
                time.sleep(self.retry_backoff_ms * (2 ** attempt) / 1e3)
        if inflight is None:
            # Retries exhausted: the batch never dispatched; shed it.
            now = time.monotonic()
            results.extend(self._shed_result(r, now, prep.degraded)
                           for r in prep.requests)
            return results
        results.extend(self.complete(inflight))
        return results

    def drain(self) -> List[Result]:
        out = []
        while self.batcher.queue:
            out.extend(self.run_once())
        return out

    def stats(self) -> Dict[str, Any]:
        # No traffic yet -> None, not 0.0: a placeholder zero would read as
        # a real latency to anything averaging across engines.
        lat = np.asarray(self.latencies_ms) if self.latencies_ms else None
        out: Dict[str, Any] = {
            "count": float(len(self.latencies_ms)),
            "mRT_ms": float(np.median(lat)) if lat is not None else None,
            "p99_ms": (float(np.percentile(lat, 99))
                       if lat is not None else None),
            "timeouts": float(self.timeouts),
            "n_compiles": float(len(self._variants)),
            "retried": float(self.retried),
            "shed": float(self.shed),
            "stragglers": float(len(self.straggler_monitor.flagged)),
        }
        if self._head_state is not None:
            out["n_swaps"] = float(self.n_swaps)
        if self.ladder is not None:
            # Share of served batches that stayed on a non-exhaustive rung
            # (the ladder's last rung scores every tile).
            total = sum(self.rung_counts.values())
            non_exhaustive = sum(c for r, c in self.rung_counts.items()
                                 if r < len(self.ladder) - 1)
            out["ladder"] = self.ladder
            out["rung_hit_fraction"] = (non_exhaustive / total if total
                                        else 0.0)
            out["rung_counts"] = dict(sorted(self.rung_counts.items()))
        return out


class DecodeEngine:
    """Slot-based continuous batching for LM decode.

    The reference's engine: each free slot admits the next waiting
    request (its payload's first token, position 0), every step decodes
    one token for all slots, and a slot retires its request once its
    position reaches ``min(max_new, max_len - 1)``.  ``decode_fn`` is
    called eagerly and may update the caches in place."""

    def __init__(self, decode_fn, init_caches_fn, *, n_slots: int,
                 max_len: int, k: int = 8, device="cuda"):
        """``decode_fn(tokens (B,), pos (B,), caches)`` -> (next_tokens
        (B,), caches), with ``tokens`` and ``pos`` int32 tensors on
        ``device``; caches batched over slots."""
        self.device = resolve_device(device)
        self._decode = decode_fn
        self.caches = init_caches_fn(n_slots)
        self.n_slots = n_slots
        self.max_len = max_len
        self.k = k
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)
        self.slot_token = np.zeros(n_slots, np.int32)
        self.slot_out: List[List[int]] = [[] for _ in range(n_slots)]
        self.waiting: collections.deque[Request] = collections.deque()
        self.finished: List[Tuple[Request, List[int]]] = []

    def submit(self, req: Request):
        self.waiting.append(req)

    def _admit(self):
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.waiting:
                req = self.waiting.popleft()
                self.slot_req[s] = req
                self.slot_pos[s] = 0
                self.slot_token[s] = int(np.asarray(req.payload)
                                         .reshape(-1)[0])
                self.slot_out[s] = []

    def step(self, max_new: int = 16):
        """One engine iteration: admit, decode one token for all slots,
        retire finished requests."""
        self._admit()
        active = [s for s in range(self.n_slots) if self.slot_req[s]]
        if not active:
            return
        tokens = torch.from_numpy(self.slot_token.copy()).to(self.device)
        pos = torch.from_numpy(self.slot_pos.copy()).to(self.device)
        nxt, self.caches = self._decode(tokens, pos, self.caches)
        nxt, = _read_result((nxt,))
        for s in active:
            self.slot_out[s].append(int(nxt[s]))
            self.slot_token[s] = int(nxt[s])
            self.slot_pos[s] += 1
            if self.slot_pos[s] >= min(max_new, self.max_len - 1):
                self.finished.append((self.slot_req[s], self.slot_out[s]))
                self.slot_req[s] = None

    def run(self, max_new: int = 16):
        while self.waiting or any(self.slot_req):
            self.step(max_new)
        return self.finished
