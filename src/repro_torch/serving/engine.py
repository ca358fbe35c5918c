"""Batched retrieval serving: request = user history, response = top-K items.

Backbone -> phi -> PQTopK -> TopK, batched, with deadline shedding,
bounded retry of injected failures and straggler accounting — the flat
routes of the reference's ``serving/engine.py``.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
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


class MicroBatcher:
    """Greedy size batcher with power-of-two padding buckets, so the number
    of serve variants stays bounded."""

    def __init__(self, max_batch: int = 64):
        self.max_batch = max_batch
        self.queue: collections.deque[Request] = collections.deque()

    def submit(self, req: Request):
        self.queue.append(req)

    def next_batch(self) -> List[Request]:
        out = []
        while self.queue and len(out) < self.max_batch:
            out.append(self.queue.popleft())
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


@dataclass
class InFlightBatch:
    """One dispatched batch: the device owns ``out`` until
    :meth:`RetrievalEngine.complete` waits for it."""
    prep: PreparedBatch
    out: Any
    t0: float


class RetrievalEngine:
    """Paper-mode serving: top-K item retrieval for user sequences."""

    def __init__(self, serve_fn: Callable[[torch.Tensor, int],
                                          Tuple[torch.Tensor, torch.Tensor]],
                 *, seq_len: int, k: int = 10, max_k: Optional[int] = None,
                 max_batch: int = 64, method: Optional[str] = None,
                 device="cuda", faults: Optional[Any] = None,
                 max_retries: int = 2, retry_backoff_ms: float = 1.0,
                 straggler_factor: float = 3.0):
        """``serve_fn(item_seq (B,S) int32, k)`` -> (ids (B,k), scores).

        Serve variants are memoised per ``(batch_bucket, k_bucket,
        method)``; ``stats()["n_compiles"]`` counts them, as the reference
        counts its compiled executables.  ``max_k`` caps client k (default
        ``k``).  ``faults`` (a ``ServeFaultInjector``) with ``max_retries``
        and ``retry_backoff_ms`` make :meth:`run_once` retry failed
        dispatches and shed a batch whose retries ran out."""
        self._serve_fn = serve_fn
        self._variants: Dict[Tuple[int, int, Optional[str]], Callable] = {}
        self.device = resolve_device(device)
        self.seq_len = seq_len
        self.k = k
        self.max_k = k if max_k is None else max(max_k, k)
        self.method = method
        self.batcher = MicroBatcher(max_batch=max_batch)
        self.latencies_ms: List[float] = []
        self.timeouts = 0
        self.faults = faults
        self.max_retries = max_retries
        self.retry_backoff_ms = retry_backoff_ms
        self.straggler_monitor = StragglerMonitor(factor=straggler_factor)
        self.retried = 0
        self.shed = 0
        self._batch_index = 0

    @classmethod
    def for_seqrec(cls, params, cfg, *, k: int = 10, max_batch: int = 64,
                   method: Optional[str] = None, device="cuda",
                   faults: Optional[Any] = None, max_retries: int = 2,
                   retry_backoff_ms: float = 1.0) -> "RetrievalEngine":
        """Stand up an engine on a seqrec model with a flat scoring route.
        ``method=None`` falls back to ``cfg.serve_method`` (the recjpq
        configs serve ``"pqtopk_fused"``, the fused CUDA kernel).  The
        parameters are moved to ``device``."""
        from repro_torch.interop import to_device
        from repro_torch.kernels.pqtopk import kernel as pqtopk_kernel
        from repro_torch.models import seqrec as seqrec_lib
        dev = resolve_device(device)
        method = method or getattr(cfg, "serve_method", "pqtopk")
        if method == "pqtopk_pruned":
            raise NotImplementedError(
                "method 'pqtopk_pruned' (the pruned cascade) is port slice "
                "2 and not ported yet")
        params = to_device(params, dev)
        # Largest k the route can serve: the catalogue, and for the fused
        # kernel also its item tile (pq_topk rejects k > tile).
        max_k = cfg.n_items
        if method == "pqtopk_fused":
            max_k = min(max_k, pqtopk_kernel.DEFAULT_TILE)

        def serve_fn(seqs, kk):
            return seqrec_lib.serve_topk(params, seqs, cfg, k=kk,
                                         method=method)

        return cls(serve_fn, seq_len=cfg.max_seq_len, k=k, max_k=max_k,
                   max_batch=max_batch, method=method, device=dev,
                   faults=faults, max_retries=max_retries,
                   retry_backoff_ms=retry_backoff_ms)

    def submit(self, req: Request):
        self.batcher.submit(req)

    def batch_k(self, ks: Sequence[int]) -> int:
        """The k a batch whose client ks are ``ks`` is served at: each
        clamped into [1, max_k], floored at the engine's own k, bucketed to
        a power of two so client values cannot multiply the variants."""
        kk = max(max(min(int(k), self.max_k) for k in ks), self.k, 1)
        return MicroBatcher.bucket(kk, self.max_k)

    def _variant(self, bucket: int, kk: int) -> Callable:
        """Memoised serve callable for one (batch_bucket, k_bucket, method)
        key; takes the (bucketed) sequence batch only."""
        key = (bucket, kk, self.method)
        fn = self._variants.get(key)
        if fn is None:
            fn = lambda seqs, _k=kk: self._serve_fn(seqs, _k)
            self._variants[key] = fn
        return fn

    def _shed_result(self, r: Request, now: float) -> Result:
        lat = (now - r.arrival) * 1e3
        timed_out = lat > r.deadline_ms
        self.shed += 1
        self.timeouts += int(timed_out)
        self.latencies_ms.append(lat)
        return Result(r.request_id, np.empty(0, np.int32),
                      np.empty(0, np.float32), lat, timed_out=timed_out,
                      shed=True)

    def prepare(self, reqs: List[Request]
                ) -> Tuple[List[Result], Optional[PreparedBatch]]:
        """Host side of one dispatch: shed expired requests, left-pad the
        rest into their power-of-two bucket, resolve the serve variant.
        Returns (shed results, prepared batch or None)."""
        batch_index = self._batch_index
        self._batch_index += 1
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
        bucket = MicroBatcher.bucket(len(alive), self.batcher.max_batch)
        # Requests in one batch may disagree on k: score once at the batch
        # k and give each request its own prefix (top-k prefixes nest).
        kk = self.batch_k([r.k for r in alive])
        seqs = np.zeros((bucket, self.seq_len), np.int32)
        for i, r in enumerate(alive):
            s = np.asarray(r.payload)[-self.seq_len:]
            seqs[i, -len(s):] = s
        return results, PreparedBatch(
            alive, torch.from_numpy(seqs).to(self.device),
            self._variant(bucket, kk), kk, batch_index)

    def launch(self, prep: PreparedBatch) -> InFlightBatch:
        """Dispatch a prepared batch; on the card the work is queued and
        :meth:`complete` waits for it.  Injected faults raise here, before
        dispatch, so the caller's retry loop sees them."""
        if self.faults is not None:
            self.faults.check(prep.batch_index)
        t0 = time.monotonic()
        with torch.inference_mode():
            out = prep.fn(prep.seqs)
        return InFlightBatch(prep, out, t0)

    def complete(self, inflight: InFlightBatch) -> List[Result]:
        """Wait until the batch's device work has finished, then timestamp
        it and slice per-request results.  The wait comes first: CUDA
        launches return before the card is done, and a timestamp taken
        without it would measure the enqueue."""
        prep = inflight.prep
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ids, scores = (t.cpu().numpy() for t in inflight.out)
        if self.faults is not None:
            delay = self.faults.delay_s(prep.batch_index)
            if delay:
                time.sleep(delay)      # synthetic straggler, lands in elapsed
        now = time.monotonic()
        self.straggler_monitor.record(prep.batch_index, now - inflight.t0)
        results: List[Result] = []
        for i, r in enumerate(prep.requests):
            lat = (now - r.arrival) * 1e3
            timed_out = lat > r.deadline_ms
            self.timeouts += int(timed_out)
            self.latencies_ms.append(lat)
            rk = max(1, min(r.k, prep.kk))
            results.append(Result(r.request_id, ids[i, :rk], scores[i, :rk],
                                  lat, timed_out))
        return results

    def run_once(self) -> List[Result]:
        """Serve one batch: prepare -> launch (with bounded retry of
        injected failures) -> complete."""
        reqs = self.batcher.next_batch()
        if not reqs:
            return []
        results, prep = self.prepare(reqs)
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
            results.extend(self._shed_result(r, now) for r in prep.requests)
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
        return {
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
