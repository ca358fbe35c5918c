"""Fault tolerance: injected failures, replica chaos schedules, straggler
accounting and the resumable training loop.

A copy of the reference's ``training/fault_tolerance.py``
(``FailureInjector``, ``ServeFaultInjector``, ``ReplicaFaultPlan``,
``StragglerMonitor``, ``run_with_restarts``), which imports no framework.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

log = logging.getLogger("repro_torch.fault")


class SimulatedFailure(RuntimeError):
    """A node failure / preemption injected mid-training or into a
    dispatch."""


@dataclass
class FailureInjector:
    """Deterministically fail at given steps (e.g. from a chaos schedule)."""
    fail_at_steps: Sequence[int] = ()
    _fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclass
class ServeFaultInjector:
    """Serving-side chaos schedule: deterministically fail and/or slow
    specific serve batches.

    ``fail_at_batches`` lists batch indices whose dispatch raises
    :class:`SimulatedFailure`; each listed batch fails ``fail_repeats``
    consecutive attempts (at most the engine's retry budget exercises
    retry-and-recover, more exercises shedding).  ``slow_at_batches`` lists
    batch indices that incur one extra ``slow_ms`` delay — a synthetic
    straggler.  Both are keyed on the engine's batch counter, so a chaos
    run is reproducible."""
    fail_at_batches: Sequence[int] = ()
    fail_repeats: int = 1
    slow_at_batches: Sequence[int] = ()
    slow_ms: float = 0.0
    _fail_counts: Dict[int, int] = field(default_factory=dict)
    _slowed: set = field(default_factory=set)

    def check(self, batch_index: int):
        """Raise on this attempt if the batch's failure budget remains."""
        if batch_index in self.fail_at_batches:
            c = self._fail_counts.get(batch_index, 0)
            if c < self.fail_repeats:
                self._fail_counts[batch_index] = c + 1
                raise SimulatedFailure(
                    f"injected serve failure at batch {batch_index} "
                    f"(attempt {c + 1}/{self.fail_repeats})")

    def delay_s(self, batch_index: int) -> float:
        """Extra seconds to sleep for this batch (fires once per batch)."""
        if batch_index in self.slow_at_batches \
                and batch_index not in self._slowed:
            self._slowed.add(batch_index)
            return self.slow_ms / 1e3
        return 0.0


@dataclass
class ReplicaFaultPlan:
    """Replica-level chaos schedule for the replicated serving fabric
    (``serving/router.py``): windows over one replica's *own* dispatch
    counter during which every dispatch crashes (raises
    :class:`SimulatedFailure`: a dead or preempted replica) or is slowed by
    ``slow_ms`` (a straggling replica).  Windows are half-open ``[start,
    stop)`` dispatch indices, so the i-th dispatch a replica attempts always
    meets the same fate however the router interleaves replicas.

    The layer above :class:`ServeFaultInjector` (transient per-batch faults
    inside one engine, retried by the engine's own backoff): a crash window
    long enough to exhaust the router's patience looks like a dead node and
    trips the health state machine (ejection, re-dispatch of its in-flight
    work, half-open probe re-admission once the window has passed)."""
    crash_windows: Sequence[Tuple[int, int]] = ()
    slow_windows: Sequence[Tuple[int, int]] = ()
    slow_ms: float = 0.0

    @staticmethod
    def _in(windows, idx: int) -> bool:
        return any(lo <= idx < hi for lo, hi in windows)

    def mode(self, dispatch_index: int) -> str:
        """Fate of this replica's ``dispatch_index``-th dispatch:
        ``"crash"`` beats ``"slow"`` where windows overlap."""
        if self._in(self.crash_windows, dispatch_index):
            return "crash"
        if self._in(self.slow_windows, dispatch_index):
            return "slow"
        return "ok"

    def check(self, dispatch_index: int) -> float:
        """Raise on a crashed dispatch; return the extra seconds a slowed
        dispatch must sleep (0.0 when healthy)."""
        m = self.mode(dispatch_index)
        if m == "crash":
            raise SimulatedFailure(
                f"injected replica crash at dispatch {dispatch_index}")
        return self.slow_ms / 1e3 if m == "slow" else 0.0


@dataclass
class StragglerMonitor:
    """Track a rolling median step time; steps slower than ``factor`` x
    the median are flagged."""
    factor: float = 3.0
    window: int = 50
    _times: List[float] = field(default_factory=list)
    flagged: List[int] = field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        self._times.append(seconds)
        hist = self._times[-self.window:]
        if len(hist) >= 5:
            med = float(np.median(hist))
            if seconds > self.factor * med:
                self.flagged.append(step)
                log.warning("straggler step %d: %.3fs > %.1fx median %.3fs",
                            step, seconds, self.factor, med)
                return True
        return False


def run_with_restarts(make_state: Callable[[], Any],
                      train: Callable[[Any, int], Any],
                      *, max_restarts: int = 3) -> Any:
    """Generic resumable loop: ``make_state()`` loads the latest checkpoint
    (or fresh state); ``train(state, restart_count)`` runs until completion
    or raises ``SimulatedFailure``.  Mirrors a cluster-level auto-restart
    policy."""
    restarts = 0
    while True:
        state = make_state()
        try:
            return train(state, restarts)
        except SimulatedFailure as e:
            restarts += 1
            log.warning("restart %d/%d after %s", restarts, max_restarts, e)
            if restarts > max_restarts:
                raise
