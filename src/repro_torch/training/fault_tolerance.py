"""Serve-side fault tolerance: injected failures and straggler accounting.

A copy of the serving classes of the reference's
``training/fault_tolerance.py``, which imports no framework.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

log = logging.getLogger("repro_torch.fault")


class SimulatedFailure(RuntimeError):
    """A node failure / preemption injected into a dispatch."""


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
