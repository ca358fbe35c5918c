"""Reading a ``torch.profiler`` trace of the card: every kernel, copy and
set on the device with its interval, the union of those intervals (the
time the device was busy), the gaps between them, and which of the
harness's host spans each gap fell in.

The profiler traces the device alone (``ProfilerActivity.CUDA``), but
its activity records still slow every launch on the host, and once it
has been started the process's launches stay slower: the harness starts
it only after the measured window.  Host spans are taken on the host's
clock; one marker kernel launched right after a synchronise ties the two
clocks: its start on the device, less the host's time just before its
launch, is the offset (off by the launch latency, some microseconds).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[int, int]


@dataclass(frozen=True)
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int


def device_ops(prof) -> List[DeviceOp]:
    """Every operation the trace saw on a CUDA device, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = (e.duration_ns() if hasattr(e, "duration_ns")
               else e.duration_us() * 1000)
        out.append(DeviceOp(e.name(), int(start), int(start + dur)))
    out.sort(key=lambda op: op.start_ns)
    return out


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same time."""
    merged: List[Interval] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def clip(intervals: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def busy_ns(intervals: Sequence[Interval], lo: int, hi: int) -> int:
    return sum(e - s for s, e in clip(union(intervals), lo, hi))


def gaps(intervals: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The idle stretches of [lo, hi] between busy intervals."""
    out, at = [], lo
    for s, e in clip(union(intervals), lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def label(gap: Interval, spans: Sequence[Tuple[str, int, int]]) -> str:
    """The innermost host span (name, start, end; device clock) that holds
    the gap's start; "harness" where none does."""
    best = None
    for name, s, e in spans:
        if s <= gap[0] < e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0] if best else "harness"


def top_ops(ops: Sequence[DeviceOp], n: int = 10) -> List[List]:
    """[name, seconds] of the ``n`` operations that took most time."""
    total: collections.Counter = collections.Counter()
    for op in ops:
        total[op.name] += op.end_ns - op.start_ns
    return [[name, ns / 1e9] for name, ns in total.most_common(n)]


def longest_gaps(idle: Sequence[Interval],
                 spans: Sequence[Tuple[str, int, int]],
                 n: int = 10) -> List[List]:
    """[host span, seconds] of the ``n`` longest idle gaps."""
    idle = sorted(idle, key=lambda g: g[0] - g[1])[:n]
    return [[label(g, spans), (g[1] - g[0]) / 1e9] for g in idle]
