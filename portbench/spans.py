"""The port's own spans (``repro_torch.tracing``) over runs of a cell, and
the device trace put on their clock.

  python3 portbench/spans.py --workload NAME --seeds 11,12,... \\
      [--traced-seeds 21,22] [--seconds 20] [--out FILE.json]

In one process: a run of the cell for each of ``--seeds``, the program's
tracer off and on in turns (off, on, on, off, ...), each as
``run.py --trace 0`` runs it; then a run for each of ``--traced-seeds``
with the tracer on, as ``run.py --trace 1`` runs it.  The tracer is on
from before the run's set-up to its end.  For every run with the tracer
on it reads, from the window's spans, the host metrics (:func:`host`);
for every traced run also the traced part's, and the device metrics
(:func:`device`): each kernel, copy and set of the traced part is put
down to the innermost program span that holds the host time of the
runtime call that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
matched by correlation id), and each idle stretch is split over the
innermost spans, the program's and the harness's, that cover it.  Prints
one line a run and the medians, and with ``--out`` writes every reading
there as JSON.

The harness does not enable the tracer, nor keep the profiler's runtime
events: this tool does both around ``harness.run``, reading the traced
part's profiler and context where the harness hands them to
``_read_trace``.  Spans are taken as one thread's (the harness drives
the engine from one thread), so the spans that hold a time nest.
"""
from __future__ import annotations

import bisect
import json
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]

ENGINE_SPANS = ("engine.prepare", "engine.launch", "engine.complete",
                "engine.results")
MODEL_SPANS = ("model.backbone", "model.head", "head.merge")
PROGRAM_SPANS = ENGINE_SPANS + MODEL_SPANS
HOST_METRICS = ("engine.host_gap_ms.backlog", "engine.prepare_ms.backlog",
                "engine.results_ms.backlog")
DEVICE_METRICS = ("backbone.span_device_ms.backlog",
                  "head.span_device_ms.backlog",
                  "head.merge_device_ms.backlog",
                  "backbone.launches.backlog")


class Interval(NamedTuple):
    """A named stretch of time on one clock, ``[start_ns, end_ns)``."""
    name: str
    start_ns: int
    end_ns: int


@dataclass(frozen=True)
class Op:
    """A device operation on the trace's clock, with the host time of the
    runtime call that launched it (None where the trace holds none)."""
    name: str
    start_ns: int
    end_ns: int
    launched_ns: Optional[int]

    @property
    def kernel(self) -> bool:
        low = self.name.lower()
        return "memcpy" not in low and "memset" not in low


def ops_with_launches(events: Iterable) -> List[Op]:
    """The device operations of a profiler's events (``prof.profiler.
    kineto_results.events()``), by start, each joined by correlation id
    to the runtime call (an event off the device named ``cu...``) that
    launched it."""
    launched: Dict[int, int] = {}
    device = []
    for e in events:
        if "CUDA" in str(e.device_type()):
            device.append(e)
        elif e.name().startswith("cu") and e.correlation_id():
            launched[e.correlation_id()] = e.start_ns()
    ops = [Op(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
              launched.get(e.correlation_id()))
           for e in device]
    ops.sort(key=lambda op: op.start_ns)
    return ops


class Holder:
    """Which of a set of nested intervals is the innermost at a time:
    the boundaries of every interval, each with the interval that holds
    the stretch from it to the next (None: none does)."""

    def __init__(self, intervals: Sequence[Interval]):
        self.bounds = sorted({s.start_ns for s in intervals}
                             | {s.end_ns for s in intervals})
        self.held = _innermost(self.bounds, intervals)

    def at(self, t: int) -> Optional[Interval]:
        i = bisect.bisect_right(self.bounds, t) - 1
        return self.held[i] if i >= 0 else None

    def split(self, lo: int, hi: int) -> Iterable[tuple]:
        """(interval or None, ns) pieces of [lo, hi)."""
        at, i = lo, bisect.bisect_right(self.bounds, lo) - 1
        while at < hi:
            nxt = self.bounds[i + 1] if i + 1 < len(self.bounds) else hi
            end = min(nxt, hi)
            yield (self.held[i] if i >= 0 else None), end - at
            at, i = end, i + 1


def _innermost(times: Sequence[int], intervals: Sequence[Interval]
               ) -> List[Optional[Interval]]:
    """For each time, the latest-started interval that holds it: the
    innermost where intervals nest."""
    order = sorted(range(len(times)), key=times.__getitem__)
    todo = sorted(intervals, key=lambda s: (s.start_ns, -s.end_ns))
    out: List[Optional[Interval]] = [None] * len(times)
    stack: List[Interval] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(todo) and todo[j].start_ns <= t:
            stack.append(todo[j])
            j += 1
        while stack and stack[-1].end_ns <= t:
            stack.pop()
        out[i] = stack[-1] if stack else None
    return out


def _median_ms(values: List[int]) -> Optional[float]:
    return statistics.median(values) / 1e6 if values else None


def host(spans: Sequence, lo_ns: int, hi_ns: int) -> Dict[str, Optional[float]]:
    """The host metrics of the batches whose engine spans start in
    [lo_ns, hi_ns) (``tracing.Span``s, monotonic clock):

    * ``engine.host_gap_ms``: median over consecutive batches of the next
      ``engine.launch``'s start less this batch's ``engine.results``'
      start: the host's time between one batch's device work ending and
      the next one's being launched;
    * ``engine.prepare_ms``, ``engine.results_ms``: median durations.
    """
    by = {(s.name, s.batch): s for s in spans
          if s.name in ENGINE_SPANS and lo_ns <= s.start_ns < hi_ns}

    def took(name):
        return [s.end_ns - s.start_ns for (n, _), s in by.items()
                if n == name]

    gaps = [by["engine.launch", b + 1].start_ns - s.start_ns
            for (n, b), s in by.items()
            if n == "engine.results" and ("engine.launch", b + 1) in by]
    return dict(zip(HOST_METRICS, (_median_ms(gaps),
                                   _median_ms(took("engine.prepare")),
                                   _median_ms(took("engine.results")))))


def device(ops: Sequence[Op], spans: Sequence[Interval], n_batches: int
           ) -> Dict[str, Optional[float]]:
    """The device metrics of a traced part: ``ops`` and program ``spans``
    on the trace's clock, ``n_batches`` the batches served in the part.
    A kernel counts for every span that holds its launch, so the merge's
    kernels count for ``model.head`` too.  -> per batch: device ms of the
    kernels launched in ``model.backbone``, ``model.head`` and
    ``head.merge``, the kernels launched in ``model.backbone``, and
    ``coverage``: the share (%) of the part's device time (kernels, copies
    and sets) launched inside any program span."""
    if not ops or not n_batches:
        return dict.fromkeys(DEVICE_METRICS + ("coverage",))
    holders = {name: Holder([s for s in spans if s.name == name])
               for name in MODEL_SPANS}
    anywhere = Holder(spans)
    ns = dict.fromkeys(MODEL_SPANS, 0)
    kernels = dict.fromkeys(MODEL_SPANS, 0)
    covered = total = 0
    for op in ops:
        took = op.end_ns - op.start_ns
        total += took
        if op.launched_ns is None:
            continue
        if anywhere.at(op.launched_ns) is not None:
            covered += took
        if not op.kernel:
            continue
        for name, h in holders.items():
            if h.at(op.launched_ns) is not None:
                ns[name] += took
                kernels[name] += 1
    per = [ns[name] / 1e6 / n_batches for name in MODEL_SPANS]
    return dict(zip(DEVICE_METRICS + ("coverage",),
                    per + [kernels["model.backbone"] / n_batches,
                           100.0 * covered / total if total else None]))


def idle_split(idle: Sequence[tuple], spans: Sequence[Interval],
               n_batches: int) -> Dict[str, float]:
    """Idle stretches ([lo, hi) on the trace's clock) split over the
    innermost of ``spans`` that cover each piece ("harness" where none
    does), in ms a batch, the largest first."""
    h = Holder(spans)
    out: Dict[str, float] = {}
    for lo, hi in idle:
        for s, ns in h.split(lo, hi):
            name = s.name if s is not None else "harness"
            out[name] = out.get(name, 0.0) + ns / 1e6 / n_batches
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def traced_part(tracer, ctx, taken) -> Dict[str, object]:
    """Everything read off one traced part: the harness's ``tracer`` (its
    profiler, bounds and spans), its ``ctx`` and the program's spans as
    ``tracing.take`` handed them over."""
    from portbench import trace as trace_lib
    mono, unix = taken.clock
    shift = unix - mono                         # monotonic -> the trace's
    ops = ops_with_launches(tracer.prof.profiler.kineto_results.events())
    marker = ops[0]
    offset = marker.start_ns - tracer.host_lo_ns    # the harness's marker
    lo, hi = marker.start_ns, tracer.host_hi_ns + offset
    ops = [op for op in ops[1:] if op.start_ns < hi]
    program = [Interval(s.name, s.start_ns + shift, s.end_ns + shift)
               for s in taken.spans if s.name in PROGRAM_SPANS]
    harness = [Interval(n, a + shift, b + shift) for n, a, b in tracer.spans]
    n_batches = len(ctx.traced_batch_sizes)
    idle = trace_lib.gaps([(op.start_ns, op.end_ns) for op in ops], lo, hi)
    out = device(ops, program, n_batches)
    out["launched_unmatched"] = sum(op.launched_ns is None for op in ops)
    out["idle_ms_a_batch"] = idle_split(idle, harness + program, n_batches)
    out["marker_launch_us"] = (None if marker.launched_ns is None else
                               (marker.launched_ns - shift
                                - tracer.host_lo_ns) / 1e3)
    out["marker_vs_clock_pair_us"] = (offset - shift) / 1e3
    out["traced_batches_per_s"] = n_batches / ctx.window_s
    out["traced_host"] = host(taken.spans, tracer.host_lo_ns,
                              tracer.host_hi_ns)
    return out


def measure(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, tracer_on: bool, device_name: str = "cuda"
            ) -> Dict[str, object]:
    """One run of the cell (``harness.run``), the program's tracer on or
    off around it; -> its metrics and, with the tracer on, what its spans
    read."""
    from portbench import harness
    from repro_torch import tracing
    seen = {}
    real = harness._read_trace

    def read_trace(ctx, tracer, traced, result_device, log):
        seen.update(ctx=ctx, tracer=tracer)
        return real(ctx, tracer, traced, result_device, log)

    harness._read_trace = read_trace
    if tracer_on:
        tracing.enable()
    t_run = time.monotonic()
    try:
        result = harness.run(root, workload, seed, seconds, trace,
                             device=device_name, process_t0=t_run,
                             log=lambda s: None)
    finally:
        taken = tracing.take()
        tracing.disable()
        harness._read_trace = real
    row = {"seed": seed, "trace": trace, "tracer_on": tracer_on,
           "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
    if not tracer_on:
        return row
    setup_s = (seen["ctx"].setup_s if trace
               else row["metrics"]["setup_s"])
    t0_ns = int((t_run + setup_s) * 1e9)
    row["spans_dropped"] = taken.dropped
    row["window_host"] = host(taken.spans, t0_ns,
                              t0_ns + int(seconds * 1e9))
    if trace:
        ctx, tracer = seen["ctx"], seen["tracer"]
        row["window_batches_per_s"] = len(ctx.batch_sizes) / ctx.elapsed_s
        row.update(traced_part(tracer, ctx, taken))
    return row


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--traced-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    traced = [int(s) for s in args.traced_seeds.split(",") if s]
    rows = []
    for j, seed in enumerate(seeds):
        on = j % 4 in (1, 2)                    # off, on, on, off, ...
        rows.append(measure(ROOT, args.workload, seed, args.seconds, False,
                            on))
        print(json.dumps(rows[-1]), flush=True)
    for seed in traced:
        rows.append(measure(ROOT, args.workload, seed, args.seconds, True,
                            True))
        print(json.dumps(rows[-1]), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    for on in (False, True):
        rate = [r["metrics"]["req_per_s"] for r in rows
                if not r["trace"] and r["tracer_on"] == on]
        if rate:
            print(f"tracer {'on' if on else 'off'}: req_per_s median "
                  f"{statistics.median(rate)} over {len(rate)}: {rate}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
