"""One run of one cell: set-up, the measured window, the metrics and the
check of what the window served.

Everything is found by name.  ``BENCHMARK.json`` names the cell; the
cell names its configuration (``configs/<name>.json``) and its traffic
mix (``traffic/<name>.json``); the configuration names its plain
reference (a file under ``reference/``); each metric, end-to-end or
per-layer, is read by ``metrics/<name>.py``'s ``read(ctx)``, which
returns a number or None where it finds nothing to read.  A new cell or
metric is new files and entries; no file here changes.

The engine is driven only through its public loop (``submit``,
``batcher.ready``, ``run_once``, ``drain``), so whatever the engine does
inside ``run_once`` is measured as it is.  The window is the same with
``trace=1``: the device profiler is first started once the window has
closed and its answers are in, and traces a further ``TRACE_SECONDS``
of the same traffic (an open mix's arrivals after the window, shifted
to start with the traced part), with the engine's ``prepare``,
``launch`` and ``complete`` timed on the host as spans.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import resource
import subprocess
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from repro_torch.configs.base import PQConfig, SeqRecConfig
from repro_torch.serving.engine import Request, RetrievalEngine

from portbench import check, seeds, trace as trace_lib, traffic, weights
from portbench import yardstick

TRACE_SECONDS = 4.0
WARM_REPEATS = 3


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Dict[str, Any]:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        return json.loads((self.dir / "configs" / f"{name}.json").read_text())

    def traffic(self, name: str) -> Dict[str, Any]:
        return traffic.load(self.dir / "traffic", name)

    def end_to_end(self, cell: str) -> List[Dict[str, Any]]:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict[str, Any]]:
        """Metrics listed for ``cell``, or, without a list, reported by
        every cell that reports the end-to-end metric they move."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def _module(self, path: Path, prefix: str) -> ModuleType:
        name = prefix + path.stem.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def reader(self, metric: str) -> Callable[[Any], Optional[float]]:
        return self._module(self.dir / "metrics" / f"{metric}.py",
                            "portbench_metric_").read

    def reference(self, cfg: Dict[str, Any]) -> ModuleType:
        """The plain reference the configuration names (a path from the
        root): ``layout``, ``all_scores`` and ``top_k``."""
        return self._module(self.root / cfg["reference"],
                            "portbench_reference_")


def program_config(cfg: Dict[str, Any]) -> SeqRecConfig:
    """The program's configuration object for a configuration file: every
    key of the file that ``SeqRecConfig`` (and ``PQConfig``) has."""
    fields = {f.name for f in dataclasses.fields(SeqRecConfig)}
    pq_fields = {f.name for f in dataclasses.fields(PQConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields and k != "pq"}
    kw.setdefault("param_dtype", cfg["dtype"])
    return SeqRecConfig(**kw, pq=PQConfig(**{k: v for k, v in cfg["pq"].items()
                                             if k in pq_fields}))


def bucket(n: int, max_batch: int) -> int:
    """The power-of-two rows a batch of ``n`` requests is padded to."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """The profiler over the traced part, and the host spans taken inside
    it (monotonic ns)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.inside = False
        self.spans: List[Tuple[str, int, int]] = []
        self.prof = None
        self.host_lo_ns = self.host_hi_ns = 0

    def _new(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        return self.prof

    def begin(self) -> None:
        """Start the device tracer (once idle first: its first start sets
        up the tracer, which takes seconds), then mark the two clocks."""
        self._new().start()
        _sync(self.device)
        self.prof.stop()
        self._new().start()
        _sync(self.device)
        self.host_lo_ns = time.monotonic_ns()
        torch.ones(1, device=self.device)       # the clocks' marker
        _sync(self.device)
        self.inside = True

    def end(self) -> None:
        _sync(self.device)
        self.host_hi_ns = time.monotonic_ns()
        self.prof.stop()
        self.inside = False

    def span(self, name: str, t0_ns: int) -> None:
        if self.inside:
            self.spans.append((name, t0_ns, time.monotonic_ns()))

    def wrap(self, engine) -> None:
        """Time the engine's prepare, launch and complete as host spans."""
        for name in ("prepare", "launch", "complete"):
            def timed(*a, _fn=getattr(engine, name), _name="engine." + name,
                      **kw):
                t = time.monotonic_ns()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.span(_name, t)
            setattr(engine, name, timed)


class Answers:
    """What each request was answered with, by request id: the host time
    of its answer (NaN: none yet), its latency, its k ids and scores, and
    whether it came whole (k answers, not shed).  Copies are kept, not
    the engine's results, so that the engine's buffers are freed as a
    server that sends its answers frees them."""

    def __init__(self, capacity: int, k: int):
        self.k = k
        self.at = np.full(capacity, np.nan)
        self.latency_ms = np.full(capacity, np.nan)
        self.ids = np.zeros((capacity, k), np.int64)
        self.scores = np.zeros((capacity, k), np.float32)
        self.whole = np.zeros(capacity, bool)

    def _fit(self, n: int) -> None:
        cap = len(self.at)
        if n <= cap:
            return
        new = max(n, 2 * cap)
        self.at = np.concatenate([self.at, np.full(new - cap, np.nan)])
        self.latency_ms = np.concatenate([self.latency_ms,
                                          np.full(new - cap, np.nan)])
        self.ids = np.concatenate([self.ids, np.zeros((new - cap, self.k),
                                                      np.int64)])
        self.scores = np.concatenate([self.scores, np.zeros(
            (new - cap, self.k), np.float32)])
        self.whole = np.concatenate([self.whole, np.zeros(new - cap, bool)])

    def record(self, results, t: float) -> None:
        if not results:
            return
        rid = np.fromiter((r.request_id for r in results), np.int64,
                          len(results))
        self._fit(int(rid.max()) + 1)
        self.at[rid] = t
        self.latency_ms[rid] = [r.latency_ms for r in results]
        try:
            ids = np.stack([r.items for r in results])
            scores = np.stack([r.scores for r in results])
        except ValueError:            # answers of different lengths
            ids = None
        if ids is not None and ids.shape[1] == self.k:
            self.ids[rid] = ids
            self.scores[rid] = scores
            self.whole[rid] = True
            return
        for i, r in zip(rid, results):
            whole = not r.shed and len(r.items) == self.k
            self.whole[i] = whole
            if whole:
                self.ids[i] = r.items
                self.scores[i] = r.scores

    def failed(self, attempted: int, n_rows: int) -> int:
        """Requests 0 .. attempted-1 not answered, or answered with other
        than k distinct ids of the catalogue's rows."""
        ids = self.ids[:attempted]
        good = (~np.isnan(self.at[:attempted]) & self.whole[:attempted]
                & ((ids >= 0) & (ids < n_rows)).all(1))
        if self.k > 1:
            good &= (np.diff(np.sort(ids, 1), axis=1) != 0).all(1)
        return int(attempted - good.sum())


@dataclasses.dataclass
class Loop:
    """The harness's side of the engine's public loop, with what it
    served: each batch's (start, end, answers) on the host's clock."""
    engine: Any
    hist: traffic.Histories
    mix: Dict[str, Any]
    answers: Answers
    tracer: Tracer
    next_id: int = 0
    outstanding: int = 0
    batches: List[Tuple[float, float, int]] = dataclasses.field(
        default_factory=list)
    extra_chunks: int = 0
    deepest: Tuple[int, float] = (0, 0.0)

    def serve(self) -> None:
        """One ``run_once``; its answers and its span recorded."""
        ts, t_ns = time.monotonic(), time.monotonic_ns()
        res = self.engine.run_once()
        te = time.monotonic()
        self.tracer.span("run_once", t_ns)
        self.answers.record(res, te)
        self.batches.append((ts, te, len(res)))
        self.outstanding -= len(res)

    def submit(self, i: int, arrival: float) -> None:
        if i >= len(self.hist):
            self.extra_chunks += self.hist.ensure(i + 1)
        self.engine.submit(Request(i, self.hist.get(i), k=int(self.mix["k"]),
                                   arrival=arrival))
        self.outstanding += 1

    def closed(self, until: float) -> None:
        """Keep ``waiting`` requests submitted; serve whole batches until
        one ends at or after ``until``."""
        waiting = int(self.mix["waiting"])
        while True:
            now = time.monotonic()
            if now >= until:
                return
            t_ns = time.monotonic_ns()
            while self.outstanding < waiting:
                self.submit(self.next_id, now)
                self.next_id += 1
            self.tracer.span("submit", t_ns)
            self.serve()

    def open(self, due: np.ndarray, until: float,
             lateness: np.ndarray) -> None:
        """Submit request i once ``due[i]`` (host clock) has passed; serve
        a batch whenever the batcher is ready; stop at ``until``."""
        n = len(due)
        i = self.next_id
        while True:
            now = time.monotonic()
            if now >= until:
                break
            if i < n and due[i] <= now:
                t_ns = time.monotonic_ns()
                while i < n and due[i] <= now:
                    self.submit(i, float(due[i]))
                    lateness[i] = now - due[i]
                    i += 1
                self.tracer.span("submit", t_ns)
                q = len(self.engine.batcher.queue)
                if q > self.deepest[0]:
                    self.deepest = (q, now)
            if self.outstanding and self.engine.batcher.ready(now):
                self.serve()
                continue
            # Idle until the next arrival, polling a waiting batch's
            # deadline.  The clock is polled, not slept on: a sleep of a
            # fraction of a millisecond can overrun by several.
            wake = min(float(due[i]) if i < n else until, until)
            if self.outstanding:
                wake = min(wake, now + 2e-4)
            t_ns = time.monotonic_ns()
            while time.monotonic() < wake:
                pass
            self.tracer.span("wait", t_ns)
        self.next_id = i

    def finish(self, due: Optional[np.ndarray] = None) -> None:
        """Submit what else is due (late is not wrong) and answer all."""
        if due is not None:
            for i in range(self.next_id, len(due)):
                self.submit(i, float(due[i]))
            self.next_id = len(due)
        self.answers.record(self.engine.drain(), time.monotonic())
        self.outstanding = 0


def _warm(engine, mix, cfg, seed, device) -> None:
    """Serve the mix's batches before the window, through the public loop,
    on histories of their own: a closed backlog runs its own loop for
    ``WARM_REPEATS`` full batches and drains what it left waiting, as the
    window does; an open loop serves every power of two up to
    ``max_batch`` ``WARM_REPEATS`` times."""
    max_batch, k = int(mix["max_batch"]), int(mix["k"])
    hist = traffic.Histories(mix, cfg["n_items"], seed, device,
                             stream=seeds.WARM)
    if mix["loop"] == "closed":
        waiting = int(mix["waiting"])
        hist.ensure(waiting + WARM_REPEATS * max_batch)
        loop = Loop(engine, hist, mix, Answers(len(hist), k), Tracer(device))
        for _ in range(WARM_REPEATS):
            while loop.outstanding < waiting:
                loop.submit(loop.next_id, time.monotonic())
                loop.next_id += 1
            loop.serve()
        loop.finish()
        sizes = [n for _, _, n in loop.batches]
        if sizes != [max_batch] * WARM_REPEATS:
            raise RuntimeError(f"warm-up batches of {sizes}, not "
                               f"{max_batch}")
    else:
        sizes = [1 << j for j in range(max_batch.bit_length())
                 if 1 << j <= max_batch]
        hist.ensure(WARM_REPEATS * sum(sizes))
        at = 0
        for size in sizes:
            for _ in range(WARM_REPEATS):
                for _ in range(size):
                    engine.submit(Request(-1 - at, hist.get(at), k=k))
                    at += 1
                if len(engine.run_once()) != size:
                    raise RuntimeError("a warm-up batch was not served whole")
    _sync(device)


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable: power limit unknown"


def _thread_cpu_s() -> float:
    u = resource.getrusage(resource.RUSAGE_THREAD)
    return u.ru_utime + u.ru_stime


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        *, device="cuda", process_t0: Optional[float] = None,
        control: bool = False, mix_overrides: Optional[Dict] = None,
        log: Callable[[str], None] = print) -> Dict[str, Any]:
    """One run of ``workload``; -> the result's JSON object.  ``control``
    adds the control's two numbers on the same sample (``control.py``);
    ``mix_overrides`` replaces keys of the traffic mix (``sweep.py``)."""
    t_start = time.monotonic() if process_t0 is None else process_t0
    device = torch.device(device)
    bench = Bench(root)
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    mix = {**bench.traffic(cell["traffic"]), **(mix_overrides or {})}
    ref = bench.reference(cfg)
    k = int(mix["k"])
    params = weights.make(cfg, ref.layout(cfg), seed, device)
    engine = RetrievalEngine.for_seqrec(params, program_config(cfg), k=k,
                                        max_batch=int(mix["max_batch"]),
                                        device=device)
    hist = traffic.Histories(mix, cfg["n_items"], seed, device)
    extra = TRACE_SECONDS if trace else 0.0
    due = None
    if mix["loop"] == "closed":
        hist.ensure(int(mix["pregen_req_per_s"] * (seconds + extra))
                    + int(mix["waiting"]))
    else:
        due = traffic.arrivals(mix, seed, seconds + extra)
        hist.ensure(len(due))
    _warm(engine, mix, cfg, seed, device)
    tracer = Tracer(device)
    loop = Loop(engine, hist, mix, Answers(len(hist), k), tracer)
    lateness = np.full(0 if due is None else len(due), np.nan)
    # The collector stays off in the window: a full collection stalls the
    # loop for milliseconds, which no server pays.
    gc.collect()
    gc.freeze()
    gc.disable()
    cpu0 = _thread_cpu_s()
    t0 = time.monotonic()
    if due is None:
        loop.closed(t0 + seconds)
        t_close = time.monotonic()
        elapsed = t_close - t0          # the window ends with a batch
        n_window = loop.next_id
    else:
        n_window = int(np.searchsorted(due, seconds))
        loop.open(t0 + due[:n_window], t0 + seconds, lateness)
        t_close = time.monotonic()
        elapsed = seconds
    cpu1 = _thread_cpu_s()
    setup_s = t0 - t_start
    t_end = t0 + elapsed
    window_batches = [n for _, te, n in loop.batches if te <= t_end]
    deepest = loop.deepest
    # Answer everything the window left (late is not wrong), then read the
    # peak before anything else runs.
    loop.finish(None if due is None else t0 + due[:n_window])
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    traced = None
    if trace:
        traced = _trace_part(loop, tracer, due, seconds, lateness)
    del engine, loop.engine
    gc.enable()
    gc.unfreeze()
    gc.collect()
    answers = loop.answers
    attempted = loop.next_id
    if loop.extra_chunks:
        log(f"generator: {loop.extra_chunks} chunks of histories made "
            "inside the run (the pre-made pool ran out)")
    late = lateness[:n_window] * 1e3
    late = late[~np.isnan(late)]
    if len(late):
        log(f"generator lateness ms: median {np.median(late)} p99 "
            f"{np.percentile(late, 99)} max {late.max()} over {len(late)} "
            f"requests submitted in the window of {n_window} due")
    log(f"window {t_close - t0} s of {seconds}; {len(window_batches)} "
        "batches")
    spans = np.asarray([(ts, te) for ts, te, _ in loop.batches
                        if te <= t_end]).reshape(-1, 2)
    took = (spans[:, 1] - spans[:, 0]) * 1e3
    if len(took):
        slow = int(np.argmax(took))
        log(f"run_once ms: median {np.median(took)} p99 "
            f"{np.percentile(took, 99)} max {took[slow]} (batch {slow}, "
            f"{spans[slow, 0] - t0} s into the window)")
    log(f"host: the loop's thread ran {cpu1 - cpu0} s of the window's "
        f"{t_close - t0}")

    # Metrics.
    answered = np.nonzero(answers.at[:n_window] <= t_end)[0]
    log(f"answered in the window {len(answered)}; unanswered at the close "
        f"{n_window - len(answered)}")
    latencies = None
    if due is not None:
        at = answers.at[:n_window]
        latencies = np.where(at <= t_end, answers.latency_ms[:n_window],
                             (t_end - (t0 + due[:n_window])) * 1e3)
        slow = np.nonzero(latencies > 100.0)[0]
        sizes = np.asarray(window_batches)
        log(f"open loop: {len(slow)} requests over 100 ms"
            + (f", due {due[slow[0]]} to {due[slow[-1]]} s into the window"
               if len(slow) else "")
            + f"; deepest batcher queue {deepest[0]} at "
            f"{deepest[1] - t0} s; batches under half of max_batch: "
            f"{int((sizes < int(mix['max_batch']) // 2).sum())} of "
            f"{len(sizes)}")
    ctx = SimpleNamespace(cfg=cfg, mix=mix, cell=cell, seconds=seconds,
                          elapsed_s=elapsed, setup_s=setup_s,
                          completed=len(answered), latencies_ms=latencies,
                          batch_sizes=window_batches,
                          request_lengths=hist.lengths(answered),
                          yardstick=yardstick, bucket=bucket)
    result_device = {"platform": "gpu" if device.type == "cuda" else "cpu",
                     "kind": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                     "count": int(cell["chips"]),
                     "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        breakdown = _read_trace(ctx, tracer, traced, result_device, log)
        wanted = bench.per_layer(workload)
    else:
        wanted = bench.end_to_end(workload)
    metrics = {}
    for m in wanted:
        value = bench.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # The check.
    n_sample = int(cfg["check"]["sample"])
    sampled = check.sample(answered, hist.lengths(answered), n_sample,
                           seeds.numpy_rng(seed, seeds.SAMPLE))
    failed = answers.failed(attempted, cfg["n_items"] + 1)
    histories = [hist.get(i) for i in sampled]
    numbers = check.judge(ref, params, cfg, histories, answers.ids[sampled],
                          answers.scores[sampled], device) \
        if sampled else {n: float("nan") for n in check.NUMBERS}
    limits = cfg["check"]["limits"]
    correct = failed == 0 and bool(sampled) and check.verdict(numbers, limits)
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in check.NUMBERS}
    checks["failed"] = {"value": failed, "limit": 0}
    checks["sampled"] = {"value": len(sampled), "limit": n_sample}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control and sampled:
        ids, vals = check.control_answers(ref, params, cfg, histories, k,
                                          device)
        result["control"] = check.judge(ref, params, cfg, histories, ids,
                                        vals, device)
    log(f"{_card_line()}; peaks {yardstick.F32_FLOP_PER_S:.3e} FLOP/s f32, "
        f"{yardstick.HBM_BYTES_PER_S:.3e} B/s HBM")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    result["checks"] = checks
    return result


def _trace_part(loop: Loop, tracer: Tracer, due, seconds: float,
                lateness: np.ndarray) -> Dict[str, Any]:
    """Trace ``TRACE_SECONDS`` more of the traffic after the window: a
    backlog goes on as it was, an open mix's later arrivals come shifted
    to start with the traced part.  -> its bounds and batches."""
    first = len(loop.batches)
    tracer.wrap(loop.engine)
    tracer.begin()
    t_lo = time.monotonic()
    if due is None:
        loop.closed(t_lo + TRACE_SECONDS)
    else:
        start = loop.next_id
        shifted = np.concatenate([np.full(start, -np.inf),
                                  t_lo + due[start:] - seconds])
        loop.open(shifted, t_lo + TRACE_SECONDS, lateness)
    tracer.end()
    loop.finish(None if due is None else np.concatenate(
        [np.full(loop.next_id, -np.inf),
         t_lo + due[loop.next_id:] - seconds]))
    return {"batches": loop.batches[first:]}


def _read_trace(ctx, tracer: Tracer, traced: Dict[str, Any], result_device,
                log: Callable[[str], None]) -> Dict[str, Any]:
    """Fill ``ctx`` with the traced part's device operations and batches;
    -> the breakdown."""
    ops = trace_lib.device_ops(tracer.prof)
    if not ops:
        raise RuntimeError("the trace holds no device operation")
    if "Fill" not in ops[0].name:
        log(f"trace: the first operation is {ops[0].name[:80]}, not the "
            "clocks' marker; host spans may be off by its distance")
    offset = ops[0].start_ns - tracer.host_lo_ns        # the marker
    lo, hi = ops[0].start_ns, tracer.host_hi_ns + offset
    ops = [op for op in ops[1:] if op.start_ns < hi]
    intervals = [(op.start_ns, op.end_ns) for op in ops]
    busy = trace_lib.busy_ns(intervals, lo, hi)
    lo_s, hi_s = tracer.host_lo_ns / 1e9, tracer.host_hi_ns / 1e9
    batches = [(ts, te, n) for ts, te, n in traced["batches"]
               if ts >= lo_s and te <= hi_s]
    ctx.ops = ops
    ctx.window_s = (hi - lo) / 1e9
    ctx.busy_s = busy / 1e9
    ctx.traced_batch_sizes = [n for _, _, n in batches]
    log(f"traced part: {ctx.window_s} s, {len(batches)} batches, "
        f"{len(ops)} device operations")
    result_device["busy_s"] = ctx.busy_s
    result_device["window_s"] = ctx.window_s
    spans = [(name, s + offset, e + offset) for name, s, e in tracer.spans]
    return {"device_ops": trace_lib.top_ops(ops),
            "idle_gaps": trace_lib.longest_gaps(
                trace_lib.gaps(intervals, lo, hi), spans)}
