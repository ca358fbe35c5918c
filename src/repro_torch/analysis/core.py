"""Core of the serve-path analysis: results, the entry's recorded runs,
the pass protocol and the runner.

The reference traces each entrypoint into a jaxpr and walks it.  The port
runs eagerly, so :class:`EntryContext` runs the entry's batch and records
what happens, once on meta tensors and once on the entry's device (the
CPU, or the card).  Meta plays the part of abstract tracing: a host read
that does not go through ``kernels.cost.host_read`` raises there (no meta
tensor has data), as a concretization error does under ``jax.jit``.

Each run is warmed first (one batch outside the record: the first use of
a kernel builds and loads its library), then one batch runs inside a
``kernels.cost.recording`` block and under a ``TorchDispatchMode``
observer.  Its :class:`RunRecord` holds the launches by form with each
launch's plan inputs, the host reads by name, the host-to-device copies,
the serve variants an engine held before and after, the CUDA launch
counters' rise and, on the card, the synchronizations that
``torch.cuda.set_sync_debug_mode("warn")`` reported.  A run that raises
caches its exception instead; the passes that need the record then skip,
and ``host-reads`` reports the failure itself, as the reference's
``dispatch-count`` reports a trace failure.

:class:`Finding`, :class:`PassResult` and :class:`Report` keep the
reference's JSON keys and its rendered table.
"""
from __future__ import annotations

import threading
import time
import traceback
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

SEV_ERROR = "error"   # gating: the invariant is violated
SEV_INFO = "info"     # observations that never gate

STATUS_PASS = "pass"
STATUS_FAIL = "fail"
STATUS_SKIP = "skip"  # prerequisite missing (a run that raised)

#: The host reads' name for reading a batch's outputs, kept apart from the
#: route's own reads.
RESULT = "result"


@dataclass
class Finding:
    """One violation (or observation) from one pass on one entrypoint."""

    pass_name: str
    entrypoint: str
    severity: str              # SEV_ERROR | SEV_INFO
    code: str                  # stable machine-readable class
    message: str               # human-readable one-liner
    details: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"pass": self.pass_name, "entrypoint": self.entrypoint,
                "severity": self.severity, "code": self.code,
                "message": self.message, "details": _jsonable(self.details)}


def _jsonable(obj: Any) -> Any:
    """Best-effort conversion of finding details to JSON-safe values."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "item"):          # numpy / torch scalars
        try:
            return obj.item()
        except Exception:  # noqa: BLE001 — a tensor without data
            pass
    return repr(obj)


# ---------------------------------------------------------------------------
# the recorded runs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Copy:
    """One cross-device copy an observer saw (``aten._to_copy`` or
    ``aten.copy_``)."""
    op: str
    nbytes: int
    src: str                  # device type of the source
    dst: str                  # device type of the destination
    non_blocking: bool


@dataclass
class RunFailure:
    exc_type: str
    message: str


@dataclass
class RunRecord:
    """What one recorded batch did on one device."""
    device: str
    launches: Dict[str, int]
    inputs: List[Any]                   # kernels.cost.LaunchInputs
    host_reads: List[str]
    copies: List[Copy]
    variants: Optional[Tuple[int, int]]  # an engine's (before, after)
    cuda_launches: Optional[Dict[str, int]]   # counters' rise on the card
    sync_warnings: Optional[List[str]]        # on the card
    seconds: float

    @property
    def route_reads(self) -> List[str]:
        return [r for r in self.host_reads if r != RESULT]

    def launched(self) -> Dict[str, int]:
        return {k: v for k, v in self.launches.items() if v}


def cuda_counts() -> Dict[str, int]:
    """The CUDA wrappers' launch counters by recorded form; each counts
    the kernel launches it made, so on the CPU they stay 0."""
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.kernels.pqtopk import kernel as pq_kernel
    return {"pq_topk_fused": pq_kernel.pq_topk_fused_cuda.launches,
            "pq_topk_fused_2d": pq_kernel.pq_topk_fused_cuda.launches_2d,
            "pq_topk_fused_live": pq_kernel.pq_topk_fused_cuda.launches_live,
            "pq_scores": pq_kernel.pq_scores_cuda.launches,
            "embedding_bag": eb_kernel.embedding_bag_cuda.launches}


def _copy_observer(sink: List[Copy], lock: threading.Lock):
    """A dispatch mode class that appends every cross-device copy to
    ``sink``.  Outside inference mode a ``.to()`` reaches the mode as
    ``aten._to_copy``; inside it, as ``aten.to`` itself (the composite is
    not decomposed when autograd is off), so both are watched, and a copy
    nested in another is not counted twice."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    moves = (aten.to, aten._to_copy)

    class CopyObserver(TorchDispatchMode):
        depth = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            packet = func.overloadpacket
            if packet not in moves and packet is not aten.copy_:
                return func(*args, **kwargs)
            self.depth += 1
            try:
                out = func(*args, **kwargs)
            finally:
                self.depth -= 1
            if self.depth:
                return out
            bound = dict(zip((a.name for a in func._schema.arguments),
                             args), **kwargs)
            src, dst = ((args[0], out) if packet in moves
                        else (args[1], args[0]))
            if isinstance(src, torch.Tensor) and src.device != dst.device:
                with lock:
                    sink.append(Copy(str(packet), dst.numel()
                                     * dst.element_size(), src.device.type,
                                     dst.device.type,
                                     bool(bound.get("non_blocking", False))))
            return out

    return CopyObserver


class _Observed:
    """The recorded batch's observers: the copy observer on this thread,
    and on every other thread that runs one of ``engines``' batch steps
    (a router's workers); on the card, sync-debug warnings from any
    thread."""

    STEPS = ("prepare", "launch", "complete")

    def __init__(self, engines: Sequence[Any], sync_debug: bool):
        self.copies: List[Copy] = []
        self.sync: Optional[List[str]] = [] if sync_debug else None
        self._lock = threading.Lock()
        self._mode_cls = _copy_observer(self.copies, self._lock)
        self._engines = list(engines)
        self._thread = threading.get_ident()
        self._stack: List[Any] = []

    def _wrap(self, fn):
        def step(*a, **kw):
            if threading.get_ident() == self._thread:
                return fn(*a, **kw)
            with self._mode_cls():
                return fn(*a, **kw)
        return step

    def __enter__(self):
        import torch
        for eng in self._engines:
            for name in self.STEPS:
                setattr(eng, name, self._wrap(getattr(eng, name)))
        mode = self._mode_cls()
        mode.__enter__()
        self._stack.append(mode)
        if self.sync is not None:
            cw = warnings.catch_warnings(record=True)
            self._caught = cw.__enter__()
            warnings.simplefilter("always")
            self._stack.append(cw)
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch
        if self.sync is not None:
            torch.cuda.set_sync_debug_mode(0)
            self._stack.pop().__exit__(*exc)
            self.sync.extend(str(w.message) for w in self._caught
                             if SYNC_WARNING in str(w.message))
        self._stack.pop().__exit__(*exc)
        for eng in self._engines:
            for name in self.STEPS:
                eng.__dict__.pop(name, None)
        return False


def _read_outputs(out) -> None:
    """A caller's read of a route's outputs: every output tensor in one
    device-to-host copy (its bytes concatenated), one synchronization on
    the card."""
    import torch
    from repro_torch.kernels import cost
    ts = [t for t in (out if isinstance(out, (tuple, list)) else (out,))
          if isinstance(t, torch.Tensor)]
    if ts:
        cost.host_read(RESULT, lambda: torch.cat(
            [t.reshape(-1).contiguous().view(torch.uint8) for t in ts]
        ).cpu(), None, of=ts)


#: What ``torch.cuda.set_sync_debug_mode("warn")`` reports, as a probe on
#: an H100 with torch 2.11 found it: one warning for each ``.item()``,
#: ``int``/``bool`` of a tensor, ``tolist()``, blocking copy between the
#: card and pageable host memory (either way, ``torch.tensor(.., device=)``
#: included), ``nonzero``, ``masked_select`` and ``Stream.synchronize``;
#: none for a copy into or out of pinned memory with ``non_blocking``,
#: ``Event.synchronize`` or ``torch.cuda.synchronize``.  The first warning
#: of a process is preceded by a notice that the mode is a prototype.
SYNC_WARNING = "called a synchronizing CUDA operation"


class EntryContext:
    """Runs a built entrypoint once on meta and once on its device, each
    warmed first, and caches each run's :class:`RunRecord` (or its
    :class:`RunFailure`) for every pass.  The record keeps the rise of
    the CUDA launch counters (:func:`cuda_counts`) over the recorded
    batch, so on the card it can be held to the recorder's launches."""

    def __init__(self, name: str, built: Any, device: str):
        self.name = name
        self.built = built
        self.device = device
        self._records: Dict[str, Optional[RunRecord]] = {}
        self.failures: Dict[str, RunFailure] = {}

    @property
    def devices(self) -> Tuple[str, ...]:
        """The runs: meta, then the entry's device (meta alone when the
        analysis runs on meta)."""
        return ("meta",) if self.device == "meta" else ("meta", self.device)

    def record(self, device: str) -> Optional[RunRecord]:
        """The run on ``device`` ("meta" or the entry's device), or None
        (see :attr:`failures`)."""
        if device not in self._records:
            try:
                self._records[device] = self._run(device)
            except Exception as e:  # noqa: BLE001 — the failure IS the result
                self._records[device] = None
                self.failures[device] = RunFailure(
                    type(e).__name__, f"{e} @ " + " <- ".join(
                        f"{f.name}:{f.lineno}" for f in
                        traceback.extract_tb(e.__traceback__)[-3:]))
        return self._records[device]

    def ok(self) -> bool:
        return all(self.record(d) is not None for d in self.devices)

    def _run(self, device: str) -> RunRecord:
        built = self.built
        args = built.make_args(device)
        try:
            return self._recorded(device, args)
        finally:
            if built.release is not None:
                built.release(args)

    def _recorded(self, device: str, args) -> RunRecord:
        import torch
        from repro_torch.kernels import cost
        built = self.built
        with torch.inference_mode():
            built.fn(*args)                              # warm
        if built.between is not None:
            built.between(args)
        engines = built.engines(args) if built.engines else []
        n0 = sum(len(e._variants) for e in engines)
        on_card = torch.device(device).type == "cuda"
        if on_card:
            torch.cuda.synchronize()
        c0 = cuda_counts()
        t0 = time.perf_counter()
        with cost.recording() as rec, \
                _Observed(engines, sync_debug=on_card) as obs, \
                torch.inference_mode():
            out = built.fn(*args)
            if not built.reads_result:
                _read_outputs(out)
        secs = time.perf_counter() - t0
        if on_card:
            torch.cuda.synchronize()
        c1 = cuda_counts()
        n1 = sum(len(e._variants) for e in engines)
        return RunRecord(
            device=device, launches=dict(rec.launches),
            inputs=list(rec.inputs), host_reads=list(rec.host_reads),
            copies=list(obs.copies),
            variants=(n0, n1) if engines else None,
            cuda_launches={k: c1[k] - c0.get(k, 0) for k in c1}
            if on_card else None,
            sync_warnings=obs.sync, seconds=secs)


# ---------------------------------------------------------------------------
# pass protocol + runner
# ---------------------------------------------------------------------------

class AnalysisPass:
    """Base class for analysis passes.

    ``scope`` is ``"entrypoint"`` (run once per registered entrypoint) or
    ``"global"`` (once per analysis: the AST lint).  ``requires_record``
    makes the runner skip the pass (``STATUS_SKIP``, not a failure) when
    either run of the entrypoint raised; a pass that reports run failures
    itself sets it False."""

    name: str = "abstract"
    description: str = ""
    scope: str = "entrypoint"
    requires_record: bool = True

    def run(self, entrypoint: str, built: Any, ctx: Optional[EntryContext]
            ) -> Tuple[List[Finding], Dict[str, Any]]:
        raise NotImplementedError


@dataclass
class PassResult:
    entrypoint: str
    pass_name: str
    status: str
    findings: List[Finding] = field(default_factory=list)
    info: Dict[str, Any] = field(default_factory=dict)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_ERROR]

    def to_json(self) -> Dict[str, Any]:
        return {"entrypoint": self.entrypoint, "pass": self.pass_name,
                "status": self.status,
                "findings": [f.to_json() for f in self.findings],
                "info": _jsonable(self.info)}


@dataclass
class Report:
    results: List[PassResult]
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def errors(self) -> List[Finding]:
        return [f for r in self.results for f in r.errors]

    @property
    def ok(self) -> bool:
        return not self.errors

    def result(self, entrypoint: str, pass_name: str) -> Optional[PassResult]:
        for r in self.results:
            if r.entrypoint == entrypoint and r.pass_name == pass_name:
                return r
        return None

    def failing_passes(self, entrypoint: str) -> List[str]:
        """Names of the passes that FAILED for one entrypoint (skips are
        not failures): what a negative control asserts on ("fails its
        pass, and only its pass")."""
        return [r.pass_name for r in self.results
                if r.entrypoint == entrypoint and r.status == STATUS_FAIL]

    def to_json(self) -> Dict[str, Any]:
        return {"ok": self.ok,
                "n_errors": len(self.errors),
                "meta": _jsonable(self.meta),
                "results": [r.to_json() for r in self.results]}

    def render(self) -> str:
        """Human-readable fixed-width table + finding detail lines."""
        rows = [("entrypoint", "pass", "status", "errors", "info")]
        for r in self.results:
            info = ",".join(f"{k}={v}" for k, v in sorted(r.info.items())
                            if isinstance(v, (int, float, str, bool)))
            rows.append((r.entrypoint, r.pass_name, r.status.upper(),
                         str(len(r.errors)), info[:60]))
        widths = [max(len(row[i]) for row in rows) for i in range(4)]
        lines = ["  ".join(c.ljust(w) for c, w in zip(row, widths)) + "  "
                 + row[4] for row in rows]
        for f in self.errors:
            lines.append(f"FINDING [{f.code}] {f.entrypoint}/{f.pass_name}: "
                         f"{f.message}")
        lines.append(f"{'OK' if self.ok else 'FAIL'}: "
                     f"{len(self.results)} (entrypoint, pass) cells, "
                     f"{len(self.errors)} error finding(s)")
        return "\n".join(lines)


def _status(findings: List[Finding]) -> str:
    return (STATUS_FAIL if any(f.severity == SEV_ERROR for f in findings)
            else STATUS_PASS)


def _run_pass(p: AnalysisPass, name: str, built: Any,
              ctx: Optional[EntryContext]) -> PassResult:
    try:
        findings, info = p.run(name, built, ctx)
    except Exception as e:  # noqa: BLE001 — a crashing pass is a fail
        findings, info = [Finding(
            p.name, name, SEV_ERROR, "pass-crash",
            f"pass raised {type(e).__name__}: {e}")], {}
    return PassResult(name, p.name, _status(findings), findings, info)


def run_analysis(entrypoints: Mapping[str, Any],
                 passes: Sequence[AnalysisPass],
                 build: Callable[[str], Any], device: str = "cuda"
                 ) -> Report:
    """Run ``passes`` over ``entrypoints`` (name -> Entrypoint) on
    ``device`` (and on meta) and return the full report.  ``build(name)``
    materialises an entrypoint into a BuiltEntry (see
    :mod:`repro_torch.analysis.entrypoints`); a build failure is reported
    as a failure of every pass on that entrypoint rather than aborting the
    whole analysis.  Each entrypoint's passes run right after its own
    runs, and its context is dropped before the next, so no more than one
    entry's state is held at once."""
    import torch

    results: List[PassResult] = []
    entry_passes = [p for p in passes if p.scope == "entrypoint"]
    global_passes = [p for p in passes if p.scope == "global"]
    seconds: Dict[str, float] = {}

    for name in entrypoints:
        t0 = time.perf_counter()
        try:
            built = build(name)
        except Exception as e:  # noqa: BLE001 — report, don't abort
            for p in entry_passes:
                results.append(PassResult(name, p.name, STATUS_FAIL, [
                    Finding(p.name, name, SEV_ERROR, "build-failure",
                            f"entrypoint failed to build: "
                            f"{type(e).__name__}: {e}")]))
            continue
        ctx = EntryContext(name, built, device)
        for p in entry_passes:
            if p.requires_record and not ctx.ok():
                results.append(PassResult(
                    name, p.name, STATUS_SKIP,
                    info={"reason": "a run of the entrypoint raised",
                          "run_error": {d: f.exc_type for d, f in
                                        ctx.failures.items()}}))
                continue
            results.append(_run_pass(p, name, built, ctx))
        if built.close is not None:
            built.close()
        seconds[name] = round(time.perf_counter() - t0, 3)

    for p in global_passes:
        results.append(_run_pass(p, "<sources>", None, None))

    return Report(results, meta={"torch": torch.__version__,
                                 "device": device,
                                 "n_entrypoints": len(entrypoints),
                                 "passes": [p.name for p in passes],
                                 "seconds": seconds})
