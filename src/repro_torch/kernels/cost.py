"""What a kernel launch costs: its work, its bound on the H100, and the
dry run's record of launches.

A launch's work is what its inputs' shapes say it must do: HBM bytes
(each input byte read once, each output byte written once), float32 adds
and lookups of S in shared memory.  :func:`bound_ms` turns work into the
least time the card could take (the kernel table's bound in ``PERF.md``);
``chip_smoke.py`` reads its constants from here.

:func:`launch` wraps the body of each kernel wrapper (the CUDA kernel on
the card, a meta branch on meta tensors, the plain version on the CPU).
Outside a :func:`recording` block it only calls the body.  Inside one it
also records the launch, keyed by the wrapper's form (the keys of
``chip_smoke.py: read_counts``), with its work and its plan inputs
(:class:`LaunchInputs`), whatever the inputs' device, and hides the
body's own aten ops from the recorder's observers
(:attr:`Recorder.hidden`), so a step counts the same work on meta, on the
CPU and on the card.

:func:`host_read` is the one way the serve path reads a device value on
the host: a CPU or CUDA tensor is read, a meta tensor gives the largest
value its shapes allow, and inside a recording block every read is
listed by name (:attr:`Recorder.host_reads`).  A read that bypasses it
raises on meta (``Tensor.item()`` and copies out of meta tensors have no
data), which is how the serve-path analysis (``repro_torch.analysis``)
finds it.

A manual region's body runs for one position of its mesh axis at a time
(:func:`at_position`); a launch records the position it ran at
(:attr:`Recorder.by_position`), so one device's share of a partitioned
step can be read off a run on one card.  :func:`mesh_op` wraps the
sharding helpers that cut a region's blocks and merge its positions'
values (``distributed/sharding.py``): inside a recording block it reports
each one to :attr:`Recorder.on_mesh_op`, which the partitioned count of
``launch/dryrun.py`` turns into collectives.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# The data sheet's 67 TFLOP/s in float32 counts an FMA as two operations;
# a plain add is one instruction, so adds alone peak at half that.
F32_ADDS_PER_S = 67e12 / 2
# Shared memory serves 32 banks x 4 B per SM per clock, so at most 32
# four-byte lookups per SM per clock (NVIDIA Hopper tuning guide), at the
# H100 SXM's 1.98 GHz maximum boost clock (data sheet).
SMEM_LOOKUPS_PER_SM_CLOCK = 32
SM_CLOCK_HZ = 1.98e9
H100_SMS = 132                     # H100 SXM

#: The recorded forms, as ``chip_smoke.py: read_counts`` names them.
FORMS = ("pq_topk_fused", "pq_topk_fused_2d", "pq_topk_fused_live",
         "pq_scores", "embedding_bag")


def bound_ms(nbytes: float, n_adds: float, n_lookups: float, n_sms: int):
    """Least time for the work: HBM bytes, f32 adds, and shared-memory
    lookups of S (the gather form's inherent operation).  Returns
    (ms, "bytes" or "operations", the three terms in ms)."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "adds": n_adds / F32_ADDS_PER_S * 1e3,
             "lookups": n_lookups / (SMEM_LOOKUPS_PER_SM_CLOCK * n_sms
                                     * SM_CLOCK_HZ) * 1e3}
    worst = max(terms, key=terms.get)
    return (terms[worst], "bytes" if worst == "bytes" else "operations",
            terms)


@dataclass(frozen=True)
class Work:
    """One launch's work."""
    bytes: int
    adds: int
    lookups: int


def pq_scores_work(n: int, m: int, code_bytes: int, bq: int, b: int
                   ) -> Work:
    """``pq_scores``: codes (N, m), S (B, m, b) f32 -> (B, N) f32."""
    return Work(n * m * code_bytes + bq * m * b * 4 + bq * n * 4,
                bq * n * (m - 1), bq * n * m)


def pq_topk_fused_work(n: int, m: int, code_bytes: int, bq: int, b: int,
                       k: int, slots: int, n_rows: int, tile: int,
                       live: bool) -> Work:
    """The fused kernel over ``n_rows`` slot rows of ``slots`` slots each
    (1 row: a 1D list): each query scores every row of every listed tile
    (no more than the catalogue), a sentinel slot counted as a full tile;
    the codes (and the ``live`` bytes) of at most N rows are read once,
    and (B, slots, k) values and ids are written."""
    rows = min(n, slots * tile)
    read = min(n, n_rows * slots * tile)
    pairs = bq * rows
    return Work(read * m * code_bytes + (read if live else 0)
                + bq * m * b * 4 + n_rows * slots * 4 + bq * slots * k * 8,
                pairs * (m - 1), pairs * m)


def embedding_bag_work(v: int, d: int, n_bags: int, bag: int,
                       weighted: bool) -> Work:
    """``embedding_bag``: at most ``min(V, slots)`` distinct rows of the
    f32 table, the indices, the weights if any, and the (n_bags, d)
    output; a multiply and an add per slot element."""
    slots = n_bags * bag
    return Work(min(v, slots) * d * 4 + slots * 4 + (slots * 4 if weighted
                                                     else 0)
                + n_bags * d * 4, 2 * slots * d, 0)


@dataclass(frozen=True)
class LaunchInputs:
    """What one pqtopk launch's plan and contract depend on: ``kind``
    ("scores" or "fused", ``kernel.plan_launch``'s), the shapes, the
    code dtype's bytes, and for the fused kernel the item tile, the 2D
    table's batch tile (0 for a 1D list), the ``live`` mask, the slot
    count and the slot table itself (a tensor on the launch's device);
    ``dtype`` names the codes' dtype."""
    form: str
    kind: str
    n: int
    m: int
    b: int
    bq: int
    code_bytes: int
    k: int = 0
    n_items: int = 0
    tile: int = 0
    batch_tile: int = 0
    live: bool = False
    slots: int = 0
    table: Any = None
    dtype: str = ""

    def plan_key(self):
        """The arguments of ``kernel.plan_launch`` for this launch."""
        return (self.kind, self.m, self.b, self.bq, self.code_bytes,
                self.n if self.kind == "scores" else 0, self.tile,
                self.batch_tile, self.live)


@dataclass
class Recorder:
    """Launches and work of the kernel wrappers called inside one
    :func:`recording` block.  ``on_launch(name, work, outputs, reads)``, if
    set, sees each launch's outputs and the tensors its kernel reads (the
    dry run tracks their storage);
    ``hidden`` > 0 while a wrapper's body runs, ``in_mesh_op`` > 0 while a
    :func:`mesh_op`'s does (``on_mesh_op(kind, parts, out, info)`` sees
    each one after it ran); ``inputs`` lists each launch's
    :class:`LaunchInputs` (pqtopk launches); ``by_position`` holds the
    launches and work per form of each :func:`at_position` (``None``:
    outside every manual region); ``host_reads`` names every
    :func:`host_read` in order, and ``stand_ins`` those of a meta tensor,
    which took their largest value."""
    launches: Dict[str, int] = field(
        default_factory=lambda: dict.fromkeys(FORMS, 0))
    work: Dict[str, Dict[str, int]] = field(
        default_factory=lambda: {f: {"bytes": 0, "adds": 0, "lookups": 0}
                                 for f in FORMS})
    inputs: List[LaunchInputs] = field(default_factory=list)
    host_reads: List[str] = field(default_factory=list)
    stand_ins: List[str] = field(default_factory=list)
    by_position: Dict[Any, Dict[str, Dict[str, int]]] = field(
        default_factory=dict)
    on_launch: Optional[Callable[[str, Work, Any, Tuple], None]] = None
    on_mesh_op: Optional[Callable[[str, Tuple, Any, Dict], None]] = None
    hidden: int = 0
    in_mesh_op: int = 0

    def add(self, name: str, work: Work, outputs: Any,
            inputs: Optional[LaunchInputs] = None, reads: Tuple = ()
            ) -> None:
        self.launches[name] += 1
        w = self.work[name]
        w["bytes"] += work.bytes
        w["adds"] += work.adds
        w["lookups"] += work.lookups
        at = self.by_position.setdefault(current_position(), {})
        p = at.setdefault(name, {"launches": 0, "bytes": 0, "adds": 0,
                                 "lookups": 0})
        p["launches"] += 1
        p["bytes"] += work.bytes
        p["adds"] += work.adds
        p["lookups"] += work.lookups
        if inputs is not None:
            self.inputs.append(inputs)
        if self.on_launch is not None:
            self.on_launch(name, work, outputs, reads)

    def totals(self) -> Dict[str, int]:
        return {key: sum(w[key] for w in self.work.values())
                for key in ("bytes", "adds", "lookups")}


_ACTIVE: List[Recorder] = []
_POSITION: ContextVar[Optional[Tuple[str, int]]] = ContextVar(
    "mesh_position", default=None)


def current_position() -> Optional[Tuple[str, int]]:
    """``(axis, index)`` of the manual region's body running in this
    thread, or ``None``."""
    return _POSITION.get()


@contextmanager
def at_position(position: Optional[Tuple[str, int]]):
    """Run the block as position ``(axis, index)`` of a manual region's
    axis (``None``: as the caller runs)."""
    if position is None:
        yield
        return
    tok = _POSITION.set(tuple(position))
    try:
        yield
    finally:
        _POSITION.reset(tok)


def active() -> Optional[Recorder]:
    """The recorder of the innermost open :func:`recording` block, or
    ``None``."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextmanager
def recording(recorder: Optional[Recorder] = None):
    """Record every kernel wrapper's launches, from any thread, into
    ``recorder`` (a new one by default) until the block ends."""
    rec = Recorder() if recorder is None else recorder
    _ACTIVE.append(rec)
    try:
        yield rec
    finally:
        _ACTIVE.remove(rec)


def launch(name: str, work: Callable[[], Work], body: Callable[[], Any],
           inputs: Optional[Callable[[], LaunchInputs]] = None,
           reads: Tuple = ()):
    """Run one wrapper's kernel ``body`` (returns its outputs); inside a
    :func:`recording` block, record the launch as ``name`` with
    ``work()``, ``inputs()`` and ``reads`` (the tensors the kernel reads;
    ``None`` entries ignored), the body's aten ops hidden."""
    rec = active()
    if rec is None:
        return body()
    rec.hidden += 1
    try:
        out = body()
    finally:
        rec.hidden -= 1
    rec.add(name, work(), out, None if inputs is None else inputs(),
            tuple(t for t in reads if t is not None))
    return out


def mesh_op(kind: str, body: Callable[[], Any], parts: Tuple = (),
            **info):
    """Run a sharding helper's ``body`` -> its result.  Inside a
    recording block its aten ops are marked (:attr:`Recorder.in_mesh_op`)
    and ``on_mesh_op(kind, parts, result, info)`` is called after it:
    ``kind`` names the helper (a region's ``block``, ``shard_rows``, a
    merge such as ``all_gather``, a ``constraint``), ``parts`` are the
    tensors it takes, ``info`` its mesh, axis, dimension or sharding."""
    rec = active()
    if rec is None:
        return body()
    rec.in_mesh_op += 1
    try:
        out = body()
    finally:
        rec.in_mesh_op -= 1
    if rec.on_mesh_op is not None:
        rec.on_mesh_op(kind, tuple(parts), out, info)
    return out


def host_read(what: str, read: Callable[[], Any], largest, *, of):
    """A host read of the device value(s) in ``of`` (a tensor, or the
    first of a sequence): ``read()`` on the CPU or the card; on meta,
    ``largest`` (called first if callable), the most the shapes allow,
    and the read is noted as a stand-in.  Inside a recording block the
    read is listed as ``what``."""
    t = of[0] if isinstance(of, (list, tuple)) else of
    rec = active()
    if rec is not None:
        rec.host_reads.append(what)
    if t.is_meta:
        if rec is not None:
            rec.stand_ins.append(what)
        return largest() if callable(largest) else largest
    return read()
