"""Entrypoint registry for the serve-path analysis.

An :class:`Entrypoint` names one serving computation worth guarding and
knows how to build it, for one device, into a :class:`BuiltEntry`: a
callable, a maker of its arguments on any device (the device itself, or
meta), and the contracts the passes hold the recorded runs to: the
kernel launches by form, the host reads and the blocking host uploads
per batch (:data:`DOCUMENTED`), and the static specs of every value that keys an
engine's serve variant.

The registry has the reference's 16 entrypoints, under the same names and
in the same order (``src/repro/analysis/entrypoints.py``):

* serve routes: ``flat_fused``, ``flat_pruned``, ``grouped_perquery``,
  ``sharded_pruned``, ``flat_hier``, ``sharded_hier``;
* ``lm_decode_step``: the pruned PQ head inside one LM decode step;
* kernels: ``pruned_tiles_kernel``, ``grouped_tiles_kernel``;
* engines: ``engine_aot``, ``engine_aot_grouped``;
* the mutable catalogue: ``flat_tombstone``, ``tombstone_tiles_kernel``,
  ``engine_mutable``;
* routers: ``router_replicated``, ``router_durable``.

The fixture keeps the reference's numbers: reduced ``sasrec-recjpq`` with
16,384 items and position-clustered codes from numpy ``default_rng(7)``
(so tiles have distinct bounds and pruning is real), the ladder
:data:`STATIC_LADDER`, k=5 and batches of 4.  The sharded entries run on
a one-shard ``ShardMesh``, as the reference's run on a ``(1,)`` mesh.
:func:`build` takes another :class:`Fixture` (the card's smoke passes
the full-width model) for the entries that :data:`FULL_WIDTH` lists.
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

SEQREC_N_ITEMS = 16384      # several pruning tiles at DEFAULT_PRUNE_TILE
STATIC_LADDER = (2, 4)      # multi-rung (normalised ladder appends the
                            # exhaustive rung) without calibration cost
K = 5
BATCH = 4
MAX_BATCH = 8

_PQ = "pq_scores"
_A = "pq_topk_fused"        # forms (a) and (b): a 1D slot list
_C = "pq_topk_fused_2d"     # form (c): a (batch tile, slot) table
_D = "pq_topk_fused_live"   # form (d): the live mask

#: The documented counts, per served batch: kernel launches by form, the
#: route's own host reads (the result read apart) and its blocking
#: uploads from the host.  The batch-any and grouped cascades read their
#: survivor counts once, the hierarchical cascade twice (super and child
#: counts); an adaptive seed adds one read per growth stage it runs
#: (every entry here seeds greedily, one stage).  An engine (a router's
#: too) uploads its padded batch of sequences once; a route or a kernel
#: takes its inputs on the device and uploads nothing.
DOCUMENTED: Dict[str, Tuple[Dict[str, int], int, int]] = {
    "flat_fused": ({_A: 1}, 0, 0),
    "flat_pruned": ({_PQ: 1, _A: 1}, 1, 0),
    "grouped_perquery": ({_C: 1}, 1, 0),
    "sharded_pruned": ({_PQ: 1, _A: 1}, 1, 0),
    "flat_hier": ({_PQ: 1, _A: 1}, 2, 0),
    "sharded_hier": ({_PQ: 1, _A: 1}, 2, 0),
    "lm_decode_step": ({_PQ: 1, _A: 1}, 1, 0),
    "pruned_tiles_kernel": ({_A: 1}, 0, 0),
    "grouped_tiles_kernel": ({_C: 1}, 0, 0),
    "engine_aot": ({_PQ: 1, _A: 1}, 1, 1),
    "engine_aot_grouped": ({_C: 1}, 1, 1),
    "flat_tombstone": ({_PQ: 1, _D: 1}, 1, 0),
    "tombstone_tiles_kernel": ({_D: 1}, 0, 0),
    "engine_mutable": ({_PQ: 1, _D: 1}, 1, 1),
    "router_replicated": ({_PQ: 1, _A: 1}, 1, 1),
    "router_durable": ({_PQ: 1, _D: 1}, 1, 1),
}

#: The entries the card's smoke also runs at the main path's full width.
FULL_WIDTH = ("flat_fused", "flat_pruned", "grouped_perquery", "engine_aot")


def expected_launches(name: str, batches: int = 1) -> Dict[str, int]:
    """An entry's documented launches for ``batches`` batches."""
    return {form: n * batches for form, n in DOCUMENTED[name][0].items()}


@dataclass(frozen=True)
class StaticArgSpec:
    """One value that keys an engine's serve variant.

    ``sample`` is a representative set of raw client-side values;
    ``mapper`` is the *real* production mapping from client value to the
    variant key (e.g. ``RetrievalEngine.batch_k``).  The variants pass
    asserts ``{mapper(v) for v in sample}`` stays within ``allowed``
    (when given) and under ``max_variants``, so unbounded client values
    can never key unbounded variants."""

    name: str
    sample: Tuple[Any, ...]
    mapper: Callable[[Any], Any]
    max_variants: int
    allowed: Optional[frozenset] = None
    note: str = ""


@dataclass
class BuiltEntry:
    """A materialised entrypoint, ready for the passes.

    ``fn(*make_args(device))`` serves one batch on ``device`` (the
    entry's device, or meta).  ``engines(args)`` lists the engines whose
    variants and batch steps the analysis watches; ``between(args)`` runs
    after the warm batch and before the recorded one (a catalogue
    mutation); ``release(args)`` frees what ``make_args`` started for a
    run (a meta router's threads) and ``close()`` what the build started
    (the device router, its log).  ``reads_result``: the batch reads its own
    outputs (an engine's result read, from pinned memory after a wait on
    its CUDA event), else the analysis reads them (one pageable copy).
    ``expect_uploads``: the blocking copies from the host to the device
    per batch."""

    fn: Callable
    make_args: Callable[[str], Tuple[Any, ...]]
    expect_kernels: Dict[str, int]
    expect_host_reads: int
    expect_uploads: int = 0
    static_specs: Tuple[StaticArgSpec, ...] = ()
    engines: Optional[Callable[[Tuple[Any, ...]], Sequence[Any]]] = None
    between: Optional[Callable[[Tuple[Any, ...]], None]] = None
    release: Optional[Callable[[Tuple[Any, ...]], None]] = None
    close: Optional[Callable[[], None]] = None
    reads_result: bool = False
    notes: str = ""


@dataclass(frozen=True)
class Entrypoint:
    name: str
    description: str
    build: Callable[..., BuiltEntry]
    tags: Tuple[str, ...] = ()


REGISTRY: Dict[str, Entrypoint] = {}


def register(name: str, description: str, tags: Tuple[str, ...] = ()):
    def deco(fn):
        REGISTRY[name] = Entrypoint(name, description, fn, tags)
        return fn
    return deco


@dataclass
class Fixture:
    """A seqrec model the serve entries run: parameters and config."""
    params: Any
    cfg: Any


def build(name: str, device: str = "cuda",
          fixture: Optional[Fixture] = None) -> BuiltEntry:
    """Build entry ``name`` for ``device`` on ``fixture`` (default
    :func:`seqrec_fixture`; the kernel and LM entries take none)."""
    return REGISTRY[name].build(fixture or seqrec_fixture(), device)


# ---------------------------------------------------------------------------
# shared fixtures
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def seqrec_fixture() -> Fixture:
    """Reduced sasrec-recjpq scaled to a multi-tile catalogue with
    position-clustered codes (the reference's fixture, drawn by the same
    formula from numpy ``default_rng(7)``; the weights are the port's
    draw from seed 0), on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_reduced
    from repro_torch.models import seqrec as seqrec_lib

    cfg = replace(get_reduced("sasrec-recjpq").model, n_items=SEQREC_N_ITEMS)
    rng0 = np.random.default_rng(7)
    centers = (np.arange(cfg.n_items + 1) / (cfg.n_items + 1)
               * cfg.pq.b).astype(np.int64)
    codes = torch.from_numpy(
        ((centers[:, None] + rng0.integers(-1, 2, (cfg.n_items + 1,
                                                   cfg.pq.m)))
         % cfg.pq.b).astype(np.int32))
    params = seqrec_lib.init_seqrec(torch.Generator().manual_seed(0), cfg,
                                    codes=codes)
    return Fixture(params, cfg)


def _seqs(cfg, device, batch: int = BATCH, seed: int = 0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(
        1, cfg.n_items + 1, (batch, cfg.max_seq_len)).astype(np.int32)
    ).to(device)


def _on(params, device):
    from repro_torch.interop import to_device
    return to_device(params, device)


def _grouped(cfg):
    return replace(cfg, pq=replace(cfg.pq, query_grouping=True, n_groups=4))


def _pow2_buckets(limit: int) -> frozenset:
    out, b = set(), 1
    while b < limit:
        out.add(b)
        b *= 2
    out.add(limit)
    return frozenset(out)


def _batch_specs(eng, max_batch: int) -> Tuple[StaticArgSpec, ...]:
    """The batch and k buckets, probed through the engine's real
    mappings."""
    from repro_torch.serving.engine import MicroBatcher
    return (
        StaticArgSpec(
            "batch_bucket", sample=tuple(range(1, max_batch + 1)),
            mapper=lambda n, _mb=max_batch: MicroBatcher.bucket(n, _mb),
            allowed=_pow2_buckets(max_batch),
            max_variants=max_batch.bit_length() + 1,
            note="pow2 padding buckets for the request batch size"),
        StaticArgSpec(
            "k_bucket", sample=tuple(range(1, 64)) + (200, 1000, 10 ** 9),
            mapper=lambda kv, _e=eng: _e.batch_k([kv]),
            allowed=_pow2_buckets(eng.max_k),
            max_variants=eng.max_k.bit_length() + 1,
            note="client k clamped into [1, max_k] then pow2-bucketed"),
    )


def _ladder_spec(eng, note: str) -> StaticArgSpec:
    return StaticArgSpec(
        "ladder_rung", sample=tuple(eng.ladder), mapper=lambda r: r,
        allowed=frozenset(eng.ladder), max_variants=4, note=note)


def _expect(name: str) -> Dict[str, Any]:
    kernels, reads, uploads = DOCUMENTED[name]
    return {"expect_kernels": dict(kernels), "expect_host_reads": reads,
            "expect_uploads": uploads}


# ---------------------------------------------------------------------------
# serve_topk routes
# ---------------------------------------------------------------------------

def _serve_entry(name: str, fx: Fixture, *, method: str,
                 grouped: bool = False, ladder=None,
                 return_rung: bool = False, sharded: bool = False,
                 super_factor: int = 0, mutable: bool = False) -> BuiltEntry:
    from repro_torch.core import pruning, retrieval_head
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import seqrec as seqrec_lib

    params, cfg = fx.params, fx.cfg
    if grouped:
        cfg = _grouped(cfg)
    head = params["item_emb"]
    if sharded:
        head = retrieval_head.ensure_sharded_pruned_state(
            head, make_mesh(1, [head["codes"].device]), k_hint=K,
            super_factor=super_factor or None)
    elif super_factor:
        head = {**head, "pruned": pruning.with_super(head["pruned"],
                                                     super_factor)}
    if mutable:
        mstate = _mutable_state(fx)
        head = {**head, **mstate.head_arrays()}
    params = {**params, "item_emb": head}

    def make_args(device):
        mesh = make_mesh(1, [device]) if sharded else None
        return _on(params, device), _seqs(cfg, device), mesh

    def fn(p, seqs, mesh):
        return seqrec_lib.serve_topk(p, seqs, cfg, k=K, method=method,
                                     sharded_mesh=mesh, ladder=ladder,
                                     return_rung=return_rung)

    return BuiltEntry(fn, make_args, **_expect(name),
                      notes=f"serve_topk method={method!r} "
                            f"n_items={cfg.n_items} grouped={grouped} "
                            f"sharded={sharded} super_factor={super_factor}"
                            f" mutable={mutable}")


@register("flat_fused",
          "serve_topk through the fused CUDA score+top-k kernel "
          "(method='pqtopk_fused'): backbone, sub-id scores and one "
          "identity-list launch (form a)",
          tags=("serve", "kernel"))
def _build_flat_fused(fx: Fixture, device: str) -> BuiltEntry:
    return _serve_entry("flat_fused", fx, method="pqtopk_fused")


@register("flat_pruned",
          "the batch-any pruned cascade with a multi-rung slot-budget "
          "ladder: one host read of the survivor count picks the rung",
          tags=("serve", "pruned"))
def _build_flat_pruned(fx: Fixture, device: str) -> BuiltEntry:
    return _serve_entry("flat_pruned", fx, method="pqtopk_pruned",
                        ladder=STATIC_LADDER, return_rung=True)


@register("grouped_perquery",
          "the per-query grouped cascade: theta per query, the grouping "
          "loop, the permutation and the 2D (batch tile, slot) table "
          "(form c); one host read of the group and union counts",
          tags=("serve", "pruned", "grouped"))
def _build_grouped_perquery(fx: Fixture, device: str) -> BuiltEntry:
    return _serve_entry("grouped_perquery", fx, method="pqtopk_pruned",
                        grouped=True, ladder=STATIC_LADDER, return_rung=True)


@register("sharded_pruned",
          "the item-sharded pruned cascade on a one-shard mesh (shard-"
          "local cascade + O(k x shards) merge)",
          tags=("serve", "pruned", "sharded"))
def _build_sharded_pruned(fx: Fixture, device: str) -> BuiltEntry:
    return _serve_entry("sharded_pruned", fx, method="pqtopk_pruned",
                        sharded=True)


@register("flat_hier",
          "the hierarchical two-stage cascade: super-tile pass 0, theta "
          "seeded from the super bounds, two-stage compaction; two host "
          "reads (super and child survivor counts)",
          tags=("serve", "pruned", "hier"))
def _build_flat_hier(fx: Fixture, device: str) -> BuiltEntry:
    return _serve_entry("flat_hier", fx, method="pqtopk_pruned",
                        ladder=STATIC_LADDER, super_factor=4)


@register("sharded_hier",
          "the item-sharded hierarchical cascade on a one-shard mesh: "
          "per-shard super-tile pass 0, shard-local rungs",
          tags=("serve", "pruned", "sharded", "hier"))
def _build_sharded_hier(fx: Fixture, device: str) -> BuiltEntry:
    return _serve_entry("sharded_hier", fx, method="pqtopk_pruned",
                        sharded=True, super_factor=4)


@register("lm_decode_step",
          "one LM decode step (stacked-cache layers) with the pruned PQ "
          "vocabulary head: the cascade inside the decode loop",
          tags=("decode", "pruned"))
def _build_lm_decode(fx: Fixture, device: str) -> BuiltEntry:
    import torch
    from repro_torch.configs.base import get_reduced
    from repro_torch.models import transformer as T

    cfg = get_reduced("qwen2.5-14b").model
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)

    # The position is a 0-d tensor on the device, as the reference's
    # jnp.int32(0) and DecodeEngine's positions are: a Python int would be
    # uploaded by every layer (torch.as_tensor), a synchronization each.
    def make_args(dev):
        return (_on(params, dev),
                torch.zeros(2, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev),
                T.init_caches(cfg, 2, 16, device=dev))

    def fn(p, token, pos, caches):
        return T.lm_decode_step(p, token, pos, caches, cfg, k=8,
                                head_method="pqtopk_pruned")

    return BuiltEntry(fn, make_args, **_expect("lm_decode_step"),
                      notes=f"qwen2.5-14b reduced, vocab={cfg.vocab}, "
                            f"head_method='pqtopk_pruned'")


# ---------------------------------------------------------------------------
# direct kernel routes: the wrappers on a small int8 catalogue
# ---------------------------------------------------------------------------

def _kernel_entry(name: str, tile_idx, *, batch_tile: int = 0,
                  live: bool = False) -> BuiltEntry:
    import numpy as np
    import torch
    from repro_torch.kernels.pqtopk import ops

    n, m, b, bq = 1024, 8, 16, 16
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, b, (n, m)).astype(np.int8))
    s = torch.from_numpy(rng.standard_normal((bq, m, b)).astype(np.float32))
    alive = torch.from_numpy(rng.random(n) < 0.9)
    table = torch.tensor(tile_idx, dtype=torch.int32)
    kw = {"batch_tile": batch_tile} if batch_tile else {}

    def make_args(dev):
        return (codes.to(dev), s.to(dev), table.to(dev),
                alive.to(dev) if live else None)

    def fn(c, sc, idx, lv):
        return ops.pq_topk_tiles(c, sc, 8, idx, tile=512, live=lv, **kw)

    return BuiltEntry(fn, make_args, **_expect(name),
                      notes=f"int8 codes ({n}, {m}), b={b}, B={bq}, "
                            f"tile=512, slots={tile_idx}, live={live}")


@register("pruned_tiles_kernel",
          "pq_topk_tiles on a 1D -1-padded compacted tile list (form b): "
          "the sentinel-slot contract surface",
          tags=("kernel",))
def _build_pruned_tiles_kernel(fx: Fixture, device: str) -> BuiltEntry:
    return _kernel_entry("pruned_tiles_kernel", [0, -1])


@register("grouped_tiles_kernel",
          "the grouped kernel table: 2D (batch tile, slot), each batch "
          "tile scoring its own -1-padded slot row (form c)",
          tags=("kernel", "grouped"))
def _build_grouped_tiles_kernel(fx: Fixture, device: str) -> BuiltEntry:
    return _kernel_entry("grouped_tiles_kernel", [[0, 1], [1, -1]],
                         batch_tile=8)


# ---------------------------------------------------------------------------
# engines: memoised variants, client-k bucketing, per-batch counts
# ---------------------------------------------------------------------------

def _requests(eng_cfg, rng, n: int, ids):
    """``n`` requests of 8 random items, their ids drawn from ``ids`` (an
    iterator: a router answers each request id once)."""
    from repro_torch.serving.engine import Request
    return [Request(next(ids), rng.integers(1, eng_cfg.n_items + 1, 8), k=K)
            for _ in range(n)]


def _serve_one_batch(eng, cfg, rng, ids):
    for r in _requests(cfg, rng, BATCH, ids):
        eng.submit(r)
    results = eng.run_once()
    assert len(results) == BATCH and not any(r.shed for r in results), (
        f"served {len(results)}/{BATCH}")
    return results


def _engine_entry(name: str, fx: Fixture, device: str, *, grouped: bool,
                  base_id: int) -> BuiltEntry:
    import numpy as np
    from repro_torch.serving.engine import RetrievalEngine

    params, cfg = fx.params, fx.cfg
    if grouped:
        cfg = _grouped(cfg)
    eng = RetrievalEngine.for_seqrec(params, cfg, k=K, max_batch=MAX_BATCH,
                                     method="pqtopk_pruned", device=device)
    # The calibrated ladder must be active: the per-batch counts have to
    # hold with the rung choice on the path.  On the registry's clustered
    # catalogue calibration finds pruning, so the ladder has several
    # rungs; random full-width weights prune nothing, and calibration
    # then keeps the exhaustive rung alone.
    assert eng.ladder is not None and (
        len(eng.ladder) >= 2 or fx is not seqrec_fixture()), (
        f"expected a calibrated multi-rung ladder, got {eng.ladder!r}")

    def make_args(dev):
        e = eng if dev == device else RetrievalEngine.for_seqrec(
            _on(params, dev), cfg, k=K, max_batch=MAX_BATCH,
            method="pqtopk_pruned", device=dev, ladder=eng.ladder)
        return e, np.random.default_rng(base_id), itertools.count(base_id)

    specs = _batch_specs(eng, MAX_BATCH) + (_ladder_spec(
        eng, "calibrated slot budgets baked into ONE serve variant (a rung "
             "is a slot prefix chosen per batch, never a new variant)"),)
    if grouped:
        specs += (StaticArgSpec(
            "n_groups", sample=(cfg.pq.n_groups,), mapper=lambda g: g,
            allowed=frozenset({cfg.pq.n_groups}), max_variants=1,
            note="config-static group count"),)
    return BuiltEntry(
        fn=lambda e, rng, ids: _serve_one_batch(e, cfg, rng, ids),
        make_args=make_args, **_expect(name), static_specs=specs,
        engines=lambda args: [args[0]], reads_result=True,
        notes=f"RetrievalEngine.for_seqrec pqtopk_pruned, calibrated "
              f"ladder={eng.ladder}, grouped={grouped}")


@register("engine_aot",
          "a calibrated RetrievalEngine on the pruned route: variant keys, "
          "client-k bucketing, per-batch launches and host reads",
          tags=("serve", "engine", "pruned"))
def _build_engine_aot(fx: Fixture, device: str) -> BuiltEntry:
    return _engine_entry("engine_aot", fx, device, grouped=False, base_id=0)


@register("engine_aot_grouped",
          "the engine on the grouped per-query route: the same variant and "
          "bucketing contracts with the grouped cascade on the path",
          tags=("serve", "engine", "pruned", "grouped"))
def _build_engine_aot_grouped(fx: Fixture, device: str) -> BuiltEntry:
    return _engine_entry("engine_aot_grouped", fx, device, grouped=True,
                         base_id=100)


# ---------------------------------------------------------------------------
# the mutable catalogue: tombstones, hot swap
# ---------------------------------------------------------------------------

def _mutable_state(fx: Fixture, device=None):
    """A MutableHeadState over the fixture's catalogue with 64 deletions
    applied: stale (loosened) bounds plus a real tombstone mask, the
    serve path's shape under streaming mutation."""
    import numpy as np
    from repro_torch.core.mutation import MutableHeadState

    head = fx.params["item_emb"]
    mstate = MutableHeadState.build(head["codes"], fx.cfg.pq.b,
                                    device=device)
    rng = np.random.default_rng(11)
    for iid in rng.choice(np.arange(1, fx.cfg.n_items + 1), 64,
                          replace=False):
        mstate.delete(int(iid))
    return mstate


def _meta_mutable(mstate):
    """``mstate``'s tensors on meta, its host bookkeeping copied."""
    from repro_torch.core.mutation import MutableHeadState
    return MutableHeadState(mstate.codes.to("meta"), mstate.live.to("meta"),
                            mstate.state.to("meta"), mstate.staleness.copy(),
                            list(mstate.free), mstate.n_rows)


@register("flat_tombstone",
          "serve_topk on a mutated catalogue: capacity-padded codes, "
          "stale-but-dominating bounds and the tombstone mask as data, "
          "the fused kernel's live form (d)",
          tags=("serve", "pruned", "mutable"))
def _build_flat_tombstone(fx: Fixture, device: str) -> BuiltEntry:
    return _serve_entry("flat_tombstone", fx, method="pqtopk_pruned",
                        ladder=STATIC_LADDER, return_rung=True, mutable=True)


@register("tombstone_tiles_kernel",
          "the compacted-tile kernel with a live (tombstone) mask on a "
          "-1-padded slot list (form d)",
          tags=("kernel", "mutable"))
def _build_tombstone_tiles_kernel(fx: Fixture, device: str) -> BuiltEntry:
    return _kernel_entry("tombstone_tiles_kernel", [0, -1], live=True)


@register("engine_mutable",
          "the hot-swap engine: serve, mutate the catalogue, "
          "swap_head_state, serve again: the swapped batch keeps its "
          "counts and adds no serve variant",
          tags=("serve", "engine", "pruned", "mutable"))
def _build_engine_mutable(fx: Fixture, device: str) -> BuiltEntry:
    import numpy as np
    from repro_torch.serving.engine import RetrievalEngine

    params, cfg = fx.params, fx.cfg
    mstate = _mutable_state(fx, device)
    eng = RetrievalEngine.for_seqrec_mutable(params, cfg, mstate, k=K,
                                             max_batch=MAX_BATCH,
                                             device=device)
    assert eng._head_state is not None, "mutable engine must be swappable"

    def make_args(dev):
        if dev == device:
            return eng, mstate, np.random.default_rng(200), \
                itertools.count(200)
        meta = _meta_mutable(mstate)
        e = RetrievalEngine.for_seqrec_mutable(
            _on(params, dev), cfg, meta, k=K, max_batch=MAX_BATCH,
            device=dev, ladder=eng.ladder)
        return e, meta, np.random.default_rng(200), itertools.count(200)

    def between(args):
        # Mutate the catalogue (on the device; meta tensors have no live
        # flags to read) and hot-swap it in before the recorded batch.
        e, st, rng, _ = args
        if not st.live.is_meta:
            for iid in rng.choice(np.arange(1, cfg.n_items + 1), 16,
                                  replace=False):
                if bool(st.live[int(iid)]):
                    st.delete(int(iid))
        e.swap_head_state(st)

    specs = _batch_specs(eng, MAX_BATCH) + (StaticArgSpec(
        "head_swap", sample=(0, 1, 2), mapper=lambda _swap: "head-as-data",
        allowed=frozenset({"head-as-data"}), max_variants=1,
        note="catalogue mutations are pure data: every swap serves "
             "through the variants the engine already holds"),)
    return BuiltEntry(
        fn=lambda e, st, rng, ids: _serve_one_batch(e, cfg, rng, ids),
        make_args=make_args, **_expect("engine_mutable"),
        static_specs=specs, engines=lambda args: [args[0]],
        between=between, reads_result=True,
        notes=f"for_seqrec_mutable, capacity={mstate.cap}, "
              f"ladder={eng.ladder}, mutate-swap-serve")


# ---------------------------------------------------------------------------
# replicated fabric
# ---------------------------------------------------------------------------

def _router_batch(router, cfg, rng, ids, lsn: bool = False):
    """One full bucket through the router: one job on one replica."""
    for r in _requests(cfg, rng, MAX_BATCH, ids):
        router.submit(r)
    results = router.drain()
    assert len(results) == MAX_BATCH, f"served {len(results)}/{MAX_BATCH}"
    assert not any(r.shed or r.degraded for r in results), (
        "healthy-path batch must be untagged")
    if lsn:
        assert all(r.lsn == router._committed_lsn for r in results), (
            "every Result must carry the committed-LSN watermark")
    return results


def _router_specs(router, eng) -> Tuple[StaticArgSpec, ...]:
    return (StaticArgSpec(
        "replica", sample=tuple(range(router.n_replicas)),
        mapper=lambda _rid: "shared-variants",
        allowed=frozenset({"shared-variants"}), max_variants=1,
        note="replica id is pure routing state: every replica holds the "
             "same serve variants"),)


@register("router_replicated",
          "the replicated serving fabric: health-checked replicas behind "
          "one submit/drain; a healthy full bucket is one job on exactly "
          "one replica, and the replica id keys no variant",
          tags=("serve", "engine", "pruned", "router"))
def _build_router_replicated(fx: Fixture, device: str) -> BuiltEntry:
    import numpy as np
    from repro_torch.serving.router import ReplicaRouter

    params, cfg = fx.params, fx.cfg
    kw = dict(n_replicas=2, k=K, max_batch=MAX_BATCH,
              method="pqtopk_pruned", hedge=False)
    router = ReplicaRouter.for_seqrec(params, cfg, device=device, **kw)
    eng = router.engines[0]
    assert eng.ladder is not None and len(eng.ladder) >= 2, (
        f"expected a calibrated multi-rung ladder, got {eng.ladder!r}")

    def make_args(dev):
        r = router if dev == device else ReplicaRouter.for_seqrec(
            _on(params, dev), cfg, device=dev, ladder=eng.ladder,
            calibrate=False, **kw)
        r.warmup()
        return r, np.random.default_rng(300), itertools.count(300)

    specs = (_batch_specs(eng, MAX_BATCH)
             + (_ladder_spec(eng, "one shared calibrated ladder across the "
                                  "fleet"),) + _router_specs(router, eng))
    return BuiltEntry(
        fn=lambda r, rng, ids: _router_batch(r, cfg, rng, ids),
        make_args=make_args, **_expect("router_replicated"),
        static_specs=specs, engines=lambda args: args[0].engines,
        release=lambda args: args[0] is router or args[0].close(),
        close=router.close, reads_result=True,
        notes=f"ReplicaRouter.for_seqrec x{router.n_replicas} replicas, "
              f"shared ladder={eng.ladder}, hedging off")


@register("router_durable",
          "the durable mutation fabric: WAL append + LSN-fenced fan-out + "
          "hot swap on every replica; a post-mutation full bucket is one "
          "job, and neither the LSN nor the replica id keys a variant",
          tags=("serve", "engine", "pruned", "router", "mutable"))
def _build_router_durable(fx: Fixture, device: str) -> BuiltEntry:
    import shutil
    import tempfile
    import time as time_lib

    import numpy as np
    from repro_torch.core.mutation import MutableHeadState
    from repro_torch.serving.catalogue_log import CatalogueLog
    from repro_torch.serving.router import ReplicaRouter

    params, cfg = fx.params, fx.cfg
    # A fresh state: the log's meta pins the catalogue layout.
    mstate = MutableHeadState.build(params["item_emb"]["codes"], cfg.pq.b,
                                    device=device)
    log_dir = tempfile.mkdtemp(prefix="repro_torch_wal_")
    log = CatalogueLog(log_dir, fsync_every=16)
    kw = dict(n_replicas=2, k=K, max_batch=MAX_BATCH, hedge=False)
    router = ReplicaRouter.for_seqrec_mutable(params, cfg, mstate, log=log,
                                              device=device, **kw)
    eng = router.engines[0]
    assert eng._head_state is not None, "fleet must be hot-swappable"

    def make_args(dev):
        # On meta: the same fleet without a log (a log writes tensors).
        r = router if dev == device else ReplicaRouter.for_seqrec_mutable(
            _on(params, dev), cfg, _meta_mutable(mstate), device=dev,
            ladder=eng.ladder, calibrate=False, **kw)
        r.warmup()
        return r, np.random.default_rng(400), itertools.count(400)

    def between(args):
        # Commit a mutation batch through the WAL and wait for every
        # replica's worker to replay it (a hot swap between batches).
        r, rng, _ = args
        if r.log is None:
            return
        n_variants = [len(e._variants) for e in r.engines]
        r.apply_mutations([("delete", int(i)) for i in rng.choice(
            np.arange(1, cfg.n_items + 1), 8, replace=False)])
        deadline = time_lib.monotonic() + 30.0
        while any(rep["lag"] != 0
                  for rep in r.stats()["replicas"].values()):
            assert time_lib.monotonic() < deadline, "catch-up stalled"
            time_lib.sleep(0.01)
        assert [len(e._variants) for e in r.engines] == n_variants, (
            "mutation propagation added serve variant(s)")

    def close():
        router.close()
        log.close()
        shutil.rmtree(log_dir, ignore_errors=True)

    specs = _batch_specs(eng, MAX_BATCH) + (StaticArgSpec(
        "lsn", sample=(0, 1, 8, 123, 10 ** 6),
        mapper=lambda _lsn: "head-as-data",
        allowed=frozenset({"head-as-data"}), max_variants=1,
        note="the catalogue version is pure data: every committed LSN "
             "serves through the variants the engines hold"),
    ) + _router_specs(router, eng)
    return BuiltEntry(
        fn=lambda r, rng, ids: _router_batch(r, cfg, rng, ids,
                                             lsn=r.log is not None),
        make_args=make_args, **_expect("router_durable"),
        static_specs=specs, engines=lambda args: args[0].engines,
        between=between,
        release=lambda args: args[0] is router or args[0].close(),
        close=close, reads_result=True,
        notes=f"ReplicaRouter.for_seqrec_mutable x{router.n_replicas} + "
              f"CatalogueLog WAL, shared ladder={eng.ladder}, "
              "mutate-swap-serve")
