"""Per-tile score upper bounds and the pruned cascade (``pqtopk_pruned``).

The port of the reference's ``core/pruning.py``.  For any item i in tile
t,

    r_i = sum_k S[k, G[i,k]]  <=  sum_k max_{j in C(t,k)} S[k, j] =: ub_t

where C(t,k) is the set of sub-ids occurring in split k of tile t.  With a
threshold theta that at least k items reach, every tile with ub_t < theta
can be skipped without changing the exact top-k (``docs/PRUNING.md``).

:func:`cascade_topk_ingraph` runs bounds -> theta seeding -> survival ->
compaction into ``-1``-padded slot buffers -> the fused kernel over the
listed tiles.  Batch-any survival gives one 1D slot list for the batch;
per-query grouping (``query_grouping=True``) gives a 2D (batch tile, slot)
table.  The reference picks the ladder rung inside one dispatch with
nested ``lax.cond``\\ s on the survivor count; eager PyTorch cannot branch
on a device value without waiting for it, so the cascade reads the count
on the host once per batch and launches the kernel on the first rung that
holds it.  No result differs.

**Hierarchical super-tiles** (:func:`with_super`, ``super_factor > 1``):
groups of ``factor`` consecutive tiles carry the OR of their presence
words, or the hull of their code ranges.  A super's bound dominates each
child's, so pass 0 prunes supers against theta (seeded from the super
bounds) and only the surviving supers' children have a bound gathered:
O(S + survivors * factor) bound work instead of O(T), and the same
surviving tiles as the flat rule at the same theta.  The reference picks
both rungs, super and child, in nested ``lax.cond``\\ s; here the super
survivor count is read on the host, the tail runs on that rung's prefix,
and then the child count is read: two host reads per batch where the flat
route has one.

:func:`cascade_topk` is the reference's host two-pass cascade (dense
presence metadata cached per catalogue, survivors compacted on the host
into a slot list padded with the past-the-end tile): the route the
single-dispatch cascade is held against; serving does not use it.

**Shard-aligned states** (``build_pruned_state(shards=S)``) tile each of
S equal row blocks on its own (the catalogue padded with zero-code rows
to ``S * n_local``), so no tile or super straddles a shard; the sharded
cascade (``retrieval_head.top_items_pruned_sharded``) seeds each shard
with :func:`seed_plan` and runs the shards' seed stages in lockstep
(:func:`run_seed_plans`, one host read per growth stage for all shards).

Presence words are ``int32`` holding the reference's ``uint32`` bit
patterns (PyTorch gives ``uint32`` few operations).  Every top-k here is
:func:`repro_torch.core.topk.topk` (ties to the lowest index, as
``lax.top_k``).  The mutable catalogue's ``live`` tombstone mask is
threaded through the masked builds, theta seeding and the fused kernel.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import pq as pq_lib
from repro_torch.core import topk as topk_lib
from repro_torch.core.scoring import tree_sum
from repro_torch.distributed.sharding import on_device
from repro_torch.kernels import cost
from repro_torch.kernels.pqtopk import ops as kernel_ops

NEG_INF = float("-inf")

#: Default pruning granularity (items per tile) — the fused kernel's item
#: tile, so one surviving tile is one kernel slot.
DEFAULT_PRUNE_TILE = 2048
DEFAULT_SEED_TILES = 2
DEFAULT_SEED_MAX_TILES = 16
DEFAULT_SEED_STAB_TOL = 0.05
DEFAULT_N_GROUPS = 8
#: Child tiles per super-tile of the hierarchical cascade.
DEFAULT_SUPER_FACTOR = 64

#: Bound backends: "bitmask" (exact per-tile code-presence sets) and
#: "range" (per-tile [code_lo, code_hi] int16 hulls, looser, 1/8 the bytes
#: at b=256).
BOUND_BACKENDS = ("bitmask", "range")

#: The stats schema every pruned route returns (the reference's).
STATS_KEYS = frozenset({
    "n_tiles", "n_survived", "n_scored", "survival_fraction",
    "n_seed_used", "seed_survival_est", "rung_hit", "n_rungs",
    "slot_overflow", "bound_backend",
    "n_groups", "max_group_survived", "pairs_scored", "pairs_union",
    "n_super", "n_super_survived", "super_rung_hit", "bounds_computed"})

_WORD = 32   # presence bits per packed word

#: The tensor fields of :class:`PrunedHeadState` (``None`` where unused).
ARRAY_FIELDS = ("packed", "code_lo", "code_hi", "super_packed", "super_lo",
                "super_hi")
#: The fields of those that hold presence words: ``int32`` here, the
#: reference's ``uint32`` bits (what a checkpoint stores).
UINT32_FIELDS = ("packed", "super_packed")


# ---------------------------------------------------------------------------
# query-independent metadata
# ---------------------------------------------------------------------------


def packed_words(b: int) -> int:
    """Presence words per (tile, split) row."""
    return -(-b // _WORD)


def pack_presence(present: torch.Tensor) -> torch.Tensor:
    """(T, m, b) bool -> (T, m, ceil(b/32)) int32, bit j of word w set iff
    ``present[..., w*32 + j]`` (the reference's uint32 bit pattern)."""
    t, m, b = present.shape
    w = packed_words(b)
    if w * _WORD != b:
        present = F.pad(present, (0, w * _WORD - b))
    bits = present.reshape(t, m, w, _WORD).long()
    shift = torch.arange(_WORD, dtype=torch.int64, device=present.device)
    words = (bits << shift).sum(dim=-1)                  # [0, 2^32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def unpack_presence(packed: torch.Tensor, b: int) -> torch.Tensor:
    """Inverse of :func:`pack_presence` -> (T, m, b) bool.  The shift is
    arithmetic on int32, and masking with 1 keeps bit j exactly."""
    t, m, w = packed.shape
    shift = torch.arange(_WORD, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shift) & 1
    return bits.reshape(t, m, w * _WORD)[..., :b] != 0


def _build_present_masked(codes: torch.Tensor, live: Optional[torch.Tensor],
                          b: int, tile: int) -> torch.Tensor:
    """present[t, k, j] iff sub-id j occurs in split k of a live row of tile
    t.  Dead rows (tombstones, a mutable catalogue's capacity padding) add
    no bits, so the result equals a fresh build over the live items alone;
    ``live=None`` counts every row."""
    n, m = codes.shape
    rows = torch.arange(n, device=codes.device)
    idx = pq_lib.widen(codes)
    if live is not None:
        keep = live.to(codes.device).bool()
        rows, idx = rows[keep], idx[keep]
    t_ids = rows // tile
    present = torch.zeros((-(-n // tile), m, b), dtype=torch.bool,
                          device=codes.device)
    for k in range(m):
        present[t_ids, k, idx[:, k]] = True
    return present


def _build_code_ranges_masked(codes: torch.Tensor,
                              live: Optional[torch.Tensor], tile: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(tile, split) min/max codes of the live rows -> ((T, m) int16 lo,
    (T, m) hi).  Dead rows and tile-alignment padding are excluded (filled
    with the min/max identities); ``live=None`` counts every row.  A tile
    with no live row would come out lo=32767 > hi=0: it is clamped to the
    one-code range [0, 0], so the segment-max gathers stay in bounds (its
    bound is then the code-0 max, sound for a tile the live mask removes
    from the top-k anyway)."""
    n, m = codes.shape
    n_tiles = -(-n // tile)
    c = pq_lib.widen(codes)
    pad = n_tiles * tile - n
    real = (torch.ones(n, dtype=torch.bool, device=codes.device)
            if live is None else live.to(codes.device).bool())
    if pad:
        c = F.pad(c, (0, 0, 0, pad))
        real = F.pad(real, (0, pad))
    c3 = c.reshape(n_tiles, tile, m)
    real = real.reshape(n_tiles, tile, 1)
    lo = torch.where(real, c3, 2 ** 15 - 1).amin(dim=1)
    hi = torch.where(real, c3, 0).amax(dim=1)
    lo = torch.minimum(lo, hi)
    hi = torch.maximum(hi, lo)
    return lo.to(torch.int16), hi.to(torch.int16)


@dataclass(frozen=True)
class TileMeta:
    """Dense presence metadata of the host two-pass cascade:
    ``present[t, k, j]`` iff sub-id j occurs in split k of tile t (the last
    tile may be partial).  n_tiles * m * b bools, 8x the presence words of
    :class:`PrunedHeadState`."""

    tile: int
    n_tiles: int
    n_items: int
    present: torch.Tensor   # (n_tiles, m, b) bool


def build_tile_metadata(codes: torch.Tensor, b: int, tile: int) -> TileMeta:
    """One O(N*m) scatter over the codes, on their device."""
    n = codes.shape[0]
    return TileMeta(tile=tile, n_tiles=-(-n // tile), n_items=n,
                    present=_build_present_masked(codes, None, b, tile))


# Per-catalogue cache keyed by the identity of the codes tensor; a
# finalizer evicts an entry when its tensor is collected, so a reused id()
# never serves stale metadata.
_META_CACHE: dict = {}


def get_tile_metadata(codes: torch.Tensor, b: int, tile: int) -> TileMeta:
    """:func:`build_tile_metadata`, cached per codes tensor."""
    key = (id(codes), b, tile)
    meta = _META_CACHE.get(key)
    if meta is None:
        meta = build_tile_metadata(codes, b, tile)
        weakref.finalize(codes, _META_CACHE.pop, key, None)
        _META_CACHE[key] = meta
    return meta


@dataclass(frozen=True)
class PrunedHeadState:
    """Query-independent pruning metadata, carried in the item head's
    parameter dict as ``"pruned"`` (the reference's fields, unchanged).

    ``"bitmask"``: ``packed`` (T, m, ceil(b/32)) int32 presence words;
    ``"range"``: ``code_lo``/``code_hi`` (T, m) int16.  With a super level
    (``super_factor > 1``, :func:`with_super`) ``super_packed`` (S, m,
    ceil(b/32)) or ``super_lo``/``super_hi`` (S, m) hold each group of
    ``super_factor`` tiles' OR or hull.  A shard-aligned state
    (``shards > 1``) holds ``tiles_per_shard`` tiles of each shard's
    ``n_local`` rows in turn, and its supers likewise."""

    packed: Optional[torch.Tensor]
    tile: int
    n_items: int
    b: int
    shards: int = 1
    n_local: int = 0
    backend: str = "bitmask"
    code_lo: Optional[torch.Tensor] = None
    code_hi: Optional[torch.Tensor] = None
    super_factor: int = 0
    super_packed: Optional[torch.Tensor] = None
    super_lo: Optional[torch.Tensor] = None
    super_hi: Optional[torch.Tensor] = None

    def meta_arrays(self) -> Tuple[torch.Tensor, ...]:
        """The backend's metadata arrays, leading dim = tiles."""
        if self.backend == "range":
            return (self.code_lo, self.code_hi)
        return (self.packed,)

    def super_meta_arrays(self) -> Tuple[torch.Tensor, ...]:
        """The backend's super-tile arrays, leading dim = supers."""
        if self.backend == "range":
            return (self.super_lo, self.super_hi)
        return (self.super_packed,)

    @property
    def has_super(self) -> bool:
        return self.super_factor > 1

    @property
    def n_tiles(self) -> int:
        return self.meta_arrays()[0].shape[0]

    @property
    def tiles_per_shard(self) -> int:
        return self.n_tiles // self.shards

    @property
    def n_super(self) -> int:
        return self.super_meta_arrays()[0].shape[0]

    @property
    def supers_per_shard(self) -> int:
        return self.n_super // self.shards

    @property
    def nbytes(self) -> int:
        """Device footprint of this backend's metadata."""
        if self.backend == "range":
            t, m = self.code_lo.shape
            return t * m * 2 * 2
        t, m, w = self.packed.shape
        return t * m * w * 4

    @property
    def bool_nbytes(self) -> int:
        """What a dense (T, m, b) bool layout would cost."""
        return self.n_tiles * self.meta_arrays()[0].shape[1] * self.b

    def to(self, device) -> "PrunedHeadState":
        """This state with every tensor on ``device``."""
        moved = {f: getattr(self, f).to(device) for f in ARRAY_FIELDS
                 if getattr(self, f) is not None}
        return replace(self, **moved)


def build_pruned_state(codes: torch.Tensor, b: int,
                       tile: int = DEFAULT_PRUNE_TILE, *,
                       shards: int = 1, backend: str = "bitmask",
                       super_factor: int = 0) -> PrunedHeadState:
    """Head-build-time constructor, on ``codes``'s device; ``super_factor >
    1`` adds the super level (:func:`with_super`).  ``shards > 1`` pads the
    catalogue to ``shards * n_local`` rows and tiles each shard's block on
    its own; the padding rows are zero codes that count as present (the
    reference's layout: sound for the bounds, and the sharded routes mask
    ids >= N out of the top-k)."""
    if shards <= 1:
        return with_super(build_pruned_state_masked(codes, None, b, tile,
                                                    backend=backend),
                          super_factor)
    n, m = codes.shape
    n_local = -(-n // shards)
    codes_p = torch.cat([codes, codes.new_zeros((shards * n_local - n, m))])
    blocks = [build_pruned_state_masked(codes_p[i * n_local:
                                                (i + 1) * n_local], None, b,
                                        tile, backend=backend)
              for i in range(shards)]
    cat = {f: torch.cat([getattr(st, f) for st in blocks])
           for f in ("packed", "code_lo", "code_hi")
           if getattr(blocks[0], f) is not None}
    return with_super(replace(blocks[0], n_items=n, shards=shards,
                              n_local=n_local, **cat), super_factor)


def build_pruned_state_masked(codes: torch.Tensor,
                              live: Optional[torch.Tensor], b: int,
                              tile: int = DEFAULT_PRUNE_TILE, *,
                              backend: str = "bitmask") -> PrunedHeadState:
    """Flat state whose metadata covers the LIVE rows only: the mutable
    catalogue's fresh-build and re-tighten oracle (:mod:`mutation`).
    ``live=None`` is every row live, which is :func:`build_pruned_state`."""
    if backend not in BOUND_BACKENDS:
        raise ValueError(f"unknown bound backend {backend!r}; "
                         f"one of {BOUND_BACKENDS}")
    if backend == "range" and b > 2 ** 15:
        raise ValueError(f"bound backend 'range' stores int16 ranges; "
                         f"b={b} exceeds int16")
    n = codes.shape[0]
    if live is not None and tuple(live.shape) != (n,):
        raise ValueError(f"live mask shape {tuple(live.shape)} != ({n},)")
    t = max(1, min(int(tile), n))
    if backend == "range":
        lo, hi = _build_code_ranges_masked(codes, live, t)
        return PrunedHeadState(None, tile=t, n_items=n, b=b, shards=1,
                               n_local=n, backend="range", code_lo=lo,
                               code_hi=hi)
    return PrunedHeadState(
        pack_presence(_build_present_masked(codes, live, b, t)),
        tile=t, n_items=n, b=b, shards=1, n_local=n)


def _or_reduce_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Bitwise OR along ``axis`` by tree halving (log2(n) ORs).  OR on the
    int32 words gives the reference's uint32 bits."""
    while x.shape[axis] > 1:
        n = x.shape[axis]
        half = n // 2
        merged = x.narrow(axis, 0, half) | x.narrow(axis, half, half)
        if n % 2:
            merged = torch.cat([merged, x.narrow(axis, 2 * half, 1)],
                               dim=axis)
        x = merged
    return x.squeeze(axis)


def with_super(state: PrunedHeadState,
               factor: int = DEFAULT_SUPER_FACTOR) -> PrunedHeadState:
    """Attach a super-tile level: each group of ``factor`` consecutive
    tiles (per shard, so no super straddles a shard) gets the OR of its
    presence words or the [min lo, max hi] hull of its ranges, so its bound
    dominates every child's.  The last group is padded with children that
    change nothing (zero words; lo = 32767, hi = 0).  ``factor <= 1``
    strips the level.  No pass over the codes: it composes with every
    builder, the mutable catalogue's included."""
    factor = int(factor)
    if factor <= 1:
        return replace(state, super_factor=0, super_packed=None,
                       super_lo=None, super_hi=None)
    t_local = state.tiles_per_shard
    s_local = -(-t_local // factor)
    pad = s_local * factor - t_local
    if state.backend == "range":
        m = state.code_lo.shape[1]
        lo = state.code_lo.reshape(state.shards, t_local, m)
        hi = state.code_hi.reshape(state.shards, t_local, m)
        if pad:
            lo = F.pad(lo, (0, 0, 0, pad), value=2 ** 15 - 1)
            hi = F.pad(hi, (0, 0, 0, pad))
        slo = lo.reshape(state.shards, s_local, factor, m).amin(dim=2)
        shi = hi.reshape(state.shards, s_local, factor, m).amax(dim=2)
        return replace(state, super_factor=factor, super_packed=None,
                       super_lo=slo.reshape(-1, m).to(torch.int16),
                       super_hi=shi.reshape(-1, m).to(torch.int16))
    _, m, w = state.packed.shape
    pk = state.packed.reshape(state.shards, t_local, m, w)
    if pad:
        pk = F.pad(pk, (0, 0, 0, 0, 0, pad))
    sup = _or_reduce_axis(pk.reshape(state.shards, s_local, factor, m, w),
                          axis=2)
    return replace(state, super_factor=factor, super_lo=None, super_hi=None,
                   super_packed=sup.reshape(-1, m, w))


def abstract_pruned_state(n_items: int, m: int, b: int,
                          tile: int = DEFAULT_PRUNE_TILE, *,
                          shards: int = 1, backend: str = "bitmask",
                          super_factor: int = 0) -> PrunedHeadState:
    """:func:`build_pruned_state`'s state for an ``(n_items, m)`` code
    table, on meta (no storage); presence words are ``int32``."""
    from repro_torch.training import tree as tree_lib
    codes = torch.empty((n_items, m), dtype=torch.int32, device="meta")
    return tree_lib.eval_shape(build_pruned_state, codes, b, tile,
                               shards=shards, backend=backend,
                               super_factor=super_factor)


# ---------------------------------------------------------------------------
# query-dependent: bounds -> theta -> survival
# ---------------------------------------------------------------------------


def tile_upper_bounds(present: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """ub[q, t] = sum_k max_{j: present[t,k,j]} s[q,k,j].
    present (T, m, b) bool, s (B, m, b) f32 -> (B, T) f32, summed in
    ``tree_sum`` order so a one-item tile's bound equals its score."""
    m = present.shape[1]
    parts = [torch.where(present[None, :, k, :], s[:, None, k, :], NEG_INF)
             .amax(dim=-1) for k in range(m)]
    return tree_sum(parts)


def tile_upper_bounds_packed(packed: torch.Tensor, s: torch.Tensor
                             ) -> torch.Tensor:
    """Bounds straight from the presence words -> (B, T) f32."""
    return tile_upper_bounds(unpack_presence(packed, s.shape[-1]), s)


def range_max_table(s: torch.Tensor) -> torch.Tensor:
    """Sparse segment-max table over the sub-id axis: s (..., b) ->
    (..., L, b) with ``table[..., l, j] = max(s[..., j : j + 2^l])``
    (clamped at b), L = floor(log2(b)) + 1."""
    b = s.shape[-1]
    levels = [s]
    w = 1
    while 2 * w <= b:
        prev = levels[-1]
        shifted = F.pad(prev[..., w:], (0, w), value=NEG_INF)
        levels.append(torch.maximum(prev, shifted))
        w *= 2
    return torch.stack(levels, dim=-2)


def tile_upper_bounds_range(code_lo: torch.Tensor, code_hi: torch.Tensor,
                            s: torch.Tensor) -> torch.Tensor:
    """ub[q, t] = sum_k max_{lo[t,k] <= j <= hi[t,k]} s[q, k, j]: the max of
    the two power-of-two windows anchored at ``lo`` and ending at ``hi``,
    summed in ``tree_sum`` order.  -> (B, T) f32."""
    bq, m, b = s.shape
    table = range_max_table(s)                         # (B, m, L, b)
    n_levels = table.shape[-2]
    lo = code_lo.long()
    hi = code_hi.long()
    length = hi - lo + 1
    level = torch.zeros_like(length)
    for lv in range(1, n_levels):
        level = level + (length >= (1 << lv)).long()
    right = hi - torch.bitwise_left_shift(torch.ones_like(level), level) + 1
    flat = table.reshape(bq, m, n_levels * b)
    parts = []
    for k in range(m):
        i1 = level[:, k] * b + lo[:, k]
        i2 = level[:, k] * b + right[:, k]
        parts.append(torch.maximum(flat[:, k].index_select(1, i1),
                                   flat[:, k].index_select(1, i2)))
    return tree_sum(parts)


def tile_bounds(state: PrunedHeadState, s: torch.Tensor) -> torch.Tensor:
    """Backend-dispatched per-tile upper bounds -> (B, T) f32."""
    return bounds_from_parts(state.backend, state.meta_arrays(), s)


def bounds_from_parts(backend: str, parts: Tuple[torch.Tensor, ...],
                      s: torch.Tensor) -> torch.Tensor:
    """Bounds from a backend name and its metadata arrays."""
    if backend == "range":
        return tile_upper_bounds_range(*parts, s)
    return tile_upper_bounds_packed(*parts, s)


def theta_from_seed(codes: torch.Tensor, s: torch.Tensor,
                    bounds: torch.Tensor, k: int, *, tile: int, n_seed: int,
                    n_items: Optional[int] = None,
                    id_offset: int = 0) -> torch.Tensor:
    """The host cascade's greedy seed: score the ``n_seed`` tiles with the
    largest batch-max bounds exactly (:func:`ops.pq_scores`, the CUDA
    kernel on the card) -> theta (B,), each query's k-th best seeded score.
    Rows whose global id ``id_offset + row`` reaches ``n_items`` (default
    N) are masked out."""
    n = codes.shape[0]
    n_tiles = -(-n // tile)
    n_seed = min(max(n_seed, -(-k // tile)), n_tiles)
    seed = topk_lib.topk(bounds.amax(dim=0), n_seed)[1].long()
    gid, safe = _tile_rows(seed, tile, n)
    sc = kernel_ops.pq_scores(
        pq_lib.take_rows(codes, safe.reshape(-1)).contiguous(), s)
    limit = n if n_items is None else n_items
    valid = ((id_offset + gid < limit) & (gid < n)).reshape(-1)
    sc = torch.where(valid[None, :], sc, NEG_INF)
    return topk_lib.topk(sc, min(k, n_seed * tile))[0][:, -1]


def seed_schedule(policy: str, n_seed: int, n_seed_max: int, k: int,
                  tile: int, n_tiles: int) -> Tuple[int, ...]:
    """Seed sizes (tiles scored after each stage).  Greedy: one stage;
    adaptive: doubling from ``n_seed`` up to ``n_seed_max``."""
    floor = max(1, -(-k // tile))
    first = min(max(n_seed, floor), n_tiles)
    if policy == "greedy":
        return (first,)
    sizes = [first]
    while sizes[-1] < min(max(n_seed_max, first), n_tiles):
        sizes.append(min(sizes[-1] * 2, n_tiles, max(n_seed_max, first)))
    return tuple(dict.fromkeys(sizes))


def degenerate_tile_mask(state: PrunedHeadState) -> Optional[torch.Tensor]:
    """(T,) bool: range tiles whose hull spans every sub-id in some split
    (loose and large bounds, pushed behind informative tiles in the seed
    order); ``None`` for the bitmask backend."""
    return degenerate_from_parts(state.backend, state.meta_arrays(), state.b)


def degenerate_from_parts(backend: str, parts: Tuple[torch.Tensor, ...],
                          b: int) -> Optional[torch.Tensor]:
    if backend != "range":
        return None
    lo, hi = parts
    return ((hi.int() - lo.int()) == b - 1).any(dim=1)


def seed_order_key(bounds: torch.Tensor,
                   degenerate: Optional[torch.Tensor]) -> torch.Tensor:
    """Seed-ordering key: the bounds, with degenerate tiles shifted below
    every informative tile (order within each class kept).  ``bounds`` is
    (T,) or (B, T)."""
    if degenerate is None:
        return bounds
    span = bounds.max() - bounds.min() + 1.0
    return bounds - degenerate.to(bounds.dtype) * span


def _tile_rows(tile_ids: torch.Tensor, tile: int, n: int):
    """Global ids of the tiles' items (``tile_ids`` shape + (tile,)), and
    the same clamped into the catalogue for the code gather."""
    gid = (tile_ids[..., None] * tile
           + torch.arange(tile, device=tile_ids.device))
    return gid, gid.clamp(max=n - 1)


def _valid(gid: torch.Tensor, safe: torch.Tensor, n: int,
           live: Optional[torch.Tensor], limit: int,
           id_offset: int) -> torch.Tensor:
    """Which of the rows ``gid`` (clamped: ``safe``) a seed may score: those
    inside the codes, whose global id ``id_offset + gid`` is below
    ``limit`` (a shard's padding rows are not) and, with a tombstone mask,
    alive."""
    ok = (gid < n) & (id_offset + gid < limit)
    if live is not None:
        ok &= live[safe].bool()
    return ok


def _mean(mask: torch.Tensor) -> torch.Tensor:
    """Mean of a bool mask as the reference's ``jnp.mean`` rounds it on
    the CPU: the count times the float32 reciprocal of the size."""
    return mask.sum(dtype=torch.float32) * (1.0 / mask.numel())


def _merge_values(vals: torch.Tensor, sc: torch.Tensor, k: int):
    cand = torch.cat([vals, topk_lib.topk(sc, min(k, sc.shape[1]))[0]],
                     dim=1)
    return topk_lib.topk(cand, k)[0]


@dataclass(frozen=True)
class SeedPlan:
    """One shard's theta seeding, set up: the seed sizes of its policy, its
    tile order and the functions that score a chunk of tiles and estimate
    survival at a theta; ``position`` is the manual region's position it
    was set up at (``kernels.cost.at_position``), where it runs."""
    sizes: Tuple[int, ...]
    order: torch.Tensor
    score_chunk: object
    survival_est: object
    bq: int
    position: Optional[Tuple[str, int]] = None


def seed_plan(codes: torch.Tensor, s: torch.Tensor, bounds: torch.Tensor,
              k: int, *, tile: int, perquery: bool = False,
              seed_policy: str = "greedy",
              seed_tiles: int = DEFAULT_SEED_TILES,
              seed_max_tiles: int = DEFAULT_SEED_MAX_TILES,
              n_items: Optional[int] = None, id_offset: int = 0,
              degenerate: Optional[torch.Tensor] = None,
              live: Optional[torch.Tensor] = None) -> SeedPlan:
    """Set up the seed of :func:`theta_seed_ingraph` (batch-shared tiles,
    scored by :func:`ops.pq_scores`) or, ``perquery``, of
    :func:`theta_seed_perquery` (each query's own tiles, plain gathers in
    ``tree_sum`` order).  ``n_items``/``id_offset``: the codes are a
    shard's rows, the first with global id ``id_offset``; rows whose global
    id reaches ``n_items`` (default: the codes' rows) are masked out."""
    n, m = codes.shape
    bq = s.shape[0]
    sizes = seed_schedule(seed_policy, seed_tiles, seed_max_tiles, k, tile,
                          bounds.shape[1])
    limit = n if n_items is None else n_items
    if perquery:
        order = topk_lib.topk(seed_order_key(bounds, degenerate),
                              sizes[-1])[1].long()               # (B, n_max)
        s = s.float()

        def score_chunk(tile_ids):
            gid, safe = _tile_rows(tile_ids, tile, n)            # (B, c, tile)
            sel = pq_lib.widen(pq_lib.take_rows(codes, safe.reshape(-1))
                               ).reshape(bq, -1, m)
            sc = tree_sum([torch.gather(s[:, kk, :], 1, sel[:, :, kk])
                           for kk in range(m)])
            return torch.where(_valid(gid, safe, n, live, limit, id_offset
                                      ).reshape(bq, -1), sc, NEG_INF)

        est = lambda th: _mean(survival_mask_perquery(bounds, th))
    else:
        order = topk_lib.topk(seed_order_key(bounds.amax(dim=0), degenerate),
                              sizes[-1])[1].long()

        def score_chunk(tile_ids):
            gid, safe = _tile_rows(tile_ids, tile, n)
            rows = pq_lib.take_rows(codes, safe.reshape(-1)).contiguous()
            sc = kernel_ops.pq_scores(rows, s)
            return torch.where(_valid(gid, safe, n, live, limit, id_offset
                                      ).reshape(-1)[None, :], sc, NEG_INF)

        est = lambda th: _mean(survival_mask(bounds, th))
    return SeedPlan(sizes, order, score_chunk, est, bq,
                    cost.current_position())


def _host_int(t: torch.Tensor, largest: int, what: str) -> int:
    """``int(t)``, a host read (``kernels.cost.host_read`` records it); of
    a meta tensor (the dry run), ``largest``, the most the shapes
    allow."""
    return cost.host_read(what, lambda: int(t), largest, of=t)


def _read_flags(flags):
    """0-d bool tensors (one per shard, maybe on several devices) read to
    the host in one read.  Meta flags read as False (not yet stable: the
    seed grows to its largest size)."""
    def read():
        if len(flags) == 1:
            return [bool(flags[0])]
        lead = flags[0].device
        return torch.stack([f.to(lead) for f in flags]).tolist()
    return cost.host_read("pruning._read_flags: seed stability", read,
                          [False] * len(flags), of=flags)


def run_seed_plans(plans, k: int,
                   seed_stab_tol: float = DEFAULT_SEED_STAB_TOL):
    """Run the shards' seed stages in lockstep -> (thetas, n_seed_used,
    survival estimates), a list each, one entry per plan.

    Each stage scores each still-growing shard's chunk and merges its k
    best values; a shard stops once its survival estimate moved by <=
    ``seed_stab_tol`` (the reference's per-shard ``lax.cond`` on ``done``;
    greedy has one stage).  The stability flags of all shards are read
    to the host once per growth stage, so S shards read the host as often
    as one."""
    vals, sf, n_used = [], [], []
    for p in plans:
        dev = p.order.device
        with on_device(dev, p.position):
            v = _merge_values(torch.full((p.bq, k), NEG_INF, device=dev),
                              p.score_chunk(p.order[..., :p.sizes[0]]), k)
            vals.append(v)
            sf.append(p.survival_est(v[:, -1]))
            n_used.append(p.sizes[0])
    sizes = plans[0].sizes
    active = list(range(len(plans)))
    for prev, size in zip(sizes, sizes[1:]):
        if not active:
            break
        flags = []
        for i in active:
            p = plans[i]
            with on_device(p.order.device, p.position):
                vals[i] = _merge_values(
                    vals[i], p.score_chunk(p.order[..., prev:size]), k)
                sf_new = p.survival_est(vals[i][:, -1])
                flags.append(torch.abs(sf_new - sf[i]) <= seed_stab_tol)
                sf[i], n_used[i] = sf_new, size
        stable = _read_flags(flags)
        active = [i for i, st in zip(active, stable) if not st]
    return [v[:, -1] for v in vals], n_used, sf


def theta_seed_ingraph(codes: torch.Tensor, s: torch.Tensor,
                       bounds: torch.Tensor, k: int, *, tile: int,
                       seed_policy: str = "greedy",
                       seed_tiles: int = DEFAULT_SEED_TILES,
                       seed_max_tiles: int = DEFAULT_SEED_MAX_TILES,
                       seed_stab_tol: float = DEFAULT_SEED_STAB_TOL,
                       n_items: Optional[int] = None, id_offset: int = 0,
                       degenerate: Optional[torch.Tensor] = None,
                       live: Optional[torch.Tensor] = None):
    """Batch-shared theta seeding -> (theta (B,), n_seed_used int,
    survival estimate f32 0-d tensor).

    Scores the tiles with the largest batch-max bounds exactly and takes
    each query's k-th best value: at least k items reach it.  The seed
    rows go through :func:`ops.pq_scores` (the CUDA kernel on the card).
    ``adaptive`` grows the seed set geometrically until the survival
    estimate is stable.  ``live`` (N,) excludes dead rows from the seed
    scores: a dead high-scorer would certify a theta that live items
    cannot reach, and the cascade would no longer be exact.
    ``n_items``/``id_offset`` as for :func:`seed_plan`."""
    (theta,), (n_used,), (sf,) = run_seed_plans([seed_plan(
        codes, s, bounds, k, tile=tile, seed_policy=seed_policy,
        seed_tiles=seed_tiles, seed_max_tiles=seed_max_tiles,
        n_items=n_items, id_offset=id_offset, degenerate=degenerate,
        live=live)], k, seed_stab_tol)
    return theta, n_used, sf


def survival_mask(bounds: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Tile survives iff any query still needs it: (B, T), (B,) -> (T,)
    bool.  ``>=`` keeps an item tying theta visible."""
    return (bounds >= theta[:, None]).any(dim=0)


def survival_mask_perquery(bounds: torch.Tensor, theta: torch.Tensor
                           ) -> torch.Tensor:
    """mask[q, t] == query q still needs tile t: (B, T) bool."""
    return bounds >= theta[:, None]


def theta_seed_perquery(codes: torch.Tensor, s: torch.Tensor,
                        bounds: torch.Tensor, k: int, *, tile: int,
                        seed_policy: str = "greedy",
                        seed_tiles: int = DEFAULT_SEED_TILES,
                        seed_max_tiles: int = DEFAULT_SEED_MAX_TILES,
                        seed_stab_tol: float = DEFAULT_SEED_STAB_TOL,
                        n_items: Optional[int] = None, id_offset: int = 0,
                        degenerate: Optional[torch.Tensor] = None,
                        live: Optional[torch.Tensor] = None):
    """Per-query theta seeding: each query scores its OWN most promising
    tiles (plain PyTorch gathers from its S row, in ``tree_sum`` order) ->
    (theta (B,), n_seed_used int, mean per-query survival f32 0-d).
    ``live``, ``n_items`` and ``id_offset`` as in
    :func:`theta_seed_ingraph`."""
    (theta,), (n_used,), (sf,) = run_seed_plans([seed_plan(
        codes, s, bounds, k, tile=tile, perquery=True,
        seed_policy=seed_policy, seed_tiles=seed_tiles,
        seed_max_tiles=seed_max_tiles, n_items=n_items, id_offset=id_offset,
        degenerate=degenerate, live=live)], k, seed_stab_tol)
    return theta, n_used, sf


# ---------------------------------------------------------------------------
# compaction and query grouping
# ---------------------------------------------------------------------------


def compact_mask(mask: torch.Tensor, n_slots: Optional[int] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cumsum-scatter compaction of survivor masks: (..., T) bool ->
    (slots (..., n_slots) int32, counts (...) int32), surviving tile
    indices ascending at the front, ``-1`` behind.  Survivors past
    ``n_slots`` are dropped (scattered into one extra column that is cut
    off), so a caller with a budget must escalate when count > n_slots."""
    t = mask.shape[-1]
    n_slots = t if n_slots is None else int(n_slots)
    pos = torch.cumsum(mask.long(), dim=-1) - 1
    dest = torch.where(mask, pos, n_slots).clamp(max=n_slots)
    src = torch.arange(t, dtype=torch.int32,
                       device=mask.device).expand(mask.shape)
    slots = torch.full(mask.shape[:-1] + (n_slots + 1,), -1,
                       dtype=torch.int32, device=mask.device)
    slots.scatter_(-1, dest, src)
    return slots[..., :n_slots], mask.sum(dim=-1, dtype=torch.int32)


def compact_values(mask: torch.Tensor, values: torch.Tensor,
                   n_slots: Optional[int] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`compact_mask` scattering ``values`` (T,) instead of positions:
    the hierarchical cascade's stage-2 compaction, whose mask axis
    enumerates (surviving super, child) pairs and whose values are the
    children's global tile ids.  The slots follow the mask axis, so they
    ascend when the values do over the survivors (the kernel's tie-break
    needs ascending slots)."""
    t = mask.shape[-1]
    n_slots = t if n_slots is None else int(n_slots)
    pos = torch.cumsum(mask.long(), dim=-1) - 1
    dest = torch.where(mask, pos, n_slots).clamp(max=n_slots)
    slots = torch.full((n_slots + 1,), -1, dtype=torch.int32,
                       device=mask.device)
    slots.scatter_(-1, dest, values.to(torch.int32))
    return slots[:n_slots], mask.sum(dtype=torch.int32)


def default_super_ladder(n_super: int) -> Tuple[int, ...]:
    """Pass-0 rung budgets (surviving supers the tail is sized for): the
    powers of two at or above S/16 and S/4; :func:`normalize_ladder` adds
    the exhaustive rung."""
    rungs = []
    for frac in (16, 4):
        x = max(1, n_super // frac)
        rungs.append(1 << (x - 1).bit_length())
    return tuple(dict.fromkeys(rungs))


def pruned_pass1(codes: torch.Tensor, present: torch.Tensor,
                 s: torch.Tensor, k: int, *, tile: int, n_seed: int,
                 n_items: Optional[int] = None, id_offset: int = 0):
    """The host cascade's first pass: dense-presence bounds, the greedy
    seed's theta and the survival mask -> (mask (T,), bounds (B, T), theta
    (B,))."""
    bounds = tile_upper_bounds(present, s)
    theta = theta_from_seed(codes, s, bounds, k, tile=tile, n_seed=n_seed,
                            n_items=n_items, id_offset=id_offset)
    return survival_mask(bounds, theta), bounds, theta


def group_queries(pq_mask: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Greedy bucketing of per-query survivor sets -> (B,) int64 group ids.

    Queries in batch order each join the group whose union grows by the
    fewest new tiles (ties to the smaller group, then the lower group id:
    ``argmin`` takes the first minimum), and that group's union absorbs
    the query's mask — the reference's ``lax.scan``, as a loop over B on
    the device.  A work heuristic only: every query's group row is a
    superset of its own survivors."""
    bq, t = pq_mask.shape
    dev = pq_mask.device
    gmask = torch.zeros((n_groups, t), dtype=torch.bool, device=dev)
    gsize = torch.zeros((n_groups,), dtype=torch.int64, device=dev)
    groups = torch.arange(n_groups, device=dev)
    assign = torch.empty((bq,), dtype=torch.int64, device=dev)
    for q in range(bq):
        mq = pq_mask[q]
        added = (mq[None, :] > gmask).sum(dim=1)         # new tiles per group
        g = torch.argmin(added * (bq + 1) + gsize)
        sel = groups == g
        gmask |= sel[:, None] & mq[None, :]
        gsize += sel
        assign[q] = g
    return assign


def group_and_compact(pq_mask: torch.Tensor, *, n_groups: int,
                      batch_tile: int):
    """Per-query masks -> ``(perm (B,), inv (B,), slots2d (n_bt, T) int32,
    counts (n_bt,) int32)``: queries permuted so groups sit contiguously,
    the permuted batch padded to a multiple of ``batch_tile`` (padding rows
    empty), each batch tile's union mask compacted into an ascending
    ``-1``-padded slot row.  A rung's table is its ``[:, :budget]``
    prefix."""
    bq, t = pq_mask.shape
    dev = pq_mask.device
    assign = (group_queries(pq_mask, n_groups) if n_groups > 1
              else torch.zeros((bq,), dtype=torch.int64, device=dev))
    perm = torch.argsort(assign * bq + torch.arange(bq, device=dev))
    inv = torch.argsort(perm)
    n_bt = -(-bq // batch_tile)
    mask_p = F.pad(pq_mask[perm], (0, 0, 0, n_bt * batch_tile - bq))
    bt_mask = mask_p.reshape(n_bt, batch_tile, t).any(dim=1)
    slots2d, counts = compact_mask(bt_mask)
    return perm, inv, slots2d, counts


# ---------------------------------------------------------------------------
# slot-budget ladder
# ---------------------------------------------------------------------------


def normalize_ladder(ladder, n_tiles: int, k: int, tile: int
                     ) -> Tuple[int, ...]:
    """Strictly ascending slot budgets clamped to ``[ceil(k/tile),
    n_tiles]``, the exhaustive rung (``n_tiles``) always last."""
    floor = min(max(1, -(-k // tile)), n_tiles)
    budgets = sorted({max(min(int(x), n_tiles), floor)
                      for x in (ladder or ())})
    return tuple(x for x in budgets if x < n_tiles) + (n_tiles,)


def calibrate_ladder(survival_counts, n_tiles: int, k: int, tile: int, *,
                     headroom: int = 2) -> Tuple[int, ...]:
    """A 2-3 rung power-of-two ladder from observed survivor counts:
    ``headroom`` x the median, the 95th percentile and ``headroom`` x the
    95th, each rounded up to a power of two, then :func:`normalize_ladder`
    (which always appends the exhaustive rung)."""
    counts = np.asarray(list(survival_counts), dtype=np.int64).reshape(-1)
    if counts.size == 0:
        counts = np.asarray([n_tiles])
    floor = min(max(1, -(-k // tile)), n_tiles)
    headroom = max(int(headroom), 2)

    def pow2_at_least(x):
        return 1 << (max(int(np.ceil(x)), 1) - 1).bit_length()

    q50, q95 = np.quantile(counts, 0.5), np.quantile(counts, 0.95)
    rungs = (pow2_at_least(max(headroom * q50, floor)),
             pow2_at_least(max(q95, floor)),
             pow2_at_least(max(headroom * q95, floor)))
    return normalize_ladder(rungs, n_tiles, k, tile)


# ---------------------------------------------------------------------------
# the cascade
# ---------------------------------------------------------------------------


def _check_flat(state: PrunedHeadState):
    if state.shards != 1:
        raise ValueError(
            f"cascade_topk_ingraph needs a shards=1 state, got "
            f"shards={state.shards}")


def _rung(count: int, rungs) -> int:
    """Index of the first rung whose budget holds ``count``; the last rung
    holds any count."""
    return next((i for i, r in enumerate(rungs[:-1]) if count <= r),
                len(rungs) - 1)


def _hier_tail(codes, s, k, state: PrunedHeadState, *, seed_kw, ladder,
               super_ladder, pin_rung, live):
    """Pass 0 over the super-tiles, then the tail over the surviving
    supers' children -> (vals, ids, stats of the tail).  Two host reads:
    the super survivor count (it picks the super rung, whose prefix of the
    super slots the tail gathers), then the child survivor count (it picks
    the child rung)."""
    tile, factor, t_total = state.tile, state.super_factor, state.n_tiles
    n_super = state.n_super
    sup_parts = state.super_meta_arrays()
    sup_bounds = bounds_from_parts(state.backend, sup_parts, s)
    theta, n_seed_used, seed_sf = theta_seed_ingraph(
        codes, s, sup_bounds, k, tile=factor * tile,
        degenerate=degenerate_from_parts(state.backend, sup_parts, state.b),
        **seed_kw)
    sup_slots, sup_count = compact_mask(survival_mask(sup_bounds, theta))
    sup_rungs = normalize_ladder(
        default_super_ladder(n_super) if super_ladder is None
        else super_ladder, n_super, k, factor * tile)
    if pin_rung:
        sup_rungs = sup_rungs[:1]
    sup_count = _host_int(sup_count, n_super,        # host read 1
                          "pruning._hier_tail: super survivor count")
    i_sup = _rung(sup_count, sup_rungs)
    r_sup = sup_rungs[i_sup]
    # Children's global tile ids, ascending: supers ascend in the slots
    # and children within each super.  A -1 super (negative ids) and the
    # last super's children past T are gathered clamped and masked out.
    gid = (sup_slots[:r_sup, None].long() * factor
           + torch.arange(factor, device=s.device)).reshape(-1)
    valid = (gid >= 0) & (gid < t_total)
    safe = gid.clamp(0, t_total - 1)
    child_bounds = bounds_from_parts(
        state.backend, tuple(p[safe] for p in state.meta_arrays()), s)
    child_slots, count = compact_values(
        survival_mask(child_bounds, theta) & valid, gid)
    crungs = normalize_ladder(ladder, r_sup * factor, k, tile)
    if pin_rung:
        crungs = crungs[:1]
    count = _host_int(count, min(r_sup * factor, t_total),   # host read 2
                      "pruning._hier_tail: child survivor count")
    vals, ids, rung = kernel_ops.pq_topk_tiles_ladder(
        codes, s, k, [child_slots[:r] for r in crungs], count, tile=tile,
        live=live)
    return vals, ids, {
        "count": count, "rungs": crungs, "rung": rung,
        "n_seed_used": n_seed_used, "seed_sf": seed_sf,
        "n_super": n_super, "n_super_survived": sup_count,
        "super_rung_hit": i_sup, "bounds_computed": n_super + r_sup * factor}


def cascade_topk_ingraph(codes: torch.Tensor, s: torch.Tensor, k: int,
                         state: Optional[PrunedHeadState] = None, *,
                         tile: int = DEFAULT_PRUNE_TILE,
                         seed_policy: str = "greedy",
                         seed_tiles: int = DEFAULT_SEED_TILES,
                         seed_max_tiles: int = DEFAULT_SEED_MAX_TILES,
                         seed_stab_tol: float = DEFAULT_SEED_STAB_TOL,
                         slot_budget: Optional[int] = None,
                         ladder=None, super_ladder=None,
                         pin_rung: bool = False,
                         query_grouping: bool = False,
                         n_groups: int = DEFAULT_N_GROUPS,
                         live: Optional[torch.Tensor] = None,
                         return_stats: bool = False):
    """Exact pruned top-k: bounds -> theta -> survival -> compaction ->
    the fused kernel over the surviving tiles -> (vals (B,k), ids (B,k)
    int32[, stats]).  Bit-identical to the exhaustive ``pqtopk_fused``
    route, ties included.

    ``ladder`` (or ``slot_budget=b`` for ``(b,)``) lists slot budgets; the
    exhaustive rung is always appended.  The survivor count — the union
    count, or the largest group's count when grouped — is read on the
    host once, and the first rung that holds it is launched on its prefix
    of the slot buffer.  ``pin_rung`` keeps only the cheapest rung:
    bounded cost, but survivors past its budget are dropped (possibly
    inexact; the caller tags such results).

    ``query_grouping`` with ``n_groups > 1``: per-query thetas and
    survival, queries bucketed into groups, and a 2D (batch tile, slot)
    table so each batch tile scores only its group's survivors.

    A state with a super level runs the hierarchical route: theta seeded
    from the super bounds, pass 0 over the supers, and the fused kernel
    over the surviving supers' surviving children.  ``super_ladder`` lists
    the pass-0 budgets (default :func:`default_super_ladder`, exhaustive
    rung appended); the child rungs are normalised against the super
    rung's ``r_sup * factor`` children.  ``pin_rung`` pins both levels.
    It cannot be combined with ``query_grouping``.

    ``live`` (N,) bool is the mutable catalogue's tombstone mask: dead rows
    (delisted items, capacity padding) are kept out of theta seeding and
    score ``-inf`` inside the fused kernel, and ``-inf`` winners get the id
    N.  Stale (loosened) bounds still dominate every live item's score, so
    the result equals a cascade over a freshly rebuilt live-only head.

    ``stats`` has exactly :data:`STATS_KEYS`; the seed survival estimate
    stays a 0-d device tensor, everything else is a host value."""
    if state is None:
        state = build_pruned_state(codes, int(s.shape[-1]), tile)
    _check_flat(state)
    if live is not None and live.shape[0] != codes.shape[0]:
        raise ValueError(f"live mask covers {live.shape[0]} rows but the "
                         f"catalogue has {codes.shape[0]}")
    tile = state.tile
    bq = s.shape[0]
    t_total = state.n_tiles
    if ladder is None and slot_budget is not None:
        ladder = (int(slot_budget),)
    grouped = query_grouping and n_groups > 1
    if grouped and state.has_super:
        raise ValueError(
            "query_grouping and hierarchical super-tiles are mutually "
            "exclusive; strip the super level (with_super(state, 0)) or "
            "disable grouping")
    sup = {"n_super": 0, "n_super_survived": 0, "super_rung_hit": 0,
           "bounds_computed": t_total}
    if state.has_super:
        vals, ids, tail = _hier_tail(
            codes, s, k, state, ladder=ladder, super_ladder=super_ladder,
            pin_rung=pin_rung, live=live,
            seed_kw=dict(seed_policy=seed_policy, seed_tiles=seed_tiles,
                         seed_max_tiles=seed_max_tiles,
                         seed_stab_tol=seed_stab_tol, live=live))
        rungs, rung, count = tail["rungs"], tail["rung"], tail["count"]
        n_seed_used, seed_sf = tail["n_seed_used"], tail["seed_sf"]
        sup = {key: tail[key] for key in sup}
    else:
        rungs = normalize_ladder(ladder, t_total, k, tile)
        if pin_rung:
            rungs = rungs[:1]
        seed_kw = dict(tile=tile, seed_policy=seed_policy,
                       seed_tiles=seed_tiles, seed_max_tiles=seed_max_tiles,
                       seed_stab_tol=seed_stab_tol,
                       degenerate=degenerate_tile_mask(state), live=live)
        bounds = tile_bounds(state, s)
        if grouped:
            bt = kernel_ops.group_batch_tile(bq, n_groups)
            theta, n_seed_used, seed_sf = theta_seed_perquery(
                codes, s, bounds, k, **seed_kw)
            pq_mask = survival_mask_perquery(bounds, theta)
            perm, inv, slots2d, counts = group_and_compact(
                pq_mask, n_groups=n_groups, batch_tile=bt)
            union = pq_mask.any(dim=0).sum(dtype=torch.int32)
            # The one host read of the batch: group counts and the union
            # count.
            *group_counts, count = cost.host_read(
                "pruning.cascade_topk_ingraph: group and union counts",
                lambda: torch.cat([counts, union[None]]).tolist(),
                [t_total] * (counts.shape[0] + 1), of=counts)
            max_group = max(group_counts)
            vals, ids, rung = kernel_ops.pq_topk_tiles_ladder(
                codes, s[perm], k, [slots2d[:, :r] for r in rungs],
                max_group, tile=tile, batch_tile=bt, live=live)
            vals, ids = vals[inv], ids[inv]
            n_bt = len(group_counts)
            pairs_scored = sum(group_counts) * bt
            pairs_union = count * n_bt * bt
            n_groups_eff = n_bt
        else:
            theta, n_seed_used, seed_sf = theta_seed_ingraph(
                codes, s, bounds, k, **seed_kw)
            slots_full, count_t = compact_mask(survival_mask(bounds, theta))
            count = _host_int(count_t, t_total,         # the one host read
                              "pruning.cascade_topk_ingraph: survivor count")
            vals, ids, rung = kernel_ops.pq_topk_tiles_ladder(
                codes, s, k, [slots_full[:r] for r in rungs], count,
                tile=tile, live=live)
    if not grouped:
        max_group = count
        bt = kernel_ops.effective_batch_tile(bq)
        pairs_scored = pairs_union = count * (-(-bq // bt) * bt)
        n_groups_eff = 1
    if not return_stats:
        return vals, ids
    stats = {"n_tiles": t_total, "n_survived": count,
             "n_scored": rungs[rung],
             # The reference's compiled division by a constant: a multiply
             # by the float32 reciprocal.
             "survival_fraction": np.float32(count) * np.float32(
                 1.0 / max(t_total, 1)),
             "n_seed_used": n_seed_used, "seed_survival_est": seed_sf,
             "rung_hit": rung, "n_rungs": len(rungs),
             "slot_overflow": len(rungs) > 1 and max_group > rungs[-2],
             "bound_backend": state.backend,
             "n_groups": n_groups_eff, "max_group_survived": max_group,
             "pairs_scored": pairs_scored, "pairs_union": pairs_union,
             **sup}
    return vals, ids, stats


# ---------------------------------------------------------------------------
# the host two-pass cascade (the reference route the cascade is held to)
# ---------------------------------------------------------------------------


def slot_bucket(n_survived: int, k: int, tile: int) -> int:
    """Survivor slots rounded up to a power of two, at least enough tiles
    to hold k."""
    need = max(1, n_survived, -(-k // tile))
    return 1 << (need - 1).bit_length()


def cascade_topk(codes: torch.Tensor, s: torch.Tensor, k: int, *, tile: int,
                 seed_tiles: int = 2, meta: Optional[TileMeta] = None,
                 return_stats: bool = False):
    """Exact top-k by the host two-pass cascade: pass 1 (dense-presence
    bounds, greedy seed, survival mask, :func:`pruned_pass1`), the
    survivors read to the host and listed in a power-of-two slot bucket
    padded with the past-the-end tile (:func:`ops.sentinel_tile`, whose
    rows all lie past N and score ``-inf``), then the fused kernel over
    that list.  -> (vals (B,k), ids (B,k) int32[, stats]), bit-identical
    to the exhaustive route; ``stats`` has :data:`STATS_KEYS`."""
    n = codes.shape[0]
    tile = min(tile, n)
    if meta is None:
        meta = get_tile_metadata(codes, int(s.shape[-1]), tile)
    mask, _, _ = pruned_pass1(codes, meta.present, s, k, tile=tile,
                              n_seed=seed_tiles)
    survivors = mask.nonzero().flatten().cpu()          # the host read
    n_surv = survivors.numel()
    n_slots = slot_bucket(n_surv, k, tile)
    tile_idx = torch.full((n_slots,), kernel_ops.sentinel_tile(n, tile),
                          dtype=torch.int32)
    tile_idx[:n_surv] = survivors
    vals, ids = kernel_ops.pq_topk_tiles(codes, s, k, tile_idx, tile=tile)
    if not return_stats:
        return vals, ids
    sf = n_surv / max(meta.n_tiles, 1)
    pairs = n_surv * int(s.shape[0])
    stats = {"n_tiles": meta.n_tiles, "n_survived": n_surv,
             "n_scored": n_slots, "survival_fraction": sf,
             "n_seed_used": min(max(seed_tiles, -(-k // tile)), meta.n_tiles),
             "seed_survival_est": sf, "rung_hit": 0, "n_rungs": 1,
             "slot_overflow": False, "bound_backend": "bitmask",
             "n_groups": 1, "max_group_survived": n_surv,
             "pairs_scored": pairs, "pairs_union": pairs,
             "n_super": 0, "n_super_survived": 0, "super_rung_hit": 0,
             "bounds_computed": meta.n_tiles}
    return vals, ids, stats


# ---------------------------------------------------------------------------
# calibration observables (engine build time)
# ---------------------------------------------------------------------------


def survival_count(codes: torch.Tensor, s: torch.Tensor, k: int,
                   state: PrunedHeadState, *,
                   seed_policy: str = "greedy",
                   seed_tiles: int = DEFAULT_SEED_TILES,
                   seed_max_tiles: int = DEFAULT_SEED_MAX_TILES,
                   seed_stab_tol: float = DEFAULT_SEED_STAB_TOL,
                   live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Surviving-tile count of one batch (0-d int32): the bounds + theta
    prefix of the batch-any cascade, no scoring pass.  A super state seeds
    theta from the super bounds, as its serve path does, and counts the
    surviving child tiles (children of a pruned super cannot survive, so
    this is the tail's survivor count)."""
    _check_flat(state)
    bounds = tile_bounds(state, s)
    seed_parts, seed_tile, seed_bounds = state.meta_arrays(), state.tile, bounds
    if state.has_super:
        seed_parts = state.super_meta_arrays()
        seed_tile *= state.super_factor
        seed_bounds = bounds_from_parts(state.backend, seed_parts, s)
    theta, _, _ = theta_seed_ingraph(
        codes, s, seed_bounds, k, tile=seed_tile, seed_policy=seed_policy,
        seed_tiles=seed_tiles, seed_max_tiles=seed_max_tiles,
        seed_stab_tol=seed_stab_tol,
        degenerate=degenerate_from_parts(state.backend, seed_parts, state.b),
        live=live)
    return survival_mask(bounds, theta).sum(dtype=torch.int32)


def survival_count_grouped(codes: torch.Tensor, s: torch.Tensor, k: int,
                           state: PrunedHeadState, *, n_groups: int,
                           batch_tile: Optional[int] = None,
                           seed_policy: str = "greedy",
                           seed_tiles: int = DEFAULT_SEED_TILES,
                           seed_max_tiles: int = DEFAULT_SEED_MAX_TILES,
                           seed_stab_tol: float = DEFAULT_SEED_STAB_TOL,
                           live: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Largest per-group surviving-tile count of one batch (0-d int32):
    the observable the grouped ladder escalates on."""
    _check_flat(state)
    if batch_tile is None:
        batch_tile = kernel_ops.group_batch_tile(s.shape[0], n_groups)
    bounds = tile_bounds(state, s)
    theta, _, _ = theta_seed_perquery(
        codes, s, bounds, k, tile=state.tile, seed_policy=seed_policy,
        seed_tiles=seed_tiles, seed_max_tiles=seed_max_tiles,
        seed_stab_tol=seed_stab_tol, degenerate=degenerate_tile_mask(state),
        live=live)
    _, _, _, counts = group_and_compact(
        survival_mask_perquery(bounds, theta), n_groups=n_groups,
        batch_tile=batch_tile)
    return counts.max()
