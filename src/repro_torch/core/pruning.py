"""Per-tile score upper bounds and the pruned cascade (``pqtopk_pruned``).

The port of the reference's ``core/pruning.py``, flat layout only.  For
any item i in tile t,

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

Presence words are ``int32`` holding the reference's ``uint32`` bit
patterns (PyTorch gives ``uint32`` few operations).  Every top-k here is
:func:`repro_torch.core.topk.topk` (ties to the lowest index, as
``lax.top_k``).  The mutable catalogue's ``live`` tombstone mask is
threaded through the masked builds, theta seeding and the fused kernel.
Super-tiles and the sharded layout are later slices: they raise
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import pq as pq_lib
from repro_torch.core import topk as topk_lib
from repro_torch.core.scoring import tree_sum
from repro_torch.kernels.pqtopk import ops as kernel_ops

NEG_INF = float("-inf")

#: Default pruning granularity (items per tile) — the fused kernel's item
#: tile, so one surviving tile is one kernel slot.
DEFAULT_PRUNE_TILE = 2048
DEFAULT_SEED_TILES = 2
DEFAULT_SEED_MAX_TILES = 16
DEFAULT_SEED_STAB_TOL = 0.05
DEFAULT_N_GROUPS = 8

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

_SUPER_SLICE = ("hierarchical super-tiles (super_factor > 1) are a later "
                "port slice (ROADMAP queue A 1) and not ported yet")
_SHARD_SLICE = ("the sharded pruned layout (shards > 1) is a later port "
                "slice and not ported yet")


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
class PrunedHeadState:
    """Query-independent pruning metadata, carried in the item head's
    parameter dict as ``"pruned"`` (the reference's fields, unchanged).

    ``"bitmask"``: ``packed`` (T, m, ceil(b/32)) int32 presence words;
    ``"range"``: ``code_lo``/``code_hi`` (T, m) int16.  The port builds and
    serves the flat layout only (``shards == 1``, ``super_factor == 0``);
    the shard and super-tile fields are kept so a reference state converts
    field for field (:mod:`repro_torch.interop`)."""

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

    @property
    def has_super(self) -> bool:
        return self.super_factor > 1

    @property
    def n_tiles(self) -> int:
        return self.meta_arrays()[0].shape[0]

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
    """Head-build-time constructor of the flat state, on ``codes``'s
    device."""
    if shards > 1:
        raise NotImplementedError(_SHARD_SLICE)
    if super_factor > 1:
        raise NotImplementedError(_SUPER_SLICE)
    return build_pruned_state_masked(codes, None, b, tile, backend=backend)


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
           live: Optional[torch.Tensor]) -> torch.Tensor:
    """Which of the rows ``gid`` (clamped: ``safe``) a seed may score: those
    inside the catalogue and, with a tombstone mask, alive."""
    ok = gid < n
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


def _seed_stages(score_chunk, order, sizes, k, bq, survival_est,
                 seed_stab_tol, device):
    """The seed policy's stages: score each stage's chunk, merge the
    values, stop once the survival estimate moved by <= ``seed_stab_tol``
    (read on the host after each growth stage; greedy has one stage)."""
    vals = _merge_values(torch.full((bq, k), NEG_INF, device=device),
                         score_chunk(order[..., :sizes[0]]), k)
    sf = survival_est(vals[:, -1])
    n_used = sizes[0]
    for prev, size in zip(sizes, sizes[1:]):
        vals = _merge_values(vals, score_chunk(order[..., prev:size]), k)
        sf_new = survival_est(vals[:, -1])
        stable = bool(torch.abs(sf_new - sf) <= seed_stab_tol)
        sf, n_used = sf_new, size
        if stable:
            break
    return vals[:, -1], n_used, sf


def theta_seed_ingraph(codes: torch.Tensor, s: torch.Tensor,
                       bounds: torch.Tensor, k: int, *, tile: int,
                       seed_policy: str = "greedy",
                       seed_tiles: int = DEFAULT_SEED_TILES,
                       seed_max_tiles: int = DEFAULT_SEED_MAX_TILES,
                       seed_stab_tol: float = DEFAULT_SEED_STAB_TOL,
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
    cannot reach, and the cascade would no longer be exact."""
    n = codes.shape[0]
    bq = s.shape[0]
    n_tiles = bounds.shape[1]
    sizes = seed_schedule(seed_policy, seed_tiles, seed_max_tiles, k, tile,
                          n_tiles)
    order = topk_lib.topk(seed_order_key(bounds.amax(dim=0), degenerate),
                          sizes[-1])[1].long()

    def score_chunk(tile_ids):
        gid, safe = _tile_rows(tile_ids, tile, n)
        rows = pq_lib.take_rows(codes, safe.reshape(-1)).contiguous()
        sc = kernel_ops.pq_scores(rows, s)
        return torch.where(_valid(gid, safe, n, live).reshape(-1)[None, :],
                           sc, NEG_INF)

    return _seed_stages(score_chunk, order, sizes, k, bq,
                        lambda th: _mean(survival_mask(bounds, th)),
                        seed_stab_tol, s.device)


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
                        degenerate: Optional[torch.Tensor] = None,
                        live: Optional[torch.Tensor] = None):
    """Per-query theta seeding: each query scores its OWN most promising
    tiles (plain PyTorch gathers from its S row, in ``tree_sum`` order) ->
    (theta (B,), n_seed_used int, mean per-query survival f32 0-d).
    ``live`` excludes dead rows, as in :func:`theta_seed_ingraph`."""
    n, m = codes.shape
    bq = s.shape[0]
    n_tiles = bounds.shape[1]
    sizes = seed_schedule(seed_policy, seed_tiles, seed_max_tiles, k, tile,
                          n_tiles)
    order = topk_lib.topk(seed_order_key(bounds, degenerate),
                          sizes[-1])[1].long()                   # (B, n_max)
    s = s.float()

    def score_chunk(tile_ids):
        gid, safe = _tile_rows(tile_ids, tile, n)                # (B, c, tile)
        sel = pq_lib.widen(pq_lib.take_rows(codes, safe.reshape(-1))
                           ).reshape(bq, -1, m)
        sc = tree_sum([torch.gather(s[:, kk, :], 1, sel[:, :, kk])
                       for kk in range(m)])
        return torch.where(_valid(gid, safe, n, live).reshape(bq, -1), sc,
                           NEG_INF)

    return _seed_stages(
        score_chunk, order, sizes, k, bq,
        lambda th: _mean(survival_mask_perquery(bounds, th)),
        seed_stab_tol, s.device)


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
    if state.has_super:
        raise NotImplementedError(_SUPER_SLICE)


def cascade_topk_ingraph(codes: torch.Tensor, s: torch.Tensor, k: int,
                         state: Optional[PrunedHeadState] = None, *,
                         tile: int = DEFAULT_PRUNE_TILE,
                         seed_policy: str = "greedy",
                         seed_tiles: int = DEFAULT_SEED_TILES,
                         seed_max_tiles: int = DEFAULT_SEED_MAX_TILES,
                         seed_stab_tol: float = DEFAULT_SEED_STAB_TOL,
                         slot_budget: Optional[int] = None,
                         ladder=None, pin_rung: bool = False,
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
    rungs = normalize_ladder(ladder, t_total, k, tile)
    if pin_rung:
        rungs = rungs[:1]
    seed_kw = dict(tile=tile, seed_policy=seed_policy, seed_tiles=seed_tiles,
                   seed_max_tiles=seed_max_tiles, seed_stab_tol=seed_stab_tol,
                   degenerate=degenerate_tile_mask(state), live=live)
    bounds = tile_bounds(state, s)
    if query_grouping and n_groups > 1:
        bt = kernel_ops.group_batch_tile(bq, n_groups)
        theta, n_seed_used, seed_sf = theta_seed_perquery(
            codes, s, bounds, k, **seed_kw)
        pq_mask = survival_mask_perquery(bounds, theta)
        perm, inv, slots2d, counts = group_and_compact(
            pq_mask, n_groups=n_groups, batch_tile=bt)
        union = pq_mask.any(dim=0).sum(dtype=torch.int32)
        # The one host read of the batch: group counts and the union count.
        *group_counts, count = torch.cat([counts, union[None]]).tolist()
        max_group = max(group_counts)
        vals, ids, rung = kernel_ops.pq_topk_tiles_ladder(
            codes, s[perm], k, [slots2d[:, :r] for r in rungs], max_group,
            tile=tile, batch_tile=bt, live=live)
        vals, ids = vals[inv], ids[inv]
        n_bt = len(group_counts)
        pairs_scored = sum(group_counts) * bt
        pairs_union = count * n_bt * bt
        n_groups_eff = n_bt
    else:
        theta, n_seed_used, seed_sf = theta_seed_ingraph(
            codes, s, bounds, k, **seed_kw)
        slots_full, count_t = compact_mask(survival_mask(bounds, theta))
        count = max_group = int(count_t)            # the one host read
        vals, ids, rung = kernel_ops.pq_topk_tiles_ladder(
            codes, s, k, [slots_full[:r] for r in rungs], count, tile=tile,
            live=live)
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
             "n_super": 0, "n_super_survived": 0, "super_rung_hit": 0,
             "bounds_computed": t_total}
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
    prefix of the batch-any cascade, no scoring pass."""
    _check_flat(state)
    bounds = tile_bounds(state, s)
    theta, _, _ = theta_seed_ingraph(
        codes, s, bounds, k, tile=state.tile, seed_policy=seed_policy,
        seed_tiles=seed_tiles, seed_max_tiles=seed_max_tiles,
        seed_stab_tol=seed_stab_tol, degenerate=degenerate_tile_mask(state),
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
