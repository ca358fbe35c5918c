"""Public wrappers around the PQTopK kernels.

A tensor on the card goes to the CUDA kernel (or the call raises); a
tensor on the CPU goes to the kernel's plain version in :mod:`ref`; a
meta tensor (the dry run) gets meta outputs of the kernel's shapes and
dtypes, and nothing is computed, built or loaded.  Each call of
:func:`pq_scores` or :func:`pq_topk_slots` is one launch that
:func:`repro_torch.kernels.cost.launch` records, with its work and its
plan inputs (the slot table included), inside a recording block, on any
device.  The
wrappers own the item-tile rule ``tile = min(2048, round_up(N, 128))``
and the ``k > tile`` error, which the engine's ``max_k`` and the slot
count depend on, and the cross-slot merge of the fused kernel's winners.

:func:`pq_topk_tiles` is the pruned cascade's scoring stage: the fused
kernel over a compacted tile list (1D, ``-1`` sentinel slots at the tail)
or a 2D (batch tile, slot) table (the grouped route), and
:func:`pq_topk_tiles_ladder` launches it on the first slot-budget rung
that holds a survivor count the caller has read on the host.  Both take
the mutable catalogue's ``live`` tombstone mask: dead rows score ``-inf``
inside the kernel's tile top-k, and :func:`_remap_dead` gives every
``-inf`` winner the sentinel id ``N``.

A pruning tile may be longer than the kernel's largest tile (a sharded
state's tile holds the per-shard top-(k + pad), ``k + pad`` > 2048 at the
engine's ``max_k``): :func:`pq_topk_tiles` then scores each listed tile
as ``f`` consecutive slots of ``tile / f`` rows (:func:`split_factor`),
with the same rows, ids and merge, so the result is the same.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.core import topk as topk_lib
from repro_torch.kernels import cost as _cost
from repro_torch.kernels.pqtopk import kernel as _k, ref as _ref

NEG_INF = float("-inf")


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def effective_batch_tile(bq: int,
                         batch_tile: int = _k.DEFAULT_BATCH_TILE) -> int:
    """Batch-tile size the reference's fused kernel pads a batch of ``bq``
    queries to (small batches round up to 8, never past the default).  The
    CUDA kernel and the plain version take any batch; this and the two
    ``_pad_*`` helpers mirror the reference's padding for parity checks."""
    return min(batch_tile, _round_up(bq, 8))


def group_batch_tile(bq: int, n_groups: int,
                     batch_tile: int = _k.DEFAULT_BATCH_TILE) -> int:
    """Batch-tile size of the grouped route: the power of two (at least 8)
    that splits the batch into about ``n_groups`` tiles, capped at
    :func:`effective_batch_tile`."""
    target = -(-bq // max(n_groups, 1))
    bt = 8
    while bt < target:
        bt *= 2
    return min(bt, effective_batch_tile(bq, batch_tile))


def n_tiles(n: int, tile: int) -> int:
    """Number of item tiles covering an N-item catalogue."""
    return -(-n // tile)


def sentinel_tile(n: int, tile: int) -> int:
    """Index of the all-padding tile just past the catalogue."""
    return n_tiles(n, tile)


def _pad_codes(codes: torch.Tensor, tile: int, *, sentinel: bool = False
               ) -> torch.Tensor:
    n = codes.shape[0]
    pad = (-n) % tile + (tile if sentinel else 0)
    if pad:
        codes = torch.cat([codes, codes.new_zeros((pad, codes.shape[1]))])
    return codes


def _pad_batch(s: torch.Tensor, batch_tile: int) -> torch.Tensor:
    pad = (-s.shape[0]) % batch_tile
    if pad:
        s = F.pad(s, (0, 0, 0, 0, 0, pad))
    return s


def _merge_slot_winners(tv: torch.Tensor, ti: torch.Tensor, k: int):
    """(B, n_slots, K) per-slot winners -> global (B, k).  Slots ascend in
    id order, so a stable descending sort of the flattened candidates
    breaks ties by the lowest global id."""
    bq, slots, kk = tv.shape
    with tracing.span("head.merge"):
        fv, fi = topk_lib.topk(tv.reshape(bq, slots * kk), k)
        return fv, torch.gather(ti.reshape(bq, slots * kk), 1, fi.long())


def _remap_dead(fv: torch.Tensor, fi: torch.Tensor, n: int):
    """Tombstone-route winner cleanup: every ``-inf`` winner (a dead item, a
    sentinel slot, or fewer than k live items) gets the sentinel id ``n``,
    the number of catalogue rows (the capacity of a mutable catalogue), so
    callers never see a dead row's id."""
    return fv, torch.where(fv == NEG_INF, n, fi)


def pq_scores(codes: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """PQ scores for all items. codes (N,m), s (B,m,b) -> (B,N) f32."""
    def body():
        if s.is_meta:
            return torch.empty((s.shape[0], codes.shape[0]),
                               dtype=torch.float32, device="meta")
        if s.is_cuda:
            return _k.pq_scores_cuda(codes.contiguous(), s.contiguous())
        return _ref.pq_scores(codes, s)

    return _cost.launch("pq_scores", lambda: _cost.pq_scores_work(
        codes.shape[0], codes.shape[1], codes.element_size(), s.shape[0],
        s.shape[2]), body, lambda: _cost.LaunchInputs(
            "pq_scores", "scores", codes.shape[0], codes.shape[1],
            s.shape[2], s.shape[0], codes.element_size(),
            dtype=str(codes.dtype)), reads=(codes, s))


def pq_topk_slots(codes: torch.Tensor, s: torch.Tensor, k: int,
                  tile_idx: torch.Tensor, *, n_items: int, tile: int,
                  batch_tile: int = 0, live=None):
    """The fused kernel's output: per-slot winners (B, n_slots, k).  A 2D
    ``tile_idx`` gives row ``j`` to queries ``j*batch_tile ..``; ``live``
    (N,) masks dead rows inside each tile's top-k."""
    slots = tile_idx.shape[-1]

    def body():
        if s.is_meta:
            shape = (s.shape[0], slots, k)
            return (torch.empty(shape, dtype=torch.float32, device="meta"),
                    torch.empty(shape, dtype=torch.int32, device="meta"))
        if s.is_cuda:
            return _k.pq_topk_fused_cuda(
                codes.contiguous(), s.contiguous(), k, tile_idx.contiguous(),
                n_items=n_items, tile=tile, batch_tile=batch_tile,
                live=None if live is None else live.contiguous())
        return _ref.pq_topk_slots(codes, s, k, tile_idx, n_items=n_items,
                                  tile=tile, batch_tile=batch_tile, live=live)

    if slots == 0:      # the kernel launches nothing for an empty list
        return body()
    form = ("pq_topk_fused_live" if live is not None
            else "pq_topk_fused_2d" if tile_idx.dim() == 2
            else "pq_topk_fused")
    return _cost.launch(form, lambda: _cost.pq_topk_fused_work(
        codes.shape[0], codes.shape[1], codes.element_size(), s.shape[0],
        s.shape[2], k, slots, tile_idx.shape[0] if tile_idx.dim() == 2
        else 1, tile, live is not None), body, lambda: _cost.LaunchInputs(
            form, "fused", codes.shape[0], codes.shape[1], s.shape[2],
            s.shape[0], codes.element_size(), k=k, n_items=n_items,
            tile=tile, batch_tile=batch_tile, live=live is not None,
            slots=slots, table=tile_idx, dtype=str(codes.dtype)),
        reads=(codes, s, tile_idx, live))


def pq_topk(codes: torch.Tensor, s: torch.Tensor, k: int, *,
            tile: int = _k.DEFAULT_TILE):
    """Fused PQ scoring + exact top-k over the whole catalogue (identity
    tile list; the tile winners contain all global winners when k <= tile).
    -> (vals (B,k), ids (B,k))."""
    n = codes.shape[0]
    tile = min(tile, _round_up(n, 128))
    if k > tile:
        raise ValueError(f"k={k} > tile={tile}")
    idx = torch.arange(n_tiles(n, tile), dtype=torch.int32, device=s.device)
    tv, ti = pq_topk_slots(codes, s, k, idx, n_items=n, tile=tile)
    return _merge_slot_winners(tv, ti, k)


def split_factor(tile: int) -> int:
    """Fewest equal parts of a ``tile``-row pruning tile that each fit the
    fused kernel's largest tile (1 when it fits whole)."""
    return next(f for f in range(1, tile + 1)
                if tile % f == 0 and tile // f <= _k.MAX_TILE)


def _split_slots(tile_idx: torch.Tensor, f: int) -> torch.Tensor:
    """Each slot ``t`` -> the ``f`` slots ``t*f .. t*f + f - 1`` of a tile
    ``f`` times shorter (``-1`` -> ``f`` sentinels); slots stay
    ascending."""
    sub = tile_idx[..., None] * f + torch.arange(f, dtype=tile_idx.dtype,
                                                 device=tile_idx.device)
    sub = torch.where(tile_idx[..., None] < 0, -1, sub)
    return sub.reshape(tile_idx.shape[:-1] + (-1,))


def pq_topk_tiles(codes: torch.Tensor, s: torch.Tensor, k: int,
                  tile_idx: torch.Tensor, *, tile: int = _k.DEFAULT_TILE,
                  batch_tile: int = _k.DEFAULT_BATCH_TILE, live=None):
    """Fused scoring + top-k over the tiles a compacted list names.

    ``tile_idx`` is 1D (one ascending list for the batch, ``-1`` sentinels
    behind) or 2D ``(n_batch_tiles, n_slots)`` (each batch tile of
    ``effective_batch_tile(B, batch_tile)`` queries scores its own
    ascending row).  Work is O(slots * tile * m), not O(N * m).
    ``live`` (N,) bool is the tombstone mask: dead rows score ``-inf``
    inside the tile top-k and ``-inf`` winners get the id N.
    -> (vals (B,k), ids (B,k)), bit-identical to the exhaustive route for
    the surviving items."""
    n = codes.shape[0]
    if live is not None and tuple(live.shape) != (n,):
        raise ValueError(f"live mask shape {tuple(live.shape)} != ({n},)")
    bq = s.shape[0]
    tile = min(tile, _round_up(n, 128))
    if k > tile:
        raise ValueError(f"k={k} > tile={tile}")
    bt = effective_batch_tile(bq, batch_tile) if tile_idx.dim() == 2 else 0
    idx = tile_idx.to(device=s.device, dtype=torch.int32)
    f = split_factor(tile)
    if f > 1:
        idx, tile = _split_slots(idx, f), tile // f
    tv, ti = pq_topk_slots(codes, s, min(k, tile), idx, n_items=n,
                           tile=tile, batch_tile=bt, live=live)
    fv, fi = _merge_slot_winners(tv, ti, k)
    if live is not None:
        fv, fi = _remap_dead(fv, fi, n)
    return fv, fi


def pq_topk_tiles_ladder(codes: torch.Tensor, s: torch.Tensor, k: int,
                         slot_lists, count: int, *, tile: int,
                         batch_tile: int = _k.DEFAULT_BATCH_TILE, live=None):
    """Score the first rung of ``slot_lists`` (``-1``-padded buffers of
    strictly increasing length, the last exhaustive; 2D rows for the
    grouped route) whose budget holds ``count``, the survivor count (the
    largest group's when grouped) that the caller read on the host; the
    last rung scores whatever the count.  ``live`` as for
    :func:`pq_topk_tiles`.  -> (vals (B,k), ids (B,k), rung
    index)."""
    rung = next((i for i, sl in enumerate(slot_lists[:-1])
                 if count <= sl.shape[-1]), len(slot_lists) - 1)
    vals, ids = pq_topk_tiles(codes, s, k, slot_lists[rung], tile=tile,
                              batch_tile=batch_tile, live=live)
    return vals, ids, rung
