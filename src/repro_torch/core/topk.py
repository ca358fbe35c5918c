"""Top-K selection: exact, tiled (two-stage) and approximate block-max.

Every selection ranks in ``lax.top_k``'s total order, the reference's:
larger first, +0.0 above -0.0, +NaN above +inf and -NaN below -inf (NaNs
by their bits), ties to the lowest index.  :func:`order_key` maps floats
to integers in that order, and a stable descending sort of the keys gives
it; ``torch.sort`` on the floats would tie +-0 and put NaN of either sign
first, and ``torch.topk`` promises no order among equal values.

:func:`merge_local_topk` and :func:`local_then_merge_topk` are the merge
half of the item-sharded routes: per-shard winners gathered to the mesh's
lead device in shard order, so ties still go to the lowest global id.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding

NEG_INF = float("-inf")


def order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys in ``lax.top_k``'s order of float32 ``x``: the bits with
    the magnitude bits flipped where the sign bit is set, ``bits ^ ((bits
    >> 31) & 0x7fffffff)``."""
    if x.dtype != torch.float32:
        raise TypeError(f"top-k ranks float32 scores, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7fffffff)


def topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis -> (values, int32 indices), in
    ``lax.top_k``'s order; ties to the lowest index."""
    _, i = torch.sort(order_key(scores), dim=-1, descending=True,
                      stable=True)
    i = i[..., :k]
    return torch.gather(scores, -1, i), i.to(torch.int32)


def tiled_topk(scores: torch.Tensor, k: int, tile: int = 8192,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage exact top-k: per-tile top-k, then top-k over the winners.

    A ragged last tile is padded with ``-inf``; candidates stay in
    ascending id order, so ties resolve as in a single :func:`topk`."""
    b, n = scores.shape
    if n <= tile:
        return topk(scores, k)
    if n % tile:
        scores = F.pad(scores, (0, (-n) % tile), value=NEG_INF)
    n_tiles = scores.shape[1] // tile
    kk = min(k, tile)
    tv, ti = topk(scores.reshape(b, n_tiles, tile), kk)          # (B, T, kk)
    base = (torch.arange(n_tiles, dtype=torch.int32,
                         device=scores.device) * tile)[None, :, None]
    cand_v = tv.reshape(b, n_tiles * kk)
    cand_i = (ti + base).reshape(b, n_tiles * kk)
    fv, fi = topk(cand_v, k)
    return fv, torch.gather(cand_i, 1, fi.long())


def merge_local_topk(local_vals: Sequence[torch.Tensor],
                     local_ids: Sequence[torch.Tensor], k: int, mesh,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard winners: ``local_vals``/``local_ids`` are each
    shard's (B, k_local) candidates with GLOBAL ids.  Gathered to the lead
    device in shard order and ranked once: O(k_local * shards) values and
    ids, independent of N.  -> (vals (B, k), ids (B, k)) on the lead."""
    all_v = sharding.all_gather(local_vals, mesh)
    all_i = sharding.all_gather(local_ids, mesh)
    fv, fi = topk(all_v, k)
    return fv, torch.gather(all_i, 1, fi.long())


def local_then_merge_topk(scores_local: Sequence[torch.Tensor], k: int,
                          mesh, offsets: Sequence[int], axis: str = "model",
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each shard's exact top-k of its (B, N_local) scores (shard ``i``'s
    first item has global id ``offsets[i]``; shard ``i`` is position ``i``
    of ``axis``), then :func:`merge_local_topk`."""
    vals, ids = [], []
    for i, (r, off) in enumerate(zip(scores_local, offsets)):
        with sharding.on_device(r.device, (axis, i)):
            v, idx = tiled_topk(r, min(k, r.shape[-1]))
            vals.append(v)
            ids.append(idx + off)
    return merge_local_topk(vals, ids, k, mesh)


def approx_topk_maxblock(scores: torch.Tensor, k: int, oversample: int = 2,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k: split N into k*oversample blocks and keep each
    block's maximum, then the top-k of the maxima.

    As the reference's ``max``/``argmax``: the index is the first maximum
    (the first NaN where the block has one); the value propagates NaN and
    is +0.0 where the block's maximum is zero and it holds a +0.0, though
    the first maximum may be a -0.0."""
    b, n = scores.shape
    n_blocks = min(k * oversample, n)
    pad = (-n) % n_blocks
    if pad:
        scores = F.pad(scores, (0, pad), value=NEG_INF)
    blk = scores.reshape(b, n_blocks, -1)
    bv, bi = blk.max(dim=2)
    pos_zero = ((blk == 0) & ~torch.signbit(blk)).any(dim=2)
    bv = torch.where((bv == 0) & pos_zero, 0.0, bv)
    width = blk.shape[2]
    gi = bi.to(torch.int32) + (torch.arange(
        n_blocks, dtype=torch.int32, device=scores.device) * width)[None, :]
    fv, fi = topk(bv, k)
    return fv, torch.gather(gi, 1, fi.long())
