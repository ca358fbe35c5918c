"""Top-K selection: exact, tiled (two-stage) and approximate block-max.

Ties go to the lowest index, as ``lax.top_k`` breaks them in the
reference.  ``torch.topk`` promises no order among equal values, so every
selection here is a stable descending sort.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

NEG_INF = float("-inf")


def topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis -> (values, int32 indices); ties to
    the lowest index."""
    v, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k].to(torch.int32)


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


def approx_topk_maxblock(scores: torch.Tensor, k: int, oversample: int = 2,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k: split N into k*oversample blocks and keep each
    block's maximum (first index on ties), then the top-k of the maxima."""
    b, n = scores.shape
    n_blocks = min(k * oversample, n)
    pad = (-n) % n_blocks
    if pad:
        scores = F.pad(scores, (0, pad), value=NEG_INF)
    blk = scores.reshape(b, n_blocks, -1)
    bv, bi = blk.max(dim=2)
    width = blk.shape[2]
    gi = bi.to(torch.int32) + (torch.arange(
        n_blocks, dtype=torch.int32, device=scores.device) * width)[None, :]
    fv, fi = topk(bv, k)
    return fv, torch.gather(gi, 1, fi.long())
