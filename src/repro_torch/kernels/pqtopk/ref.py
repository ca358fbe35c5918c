"""Plain PyTorch versions of the two PQTopK kernels.

The CPU path of :mod:`ops` runs these, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card.  Their float32 add order is the
kernels' (``tree_sum`` over the per-split gathers), so the comparison is
at atol=0.

:func:`plant_specials` makes the inputs that hold a selection to
``lax.top_k``'s total order (signed zeros, NaN of both signs, infinities,
the padding of a ragged last tile); the CPU tests and the card's checks
share it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import pq as pq_lib
from repro_torch.core import topk as topk_lib
from repro_torch.core.scoring import score_pqtopk

NEG_INF = float("-inf")


def pq_scores(codes: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """r[q, i] = sum_k s[q, k, codes[i, k]].  codes (N,m), s (B,m,b) ->
    (B,N) f32, reduced in ``tree_sum`` order."""
    return score_pqtopk(codes, s)


def pq_topk(codes: torch.Tensor, s: torch.Tensor, k: int):
    """Exact global top-k of :func:`pq_scores` -> (vals (B,k), ids (B,k))."""
    return topk_lib.topk(pq_scores(codes, s), k)


def pq_topk_slots(codes: torch.Tensor, s: torch.Tensor, k: int,
                  tile_idx: torch.Tensor, *, n_items: int, tile: int,
                  batch_tile: int = 0, live: Optional[torch.Tensor] = None):
    """What the fused kernel writes: for each slot ``i`` the exact top-``k``
    of codes tile ``tile_idx[i]`` per query, with global ids and ids
    ``>= n_items`` masked to ``-inf`` first; ties to the lowest id.  A
    ``-1`` slot emits ``(-inf, n_items)``.  -> (B, n_slots, k) f32 + i32.

    ``live`` (N,) bool or uint8 is the tombstone mask: a dead row scores
    ``-inf`` inside its tile's top-k, before the per-slot selection (masking
    the winners afterwards would let a dead item crowd a live one out).

    A 2D ``(n_bt, n_slots)`` table with ``batch_tile`` gives row ``j`` to
    queries ``j*batch_tile .. (j+1)*batch_tile - 1``.  Tiles may run past
    the codes' rows (a ragged last tile, or a whole tile past the
    catalogue): those rows score as padding and are masked.
    """
    if tile_idx.dim() == 2:
        bq = s.shape[0]
        n_bt = -(-bq // batch_tile) if batch_tile > 0 else 0
        if batch_tile < 1 or tile_idx.shape[0] < n_bt:
            raise ValueError(
                f"2D tile_idx has {tile_idx.shape[0]} rows; batch_tile="
                f"{batch_tile} needs {n_bt} to cover {bq} queries")
        rows = [pq_topk_slots(codes, s[j * batch_tile:(j + 1) * batch_tile],
                              k, tile_idx[j], n_items=n_items, tile=tile,
                              live=live)
                for j in range(n_bt)]
        return (torch.cat([v for v, _ in rows]),
                torch.cat([i for _, i in rows]))
    n = codes.shape[0]
    bq = s.shape[0]
    n_slots = tile_idx.shape[0]
    dev = s.device
    tid = tile_idx.to(device=dev, dtype=torch.int64)
    gid = (tid.clamp(min=0)[:, None] * tile
           + torch.arange(tile, device=dev)[None, :])          # (slots, tile)
    safe = gid.clamp(max=n - 1)
    rows = pq_lib.take_rows(codes, safe.reshape(-1))
    sc = pq_scores(rows, s).reshape(bq, n_slots, tile)
    ok = (gid < n_items) & (gid < n)
    if live is not None:
        ok &= live.to(dev)[safe] != 0
    sc = torch.where(ok, sc, NEG_INF)
    v, pos = topk_lib.topk(sc, k)                               # (B, S, k)
    ids = torch.gather(gid.expand(bq, n_slots, tile), 2,
                       pos.long()).to(torch.int32)
    dead = (tid < 0)[None, :, None]
    v = torch.where(dead, NEG_INF, v)
    ids = torch.where(dead, n_items, ids)
    return v, ids


def plant_specials(codes: np.ndarray, s: np.ndarray, tile: int,
                   seed: int = 0):
    """Codes (N, m) and S (B, m, b >= 6) rewritten so that scores reach
    every edge of ``lax.top_k``'s order: ordinary items score below -m
    (S < -1), and of the rest

    * code 0 in every split scores -0.0, codes of only 0 and 1 with a 1
      score +0.0 (S = -0.0 and +0.0 there; a sum of -0 parts is -0);
    * split 0's codes 2, 3, 4 and 5 are +inf, +NaN, -NaN and -inf, and
      split 1's code 5 is +inf, so codes (5, 5, ..) score -inf + inf = NaN
      (a NaN's sign after an add is the hardware's: x86 keeps the
      operand's and gives -NaN for inf - inf, the card gives +NaN);
    * the last tile (ragged when N is not a multiple of ``tile``) holds
      mostly -NaN items, three -inf and two ordinary ones, so its top-k
      passes the ``-inf`` padding, which ranks between them.

    Returns new (codes, S) arrays of the same dtypes."""
    rng = np.random.default_rng(seed)
    n, m = codes.shape
    b = s.shape[2]
    s = -(np.abs(s) + 1.0).astype(np.float32)
    s[:, :, 0], s[:, :, 1] = -0.0, 0.0
    s[:, 0, 2:6] = [np.inf, np.nan, -np.nan, -np.inf]
    if m > 1:
        s[:, 1, 5] = np.inf
    out = rng.integers(6, b, (n, m))
    kind = rng.choice(8, n, p=[0.86, 0.03, 0.03, 0.02, 0.02, 0.01, 0.02,
                               0.01])
    out[kind == 1] = 0                                    # -0.0
    pos = np.flatnonzero(kind == 2)                       # +0.0
    out[pos] = rng.integers(0, 2, (pos.size, m))
    out[pos, rng.integers(0, m, pos.size)] = 1
    for kd, code in ((3, 2), (4, 3), (5, 4), (6, 5)):     # inf, NaN, -NaN,
        out[kind == kd, 0] = code                         # -inf
    if m > 1:
        out[kind == 7, :2] = 5                            # -inf + inf
    last = (n - 1) // tile * tile
    out[last:, 0] = 4
    out[last:last + 3, 0] = 5
    out[last + 3:last + 5, 0] = 6
    return out.astype(codes.dtype), s
