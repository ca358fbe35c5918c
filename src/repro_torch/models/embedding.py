"""Sparse-feature embedding substrate for the recsys archs.

Per-field tables, single-valued lookup by plain indexing, bag (multi-hot)
lookup as gather + masked weighted reduce, and the ragged (flat values +
segment ids) form on ``index_add_``.  ``lookup_bag(use_kernel=True)`` is
the route through the embedding-bag kernel (:mod:`..kernels.embedding_bag`:
CUDA on the card, its plain version on the CPU); as in the reference, no
model calls it: the recsys models embed their single-valued fields with
:func:`lookup_fields`.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from repro_torch.kernels.embedding_bag import ops as bag_ops, ref as bag_ref

Params = Dict[str, Any]


def init_tables(generator: torch.Generator, rows: Sequence[int],
                dim: int) -> Params:
    """N(0, 0.02^2) tables, one per field, drawn on the CPU from
    ``generator``."""
    return {"tables": [torch.randn((r, dim), generator=generator).mul_(0.02)
                       for r in rows]}


def lookup_fields(params: Params, ids: torch.Tensor) -> torch.Tensor:
    """Single-valued categorical fields.  ids: (B, n_fields) ->
    (B, n_fields, dim)."""
    return torch.stack([t[ids[:, i]] for i, t in enumerate(params["tables"])],
                       dim=1)


def lookup_bag(table: torch.Tensor, indices: torch.Tensor,
               weights: torch.Tensor | None = None, mode: str = "sum",
               use_kernel: bool = False) -> torch.Tensor:
    """EmbeddingBag over one table: indices (B, bag), -1 = padding."""
    if use_kernel:
        return bag_ops.embedding_bag(table, indices, weights, mode=mode)
    w = bag_ref.fold_weights(indices, weights).to(table.dtype)
    rows = table[indices.clamp(min=0)]
    acc = (rows * w[..., None]).sum(dim=1)
    if mode == "mean":
        acc = acc / w.sum(dim=1).clamp(min=1.0)[:, None]
    return acc


def segment_embedding_bag(table: torch.Tensor, flat_indices: torch.Tensor,
                          segment_ids: torch.Tensor, n_bags: int,
                          weights: torch.Tensor | None = None,
                          mode: str = "sum") -> torch.Tensor:
    """Ragged EmbeddingBag: CSR-style (values, segment ids) layout, the
    form of torch's ``EmbeddingBag(include_last_offset)`` inputs."""
    rows = table[flat_indices]
    if weights is not None:
        rows = rows * weights[:, None]
    seg = segment_ids.long()
    acc = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device).index_add_(0, seg, rows)
    if mode == "mean":
        cnt = torch.zeros((n_bags,), dtype=table.dtype,
                          device=table.device).index_add_(
            0, seg, torch.ones_like(rows[:, 0]))
        acc = acc / cnt.clamp(min=1.0)[:, None]
    return acc
