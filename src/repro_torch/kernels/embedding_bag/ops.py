"""Public wrapper around the embedding-bag kernel.

A table on the card goes to the CUDA kernel (or the call raises); a table
on the CPU goes to the kernel's plain version in :mod:`ref`; a meta table
(the dry run) gets a meta output of the kernel's shape and dtype.  Each
call is one launch that :func:`repro_torch.kernels.cost.launch` records
inside a recording block.  Both apply
the padding mask themselves, slot by slot, so nothing is folded here.  The
reference's TPU tiling knobs (``bags_per_step``, ``interpret`` and the
padding of ``n_bags`` to a multiple of 8) have no counterpart: the CUDA
grid takes any number of bags.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cost as _cost
from repro_torch.kernels.embedding_bag import kernel as _k, ref as _ref


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None, *,
                  mode: str = "sum") -> torch.Tensor:
    """table (V, d), indices (n_bags, bag) int (-1 = padding, the rest in
    [0, V)), weights (n_bags, bag) or None -> (n_bags, d) f32: the
    weighted sum of each bag's rows, or (``mode="mean"``) that sum over
    ``max(sum of weights, 1)``.  Modes other than "sum" and "mean" raise
    (the reference treats them as "sum")."""
    def body():
        if table.is_meta or indices.is_meta:
            if mode not in _ref.MODES:
                raise ValueError(f"mode {mode!r} not in {_ref.MODES}")
            return torch.empty((indices.shape[0], table.shape[1]),
                               dtype=torch.float32, device="meta")
        t = table.to(torch.float32)
        if t.is_cuda or indices.is_cuda:
            return _k.embedding_bag_cuda(
                t.contiguous(), indices.to(torch.int32).contiguous(),
                None if weights is None
                else weights.to(torch.float32).contiguous(), mode=mode)
        return _ref.bag_reduce(t, indices, weights, mode)

    return _cost.launch("embedding_bag", lambda: _cost.embedding_bag_work(
        *table.shape, *indices.shape, weights is not None), body,
        reads=(table, indices, weights))
