"""Plain PyTorch version of the embedding-bag kernel: gather + masked
weighted reduce.

:func:`fold_weights` folds the padding mask into the weights, the one
place that step is written.  :func:`bag_reduce` takes the CUDA kernel's
steps (slot by slot, a product then an add, the weight sum in the same
order), so the two agree bit for bit on the card; :func:`embedding_bag`
is the reference's ``ref.py`` signature: fold, then reduce.
"""
from __future__ import annotations

import torch

MODES = ("sum", "mean")

# The shapes the kernel is held to, (v, d, n_bags, bag, mode, weighted):
# the reference's grid (tests/test_kernels.py), then the recsys configs'
# row widths 10 and 18 (40- and 72-byte rows, not 16-byte aligned) and bag
# counts that are not a multiple of 8.
GRID = [
    (512, 16, 32, 4, "sum", False),
    (1000, 32, 17, 6, "mean", True),
    (64, 8, 8, 3, "sum", True),
    (2048, 64, 64, 8, "mean", False),
    (128, 128, 9, 1, "sum", False),
    (300, 10, 13, 5, "mean", True),
    (300, 18, 11, 7, "sum", True),
    (3000, 10, 201, 20, "mean", False),
]


def fold_weights(indices: torch.Tensor,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """indices (n_bags, bag) (-1 = padding), weights (n_bags, bag) or None
    -> f32 weights that are 0 on every padded slot."""
    mask = (indices >= 0).to(torch.float32)
    return mask if weights is None else weights.to(torch.float32) * mask


def bag_reduce(table: torch.Tensor, indices: torch.Tensor, w: torch.Tensor,
               mode: str = "sum") -> torch.Tensor:
    """table (V, d), indices (n_bags, bag) (-1 = padding, read as row 0),
    w (n_bags, bag) with the padding mask folded in -> (n_bags, d).
    ``mean`` divides by ``max(sum_j w_j, 1)``."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    n_bags, bag = indices.shape
    acc = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    den = torch.zeros((n_bags,), dtype=table.dtype, device=table.device)
    rows = indices.clamp(min=0)
    for j in range(bag):
        acc = acc + w[:, j, None] * table[rows[:, j]]
        den = den + w[:, j]
    if mode == "mean":
        acc = acc / den.clamp(min=1.0)[:, None]
    return acc


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """table (V, d), indices (n_bags, bag) int (-1 = padding), weights
    (n_bags, bag) or None -> (n_bags, d) f32."""
    return bag_reduce(table.to(torch.float32), indices,
                      fold_weights(indices, weights), mode)
