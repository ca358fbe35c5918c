"""Plain PyTorch version of the embedding-bag kernel: gather + masked
weighted reduce.

:func:`bag_reduce` takes the CUDA kernel's steps (slot by slot: the
padding mask folded into the slot's weight, or the mask alone for an
unweighted bag, then a product and an add, the weight sum in the same
order), so the two agree bit for bit on the card; :func:`embedding_bag` is
the reference's ``ref.py`` signature.  :func:`fold_weights` folds the mask
into a whole weight array at once, for the substrate's gather route and
the library call the smoke run times.
"""
from __future__ import annotations

import torch

MODES = ("sum", "mean")

# The shapes the kernel is held to, (v, d, n_bags, bag, mode, weighted):
# the reference's grid (tests/test_kernels.py), then the recsys configs'
# row widths 10 and 18 (40- and 72-byte rows, not 16-byte aligned) and bag
# counts that are not a multiple of 8; then the kernel's lane layouts:
# d = 16 and 10 (two and three bags a warp), 18 and 32 (a warp a bag), 128
# (4-float loads), 200 (two column passes) and 3 (lanes past d idle), with
# bags longer than a group's lanes (indices read in several chunks).
GRID = [
    (512, 16, 32, 4, "sum", False),
    (1000, 32, 17, 6, "mean", True),
    (64, 8, 8, 3, "sum", True),
    (2048, 64, 64, 8, "mean", False),
    (128, 128, 9, 1, "sum", False),
    (300, 10, 13, 5, "mean", True),
    (300, 18, 11, 7, "sum", True),
    (3000, 10, 201, 20, "mean", False),
    (5000, 16, 8, 8, "sum", True),
    (500, 10, 7, 13, "mean", False),
    (400, 18, 5, 34, "sum", True),
    (4000, 32, 8, 33, "mean", True),
    (300, 128, 3, 12, "sum", False),
    (64, 200, 3, 9, "mean", True),
    (50, 3, 9, 6, "sum", False),
]

# Shapes that reach the CUDA kernel's other layouts, held on the card only:
# batches past one wave of warps (8,192 bags on an H100 SXM), which take
# 4-float loads where d % 4 == 0; and rows of more than 32 vectors, which
# take several passes over each bag (d = 50 and 150 with 1-float loads,
# 300 and 600 with 4-float).
LAYOUT_GRID = [
    (5000, 32, 9000, 5, "mean", False),
    (3000, 16, 8200, 3, "sum", True),
    (2000, 8, 9001, 4, "sum", True),
    (1000, 10, 8300, 6, "mean", True),
    (500, 18, 8193, 3, "sum", False),
    (300, 128, 8500, 2, "mean", True),
    (100, 50, 7, 5, "sum", True),
    (100, 150, 5, 4, "mean", False),
    (100, 300, 6, 3, "sum", True),
    (60, 600, 3, 5, "mean", True),
]

# Shapes held with NaN and inf in row 0 of the table (plant_row0): every
# padded slot reads row 0 and multiplies it by 0, which gives NaN.
ROW0_GRID = [
    (300, 16, 6, 34, "sum", True),
    (200, 32, 5, 12, "mean", False),
    (100, 128, 3, 10, "sum", True),
]


def plant_row0(table):
    """Row 0 of ``table`` (numpy or torch, in place) set to NaN, +inf and
    -inf in turn; returns it."""
    for c in range(table.shape[1]):
        table[0, c] = (float("nan"), float("inf"), float("-inf"))[c % 3]
    return table


def fold_weights(indices: torch.Tensor,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """indices (n_bags, bag) (-1 = padding), weights (n_bags, bag) or None
    -> f32 weights that are 0 on every padded slot."""
    mask = (indices >= 0).to(torch.float32)
    return mask if weights is None else weights.to(torch.float32) * mask


def bag_reduce(table: torch.Tensor, indices: torch.Tensor,
               weights: torch.Tensor | None = None,
               mode: str = "sum") -> torch.Tensor:
    """table (V, d), indices (n_bags, bag) (-1 = padding, read as row 0),
    weights (n_bags, bag) or None -> (n_bags, d).  Slot j's weight is
    ``weights[:, j] * mask[:, j]`` (the mask alone when unweighted);
    ``mean`` divides by ``max(sum_j w_j, 1)``."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    n_bags, bag = indices.shape
    acc = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    den = torch.zeros((n_bags,), dtype=table.dtype, device=table.device)
    rows = indices.clamp(min=0)
    mask = (indices >= 0).to(torch.float32)
    for j in range(bag):
        w = mask[:, j] if weights is None \
            else weights[:, j].to(torch.float32) * mask[:, j]
        acc = acc + w[:, None] * table[rows[:, j]]
        den = den + w
    if mode == "mean":
        acc = acc / den.clamp(min=1.0)[:, None]
    return acc


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """table (V, d), indices (n_bags, bag) int (-1 = padding), weights
    (n_bags, bag) or None -> (n_bags, d) f32."""
    return bag_reduce(table.to(torch.float32), indices, weights, mode)
