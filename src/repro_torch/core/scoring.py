"""Scoring algorithms — the port of the reference's ``core/scoring.py``.

Given sequence embeddings ``phi (B, d)`` and an item space described
either densely (``W (N, d)``) or by PQ codes (``codes (N, m)`` +
sub-embeddings ``Psi (m, b, d/m)``), compute all item scores ``r (B, N)``.

Each function keeps its reference's own float32 add order, so the PQ
routes agree with the reference bit for bit:

* ``tree_sum``            — pairs, odd tail appended (the PQTopK order);
* ``score_recjpq``        — sequential accumulation from zeros (Alg. 2);
* ``score_pqtopk_onehot`` — sequential accumulation, no zero start.
"""
from __future__ import annotations

import torch

from repro_torch.core import pq as pq_lib


def tree_sum(parts):
    """Balanced-tree reduction of a list of tensors: THE accumulation order
    for per-split partial scores (Algorithm 1, the plain kernel versions
    and the CUDA kernels all reduce in this order)."""
    parts = list(parts)
    while len(parts) > 1:
        nxt = [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def score_dense(w: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Default matmul scoring r = W phi. w: (N, d), phi: (B, d) -> (B, N)."""
    return torch.einsum("bd,nd->bn", phi.float(), w.float())


def subid_scores(sub_emb: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Eq. 4. sub_emb: (m, b, d/m), phi: (B, d) -> S: (B, m, b)."""
    bq, d = phi.shape
    m, _, sub = sub_emb.shape
    if d != m * sub:
        raise ValueError(f"phi dim {d} != m*sub {m * sub}")
    return torch.einsum("bms,mjs->bmj", phi.float().reshape(bq, m, sub),
                        sub_emb.float())


def _split_gathers(codes: torch.Tensor, s: torch.Tensor):
    """The m per-split gathers S[:, k, codes[:, k]] -> m x (B, N) f32."""
    idx = pq_lib.widen(codes)
    s = s.float()
    return [s[:, k, :].index_select(1, idx[:, k]) for k in range(idx.shape[1])]


def score_pqtopk(codes: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Algorithm 1 (PQTopK): r_i = sum_k S[k, G[i,k]], parallel over items,
    reduced in ``tree_sum`` order.  codes (N, m), s (B, m, b) -> (B, N)."""
    return tree_sum(_split_gathers(codes, s))


def score_recjpq(codes: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Algorithm 2 (RecJPQ original): a (B, N) accumulator carried over the
    splits, starting from zeros."""
    acc = torch.zeros((s.shape[0], codes.shape[0]), dtype=torch.float32,
                      device=s.device)
    for part in _split_gathers(codes, s):
        acc = acc + part
    return acc


def score_pqtopk_onehot(codes: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Matmul restatement of Algorithm 1: sum_k onehot(G_k) @ S_k^T, the
    first split's product starting the sum.  Materialises one (N, b)
    one-hot per split."""
    idx = pq_lib.widen(codes)
    b = s.shape[-1]
    iota = torch.arange(b, device=idx.device)[None, :]
    acc = None
    for k in range(idx.shape[1]):
        onehot = (idx[:, k:k + 1] == iota).float()               # (N, b)
        part = torch.einsum("nb,qb->qn", onehot, s[:, k, :].float())
        acc = part if acc is None else acc + part
    return acc


def score_items_pqtopk(codes: torch.Tensor, s: torch.Tensor,
                       item_ids: torch.Tensor) -> torch.Tensor:
    """PQTopK over a candidate subset V of the items."""
    return score_pqtopk(pq_lib.take_rows(codes, item_ids), s)
