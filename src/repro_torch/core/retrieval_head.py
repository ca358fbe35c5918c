"""RetrievalHead: score a huge id space against a query vector, top-K.

Holds either a PQ representation ``{"codes": (N, m), "sub_emb": (m, b,
d/m)}`` or a dense table ``{"table": (N, d)}``, and serves the flat
routes of the reference's ``core/retrieval_head.py``: the paper's three
algorithms, the scores-only kernel, the fused score+top-k kernel and the
approximate block-max route.  The pruned cascade is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import PQConfig
from repro_torch.core import pq as pq_lib
from repro_torch.core import scoring, topk as topk_lib
from repro_torch.kernels.pqtopk import ops as kernel_ops

Params = Dict[str, Any]

TOP_ITEMS_METHODS = ("dense", "recjpq", "pqtopk", "pqtopk_onehot",
                     "pqtopk_kernel", "pqtopk_fused", "pqtopk_pruned",
                     "pqtopk_approx")


def init(generator: torch.Generator, n_items: int, d_model: int,
         pq: Optional[PQConfig] = None, codes=None, centroids=None,
         device="cpu") -> Params:
    if pq is None:
        table = torch.randn((n_items, d_model), generator=generator) * 0.02
        return {"table": table.to(device)}
    return pq_lib.init_pq_embedding(generator, pq, n_items, d_model, codes,
                                    centroids, device=device)


def is_pq(params: Params) -> bool:
    return "codes" in params


def n_items(params: Params) -> int:
    return (params["codes"] if is_pq(params) else params["table"]).shape[0]


def embed(params: Params, ids: torch.Tensor) -> torch.Tensor:
    """Input-embedding lookup (shared with the head, as in RecJPQ)."""
    if is_pq(params):
        return pq_lib.reconstruct(params, ids)
    return params["table"][ids]


def _subid_scores(params: Params, phi: torch.Tensor) -> torch.Tensor:
    return scoring.subid_scores(params["sub_emb"].float(), phi.float())


def score_all(params: Params, phi: torch.Tensor, method: str = "pqtopk",
              ) -> torch.Tensor:
    """All item scores (B, N) via the selected algorithm."""
    if method == "dense":
        w = (pq_lib.reconstruct_all(params) if is_pq(params)
             else params["table"])
        return scoring.score_dense(w.to(phi.dtype), phi)
    if not is_pq(params):
        raise ValueError(f"method {method!r} requires a PQ head")
    s = _subid_scores(params, phi)
    if method == "recjpq":
        return scoring.score_recjpq(params["codes"], s)
    if method == "pqtopk":
        return scoring.score_pqtopk(params["codes"], s)
    if method == "pqtopk_onehot":
        return scoring.score_pqtopk_onehot(params["codes"], s)
    if method == "pqtopk_kernel":
        return kernel_ops.pq_scores(params["codes"], s)
    raise ValueError(f"unknown scoring method {method!r}")


def score_candidates(params: Params, phi: torch.Tensor,
                     item_ids: torch.Tensor,
                     method: str = "pqtopk") -> torch.Tensor:
    """Scores for a candidate subset V (Algorithm 1's optional V)."""
    if method == "dense":
        return scoring.score_dense(embed(params, item_ids).to(phi.dtype), phi)
    s = _subid_scores(params, phi)
    rows = pq_lib.take_rows(params["codes"], item_ids).contiguous()
    if method in ("pqtopk_kernel", "pqtopk_fused"):
        return kernel_ops.pq_scores(rows, s)
    return scoring.score_pqtopk(rows, s)


def top_items(params: Params, phi: torch.Tensor, k: int,
              method: str = "pqtopk", tile: int = 8192,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TopK(score, K) -> (values (B,k), item ids (B,k) int32).

    ``pqtopk_fused`` runs the fused CUDA kernel on the card: scores stay in
    shared memory and only (B, n_tiles, k) candidates reach device memory.
    """
    if method == "pqtopk_pruned":
        raise NotImplementedError(
            "method 'pqtopk_pruned' (the pruned cascade) is port slice 2 "
            "and not ported yet")
    if method in ("pqtopk_fused", "pqtopk_approx") and not is_pq(params):
        raise ValueError(f"method {method!r} requires a PQ head")
    if method == "pqtopk_fused":
        return kernel_ops.pq_topk(params["codes"], _subid_scores(params, phi),
                                  k)
    if method == "pqtopk_approx":
        return topk_lib.approx_topk_maxblock(
            score_all(params, phi, "pqtopk"), k)
    return topk_lib.tiled_topk(score_all(params, phi, method), k, tile)
