"""RetrievalHead: score a huge id space against a query vector, top-K.

Holds either a PQ representation ``{"codes": (N, m), "sub_emb": (m, b,
d/m)}`` or a dense table ``{"table": (N, d)}``, and serves the routes of
the reference's ``core/retrieval_head.py`` on one device: the paper's
three algorithms, the scores-only kernel, the fused score+top-k kernel,
the pruned cascade (``pqtopk_pruned``; a PQ head carries its metadata as
``"pruned"``, with a super level when ``PQConfig.super_factor > 1``) and
the approximate block-max route; :func:`top_items_pruned` is the host
two-pass cascade the pruned route is held against.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import PQConfig
from repro_torch.core import pq as pq_lib
from repro_torch.core import pruning, scoring, topk as topk_lib
from repro_torch.kernels.pqtopk import ops as kernel_ops

Params = Dict[str, Any]

TOP_ITEMS_METHODS = ("dense", "recjpq", "pqtopk", "pqtopk_onehot",
                     "pqtopk_kernel", "pqtopk_fused", "pqtopk_pruned",
                     "pqtopk_approx")

DEFAULT_PRUNE_TILE = pruning.DEFAULT_PRUNE_TILE


def init(generator: torch.Generator, n_items: int, d_model: int,
         pq: Optional[PQConfig] = None, codes=None, centroids=None,
         device="cpu") -> Params:
    """A dense table, or a PQ head with its pruning metadata (built once
    here, per ``pq.bound_backend`` and ``pq.super_factor``, so the cascade
    never rebuilds it)."""
    if pq is None:
        table = torch.randn((n_items, d_model), generator=generator) * 0.02
        return {"table": table.to(device)}
    params = pq_lib.init_pq_embedding(generator, pq, n_items, d_model, codes,
                                      centroids, device=device)
    params["pruned"] = pruning.build_pruned_state(
        params["codes"], pq.b, DEFAULT_PRUNE_TILE, backend=pq.bound_backend,
        super_factor=pq.super_factor)
    return params


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
              pq_cfg: Optional[PQConfig] = None, ladder=None,
              pin_rung: bool = False, return_rung: bool = False):
    """TopK(score, K) -> (values (B,k), item ids (B,k) int32).

    ``pqtopk_fused`` runs the fused CUDA kernel on the card: scores stay in
    shared memory and only (B, n_tiles, k) candidates reach device memory.

    ``pqtopk_pruned`` runs the pruned cascade: ``pq_cfg`` supplies the
    seeding and grouping knobs, ``ladder`` the slot budgets, ``pin_rung``
    the cheapest-rung degraded mode, and ``return_rung=True`` appends the
    rung taken (an int) to the outputs.
    """
    if params.get("live") is not None and method != "pqtopk_pruned":
        raise ValueError(
            f"params carry a tombstone mask ('live') but method {method!r} "
            f"would ignore it and could return delisted items; mutable "
            f"catalogues serve via 'pqtopk_pruned'")
    if pin_rung and method != "pqtopk_pruned":
        raise ValueError("pin_rung (the load-degraded cascade) is only "
                         "meaningful for method='pqtopk_pruned'")
    if method in ("pqtopk_fused", "pqtopk_pruned", "pqtopk_approx") \
            and not is_pq(params):
        raise ValueError(f"method {method!r} requires a PQ head")
    if method == "pqtopk_fused":
        return kernel_ops.pq_topk(params["codes"], _subid_scores(params, phi),
                                  k)
    if method == "pqtopk_pruned":
        return _top_items_pruned_ingraph(params, phi, k, pq_cfg=pq_cfg,
                                         ladder=ladder, pin_rung=pin_rung,
                                         return_rung=return_rung)
    if method == "pqtopk_approx":
        return topk_lib.approx_topk_maxblock(
            score_all(params, phi, "pqtopk"), k)
    return topk_lib.tiled_topk(score_all(params, phi, method), k, tile)


def _seed_kwargs(pq_cfg: Optional[PQConfig]) -> Dict[str, Any]:
    """theta-seeding knobs for the cascade, from PQConfig."""
    if pq_cfg is None:
        return {}
    return {"seed_policy": pq_cfg.seed_policy,
            "seed_tiles": pq_cfg.seed_tiles,
            "seed_max_tiles": pq_cfg.seed_max_tiles,
            "seed_stab_tol": pq_cfg.seed_stab_tol}


def _grouping_kwargs(pq_cfg: Optional[PQConfig]) -> Dict[str, Any]:
    """Per-query grouping knobs for the cascade, from PQConfig."""
    if pq_cfg is None:
        return {}
    return {"query_grouping": pq_cfg.query_grouping,
            "n_groups": pq_cfg.n_groups}


def _pruned_state(params: Params) -> Optional[pruning.PrunedHeadState]:
    st = params.get("pruned")
    return st if isinstance(st, pruning.PrunedHeadState) else None


def _top_items_pruned_ingraph(params: Params, phi: torch.Tensor, k: int, *,
                              pq_cfg: Optional[PQConfig] = None,
                              ladder=None, pin_rung: bool = False,
                              return_rung: bool = False):
    """The pruned route: ``pruning.cascade_topk_ingraph`` on the head's
    ``"pruned"`` state (rebuilt from the codes, with the config's bound
    backend, when the head has none or a sharded one)."""
    codes, sub_emb = params["codes"], params["sub_emb"]
    s = _subid_scores(params, phi)
    state = _pruned_state(params)
    if state is not None and state.shards != 1:
        state = None
    if state is None:
        state = pruning.build_pruned_state(
            codes, int(sub_emb.shape[1]), DEFAULT_PRUNE_TILE,
            backend=pq_cfg.bound_backend if pq_cfg is not None
            else "bitmask",
            super_factor=pq_cfg.super_factor if pq_cfg is not None else 0)
    out = pruning.cascade_topk_ingraph(
        codes, s, k, state, tile=DEFAULT_PRUNE_TILE, ladder=ladder,
        pin_rung=pin_rung, live=params.get("live"),
        return_stats=return_rung, **_seed_kwargs(pq_cfg),
        **_grouping_kwargs(pq_cfg))
    if return_rung:
        vals, ids, stats = out
        return vals, ids, stats["rung_hit"]
    return out


def top_items_pruned(params: Params, phi: torch.Tensor, k: int, *,
                     tile: int = DEFAULT_PRUNE_TILE,
                     seed_tiles: int = pruning.DEFAULT_SEED_TILES,
                     return_stats: bool = False):
    """The host two-pass cascade (``pruning.cascade_topk``): dense presence
    metadata cached per codes tensor, a greedy seed, the survivors read to
    the host, then the fused kernel over their tiles.  Exact, ties
    included; serving uses ``method="pqtopk_pruned"`` instead.  ->
    (values (B,k), ids (B,k)[, stats])."""
    if not is_pq(params):
        raise ValueError("top_items_pruned requires a PQ head")
    return pruning.cascade_topk(params["codes"], _subid_scores(params, phi),
                                k, tile=tile, seed_tiles=seed_tiles,
                                return_stats=return_stats)
