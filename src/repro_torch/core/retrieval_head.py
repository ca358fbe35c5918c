"""RetrievalHead: score a huge id space against a query vector, top-K.

Holds either a PQ representation ``{"codes": (N, m), "sub_emb": (m, b,
d/m)}`` or a dense table ``{"table": (N, d)}``, and serves the routes of
the reference's ``core/retrieval_head.py`` on one device: the paper's
three algorithms, the scores-only kernel, the fused score+top-k kernel,
the pruned cascade (``pqtopk_pruned``; a PQ head carries its metadata as
``"pruned"``, with a super level when ``PQConfig.super_factor > 1``) and
the approximate block-max route; :func:`top_items_pruned` is the host
two-pass cascade the pruned route is held against.

The item-sharded routes (:func:`top_items_sharded`,
:func:`top_items_pruned_sharded`) split the catalogue over a shard mesh
(``launch/mesh.py``): each shard scores its own ``n_local`` rows on its
device and contributes its top-k to an O(k * shards) merge on the lead
device (``distributed/sharding.py``).  The reference runs them as one
``shard_map``; here the shard bodies run one after another from the
calling thread, on each device's current stream, the shard-local
``lax.cond``\\ s are host branches, and every cross-shard step (the theta
``pmax``, the merge, the stats reductions) runs outside the bodies, in
request order.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import PQConfig
from repro_torch.core import pq as pq_lib
from repro_torch.core import pruning, scoring, topk as topk_lib
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import on_device
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
        table = torch.randn((n_items, d_model), generator=generator,
                            device=generator.device) * 0.02
        return {"table": table.to(device)}
    params = pq_lib.init_pq_embedding(generator, pq, n_items, d_model, codes,
                                      centroids, device=device)
    params["pruned"] = pruning.build_pruned_state(
        params["codes"], pq.b, DEFAULT_PRUNE_TILE, backend=pq.bound_backend,
        super_factor=pq.super_factor)
    return params


def abstract(n_items: int, d_model: int, pq: Optional[PQConfig] = None,
             dtype: torch.dtype = torch.float32) -> Params:
    """:func:`init`'s tree on meta (no storage), its table or
    sub-embeddings in ``dtype``."""
    from repro_torch.training import tree as tree_lib

    def build(generator):
        p = init(generator, n_items, d_model, pq)
        key = "table" if pq is None else "sub_emb"
        return {**p, key: p[key].to(dtype)}
    return tree_lib.eval_shape(build, torch.Generator())


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


# ---------------------------------------------------------------------------
# item-sharded routes: items over the mesh axis, O(k * shards) merge
# ---------------------------------------------------------------------------


def _shard_layout(n: int, mesh, axis: str):
    """-> (shards, pad, n_local, each shard's first global id)."""
    n_shards = mesh.shape[axis]
    pad = (-n) % n_shards
    n_local = (n + pad) // n_shards
    return n_shards, pad, n_local, [i * n_local for i in range(n_shards)]


def ensure_sharded_pruned_state(params: Params, mesh, axis: str = "model",
                                *, k_hint: int = 64,
                                tile: int = DEFAULT_PRUNE_TILE,
                                backend: Optional[str] = None,
                                super_factor: Optional[int] = None
                                ) -> Params:
    """``params`` with a pruned state whose tiles are aligned to ``mesh``'s
    ``axis`` (no tile or super straddles a shard).  A no-op when the
    threaded state already has that layout, a tile that holds the
    per-shard top-(``k_hint`` + pad), the same backend and the same super
    factor; otherwise built once (engine build time).  ``backend=None``
    and ``super_factor=None`` keep the threaded state's."""
    if not is_pq(params):
        return params
    codes = params["codes"]
    n_shards, pad, n_local, _ = _shard_layout(codes.shape[0], mesh, axis)
    k_local = min(k_hint + pad, n_local)
    st = _pruned_state(params)
    if backend is None:
        backend = st.backend if st is not None else "bitmask"
    if super_factor is None:
        super_factor = st.super_factor if st is not None else 0
    super_factor = 0 if super_factor <= 1 else int(super_factor)
    if (st is not None and st.shards == n_shards and st.tile >= k_local
            and st.backend == backend and st.super_factor == super_factor):
        return params
    new = pruning.build_pruned_state(
        codes, int(params["sub_emb"].shape[1]),
        min(max(tile, k_local), n_local), shards=n_shards, backend=backend,
        super_factor=super_factor)
    return {**params, "pruned": new}


def _finish_shard(lv, li, offset: int, n: int, k: int, live: bool):
    """A shard's winners -> its best k with global ids: ids past the
    catalogue (shard padding) masked to ``-inf``; with a tombstone mask
    every ``-inf`` candidate re-pointed at the global sentinel ``n``."""
    gid = li.to(torch.int32) + offset
    lv = torch.where(gid < n, lv, float("-inf"))
    if live:
        gid = torch.where(lv == float("-inf"), n, gid)
    if lv.shape[1] > k:
        lv, sel = topk_lib.topk(lv, k)
        gid = torch.gather(gid, 1, sel.long())
    return lv, gid


def top_items_pruned_sharded(params: Params, phi: torch.Tensor, k: int,
                             mesh, axis: str = "model", *,
                             tile: int = DEFAULT_PRUNE_TILE,
                             seed_tiles: Optional[int] = None,
                             pq_cfg: Optional[PQConfig] = None,
                             ladder=None, super_ladder=None,
                             return_stats: bool = False):
    """The item-sharded cascade -> (vals (B,k), ids (B,k)[, stats]) on the
    mesh's lead device, bit-identical to the flat exhaustive route.

    Each shard bounds its own tiles, seeds a local theta from its own most
    promising tiles (the shards' seed stages in lockstep), and shares
    ``theta = pmax(theta_local)`` (each local theta certifies >= k items,
    so the max is still certified).  Then each shard compacts its
    survivors, takes the first rung of its own ladder that holds its count
    (rungs against ``tiles_per_shard``), scores them with the fused kernel
    at ``k + pad`` (so shard-padding winners can be masked), and
    contributes its best k to :func:`topk.merge_local_topk`.  The shards'
    counts are read to the host together, once per stage.

    ``pq_cfg.query_grouping``: per-query thetas, ``pmax``'d per query, and
    each shard groups queries by its own survivor sets and un-permutes its
    winners before the merge.  A state with a super level: theta is seeded
    from the super bounds; a shard none of whose supers survive skips its
    child bounds and its kernel and contributes ``-inf`` candidates with
    the sentinel id N (the shard-skip); otherwise its tail runs as the
    flat hierarchical cascade's, on its own super and child rungs (two
    host reads per batch for all shards).

    Uses the shard-aligned state in ``params`` when it fits
    (:func:`ensure_sharded_pruned_state`), else builds one per call.  A
    ``"live"`` tombstone mask is split with the codes (padding rows dead).
    ``stats`` has exactly ``pruning.STATS_KEYS``, reduced over the shards
    as the reference's psum / pmax do; ``slot_overflow`` is per shard (a
    shard on its exhaustive rung)."""
    if not is_pq(params):
        raise ValueError("top_items_pruned_sharded requires a PQ head")
    codes, sub_emb = params["codes"], params["sub_emb"]
    live = params.get("live")
    n = codes.shape[0]
    n_shards, pad, n_local, offsets = _shard_layout(n, mesh, axis)
    # The local pass oversamples the top-(k + pad) so shard-padding rows
    # can be masked out afterwards; the tile must hold that many winners.
    k_local = min(k + pad, n_local)
    state = _pruned_state(params)
    want_backend = (state.backend if state is not None else
                    (pq_cfg.bound_backend if pq_cfg is not None
                     else "bitmask"))
    want_super = (state.super_factor if state is not None else
                  (pq_cfg.super_factor if pq_cfg is not None else 0))
    if (state is None or state.shards != n_shards or state.tile < k_local
            or state.backend != want_backend):
        state = pruning.build_pruned_state(
            codes, int(sub_emb.shape[1]), min(max(tile, k_local), n_local),
            shards=n_shards, backend=want_backend, super_factor=want_super)
    hier, tile, t_local = state.has_super, state.tile, state.tiles_per_shard
    seed_kw = _seed_kwargs(pq_cfg)
    if seed_tiles is not None:
        seed_kw["seed_tiles"] = seed_tiles
        seed_kw["seed_max_tiles"] = max(
            seed_tiles, seed_kw.get("seed_max_tiles",
                                    pruning.DEFAULT_SEED_MAX_TILES))
    stab_tol = seed_kw.pop("seed_stab_tol", pruning.DEFAULT_SEED_STAB_TOL)
    rungs = pruning.normalize_ladder(ladder, t_local, k_local, tile)
    grp = _grouping_kwargs(pq_cfg)
    grouped = grp.get("query_grouping", False) and grp.get("n_groups", 1) > 1
    if hier and grouped:
        raise ValueError(
            "query_grouping and hierarchical super-tiles are mutually "
            "exclusive on the sharded route too; strip the super level "
            "or disable grouping")
    n_groups = grp.get("n_groups", pruning.DEFAULT_N_GROUPS)
    bq = phi.shape[0]
    bt = (kernel_ops.group_batch_tile(bq, n_groups) if grouped
          else kernel_ops.effective_batch_tile(bq))
    b_pad = -(-bq // bt) * bt
    devs = mesh.axis_devices(axis)
    shards = range(n_shards)
    codes_sh = sharding.shard_rows(codes, mesh, axis)
    live_sh = (sharding.shard_rows(live, mesh, axis) if live is not None
               else [None] * n_shards)
    child_sh = list(zip(*(sharding.shard_rows(a, mesh, axis)
                          for a in state.meta_arrays())))
    s_sh = sharding.replicate(_subid_scores(params, phi), mesh, axis)
    if hier:
        factor, s_per_shard = state.super_factor, state.supers_per_shard
        seed_sh = list(zip(*(sharding.shard_rows(a, mesh, axis)
                             for a in state.super_meta_arrays())))
    else:
        factor, seed_sh = 1, child_sh

    # ---- bounds and the seed (lockstep), then the shared theta ----------
    bounds, plans = [], []
    for i in shards:
        with on_device(devs[i], (axis, i)):
            bounds.append(pruning.bounds_from_parts(state.backend,
                                                    seed_sh[i], s_sh[i]))
            plans.append(pruning.seed_plan(
                codes_sh[i], s_sh[i], bounds[i], k, tile=factor * tile,
                perquery=grouped, n_items=n, id_offset=offsets[i],
                degenerate=pruning.degenerate_from_parts(
                    state.backend, seed_sh[i], state.b),
                live=live_sh[i], **seed_kw))
    thetas, n_seed_used, _ = pruning.run_seed_plans(plans, k, stab_tol)
    theta_sh = sharding.replicate(sharding.pmax(thetas, mesh), mesh, axis)

    # ---- each shard's survivors; their counts read together -------------
    out, loc = [None] * n_shards, [None] * n_shards
    if hier:
        sup = []
        for i in shards:
            with on_device(devs[i], (axis, i)):
                sup.append(pruning.compact_mask(pruning.survival_mask(
                    bounds[i], theta_sh[i])))
        sup_counts = sharding.host_values(
            [c for _, c in sup], mesh,
            "retrieval_head.top_items_pruned_sharded: super survivor "
            "counts", s_per_shard)
        sup_rungs = pruning.normalize_ladder(
            pruning.default_super_ladder(s_per_shard)
            if super_ladder is None else super_ladder,
            s_per_shard, k_local, factor * tile)
        tails = {}
        for i in shards:
            if sup_counts[i] == 0:
                continue            # the shard-skip: no child bound, no kernel
            with on_device(devs[i], (axis, i)):
                i_sup = pruning._rung(sup_counts[i], sup_rungs)
                r_sup = sup_rungs[i_sup]
                gid_t = (sup[i][0][:r_sup, None].long() * factor
                         + torch.arange(factor, device=devs[i])).reshape(-1)
                valid = (gid_t >= 0) & (gid_t < t_local)
                safe = gid_t.clamp(0, t_local - 1)
                cb = pruning.bounds_from_parts(
                    state.backend, tuple(p[safe] for p in child_sh[i]),
                    s_sh[i])
                tails[i] = (i_sup, r_sup) + pruning.compact_values(
                    pruning.survival_mask(cb, theta_sh[i]) & valid, gid_t)
        counts = dict(zip(tails, sharding.host_values(
            [t[3] for t in tails.values()], mesh,
            "retrieval_head.top_items_pruned_sharded: child survivor "
            "counts", t_local) if tails else []))
        for i in shards:
            if i not in tails:
                out[i] = (torch.full((bq, k_local), float("-inf"),
                                     device=devs[i]),
                          torch.full((bq, k_local), n - offsets[i],
                                     dtype=torch.int32, device=devs[i]))
                loc[i] = dict(count=0, rung=0, n_scored=0, n_rungs=1,
                              overflow=False, bounds=s_per_shard,
                              sup_rung=0, max_group=0)
                continue
            i_sup, r_sup, child_slots, _ = tails[i]
            crungs = pruning.normalize_ladder(ladder, r_sup * factor,
                                              k_local, tile)
            c = counts[i]
            r = pruning._rung(c, crungs)
            with on_device(devs[i], (axis, i)):
                out[i] = kernel_ops.pq_topk_tiles(
                    codes_sh[i], s_sh[i], k_local, child_slots[:crungs[r]],
                    tile=tile, live=live_sh[i])
            loc[i] = dict(count=c, rung=r, n_scored=crungs[r],
                          n_rungs=len(crungs),
                          overflow=len(crungs) > 1 and c > crungs[-2],
                          bounds=s_per_shard + r_sup * factor,
                          sup_rung=i_sup, max_group=c)
    elif grouped:
        grp_out = []
        for i in shards:
            with on_device(devs[i], (axis, i)):
                pq_mask = pruning.survival_mask_perquery(bounds[i],
                                                         theta_sh[i])
                perm, inv, slots2d, gcounts = pruning.group_and_compact(
                    pq_mask, n_groups=n_groups, batch_tile=bt)
                union = pq_mask.any(dim=0).sum(dtype=torch.int32)
                grp_out.append((perm, inv, slots2d,
                                torch.cat([gcounts, union[None]])))
        counts = sharding.host_values(
            [g[3] for g in grp_out], mesh,
            "retrieval_head.top_items_pruned_sharded: group and union "
            "counts", t_local)
        for i in shards:
            perm, inv, slots2d, _ = grp_out[i]
            *gcounts, union = counts[i]
            r = pruning._rung(max(gcounts), rungs)
            with on_device(devs[i], (axis, i)):
                lv, li = kernel_ops.pq_topk_tiles(
                    codes_sh[i], s_sh[i][perm], k_local,
                    slots2d[:, :rungs[r]], tile=tile, batch_tile=bt,
                    live=live_sh[i])
                out[i] = (lv[inv], li[inv])
            loc[i] = dict(count=union, rung=r, n_scored=rungs[r],
                          max_group=max(gcounts),
                          pairs=sum(gcounts) * bt)
    else:
        flat = []
        for i in shards:
            with on_device(devs[i], (axis, i)):
                flat.append(pruning.compact_mask(pruning.survival_mask(
                    bounds[i], theta_sh[i])))
        counts = sharding.host_values(
            [c for _, c in flat], mesh,
            "retrieval_head.top_items_pruned_sharded: survivor counts",
            t_local)
        for i in shards:
            r = pruning._rung(counts[i], rungs)
            with on_device(devs[i], (axis, i)):
                out[i] = kernel_ops.pq_topk_tiles(
                    codes_sh[i], s_sh[i], k_local, flat[i][0][:rungs[r]],
                    tile=tile, live=live_sh[i])
            loc[i] = dict(count=counts[i], rung=r, n_scored=rungs[r],
                          max_group=counts[i])

    # ---- the merge, in request order ------------------------------------
    lvs, gids = [], []
    for i in shards:
        with on_device(devs[i], (axis, i)):
            lv, gid = _finish_shard(*out[i], offsets[i], n, k,
                                    live is not None)
        lvs.append(lv)
        gids.append(gid)
    vals, ids = topk_lib.merge_local_topk(lvs, gids, k, mesh)
    if not return_stats:
        return vals, ids
    total = n_shards * t_local
    survived = sum(x["count"] for x in loc)
    rung = max(x["rung"] for x in loc)
    if hier:
        sup_stats = {"n_super": state.n_super,
                     "n_super_survived": sum(sup_counts),
                     "super_rung_hit": max(x["sup_rung"] for x in loc),
                     "bounds_computed": sum(x["bounds"] for x in loc)}
        n_rungs = max(x["n_rungs"] for x in loc)
        overflow = any(x["overflow"] for x in loc)
    else:
        sup_stats = {"n_super": 0, "n_super_survived": 0,
                     "super_rung_hit": 0, "bounds_computed": total}
        n_rungs = len(rungs)
        # Per shard: survivor skew can force one shard onto its exhaustive
        # rung while the total would fit.
        overflow = len(rungs) > 1 and rung == len(rungs) - 1
    # The reference's compiled division by a constant: a multiply by the
    # float32 reciprocal.
    frac = np.float32(survived) * np.float32(1.0 / max(total, 1))
    stats = {"n_tiles": total, "n_survived": survived,
             "n_scored": sum(x["n_scored"] for x in loc),
             "survival_fraction": frac, "n_seed_used": max(n_seed_used),
             "seed_survival_est": frac, "rung_hit": rung,
             "n_rungs": n_rungs, "slot_overflow": overflow,
             "bound_backend": state.backend,
             "n_groups": b_pad // bt if grouped else 1,
             "max_group_survived": max(x["max_group"] for x in loc),
             "pairs_scored": sum(x.get("pairs", x["count"] * b_pad)
                                 for x in loc),
             "pairs_union": survived * b_pad, **sup_stats}
    return vals, ids, stats


def top_items_sharded(params: Params, phi: torch.Tensor, k: int, mesh,
                      axis: str = "model", method: str = "pqtopk",
                      pq_cfg: Optional[PQConfig] = None, ladder=None):
    """Item-sharded retrieval: the codes split over ``axis``, each shard
    scores its rows with ``method`` and contributes k candidates to an
    O(k * shards) merge -> (vals (B,k), ids (B,k)) on the lead device.
    ``pqtopk_kernel`` launches the ``pq_scores`` kernel per shard (the
    reference maps it to its plain scorer there; scoring is exact, so the
    bits agree).  A dense head goes to :func:`_dense_top_items_sharded`,
    ``pqtopk_pruned`` to :func:`top_items_pruned_sharded`."""
    if not is_pq(params):
        return _dense_top_items_sharded(params, phi, k, mesh, axis)
    if method == "pqtopk_pruned":
        return top_items_pruned_sharded(params, phi, k, mesh, axis,
                                        pq_cfg=pq_cfg, ladder=ladder)
    if params.get("live") is not None:
        raise ValueError(
            f"params carry a tombstone mask ('live') but method {method!r} "
            "would ignore it and could return delisted items; mutable "
            "catalogues serve via 'pqtopk_pruned'")
    n = params["codes"].shape[0]
    _, pad, n_local, offsets = _shard_layout(n, mesh, axis)
    codes_sh = sharding.shard_rows(params["codes"], mesh, axis)
    s_sh = sharding.replicate(_subid_scores(params, phi), mesh, axis)
    if method == "pqtopk_fused":
        return _fused_shard_fn(k, n, n_local, pad, axis)(codes_sh, s_sh,
                                                         mesh)
    scorers = {"pqtopk": scoring.score_pqtopk,
               "pqtopk_onehot": scoring.score_pqtopk_onehot,
               "pqtopk_kernel": kernel_ops.pq_scores,
               "recjpq": scoring.score_recjpq}
    if method not in scorers:
        raise ValueError(f"method {method!r} has no sharded route; one of "
                         f"{sorted(scorers) + ['pqtopk_fused', 'pqtopk_pruned']}")
    r_sh = []
    for i, (c, sq, off) in enumerate(zip(codes_sh, s_sh, offsets)):
        with on_device(c.device, (axis, i)):
            r = scorers[method](c, sq)
            # Padding rows (global id >= n) out of the top-k.
            gid = off + torch.arange(n_local, device=c.device)
            r_sh.append(torch.where(gid[None, :] < n, r, float("-inf")))
    return topk_lib.local_then_merge_topk(r_sh, k, mesh, offsets, axis)


def _fused_shard_fn(k: int, n: int, n_local: int, pad: int,
                    axis: str = "model"):
    """Shard bodies of the fused route: the fused kernel gives each shard's
    top-(k + pad) directly (the (B, N_local) scores never exist), shard
    padding rows (zero codes, on the last shard) are masked after the ids
    go global, each shard keeps its best k, and the merge is the same
    O(k * shards) one as every other method."""
    k_local = min(k + pad, n_local)

    def run(codes_sh, s_sh, mesh):
        lvs, gids = [], []
        for i, (c, sq) in enumerate(zip(codes_sh, s_sh)):
            with on_device(c.device, (axis, i)):
                lv, gid = _finish_shard(*kernel_ops.pq_topk(c, sq, k_local),
                                        i * n_local, n, k, False)
            lvs.append(lv)
            gids.append(gid)
        return topk_lib.merge_local_topk(lvs, gids, k, mesh)

    return run


def _dense_top_items_sharded(params: Params, phi: torch.Tensor, k: int,
                             mesh, axis: str):
    """The dense head's table split over ``axis``; N must divide by the
    shard count (the reference's ``shard_map`` refuses it otherwise)."""
    table = params["table"]
    n = table.shape[0]
    n_shards = mesh.shape[axis]
    if n % n_shards:
        raise ValueError(f"the dense sharded route splits the table's {n} "
                         f"rows evenly; {n} does not divide by {n_shards}")
    n_local = n // n_shards
    r_sh = []
    for i, (t, p) in enumerate(zip(sharding.shard_rows(table, mesh, axis),
                                   sharding.replicate(phi, mesh, axis))):
        with on_device(t.device, (axis, i)):
            r_sh.append(scoring.score_dense(t.to(p.dtype), p).float())
    return topk_lib.local_then_merge_topk(
        r_sh, k, mesh, [i * n_local for i in range(n_shards)], axis)
