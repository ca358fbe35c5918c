"""Mixture-of-experts FFN: top-k routing with a per-group expert capacity,
as plain functions on parameter dicts — the reference's ``models/moe.py``.

Tokens are cut into groups of about ``GROUP_TOKENS`` (the group count is
the reference's: ``max(1, t // GROUP_TOKENS)``, lowered until it divides
``t``); each group routes on its own and each expert takes at most
``_capacity(tokens_per_group)`` of a group's (token, choice) pairs, the
pairs ranked by ``t * k + j`` within their expert so that both impls drop
the same ones.  Two dispatches, each held against its own reference twin:

* ``impl="dense"``: one-hot dispatch and combine tensors (G, Tg, E, C)
  and einsums, the GShard form.  Its aux loss counts the pairs kept after
  the capacity drop, over all k choices (``dispatch.sum((1, 3)) / tg``).
* ``impl="sort"``: the pairs sorted by expert (stable), gathered into
  (G, E, C, d) buffers, the same expert products, and each token's kept
  contributions added back.  Its aux loss counts the one-hot density of
  the choices before any drop, over ``tg * k``.  The two aux losses agree
  only when nothing is dropped and k = 1 (ROADMAP C10).

The router is float32 whatever the other weights are, and its logits are
a float32 product; the expert products run in the activations' dtype.
Routing takes the top-k of the softmax in ``lax.top_k``'s order
(``core/topk.py``), so ties go to the lower expert as in the reference.

The sort impl adds each token's contributions in ascending expert order,
the order the reference's ``segment_sum`` meets them in on the CPU,
without atomics: the sum is the same on the card from run to run.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import topk as topk_lib
from repro_torch.models import layers

Params = Dict[str, Any]

GROUP_TOKENS = 2048


def moe_init(generator: torch.Generator, cfg: MoEConfig, d_model: int, *,
             gated: bool, dtype: torch.dtype = torch.float32) -> Params:
    """The reference's tree: a float32 ``router`` (d, E), experts ``up``
    and ``gate`` (E, d, f) at scale d^-1/2 and ``down`` (E, f, d) at
    f^-1/2 in ``dtype``, and a ``shared`` MLP of width ``n_shared * f``."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": layers.dense_init(generator, d_model, e,
                                    dtype=torch.float32),
        "up": layers._normal(generator, (e, d_model, f), d_model ** -0.5,
                             dtype),
        "down": layers._normal(generator, (e, f, d_model), f ** -0.5,
                               dtype),
    }
    if gated:
        p["gate"] = layers._normal(generator, (e, d_model, f),
                                   d_model ** -0.5, dtype)
    if cfg.n_shared:
        p["shared"] = layers.mlp_init(generator, d_model, cfg.n_shared * f,
                                      gated=gated, dtype=dtype)
    return p


def _capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8 lanes


def _groups(t: int) -> Tuple[int, int]:
    """(group count, tokens per group) for ``t`` tokens."""
    g = max(1, t // GROUP_TOKENS)
    while t % g:
        g -= 1
    return g, t // g


def _route(p: Params, cfg: MoEConfig, xg: torch.Tensor):
    """xg (G, Tg, d) -> (probs (G, Tg, E) float32, renormalised gate
    values (G, Tg, k), chosen experts (G, Tg, k) int32)."""
    logits = xg.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = topk_lib.topk(probs, cfg.top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, sel


def _dense_dispatch(sel: torch.Tensor, gate_vals: torch.Tensor, e: int,
                    c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dispatch (G, Tg, E, C) 0/1, combine (G, Tg, E, C) with the gate
    values): choice j of token t sits at its rank among the group's pairs
    that chose its expert, counted in ``t * k + j`` order; a rank >= c is
    dropped.  ``F.one_hot`` refuses the reference's out-of-range ranks
    (which ``jax.nn.one_hot`` maps to zero rows), so ranks are clamped
    first and the rows not kept zeroed after, as the reference's are."""
    g, tg, k = sel.shape
    onehot = F.one_hot(sel.long(), e).float()                  # (G, Tg, k, E)
    pos = torch.cumsum(onehot.reshape(g, tg * k, e), dim=1) - 1.0
    pos = pos.reshape(g, tg, k, e)
    keep = (pos < c) & (onehot > 0)
    pos_c = F.one_hot(pos.long().clamp(0, c - 1), c).float()
    pos_c = pos_c * keep[..., None]
    dispatch = pos_c.sum(2)
    combine = (pos_c * gate_vals[..., None, None]).sum(2)
    return dispatch, combine


def _experts(p: Params, xe: torch.Tensor, act: str) -> torch.Tensor:
    """(G, E, C, d) -> (G, E, C, d): each expert's MLP on its buffer, in
    ``xe``'s dtype."""
    f = layers.activation(act)
    h = xe @ p["up"].to(xe.dtype)
    if "gate" in p:
        h = f(xe @ p["gate"].to(xe.dtype)) * h
    else:
        h = f(h)
    return h @ p["down"].to(xe.dtype)


def moe_ffn(p: Params, cfg: MoEConfig, x: torch.Tensor, act: str,
            impl: str = "dense") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux loss float32 0-d).

    ``impl`` is ``"dense"`` (one-hot dispatch and combine) or ``"sort"``
    (sort, gather and add back); the aux loss is the Switch/GShard
    load-balance loss, each impl's own formula (module docstring)."""
    if impl == "sort":
        return _moe_ffn_sort(p, cfg, x, act)
    if impl != "dense":
        raise ValueError(f"unknown moe impl {impl!r}; one of "
                         "('dense', 'sort')")
    b, s, d = x.shape
    g, tg = _groups(b * s)
    xg = x.reshape(g, tg, d)
    e = cfg.n_experts
    probs, gate_vals, sel = _route(p, cfg, xg)
    dispatch, combine = _dense_dispatch(sel, gate_vals, e, _capacity(tg, cfg))

    xe = torch.einsum("gtec,gtd->gecd", dispatch, xg.float()).to(x.dtype)
    ye = _experts(p, xe, act)
    out = torch.einsum("gtec,gecd->gtd", combine, ye.float())
    out = out.reshape(b, s, d).to(x.dtype)
    if "shared" in p:
        out = out + layers.mlp(p["shared"], x, act)

    frac_routed = dispatch.sum((1, 3)) / tg                     # (G, E)
    aux = (frac_routed * probs.mean(1)).sum(-1).mean() * e
    return out, aux.float()


def _sort_dispatch(sel: torch.Tensor, gate_vals: torch.Tensor, e: int,
                   c: int):
    """The pairs sorted by expert -> (slot (G, Tg*k): the pair's row of the
    (E*C + 1)-row buffer, E*C for a dropped pair; st: its token; sg: its
    gate value; keep; order: the sort's permutation)."""
    g, tg, k = sel.shape
    dev = sel.device
    flat_e = sel.reshape(g, tg * k).long()
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = torch.div(order, k, rounding_mode="floor")            # its token
    sg = torch.gather(gate_vals.reshape(g, tg * k), 1, order)
    start = torch.searchsorted(
        se, torch.arange(e, device=dev).expand(g, e).contiguous(),
        side="left")
    rank = torch.arange(tg * k, device=dev) - torch.gather(start, 1, se)
    keep = rank < c
    slot = torch.where(keep, se * c + rank, torch.full_like(se, e * c))
    return slot, st, sg, keep, order


def _moe_ffn_sort(p: Params, cfg: MoEConfig, x: torch.Tensor, act: str,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g, tg = _groups(b * s)
    xg = x.reshape(g, tg, d)
    c = _capacity(tg, cfg)
    probs, gate_vals, sel = _route(p, cfg, xg)
    slot, st, sg, keep, order = _sort_dispatch(sel, gate_vals, e, c)

    # Dropped pairs all write the spare row e*c, which is cut off.
    rows = torch.arange(g, device=x.device)[:, None]
    buf = x.new_zeros((g, e * c + 1, d))
    buf[rows, slot] = xg[rows, st]
    ye = _experts(p, buf[:, :e * c].reshape(g, e, c, d), act)

    ye_flat = torch.cat([ye.reshape(g, e * c, d), ye.new_zeros((g, 1, d))],
                        dim=1)
    contrib = ye_flat[rows, slot] * (sg * keep)[..., None].to(ye.dtype)
    # Each token's k contributions in ascending expert order: the sorted
    # positions of its pairs, sorted.
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(tg * k, device=x.device)
                 .expand(g, -1).contiguous())
    mine = inv.reshape(g, tg, k).sort(dim=-1).values.reshape(g, tg * k)
    parts = contrib[rows, mine].reshape(g, tg, k, d)
    out = parts[:, :, 0]
    for j in range(1, k):
        out = out + parts[:, :, j]
    out = out.reshape(b, s, d).to(x.dtype)
    if "shared" in p:
        out = out + layers.mlp(p["shared"], x, act)

    density = F.one_hot(sel.long(), e).float().sum((1, 2)) / (tg * k)
    aux = ((density * probs.mean(1)).sum(-1) * e).mean()
    return out, aux.float()
