"""Train-step factory: loss and gradients by ``torch.autograd`` +
microbatch gradient accumulation + optional cross-pod PowerSGD compression
(a manual region over the ``pod`` axis) + the AdamW update — the
reference's ``training/train_loop.py``.

``train_step(params, opt_state, batch)`` is a function of its inputs that
returns new trees (the launcher keeps the latest).  Gradients follow
``jax.value_and_grad(..., allow_int=True)``: an integer leaf (codes,
pruning metadata) gets ``None`` (the reference's ``float0``) and a float
leaf the loss does not read gets zeros, so weight decay still moves it and
``global_norm`` still counts it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P
from repro_torch.training import (
    compression, optimizer as opt_lib, tree as tree_lib,
)

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def value_and_grad(loss_fn: LossFn, params, batch,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch)``: grads has
    params' structure, ``None`` at integer leaves and zeros at unused
    float leaves.  The graph is freed before returning."""
    tracked = []

    def track(p):
        if isinstance(p, torch.Tensor) and p.is_floating_point():
            p = p.detach().requires_grad_(True)
            tracked.append(p)
        return p

    live = tree_lib.tree_map(track, params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, tracked, allow_unused=True)
    grads = sharding.gradients(tracked, grads)
    by_id = {id(p): (g if g is not None else torch.zeros_like(p))
             for p, g in zip(tracked, grads)}
    grad_tree = tree_lib.tree_map(lambda p: by_id.get(id(p)), live)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grad_tree)


def _microbatch(batch: Dict[str, torch.Tensor], i: int, n: int):
    """The i-th of n contiguous slices of every batch array's leading dim
    (the reference's reshape to (n, B // n, ...))."""
    out = {}
    for k, x in batch.items():
        mb = x.shape[0] // n
        out[k] = x[i * mb:(i + 1) * mb]
    return out


def make_train_step(loss_fn: LossFn, opt_cfg: opt_lib.AdamWConfig, *,
                    grad_accum: int = 1,
                    frozen=opt_lib.default_frozen,
                    powersgd_axis: Optional[str] = None,
                    powersgd_rank: int = 4,
                    mesh=None,
                    grad_shardings=None,
                    powersgd_q=None):
    """Returns train_step(params, opt_state, batch, *, trace=None) ->
    (params, opt_state, metrics).  Metrics are the loss function's own
    plus ``loss``, ``grad_norm`` and ``lr``.

    ``grad_accum`` > 1 splits the batch's leading dim into contiguous
    microbatches; each one's gradients are added in float32 in order (its
    graph freed before the next), then divided by ``grad_accum``; loss and
    metrics are the means over microbatches.

    ``powersgd_axis`` (with ``mesh``): each position of that axis (a pod)
    computes its gradients on its contiguous slice of the batch, on its
    device, in turn; the pods exchange them by PowerSGD
    (:func:`compression.compressed_psum`, ``powersgd_rank``; the factors
    ``powersgd_q`` by leaf path, else drawn); loss and metrics are the pod
    means.  The error feedback lives in ``opt_state["ef"]``, one residual
    per pod after a step (:class:`~repro_torch.distributed.sharding.
    Varying`), as in the reference.  ``grad_shardings`` (a tree of
    ``NamedSharding``) constrains the gradients to the parameter layout
    before AdamW; values are unchanged.

    ``trace`` (a dict, for checks and timing): ``trace["mark"](name)`` is
    called after the pod bodies (``"pods"``), the exchange
    (``"exchange"``) and AdamW (``"update"``), and ``trace["leaf"]`` is
    the exchange's ``probe``."""
    if powersgd_axis is not None and mesh is None:
        raise ValueError("powersgd needs the mesh")

    def compute_grads(params, batch):
        if grad_accum == 1:
            return value_and_grad(loss_fn, params, batch)
        acc, losses, metrics = None, [], []
        for i in range(grad_accum):
            loss, mets, grads = value_and_grad(
                loss_fn, params, _microbatch(batch, i, grad_accum))
            g32 = tree_lib.tree_map(
                lambda g: None if g is None else g.float(), grads)
            acc = g32 if acc is None else tree_lib.tree_map(
                lambda a, g: None if a is None else a + g, acc, g32)
            losses.append(loss)
            metrics.append(mets)
            del grads, g32
        grads = tree_lib.tree_map(
            lambda a: None if a is None else a / grad_accum, acc)
        metrics = {k: torch.stack([m[k] for m in metrics]).mean()
                   for k in metrics[0]}
        return torch.stack(losses).mean(), metrics, grads

    def train_step(params, opt_state, batch, *, trace=None):
        trace = trace or {}
        mark = trace.get("mark") or (lambda name: None)
        # The old residual is not needed past the exchange: drop this
        # frame's hold on it (a caller that keeps no reference to its old
        # state then gets that memory back before AdamW).
        ef = opt_state.get("ef")
        opt_state = {k: v for k, v in opt_state.items() if k != "ef"}
        if powersgd_axis is not None:
            # Manual over the pod axis: each body sees its pod's batch
            # slice; the only cross-pod traffic is the compressed factors.
            region = sharding.manual_axis_map(
                compute_grads, mesh, in_specs=(P(), P(powersgd_axis)),
                out_specs=(P(), P(), P()), axis_names={powersgd_axis})
            loss, metrics, grads = region(params, batch)
            mark("pods")
            grads, ef = compression.compressed_psum(
                grads, ef, mesh, powersgd_axis, rank=powersgd_rank,
                q=powersgd_q, probe=trace.get("leaf"))
            loss = sharding.pmean(loss.parts, mesh)
            metrics = {k: sharding.pmean(v.parts, mesh)
                       for k, v in metrics.items()}
            mark("exchange")
        else:
            loss, metrics, grads = compute_grads(params, batch)
        if grad_shardings is not None:
            grads = tree_lib.map_with_path(
                lambda path, g, sh: sharding.with_sharding_constraint(
                    g, sh, "grads/" + tree_lib.path_str(path)),
                grads, grad_shardings)
        params, opt_state, om = opt_lib.adamw_update(
            grads, opt_state, params, opt_cfg, frozen=frozen)
        if ef is not None:
            opt_state["ef"] = ef
        mark("update")
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


def init_opt_state(params, opt_cfg: opt_lib.AdamWConfig, *,
                   powersgd: bool = False, abstract: bool = False):
    """AdamW state for ``params``, with PowerSGD's error feedback under
    ``"ef"`` when ``powersgd``; ``abstract=True`` gives it on meta (the
    dry run's stand-in, no storage)."""
    mk = opt_lib.abstract_adamw if abstract else opt_lib.adamw_init
    state = mk(params, opt_cfg)
    if powersgd:
        state["ef"] = (compression.abstract_error_feedback(params) if abstract
                       else compression.init_error_feedback(params))
    return state
