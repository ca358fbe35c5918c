"""Train-step factory: loss and gradients by ``torch.autograd`` +
microbatch gradient accumulation + the AdamW update — the reference's
``training/train_loop.py`` on one device.

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

from repro_torch.training import optimizer as opt_lib, tree as tree_lib

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
                    grad_shardings=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  Metrics are the loss function's own plus ``loss``,
    ``grad_norm`` and ``lr``.

    ``grad_accum`` > 1 splits the batch's leading dim into contiguous
    microbatches; each one's gradients are added in float32 in order (its
    graph freed before the next), then divided by ``grad_accum``; loss and
    metrics are the means over microbatches."""
    del powersgd_rank
    if powersgd_axis is not None or mesh is not None \
            or grad_shardings is not None:
        raise NotImplementedError(
            "powersgd_axis, mesh and grad_shardings are training over a "
            "mesh, not ported yet (ROADMAP A 6b)")

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

    def train_step(params, opt_state, batch):
        loss, metrics, grads = compute_grads(params, batch)
        params, opt_state, om = opt_lib.adamw_update(
            grads, opt_state, params, opt_cfg, frozen=frozen)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


def init_opt_state(params, opt_cfg: opt_lib.AdamWConfig, *,
                   powersgd: bool = False, abstract: bool = False):
    """AdamW state for ``params``; ``abstract=True`` gives it on meta (the
    dry run's stand-in, no storage)."""
    if powersgd:
        raise NotImplementedError(
            "PowerSGD error feedback is training over a mesh, not ported "
            "yet (ROADMAP A 6b)")
    mk = opt_lib.abstract_adamw if abstract else opt_lib.adamw_init
    return mk(params, opt_cfg)
