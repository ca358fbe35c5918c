"""The reference's optimizers as functions on tensor trees: AdamW with a
configurable moment dtype (bf16 at 340B scale), global-norm clipping,
warmup-cosine / warmup-rsqrt schedules, and Adafactor.

Signatures and returned trees are the reference's ``training/optimizer.py``
(not ``torch.optim``'s: the update order, ``moment_dtype`` and the frozen
paths are the reference's).  The step counter is an int32 0-d tensor, and
the schedule and bias corrections are computed on 0-d float32 tensors, as
the reference computes them on float32 arrays.  A gradient tree carries
``None`` at integer leaves (the reference's ``float0``); updates run under
``torch.no_grad()`` and return new tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.training import tree as tree_lib

Params = Any

MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"        # cosine | rsqrt | constant


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = ((step + 1) / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    if cfg.schedule == "cosine":
        frac = ((step - cfg.warmup_steps)
                / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0, 1)
        decay = 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "rsqrt":
        decay = torch.rsqrt(step.clamp(min=cfg.warmup_steps)
                            / max(cfg.warmup_steps, 1))
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def adamw_init(params: Params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments of ``moment_dtype`` for every leaf, integer ones
    included (as the reference's state, so checkpoints cross key for
    key)."""
    mdt = MOMENT_DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    dev = next(iter(tree_lib.leaves(params))).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_lib.tree_map(zeros, params),
            "v": tree_lib.tree_map(zeros, params)}


def abstract_adamw(params: Params, cfg: AdamWConfig) -> Dict[str, Any]:
    """:func:`adamw_init`'s state on meta (no storage)."""
    return adamw_init(tree_lib.to_meta(params), cfg)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of the float leaves' squares, summed in the
    reference's leaf order."""
    sq = [x.float().square().sum() for x in tree_lib.leaves(tree)
          if _is_float(x)]
    return torch.stack(sq).sum().sqrt()


def clip_by_global_norm(grads: Params, max_norm: float,
                        ) -> Tuple[Params, torch.Tensor]:
    gn = global_norm(grads)
    scale = (max_norm / gn.clamp(min=1e-9)).clamp(max=1.0)
    return tree_lib.tree_map(
        lambda g: (g.float() * scale).to(g.dtype) if _is_float(g) else g,
        grads), gn


@torch.no_grad()
def adamw_update(grads: Params, state: Dict[str, Any], params: Params,
                 cfg: AdamWConfig, *,
                 frozen: Optional[Callable[[str], bool]] = None,
                 ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  ``frozen(path)`` -> True freezes a leaf (e.g. PQ
    ``codes`` buffers, which are integer constants, are always frozen)."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    if cfg.clip_norm > 0:
        grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gn = global_norm(grads)
    b1, b2 = cfg.b1, cfg.b2
    step32 = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, step32)
    bc2 = 1 - torch.pow(b2, step32)
    mdt = MOMENT_DTYPES[cfg.moment_dtype]

    def leaf(path, p, g, m, v):
        if not p.is_floating_point() or (
                frozen is not None and frozen(tree_lib.path_str(path))):
            return p, m, v
        # The reference's arithmetic op for op, each temporary updated in
        # place once made (at a vocabulary-sized leaf every float32 copy
        # is gigabytes); p - u is computed as -u + p, the same float.
        g32 = g.float()
        m32 = m.float() * b1
        m32 += g32 * (1 - b1)
        t = g32.square()
        del g32
        t *= 1 - b2
        v32 = v.float() * b2
        v32 += t
        del t
        upd = m32 / bc1
        den = v32 / bc2
        den.sqrt_()
        den += cfg.eps
        upd /= den
        del den
        upd += cfg.weight_decay * p.float()
        upd *= lr
        new_p = upd.neg_().add_(p.float()).to(p.dtype)
        return new_p, m32.to(mdt), v32.to(mdt)

    new_params, new_m, new_v = tree_lib.unzip(tree_lib.map_with_path(
        leaf, params, grads, state["m"], state["v"]), 3)
    new_state = {"step": step, "m": new_m, "v": new_v}
    return new_params, new_state, {"grad_norm": gn, "lr": lr}


def default_frozen(path: str) -> bool:
    """Integer PQ codes and any explicitly frozen buffers."""
    return path.endswith("codes")


# ---------------------------------------------------------------------------
# Adafactor [Shazeer & Stern, arXiv:1804.04235] — factored second moments:
# O(m+n) optimizer state per (m, n) matrix instead of Adam's O(2mn).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-2
    decay: float = 0.8           # beta2_t = 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "rsqrt"

    def as_adamw(self) -> AdamWConfig:
        return AdamWConfig(lr=self.lr, warmup_steps=self.warmup_steps,
                           total_steps=self.total_steps,
                           schedule=self.schedule)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params: Params, cfg: AdafactorConfig) -> Dict[str, Any]:
    def leaf(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                      device=p.device)
        if not p.is_floating_point():
            return {"_": z(())}
        if _factored(p.shape):
            return {"vr": z(p.shape[:-1]),
                    "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    dev = next(iter(tree_lib.leaves(params))).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "v": tree_lib.tree_map(leaf, params)}


def abstract_adafactor(params: Params, cfg: AdafactorConfig
                       ) -> Dict[str, Any]:
    """:func:`adafactor_init`'s state on meta (no storage)."""
    return adafactor_init(tree_lib.to_meta(params), cfg)


@torch.no_grad()
def adafactor_update(grads: Params, state: Dict[str, Any], params: Params,
                     cfg: AdafactorConfig, *,
                     frozen: Optional[Callable[[str], bool]] = None,
                     ) -> Tuple[Params, Dict[str, Any],
                                Dict[str, torch.Tensor]]:
    step = state["step"] + 1
    lr = schedule_lr(cfg.as_adamw(), step)
    beta2 = 1.0 - step.to(torch.float32) ** (-cfg.decay)
    gn = global_norm(grads)

    def leaf(path, p, g, v):
        if not p.is_floating_point() or (
                frozen is not None and frozen(tree_lib.path_str(path))):
            return p, v
        g32 = g.float()
        g2 = g32.square() + cfg.eps
        if "vr" in v:
            vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(-1)
            vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(-2)
            denom = (vr / vr.mean(-1, keepdim=True).clamp(min=cfg.eps)
                     )[..., None] * vc[..., None, :]
            upd = g32 * torch.rsqrt(denom.clamp(min=cfg.eps))
            new_v = {"vr": vr, "vc": vc}
        else:
            vv = beta2 * v["v"] + (1 - beta2) * g2
            upd = g32 * torch.rsqrt(vv.clamp(min=cfg.eps))
            new_v = {"v": vv}
        # Update clipping (RMS <= clip_threshold).
        rms = (upd.square().mean() + cfg.eps).sqrt()
        upd = upd / (rms / cfg.clip_threshold).clamp(min=1.0)
        if cfg.weight_decay:
            upd = upd + cfg.weight_decay * p.float()
        return (p.float() - lr * upd).to(p.dtype), new_v

    new_params, new_v = tree_lib.unzip(tree_lib.map_with_path(
        leaf, params, grads, state["v"]), 2)
    return new_params, {"step": step, "v": new_v}, {"grad_norm": gn,
                                                     "lr": lr}


def adafactor_state_bytes(params: Params) -> int:
    """Factored-state footprint — compare against Adam's 2x param bytes."""
    total = 0
    for p in tree_lib.leaves(params):
        if not p.is_floating_point():
            continue
        shape = tuple(p.shape)
        if _factored(shape):
            total += 4 * (int(np.prod(shape[:-1]))
                          + int(np.prod(shape[:-2] + shape[-1:])))
        else:
            total += 4 * p.numel()
    return total
