"""Shared NN building blocks as plain functions on parameter dicts.

Weights keep the reference's layout: a dense layer's ``w`` is
``(d_in, d_out)`` and applies as ``x @ w``.  Three details differ from
PyTorch's habits and follow the reference instead:

* ``apply_norm`` uses eps=1e-6 (not ``nn.LayerNorm``'s 1e-5);
* ``activation("gelu")`` is the tanh form (``jax.nn.gelu``'s default);
* RoPE rotates split halves, not interleaved pairs.

The MLP is the reference's: plain two-matrix (``gated=False``, the seqrec
blocks and BST) or gated GLU (``act(gate(x)) * up(x)``).

The ``*_init`` functions draw in float32 on ``generator.device`` and then
cast to ``dtype`` (float32 unless the caller asks for another), as the
reference does; norms are built on ``device``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _normal(generator: torch.Generator, shape, scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 on the generator's device, then cast."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * scale).to(dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype: torch.dtype = torch.float32,
               scale: float | None = None) -> Params:
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": _normal(generator, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embedding_init(generator: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype = torch.float32,
                   scale: float = 0.02) -> Params:
    return {"table": _normal(generator, (vocab, d), scale, dtype)}


def norm_init(d: int, kind: str = "rmsnorm",
              dtype: torch.dtype = torch.float32, device="cpu") -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = xf * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's form
    "relu": F.relu,
    "sqrelu": lambda x: torch.square(F.relu(x)),       # Primer / Nemotron
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def activation(name: str):
    """The reference's activation table."""
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; one of "
                         f"{sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D), positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (D/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, D/2)
    angles = angles[..., None, :]                                 # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool, dtype: torch.dtype = torch.float32) -> Params:
    p = {
        "up": dense_init(generator, d_model, d_ff, dtype=dtype),
        "down": dense_init(generator, d_ff, d_model, dtype=dtype,
                           scale=d_ff ** -0.5),
    }
    if gated:
        p["gate"] = dense_init(generator, d_model, d_ff, dtype=dtype)
    return p


def mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    from repro_torch.distributed.sharding import constrain
    f = activation(act)
    h = dense(p["up"], x)
    h = f(dense(p["gate"], x)) * h if "gate" in p else f(h)
    # TP hook: the d_ff intermediate (Megatron-SP plans set "mlp_hidden").
    h = constrain(h, "mlp_hidden")
    return dense(p["down"], h)
