"""PowerSGD gradient compression with error feedback [Vogels+ NeurIPS'19]
for the cross-pod all-reduce -- the reference's ``training/compression.py``
over the port's single-controller mesh.

For each 2-D gradient G (m x n), on every pod: P = (G + E) @ Q; the pods'
P are averaged (r*m floats) and orthonormalised; Q' = (G + E)^T @ P; the
pods' Q' are averaged (r*n floats); G_hat = P @ Q'^T.  Bytes per matrix
drop from m*n to r*(m+n).  Each pod keeps its own residual E' = G + E -
G_hat and adds it to its next gradient (error feedback).

A leaf of rank 3 or more is compressed as one matrix (prod(leading),
last): a stacked (L, d, f) layer leaf shares one low-rank factor over its
layers, as in the reference.  A leaf below ``min_size`` elements or of
rank below 2 is averaged uncompressed; an integer leaf (``None``
gradient) passes through.

The pods run in turn: a pod's values are :class:`~repro_torch.distributed.
sharding.Varying` leaves (one tensor per position of the pod axis, on its
device), and each average is :func:`~repro_torch.distributed.sharding.
pmean` over them on the lead device, sent back to every pod.

Q is drawn per leaf from a torch generator seeded by ``seed`` and the
CRC32 of the leaf's path: the same on every pod, every step and every run.
The reference folds Python's ``hash`` of the path into its key, which
Python salts per process; ``q=`` takes given factors instead (how the
tests inject the reference's).  The decompressed gradient and the residual
depend on P's span only, not on the signs QR picks.
"""
from __future__ import annotations

import math
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (
    Varying, pmean, replicate, to_device,
)
from repro_torch.training import tree as tree_lib

Params = Any


def _as_matrix(g: torch.Tensor) -> torch.Tensor:
    """``g`` (2-D or more) as (prod(leading), last)."""
    return g.reshape(-1, g.shape[-1])


def _orthonormalise(p: torch.Tensor) -> torch.Tensor:
    """An orthonormal basis of p's columns (QR)."""
    q, _ = torch.linalg.qr(p)
    return q


def init_error_feedback(params: Params) -> Params:
    """Zeros in float32 per float leaf; a 0-d zero per integer leaf."""
    def leaf(p):
        shape = p.shape if p.is_floating_point() else ()
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    return tree_lib.tree_map(leaf, params)


def abstract_error_feedback(params: Params) -> Params:
    """:func:`init_error_feedback`'s tree on meta."""
    def leaf(p):
        shape = p.shape if p.is_floating_point() else ()
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return tree_lib.tree_map(leaf, params)


def draw_q(path: str, n: int, r: int, seed: int = 0) -> torch.Tensor:
    """The (n, r) float32 normal draw for the leaf at ``path``, on the CPU
    (the same on any device it is copied to)."""
    gen = torch.Generator().manual_seed(
        (seed * 0x9E3779B1 + zlib.crc32(path.encode())) % 2 ** 63)
    return torch.randn((n, r), generator=gen, dtype=torch.float32)


def compressed(shape, min_size: int = 65536) -> bool:
    """Whether a float leaf of this shape is exchanged as low-rank
    factors."""
    return len(shape) >= 2 and math.prod(shape) >= min_size


def compressed_psum(grads: Params, err: Params, mesh, axis: str, *,
                    rank: int = 4, min_size: int = 65536, seed: int = 0,
                    q: Optional[Dict[str, torch.Tensor]] = None,
                    probe: Optional[Callable] = None,
                    ) -> Tuple[Params, Params]:
    """PowerSGD all-reduce over the positions of ``axis``.

    ``grads``: a tree whose float leaves are :class:`Varying` (each pod's
    gradient); ``None`` leaves (integer parameters) pass through.  ``err``:
    the error feedback, a tree of :class:`Varying` (per pod) or of tensors
    (one residual given to every pod, as after init or a restore).
    Returns ``(grads, new_err)``: the mean-reduced gradients as tensors on
    the lead device (every pod's copy is the same), and each pod's new
    residual as :class:`Varying`.

    ``q`` maps a leaf's path (``"a/b/0"``) to its (n, r) factor; the
    others are drawn (:func:`draw_q`).  ``probe(path, g, e, g_hat,
    new_e)`` is called for each compressed leaf with the pods' (m, n)
    gradients, residuals in and out (lists, as stored) and the float32
    ``g_hat`` before its cast, for checks; nothing is kept."""
    devs = mesh.axis_devices(axis)
    n_pods = len(devs)

    def pods(x):
        if isinstance(x, Varying):
            if len(x.parts) != n_pods:
                raise ValueError(f"{len(x.parts)} values for {n_pods} "
                                 f"positions of {axis!r}")
            return [to_device(t, d) for t, d in zip(x.parts, devs)]
        return replicate(x, mesh, axis)

    def leaf(path, g, e):
        if g is None:
            return None, e
        gs = pods(g)
        if not compressed(gs[0].shape, min_size):
            out = pmean([x.float() for x in gs], mesh).to(gs[0].dtype)
            return out, e
        es = pods(e)
        mats = [_as_matrix(x.float() + y.float()) for x, y in zip(gs, es)]
        shape = tuple(gs[0].shape)
        m, n = mats[0].shape
        r = min(rank, m, n)
        key = tree_lib.path_str(path)
        qf = q[key] if q is not None and key in q else draw_q(key, n, r, seed)
        qs = replicate(qf.to(torch.float32), mesh, axis)
        p = pmean([mt @ qi for mt, qi in zip(mats, qs)], mesh)  # r*m
        p = _orthonormalise(p)
        ps = replicate(p, mesh, axis)
        qq = pmean([mt.T @ pi for mt, pi in zip(mats, ps)], mesh)  # r*n
        g_hat = p @ qq.T
        # The residual G + E - G_hat in each pod's own G + E (no copy).
        new_e = [mt.sub_(gh).reshape(shape).to(es[0].dtype)
                 for mt, gh in zip(mats, replicate(g_hat, mesh, axis))]
        del mats
        if probe is not None:
            probe(key, [x.reshape(m, n) for x in gs],
                  [y.reshape(m, n) for y in es], g_hat,
                  [y.reshape(m, n) for y in new_e])
        return g_hat.reshape(shape).to(gs[0].dtype), Varying(new_e)

    # Over err's structure: it has a leaf (a 0-d zero) where an integer
    # parameter's gradient is None.
    pairs = tree_lib.map_with_path(
        lambda path, e, g: leaf(path, g, e), err, grads)
    return tree_lib.unzip(pairs, 2)


def compressed_psum_sharded(grads: Params, err: Params, mesh, axis: str, *,
                            rank: int = 4, min_size: int = 65536,
                            q: Optional[Dict[str, torch.Tensor]] = None,
                            ) -> Tuple[Params, Params]:
    """:func:`compressed_psum` for callers outside a manual region: grads
    and error feedback replicated over ``axis`` (tensors); the results as
    the host reads them (position 0's residual)."""
    out_g, out_e = compressed_psum(
        tree_lib.tree_map(lambda g: Varying(replicate(g, mesh, axis)),
                          grads), err, mesh, axis, rank=rank,
        min_size=min_size, q=q)
    return out_g, tree_lib.tree_map(
        lambda e: e.host() if isinstance(e, Varying) else e, out_e)


def compression_ratio(params: Params, rank: int = 4,
                      min_size: int = 65536) -> float:
    """Estimated collective-bytes ratio (compressed / uncompressed)."""
    full, comp = exchanged_elements(params, rank, min_size)
    return comp / max(full, 1)


def exchanged_elements(params: Params, rank: int = 4,
                       min_size: int = 65536) -> Tuple[int, int]:
    """(elements a pod exchanges uncompressed, elements it exchanges with
    PowerSGD) per step, over the float leaves."""
    full = comp = 0
    for p in tree_lib.leaves(params):
        if not p.is_floating_point():
            continue
        size = math.prod(p.shape)
        full += size
        if compressed(p.shape, min_size):
            m, n = size // p.shape[-1], p.shape[-1]
            comp += min(rank, m, n) * (m + n)
        else:
            comp += size
    return full, comp
