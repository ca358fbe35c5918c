"""Codebook construction: item id -> m sub-ids (Eq. 1 of the paper).

Three strategies:

* ``svd``    — RecJPQ [WSDM'24]: truncated SVD of the user-item interaction
               matrix gives item factors; each of the m factor sub-spaces is
               k-means-clustered into b centroids; an item's sub-id in split k
               is its cluster in sub-space k.  Centroids initialise the
               sub-embeddings.
* ``kmeans`` — classic PQ [Jégou+ TPAMI'11] on a given embedding matrix.
* ``random`` — uniform random codes (used by the paper's RQ2 simulations and
               by our scaling benchmarks; scoring cost is independent of the
               assignment quality).

Every strategy runs on the host (numpy/scipy) — codebook construction happens once
before training, like building a tokenizer.  A copy of the reference's
``core/codebook.py`` over the port's own ``PQConfig``: the same inputs and
seed give identical codes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.base import PQConfig


def _kmeans(x: np.ndarray, n_clusters: int, n_iter: int = 25,
            seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd's k-means (numpy). Returns (centroids [b,d], assignment [n])."""
    n, d = x.shape
    rng = np.random.default_rng(seed)
    if n <= n_clusters:
        # Degenerate: fewer points than clusters — pad with noise copies.
        centroids = np.zeros((n_clusters, d), x.dtype)
        centroids[:n] = x
        centroids[n:] = x[rng.integers(0, n, n_clusters - n)] + rng.normal(
            0, 1e-3, (n_clusters - n, d)).astype(x.dtype)
        return centroids, np.arange(n) % n_clusters
    # k-means++ style seeding (cheap variant: distinct random picks).
    centroids = x[rng.choice(n, n_clusters, replace=False)].copy()
    assign = np.zeros(n, np.int64)
    # The reference's distances, |x|^2 - (2x) @ c.T + |c|^2, by the same
    # operations in the same order, written into one (n, b) buffer: the
    # terms of x once, and no (n, b) array allocated per iteration.
    x_sq = (x ** 2).sum(1, keepdims=True)
    x2 = 2.0 * x
    d2 = np.empty((n, n_clusters), x.dtype)
    for _ in range(n_iter):
        np.matmul(x2, centroids.T, out=d2)
        np.subtract(x_sq, d2, out=d2)
        np.add(d2, (centroids ** 2).sum(1)[None, :], out=d2)
        new_assign = d2.argmin(1)
        if (new_assign == assign).all():
            assign = new_assign
            break
        assign = new_assign
        # Each cluster's members in ascending index order, as the
        # reference's boolean mask selects them (so each mean sums the same
        # rows in the same order), found by one stable sort instead of a
        # full scan per cluster; and the farthest point found once an
        # iteration, since d2 does not change inside the loop (the
        # reference recomputes it for every dead centroid).
        order = np.argsort(assign, kind="stable")
        bounds = np.searchsorted(assign[order], np.arange(n_clusters + 1))
        farthest = None
        for c in range(n_clusters):
            members = order[bounds[c]:bounds[c + 1]]
            if len(members):
                centroids[c] = x[members].mean(0)
            else:  # dead centroid: re-seed on the farthest point
                if farthest is None:
                    farthest = d2.min(1).argmax()
                centroids[c] = x[farthest]
    return centroids.astype(np.float32), assign.astype(np.int64)


def build_random(n_items: int, pq: PQConfig, seed: int = 0) -> np.ndarray:
    """Uniform random codes, shape (n_items, m)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, pq.b, size=(n_items, pq.m), dtype=np.int64)


def build_kmeans(embeddings: np.ndarray, pq: PQConfig, seed: int = 0,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Classic PQ: split embedding dims into m sub-spaces, k-means each.

    Returns (codes [n,m] int64, centroids [m,b,d/m] f32).
    """
    n, d = embeddings.shape
    if d % pq.m:
        raise ValueError(f"d={d} not divisible by m={pq.m}")
    sub = d // pq.m
    codes = np.zeros((n, pq.m), np.int64)
    cents = np.zeros((pq.m, pq.b, sub), np.float32)
    for k in range(pq.m):
        c, a = _kmeans(embeddings[:, k * sub:(k + 1) * sub].astype(np.float32),
                       pq.b, seed=seed + k)
        cents[k], codes[:, k] = c, a
    return codes, cents


def build_svd(user_ids: np.ndarray, item_ids: np.ndarray, n_users: int,
              n_items: int, d_model: int, pq: PQConfig, seed: int = 0,
              ) -> Tuple[np.ndarray, np.ndarray]:
    """RecJPQ codebook: truncated SVD of the interaction matrix + per-split
    k-means.  Returns (codes [n_items,m], centroid init [m,b,d_model/m]).
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.linalg import svds

    rank = min(max(pq.m * 4, 8), min(n_users, n_items) - 1, 128)
    mat = coo_matrix(
        (np.ones(len(user_ids), np.float32), (user_ids, item_ids)),
        shape=(n_users, n_items),
    ).tocsr()
    _, s, vt = svds(mat, k=rank, random_state=np.random.default_rng(seed))
    item_factors = (vt.T * s[None, :]).astype(np.float32)  # (n_items, rank)
    # Split the factor space into m sub-spaces (pad rank up to a multiple).
    pad = (-item_factors.shape[1]) % pq.m
    if pad:
        item_factors = np.pad(item_factors, ((0, 0), (0, pad)))
    sub = item_factors.shape[1] // pq.m
    codes = np.zeros((n_items, pq.m), np.int64)
    for k in range(pq.m):
        _, codes[:, k] = _kmeans(item_factors[:, k * sub:(k + 1) * sub],
                                 pq.b, seed=seed + k)
    # Centroid init in model space: zeros-mean gaussian scaled like the
    # factors (the trainable sub-embeddings are learned afterwards; RecJPQ
    # only needs the *assignment* from SVD).
    rng = np.random.default_rng(seed)
    if d_model % pq.m:
        raise ValueError(f"d_model={d_model} not divisible by m={pq.m}")
    cents = rng.normal(0.0, 0.02, (pq.m, pq.b, d_model // pq.m)).astype(np.float32)
    return codes, cents


def build_codebook(pq: PQConfig, n_items: int, *, d_model: Optional[int] = None,
                   embeddings: Optional[np.ndarray] = None,
                   interactions: Optional[Tuple[np.ndarray, np.ndarray, int]] = None,
                   seed: int = 0) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Dispatch on ``pq.assign``. Returns (codes, centroid_init or None)."""
    if pq.assign == "random":
        return build_random(n_items, pq, seed), None
    if pq.assign == "kmeans":
        if embeddings is None:
            raise ValueError("kmeans assignment needs an embedding matrix")
        return build_kmeans(embeddings, pq, seed)
    if pq.assign == "svd":
        if interactions is None:
            raise ValueError("svd assignment needs (user_ids, item_ids, n_users)")
        if d_model is None:
            raise ValueError("svd assignment needs d_model")
        u, i, n_users = interactions
        return build_svd(u, i, n_users, n_items, d_model, pq, seed)
    raise ValueError(f"unknown assignment strategy {pq.assign!r}")
