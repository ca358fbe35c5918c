"""Graph data: synthetic power-law graphs, the uniform fanout neighbor
sampler (real sampling, host-side — required for minibatch_lg), and batched
small-molecule graphs.

A numpy-only copy of the reference's ``data/graph.py``: the same seed and
``np.random.Generator`` give bit-identical graphs, samples and batches in
both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass
class Graph:
    edges: np.ndarray        # (E, 2) int32 src,dst
    feats: np.ndarray        # (N, F) f32
    labels: np.ndarray       # (N,) int32
    n_classes: int

    @property
    def n_nodes(self) -> int:
        return self.feats.shape[0]


def synthetic_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                    seed: int = 0) -> Graph:
    """Power-law-ish random graph (preferential-attachment flavoured)."""
    rng = np.random.default_rng(seed)
    # Degree-biased destination choice approximates preferential attachment.
    dst_pool = rng.zipf(1.5, n_edges * 2) % n_nodes
    src = rng.integers(0, n_nodes, n_edges)
    dst = dst_pool[:n_edges]
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    feats = rng.normal(0, 1, (n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    return Graph(edges, feats, labels, n_classes)


class NeighborSampler:
    """Uniform-with-replacement fanout sampling from a CSR adjacency —
    the GraphSAGE minibatch pipeline (host-side, feeds device steps)."""

    def __init__(self, graph: Graph):
        order = np.argsort(graph.edges[:, 1], kind="stable")
        self._sorted_src = graph.edges[order, 0]
        dst_sorted = graph.edges[order, 1]
        self._starts = np.searchsorted(dst_sorted, np.arange(graph.n_nodes))
        self._ends = np.searchsorted(dst_sorted, np.arange(graph.n_nodes) + 1)
        self.graph = graph

    def sample_neighbors(self, nodes: np.ndarray, fanout: int,
                         rng: np.random.Generator) -> np.ndarray:
        """(B,) -> (B, fanout) neighbor ids (self-loop where degree 0)."""
        starts, ends = self._starts[nodes], self._ends[nodes]
        deg = ends - starts
        offs = rng.integers(0, np.maximum(deg, 1)[:, None],
                            (len(nodes), fanout))
        idx = starts[:, None] + offs
        nbrs = self._sorted_src[np.minimum(idx, len(self._sorted_src) - 1)]
        return np.where(deg[:, None] > 0, nbrs, nodes[:, None]).astype(
            np.int32)

    def sample_batch(self, batch_nodes: np.ndarray, fanout: Tuple[int, int],
                     rng: np.random.Generator) -> Dict[str, np.ndarray]:
        f1, f2 = fanout
        n1 = self.sample_neighbors(batch_nodes, f1, rng)           # (B, f1)
        n2 = self.sample_neighbors(n1.reshape(-1), f2, rng)
        n2 = n2.reshape(len(batch_nodes), f1, f2)
        g = self.graph
        return {
            "feats_b": g.feats[batch_nodes],
            "feats_n1": g.feats[n1],
            "feats_n2": g.feats[n2],
            "labels": g.labels[batch_nodes].astype(np.int32),
        }


def molecule_batch(n_graphs: int, n_nodes: int, n_edges: int, d_feat: int,
                   n_classes: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Batched small graphs with a global node id space + graph ids."""
    rng = np.random.default_rng(seed)
    offsets = np.arange(n_graphs)[:, None] * n_nodes
    edges = rng.integers(0, n_nodes, (n_graphs, n_edges, 2)) + offsets[..., None]
    return {
        "feats": rng.normal(0, 1, (n_graphs * n_nodes, d_feat)).astype(
            np.float32),
        "edges": edges.reshape(-1, 2).astype(np.int32),
        "graph_ids": np.repeat(np.arange(n_graphs), n_nodes).astype(np.int32),
        "labels": rng.integers(0, n_classes, n_graphs).astype(np.int32),
    }
