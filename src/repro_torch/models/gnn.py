"""GraphSAGE [arXiv:1706.02216] — mean aggregator, full-batch and sampled:
the reference's ``models/gnn.py`` as plain functions on parameter dicts.

Messages ``h[src]`` are gathered and added into their ``dst`` rows with
``index_add`` (the reference's ``segment_sum``), whose backward keeps only
the ids, not the messages.  On the CPU the adds run in edge order, as the
reference's do; on the card ``index_add`` adds float32 with atomics in no
fixed order, so a full-batch forward there is held to the CPU within a
float32 tolerance, not to its bits.  Three forward modes:

* full-batch (``gnn_forward``, ``gnn_loss``): edges (E, 2) + features
  (N, F), the loss over the nodes ``label_mask`` marks;
* sampled minibatch (``gnn_minibatch_forward``, ``gnn_minibatch_loss``):
  the 2-layer fanout tensors of ``data.graph.NeighborSampler``;
* batched small graphs (``gnn_graph_batch_loss``): the edge-list path,
  then a mean over each graph's nodes.

Every layer is ``relu(w_self(h) + w_neigh(mean of neighbours))``, then an
L2 normalisation whose norm is clamped at 1e-6; ``w_self`` and ``out``
carry a bias, ``w_neigh`` does not.  The norm is the reference's
``sqrt(sum(h^2))``, whose gradient at an all-zero row is NaN in both.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.interop import to_device
from repro_torch.models import layers
from repro_torch.training import tree as tree_lib

Params = Dict[str, Any]


def init_gnn(generator: torch.Generator, cfg: GNNConfig, d_feat: int, *,
             device=None) -> Params:
    """The reference's tree (``layers`` a list of ``w_self``/``w_neigh``
    dicts, then ``out``), drawn in float32 on the generator's device, cast
    to ``cfg.param_dtype`` and moved to ``device`` (default: the
    generator's)."""
    dtype = getattr(torch, cfg.param_dtype)
    lyrs = []
    d_in = d_feat
    for _ in range(cfg.n_layers):
        lyrs.append({
            "w_self": layers.dense_init(generator, d_in, cfg.d_hidden,
                                        bias=True, dtype=dtype),
            "w_neigh": layers.dense_init(generator, d_in, cfg.d_hidden,
                                         dtype=dtype),
        })
        d_in = cfg.d_hidden
    p = {"layers": lyrs,
         "out": layers.dense_init(generator, cfg.d_hidden, cfg.n_classes,
                                  bias=True, dtype=dtype)}
    return to_device(p, device) if device is not None else p


def abstract_gnn(cfg: GNNConfig, d_feat: int) -> Params:
    """:func:`init_gnn`'s tree on meta: no storage, no draw."""
    return tree_lib.eval_shape(init_gnn, torch.Generator(), cfg, d_feat)


class _SegmentSum(torch.autograd.Function):
    """Rows of ``x`` added into ``n`` rows at ``ids``; the backward
    gathers the rows back and keeps only ``ids`` (``index_add``'s own
    backward keeps ``x``: at ogb_products' second layer 31.7 GB of
    messages, held until the backward that then needs as much again)."""

    @staticmethod
    def forward(ctx, x, ids, n):
        ctx.save_for_backward(ids)
        return x.new_zeros((n,) + x.shape[1:]).index_add_(0, ids, x)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        return g.index_select(0, ids), None, None


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return _SegmentSum.apply(x, ids, n)


def _aggregate(h: torch.Tensor, edges: torch.Tensor, n_nodes: int,
               aggregator: str) -> torch.Tensor:
    """Mean (or sum) of the neighbours' features: h[src] added into dst."""
    src, dst = edges[:, 0], edges[:, 1]
    msgs = constrain(h[src], "edge_feats")
    agg = _segment_sum(msgs, dst, n_nodes)
    if aggregator == "mean":
        deg = _segment_sum(torch.ones_like(dst, dtype=h.dtype), dst, n_nodes)
        agg = agg / deg.clamp_min(1.0)[:, None]
    return agg


def _sage(lyr: Params, h_self: torch.Tensor, h_neigh: torch.Tensor
          ) -> torch.Tensor:
    h = F.relu(layers.dense(lyr["w_self"], h_self)
               + layers.dense(lyr["w_neigh"], h_neigh))
    return h / torch.sqrt((h * h).sum(-1, keepdim=True)).clamp_min(1e-6)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross entropy of float32 logits at int labels."""
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, 1, labels.long()[:, None])[:, 0]


def gnn_forward(params: Params, feats: torch.Tensor, edges: torch.Tensor,
                cfg: GNNConfig) -> torch.Tensor:
    """Full-batch forward.  feats (N, F), edges (E, 2) -> logits (N, C)."""
    h = feats
    for lyr in params["layers"]:
        h = _sage(lyr, h, _aggregate(h, edges, feats.shape[0],
                                     cfg.aggregator))
    return layers.dense(params["out"], h)


def gnn_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: GNNConfig,
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-batch node-classification CE over the ``label_mask`` nodes."""
    logits = gnn_forward(params, batch["feats"], batch["edges"], cfg).float()
    mask = batch["label_mask"].float()
    nll = ((_nll(logits, batch["labels"]) * mask).sum()
           / mask.sum().clamp_min(1.0))
    return nll, {"nll": nll}


def gnn_minibatch_forward(params: Params, feats_b: torch.Tensor,
                          feats_n1: torch.Tensor, feats_n2: torch.Tensor,
                          cfg: GNNConfig) -> torch.Tensor:
    """2-layer sampled GraphSAGE.  feats_b (B, F) batch nodes, feats_n1
    (B, f1, F) their neighbours, feats_n2 (B, f1, f2, F) 2-hop -> logits
    (B, C)."""
    l1, l2 = params["layers"][0], params["layers"][1]
    h1_n1 = _sage(l1, feats_n1, feats_n2.mean(2))     # (B, f1, d)
    h1_b = _sage(l1, feats_b, feats_n1.mean(1))       # (B, d)
    h2_b = _sage(l2, h1_b, h1_n1.mean(1))             # (B, d)
    return layers.dense(params["out"], h2_b)


def gnn_minibatch_loss(params: Params, batch: Dict[str, torch.Tensor],
                       cfg: GNNConfig
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = gnn_minibatch_forward(params, batch["feats_b"],
                                   batch["feats_n1"], batch["feats_n2"],
                                   cfg).float()
    nll = _nll(logits, batch["labels"]).mean()
    return nll, {"nll": nll}


def gnn_graph_batch_loss(params: Params, batch: Dict[str, torch.Tensor],
                         cfg: GNNConfig
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """feats (G*n, F), edges (G*e, 2) with global node ids, graph_ids
    (G*n,), labels (G,): graph classification on each graph's mean node."""
    n_total = batch["feats"].shape[0]
    n_graphs = batch["labels"].shape[0]
    h = batch["feats"]
    for lyr in params["layers"]:
        h = _sage(lyr, h, _aggregate(h, batch["edges"], n_total,
                                     cfg.aggregator))
    gid = batch["graph_ids"]
    pooled = _segment_sum(h, gid, n_graphs)
    cnt = _segment_sum(torch.ones((n_total,), dtype=h.dtype,
                                  device=h.device), gid, n_graphs)
    pooled = pooled / cnt.clamp_min(1.0)[:, None]
    logits = layers.dense(params["out"], pooled).float()
    nll = _nll(logits, batch["labels"]).mean()
    return nll, {"nll": nll}
