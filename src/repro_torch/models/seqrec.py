"""SASRec / gBERT4Rec backbones with the RecJPQ item layer — the
reference's ``models/seqrec.py`` (its abstract, shape-only init aside).

Item id 0 is padding; real items are 1..n_items.  The PQ embedding is
shared between the input layer and the scoring head (as in RecJPQ).
Training uses gBCE with uniform negative sampling [gSASRec, RecSys'23] so
large catalogues are trainable; serving scores the full catalogue through
any of the paper's scoring algorithms.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import AttentionConfig, SeqRecConfig
from repro_torch.core import retrieval_head
from repro_torch.distributed.sharding import constrain
from repro_torch.interop import to_device
from repro_torch.models import attention as attn_lib, layers
from repro_torch.training import tree as tree_lib

Params = Dict[str, Any]


def _attn_cfg(cfg: SeqRecConfig) -> AttentionConfig:
    return AttentionConfig(n_heads=cfg.n_heads, n_kv_heads=cfg.n_heads,
                           head_dim=cfg.d_model // cfg.n_heads)


def init_seqrec(generator: torch.Generator, cfg: SeqRecConfig, *,
                device="cpu", codes=None, centroids=None) -> Params:
    """Random weights with the reference's tree and scales, drawn on the
    CPU from ``generator`` (so a seed gives the same weights on any
    device), then moved to ``device``.  The values differ from the
    reference's ``jax.random`` draws; ``interop.params_from_jax`` carries
    the reference's own weights over."""
    if cfg.param_dtype != "float32":
        raise ValueError(f"param_dtype {cfg.param_dtype!r}: only float32 "
                         "seqrec weights are ported")
    acfg = _attn_cfg(cfg)
    blocks = [{
        "attn": attn_lib.attention_init(generator, acfg, cfg.d_model),
        "ln1": layers.norm_init(cfg.d_model, "layernorm"),
        "ln2": layers.norm_init(cfg.d_model, "layernorm"),
        "mlp": layers.mlp_init(generator, cfg.d_model, cfg.d_ff, gated=False),
    } for _ in range(cfg.n_blocks)]
    p: Params = {
        # +1 row for padding id 0.
        "item_emb": retrieval_head.init(generator, cfg.n_items + 1,
                                        cfg.d_model, cfg.pq, codes=codes,
                                        centroids=centroids),
        "pos_emb": layers.embedding_init(generator, cfg.max_seq_len,
                                         cfg.d_model),
        "final_norm": layers.norm_init(cfg.d_model, "layernorm"),
        "blocks": blocks,
    }
    if cfg.backbone == "bert4rec":
        p["mask_emb"] = torch.randn((cfg.d_model,), generator=generator) * 0.02
    return to_device(p, device)


def abstract_seqrec(cfg: SeqRecConfig) -> Params:
    """:func:`init_seqrec`'s tree on meta: no storage, no draw."""
    return tree_lib.eval_shape(init_seqrec, torch.Generator(), cfg)


def _encode(params: Params, x: torch.Tensor, cfg: SeqRecConfig,
            causal: bool) -> torch.Tensor:
    acfg = _attn_cfg(cfg)
    for blk in params["blocks"]:
        h = layers.apply_norm(blk["ln1"], x, "layernorm")
        x = x + attn_lib.full_attention(blk["attn"], acfg, h, causal=causal)
        h = layers.apply_norm(blk["ln2"], x, "layernorm")
        x = x + layers.mlp(blk["mlp"], h, "gelu")
    return layers.apply_norm(params["final_norm"], x, "layernorm")


def _embed_seq(params: Params, seq: torch.Tensor) -> torch.Tensor:
    x = retrieval_head.embed(params["item_emb"], seq)
    return x * (seq != 0)[..., None].to(x.dtype)


def seqrec_hidden(params: Params, item_seq: torch.Tensor, cfg: SeqRecConfig,
                  ) -> torch.Tensor:
    """item_seq (B, S) int (0 = pad) -> hidden (B, S, d)."""
    s = item_seq.shape[1]
    x = _embed_seq(params, item_seq)
    x = x + params["pos_emb"]["table"][None, :s].to(x.dtype)
    x = constrain(x, "seq_hidden")
    return _encode(params, x, cfg, causal=cfg.backbone == "sasrec")


# ---------------------------------------------------------------------------
# training: gBCE with uniform negatives
# ---------------------------------------------------------------------------

def gbce_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
              mask: torch.Tensor, n_items: int, n_negatives: int,
              t: float) -> torch.Tensor:
    """Generalised BCE [gSASRec].  beta = alpha*(t*(1-1/alpha)+1/alpha),
    sigma^beta(s+) applied via logits: log(sigma^beta(s)) = beta*logsigmoid(s)."""
    alpha = n_negatives / max(n_items - 1, 1)
    beta = alpha * (t * (1.0 - 1.0 / alpha) + 1.0 / alpha)
    pos = beta * F.logsigmoid(pos_scores)                         # (B, S)
    neg = F.logsigmoid(-neg_scores).sum(-1)                       # (B, S)
    per_pos = -(pos + neg)
    denom = mask.sum().clamp(min=1.0)
    return (per_pos * mask).sum() / denom


def seqrec_loss(params: Params, batch: Dict[str, torch.Tensor],
                cfg: SeqRecConfig) -> Tuple[torch.Tensor,
                                            Dict[str, torch.Tensor]]:
    """batch: input_seq (B,S), targets (B,S), negatives (B,S,n_neg) — all
    item ids (0 pad).  SASRec: next-item at every position; BERT4Rec: the
    data pipeline pre-masks inputs and sets targets only at masked slots
    (so ``mask_emb`` takes no gradient here, as in the reference)."""
    hidden = seqrec_hidden(params, batch["input_seq"], cfg).float()
    emb = params["item_emb"]
    pos_emb = retrieval_head.embed(emb, batch["targets"]).float()
    neg_emb = retrieval_head.embed(emb, batch["negatives"]).float()
    pos_scores = torch.einsum("bsd,bsd->bs", hidden, pos_emb)
    neg_scores = torch.einsum("bsd,bsnd->bsn", hidden, neg_emb)
    mask = (batch["targets"] != 0).float()
    loss = gbce_loss(pos_scores, neg_scores, mask, cfg.n_items,
                     cfg.n_negatives, cfg.gbce_t)
    return loss, {"nll": loss}


def sequence_embedding(params: Params, item_seq: torch.Tensor,
                       cfg: SeqRecConfig) -> torch.Tensor:
    """phi for each user: the last position (SASRec), or a [MASK] slot
    appended after the history shifted left (BERT4Rec)."""
    if cfg.backbone == "bert4rec":
        seq = torch.cat([item_seq[:, 1:], torch.zeros_like(item_seq[:, :1])],
                        dim=1)
        x = _embed_seq(params, seq)
        x = torch.cat([x[:, :-1], params["mask_emb"].to(x.dtype)
                       .expand(x.shape[0], 1, -1)], dim=1)
        x = x + params["pos_emb"]["table"][None, :seq.shape[1]].to(x.dtype)
        return _encode(params, x, cfg, causal=False)[:, -1, :].float()
    return seqrec_hidden(params, item_seq, cfg)[:, -1, :].float()


def serve_topk(params: Params, item_seq: torch.Tensor, cfg: SeqRecConfig, *,
               k: int = 10, method: str = "pqtopk", sharded_mesh=None,
               ladder=None, pin_rung: bool = False, return_rung: bool = False):
    """Full serving path: backbone -> phi -> scoring -> TopK (Table 3).
    -> (ids (B,k) int32, scores (B,k) f32[, rung]).

    ``sharded_mesh`` (a ``launch.mesh.ShardMesh``): item-sharded retrieval,
    shard-local scoring and an O(k x shards) merge on the mesh's lead
    device.  ``ladder``/``pin_rung``/``return_rung`` apply to
    ``method="pqtopk_pruned"`` only: the cascade's slot budgets, its
    cheapest-rung degraded mode (flat only), and whether to also return
    the rung taken (the engine tallies it into ``rung_hit_fraction``)."""
    if method != "pqtopk_pruned" and return_rung:
        raise ValueError("return_rung is only meaningful for the pruned "
                         "cascade (method='pqtopk_pruned')")
    if pin_rung and sharded_mesh is not None:
        raise ValueError("pin_rung is not threaded through the sharded "
                         "cascade; degrade the flat replicas instead")
    with tracing.span("model.backbone"):
        phi = constrain(sequence_embedding(params, item_seq, cfg), "phi")
    with tracing.span("model.head"):
        if sharded_mesh is not None:
            if method == "pqtopk_pruned" and return_rung:
                vals, ids, stats = retrieval_head.top_items_pruned_sharded(
                    params["item_emb"], phi, k, sharded_mesh, pq_cfg=cfg.pq,
                    ladder=ladder, return_stats=True)
                return ids, vals, stats["rung_hit"]
            vals, ids = retrieval_head.top_items_sharded(
                params["item_emb"], phi, k, sharded_mesh, method=method,
                pq_cfg=cfg.pq, ladder=ladder)
            return ids, vals
        out = retrieval_head.top_items(params["item_emb"], phi, k,
                                       method=method, pq_cfg=cfg.pq,
                                       ladder=ladder, pin_rung=pin_rung,
                                       return_rung=return_rung)
    if return_rung:
        vals, ids, rung = out
        return ids, vals, rung
    vals, ids = out
    return ids, vals
