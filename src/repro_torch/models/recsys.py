"""RecSys CTR/retrieval models: DCN-v2, BST, DIEN (AUGRU), FM — the
reference's ``models/recsys.py``: the click loss and the serving paths.

All four share the embedding substrate (:mod:`.embedding`) and a PQ item
catalogue for the ``retrieval_cand`` path, where the user-side query is
scored against the catalogue with PQTopK (:func:`retrieve_topk`).  The
reference's sharding constraints sit at the same points
(:func:`~repro_torch.distributed.sharding.constrain`: values unchanged).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import AttentionConfig, RecsysConfig
from repro_torch.core import retrieval_head
from repro_torch.distributed.sharding import constrain
from repro_torch.interop import to_device
from repro_torch.models import attention as attn_lib, embedding, layers
from repro_torch.training import tree as tree_lib
from repro_torch.training.losses import bce_with_logits

Params = Dict[str, Any]
KINDS = ("dcn", "bst", "dien", "fm")


def _bst_attn_cfg(cfg: RecsysConfig, d_tok: int) -> AttentionConfig:
    return AttentionConfig(n_heads=cfg.n_heads, n_kv_heads=cfg.n_heads,
                           head_dim=max(d_tok // cfg.n_heads, 8))


# ---------------------------------------------------------------------------
# shared init
# ---------------------------------------------------------------------------

def _mlp_tower_init(generator: torch.Generator, d_in: int, widths) -> list:
    tower = []
    prev = d_in
    for w in widths:
        tower.append(layers.dense_init(generator, prev, w, bias=True))
        prev = w
    tower.append(layers.dense_init(generator, prev, 1, bias=True))
    return tower


def _mlp_tower(tower: list, x: torch.Tensor) -> torch.Tensor:
    for p in tower[:-1]:
        x = torch.relu(layers.dense(p, x))
    return layers.dense(tower[-1], x)[..., 0]


def init_recsys(generator: torch.Generator, cfg: RecsysConfig, *,
                device="cuda", codes=None, centroids=None) -> Params:
    """Random weights with the reference's tree and scales, drawn on the
    CPU from ``generator`` (so a seed gives the same weights on any
    device), then moved to ``device``.  The values differ from the
    reference's ``jax.random`` draws; ``interop.params_from_jax`` carries
    the reference's own weights over."""
    if cfg.kind not in KINDS:
        raise ValueError(cfg.kind)
    if cfg.param_dtype != "float32":
        raise ValueError(f"param_dtype {cfg.param_dtype!r}: only float32 "
                         "recsys weights are ported")
    dev = resolve_device(device)
    p: Params = {"emb": embedding.init_tables(generator, cfg.table_rows,
                                              cfg.embed_dim)}
    d_emb = cfg.n_sparse * cfg.embed_dim
    if cfg.kind == "dcn":
        d0 = cfg.n_dense + d_emb
        p["cross"] = [layers.dense_init(generator, d0, d0, bias=True)
                      for _ in range(cfg.n_cross_layers)]
        p["mlp"] = _mlp_tower_init(generator, d0, cfg.mlp)
        p["user_proj"] = layers.dense_init(generator, d0, cfg.embed_dim)
    elif cfg.kind == "bst":
        d_tok = d_emb                                # item+cate per position
        acfg = _bst_attn_cfg(cfg, d_tok)
        p["blocks"] = [{
            "attn": attn_lib.attention_init(generator, acfg, d_tok),
            "ln1": layers.norm_init(d_tok, "layernorm"),
            "ln2": layers.norm_init(d_tok, "layernorm"),
            "mlp": layers.mlp_init(generator, d_tok, 4 * d_tok, gated=False),
        } for _ in range(cfg.n_blocks)]
        p["pos_emb"] = layers.embedding_init(generator, cfg.seq_len + 1,
                                             d_tok)
        p["mlp"] = _mlp_tower_init(generator, d_tok * (cfg.seq_len + 1),
                                   cfg.mlp)
    elif cfg.kind == "dien":
        d_in = d_emb                                 # item+cate concat
        p["gru"] = _gru_init(generator, d_in, cfg.gru_dim)
        p["augru"] = _gru_init(generator, cfg.gru_dim, cfg.gru_dim)
        p["att"] = layers.dense_init(generator, cfg.gru_dim, d_in)
        p["mlp"] = _mlp_tower_init(generator, cfg.gru_dim + d_in, cfg.mlp)
    else:
        p["linear"] = {"w": [torch.zeros((r,)) for r in cfg.table_rows],
                       "b": torch.zeros(())}
    if cfg.pq is not None:
        # PQ item catalogue for retrieval_cand (query dim = embed_dim).
        p["item_emb"] = retrieval_head.init(generator, cfg.n_items,
                                            cfg.embed_dim, cfg.pq,
                                            codes=codes, centroids=centroids)
    return to_device(p, dev)


def abstract_recsys(cfg: RecsysConfig) -> Params:
    """:func:`init_recsys`'s tree on meta: no storage, no draw."""
    return tree_lib.eval_shape(init_recsys, torch.Generator(), cfg,
                               device="cpu")


def batch_tensors(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                                torch.Tensor]:
    """A ``ctr_batch`` of numpy arrays as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# GRU / AUGRU (DIEN)
# ---------------------------------------------------------------------------

def _gru_init(generator: torch.Generator, d_in: int, d_h: int) -> Params:
    scale = (d_in + d_h) ** -0.5
    wx = torch.randn((d_in, 3 * d_h), generator=generator) * scale
    wh = torch.randn((d_h, 3 * d_h), generator=generator) * scale
    return {"wx": wx, "wh": wh, "b": torch.zeros((3 * d_h,))}


def _gru_cell(p: Params, h: torch.Tensor, x: torch.Tensor,
              a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's cell, not ``torch.nn.GRU``'s: the whole bias sits
    outside the reset gate, ``n = tanh(x_n + h_n + b_n + (r - 1) h_n)``.
    AUGRU scales the update gate by the attention weight ``a``."""
    d_h = h.shape[-1]
    hw = h @ p["wh"]
    gates = x @ p["wx"] + hw + p["b"]
    r, z, n = gates.split(d_h, dim=-1)
    r, z = torch.sigmoid(r), torch.sigmoid(z)
    n = torch.tanh(n + (r - 1.0) * hw[..., 2 * d_h:])
    if a is not None:                      # AUGRU: attention-scaled update
        z = z * a[..., None]
    return (1.0 - z) * n + z * h


def gru_scan(p: Params, xs: torch.Tensor,
             att: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xs (B, S, d_in) -> all hidden states (B, S, d_h)."""
    h = torch.zeros((xs.shape[0], p["wh"].shape[0]), dtype=xs.dtype,
                    device=xs.device)
    hs = []
    for t in range(xs.shape[1]):
        h = _gru_cell(p, h, xs[:, t], None if att is None else att[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1)


# ---------------------------------------------------------------------------
# forward per kind: pointwise CTR score
# ---------------------------------------------------------------------------

def _dcn_x0(params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    emb = embedding.lookup_fields(params["emb"], batch["sparse"])
    return torch.cat([batch["dense"].to(emb.dtype),
                      emb.reshape(emb.shape[0], -1)], dim=-1)


def _seq_emb(params: Params, seq: torch.Tensor) -> torch.Tensor:
    """(B, S, 2) (item, category) ids -> (B, S, 2 * embed_dim)."""
    b, s = seq.shape[:2]
    return embedding.lookup_fields(params["emb"],
                                   seq.reshape(-1, 2)).reshape(b, s, -1)


def ctr_logits(params: Params, batch: Dict[str, torch.Tensor],
               cfg: RecsysConfig) -> torch.Tensor:
    """Pointwise (user, item) scoring -> logit (B,)."""
    if cfg.kind == "dcn":
        x0 = constrain(_dcn_x0(params, batch), "hidden")
        x = x0
        for cp in params["cross"]:
            x = x0 * layers.dense(cp, x) + x      # DCN-v2 cross layer
        return _mlp_tower(params["mlp"], x)
    if cfg.kind == "bst":
        # behaviour sequence (B, S, 2) ids + target (B, 2): embed, concat
        # fields per position, append target, transformer, MLP.
        x = _bst_tokens(params, batch["seq"], batch["target"])
        acfg = _bst_attn_cfg(cfg, x.shape[-1])
        for blk in params["blocks"]:
            h = layers.apply_norm(blk["ln1"], x, "layernorm")
            x = x + attn_lib.full_attention(blk["attn"], acfg, h,
                                            causal=False)
            h = layers.apply_norm(blk["ln2"], x, "layernorm")
            x = x + layers.mlp(blk["mlp"], h, "relu")
        return _mlp_tower(params["mlp"], x.reshape(x.shape[0], -1))
    if cfg.kind == "dien":
        seq_emb = _seq_emb(params, batch["seq"])            # (B, S, 2*emb)
        b = seq_emb.shape[0]
        tgt_emb = embedding.lookup_fields(params["emb"],
                                          batch["target"]).reshape(b, -1)
        hs = gru_scan(params["gru"], seq_emb)           # interest extraction
        att_logits = torch.einsum("bsd,bd->bs",
                                  layers.dense(params["att"], hs), tgt_emb)
        att = torch.softmax(att_logits, dim=-1)
        hs2 = gru_scan(params["augru"], hs, att)        # interest evolution
        x = torch.cat([hs2[:, -1, :], tgt_emb], dim=-1)
        return _mlp_tower(params["mlp"], x)
    if cfg.kind == "fm":
        emb = embedding.lookup_fields(params["emb"], batch["sparse"])
        sum_v = emb.sum(1)
        sum_sq = emb.square().sum(1)
        pairwise = 0.5 * (sum_v.square() - sum_sq).sum(-1)
        lin = params["linear"]["b"].to(pairwise.dtype)
        for i, w in enumerate(params["linear"]["w"]):
            lin = lin + w[batch["sparse"][:, i]]
        return lin + pairwise
    raise ValueError(cfg.kind)


def ctr_loss(params: Params, batch: Dict[str, torch.Tensor],
             cfg: RecsysConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean binary cross-entropy of the click logits."""
    loss = bce_with_logits(ctr_logits(params, batch, cfg).float(),
                           batch["label"].float())
    return loss, {"bce": loss}


def _bst_tokens(params: Params, seq: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    seq_emb = _seq_emb(params, seq)
    b, s = seq_emb.shape[:2]
    tgt_emb = embedding.lookup_fields(params["emb"], target).reshape(b, 1, -1)
    x = torch.cat([seq_emb, tgt_emb], dim=1)            # (B, S+1, d_tok)
    return x + params["pos_emb"]["table"][None, :s + 1].to(x.dtype)


# ---------------------------------------------------------------------------
# retrieval: PQTopK over the item catalogue (paper technique)
# ---------------------------------------------------------------------------

def user_query(params: Params, batch: Dict[str, torch.Tensor],
               cfg: RecsysConfig) -> torch.Tensor:
    """User-side query vector in item-embedding space (B, embed_dim)."""
    if cfg.kind == "dcn":
        return layers.dense(params["user_proj"],
                            _dcn_x0(params, batch)).float()
    if cfg.kind == "bst":
        seq_emb = _seq_emb(params, batch["seq"])
        b, s = seq_emb.shape[:2]
        # Mean-pooled history, item-field half only.
        return seq_emb.reshape(b, s, 2, -1)[:, :, 0, :].mean(1).float()
    if cfg.kind == "dien":
        hs = gru_scan(params["gru"], _seq_emb(params, batch["seq"]))
        # Final interest state projected onto the item half via att weights.
        return layers.dense(params["att"],
                            hs[:, -1, :])[:, :cfg.embed_dim].float()
    if cfg.kind == "fm":
        emb = embedding.lookup_fields(params["emb"], batch["sparse"])
        return emb.sum(1).float()         # FM user-side sum of factors
    raise ValueError(cfg.kind)


def retrieve_topk(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: RecsysConfig, *, k: int = 10, method: str = "pqtopk"):
    """retrieval_cand path: PQTopK over the n_items catalogue.  Returns
    ``(ids, vals)``, the reverse of ``retrieval_head.top_items``."""
    phi = constrain(user_query(params, batch, cfg), "hidden")
    vals, ids = retrieval_head.top_items(params["item_emb"], phi, k,
                                         method=method)
    return ids, vals
