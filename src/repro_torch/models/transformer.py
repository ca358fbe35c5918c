"""The decoder LM family (gemma3-27b, qwen2.5-14b, nemotron-4-340b, and
the mixture-of-experts qwen3-moe-30b-a3b and dbrx-132b): GQA + RoPE
(+QK-norm, QKV-bias), sliding/global layer interleave, dense or MoE FFN
(``models/moe.py``, ``cfg.moe_impl``), squared-ReLU / SiLU / GeGLU MLPs,
remat, and the PQ-compressed retrieval head on the decode path (the
paper's technique applied to vocabulary scoring) — the reference's
``models/transformer.py``.  The MoE layers' load-balance losses are
summed over the layers into ``lm_hidden``'s aux; a decode step routes
its B tokens as one group, so they share each expert's capacity.

The parameter tree is the reference's.  With ``cfg.scan_layers`` every
layer leaf is stacked on a leading L axis (``params["layers"]`` is one
dict); without it ``params["layers"]`` is a list of per-layer dicts.
Caches follow the reference too: an all-global arch holds one stacked
(L, B, S, H, D) pair, a mixed sliding/global arch (gemma3) a per-layer
list whose sliding layers are rings of ``min(window, max_len)`` slots.
The decode step writes its new keys and values into them in place (the
reference returns new caches) and returns the same object.

Precision follows the reference's cast points: activations in
``cfg.dtype`` after the embedding, norms and softmaxes in float32, phi
cast to float32, and the PQ head's sub-embeddings in float32.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.core import retrieval_head, topk as topk_lib
from repro_torch.interop import to_device
from repro_torch.models import attention, layers, moe as moe_lib

Params = Dict[str, Any]

#: Head methods that score and select in one route (no (B, vocab) score
#: matrix is the route's output); the others score all, then take top-k.
TOP_ITEMS_HEADS = ("pqtopk_fused", "pqtopk_pruned", "pqtopk_approx")


class _GradCast(torch.autograd.Function):
    """Identity forward; the cotangent is cast to ``dtype`` in backward
    (the reference's ``custom_vjp`` that pins the backward residual stream
    to ``cfg.dtype``)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def _grad_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return _GradCast.apply(x, dtype)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(generator: torch.Generator, cfg: LMConfig) -> Params:
    dtype = _dtype(cfg.param_dtype)
    dev = generator.device
    p = {
        "attn": attention.attention_init(generator, cfg.attention,
                                         cfg.d_model, dtype),
        "ln1": layers.norm_init(cfg.d_model, cfg.norm, dtype, dev),
        "ln2": layers.norm_init(cfg.d_model, cfg.norm, dtype, dev),
    }
    if cfg.moe is None:
        p["mlp"] = layers.mlp_init(generator, cfg.d_model, cfg.d_ff,
                                   gated=cfg.gated_mlp, dtype=dtype)
    else:
        p["moe"] = moe_lib.moe_init(generator, cfg.moe, cfg.d_model,
                                    gated=cfg.gated_mlp, dtype=dtype)
    return p


def _stack(blocks: List[Params]) -> Params:
    """Per-layer trees -> one tree of (L, ...) leaves, freeing each
    layer's leaf as it is stacked."""
    out = {}
    for key in list(blocks[0]):
        parts = [blk.pop(key) for blk in blocks]
        out[key] = (_stack(parts) if isinstance(parts[0], dict)
                    else torch.stack(parts))
        del parts
    return out


def init_lm(generator: torch.Generator, cfg: LMConfig, *,
            device=None) -> Params:
    """Random weights with the reference's tree, shapes, scales and
    dtypes, drawn in float32 from ``generator`` on ``generator``'s device
    and cast to ``cfg.param_dtype`` (the PQ head stays float32), then
    moved to ``device`` (default: the generator's device).  A generator
    on the card draws a full-width model in seconds where the CPU takes
    minutes; a seed gives the same weights only on the same device.  The
    values differ from the reference's ``jax.random`` draws;
    ``interop.params_from_jax`` carries the reference's own weights
    over."""
    dtype = _dtype(cfg.param_dtype)
    blocks = [init_block(generator, cfg) for _ in range(cfg.n_layers)]
    p: Params = {
        "embed": layers.embedding_init(generator, cfg.vocab, cfg.d_model,
                                       dtype),
        "layers": _stack(blocks) if cfg.scan_layers else blocks,
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, dtype,
                                       generator.device),
    }
    if not cfg.tie_embeddings:
        p["head"] = layers.dense_init(generator, cfg.d_model, cfg.vocab,
                                      dtype=dtype)
    if cfg.pq_head is not None:
        p["pq_head"] = retrieval_head.init(generator, cfg.vocab, cfg.d_model,
                                           cfg.pq_head,
                                           device=generator.device)
    if device is not None:
        p = to_device(p, device)
    return p


def layer_types(cfg: LMConfig) -> np.ndarray:
    """Per-layer is_global flags (sliding/global interleave)."""
    return np.array([cfg.attention.layer_is_global(i)
                     for i in range(cfg.n_layers)])


def _layer(params: Params, cfg: LMConfig, i: int) -> Params:
    """Layer ``i``'s parameters (views into the stacked leaves)."""
    if not cfg.scan_layers:
        return params["layers"][i]

    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return take(params["layers"])


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _ffn(blk: Params, cfg: LMConfig, h: torch.Tensor):
    """The block's FFN on the normed h -> (out, load-balance aux: a
    float32 0-d tensor, or 0.0 for a dense FFN)."""
    if cfg.moe is None:
        return layers.mlp(blk["mlp"], h, cfg.act), 0.0
    return moe_lib.moe_ffn(blk["moe"], cfg.moe, h, cfg.act,
                           impl=cfg.moe_impl)


def _block_fwd(blk: Params, cfg: LMConfig, x: torch.Tensor,
               is_global: bool):
    x = _grad_cast(x, _dtype(cfg.dtype))
    h = layers.apply_norm(blk["ln1"], x, cfg.norm)
    h = attention.full_attention(blk["attn"], cfg.attention, h,
                                 is_global=is_global, causal=cfg.causal)
    x = x + h
    h, aux = _ffn(blk, cfg, layers.apply_norm(blk["ln2"], x, cfg.norm))
    return x + h, aux


def lm_hidden(params: Params, tokens: torch.Tensor, cfg: LMConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (hidden (B, S, d), aux_loss summed over the
    layers).  With ``cfg.remat`` each layer's activations are recomputed
    in backward (``torch.utils.checkpoint``), which moves no number."""
    x = params["embed"]["table"][tokens].to(_dtype(cfg.dtype))
    flags = layer_types(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        blk = _layer(params, cfg, i)
        if remat:
            x, a = checkpoint(_block_fwd, blk, cfg, x, bool(flags[i]),
                              use_reentrant=False)
        else:
            x, a = _block_fwd(blk, cfg, x, bool(flags[i]))
        aux = aux + a
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return x, aux


def unembed(params: Params, hidden: torch.Tensor, cfg: LMConfig
            ) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = params["embed"]["table"].to(hidden.dtype)          # (V, d)
        return hidden @ w.T
    return layers.dense(params["head"], hidden)


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: LMConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal-LM cross entropy."""
    hidden, aux = lm_hidden(params, batch["tokens"], cfg)
    logits = unembed(params, hidden, cfg).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        batch["targets"].long()[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with the PQ head
# ---------------------------------------------------------------------------

def _uniform_layers(cfg: LMConfig) -> bool:
    return bool(layer_types(cfg).all()) and cfg.scan_layers


def init_caches(cfg: LMConfig, batch: int, max_len: int, *, device="cpu"):
    """KV caches in ``cfg.dtype``: one stacked (L, B, S, H, D) pair for an
    all-global arch with stacked layers, else a per-layer list (sliding
    layers get a ring of ``min(window, max_len)`` slots)."""
    dtype = _dtype(cfg.dtype)
    if _uniform_layers(cfg):
        a = cfg.attention
        shape = (cfg.n_layers, batch, max_len, a.n_kv_heads, a.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    flags = layer_types(cfg)
    return [attention.init_cache(batch, max_len, cfg.attention,
                                 is_global=bool(flags[i]), dtype=dtype,
                                 device=device)
            for i in range(cfg.n_layers)]


def _layer_cache(caches, cfg: LMConfig, i: int) -> Dict[str, torch.Tensor]:
    if _uniform_layers(cfg):
        return {"k": caches["k"][i], "v": caches["v"][i]}
    return caches[i]


def _decode_backbone(params: Params, token: torch.Tensor, pos, caches,
                     cfg: LMConfig) -> torch.Tensor:
    """Embed ``token`` (B,), run every layer against its cache at ``pos``
    (the caches are written in place) -> phi (B, d) float32."""
    x = params["embed"]["table"][token[:, None]].to(_dtype(cfg.dtype))
    flags = layer_types(cfg)
    for i in range(cfg.n_layers):
        blk = _layer(params, cfg, i)
        h = layers.apply_norm(blk["ln1"], x, cfg.norm)
        h, _ = attention.decode_attend(blk["attn"], cfg.attention, h,
                                       _layer_cache(caches, cfg, i), pos,
                                       bool(flags[i]))
        x = x + h
        x = x + _ffn(blk, cfg, layers.apply_norm(blk["ln2"], x, cfg.norm))[0]
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return x[:, 0, :].float()


def _decode_head(params: Params, phi: torch.Tensor, cfg: LMConfig, k: int,
                 head_method: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vocabulary scoring and top-k of phi -> (ids (B, k) int32, scores
    (B, k) float32): the dense unembedding (``"dense"``, the baseline) or
    the PQ head by ``head_method``."""
    if head_method == "dense":
        w = (params["embed"]["table"] if cfg.tie_embeddings
             else params["head"]["w"].T)                        # (V, d)
        vals, ids = topk_lib.topk(phi @ w.float().T, k)
    elif head_method in TOP_ITEMS_HEADS:
        vals, ids = retrieval_head.top_items(params["pq_head"], phi, k,
                                             method=head_method,
                                             pq_cfg=cfg.pq_head)
    else:
        vals, ids = topk_lib.topk(
            retrieval_head.score_all(params["pq_head"], phi, head_method), k)
    return ids, vals


def lm_decode_step(params: Params, token: torch.Tensor, pos, caches,
                   cfg: LMConfig, *, k: int = 64,
                   head_method: str = "pqtopk"):
    """One decode step.  token (B,), ``pos`` a scalar (an int or a 0-d
    tensor).  -> (topk_ids (B, k), topk_scores (B, k), caches), the caches
    written in place.  ``pqtopk_fused`` launches the fused kernel's form
    (a) once on the card; ``pqtopk_pruned`` runs the pruned cascade on the
    head's ``"pruned"`` state, built once at init."""
    phi = _decode_backbone(params, token, pos, caches, cfg)
    ids, vals = _decode_head(params, phi, cfg, k, head_method)
    return ids, vals, caches


def lm_prefill(params: Params, tokens: torch.Tensor, cfg: LMConfig
               ) -> torch.Tensor:
    """Prefill: full forward returning the last position's hidden state
    (the decode engine fills its caches incrementally)."""
    hidden, _ = lm_hidden(params, tokens, cfg)
    return hidden[:, -1, :]
