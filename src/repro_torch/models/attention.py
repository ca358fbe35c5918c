"""GQA attention in plain tensor ops: the chunked (online-softmax) path for
a full sequence, with an optional sliding window and QK-norm, and the
KV-cache decode path.

``chunked_attention`` is the reference's online-softmax form (a loop over
KV chunks carrying the running max, normaliser and accumulator), so the
two packages take the same steps.  Masked scores are -1e30, and there is
no key-padding mask: left-padded positions take part in attention, as
they do in the reference.

The reference's traced-window form (``_chunked_attention_dyn_window``,
run when the layer type is a traced flag inside its layer scan) masks
with an effective window of ``s + 1`` on global layers.  Here the layer
type is always a Python bool, so ``chunked_attention(window=...)`` serves
both: ``window=s + 1`` gives that form's mask, ``window=0`` none, and the
two agree because no causal key lies ``s + 1`` positions back.

Decode (:func:`decode_attend`) writes the new key and value into the
cache in place and attends over every cache slot with the reference's
mask.  It reads the cache in slices of ``DEFAULT_KV_CHUNK`` slots, each
cast to
float32 (heads first, in the same copy) on its own, so the reference's
float32 arithmetic never needs a float32 copy of a whole (bfloat16)
cache.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionConfig
from repro_torch.models import layers

Params = Dict[str, Any]

DEFAULT_KV_CHUNK = 1024
NEG_INF = -1e30


def attention_init(generator: torch.Generator, cfg: AttentionConfig,
                   d_model: int, dtype: torch.dtype = torch.float32
                   ) -> Params:
    q_dim = cfg.n_heads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    p = {
        "wq": layers.dense_init(generator, d_model, q_dim, bias=cfg.qkv_bias,
                                dtype=dtype),
        "wk": layers.dense_init(generator, d_model, kv_dim,
                                bias=cfg.qkv_bias, dtype=dtype),
        "wv": layers.dense_init(generator, d_model, kv_dim,
                                bias=cfg.qkv_bias, dtype=dtype),
        "wo": layers.dense_init(generator, q_dim, d_model, dtype=dtype,
                                scale=q_dim ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.norm_init(cfg.head_dim, "rmsnorm", dtype,
                                       generator.device)
        p["k_norm"] = layers.norm_init(cfg.head_dim, "rmsnorm", dtype,
                                       generator.device)
    return p


def _project_qkv(p: Params, cfg: AttentionConfig, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v (B, S, H, D), QK-normed when the config says so.  RoPE is
    applied to q and k even for SASRec, which also adds learned position
    embeddings — as the reference does."""
    b, s, _ = x.shape
    q = layers.dense(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = layers.dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = layers.dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = layers.apply_norm(p["q_norm"], q, "rmsnorm")
        k = layers.apply_norm(p["k_norm"], k, "rmsnorm")
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      kv_chunk: int = DEFAULT_KV_CHUNK) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); Hq = Hkv * G.  ``window >
    0`` limits attention to the last ``window`` positions (inclusive of
    self)."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, d).float() * (d ** -0.5)
    kv_chunk = min(kv_chunk, sk)
    n_chunks = -(-sk // kv_chunk)
    pad = n_chunks * kv_chunk - sk
    kp = F.pad(k, (0, 0, 0, 0, 0, pad)).float()
    vp = F.pad(v, (0, 0, 0, 0, 0, pad)).float()
    q_pos = torch.arange(sq, device=dev)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        k_i = kp[:, c * kv_chunk:(c + 1) * kv_chunk]
        v_i = vp[:, c * kv_chunk:(c + 1) * kv_chunk]
        k_pos = c * kv_chunk + torch.arange(kv_chunk, device=dev)
        s_blk = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_i)
        mask = (k_pos[None, :] < sk).expand(sq, kv_chunk)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        s_blk = torch.where(mask, s_blk, NEG_INF)
        m_cur = torch.maximum(m, s_blk.amax(-1))
        p_blk = torch.exp(s_blk - m_cur[..., None])
        alpha = torch.exp(m - m_cur)
        l = l * alpha + p_blk.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                    p_blk, v_i)
        m = m_cur
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return out.to(q.dtype)


def full_attention(p: Params, cfg: AttentionConfig, x: torch.Tensor, *,
                   is_global: bool = True, causal: bool = True,
                   kv_chunk: int = DEFAULT_KV_CHUNK) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill); a local layer
    (``is_global=False``) attends over the config's sliding window."""
    from repro_torch.distributed.sharding import constrain
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    # TP hook: query heads over 'model' (Megatron-SP plans set
    # "attn_q_heads").
    q = constrain(q, "attn_q_heads")
    out = chunked_attention(q, k, v, causal=causal,
                            window=0 if is_global else cfg.window,
                            kv_chunk=kv_chunk)
    out = constrain(out, "attn_q_heads")
    return layers.dense(p["wo"], out.reshape(b, s, -1))


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def init_cache(batch: int, max_len: int, cfg: AttentionConfig, *,
               is_global: bool, dtype: torch.dtype = torch.bfloat16,
               device="cpu") -> Dict[str, torch.Tensor]:
    """Global layers cache ``max_len`` positions; local layers a ring
    buffer of ``min(window, max_len)`` positions."""
    length = max_len if is_global else min(cfg.window, max_len)
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def abstract_cache(batch: int, max_len: int, cfg: AttentionConfig, *,
                   is_global: bool, dtype: torch.dtype = torch.bfloat16
                   ) -> Dict[str, torch.Tensor]:
    """Meta stand-in of :func:`init_cache` (no storage)."""
    return init_cache(batch, max_len, cfg, is_global=is_global, dtype=dtype,
                      device="meta")


def decode_attend(p: Params, cfg: AttentionConfig, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], pos, is_global: bool,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  x: (B, 1, d_model); ``pos``: the current position
    (an int or a 0-d integer tensor).

    Writes the new KV into ``cache`` in place at slot ``pos`` (global; a
    position past the end lands on the last slot, as the reference's
    clamped ``dynamic_update_slice`` does) or ``pos % cache_len`` (ring
    buffer), then attends over the valid region: slots ``<= pos``
    (global), or the slots written so far, which is the whole ring once
    it has wrapped.  Returns (out (B, 1, d_model), the same cache)."""
    b = x.shape[0]
    dev = x.device
    pos = torch.as_tensor(pos, device=dev).long()
    q, k_new, v_new = _project_qkv(p, cfg, x, pos.expand(b, 1))
    kc, vc = cache["k"], cache["v"]
    cache_len = kc.shape[1]
    slot = (torch.clamp(pos, max=cache_len - 1) if is_global
            else pos % cache_len).reshape(1)
    kc.index_copy_(1, slot, k_new.to(kc.dtype))
    vc.index_copy_(1, slot, v_new.to(vc.dtype))
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float() * (d ** -0.5)       # (B, H, G, D)
    bounds = [(c, min(c + DEFAULT_KV_CHUNK, cache_len))
              for c in range(0, cache_len, DEFAULT_KV_CHUNK)]

    def heads_first_f32(t, c0, c1):
        """Cache slots [c0, c1) as float32 (B, H, c, D): the cast and the
        transpose in one copy, so the batched matmuls read it as is."""
        out = torch.empty((b, hkv, c1 - c0, d), dtype=torch.float32,
                          device=dev)
        return out.copy_(t[:, c0:c1].permute(0, 2, 1, 3))

    scores = torch.cat([qg @ heads_first_f32(kc, c0, c1).transpose(-1, -2)
                        for c0, c1 in bounds], dim=-1)       # (B, H, G, S)
    slots = torch.arange(cache_len, device=dev)
    valid = slots <= (pos if is_global
                      else torch.clamp(pos, max=cache_len - 1))
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = None
    for c0, c1 in bounds:
        part = probs[..., c0:c1] @ heads_first_f32(vc, c0, c1)
        out = part if out is None else out + part
    out = out.reshape(b, 1, hq * d).to(x.dtype)
    return layers.dense(p["wo"], out), cache
