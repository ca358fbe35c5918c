"""Self-attention over a full sequence, in plain tensor ops.

``chunked_attention`` is the reference's online-softmax form (a loop over
KV chunks carrying the running max, normaliser and accumulator), so the
two packages take the same steps.  Masked scores are -1e30, and there is
no key-padding mask: left-padded positions take part in attention, as
they do in the reference.
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
                   d_model: int) -> Params:
    q_dim = cfg.n_heads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    p = {
        "wq": layers.dense_init(generator, d_model, q_dim, bias=cfg.qkv_bias),
        "wk": layers.dense_init(generator, d_model, kv_dim, bias=cfg.qkv_bias),
        "wv": layers.dense_init(generator, d_model, kv_dim, bias=cfg.qkv_bias),
        "wo": layers.dense_init(generator, q_dim, d_model,
                                scale=q_dim ** -0.5),
    }
    if cfg.qk_norm:
        raise ValueError("qk_norm attention is not ported")
    return p


def _project_qkv(p: Params, cfg: AttentionConfig, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v (B, S, H, D).  RoPE is applied to q and k even for SASRec,
    which also adds learned position embeddings — as the reference does."""
    b, s, _ = x.shape
    q = layers.dense(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = layers.dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = layers.dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      kv_chunk: int = DEFAULT_KV_CHUNK) -> torch.Tensor:
    """Online-softmax attention over KV chunks, no sliding window.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); Hq = Hkv * G."""
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
                   causal: bool = True,
                   kv_chunk: int = DEFAULT_KV_CHUNK) -> torch.Tensor:
    """Self-attention over a full sequence (every layer global, window 0)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = chunked_attention(q, k, v, causal=causal, kv_chunk=kv_chunk)
    return layers.dense(p["wo"], out.reshape(b, s, -1))
