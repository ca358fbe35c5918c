"""Plain PyTorch reference of SASRec with the RecJPQ item layer, served by
PQTopK: the frozen forward pass to phi, the sub-id scores, every item's
score in ``tree_sum`` order, and the top-k in ``lax.top_k``'s order.

It imports nothing of the program under test and takes only what the
benchmark made: the weight tree (``portbench/weights.py`` draws it in the
layout ``layout`` gives) and the users' histories.  A configuration names
its reference file; the harness reads ``layout``, ``all_scores`` and
``top_k`` from it.  It follows the SASRec of Kang & McAuley (ICDM'18) with
RecJPQ's item embeddings (Petrov & Macdonald, WSDM'24), with the
departures that the served model has, each noted where it is made:

* the history is left-padded with id 0 to ``max_seq_len`` positions; a
  padded position's item embedding is zero, but it keeps its position
  embedding and takes part in attention (no key-padding mask);
* queries and keys are rotated by RoPE (theta 10,000, split halves) on
  top of the learned position embeddings;
* layer norms use eps 1e-6; the MLP's GELU is the tanh form;
* phi is the last position's hidden state after the final layer norm.

``precision="tf32"`` computes every matrix product in TF32 (inputs
rounded to 10 mantissa bits, float32 accumulation): the benchmark's
control.  On a card it switches the hardware's TF32 on around the
products; elsewhere it rounds the operands itself.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-6
ROPE_THETA = 10_000.0
PRECISIONS = ("float32", "tf32")


def layout(cfg: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(path, shape, how it is drawn) of every float weight of the
    configuration ``cfg``, in draw order: the tree the served model and
    this reference read (dense weights ``(d_in, d_out)``)."""
    d, dff, s = cfg["d_model"], cfg["d_ff"], cfg["max_seq_len"]
    pq = cfg["pq"]
    out = [("item_emb.sub_emb", (pq["m"], pq["b"], d // pq["m"]), "emb"),
           ("pos_emb.table", (s, d), "emb")]
    for i in range(cfg["n_blocks"]):
        for name in ("wq", "wk", "wv", "wo"):
            out.append((f"blocks.{i}.attn.{name}.w", (d, d), "dense"))
        out.append((f"blocks.{i}.mlp.up.w", (d, dff), "dense"))
        out.append((f"blocks.{i}.mlp.down.w", (dff, d), "dense"))
        for ln in ("ln1", "ln2"):
            out.append((f"blocks.{i}.{ln}.scale", (d,), "scale"))
            out.append((f"blocks.{i}.{ln}.bias", (d,), "shift"))
    out.append(("final_norm.scale", (d,), "scale"))
    out.append(("final_norm.bias", (d,), "shift"))
    return out


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away from
    zero, as the card's conversion), still stored as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _Products:
    """Matrix products in the asked precision."""

    def __init__(self, precision: str, device: torch.device):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        self.emulate = precision == "tf32" and device.type != "cuda"
        self.hardware = precision == "tf32" and device.type == "cuda"

    def __call__(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        if self.emulate:
            a, b = _round_tf32(a), _round_tf32(b)
        return torch.einsum(eq, a, b)

    @contextlib.contextmanager
    def scope(self):
        """The card's TF32 switch, set for the scope and restored after."""
        if not self.hardware:
            yield
            return
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


def widen(codes: torch.Tensor) -> torch.Tensor:
    """Codes of any storage type -> int64 ids of sub-items."""
    if codes.dtype == torch.uint16:
        return codes.view(torch.int16).to(torch.int64) & 0xFFFF
    return codes.to(torch.int64)


def pad_left(histories: List[Any], seq_len: int,
             device: torch.device) -> torch.Tensor:
    """Histories (sequences of item ids) -> (B, seq_len) int64, each the
    last ``seq_len`` ids, right-aligned, 0 before."""
    out = torch.zeros((len(histories), seq_len), dtype=torch.int64)
    for i, h in enumerate(histories):
        h = torch.as_tensor(h, dtype=torch.int64)[-seq_len:]
        out[i, seq_len - h.numel():] = h
    return out.to(device)


def _layer_norm(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + EPS) * p["scale"] + p["bias"]


def _rope(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D): position s rotates pair (i, i + D/2) by s * theta^(-2i/D)."""
    s, d = x.shape[1], x.shape[3]
    inv = ROPE_THETA ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def item_embedding(item_emb: Dict[str, torch.Tensor],
                   ids: torch.Tensor) -> torch.Tensor:
    """RecJPQ: an item's embedding is its m sub-item embeddings, concatenated."""
    codes = item_emb["codes"]
    if codes.dtype == torch.uint16:       # indexed through its int16 view
        codes = codes.view(torch.int16)[ids].view(torch.uint16)
    else:
        codes = codes[ids]
    codes = widen(codes)                                        # (..., m)
    sub = item_emb["sub_emb"]                                   # (m, b, d/m)
    return torch.cat([sub[k][codes[..., k]] for k in range(sub.shape[0])],
                     dim=-1)


def phi(params: Dict[str, Any], seqs: torch.Tensor, n_heads: int,
        precision: str = "float32") -> torch.Tensor:
    """Left-padded histories (B, S) -> phi (B, d), float32."""
    mm = _Products(precision, seqs.device)
    bq, s = seqs.shape
    with mm.scope():
        x = item_embedding(params["item_emb"], seqs)
        x = x * (seqs != 0)[..., None].to(x.dtype)
        x = x + params["pos_emb"]["table"][:s][None]
        d = x.shape[-1]
        hd = d // n_heads
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=seqs.device).tril()
        for blk in params["blocks"]:
            a = blk["attn"]
            h = _layer_norm(blk["ln1"], x)
            q = mm("bsd,de->bse", h, a["wq"]["w"]).reshape(bq, s, n_heads, hd)
            k = mm("bsd,de->bse", h, a["wk"]["w"]).reshape(bq, s, n_heads, hd)
            v = mm("bsd,de->bse", h, a["wv"]["w"]).reshape(bq, s, n_heads, hd)
            q, k = _rope(q), _rope(k)
            att = mm("bqhd,bkhd->bhqk", q / math.sqrt(hd), k)
            att = att.masked_fill(~causal, float("-inf")).softmax(-1)
            o = mm("bhqk,bkhd->bqhd", att, v).reshape(bq, s, d)
            x = x + mm("bsd,de->bse", o, a["wo"]["w"])
            h = _layer_norm(blk["ln2"], x)
            u = F.gelu(mm("bsd,df->bsf", h, blk["mlp"]["up"]["w"]),
                       approximate="tanh")
            x = x + mm("bsf,fd->bsd", u, blk["mlp"]["down"]["w"])
        return _layer_norm(params["final_norm"], x)[:, -1, :]


def subid_scores(sub_emb: torch.Tensor, phi_: torch.Tensor,
                 precision: str = "float32") -> torch.Tensor:
    """Eq. 4: S[q, k, j] = <phi_q's k-th slice, psi_kj>.  -> (B, m, b)."""
    mm = _Products(precision, phi_.device)
    m, _, sub = sub_emb.shape
    with mm.scope():
        return mm("bks,kjs->bkj", phi_.reshape(-1, m, sub), sub_emb)


def item_scores(codes: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Algorithm 1: r_i = sum_k S[k, G[i, k]] over every row of ``codes``,
    summed pairwise ((0+1)+(2+3)) + ((4+5)+(6+7)), an odd part carried
    to the next level.  -> (B, N) float32."""
    idx = widen(codes)
    parts = [s[:, k, :][:, idx[:, k]] for k in range(idx.shape[1])]
    while len(parts) > 1:
        nxt = [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def all_scores(params: Dict[str, Any], cfg: Dict[str, Any],
               histories: Sequence[Any], device,
               precision: str = "float32") -> torch.Tensor:
    """Every item's score (B, N+1) for ``histories``: phi, S, Algorithm 1."""
    seqs = pad_left(list(histories), cfg["max_seq_len"], torch.device(device))
    with torch.no_grad():
        phi_ = phi(params, seqs, cfg["n_heads"], precision)
        s = subid_scores(params["item_emb"]["sub_emb"], phi_, precision)
        return item_scores(params["item_emb"]["codes"], s)


def top_k(scores: torch.Tensor, k: int):
    """Exact top-k of float32 ``scores`` along the last axis, in
    ``lax.top_k``'s order: larger first, +0.0 above -0.0, ties to the
    lowest index.  -> (values (B, k), ids (B, k) int64)."""
    bits = scores.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    _, order = torch.sort(key, dim=-1, descending=True, stable=True)
    ids = order[:, :k]
    return torch.gather(scores, 1, ids), ids
