"""PQ (RecJPQ-style) embedding: item embedding = concat of m sub-embeddings.

Parameters of a PQ embedding:
  codes:   (n_items, m) integer codebook G (Eq. 1) in the config's storage
           dtype (``uint16`` at b=512) — non-trainable.
  sub_emb: (m, b, d/m) f32 sub-id embedding tables Psi (one per split).

Reconstruction (Eq. 2):  w_i = psi_{1,g_i1} || ... || psi_{m,g_im}.

PyTorch gives ``uint16`` tensors only a few operations, so codes are
widened and gathered through :func:`widen` and :func:`take_rows`, which go
through a same-width ``int16`` view.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import PQConfig

Params = Dict[str, Any]

TORCH_CODE_DTYPES = {"int8": torch.int8, "uint8": torch.uint8,
                     "int16": torch.int16, "uint16": torch.uint16,
                     "int32": torch.int32}


def widen(codes: torch.Tensor) -> torch.Tensor:
    """Codes in any storage dtype -> int64 indices."""
    if codes.dtype == torch.uint16:
        return codes.view(torch.int16).long() & 0xFFFF
    return codes.long()


def take_rows(codes: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``codes[ids]`` in the storage dtype."""
    if codes.dtype == torch.uint16:
        return codes.view(torch.int16)[ids].view(torch.uint16)
    return codes[ids]


def init_pq_embedding(generator: torch.Generator, pq: PQConfig, n_items: int,
                      d_model: int, codes: Optional[np.ndarray] = None,
                      centroids: Optional[np.ndarray] = None,
                      device="cpu") -> Params:
    """Random codes in [0, b) and N(0, 0.02^2) sub-embeddings, drawn on the
    generator's device (a CPU generator gives the same weights whatever
    ``device`` is) and then moved to ``device``."""
    if d_model % pq.m:
        raise ValueError(f"d_model={d_model} not divisible by m={pq.m}")
    sub = d_model // pq.m
    if codes is None:
        codes = torch.randint(0, pq.b, (n_items, pq.m), generator=generator,
                              device=generator.device)
    else:
        codes = torch.from_numpy(np.asarray(codes).astype(np.int64))
    codes = codes.to(TORCH_CODE_DTYPES[pq.code_dtype])
    if centroids is None:
        sub_emb = torch.randn((pq.m, pq.b, sub), generator=generator,
                              device=generator.device) * 0.02
    else:
        sub_emb = torch.as_tensor(np.asarray(centroids, np.float32))
        if tuple(sub_emb.shape) != (pq.m, pq.b, sub):
            raise ValueError(f"centroid shape {tuple(sub_emb.shape)} != "
                             f"{(pq.m, pq.b, sub)}")
    return {"codes": codes.to(device), "sub_emb": sub_emb.to(device)}


def abstract_pq_embedding(pq: PQConfig, n_items: int, d_model: int,
                          dtype: torch.dtype = torch.float32) -> Params:
    """:func:`init_pq_embedding`'s tree on meta (no storage), its
    sub-embeddings in ``dtype``."""
    from repro_torch.training import tree as tree_lib

    def build(generator):
        p = init_pq_embedding(generator, pq, n_items, d_model)
        return {**p, "sub_emb": p["sub_emb"].to(dtype)}
    return tree_lib.eval_shape(build, torch.Generator())


def reconstruct(params: Params, ids: torch.Tensor) -> torch.Tensor:
    """Eq. 2: gather sub-embeddings for ``ids`` and concat. (..., d_model).

    Gathered by ``F.embedding`` (the same rows as indexing): its backward
    splits each sub-id's run of duplicate rows, where indexing's sums
    the run in one warp, so its time would follow the most repeated
    sub-id."""
    codes = widen(take_rows(params["codes"], ids))              # (..., m)
    sub_emb = params["sub_emb"]                                 # (m, b, d/m)
    return torch.cat([F.embedding(codes[..., k], sub_emb[k])
                      for k in range(sub_emb.shape[0])], dim=-1)


def reconstruct_all(params: Params) -> torch.Tensor:
    """Materialise the full (n_items, d) table."""
    n = params["codes"].shape[0]
    return reconstruct(params, torch.arange(n, device=params["codes"].device))


def code_nbytes(pq: PQConfig) -> int:
    """Bytes per stored sub-id: the per-split traffic of every code read."""
    return np.dtype(pq.code_dtype).itemsize


def compression_ratio(pq: PQConfig, n_items: int, d_model: int,
                      dense_bytes: int = 4,
                      code_bytes: Optional[int] = None) -> float:
    cb = code_nbytes(pq) if code_bytes is None else code_bytes
    dense = n_items * d_model * dense_bytes
    compressed = (n_items * pq.m * cb
                  + pq.m * pq.b * (d_model // pq.m) * dense_bytes)
    return dense / compressed
