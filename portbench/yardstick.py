"""The benchmark's own arithmetic: the card's published peaks, the least
time of the PQTopK scoring and selection at given shapes, and the model
FLOPs of a served request.

Peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W limit:
float32 outside the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s.  Every share
is stated against these, with the card's power limit printed beside it.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
CODE_BYTES = {"uint8": 1, "int8": 1, "uint16": 2, "int16": 2, "int32": 4}


def pq_topk_work(batch: int, n_items: int, m: int, code_bytes: int, b: int,
                 k: int) -> Tuple[int, int]:
    """(float32 adds, bytes) that scoring ``n_items`` items for ``batch``
    queries and keeping each query's top ``k`` needs, whatever implements
    it: m-1 adds an item and query; the codes, the sub-id scores S
    (batch, m, b) float32 and the answers (batch, k) of a float32 score
    and an int32 id, each moved once."""
    adds = batch * n_items * (m - 1)
    nbytes = n_items * m * code_bytes + batch * m * b * 4 + batch * k * 8
    return adds, nbytes


def least_seconds(adds: float, nbytes: float) -> Tuple[float, str]:
    """The least time the card could take for this work, and which of
    the two bounds sets it.  An add is counted as one float32 operation
    against the 67 TFLOP/s peak (which counts a fused multiply-add as
    two), so this bound is never above what the card can reach."""
    t_ops, t_bytes = adds / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pq_topk_least_seconds(cfg: Dict[str, Any], batch: int, k: int
                          ) -> Tuple[float, str]:
    pq = cfg["pq"]
    return least_seconds(*pq_topk_work(batch, cfg["n_items"], pq["m"],
                                       CODE_BYTES[pq["code_dtype"]],
                                       pq["b"], k))


def backbone_matmul_params(cfg: Dict[str, Any]) -> int:
    """Weights that multiply every position: q, k, v, o (d x d each) and
    the MLP's two (d x d_ff) of each block."""
    d, dff = cfg["d_model"], cfg["d_ff"]
    return cfg["n_blocks"] * (4 * d * d + 2 * d * dff)


def request_flops(cfg: Dict[str, Any], length):
    """Model FLOPs of serving one request over its real history length L
    (padding is waste, not work): 2 * (backbone matmul weights) * L, plus
    4 * L^2 * d a block for attention's two products, plus the head's
    2 * m * b * (d/m) for S and N * (m-1) adds for the scores.  ``length``
    may be an int or an integer numpy array (one request each)."""
    d, pq = cfg["d_model"], cfg["pq"]
    length = np.minimum(np.asarray(length, dtype=np.int64), cfg["max_seq_len"])
    backbone = (2 * backbone_matmul_params(cfg) * length
                + cfg["n_blocks"] * 4 * length * length * d)
    head = 2 * pq["m"] * pq["b"] * (d // pq["m"]) \
        + cfg["n_items"] * (pq["m"] - 1)
    flops = backbone + head
    return int(flops) if flops.ndim == 0 else flops
