"""Synthetic CTR / behaviour-sequence click logs for the recsys archs.

A numpy-only copy of the reference's ``data/recsys_data.py``: the same
seed gives bit-identical arrays in both packages."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import RecsysConfig


def ctr_batch(cfg: RecsysConfig, batch: int, seed: int = 0,
              ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    if cfg.kind in ("dcn", "fm"):
        if cfg.n_dense:
            out["dense"] = rng.normal(0, 1, (batch, cfg.n_dense)).astype(
                np.float32)
        out["sparse"] = np.stack(
            [rng.integers(0, r, batch) for r in cfg.table_rows],
            axis=1).astype(np.int32)
    else:  # bst / dien: (item, cate) behaviour sequence + target
        out["seq"] = np.stack([
            rng.integers(0, cfg.table_rows[0], (batch, cfg.seq_len)),
            rng.integers(0, cfg.table_rows[1], (batch, cfg.seq_len)),
        ], axis=-1).astype(np.int32)
        out["target"] = np.stack([
            rng.integers(0, cfg.table_rows[0], batch),
            rng.integers(0, cfg.table_rows[1], batch),
        ], axis=1).astype(np.int32)
    out["label"] = rng.integers(0, 2, batch).astype(np.float32)
    return out


def ctr_batches(cfg: RecsysConfig, batch: int, seed: int = 0,
                ) -> Iterator[Dict[str, np.ndarray]]:
    i = 0
    while True:
        yield ctr_batch(cfg, batch, seed + i)
        i += 1
