"""Synthetic sequential-recommendation data (Booking/Gowalla-scale shapes):
the training data path of the seqrec archs.

A numpy-only copy of the reference's ``data/sequences.py``: interactions
follow a Zipf item popularity and the same seed gives bit-identical
sequences and batches in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np


def zipf_item_sampler(n_items: int, a: float = 1.2,
                      seed: int = 0) -> np.ndarray:
    """Unnormalised Zipf ranks -> sampling distribution over 1..n_items."""
    rng = np.random.default_rng(seed)
    ranks = rng.permutation(n_items) + 1
    p = ranks ** (-a)
    return p / p.sum()


def gen_interactions(n_users: int, n_items: int, avg_len: float,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (user_ids, item_ids) with items in 1..n_items (0 = pad)."""
    rng = np.random.default_rng(seed)
    lens = np.maximum(rng.poisson(avg_len, n_users), 2)
    probs = zipf_item_sampler(n_items, seed=seed)
    users = np.repeat(np.arange(n_users), lens)
    items = rng.choice(n_items, size=lens.sum(), p=probs) + 1
    return users.astype(np.int64), items.astype(np.int64)


def to_user_sequences(users: np.ndarray, items: np.ndarray, n_users: int,
                      max_len: int) -> np.ndarray:
    """Right-aligned padded sequences (n_users, max_len), 0 = pad."""
    seqs = np.zeros((n_users, max_len), np.int64)
    order = np.argsort(users, kind="stable")
    users, items = users[order], items[order]
    starts = np.searchsorted(users, np.arange(n_users))
    ends = np.searchsorted(users, np.arange(n_users) + 1)
    for u in range(n_users):
        s = items[starts[u]:ends[u]][-max_len:]
        if len(s):
            seqs[u, -len(s):] = s
    return seqs


@dataclass
class SeqRecDataset:
    sequences: np.ndarray          # (n_users, max_len)
    n_items: int

    @classmethod
    def synthetic(cls, n_users: int, n_items: int, avg_len: float,
                  max_len: int, seed: int = 0) -> "SeqRecDataset":
        u, i = gen_interactions(n_users, n_items, avg_len, seed)
        return cls(to_user_sequences(u, i, n_users, max_len), n_items)

    def interactions(self) -> Tuple[np.ndarray, np.ndarray]:
        """Back to (user, item) pairs — input for the SVD codebook."""
        users, items = np.nonzero(self.sequences)
        return users.astype(np.int64), self.sequences[users, items] - 1

    def batches(self, batch_size: int, n_negatives: int, *, backbone: str,
                mask_prob: float = 0.2, seed: int = 0,
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite stream of training batches.

        SASRec: input = seq[:-1], target = seq[1:] (next item / position).
        BERT4Rec: random positions masked (input id -> 0), targets set only
        at masked slots.
        """
        rng = np.random.default_rng(seed)
        n = len(self.sequences)
        while True:
            idx = rng.integers(0, n, batch_size)
            seqs = self.sequences[idx]
            if backbone == "sasrec":
                inp = seqs[:, :-1]
                tgt = seqs[:, 1:]
            else:
                inp = seqs.copy()
                mask = (rng.random(seqs.shape) < mask_prob) & (seqs != 0)
                tgt = np.where(mask, seqs, 0)
                inp[mask] = 0
            negs = rng.integers(1, self.n_items + 1,
                                (*tgt.shape, n_negatives))
            yield {
                "input_seq": inp.astype(np.int32),
                "targets": tgt.astype(np.int32),
                "negatives": negs.astype(np.int32),
            }
