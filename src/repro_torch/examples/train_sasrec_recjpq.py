"""End-to-end training run: SASRec + RecJPQ on a synthetic Gowalla-mini
dataset — data generation -> SVD codebook -> gBCE training with
checkpointing -> NDCG@10 eval vs a popularity baseline.

  PYTHONPATH=src python -m repro_torch.examples.train_sasrec_recjpq \
      --items 50000 --users 2000 --steps 300 [--device cpu]

The twin of the reference's ``examples/train_sasrec_recjpq.py``: the same
data and codebook bit for bit, weights from ``torch.Generator()
.manual_seed(0)``.  ``--device`` defaults to ``cuda`` and raises without
a card.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import PQConfig, SeqRecConfig
from repro_torch.core import codebook
from repro_torch.data.sequences import SeqRecDataset
from repro_torch.models import seqrec as S
from repro_torch.training import (checkpoint as ckpt_lib, optimizer as O,
                                  train_loop as TL, tree)


def ndcg_at_k(ranks, k=10):
    """ranks: 0-based rank of the held-out item per user (-1: a miss)."""
    hit = (ranks >= 0) & (ranks < k)
    gains = np.zeros(ranks.shape, np.float64)
    gains[hit] = 1.0 / np.log2(ranks[hit] + 2)
    return float(gains.mean())


def _ranks(top: np.ndarray, held: np.ndarray) -> np.ndarray:
    ranks = np.full(len(held), -1)
    for u in range(len(held)):
        w = np.nonzero(top[u] == held[u])[0]
        if len(w):
            ranks[u] = w[0]
    return ranks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=50_000)
    ap.add_argument("--users", type=int, default=2_000)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=50)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "sasrec_recjpq_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = SeqRecConfig(
        name="sasrec-recjpq-example", backbone="sasrec", n_items=args.items,
        d_model=args.d_model, n_blocks=2, n_heads=8, d_ff=args.d_model,
        max_seq_len=args.seq_len, n_negatives=128,
        pq=PQConfig(m=args.m, b=args.b, assign="svd"))

    print(f"generating {args.users:,} users x ~12 interactions over "
          f"{args.items:,} items ...")
    ds = SeqRecDataset.synthetic(args.users, args.items, 12,
                                 args.seq_len + 1, seed=0)
    users, items = ds.interactions()

    print("building RecJPQ codebook (truncated SVD + per-split k-means) ...")
    t0 = time.time()
    codes, _ = codebook.build_codebook(
        cfg.pq, cfg.n_items + 1, d_model=cfg.d_model,
        interactions=(users, items + 1, args.users))
    codebook_s = time.time() - t0
    print(f"  codebook built in {codebook_s:.1f}s; codes shape {codes.shape}")

    params = S.init_seqrec(torch.Generator().manual_seed(0), cfg,
                           device=dev, codes=codes)
    n_params = sum(p.numel() for p in tree.leaves(params))
    emb = params["item_emb"]
    dense_equiv = (cfg.n_items + 1) * cfg.d_model + n_params - (
        emb["codes"].numel() + emb["sub_emb"].numel())
    print(f"  params: {n_params / 1e6:.1f}M (dense-equivalent "
          f"{dense_equiv / 1e6:.1f}M -> RecJPQ compression)")

    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=args.steps // 10,
                         total_steps=args.steps)
    opt_state = TL.init_opt_state(params, ocfg)
    step_fn = TL.make_train_step(lambda p, b: S.seqrec_loss(p, b, cfg), ocfg)
    mgr = ckpt_lib.CheckpointManager(args.ckpt, keep=2)

    it = ds.batches(args.batch, cfg.n_negatives, backbone="sasrec", seed=1)
    losses, rate = [], 0.0
    t0 = time.time()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(m["loss"])
        if step % 25 == 0 or step == args.steps - 1:
            loss = float(m["loss"])
            rate = args.batch * (step + 1) / (time.time() - t0)
            print(f"step {step:4d}  loss {loss:.4f}  ({rate:.1f} seq/s)")
    mgr.save(args.steps, {"params": params, "opt_state": opt_state},
             block=True)

    # --- eval: hold out the last item, rank with PQTopK ------------------
    seqs = ds.sequences
    valid = seqs[:, -1] != 0
    prefix, held = seqs[valid][:, :-1], seqs[valid][:, -1]
    k = 100
    with torch.inference_mode():
        ids, _ = S.serve_topk(params, torch.from_numpy(prefix).to(dev), cfg,
                              k=k, method="pqtopk")
    ranks = _ranks(ids.cpu().numpy(), held)
    # popularity baseline
    pop = np.bincount(prefix.ravel(), minlength=cfg.n_items + 1)
    pop[0] = 0
    pop_ranks = _ranks(np.broadcast_to(np.argsort(-pop)[:k], (len(held), k)),
                       held)
    ndcg, pop_ndcg = ndcg_at_k(ranks), ndcg_at_k(pop_ranks)
    print(f"NDCG@10  model={ndcg:.4f}  popularity={pop_ndcg:.4f}")
    print(f"checkpoint saved to {args.ckpt}")
    return {"codes": codes, "params": params, "opt_state": opt_state,
            "losses": [float(x) for x in losses], "ndcg": ndcg,
            "pop_ndcg": pop_ndcg, "codebook_s": codebook_s, "seq_per_s": rate}


if __name__ == "__main__":
    main()
