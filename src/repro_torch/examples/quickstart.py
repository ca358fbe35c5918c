"""Quickstart: the paper's technique in a few lines, on one GPU.

Builds a PQ-compressed item catalogue, scores it with the three
algorithms (Transformer-Default matmul, RecJPQ Alg. 2, PQTopK Alg. 1),
checks that they agree, shows the memory compression, and checks the
fused CUDA kernel's top-10 against ``pqtopk``'s.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import PQConfig
from repro_torch.core import pq, retrieval_head, scoring
from repro_torch.kernels.pqtopk import ops as kops

N_ITEMS = 100_000
D_MODEL = 512
PQ_CFG = PQConfig(m=8, b=256)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    print(f"catalogue: {N_ITEMS:,} items, d={D_MODEL}, "
          f"m={PQ_CFG.m} splits x b={PQ_CFG.b} sub-ids, on {dev}")

    # 1. PQ item representation (Eq. 1-2): codes + sub-embeddings.
    head = retrieval_head.init(torch.Generator().manual_seed(0), N_ITEMS,
                               D_MODEL, PQ_CFG, device=dev)
    ratio = pq.compression_ratio(PQ_CFG, N_ITEMS, D_MODEL)
    pq_mb = (head["codes"].numel() * 4 + head["sub_emb"].numel() * 4) / 1e6
    print(f"embedding memory: dense {N_ITEMS * D_MODEL * 4 / 1e6:.0f} MB -> "
          f"PQ {pq_mb:.1f} MB ({ratio:.0f}x compression)")

    # 2. A batch of "sequence embeddings" phi (normally from a Transformer).
    phi = torch.randn((4, D_MODEL),
                      generator=torch.Generator().manual_seed(1)).to(dev)

    # 3. Score all items three ways.
    scores = {m: retrieval_head.score_all(head, phi, m)
              for m in ("dense", "recjpq", "pqtopk")}
    for m in ("recjpq", "pqtopk"):
        torch.testing.assert_close(scores[m], scores["dense"], rtol=1e-4,
                                   atol=1e-4)
    print("scores identical across Default / RecJPQ / PQTopK: OK")

    # 4. Top-10 recommendation per user.
    vals, ids = retrieval_head.top_items(head, phi, 10, method="pqtopk")
    print("top-10 items, user 0:", ids[0].cpu().numpy())

    # 5. The fused kernel (CUDA on the card, its plain version on the CPU).
    s = scoring.subid_scores(head["sub_emb"], phi)
    kv, ki = kops.pq_topk(head["codes"], s, 10)
    np.testing.assert_array_equal(kv.cpu().numpy(), vals.cpu().numpy())
    np.testing.assert_array_equal(ki.cpu().numpy(), ids.cpu().numpy())
    print("fused pqtopk kernel matches: OK")


if __name__ == "__main__":
    main()
