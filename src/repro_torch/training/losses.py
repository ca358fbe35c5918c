"""Shared loss functions beyond the per-model ones: sampled softmax with
logQ correction (two-tower retrieval training at large catalogue scale) and
plain helpers.  The reference's ``training/losses.py`` on tensors."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def sampled_softmax_logq(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
                         neg_logq: torch.Tensor,
                         pos_logq: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """Sampled softmax with logQ correction [Bengio & Senécal'08; Yi+
    RecSys'19]: subtract log-proposal from sampled logits so the gradient
    is unbiased under non-uniform (e.g. popularity) negative sampling.

    pos_scores (B,), neg_scores (B, n), neg_logq (B, n) or (n,).
    """
    if pos_logq is not None:
        pos_scores = pos_scores - pos_logq
    neg = neg_scores - neg_logq
    logits = torch.cat([pos_scores[:, None], neg], dim=1)
    return (torch.logsumexp(logits, -1) - logits[:, 0]).mean()


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    ) -> torch.Tensor:
    return -(labels * F.logsigmoid(logits)
             + (1 - labels) * F.logsigmoid(-logits)).mean()


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    return (logz - gold).mean()
