"""Parameter interop with the reference package, through numpy.

``params_from_jax`` takes the reference's ``init_seqrec`` tree with its
leaves as numpy arrays (or anything ``np.asarray`` accepts) and returns
the same tree of torch tensors.  The layouts already agree: dense weights
stay ``(d_in, d_out)``, codes keep their storage dtype (``uint16`` at
b=512).  The pruned-cascade metadata ``item_emb.pruned`` is dropped; the
port serves only the flat routes.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

#: Keys of the reference's ``item_emb`` dict that the port does not carry.
SKIPPED_HEAD_KEYS = ("pruned",)


def _convert(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def params_from_jax(tree: Any, device="cpu") -> Any:
    """The reference's seqrec parameter tree -> the port's, on ``device``."""
    tree = dict(tree)
    tree["item_emb"] = {k: v for k, v in tree["item_emb"].items()
                        if k not in SKIPPED_HEAD_KEYS}
    return _convert(tree, device)


def to_device(tree: Any, device) -> Any:
    """A parameter tree with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device)
