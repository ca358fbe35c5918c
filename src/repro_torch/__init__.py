"""PyTorch + CUDA port of the PQTopK serving path (the JAX package ``repro``
is the reference it is held against).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
:func:`resolve_device` raises rather than carrying on quietly on the CPU
when no card is present.  Float32 products run in full float32: TF32 is
switched off for matmuls and cuDNN so that ``dense`` and
``pqtopk_onehot`` are compared at float32 precision.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev
