"""The CUDA embedding-bag kernel on Hopper, and its ctypes binding.

``csrc/embedding_bag.cu`` holds the hand-written kernel (its header notes
say which TPU kernel it replaces and what bounds it on the card).  The
source is compiled on first use with ``nvcc`` for ``sm_90a`` into
``_build/`` beside this file (:mod:`repro_torch.kernels.nvcc`) and loaded
with ``ctypes``; nothing is compiled or loaded on import.

:func:`embedding_bag_cuda` checks device, dtype, shape and contiguity,
raises on what the kernel does not take, launches on the current CUDA
stream and counts its launches in ``embedding_bag_cuda.launches``.  The
first-use build and load and the count's increment hold ``_LOCK``, so
threads may launch at once.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List

import torch

from repro_torch.kernels import nvcc as _nvcc
from repro_torch.kernels.embedding_bag.ref import MODES

SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_lib = None
_LOCK = threading.Lock()      # the library's first load; the launch count


def nvcc_command(out: Path, nvcc: str = "nvcc") -> List[str]:
    """The build line of this package's source (see :mod:`..nvcc`)."""
    return _nvcc.nvcc_command(SOURCE, out, nvcc)


def build() -> Path:
    """Compile the kernel unless this source's library exists; returns its
    path."""
    return _nvcc.build(SOURCE, BUILD_DIR, "embedding_bag")


def _load():
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.embedding_bag_launch.argtypes = [p, p, p, p, i, i, i, i, p]
            lib.embedding_bag_launch.restype = i
            _lib = lib
    return _lib


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                       weights: torch.Tensor | None = None, *,
                       mode: str = "sum") -> torch.Tensor:
    """table (V, d) f32, indices (n_bags, bag) int32 in [-1, V), weights
    (n_bags, bag) f32 or None (unweighted: no weights are read), all
    contiguous on one CUDA device -> (n_bags, d) f32.  The kernel applies
    the padding mask.  The indices are not read back to check their
    range."""
    w = indices if weights is None else weights   # checked alike
    if not (table.is_cuda and indices.device == table.device
            and w.device == table.device):
        raise ValueError(f"CUDA kernel needs table, indices and weights on "
                         f"one CUDA device, got {table.device}, "
                         f"{indices.device} and {w.device}")
    if table.dtype != torch.float32 or indices.dtype != torch.int32 \
            or (weights is not None and weights.dtype != torch.float32):
        raise ValueError(f"need a float32 table, int32 indices and float32 "
                         f"weights, got {table.dtype}, {indices.dtype} and "
                         f"{w.dtype}")
    if table.dim() != 2 or indices.dim() != 2 \
            or tuple(w.shape) != tuple(indices.shape):
        raise ValueError(f"need table (V, d), indices and weights (n_bags, "
                         f"bag), got {tuple(table.shape)}, "
                         f"{tuple(indices.shape)} and {tuple(w.shape)}")
    if not (table.is_contiguous() and indices.is_contiguous()
            and w.is_contiguous()):
        raise ValueError("table, indices and weights must be contiguous")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    n_bags, bag = indices.shape
    if table.shape[0] < 1:
        raise ValueError("empty table: a padded slot reads row 0")
    if max(n_bags, bag, table.shape[1]) >= 2 ** 31:
        raise ValueError(f"oversized input: n_bags={n_bags}, bag={bag}, "
                         f"d={table.shape[1]}")
    out = torch.empty((n_bags, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _load().embedding_bag_launch(
        table.data_ptr(), indices.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        n_bags, bag, table.shape[1], int(mode == "mean"), stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")
    with _LOCK:
        embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
