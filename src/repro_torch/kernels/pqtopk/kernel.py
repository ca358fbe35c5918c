"""CUDA kernels for PQTopK scoring on Hopper, and their ctypes binding.

``csrc/pqtopk.cu`` holds two hand-written kernels (its header notes say
which TPU kernel each replaces and what bounds it on the card):

* ``pq_scores``     — all PQ scores (B, N), the ``pqtopk_kernel`` route;
* ``pq_topk_fused`` — per item-tile exact top-K over a tile list: the 1D
  identity list (the ``pqtopk_fused`` route), a 1D compacted list with
  ``-1`` sentinel slots (the batch-any ``pqtopk_pruned`` route) or a 2D
  (batch tile, slot) table (the grouped ``pqtopk_pruned`` route), each
  optionally with the ``live`` tombstone mask (the mutable catalogue); the
  cross-slot merge is ``ops._merge_slot_winners``.

The source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``_build/`` beside this
file (:mod:`repro_torch.kernels.nvcc`), and loaded with ``ctypes``.
Nothing is compiled or loaded on import: CPU-only hosts import this
module and never call into it.

Each wrapper checks device, dtype, shape and contiguity and raises on
what its kernel does not take; it launches on the current CUDA stream and
counts its launches in ``<wrapper>.launches`` (the fused kernel's 2D-table
launches in ``pq_topk_fused_cuda.launches_2d``, and its launches with a
``live`` mask, in any list form, in ``pq_topk_fused_cuda.launches_live``).

Threads may launch at once, each on its own stream (the replicated
fabric's workers; ``ctypes`` lets go of the GIL during the call): the
first-use build and load and every count's increment hold ``_LOCK``, and
the C side keeps its shared-memory attribute and occupancy cache under a
mutex of its own.

:func:`plan_launch` is the launch arithmetic, in Python so the CPU tests
reach it: how many queries a lane scores per lookup (QB), how many code
rows a ring stage holds, and the shared-memory layout.  The kernels take
the plan as it is; a shape with no plan that fits raises before launch.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import List

import torch

from repro_torch.kernels import nvcc as _nvcc

DEFAULT_TILE = 2048
DEFAULT_BATCH_TILE = 128
MAX_M = 64
MAX_TILE = 2048          # a warp lane tracks its columns in one 64-bit mask
MAX_SMEM = 232_448       # H100: dynamic shared memory a block may use
SMEM_PER_SM = 233_472    # H100: shared memory of one SM (228 KB)
SMEM_PER_BLOCK_RESERVED = 1_024   # the runtime's own share of each block
THREADS = 512            # threads of a block (the kernels' kThreads)
CAND_CAP = 64            # fused selection: candidates a buffer holds
MAX_QB = 4
QB_CHOICES = (4, 2, 1)   # queries per lookup: a 16-, 8- or 4-byte load
MIN_CHUNK = 32           # fewest code rows a ring stage may hold
STAGE_TARGET = 32_768    # code bytes a ring stage aims at
MAX_DEPTH = 8            # ring stages (csrc: kMaxDepth)
RING_BUDGET = 131_072    # ring bytes worth filling: chunks in flight cover
                         # the latency of codes streamed from HBM
# The fused kernel's selection state (csrc: struct QueryCands, two sets of
# per-query thresholds, counts and candidate buffers) and a candidate
# buffer per warp.
CANDS_BYTES = (2 * MAX_QB * (4 + 4 + CAND_CAP * 8)
               + (THREADS // 32) * CAND_CAP * 8)

SOURCE = Path(__file__).resolve().parent / "csrc" / "pqtopk.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

CODE_TYPES = {torch.int8: 0, torch.uint8: 1, torch.int16: 2,
              torch.uint16: 3, torch.int32: 4}

_lib = None
_LOCK = threading.Lock()      # the library's first load; the launch counts


def _round16(x: int) -> int:
    return -(-x // 16) * 16


class _PlanC(ctypes.Structure):
    """``struct Plan`` of ``csrc/pqtopk.cu``, field for field."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "threads", "qb", "chunk", "depth", "smem", "sc_off", "cand_off",
        "ring_off", "stage_bytes", "live_off")]


@dataclass(frozen=True)
class LaunchPlan:
    """How a launch uses a block of ``THREADS`` threads: S staged as (m, b,
    ``qb``) floats at offset 0; for the fused kernel two (``qb``, tile)
    score buffers at ``sc_off`` and the selection's candidate buffers at
    ``cand_off``; then a ring of ``depth`` stages of ``stage_bytes``, each
    ``chunk`` code rows (read from the 16-byte boundary below the first, so
    16 bytes more) and, with a live mask, their live bytes at ``live_off``
    within the stage."""
    qb: int
    chunk: int
    depth: int
    smem: int
    sc_off: int
    cand_off: int
    ring_off: int
    stage_bytes: int
    live_off: int

    @property
    def blocks_per_sm(self) -> int:
        """Resident blocks an SM's shared memory allows."""
        return SMEM_PER_SM // (self.smem + SMEM_PER_BLOCK_RESERVED)

    def as_c(self) -> _PlanC:
        return _PlanC(THREADS, self.qb, self.chunk, self.depth, self.smem,
                      self.sc_off, self.cand_off, self.ring_off,
                      self.stage_bytes, self.live_off)


def _layout(qb, chunk, depth, *, m, b, code_bytes, tile, fused, live):
    s_bytes = _round16(qb * m * b * 4)
    # Rounded up: an odd tile at QB=1 would leave the candidate buffers and
    # the ring off the 16-byte grid the kernel's copies need.
    sc_bytes = _round16(2 * qb * tile * 4) if fused else 0
    cand_bytes = _round16(CANDS_BYTES) if fused else 0
    codes = _round16(chunk * m * code_bytes + 16)
    stage = codes + (_round16(chunk + 16) if live else 0)
    ring_off = s_bytes + sc_bytes + cand_bytes
    return LaunchPlan(qb=qb, chunk=chunk, depth=depth,
                      smem=ring_off + depth * stage, sc_off=s_bytes,
                      cand_off=s_bytes + sc_bytes, ring_off=ring_off,
                      stage_bytes=stage, live_off=codes)


def plan_launch(kind: str, *, m: int, b: int, bq: int, code_bytes: int,
                n: int = 0, tile: int = 0, batch_tile: int = 0,
                live: bool = False) -> LaunchPlan:
    """The launch plan of ``kind`` ("scores" over ``n`` items, or "fused"
    over item tiles of ``tile`` rows).

    QB is the largest of 4, 2, 1 that the batch fills (QB <= ``bq``; at B=1
    every lane scores its own item for the one query), that divides a 2D
    table's ``batch_tile`` (a query chunk never straddles two rows) and
    whose S fits.  A ring stage holds about ``STAGE_TARGET`` bytes of code
    rows (a power of two, at most the tile, or 2048 rows for the scores
    kernel), and the ring as many stages (all but one in flight while one
    is scored) as fit in ``MAX_SMEM`` and ``RING_BUDGET``, between 2 and
    ``MAX_DEPTH``; stages shrink down to ``MIN_CHUNK`` rows before QB does.
    Raises ValueError when not even QB=1 with two 32-row stages fits in
    ``MAX_SMEM``."""
    if kind not in ("scores", "fused"):
        raise ValueError(f"unknown kernel {kind!r}")
    fused = kind == "fused"
    full = tile if fused else min(2048, max(n, 1))
    target = 1 << max(0, (STAGE_TARGET // (m * code_bytes)).bit_length() - 1)
    first = min(full, target)
    chunks = [first] + [c for c in (1024, 512, 256, 128, 64, MIN_CHUNK)
                        if c < first]
    for qb in QB_CHOICES:
        if qb > bq or (batch_tile > 0 and batch_tile % qb):
            continue
        for chunk in chunks:
            for depth in range(MAX_DEPTH, 1, -1):
                plan = _layout(qb, chunk, depth, m=m, b=b,
                               code_bytes=code_bytes, tile=tile, fused=fused,
                               live=live)
                if plan.smem <= MAX_SMEM and (
                        depth == 2
                        or depth * chunk * m * code_bytes <= RING_BUDGET):
                    return plan
    raise ValueError(
        f"no launch plan fits {MAX_SMEM} bytes of shared memory: S for one "
        f"query (m={m}, b={b}) is {m * b * 4} bytes"
        + (f", with two score buffers of tile={tile}" if fused else ""))


def nvcc_command(out: Path, nvcc: str = "nvcc") -> List[str]:
    """The build line of this package's source (see :mod:`..nvcc`)."""
    return _nvcc.nvcc_command(SOURCE, out, nvcc)


def build() -> Path:
    """Compile the kernels unless this source's library exists; returns
    its path."""
    return _nvcc.build(SOURCE, BUILD_DIR, "pqtopk")


def _count(fn, attr: str = "launches") -> None:
    with _LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)


def _load():
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            plan = ctypes.POINTER(_PlanC)
            lib.pq_scores_launch.argtypes = [p, i, p, p, i, i, i, i, plan, p]
            lib.pq_scores_launch.restype = i
            lib.pq_topk_fused_launch.argtypes = [p, i, p, p, p, p, p, i, i, i,
                                                 i, i, i, i, i, i, plan, p]
            lib.pq_topk_fused_launch.restype = i
            _lib = lib
    return _lib


def _check_inputs(codes: torch.Tensor, s: torch.Tensor):
    if not (codes.is_cuda and s.is_cuda) or codes.device != s.device:
        raise ValueError(f"CUDA kernel needs codes and s on one CUDA device, "
                         f"got {codes.device} and {s.device}")
    if codes.dtype not in CODE_TYPES:
        raise ValueError(f"unsupported code dtype {codes.dtype}")
    if s.dtype != torch.float32:
        raise ValueError(f"s must be float32, got {s.dtype}")
    if codes.dim() != 2 or s.dim() != 3 or codes.shape[1] != s.shape[1]:
        raise ValueError(f"need codes (N, m) and s (B, m, b), got "
                         f"{tuple(codes.shape)} and {tuple(s.shape)}")
    n, m = codes.shape
    if not 1 <= m <= MAX_M:
        raise ValueError(f"m={m} outside [1, {MAX_M}]")
    if n < 1 or s.shape[0] < 1 or n >= 2 ** 31:
        raise ValueError(f"empty or oversized input: N={n}, B={s.shape[0]}")
    if not (codes.is_contiguous() and s.is_contiguous()):
        raise ValueError("codes and s must be contiguous")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def pq_scores_cuda(codes: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """codes (N, m) int, s (B, m, b) f32, both on the card -> (B, N) f32."""
    _check_inputs(codes, s)
    n, m = codes.shape
    bq, _, b = s.shape
    plan = plan_launch("scores", m=m, b=b, bq=bq,
                       code_bytes=codes.element_size(), n=n)
    lib = _load()
    out = torch.empty((bq, n), dtype=torch.float32, device=s.device)
    stream = torch.cuda.current_stream(s.device).cuda_stream
    err = lib.pq_scores_launch(codes.data_ptr(), CODE_TYPES[codes.dtype],
                               s.data_ptr(), out.data_ptr(), n, m, b, bq,
                               ctypes.byref(plan.as_c()), stream)
    _raise_on(err, "pq_scores")
    _count(pq_scores_cuda)
    return out


pq_scores_cuda.launches = 0


def pq_topk_fused_cuda(codes: torch.Tensor, s: torch.Tensor, k: int,
                       tile_idx: torch.Tensor, *, n_items: int, tile: int,
                       batch_tile: int = 0, live=None):
    """Per-slot exact top-``k`` of codes tile ``tile_idx[i]`` (``-1`` =
    sentinel slot), global ids, ids >= ``n_items`` masked to -inf.
    ``tile_idx`` is 1D (n_slots,) with ``batch_tile=0``, or 2D (n_bt,
    n_slots) with ``batch_tile >= 1``: row ``j`` serves queries
    ``j*batch_tile .. (j+1)*batch_tile - 1``, and the rows must cover the
    batch.  ``live`` (N,) bool or uint8, if given, masks dead rows to -inf
    inside each tile's top-k.  -> (vals (B, n_slots, k) f32, ids (B,
    n_slots, k) i32)."""
    _check_inputs(codes, s)
    n, m = codes.shape
    bq, _, b = s.shape
    if tile_idx.dtype != torch.int32 or tile_idx.device != s.device \
            or not tile_idx.is_contiguous():
        raise ValueError("tile_idx must be a contiguous int32 tensor on the "
                         "kernel's device")
    if tile_idx.dim() == 1:
        if batch_tile != 0:
            raise ValueError("a 1D tile_idx takes batch_tile=0")
    elif tile_idx.dim() == 2:
        if batch_tile < 1 or tile_idx.shape[0] * batch_tile < bq:
            raise ValueError(
                f"2D tile_idx has {tile_idx.shape[0]} rows; batch_tile="
                f"{batch_tile} needs {-(-bq // max(batch_tile, 1))} to cover "
                f"{bq} queries")
    else:
        raise ValueError(f"tile_idx must be 1D or 2D, got "
                         f"{tuple(tile_idx.shape)}")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile={tile} outside [1, {MAX_TILE}]")
    if not 1 <= k <= tile:
        raise ValueError(f"k={k} outside [1, tile={tile}]")
    if not 0 <= n_items <= n:
        raise ValueError(f"n_items={n_items} outside [0, N={n}]")
    if live is not None and (live.dtype not in (torch.bool, torch.uint8)
                             or tuple(live.shape) != (n,)
                             or live.device != s.device
                             or not live.is_contiguous()):
        raise ValueError(f"live must be a contiguous ({n},) bool or uint8 "
                         f"tensor on the kernel's device, got "
                         f"{tuple(live.shape)} {live.dtype} on {live.device}")
    plan = plan_launch("fused", m=m, b=b, bq=bq,
                       code_bytes=codes.element_size(), tile=tile,
                       batch_tile=batch_tile, live=live is not None)
    lib = _load()
    n_slots = tile_idx.shape[-1]
    out_v = torch.empty((bq, n_slots, k), dtype=torch.float32,
                        device=s.device)
    out_i = torch.empty((bq, n_slots, k), dtype=torch.int32, device=s.device)
    if n_slots == 0:
        return out_v, out_i
    stream = torch.cuda.current_stream(s.device).cuda_stream
    err = lib.pq_topk_fused_launch(
        codes.data_ptr(), CODE_TYPES[codes.dtype], s.data_ptr(),
        tile_idx.data_ptr(), None if live is None else live.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(), n, n_items, m, b, bq, n_slots,
        tile, k, batch_tile, ctypes.byref(plan.as_c()), stream)
    _raise_on(err, "pq_topk_fused")
    _count(pq_topk_fused_cuda, "launches_live" if live is not None
           else "launches_2d" if tile_idx.dim() == 2 else "launches")
    return out_v, out_i


pq_topk_fused_cuda.launches = 0
pq_topk_fused_cuda.launches_2d = 0
pq_topk_fused_cuda.launches_live = 0
