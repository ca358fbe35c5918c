#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch``, holds each against
its plain PyTorch version on the card (the fused kernel with its 1D tile
list, ``-1`` sentinel slots and 2D (batch tile, slot) table), runs the
pruned cascade on a full-width tile-coherent catalogue (both bound
backends, grouping off and on, both seed policies) against the exhaustive
fused route.  RQ2 (``repro_torch.examples.billion_item_sim``): the flat
and hierarchical cascades (super-tiles of 64) on tile-coherent uint8
catalogues of 2^24 and 10^8 items, both backends, bit-identical to the
one-shot fused route, with their bound work and the hierarchical split;
the host two-pass cascade; and a 10^8-item stream in chunks of 2x10^7.
Then it serves the full-width SASRec-RecJPQ model (N=1,271,638 items,
d=512, m=8, b=512, uint16 codes; random weights from a fixed seed)
through ``RetrievalEngine`` with the fused kernel, the scores kernel, the
plain route and the pruned cascade (batch-any, grouped, and with
super-tiles of 64), checking every batch against the plain ``pqtopk`` and
fused routes and each path's kernel launches.  Then the item-sharded
routes on the card (``["cuda:0"] * S``): both kernels at the per-shard
shapes against their plain versions, every engine path at S = 1, 2 and 4
bit-identical to its flat engine with each kernel launched once per shard
per batch, the sharded cascade on the skewed catalogue at S=4 (batch-any,
grouped, super-tiles) and under the ``live`` mask at the mutable capacity,
each bit-identical to the flat cascade, and a K=2 fabric of 2-shard fused
engines.  Then the mutable
catalogue: the fused kernel's tombstone-masked form (``live``) against
its plain version, and mutable engines at full width (capacity 2,097,152
rows; bitmask over 100 batches, range and bitmask with 16 supers over 20)
with 8 catalogue mutations and a hot swap between batches, each logged to
a durable write-ahead log that is recovered and checked bit for bit at
the end.  Then the replicated fabric (``serving/router.py``) at full width:
a healthy 2-replica fused fabric over the same 6,400 histories (untagged
results bit-identical to the fused engine's, form (a) launched once per
job the replicas ran), the serve launcher's ``--chaos`` plan on 3
replicas (ejection, re-admission, a hedge and its suppressed duplicate),
the load ladder, 1, 2 and 4 replicas side by side (at windows of two and
eight batches and at two a replica), and a durable mutable
2-replica fabric with a crashed replica recovered from its log.  Then the
recsys slice: the embedding-bag kernel against its plain version (phase
1); the embedding substrate's ``lookup_bag(use_kernel=True)`` on BST's
full-width item table (4,000,000 x 32; 512 and 262,144 bags, cross-checked
against BST's ``user_query``) and DCN-v2's 10,131,227-row table (phase 2);
and the four recsys models (DCN-v2, BST, DIEN, FM) at full width, one at a
time: ``serve_p99`` logits against the same function on the CPU,
``retrieval_cand`` through the fused kernel bit-identical to ``pqtopk``,
DCN-v2's ``serve_bulk``, and launch counts that show the model paths run
no embedding bag (phase 3).  Then training (``train_phase``): the train
launcher at full width with a failure injected at step 12 and a restart
from the step-10 checkpoint, the final checkpoint restored bit for bit,
one step's split (host batch, forward and backward, AdamW) and its
device profile, one step on the card against the CPU, one step at the
config's ``train_seq`` shape (4,096 sequences as 128 microbatches), the
trained weights served through both kernels bit-identical to the plain
route (20 launches each), gBERT4Rec and the four recsys kinds at full
width through the launcher, and the end-to-end example.  Then the LM
family (``lm_phase``): gemma3-27b at full width cut to 6 layers (one
5:1 sliding/global period), bf16, at its ``decode_32k`` shape (B=128,
32,768 slots): decode steps with every vocabulary head (the fused,
scores-kernel and pruned heads bit-identical to plain ``pqtopk`` at
k=64 and 8, launches counted), both kernels at the int32 vocabulary
shape, ``DecodeEngine`` with the fused head (form (a) once a step), the
ring past its wrap against the windowed prefill, and the card against
the CPU; then qwen2.5-14b cut to 2 layers on the stacked-cache path.
After the recsys models, the mixture-of-experts LMs (``moe_phase``):
qwen3-moe-30b-a3b at full width cut to 4 layers at ``decode_32k`` (every
head bit-identical to plain ``pqtopk``, launches counted and added to the
LM-head records; the sort dispatch against the dense one on every MoE
layer's input, in bf16 and cast to f32; ``DecodeEngine``; the card
against the CPU; both kernels at its vocabulary shape; one AdamW step at
2 layers) and dbrx-132b cut to 2 layers; then GraphSAGE (``gnn_phase``):
``minibatch_lg`` with its edges cut tenfold (host, copy and card split),
``ogb_products`` at full size (step ms, peak memory, a profile),
``full_graph_sm`` and ``molecule`` against the CPU, and the train
launcher.  Both kernel sources are built at once, one
nvcc each; a pqtopk instance for a width the configs use (m = 2, 4, 6, 8)
with a stack frame fails the run.  Prints the card's name and power limit,
the pqtopk launch plans, kernel and per-method timings, a JSON line of
kernel records, and last ``{"ok": true, "device": ...}``.  Any failed
phase raises and exits non-zero; without a CUDA device it exits non-zero
before doing anything.

Both kernels rank in ``lax.top_k``'s total order: a phase plants scores
at -0.0, +0.0, +-NaN and +-inf (``ref.plant_specials``) and holds
``pq_scores`` with its top-k, the fused kernel's four forms and B=1
against the plain versions on the card, bit for bit; the embedding-bag
check includes tables whose row 0 holds NaN and inf.

Kernel and library times are device times: the calls are captured in a
CUDA graph and replayed between one pair of CUDA events (``time_ms``), so
the wrappers' host work is outside the window.  ``--baseline
LABEL=SOURCE`` builds another ``pqtopk.cu`` or ``embedding_bag.cu`` (an
earlier one; which of the two, its library's exports say) and, at every
timing of that kernel, checks it bit for bit against this tree's kernel
and times it in turns (old, new, new, old); ``--variant`` does the same
without the check, for timing splits.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# The data sheet's 67 TFLOP/s in float32 counts an FMA as two operations;
# a plain add is one instruction, so adds alone peak at half that.
F32_ADDS_PER_S = 67e12 / 2
# Shared memory serves 32 banks x 4 B per SM per clock, so at most 32
# four-byte lookups per SM per clock (NVIDIA Hopper tuning guide), at the
# H100 SXM's 1.98 GHz maximum boost clock (data sheet).
SMEM_LOOKUPS_PER_SM_CLOCK = 32
SM_CLOCK_HZ = 1.98e9
N_REQUESTS = 6400                  # 100 full batches of 64
MAX_BATCH = 64
K = 10
K_KERNEL = 16                      # the engine serves k=10 at its bucket 16
CHURN_OPS = 8                      # catalogue mutations between batches
ORACLE_BATCHES = 5                 # mutable batches checked against the oracle


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int, graph: bool = False, windows: int = 5) -> float:
    """Device time of one ``fn()``: after a warm-up call, ``reps`` calls
    run between one pair of CUDA events, and the median over ``windows``
    such windows is divided by ``reps``.  ``graph=True`` captures the
    ``reps`` calls in one CUDA graph and replays it, so no host work (the
    wrapper's checks and allocations, the launch itself) sits inside the
    window: the kernels' and library calls' timings use it.  Without it
    the calls are issued back to back, which times the host too when a
    call's device work is shorter than its host work (the plain versions
    and the paths with host reads, whose device work is longer)."""
    import torch
    fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(reps):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(reps):
                fn()
    run()
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    if graph:
        del g
        torch.cuda.synchronize()
    return statistics.median(times)


# Kernel libraries built from sources outside the tree (``--baseline``,
# ``--variant``), timed against this tree's kernels in the same call.
BASELINES = {}
COMPARISONS = []


class Baseline:
    """The kernels of another source, built with the tree's nvcc line into
    ``_build/`` beside it.  ``kind`` is "embedding_bag" when its library
    exports ``embedding_bag_launch``: a checked one has the earlier
    interface and is given the folded weights (this tree's kernel would
    fold them again to the same bits), a variant this tree's (the raw
    weights, none when unweighted).  Else "pqtopk": one with the earlier C
    interface (its library exports ``pq_smem_bytes``, and its launches
    choose their own chunk and grid) or a variant of this tree's (launched
    with this tree's plan).
    ``check``: its outputs must equal this tree's kernels' bit for bit (a
    variant that computes something else for a timing split does not)."""

    def __init__(self, label, source, check):
        import ctypes
        from pathlib import Path
        from repro_torch.kernels import nvcc
        from repro_torch.kernels.pqtopk import kernel
        src = Path(source).resolve()
        self.label, self.check = label, check
        self.lib = ctypes.CDLL(str(nvcc.build(src, src.parent / "_build",
                                              f"{src.stem}_{label}")))
        p, i = ctypes.c_void_p, ctypes.c_int
        self.kind = ("embedding_bag" if hasattr(self.lib,
                                                "embedding_bag_launch")
                     else "pqtopk")
        if self.kind == "embedding_bag":
            self.lib.embedding_bag_launch.argtypes = [p, p, p, p, i, i, i, i,
                                                      p]
            return
        self.old = hasattr(self.lib, "pq_smem_bytes")
        plan = [] if self.old else [ctypes.POINTER(kernel._PlanC)]
        self.lib.pq_scores_launch.argtypes = [p, i, p, p, i, i, i, i] + plan \
            + [p]
        self.lib.pq_topk_fused_launch.argtypes = [p, i, p, p, p, p, p, i, i,
                                                  i, i, i, i, i, i, i] + plan \
            + [p]

    def _plan(self, kind, codes, s, **kw):
        """() for the earlier interface; this tree's plan otherwise."""
        import ctypes
        from repro_torch.kernels.pqtopk import kernel
        if self.old:
            return ()
        m, b = codes.shape[1], s.shape[2]
        return (ctypes.byref(kernel.plan_launch(
            kind, m=m, b=b, bq=s.shape[0], code_bytes=codes.element_size(),
            **kw).as_c()),)

    def pq_scores(self, codes, s):
        import torch
        from repro_torch.kernels.pqtopk.kernel import CODE_TYPES
        n, m = codes.shape
        bq, _, b = s.shape
        out = torch.empty((bq, n), dtype=torch.float32, device=s.device)
        err = self.lib.pq_scores_launch(
            codes.data_ptr(), CODE_TYPES[codes.dtype], s.data_ptr(),
            out.data_ptr(), n, m, b, bq, *self._plan("scores", codes, s, n=n),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.label} pq_scores: CUDA error {err}")
        return out

    def pq_topk_fused(self, codes, s, k, tile_idx, *, n_items, tile,
                      batch_tile=0, live=None):
        import torch
        from repro_torch.kernels.pqtopk.kernel import CODE_TYPES
        n, m = codes.shape
        bq, _, b = s.shape
        n_slots = tile_idx.shape[-1]
        out_v = torch.empty((bq, n_slots, k), dtype=torch.float32,
                            device=s.device)
        out_i = torch.empty((bq, n_slots, k), dtype=torch.int32,
                            device=s.device)
        err = self.lib.pq_topk_fused_launch(
            codes.data_ptr(), CODE_TYPES[codes.dtype], s.data_ptr(),
            tile_idx.data_ptr(), None if live is None else live.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), n, n_items, m, b, bq, n_slots,
            tile, k, batch_tile,
            *self._plan("fused", codes, s, tile=tile, batch_tile=batch_tile,
                        live=live is not None),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.label} pq_topk_fused: CUDA error {err}")
        return out_v, out_i

    def embedding_bag(self, table, idx, w, w_folded, mode):
        import torch
        out = torch.empty((idx.shape[0], table.shape[1]), dtype=torch.float32,
                          device=table.device)
        w = w_folded if self.check else w
        err = self.lib.embedding_bag_launch(
            table.data_ptr(), idx.data_ptr(),
            None if w is None else w.data_ptr(),
            out.data_ptr(), idx.shape[0], idx.shape[1], table.shape[1],
            int(mode == "mean"), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.label} embedding_bag: CUDA error {err}")
        return out


def same_bits(got, want):
    """Tensors equal bit for bit (NaN payloads and signed zeros too)."""
    import torch
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            return False
    return True


def compare_timed(name, fn_new, fn_old, reps=20, kind="pqtopk"):
    """This tree's kernel call ``fn_new()`` against every baseline of
    ``kind``'s ``fn_old(baseline)`` on the same inputs: outputs of checked
    baselines must be bit-identical; then device times (CUDA graphs) in
    turns, each baseline before and after the two runs of the new kernel
    (old, new, new, old).  Returns the new kernel's time (the mean of its
    two runs; without baselines, one run)."""
    bls = {label: bl for label, bl in BASELINES.items() if bl.kind == kind}
    if not bls:
        return time_ms(fn_new, reps, graph=True)
    want = fn_new()
    want_t = want if isinstance(want, tuple) else (want,)
    for bl in bls.values():
        if bl.check:
            got = fn_old(bl)
            if not same_bits(got if isinstance(got, tuple) else (got,),
                             want_t):
                raise AssertionError(f"{name}: baseline {bl.label} differs "
                                     "from this tree's kernel")
    old = {label: [time_ms(lambda: fn_old(bl), reps, graph=True)]
           for label, bl in bls.items()}
    new = [time_ms(fn_new, reps, graph=True) for _ in range(2)]
    for label, bl in bls.items():
        old[label].append(time_ms(lambda: fn_old(bl), reps, graph=True))
    rec = {"name": name, "new_ms": new,
           **{f"{label}_ms": t for label, t in old.items()}}
    COMPARISONS.append(rec)
    print(f"compare {name}: new {new[0]:.4f}/{new[1]:.4f}ms; "
          + "; ".join(f"{label} {t[0]:.4f}/{t[1]:.4f}ms"
                      for label, t in old.items())
          + " (device time, CUDA graphs; order old, new, new, old)")
    return statistics.mean(new)


def bound_ms(nbytes: float, n_adds: float, n_lookups: float, n_sms: int):
    """Least time for the work: HBM bytes, f32 adds, and shared-memory
    lookups of S (the gather form's inherent operation).  Returns
    (ms, "bytes" or "operations", the three terms in ms)."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "adds": n_adds / F32_ADDS_PER_S * 1e3,
             "lookups": n_lookups / (SMEM_LOOKUPS_PER_SM_CLOCK * n_sms
                                     * SM_CLOCK_HZ) * 1e3}
    worst = max(terms, key=terms.get)
    return (terms[worst], "bytes" if worst == "bytes" else "operations",
            terms)


def pq_inputs(n, m, b, bq, dtype, seed, dev):
    """Codes and S with planted ties: rows 3, N/2 and N-1 share codes and
    query 0 scores them highest."""
    import torch
    g = torch.Generator().manual_seed(seed)
    codes = torch.randint(0, b, (n, m), generator=g)
    codes[[n // 2, n - 1]] = codes[3].clone()
    s = torch.randn((bq, m, b), generator=g)
    s[0, torch.arange(m), codes[3]] = 50.0
    return codes.to(dtype).to(dev), s.to(dev)


def compare(what, got, want):
    """Kernel outputs (values first, then ids) against their plain
    version, bit for bit (NaN payloads and signed zeros too); returns the
    max abs value error over entries finite in both."""
    import torch
    gv, wv = got[0], want[0]
    both = torch.isfinite(gv) & torch.isfinite(wv)
    err = torch.where(both, gv - wv, 0.0).abs().max().item()
    if not same_bits(got, want):
        raise AssertionError(
            f"{what}: {int((gv.view(torch.int32) != wv.view(torch.int32)).sum())}"
            f" value bits and "
            f"{sum(int((g != w).sum()) for g, w in zip(got[1:], want[1:]))}"
            " ids differ")
    return err


def table_2d(n_tiles, n_rows, n_slots, seed):
    """A 2D tile table whose rows differ: ascending tiles, then ``-1``
    tails of different lengths; the last row is all ``-1``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    table = np.full((n_rows, n_slots), -1, np.int32)
    for j in range(n_rows - 1):
        live = max(1, n_slots - j)
        table[j, :live] = np.sort(rng.choice(n_tiles, live, replace=False))
    return torch.from_numpy(table)


# Kernel check cases: (code dtype, N, m, b, batch sizes).  Every width
# instance (m = 2, 4, 6, 8 and the generic path at m = 3, 5), the configs'
# int32 b=256 catalogues, and the lane layouts' edges: B = 1 (QB=1), 3
# (QB=2), 9 and 65 (a last query chunk of one), N never a multiple of the
# tile (a ragged last tile).
CHECK_CASES = (
    ("int8", 100_003, 8, 128, (5,)), ("uint8", 100_003, 8, 256, (9,)),
    ("uint16", 100_003, 8, 512, (1, 3, 9, 65)),
    ("int32", 100_003, 8, 512, (5,)), ("uint8", 4_097, 3, 100, (5,)),
    ("int32", 50_001, 3, 100, (3,)), ("int16", 30_011, 5, 100, (9,)),
    ("int32", 100_003, 2, 256, (1, 3, 9, 65)),
    ("int32", 100_003, 4, 256, (1, 65)), ("int32", 100_003, 6, 256, (1, 9)),
    ("int32", 100_003, 8, 256, (1,)), ("uint16", 1_271_639, 8, 512, (64,)))


def check_kernels(dev):
    """Each kernel against its plain version, bit-exact, over
    ``CHECK_CASES``: the fused kernel on the identity list and (below full
    width) a list with ``-1`` sentinels, repeats and the padding tile, at
    k = 1, 16 and 100, and on 2D tables at batch_tile 8 and 16 with a
    ragged last batch tile.  Returns the max abs error seen per kernel."""
    import torch
    from repro_torch.kernels.pqtopk import kernel, ops, ref
    err = {"pq_scores": 0.0, "pq_topk_fused": 0.0, "pq_topk_fused_2d": 0.0}
    for i, (dname, n, m, b, bqs) in enumerate(CHECK_CASES):
        dtype = getattr(torch, dname)
        full = n > 1_000_000
        tile = min(2048, -(-n // 128) * 128)
        nt = ops.n_tiles(n, tile)
        lists = [torch.arange(nt, dtype=torch.int32)]
        if not full:            # sentinels, repeats, the padding tile
            lists.append(torch.tensor([-1, nt - 1, 0, -1, nt, 0, -1],
                                      dtype=torch.int32))
        for bq in bqs:
            codes, s = pq_inputs(n, m, b, bq, dtype, seed=i, dev=dev)
            err["pq_scores"] = max(err["pq_scores"], compare(
                f"pq_scores {dtype} N={n} m={m} b={b} B={bq}",
                (kernel.pq_scores_cuda(codes, s),),
                (ref.pq_scores(codes, s),)))
            for idx in lists:
                idx_d = idx.to(dev)
                for k in (1, 16, 100):
                    err["pq_topk_fused"] = max(err["pq_topk_fused"], compare(
                        f"pq_topk_fused {dtype} N={n} m={m} b={b} B={bq} "
                        f"k={k}",
                        kernel.pq_topk_fused_cuda(codes, s, k, idx_d,
                                                  n_items=n, tile=tile),
                        ref.pq_topk_slots(codes, s, k, idx_d, n_items=n,
                                          tile=tile)))
        # 2D tables: rows that differ with -1 tails, a ragged last batch
        # tile (small cases), one case at an odd tile width.
        tile2 = 1000 if i == 4 else tile
        nt2 = ops.n_tiles(n, tile2)
        for bt in ((8,) if full else (8, 16)):
            bq2 = 64 if full else 2 * bt + 5
            _, s2 = pq_inputs(n, m, b, bq2, dtype, seed=100 + i, dev=dev)
            rows = -(-bq2 // bt)
            table = table_2d(nt2, rows, min(nt2, 40 if full else 6),
                             seed=bt + i).to(dev)
            for k in (1, 16, 100):
                err["pq_topk_fused_2d"] = max(err["pq_topk_fused_2d"], compare(
                    f"pq_topk_fused 2D {dtype} N={n} bt={bt} k={k}",
                    kernel.pq_topk_fused_cuda(codes, s2, k, table, n_items=n,
                                              tile=tile2, batch_tile=bt),
                    ref.pq_topk_slots(codes, s2, k, table, n_items=n,
                                      tile=tile2, batch_tile=bt)))
        # Rows equal to row 3 (the planted N/2 and N-1, and at small m*b
        # chance repeats) tie at query 0's top: lowest ids first.
        fv, fi = ops.pq_topk(codes, s, 10)
        same = (codes == codes[3]).all(1).nonzero().flatten()[:3].tolist()
        if fi[0, :3].tolist() != same or n // 2 not in (
                (codes == codes[3]).all(1).nonzero().flatten().tolist()):
            raise AssertionError(f"tie order {fi[0, :3].tolist()}, rows "
                                 f"equal to row 3 start {same}")
        torch.cuda.synchronize()
        print(f"kernel check: {dtype} N={n} m={m} b={b} B={bqs}: bit-exact "
              f"(2D tables at tile {tile2})")
    return err


# Planted-order cases: (N, m, b, batch sizes).  m = 1 keeps a planted -NaN
# in the scores (the card's adds return +NaN); B = 1 is the QB=1 layout,
# B = 64 the main path's batch.
SPECIAL_CASES = ((100_003, 1, 64, (1, 5)), (100_003, 8, 512, (1, 64)),
                 (50_001, 4, 256, (9,)))


def check_specials(dev):
    """Scores planted at -0.0, +0.0, +-NaN and +-inf (``ref.plant_specials``,
    the last tile mostly -NaN past its ``-inf`` padding): ``pq_scores``,
    its top-k through ``core.topk``, and the fused kernel's four forms (the
    identity list, ``-1`` sentinels, a 2D table, the ``live`` mask) at
    k = 1, 16 and 100, each against its plain version run on the card, bit
    for bit.  Returns the max abs error per kernel (entries finite in
    both)."""
    import numpy as np
    import torch
    from repro_torch.core import topk as topk_lib
    from repro_torch.kernels.pqtopk import kernel, ops, ref
    err = {"pq_scores": 0.0, "pq_topk_fused": 0.0, "pq_topk_fused_2d": 0.0,
           "pq_topk_fused_live": 0.0}
    tile = 2048
    for i, (n, m, b, bqs) in enumerate(SPECIAL_CASES):
        rng = np.random.default_rng(200 + i)
        nt = ops.n_tiles(n, tile)
        for bq in bqs:
            c_np, s_np = ref.plant_specials(
                rng.integers(0, b, (n, m)).astype(np.uint16),
                rng.standard_normal((bq, m, b)).astype(np.float32), tile,
                seed=i)
            codes = torch.from_numpy(c_np).to(dev)
            s = torch.from_numpy(s_np).to(dev)
            what = f"specials N={n} m={m} b={b} B={bq}"
            sc = kernel.pq_scores_cuda(codes, s)
            err["pq_scores"] = max(err["pq_scores"], compare(
                f"pq_scores {what}", (sc,), (ref.pq_scores(codes, s),)))
            for k in (16, 100):
                compare(f"pq_scores + topk {what} k={k}",
                        topk_lib.topk(sc, k), ref.pq_topk(codes, s, k))
            bt = 8
            width = min(nt - 1, 6)
            table = np.full((-(-bq // bt), width), -1, np.int32)
            table[-1, :2] = [0, nt - 1]
            table[0] = np.sort(rng.choice(nt - 1, width, replace=False))
            table[0, -1] = nt - 1
            live = torch.from_numpy(rng.random(n) > 0.1).to(dev)
            forms = [("identity", torch.arange(nt, dtype=torch.int32), 0,
                      None, "pq_topk_fused"),
                     ("sentinel", torch.tensor([nt - 1, -1, 0, -1, 1],
                                               dtype=torch.int32), 0, None,
                      "pq_topk_fused"),
                     ("2D", torch.from_numpy(table), bt, None,
                      "pq_topk_fused_2d"),
                     ("live", torch.arange(nt, dtype=torch.int32), 0, live,
                      "pq_topk_fused_live")]
            for form, idx, batch_tile, lv, name in forms:
                idx = idx.to(dev)
                for k in (1, 16, 100):
                    err[name] = max(err[name], compare(
                        f"pq_topk_fused {form} {what} k={k}",
                        kernel.pq_topk_fused_cuda(
                            codes, s, k, idx, n_items=n, tile=tile,
                            batch_tile=batch_tile, live=lv),
                        ref.pq_topk_slots(codes, s, k, idx, n_items=n,
                                          tile=tile, batch_tile=batch_tile,
                                          live=lv)))
            # -0.0, +0.0, +inf, -inf, a +NaN, and at m = 1 a -NaN.
            bits = torch.unique(sc.view(torch.int32))
            seen = [bool((bits == x).any()) for x in (-2 ** 31, 0, 0x7f800000,
                                                      -0x800000)]
            seen.append(bool((bits > 0x7f800000).any()))
            if m == 1:
                seen.append(bool(((bits > -0x800000) & (bits < 0)).any()))
            if not all(seen):
                raise AssertionError(f"{what}: a planted score class is "
                                     f"missing ({seen})")
        torch.cuda.synchronize()
        print(f"kernel check specials: N={n} m={m} b={b} B={bqs}: scores at "
              "+-0, +-NaN, +-inf; pq_scores + topk and the fused kernel's "
              "four forms bit-exact against the plain versions on the card")
    return err


def clustered_codes(n, m, b, grain=2048, width=8, seed=0):
    """A tile-coherent catalogue, after ``examples/billion_item_sim.py``'s
    ``make_clustered_codes``: every ``grain`` consecutive items draw their
    codes from one band [base, base + width), bases rising across groups."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_groups = -(-n // grain)
    span = max(1, b - width)
    base = np.minimum((np.arange(n_groups, dtype=np.int64) * span)
                      // max(1, n_groups - 1), span - 1)
    codes = np.repeat(base, grain)[:n, None] + rng.integers(0, width, (n, m))
    return codes.astype(np.uint16)


def window_scores(bq, m, b, seed, spread, power, boost=6.0):
    """S with skewed noise (``|g|**power``, sign kept) and a boosted code
    window per query, after ``tests/test_perquery_pruning.py``: query q's
    window starts at ``q * spread * b / B``.  ``spread=0.25, power=3``: the
    windows tile the first quarter of the codebook (mixed interests: each
    query's survivors are its own); ``spread=0, power=2``: every query
    boosts the same head window (shared interest)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((bq, m, b))
    g = np.sign(g) * np.abs(g) ** power
    for q in range(bq):
        w = int(q * spread * b) // bq
        g[q, :, max(0, w - 1):w + 3] += boost
    return g.astype(np.float32)


def tile_items(n, tile, tiles):
    """Real items in each of ``tiles`` (the last tile is ragged)."""
    return [min(tile, n - t * tile) for t in tiles if t >= 0]


def skewed_cascade(dev, n_sms, n=1_271_638):
    """The pruned cascade at full width on a tile-coherent catalogue, every
    configuration against the exhaustive fused route; then the time split
    of one batch and the compacted (1D with sentinels) and 2D kernel forms
    against their plain versions and bounds.  Returns the two kernel
    forms' measurements."""
    import numpy as np
    import torch
    from repro_torch.core import pruning
    from repro_torch.kernels.pqtopk import kernel, ops, ref
    m, b, bq = 8, 512, MAX_BATCH
    codes = torch.from_numpy(clustered_codes(n, m, b)).to(dev)
    states = {be: pruning.build_pruned_state(codes, b, backend=be)
              for be in pruning.BOUND_BACKENDS}
    # (batch, score shape, grouping modes run on it)
    batches = {"mixed": (dict(spread=0.25, power=3), (False, True)),
               "shared": (dict(spread=0.0, power=2), (False,))}
    below_exhaustive, n_configs, scores = [], 0, {}
    for batch, (shape, modes) in batches.items():
        s = torch.from_numpy(window_scores(bq, m, b, 0, **shape)).to(dev)
        scores[batch] = s
        calib = [torch.from_numpy(window_scores(bq, m, b, i, **shape)).to(dev)
                 for i in (1, 2, 3)] + [s]
        ev, ei = ops.pq_topk(codes, s, K_KERNEL)
        for backend, state in states.items():
            for grouped in modes:
                for policy in ("greedy", "adaptive"):
                    seed_kw = dict(seed_policy=policy)
                    counts = [int(pruning.survival_count_grouped(
                        codes, c, K_KERNEL, state, n_groups=8, **seed_kw)
                        if grouped else pruning.survival_count(
                            codes, c, K_KERNEL, state, **seed_kw))
                        for c in calib]
                    ladder = pruning.calibrate_ladder(
                        counts, state.n_tiles, K_KERNEL, state.tile)
                    v, i, st = pruning.cascade_topk_ingraph(
                        codes, s, K_KERNEL, state, ladder=ladder,
                        query_grouping=grouped, n_groups=8,
                        return_stats=True, **seed_kw)
                    what = (f"cascade {batch} {backend} grouping="
                            f"{'on' if grouped else 'off'} {policy}")
                    if not (torch.equal(v, ev) and torch.equal(i, ei)):
                        raise AssertionError(f"{what}: differs from pq_topk")
                    n_configs += 1
                    if st["rung_hit"] < st["n_rungs"] - 1:
                        below_exhaustive.append(what)
                    print(f"{what}: ladder={ladder} rung_hit="
                          f"{st['rung_hit']} survival_fraction="
                          f"{float(st['survival_fraction']):.4f} n_survived="
                          f"{st['n_survived']} n_groups={st['n_groups']} "
                          f"max_group={st['max_group_survived']} "
                          f"pairs_scored/pairs_union={st['pairs_scored']}/"
                          f"{st['pairs_union']} n_seed_used="
                          f"{st['n_seed_used']}: bit-identical to pq_topk")
    if not below_exhaustive:
        raise AssertionError("no skewed configuration took a rung below the "
                             "exhaustive one")
    print(f"cascade: {len(below_exhaustive)} of {n_configs} configurations "
          "ended below the exhaustive rung, every result exact")

    # ---- time split of one batch (bitmask, greedy), both routes ------
    state = states["bitmask"]
    tile = state.tile
    forms = {}
    for grouped in (False, True):
        # Batch-any on the shared-interest batch, grouped on the mixed one.
        s = scores["mixed" if grouped else "shared"]
        bounds = pruning.tile_bounds(state, s)
        t_bounds = time_ms(lambda: pruning.tile_bounds(state, s), 10)
        if grouped:
            theta_fn = lambda: pruning.theta_seed_perquery(
                codes, s, bounds, K_KERNEL, tile=tile)
            theta = theta_fn()[0]
            mask = pruning.survival_mask_perquery(bounds, theta)
            bt = ops.group_batch_tile(bq, 8)
            compact_fn = lambda: pruning.group_and_compact(
                mask, n_groups=8, batch_tile=bt)
            perm, _, slots, counts = compact_fn()
            s_k = s[perm].contiguous()
        else:
            theta_fn = lambda: pruning.theta_seed_ingraph(
                codes, s, bounds, K_KERNEL, tile=tile)
            theta = theta_fn()[0]
            compact_fn = lambda: pruning.compact_mask(
                pruning.survival_mask(bounds, theta))
            slots, counts = compact_fn()
            bt, s_k = 0, s
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cl = counts.reshape(-1).tolist()
            host.append((time.perf_counter() - t0) * 1e3)
        rung = max(cl)
        budget = 1 << (max(rung, 1) - 1).bit_length()     # a pow2 rung
        table = slots[..., :min(budget, state.n_tiles)].contiguous()
        kern = lambda: kernel.pq_topk_fused_cuda(
            codes, s_k, K_KERNEL, table, n_items=n, tile=tile, batch_tile=bt)
        tv, ti = kern()
        whole = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pruning.cascade_topk_ingraph(codes, s, K_KERNEL, state,
                                         ladder=(budget,),
                                         query_grouping=grouped, n_groups=8)
            torch.cuda.synchronize()
            whole.append((time.perf_counter() - t0) * 1e3)
        split = {"bounds": t_bounds, "theta": time_ms(theta_fn, 10),
                 "grouping+compaction" if grouped else "compaction":
                     time_ms(compact_fn, 10),
                 "host read": statistics.median(host),
                 "kernel": 0.0,
                 "merge": time_ms(lambda: ops._merge_slot_winners(
                     tv, ti, K_KERNEL), 20)}
        name = "pq_topk_fused_2d" if grouped else "pq_topk_fused_sentinel"
        split["kernel"] = compare_timed(
            name, kern, lambda bl: bl.pq_topk_fused(
                codes, s_k, K_KERNEL, table, n_items=n, tile=tile,
                batch_tile=bt))
        print(f"split {'grouped, mixed' if grouped else 'batch-any, shared'}"
              f" batch (bitmask, greedy, B={bq}, {table.shape[-1]} slots, "
              "max survivors "
              f"{rung}): " + ", ".join(f"{k} {v:.4f}ms"
                                       for k, v in split.items())
              + f"; whole cascade {statistics.median(whole):.4f}ms host clock")
        # Work this table needs: (query, item) pairs of scored slots.
        rows = table.reshape(-1, table.shape[-1]).tolist()
        row_q = [min(bt, bq - j * bt) for j in range(len(rows))] \
            if grouped else [bq]
        pair_items = sum(q * sum(tile_items(n, tile, r))
                         for q, r in zip(row_q, rows))
        scored = {t for r in rows for t in r if t >= 0}
        nbytes = (sum(tile_items(n, tile, scored)) * m * 2
                  + bq * m * b * 4 + table.numel() * 4
                  + bq * table.shape[-1] * K_KERNEL * 8)
        bnd, by, terms = bound_ms(nbytes, pair_items * (m - 1),
                                  pair_items * m, n_sms)
        plain = time_ms(lambda: ref.pq_topk_slots(
            codes, s_k, K_KERNEL, table, n_items=n, tile=tile,
            batch_tile=bt), 3)
        print(f"bound {name}: {terms} ms ({pair_items} scored query-item "
              f"pairs)")
        forms[name] = {"ms": split["kernel"], "plain_ms": plain,
                       "bound_ms": bnd, "bound_by": by}
    return forms


HIER_SIZES = (1 << 24, 100_000_000)  # RQ2 catalogues: T = 16,384 and 97,657
HIER_TILE, HIER_FACTOR, HIER_B, HIER_BQ = 1024, 64, 256, 2
# The reference's own count at 2^24 (README, its CPU run of
# ``examples/billion_item_sim.py --mode hier``): flat -> hierarchical.
REFERENCE_HIER_BOUNDS = (16384, 1280)
STREAM_N, STREAM_CHUNK = 100_000_000, 20_000_000


def host_ms(fn, reps=5):
    """Median host-clock ms of ``fn()`` with a synchronize before and after
    (for paths that read the host, so their device work cannot be queued
    ahead)."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def read_ms(t):
    """Median host-clock ms of reading a ready 0-d tensor to the host."""
    import torch
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.item()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def reset_counts():
    """Every kernel wrapper's launch counts to 0."""
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.kernels.pqtopk import kernel
    kernel.pq_scores_cuda.launches = 0
    kernel.pq_topk_fused_cuda.launches = 0
    kernel.pq_topk_fused_cuda.launches_2d = 0
    kernel.pq_topk_fused_cuda.launches_live = 0
    eb_kernel.embedding_bag_cuda.launches = 0


def read_counts():
    from repro_torch.kernels.pqtopk import kernel
    return {"pq_topk_fused": kernel.pq_topk_fused_cuda.launches,
            "pq_topk_fused_2d": kernel.pq_topk_fused_cuda.launches_2d,
            "pq_topk_fused_live": kernel.pq_topk_fused_cuda.launches_live,
            "pq_scores": kernel.pq_scores_cuda.launches}


def expect_counts(what, got, **want):
    full = {k: want.get(k, 0) for k in got}
    print(f"path {what}: launches {got}")
    if got != full:
        raise AssertionError(f"{what} launched {got}, expected {full}")


def hier_split(codes, s, hier, n_sms):
    """The hierarchical cascade's pieces on one batch, as ``_hier_tail``
    runs them (greedy seed, default super ladder, exhaustive child rung):
    device times of each piece, host-clock times of the two host reads,
    and the tail's kernel launch against its plain version; beside them
    the flat route's bounds and seed, the pass-0 pieces stand in for.
    Returns (split ms, the tail kernel's record)."""
    import torch
    from repro_torch.core import pruning
    from repro_torch.kernels.pqtopk import kernel, ops, ref
    n, m = codes.shape
    bq, _, b = s.shape
    tile, factor, t_total = hier.tile, hier.super_factor, hier.n_tiles
    be, parts = hier.backend, hier.super_meta_arrays()
    sup_fn = lambda: pruning.bounds_from_parts(be, parts, s)
    sup_bounds = sup_fn()
    deg = pruning.degenerate_from_parts(be, parts, hier.b)
    seed_fn = lambda: pruning.theta_seed_ingraph(
        codes, s, sup_bounds, K, tile=factor * tile, degenerate=deg)
    theta = seed_fn()[0]
    comp0_fn = lambda: pruning.compact_mask(pruning.survival_mask(
        sup_bounds, theta))
    sup_slots, sup_count = comp0_fn()
    rungs = pruning.normalize_ladder(pruning.default_super_ladder(
        hier.n_super), hier.n_super, K, factor * tile)
    r_sup = rungs[pruning._rung(int(sup_count), rungs)]

    def gather_fn():
        gid = (sup_slots[:r_sup, None].long() * factor
               + torch.arange(factor, device=s.device)).reshape(-1)
        safe = gid.clamp(0, t_total - 1)
        return gid, pruning.bounds_from_parts(
            be, tuple(p[safe] for p in hier.meta_arrays()), s)

    gid, cb = gather_fn()
    comp2_fn = lambda: pruning.compact_values(
        pruning.survival_mask(cb, theta) & (gid >= 0) & (gid < t_total), gid)
    slots, count = comp2_fn()
    crungs = pruning.normalize_ladder(None, r_sup * factor, K, tile)
    table = slots[:crungs[pruning._rung(int(count), crungs)]].contiguous()
    kern = lambda: kernel.pq_topk_fused_cuda(codes, s, K, table, n_items=n,
                                             tile=tile)
    tv, ti = kern()
    err = compare(f"hier tail kernel N={n}", (tv, ti), ref.pq_topk_slots(
        codes, s, K, table, n_items=n, tile=tile))
    flat = pruning.with_super(hier, 0)
    flat_bounds = pruning.tile_bounds(flat, s)
    split = {"flat bounds": time_ms(lambda: pruning.tile_bounds(flat, s), 10),
             "flat seed": time_ms(lambda: pruning.theta_seed_ingraph(
                 codes, s, flat_bounds, K, tile=tile), 10),
             "super bounds": time_ms(sup_fn, 10),
             "seed": time_ms(seed_fn, 10),
             "pass-0 compaction": time_ms(comp0_fn, 10),
             "host read 1": read_ms(sup_count),
             "child-bound gather": time_ms(gather_fn, 10),
             "stage-2 compaction": time_ms(comp2_fn, 10),
             "host read 2": read_ms(count),
             "kernel": time_ms(kern, 20, graph=True),
             "merge": time_ms(lambda: ops._merge_slot_winners(tv, ti, K),
                              20)}
    listed = [t for t in table.tolist() if t >= 0]
    rows = sum(tile_items(n, tile, listed))
    nbytes = (rows * m * codes.element_size() + bq * m * b * 4
              + table.numel() * 4 + bq * table.numel() * K * 8)
    bnd, by, _ = bound_ms(nbytes, bq * rows * (m - 1), bq * rows * m, n_sms)
    rec = {"ms": split["kernel"], "max_abs_err": err,
           "plain_ms": time_ms(lambda: ref.pq_topk_slots(
               codes, s, K, table, n_items=n, tile=tile), 3),
           "bound_ms": bnd, "bound_by": by, "slots": table.numel(),
           "survivors": int(count), "supers": int(sup_count)}
    return split, rec


def hier_phase(dev, n_sms):
    """RQ2's hierarchical scenario at 2^24 and 10^8 items (m=8, b=256,
    tile 1024, factor 64, B=2, k=10, uint8 codes, the reference's ``--mode
    hier`` defaults): per catalogue and bound backend, the flat and the
    hierarchical cascade bit-identical to each other and to the one-shot
    fused route, their bound work and host-clock times, the hierarchical
    route's launches (counts at 0 just before), and its split; at 2^24
    also on the reference's own S (its ``jax.random`` draw, saved), whose
    bound count the reference's README gives; then the host two-pass
    cascade on the 2^24 catalogue.  Returns a summary."""
    import gc
    import numpy as np
    import torch
    from repro_torch.core import pruning
    from repro_torch.examples import billion_item_sim as sim
    from repro_torch.kernels.pqtopk import ops
    out = {}
    scores = {"torch S": sim.make_popularity_scores(HIER_BQ, 8, HIER_B,
                                              seed=0).to(dev),
              "reference S": torch.from_numpy(np.load(sim.REFERENCE_S)
                                              ).to(dev)}
    for n in HIER_SIZES:
        t0 = time.monotonic()
        codes = torch.from_numpy(sim.make_clustered_codes(
            n, 8, HIER_B, HIER_TILE * HIER_FACTOR, seed=0)).to(dev)
        print(f"hier N={n}: {n * 8 / 1e6:.0f} MB of uint8 codes made and "
              f"moved in {time.monotonic() - t0:.1f}s")
        for label, s in scores.items():
            if label != "torch S" and n != HIER_SIZES[0]:
                continue
            ev, ei = ops.pq_topk(codes, s, K)
            for backend in pruning.BOUND_BACKENDS:
                what = f"hier N={n} {label} {backend}"
                flat = pruning.build_pruned_state(codes, HIER_B, HIER_TILE,
                                                  backend=backend)
                hier = pruning.with_super(flat, HIER_FACTOR)
                fv, fi, fst = pruning.cascade_topk_ingraph(
                    codes, s, K, flat, return_stats=True)
                reset_counts()
                hv, hi, hst = pruning.cascade_topk_ingraph(
                    codes, s, K, hier, return_stats=True)
                torch.cuda.synchronize()
                expect_counts(what, read_counts(), pq_topk_fused=1,
                              pq_scores=1)
                if not (torch.equal(fv, ev) and torch.equal(fi, ei)
                        and torch.equal(hv, ev) and torch.equal(hi, ei)):
                    raise AssertionError(f"{what}: a cascade differs from "
                                         "the one-shot pq_topk")
                ref_note = (f" (the reference's CPU run on the reference S: "
                            f"{REFERENCE_HIER_BOUNDS[0]} -> "
                            f"{REFERENCE_HIER_BOUNDS[1]}, its README; not "
                            "this card)" if n == HIER_SIZES[0] else "")
                t_flat = host_ms(lambda: pruning.cascade_topk_ingraph(
                    codes, s, K, flat))
                t_hier = host_ms(lambda: pruning.cascade_topk_ingraph(
                    codes, s, K, hier))
                print(f"{what}: T={flat.n_tiles} S={hier.n_super} "
                      f"bounds_computed {fst['bounds_computed']} -> "
                      f"{hst['bounds_computed']} ("
                      f"{fst['bounds_computed'] / hst['bounds_computed']:.2f}"
                      f"x){ref_note}; n_super_survived="
                      f"{hst['n_super_survived']} super_rung_hit="
                      f"{hst['super_rung_hit']} n_survived="
                      f"{hst['n_survived']} (flat {fst['n_survived']}) "
                      f"n_scored={hst['n_scored']}; whole cascade flat "
                      f"{t_flat:.4f}ms hier {t_hier:.4f}ms host clock; both "
                      "bit-identical to pq_topk")
                out[(n, label, backend)] = {
                    "flat_bounds": fst["bounds_computed"],
                    "hier_bounds": hst["bounds_computed"],
                    "n_super_survived": hst["n_super_survived"],
                    "flat_ms": t_flat, "hier_ms": t_hier}
                if backend == "bitmask" and label == "torch S":
                    split, rec = hier_split(codes, s, hier, n_sms)
                    out[(n, "split")] = (split, rec)
                    print(f"split hier N={n} (bitmask, greedy, B={HIER_BQ}, "
                          f"{rec['supers']} supers, {rec['survivors']} child "
                          f"survivors in {rec['slots']} slots): "
                          + ", ".join(f"{k} {v:.4f}ms"
                                      for k, v in split.items())
                          + f"; tail kernel plain {rec['plain_ms']:.4f}ms "
                          f"bound {rec['bound_ms']:.4f}ms ({rec['bound_by']})")
                del flat, hier
            if n == HIER_SIZES[0] and label == "torch S":
                out["host"] = host_cascade(codes, s, ev, ei)
        del codes
        gc.collect()
        torch.cuda.empty_cache()
    return out


def host_cascade(codes, s, ev, ei):
    """The host two-pass cascade on the clustered catalogue: bit-identical
    to the in-graph cascade and the one-shot route; its slot list (padded
    with the past-the-end tile) held against the plain kernel; launches
    with the counts at 0."""
    import torch
    from repro_torch.core import pruning
    from repro_torch.kernels.pqtopk import kernel, ops, ref
    n = codes.shape[0]
    reset_counts()
    v, i, st = pruning.cascade_topk(codes, s, K, tile=HIER_TILE,
                                    return_stats=True)
    torch.cuda.synchronize()
    expect_counts("host cascade", read_counts(), pq_topk_fused=1,
                  pq_scores=1)
    gv, gi = pruning.cascade_topk_ingraph(
        codes, s, K, pruning.build_pruned_state(codes, HIER_B, HIER_TILE))
    if not (torch.equal(v, ev) and torch.equal(i, ei)
            and torch.equal(gv, v) and torch.equal(gi, i)):
        raise AssertionError("host cascade differs from the in-graph one")
    meta = pruning.get_tile_metadata(codes, HIER_B, HIER_TILE)
    mask = pruning.pruned_pass1(codes, meta.present, s, K, tile=HIER_TILE,
                                n_seed=2)[0]
    surv = mask.nonzero().flatten().to(torch.int32)
    idx = torch.full((pruning.slot_bucket(surv.numel(), K, HIER_TILE),),
                     ops.sentinel_tile(n, HIER_TILE), dtype=torch.int32,
                     device=codes.device)
    idx[:surv.numel()] = surv
    err = compare("host cascade slot list", kernel.pq_topk_fused_cuda(
        codes, s, K, idx, n_items=n, tile=HIER_TILE), ref.pq_topk_slots(
        codes, s, K, idx, n_items=n, tile=HIER_TILE))
    t = host_ms(lambda: pruning.cascade_topk(codes, s, K, tile=HIER_TILE))
    print(f"host cascade N={n}: n_survived={st['n_survived']} in "
          f"{st['n_scored']} slots ({st['n_scored'] - st['n_survived']} "
          f"past-the-end tiles), {t:.4f}ms host clock; bit-identical to the "
          "in-graph cascade and pq_topk; slot list bit-exact against the "
          "plain kernel")
    return {"ms": t, "max_abs_err": err, **{k: st[k] for k in (
        "n_survived", "n_scored")}}


def stream_phase(dev, n_sms):
    """RQ2's pre-computing scenario at 10^8 items (m=8, b=256, B=1, uint8
    codes on the host): the chunked stream (one form (a) launch per chunk
    of 2x10^7 items, host merge) bit-identical to the one-shot fused route
    over the catalogue on the card; its rate, per-chunk split and the
    host-to-device copy rates.  Returns a summary."""
    import gc
    import numpy as np
    import torch
    from repro_torch.examples import billion_item_sim as sim
    from repro_torch.kernels.pqtopk import kernel, ops, ref
    n, chunk, m, b = STREAM_N, STREAM_CHUNK, 8, 256
    codes = np.random.default_rng(0).integers(0, b, (n, m), dtype=np.uint8)
    s = torch.randn((1, m, b), generator=torch.Generator().manual_seed(0)
                    ).to(dev)
    sim.streaming_pqtopk(codes[:chunk], s, K, chunk)        # warm-up
    reset_counts()
    v, i, n_chunks = sim.streaming_pqtopk(codes, s, K, chunk)
    expect_counts(f"stream N={n}", read_counts(), pq_topk_fused=n_chunks)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        sim.streaming_pqtopk(codes, s, K, chunk)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    codes_d = torch.from_numpy(codes).to(dev)
    ov, oi = ops.pq_topk(codes_d, s, K)
    if not (np.array_equal(v, ov.cpu().numpy())
            and np.array_equal(i, oi.cpu().numpy().astype(np.int64))):
        raise AssertionError("stream differs from the one-shot pq_topk")
    # Per chunk: the copy (pageable, as the stream does it; and from
    # pinned memory), the kernel, the host merge.
    part_h = torch.from_numpy(codes[:chunk])
    pinned = part_h.pin_memory()
    copy_ms = time_ms(lambda: part_h.to(dev), 3)
    pinned_ms = time_ms(lambda: pinned.to(dev, non_blocking=True), 3)
    part = codes_d[:chunk]
    tile = 2048
    idx = torch.arange(ops.n_tiles(chunk, tile), dtype=torch.int32,
                       device=dev)
    kern = lambda: kernel.pq_topk_fused_cuda(part, s, K, idx,
                                             n_items=chunk, tile=tile)
    tv, ti = kern()
    err = compare("stream chunk kernel", (tv, ti), ref.pq_topk_slots(
        part, s, K, idx, n_items=chunk, tile=tile))
    kern_ms = time_ms(kern, 10, graph=True)
    cv, ci = ops._merge_slot_winners(tv, ti, K)
    cv, ci = cv.cpu().numpy(), ci.cpu().numpy()
    best = (np.full((1, K), -np.inf, np.float32), np.full((1, K), -1,
                                                          np.int64))
    t0 = time.perf_counter()
    for _ in range(20):
        sim.merge_topk_host(*best, cv, ci, 0, K)
    merge_ms = (time.perf_counter() - t0) * 1e3 / 20
    full_idx = torch.arange(ops.n_tiles(n, tile), dtype=torch.int32,
                            device=dev)
    one_shot_ms = time_ms(lambda: kernel.pq_topk_fused_cuda(
        codes_d, s, K, full_idx, n_items=n, tile=tile), 5, graph=True)
    gbps = chunk * m / copy_ms / 1e6
    pinned_gbps = chunk * m / pinned_ms / 1e6
    rate = n / med
    print(f"stream N={n} chunk={chunk} B=1: {n_chunks} chunks, "
          f"{med * 1e3:.1f}ms host clock ({rate:.4e} items/s, "
          f"{rate * m / 1e9:.3f} GB/s of codes = "
          f"{rate * m / 1e9 / gbps:.3f} of the pageable copy rate "
          f"{gbps:.3f} GB/s, {rate * m / 1e9 / pinned_gbps:.3f} of the "
          f"pinned {pinned_gbps:.3f} GB/s); per chunk: copy {copy_ms:.4f}ms "
          f"(pinned {pinned_ms:.4f}), kernel {kern_ms:.4f}ms (device), host "
          f"merge {merge_ms:.4f}ms; one-shot kernel over all {n} items "
          f"{one_shot_ms:.4f}ms (device); bit-identical to the one-shot "
          "pq_topk, chunk kernel bit-exact against its plain version")
    del codes, codes_d, part_h, pinned
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": med * 1e3, "items_per_s": rate, "copy_gbps": gbps,
            "pinned_gbps": pinned_gbps, "kernel_ms": kern_ms,
            "merge_ms": merge_ms, "one_shot_ms": one_shot_ms,
            "launches": n_chunks, "max_abs_err": err}


def request_stream(cfg, n=N_REQUESTS, seed=0):
    """``n`` user histories of 2..200 random items."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.n_items + 1,
                         int(rng.integers(2, cfg.max_seq_len + 1)))
            for _ in range(n)]


def serve(engine, histories):
    """Submit in batches of MAX_BATCH and drain each, as the serve launcher
    does.  Requests are made at submission, so a request's latency is its
    own batch's service time, not the wait behind earlier batches."""
    from repro_torch.serving.engine import Request
    out = {}
    for i in range(0, len(histories), MAX_BATCH):
        for j, h in enumerate(histories[i:i + MAX_BATCH], start=i):
            engine.submit(Request(j, h, k=K))
        out.update((r.request_id, r) for r in engine.drain())
    return out


def super_model(params, cfg):
    """The model with super-tiles of ``HIER_FACTOR`` tiles: its config and
    its parameters with the head's pruned state given the super level."""
    from repro_torch.core import pruning
    head = params["item_emb"]
    return ({**params, "item_emb": {**head, "pruned": pruning.with_super(
        head["pruned"], HIER_FACTOR)}},
            replace(cfg, pq=replace(cfg.pq, super_factor=HIER_FACTOR)))


def serve_paths(params, cfg, dev):
    """Serve the same requests through an engine per path (the fused and
    scores kernels, the plain route, the pruned cascade batch-any, grouped
    and with super-tiles), each with the launch counts set to 0 just
    before and read just after; check the counts and that every batch
    agrees with the plain or fused route.  Returns each path's launch
    counts and engine stats (with its ``req_s``: requests over the wall
    time of its serve), and each path's results."""
    import numpy as np
    from repro_torch.serving.engine import RetrievalEngine
    grouped_cfg = replace(cfg, pq=replace(cfg.pq, query_grouping=True))
    super_params, super_cfg = super_model(params, cfg)
    # (name, method, config, parameters): the pruned engines calibrate
    # their ladders at build time.
    paths = [("pqtopk_fused", "pqtopk_fused", cfg, params),
             ("pqtopk_kernel", "pqtopk_kernel", cfg, params),
             ("pqtopk", "pqtopk", cfg, params),
             ("pqtopk_pruned", "pqtopk_pruned", cfg, params),
             ("pqtopk_pruned_grouped", "pqtopk_pruned", grouped_cfg, params),
             ("pqtopk_pruned_super", "pqtopk_pruned", super_cfg,
              super_params)]
    engines = {name: RetrievalEngine.for_seqrec(p, c, k=K,
                                                max_batch=MAX_BATCH,
                                                method=method, device=dev)
               for name, method, c, p in paths}
    for eng in engines.values():                 # warm both buckets
        serve(eng, request_stream(cfg, MAX_BATCH + 1, seed=1))
        eng.latencies_ms.clear()
        eng.rung_counts.clear()

    # Each path is served with the counts at 0 and read just after; each
    # must launch its own kernels once per batch and the others not at all.
    n_batches = -(-N_REQUESTS // MAX_BATCH)
    expected = {"pqtopk_fused": {"pq_topk_fused": n_batches},
                "pqtopk_kernel": {"pq_scores": n_batches},
                "pqtopk": {},
                "pqtopk_pruned": {"pq_topk_fused": n_batches,
                                  "pq_scores": n_batches},
                "pqtopk_pruned_grouped": {"pq_topk_fused_2d": n_batches},
                "pqtopk_pruned_super": {"pq_topk_fused": n_batches,
                                        "pq_scores": n_batches}}
    outs, launches, walls = {}, {}, {}
    for name, _, _, _ in paths:
        reset_counts()
        t0 = time.monotonic()
        outs[name] = serve(engines[name], request_stream(cfg))
        walls[name] = time.monotonic() - t0
        launches[name] = read_counts()
        expect_counts(name, launches[name], **expected[name])
    stats = {name: eng.stats() for name, eng in engines.items()}
    out_plain = outs["pqtopk"]
    for rid, want in out_plain.items():
        for name in ("pqtopk_fused", "pqtopk_kernel"):
            got = outs[name][rid]
            if got.shed or not (np.array_equal(got.items, want.items)
                                and np.array_equal(got.scores,
                                                   want.scores)):
                raise AssertionError(f"{name} request {rid} differs from "
                                     "pqtopk")
        for name in ("pqtopk_pruned", "pqtopk_pruned_grouped",
                     "pqtopk_pruned_super"):
            got, fused = outs[name][rid], outs["pqtopk_fused"][rid]
            if got.shed or got.degraded or not (
                    np.array_equal(got.items, fused.items)
                    and np.array_equal(got.scores, fused.scores)):
                raise AssertionError(f"{name} request {rid} differs from "
                                     "pqtopk_fused")
        if want.items.shape != (K,) or not np.all(np.isfinite(want.scores)) \
                or want.items.min() < 0 or want.items.max() > cfg.n_items:
            raise AssertionError(f"request {rid}: bad result {want}")
    for name, st in stats.items():
        extra = (f" ladder={st['ladder']} rung_hit_fraction="
                 f"{st['rung_hit_fraction']:.4f} rung_counts="
                 f"{st['rung_counts']}" if "ladder" in st else "")
        print(f"engine {name}: served {int(st['count'])} mRT="
              f"{st['mRT_ms']:.3f}ms p99={st['p99_ms']:.3f}ms "
              f"{N_REQUESTS / walls[name]:.1f} req/s "
              f"n_compiles={int(st['n_compiles'])} shed={int(st['shed'])}"
              + extra)
        st["req_s"] = N_REQUESTS / walls[name]
    print(f"engine: {N_REQUESTS} requests in {n_batches} batches per path; "
          "pqtopk_fused and pqtopk_kernel bit-identical to pqtopk, the three "
          "pqtopk_pruned engines (batch-any, grouped, super-tiles of "
          f"{HIER_FACTOR}) bit-identical to pqtopk_fused; p99 is near the "
          "slowest batch (a request's latency is its batch's)")
    return launches, stats, outs


def live_mask(cap, n_real, tile, seed):
    """~10% random tombstones, tile 5 fully dead, rows past ``n_real`` dead
    (a mutable catalogue's capacity padding); rows 3 and cap/2 (planted
    ties, see ``pq_inputs``) live."""
    import torch
    g = torch.Generator().manual_seed(seed)
    live = torch.rand(cap, generator=g) > 0.1
    live[n_real:] = False
    live[5 * tile:6 * tile] = False
    live[[3, cap // 2]] = True
    return live


def check_live_kernel(dev):
    """The fused kernel's tombstone-masked form (d) against its plain
    version, bit-exact, on uint16 codes: the identity list at full width
    (capacity 2,097,152, 1,271,639 real rows), and at a smaller capacity
    the identity list, a list with ``-1`` sentinels and 2D tables at
    batch_tile 8 and 16, at tile 2048 and 1000; and the same smaller forms
    on int32 codes at m=4, b=256 with one query (the QB=1 layout).
    Returns the max abs error."""
    import torch
    from repro_torch.kernels.pqtopk import kernel, ops, ref
    err = 0.0
    for ci, (cap, n_real, dtype, m, b, bq) in enumerate((
            (2_097_152, 1_271_639, torch.uint16, 8, 512, 64),
            (131_072, 100_003, torch.uint16, 8, 512, 5),
            (131_072, 100_003, torch.int32, 4, 256, 1))):
        full = cap > 1_000_000
        for tile in ((2048,) if full else (2048, 1000)):
            live = live_mask(cap, n_real, tile, seed=30 + ci).to(dev)
            nt = ops.n_tiles(cap, tile)
            codes, s = pq_inputs(cap, m, b, bq, dtype, seed=20 + ci, dev=dev)
            forms = [("identity", torch.arange(nt, dtype=torch.int32), 0, s)]
            if not full:
                forms.append(("sentinel", torch.tensor(
                    [-1, nt - 1, 0, -1, 5, 0, -1], dtype=torch.int32), 0, s))
            for bt in (8, 16):
                bq2 = 64 if full else 2 * bt + 5
                _, s2 = pq_inputs(cap, m, b, bq2, dtype, seed=40 + bt + ci,
                                  dev=dev)
                table = table_2d(nt, -(-bq2 // bt), min(nt, 40 if full else 6),
                                 seed=bt + ci)
                table[0, :2] = torch.tensor([0, 5])   # a live and a dead tile
                forms.append((f"2D bt={bt}", table, bt, s2))
            for what, idx, bt, sq in forms:
                idx = idx.to(dev)
                for k in ((16, 100) if full and bt == 0 else (1, 16, 100)):
                    got = kernel.pq_topk_fused_cuda(
                        codes, sq, k, idx, n_items=cap, tile=tile,
                        batch_tile=bt, live=live)
                    want = ref.pq_topk_slots(codes, sq, k, idx, n_items=cap,
                                             tile=tile, batch_tile=bt,
                                             live=live)
                    err = max(err, compare(
                        f"pq_topk_fused live {what} cap={cap} tile={tile} "
                        f"k={k}", got, want))
                    ids = want[1][torch.isfinite(want[0])].long()
                    if not bool(live[ids].all()):
                        raise AssertionError(f"live {what}: a dead id won")
            torch.cuda.synchronize()
            print(f"kernel check live: {dtype} m={m} B={bq} cap={cap} real="
                  f"{n_real} tile={tile}: {', '.join(f[0] for f in forms)} "
                  "bit-exact (10% tombstones, a dead tile, dead padding)")
    return err


def left_padded(histories, seq_len):
    """The engine's batch layout: histories left-padded with id 0."""
    import numpy as np
    seqs = np.zeros((len(histories), seq_len), np.int32)
    for i, h in enumerate(histories):
        t = np.asarray(h)[-seq_len:]
        seqs[i, -len(t):] = t
    return seqs


def masked_oracle(params, cfg, mstate, histories):
    """The plain masked exhaustive route on the card: every capacity row
    scored (plain ``pq_scores``), dead rows -inf, stable top-K, ``-inf``
    winners -> the capacity id.  -> (vals, ids) numpy."""
    import torch
    from repro_torch.core import scoring, topk as topk_lib
    from repro_torch.kernels.pqtopk import ref
    from repro_torch.models import seqrec
    head = {**params["item_emb"], **mstate.head_arrays()}
    seqs = torch.from_numpy(left_padded(histories, cfg.max_seq_len)).to(
        mstate.codes.device)
    with torch.inference_mode():
        phi = seqrec.sequence_embedding({**params, "item_emb": head}, seqs,
                                         cfg)
        s = scoring.subid_scores(head["sub_emb"], phi)
        sc = torch.where(mstate.live[None, :], ref.pq_scores(mstate.codes, s),
                         float("-inf"))
        v, i = topk_lib.topk(sc, K)
        i = torch.where(v == float("-inf"), mstate.cap, i)
    return v.cpu().numpy(), i.cpu().numpy()


def serve_mutable(engine, mstate, params, cfg, histories, log, seed):
    """Serve ``histories`` in batches of MAX_BATCH; after each batch check
    that no dead id was returned (and, for the first ORACLE_BATCHES, that
    the batch equals the masked oracle bit for bit), then draw CHURN_OPS
    mutations (the serve launcher's mix), commit them to ``log`` and swap
    the head.  Returns (results, swaps, batches)."""
    import numpy as np
    from repro_torch.launch.serve import _churn_ops
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    out, swaps, n_batches = {}, 0, 0
    for i in range(0, len(histories), MAX_BATCH):
        batch = histories[i:i + MAX_BATCH]
        for j, h in enumerate(batch, start=i):
            engine.submit(Request(j, h, k=K))
        res = engine.drain()
        live = mstate.live.cpu().numpy()
        for r in res:
            if r.shed or r.items.shape != (K,) or not live[r.items].all():
                raise AssertionError(f"mutable request {r.request_id}: "
                                     f"shed or a dead item {r.items}")
        if n_batches < ORACLE_BATCHES:
            ov, oi = masked_oracle(params, cfg, mstate, batch)
            for r in res:
                q = r.request_id - i
                if not (np.array_equal(r.items, oi[q])
                        and np.array_equal(r.scores, ov[q])):
                    raise AssertionError(f"mutable batch {n_batches} request "
                                         f"{r.request_id} differs from the "
                                         "masked oracle")
        out.update((r.request_id, r) for r in res)
        n_batches += 1
        ops = _churn_ops(mstate, rng, CHURN_OPS, cfg.pq.b)
        log.append_many(ops)
        log.maybe_snapshot(mstate)
        engine.swap_head_state(mstate)
        swaps += 1
    return out, swaps, n_batches


def mutable_path(params, cfg, dev, n_sms, frozen_stats):
    """The mutable catalogue at full width: a bitmask engine over 100
    batches (oracle checks, launch counts, constant serve variants, the
    durable log and its recovery), a range engine and a bitmask engine
    with super-tiles (16 supers of 64 tiles) over fewer batches, the
    masked cascade's time split and the live kernel's record."""
    import numpy as np
    import torch
    from repro_torch.core import pruning, scoring
    from repro_torch.core.mutation import MutableHeadState
    from repro_torch.core.pruning import ARRAY_FIELDS
    from repro_torch.kernels.pqtopk import kernel, ref
    from repro_torch.models import seqrec
    from repro_torch.serving.catalogue_log import CatalogueLog
    from repro_torch.serving.engine import RetrievalEngine
    out = {}
    with tempfile.TemporaryDirectory() as log_dir:
        for label, backend, factor, n_req in (
                ("bitmask", "bitmask", 0, N_REQUESTS),
                ("range", "range", 0, 1280),
                ("bitmask+super", "bitmask", HIER_FACTOR, 1280)):
            t0 = time.monotonic()
            mstate = MutableHeadState.build(params["item_emb"]["codes"],
                                            cfg.pq.b, backend=backend,
                                            super_factor=factor)
            cfg_l = super_model(params, cfg)[1] if factor else cfg
            eng = RetrievalEngine.for_seqrec_mutable(
                params, cfg_l, mstate, k=K, max_batch=MAX_BATCH, device=dev)
            serve(eng, request_stream(cfg, MAX_BATCH + 1, seed=1))  # warm-up
            eng.latencies_ms.clear()
            eng.rung_counts.clear()
            n_compiles = eng.stats()["n_compiles"]
            print(f"mutable {label}: capacity={mstate.cap} tiles="
                  f"{mstate.state.n_tiles} supers="
                  f"{mstate.state.n_super if factor else 0} ladder="
                  f"{eng.ladder} built in {time.monotonic() - t0:.1f}s")
            log = CatalogueLog(os.path.join(log_dir, label),
                               snapshot_every=300)
            log.snapshot(mstate)
            reset_counts()
            res, swaps, n_batches = serve_mutable(
                eng, mstate, params, cfg, request_stream(cfg, n_req, seed=3),
                log, seed=4)
            got = read_counts()
            expect_counts(f"pqtopk_pruned_mutable {label}", got,
                          pq_topk_fused_live=n_batches, pq_scores=n_batches)
            st = eng.stats()
            if st["n_compiles"] != n_compiles or st["n_swaps"] != swaps:
                raise AssertionError(
                    f"mutable {label}: n_compiles {n_compiles} -> "
                    f"{st['n_compiles']}, n_swaps {st['n_swaps']} != {swaps}")
            print(f"engine pqtopk_pruned_mutable {label}: served "
                  f"{int(st['count'])} in {n_batches} batches mRT="
                  f"{st['mRT_ms']:.3f}ms p99={st['p99_ms']:.3f}ms "
                  f"rung_hit_fraction={st['rung_hit_fraction']:.4f} "
                  f"n_compiles={int(st['n_compiles'])} n_swaps="
                  f"{int(st['n_swaps'])} n_live={mstate.n_live} "
                  f"stale_tiles={int(mstate.stats()['stale_tiles'])}; no dead "
                  f"id, first {ORACLE_BATCHES} batches bit-identical to the "
                  "masked oracle")
            out[label] = (mstate, got)
            # ---- durability: recover the log, bit for bit -----------
            log.close()
            t0 = time.monotonic()
            rec, lsn = CatalogueLog(os.path.join(log_dir, label)).recover(
                device=dev, verify=True)
            want_state = mstate.clone()
            want_state.retighten()
            same = (lsn == log.lsn and rec.free == mstate.free
                    and rec.n_rows == mstate.n_rows
                    and torch.equal(rec.codes, mstate.codes)
                    and torch.equal(rec.live, mstate.live)
                    and rec.super_factor == factor
                    and all((getattr(rec.state, f) is None
                             and getattr(want_state.state, f) is None)
                            or torch.equal(getattr(rec.state, f),
                                           getattr(want_state.state, f))
                            for f in ARRAY_FIELDS))
            if not same:
                raise AssertionError(f"durability {label}: recovered state "
                                     "differs from the in-memory one")
            ls = log.stats()
            print(f"durability {label}: lsn={lsn} snapshots="
                  f"{int(ls['n_snapshots'])} latest_snapshot_lsn="
                  f"{int(ls['latest_snapshot_lsn'])} log_bytes="
                  f"{int(ls['log_bytes'])}; recovered (verify) bit-identical "
                  f"to the in-memory state in {time.monotonic() - t0:.1f}s")
    fz = frozen_stats["pqtopk_pruned"]
    print(f"engine pqtopk_pruned (frozen, same run): mRT={fz['mRT_ms']:.3f}ms "
          f"p99={fz['p99_ms']:.3f}ms rung_hit_fraction="
          f"{fz['rung_hit_fraction']:.4f}")

    # ---- the masked cascade on one batch: split and the live kernel ----
    mstate, launches = out["bitmask"][0], out["bitmask"][1]
    head = {**params["item_emb"], **mstate.head_arrays()}
    rng = np.random.default_rng(5)
    seqs = torch.from_numpy(rng.integers(
        1, cfg.n_items + 1, (MAX_BATCH, cfg.max_seq_len)).astype(np.int32)
    ).to(dev)
    codes, live, cap = mstate.codes, mstate.live, mstate.cap
    m, b = codes.shape[1], cfg.pq.b
    with torch.inference_mode():
        phi = seqrec.sequence_embedding({**params, "item_emb": head}, seqs,
                                         cfg)
        s = scoring.subid_scores(head["sub_emb"], phi).contiguous()
        for label, (ms, _) in out.items():
            _, _, cs = pruning.cascade_topk_ingraph(
                ms.codes, s, K_KERNEL, ms.state, live=ms.live,
                return_stats=True)
            print(f"mutable cascade {label}: n_tiles={cs['n_tiles']} "
                  f"n_survived={cs['n_survived']} n_scored={cs['n_scored']} "
                  f"n_super={cs['n_super']} n_super_survived="
                  f"{cs['n_super_survived']} bounds_computed="
                  f"{cs['bounds_computed']}")
        state = mstate.state
        tile = state.tile
        bounds = pruning.tile_bounds(state, s)
        theta = pruning.theta_seed_ingraph(codes, s, bounds, K_KERNEL,
                                           tile=tile, live=live)[0]
        slots, count = pruning.compact_mask(pruning.survival_mask(bounds,
                                                                  theta))
        whole = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pruning.cascade_topk_ingraph(codes, s, K_KERNEL, state, live=live)
            torch.cuda.synchronize()
            whole.append((time.perf_counter() - t0) * 1e3)
        kern = lambda: kernel.pq_topk_fused_cuda(
            codes, s, K_KERNEL, slots, n_items=cap, tile=tile, live=live)
        split = {"bounds": time_ms(lambda: pruning.tile_bounds(state, s), 10),
                 "theta": time_ms(lambda: pruning.theta_seed_ingraph(
                     codes, s, bounds, K_KERNEL, tile=tile, live=live), 10),
                 "kernel": compare_timed(
                     "pq_topk_fused_live", kern, lambda bl: bl.pq_topk_fused(
                         codes, s, K_KERNEL, slots, n_items=cap, tile=tile,
                         live=live))}
        plain = time_ms(lambda: ref.pq_topk_slots(
            codes, s, K_KERNEL, slots, n_items=cap, tile=tile, live=live), 3)
        print(f"split mutable batch-any (bitmask, greedy, B={MAX_BATCH}, "
              f"{slots.numel()} slots, {int(count)} survivors): "
              + ", ".join(f"{k} {v:.4f}ms" for k, v in split.items())
              + f"; whole cascade {statistics.median(whole):.4f}ms host clock")
    # Work this list needs: every row of a listed tile reads its live byte;
    # only live rows read their codes and look up S.
    tiles = [t for t in slots.tolist() if t >= 0]
    rows = sum(min(tile, cap - t * tile) for t in tiles)
    live_rows = int(live.view(-1, tile)[tiles].sum())
    nbytes = (rows + live_rows * m * 2 + MAX_BATCH * m * b * 4
              + slots.numel() * 4 + MAX_BATCH * slots.numel() * K_KERNEL * 8)
    pairs = MAX_BATCH * live_rows
    bnd, by, terms = bound_ms(nbytes, pairs * (m - 1), pairs * m, n_sms)
    print(f"bound pq_topk_fused_live: {terms} ms ({pairs} scored query-item "
          f"pairs, {len(tiles)} of {slots.numel()} slots listed)")
    return {"ms": split["kernel"], "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by,
            "launches": launches["pq_topk_fused_live"]}


# ---- item-sharded serving (shards on one card) --------------------------
SHARD_COUNTS = (1, 2, 4)
SHARD_BATCHES = 20                 # batches of 64 per sharded path
SKEW_SHARDS, SKEW_FACTOR = 4, 4    # the skewed catalogue's mesh, supers


def check_shard_kernels(codes, s, n_sms):
    """Both pqtopk kernels at the sharded paths' per-shard shapes, bit for
    bit against their plain versions on the same inputs: the last shard's
    padded block at S = 2 and 4 (n_local rows), the fused kernel's form
    (a) at k + pad (the fused route's oversample at the engine's k bucket)
    and ``pq_scores``; and the pruned form (b) at the sharded state's tile
    (2,048 + pad at the engine's k_hint), which ``ops.pq_topk_tiles``
    scores as kernel-sized parts, against the plain version at the whole
    tile.  Returns ({name: max abs error}, {(S, name): record})."""
    import torch
    from repro_torch.distributed.sharding import shard_rows
    from repro_torch.kernels.pqtopk import kernel, ops, ref
    from repro_torch.launch.mesh import make_mesh
    n, m = codes.shape
    bq, _, b = s.shape
    err, recs = {"pq_scores": 0.0, "pq_topk_fused": 0.0}, {}
    for n_shards in (2, 4):
        last = shard_rows(codes, make_mesh(n_shards, [codes.device] *
                                           n_shards))[-1]
        n_local = last.shape[0]
        pad = n_shards * n_local - n
        k_local = K_KERNEL + pad
        tile = 2048
        idx = torch.arange(ops.n_tiles(n_local, tile), dtype=torch.int32,
                           device=codes.device)
        fused = lambda: kernel.pq_topk_fused_cuda(last, s, k_local, idx,
                                                  n_items=n_local, tile=tile)
        plain = lambda: ref.pq_topk_slots(last, s, k_local, idx,
                                          n_items=n_local, tile=tile)
        err["pq_topk_fused"] = max(err["pq_topk_fused"], compare(
            f"shard S={n_shards} pq_topk_fused (a)", fused(), plain()))
        err["pq_scores"] = max(err["pq_scores"], compare(
            f"shard S={n_shards} pq_scores",
            (kernel.pq_scores_cuda(last, s),), (ref.pq_scores(last, s),)))
        big = 2048 + pad
        nt = ops.n_tiles(n_local, big)
        sl = torch.tensor([0, 5, nt - 1] + [-1] * 5, dtype=torch.int32,
                          device=codes.device)
        tv, ti = ref.pq_topk_slots(last, s, k_local, sl, n_items=n_local,
                                   tile=big)
        err["pq_topk_fused"] = max(err["pq_topk_fused"], compare(
            f"shard S={n_shards} pq_topk_fused (b) tile {big} split "
            f"{ops.split_factor(big)}",
            ops.pq_topk_tiles(last, s, k_local, sl, tile=big),
            ops._merge_slot_winners(tv, ti, k_local)))
        code_b = codes.element_size()
        for name, fn, pfn, nbytes in (
                ("pq_topk_fused", fused, plain,
                 n_local * m * code_b + bq * m * b * 4
                 + bq * idx.numel() * k_local * 8),
                ("pq_scores", lambda: kernel.pq_scores_cuda(last, s),
                 lambda: ref.pq_scores(last, s),
                 n_local * m * code_b + bq * m * b * 4 + bq * n_local * 4)):
            bnd, by, _ = bound_ms(nbytes, bq * n_local * (m - 1),
                                  bq * n_local * m, n_sms)
            recs[(n_shards, name)] = rec = {
                "ms": time_ms(fn, 20, graph=True), "plain_ms": time_ms(pfn, 3),
                "bound_ms": bnd, "bound_by": by}
            print(f"kernel {name} shard S={n_shards}: N_local={n_local} "
                  f"k={k_local if name == 'pq_topk_fused' else '-'} "
                  f"{rec['ms']:.4f}ms plain {rec['plain_ms']:.4f}ms bound "
                  f"{bnd:.4f}ms ({by}); bit-exact")
    torch.cuda.synchronize()
    return err, recs


def identity_head(codes, s):
    """A head whose sub-id scores ARE ``s``: sub-embeddings the identity per
    split (d = m * b), phi the flattened S (products by 1 and 0, exact)."""
    import torch
    m, b = s.shape[1], s.shape[2]
    eye = torch.eye(b, device=s.device).expand(m, b, b).contiguous()
    return {"codes": codes, "sub_emb": eye}, s.reshape(s.shape[0], m * b)


def sharded_phase(params, cfg, dev, outs, n_sms):
    """The item-sharded routes on one card (``["cuda:0"] * S``): the
    kernels at the per-shard shapes; engines at S = 1, 2 and 4 for every
    engine path, each over the engine phase's first SHARD_BATCHES batches
    with the counts at 0 just before and read just after (each kernel
    once per shard per batch), bit-identical to that path's flat engine;
    the sharded cascade on the skewed catalogue at S=4 (batch-any,
    grouped, hierarchical) and under the ``live`` mask at the mutable
    capacity, each bit-identical to the flat cascade; and a healthy K=2
    fabric of 2-shard fused engines, bit-identical to the flat fused
    engine."""
    import numpy as np
    import torch
    from repro_torch.core import pruning, retrieval_head as rh, scoring
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import seqrec
    from repro_torch.serving.engine import RetrievalEngine
    from repro_torch.serving.router import ReplicaRouter
    t_phase = time.monotonic()
    hist = request_stream(cfg)[:SHARD_BATCHES * MAX_BATCH]
    grouped_cfg = replace(cfg, pq=replace(cfg.pq, query_grouping=True))
    super_params, super_cfg = super_model(params, cfg)
    # (name, method, config, parameters, kernels launched once a shard)
    paths = [("pqtopk_fused", "pqtopk_fused", cfg, params,
              ("pq_topk_fused",)),
             ("pqtopk_kernel", "pqtopk_kernel", cfg, params, ("pq_scores",)),
             ("pqtopk", "pqtopk", cfg, params, ()),
             ("pqtopk_pruned", "pqtopk_pruned", cfg, params,
              ("pq_topk_fused", "pq_scores")),
             ("pqtopk_pruned_grouped", "pqtopk_pruned", grouped_cfg, params,
              ("pq_topk_fused_2d",)),
             ("pqtopk_pruned_super", "pqtopk_pruned", super_cfg,
              super_params, ("pq_topk_fused", "pq_scores"))]
    head = params["item_emb"]
    seqs = torch.from_numpy(left_padded(hist[:MAX_BATCH], cfg.max_seq_len)
                            ).to(dev)
    with torch.inference_mode():
        s = scoring.subid_scores(head["sub_emb"],
                                 seqrec.sequence_embedding(params, seqs, cfg))
    err, kernel_recs = check_shard_kernels(head["codes"], s.contiguous(),
                                           n_sms)
    launches, lines = {}, {}
    for n_shards in SHARD_COUNTS:
        mesh = make_mesh(n_shards, [dev] * n_shards)
        for name, method, c, p, kernels in paths:
            eng = RetrievalEngine.for_seqrec(p, c, k=K, max_batch=MAX_BATCH,
                                             method=method,
                                             sharded_mesh=mesh, device=dev)
            serve(eng, request_stream(cfg, MAX_BATCH + 1, seed=1))
            eng.latencies_ms.clear()
            eng.rung_counts.clear()
            reset_counts()
            got = serve(eng, hist)
            launches[(n_shards, name)] = counts = read_counts()
            expect_counts(f"sharded S={n_shards} {name}", counts,
                          **{kn: n_shards * SHARD_BATCHES for kn in kernels})
            for rid, r in got.items():
                w = outs[name][rid]
                if r.shed or r.degraded or not (
                        np.array_equal(r.items, w.items)
                        and np.array_equal(r.scores, w.scores)):
                    raise AssertionError(f"sharded S={n_shards} {name} "
                                         f"request {rid} differs from the "
                                         "flat engine")
            st = eng.stats()
            extra = (f" ladder={st['ladder']} rung_counts={st['rung_counts']}"
                     if "ladder" in st else "")
            lines[(n_shards, name)] = st
            print(f"sharded S={n_shards} {name}: served {int(st['count'])} "
                  f"mRT={st['mRT_ms']:.3f}ms p99={st['p99_ms']:.3f}ms "
                  f"launches {counts}{extra}; bit-identical to the flat "
                  "engine")
            del eng
    torch.cuda.synchronize()

    # ---- the skewed catalogue at S=4 --------------------------------
    n, m, b, bq = 1_271_638, 8, 512, MAX_BATCH
    codes = torch.from_numpy(clustered_codes(n, m, b)).to(dev)
    mesh = make_mesh(SKEW_SHARDS, [dev] * SKEW_SHARDS)
    flat = pruning.build_pruned_state(codes, b)
    for batch, shape, grouped, factor in (
            ("shared", dict(spread=0.0, power=2), False, 0),
            ("mixed", dict(spread=0.25, power=3), True, 0),
            ("shared", dict(spread=0.0, power=2), False, SKEW_FACTOR)):
        sq = torch.from_numpy(window_scores(bq, m, b, 0, **shape)).to(dev)
        hp, phi = identity_head(codes, sq)
        if not torch.equal(rh._subid_scores(hp, phi), sq):
            raise AssertionError("identity head: S not reproduced")
        hp = rh.ensure_sharded_pruned_state(hp, mesh, k_hint=K_KERNEL,
                                            super_factor=factor)
        pq = replace(cfg.pq, query_grouping=grouped, n_groups=8,
                     super_factor=factor)
        t0 = time.perf_counter()
        v, i, st = rh.top_items_pruned_sharded(hp, phi, K_KERNEL, mesh,
                                               pq_cfg=pq, return_stats=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        fv, fi = pruning.cascade_topk_ingraph(
            codes, sq, K_KERNEL, pruning.with_super(flat, factor),
            query_grouping=grouped, n_groups=8)
        what = (f"sharded cascade S={SKEW_SHARDS} {batch} "
                + ("grouped" if grouped else
                   f"hier factor {factor}" if factor else "batch-any"))
        if not same_bits((v, i), (fv, fi)):
            raise AssertionError(f"{what}: differs from the flat cascade")
        print(f"{what}: n_survived={st['n_survived']}/{st['n_tiles']} "
              f"n_scored={st['n_scored']} pairs_scored/pairs_union="
              f"{st['pairs_scored']}/{st['pairs_union']} bounds_computed="
              f"{st['bounds_computed']} n_super_survived="
              f"{st['n_super_survived']}/{st['n_super']} max_group="
              f"{st['max_group_survived']} rung_hit={st['rung_hit']}; "
              f"{ms:.3f}ms host clock (first call); bit-identical to the "
              "flat cascade")

    # ---- tombstones at the mutable capacity -------------------------
    cap = 1 << 21
    codes_cap = torch.cat([codes, codes.new_zeros((cap - n, m))])
    live = live_mask(cap, n, 2048, seed=50).to(dev)
    sq = torch.from_numpy(window_scores(bq, m, b, 1, spread=0.0, power=2)
                          ).to(dev)
    hp, phi = identity_head(codes_cap, sq)
    hp["live"] = live
    v, i, st = rh.top_items_pruned_sharded(hp, phi, K_KERNEL, mesh,
                                           return_stats=True)
    fv, fi = pruning.cascade_topk_ingraph(
        codes_cap, sq, K_KERNEL,
        pruning.build_pruned_state_masked(codes_cap, live, b), live=live)
    if not same_bits((v, i), (fv, fi)):
        raise AssertionError("sharded live cascade differs from the flat "
                             "masked cascade")
    if not bool(live[i[torch.isfinite(v)].long()].all()):
        raise AssertionError("sharded live cascade served a dead id")
    print(f"sharded live S={SKEW_SHARDS} cap={cap}: n_survived="
          f"{st['n_survived']}/{st['n_tiles']} n_scored={st['n_scored']}; "
          "bit-identical to the flat masked cascade, no dead id")

    # ---- a healthy K=2 fabric of 2-shard fused engines ---------------
    with ReplicaRouter.for_seqrec(
            params, cfg, n_replicas=2, k=K, max_batch=MAX_BATCH,
            method="pqtopk_fused", sharded_mesh=make_mesh(2, [dev] * 2),
            device=dev, degrade_high=1 << 30) as router:
        router.warmup()
        reset_counts()
        res, wall = drive(router, hist)
        settle(router)
        jobs = launched_jobs(router)
        expect_counts("sharded router K=2 S=2", read_counts(),
                      pq_topk_fused=2 * jobs)
        if sorted(res) != list(range(len(hist))):
            raise AssertionError("sharded router: not one Result per request")
        if check_untagged("sharded router", res, outs["pqtopk_fused"]) \
                != len(hist):
            raise AssertionError("sharded router: results tagged or shed")
        router_line("sharded K=2 S=2", router, res, wall)
    print(f"sharded phase: {time.monotonic() - t_phase:.1f}s")
    return {"launches": launches, "stats": lines, "err": err,
            "kernels": kernel_recs}


# ---- the replicated fabric (serving/router.py) -------------------------
ROUTER_SCALING = (1, 2, 4)         # replicas of the scaling lines
# ... each driven at these windows: two batches (what one replica keeps in
# flight) and two batches a replica of the largest fleet.
SCALING_WINDOWS = (2 * MAX_BATCH, 2 * max(ROUTER_SCALING) * MAX_BATCH)
DURABLE_BATCHES = 20               # mutable fabric: logged churn between each
CRASH_AT_BATCH = 8                 # ... and replica 1 crashed after this one


def drive(router, histories, base=0, window=None, ids=None):
    """Submit ``histories`` in batches of MAX_BATCH (request id ``base + j``
    for history ``j``, so each batch is one the engine phase served),
    keeping at most ``window`` requests unanswered (closed loop; default:
    two batches in flight per replica), and drain.  Returns ({id: Result},
    wall seconds)."""
    window = window or 2 * router.n_replicas * MAX_BATCH
    from repro_torch.serving.engine import Request
    t0 = time.monotonic()
    done0 = len(router._done_ids)
    sent = 0
    while sent < len(histories):
        while sent < len(histories) and \
                sent - (len(router._done_ids) - done0) < window:
            for j in range(sent, min(sent + MAX_BATCH, len(histories))):
                router.submit(Request(base + j, histories[j], k=K))
            sent += MAX_BATCH
        router.pump(block=True, timeout=0.01)
    out = {r.request_id: r for r in router.drain(timeout_s=120.0)}
    return out, time.monotonic() - t0


def settle(router, timeout_s=60.0):
    """Pump until no job is queued or in flight on any replica (a hedge's
    slower copy included), then wait for the card."""
    import torch
    t0 = time.monotonic()
    while any(rs.inflight for rs in router.replicas) or router._jobs:
        router.pump(block=True, timeout=0.01)
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError("router did not settle")
    torch.cuda.synchronize()


def launched_jobs(router):
    """Jobs the replicas launched: every dispatch that did not fail (each
    one that got past its fault plan launched exactly one batch)."""
    st = router.stats()["replicas"]
    done = sum(r["completed"] for r in st.values())
    if done != sum(r["dispatched"] - r["failures"] for r in st.values()):
        raise AssertionError(f"router jobs do not add up: {st}")
    return done


def check_untagged(what, res, want, base=0):
    """Untagged results bit-identical to the fused engine's for the same
    history; returns how many were checked."""
    import numpy as np
    n = 0
    for rid, r in res.items():
        if r.degraded or r.shed:
            continue
        w = want[(rid - base) % N_REQUESTS]
        if not (np.array_equal(r.items, w.items)
                and np.array_equal(r.scores, w.scores)):
            raise AssertionError(f"{what}: request {rid} on replica "
                                 f"{r.replica} differs from the engine")
        n += 1
    return n


def router_line(what, router, res, wall, window=None):
    """One line of the fabric's numbers.  ``window``: the closed loop's
    bound on unanswered requests, printed with the latency it alone
    implies (window / throughput, Little's law)."""
    st = router.stats()
    per = " ".join(f"r{rid}={rep['completed']}"
                   for rid, rep in st["replicas"].items())
    little = (f" window={window} window/throughput="
              f"{window * wall / len(res) * 1e3:.3f}ms" if window else "")
    print(f"router {what}: {len(res)} requests {len(res) / wall:.1f} req/s "
          f"p50={st['p50_ms']:.3f}ms p99={st['p99_ms']:.3f}ms{little} "
          "completions "
          f"{per} hedges={int(st['hedges'])} hedge_wins="
          f"{int(st['hedge_wins'])} dup_suppressed="
          f"{int(st['duplicates_suppressed'])} redispatched="
          f"{int(st['redispatched'])} degraded={st['degraded_results']}")
    return st


def router_phase(params, cfg, dev, fused_out, path_stats):
    """The replicated fabric at full width, each part with the launch counts
    set to 0 after its warm-up and read after it: a healthy K=2 fused
    fabric over the engine phase's 6,400 histories (untagged results
    bit-identical to the fused engine's, form (a) once per launched job,
    no pq_scores); the serve launcher's --chaos plan on K=3 (crash window
    (1, 4) on replica 1, ejected at its first failure; a 250 ms straggle
    window (0, 3) on replica 2): one Result per request, an ejection and a
    re-admission, a hedge and its suppressed duplicate; the load ladder
    (k-capped results are prefixes of the exact ones, shed ones tagged,
    the level back at 0); K = 1, 2, 4 without hedging, each at windows of
    two and eight batches and at two batches a replica (req/s, p50, p99,
    the window's own queue time, per-replica completions beside the
    engine's); and a durable mutable
    K=2 fabric (capacity 2,097,152) with logged churn and a crashed
    replica, recovered from the log, re-admitted only after it, then equal
    to the writer's catalogue bit for bit and serving batches equal to the
    masked oracle's."""
    import numpy as np
    import torch
    from repro_torch.core.mutation import MutableHeadState
    from repro_torch.core.pruning import ARRAY_FIELDS
    from repro_torch.launch.serve import _churn_ops
    from repro_torch.serving.catalogue_log import CatalogueLog
    from repro_torch.serving.engine import Request
    from repro_torch.serving.router import ReplicaRouter
    from repro_torch.training.fault_tolerance import ReplicaFaultPlan
    t_phase = time.monotonic()
    hist = request_stream(cfg)
    fz = path_stats["pqtopk_fused"]
    kw = dict(k=K, max_batch=MAX_BATCH, method="pqtopk_fused", device=dev)
    # The closed loop keeps up to two batches a replica unanswered: the
    # ladder's watermarks (default 256) are out of its way but in the
    # ladder part's.
    calm = dict(degrade_high=1 << 30, **kw)

    # ---- healthy K=2 -------------------------------------------------
    with ReplicaRouter.for_seqrec(params, cfg, n_replicas=2,
                                  **calm) as router:
        router.warmup()
        reset_counts()
        res, wall = drive(router, hist)
        settle(router)
        jobs = launched_jobs(router)
        expect_counts("router healthy K=2", read_counts(), pq_topk_fused=jobs)
        if sorted(res) != list(range(N_REQUESTS)):
            raise AssertionError("router healthy: not one Result per request")
        n = check_untagged("router healthy", res, fused_out)
        if n != N_REQUESTS:
            raise AssertionError(f"router healthy: {N_REQUESTS - n} results "
                                 "tagged or shed")
        router_line("healthy K=2", router, res, wall)
    print(f"router healthy K=2: {n} results bit-identical to the fused "
          f"engine's, {jobs} jobs = {jobs} form (a) launches, pq_scores 0")

    # ---- chaos: the --chaos plan, K=3 ---------------------------------
    plans = {1: ReplicaFaultPlan(crash_windows=((1, 4),)),
             2: ReplicaFaultPlan(slow_windows=((0, 3),), slow_ms=250.0)}
    with ReplicaRouter.for_seqrec(params, cfg, n_replicas=3, fault_plans=plans,
                                  suspect_after=1, eject_after=1,
                                  cooldown_ms=20.0, **calm) as router:
        router.warmup()
        reset_counts()
        res, wall = drive(router, hist)
        extra = 0
        while router.replicas[1].readmissions == 0:
            more, _ = drive(router, hist[:2 * MAX_BATCH],
                            base=N_REQUESTS * (2 + extra))
            res.update(more)
            extra += 1
            if extra > 50:
                raise AssertionError("chaos: replica 1 never re-admitted")
        settle(router)
        jobs = launched_jobs(router)
        expect_counts("router chaos K=3", read_counts(), pq_topk_fused=jobs)
        if sorted(res) != sorted(router._expected) \
                or router._expected != router._done_ids:
            raise AssertionError("chaos: not exactly one Result per request")
        st = router_line("chaos K=3", router, res, wall)
        r1 = st["replicas"][1]
        if r1["ejections"] < 1 or r1["readmissions"] < 1 \
                or st["hedges"] < 1 or st["hedge_wins"] < 1 \
                or st["duplicates_suppressed"] < 1:
            raise AssertionError(f"chaos: expected an ejection, a "
                                 f"re-admission and a suppressed hedge: {st}")
        n = check_untagged("router chaos", res, fused_out)
        print(f"router chaos K=3: {len(res)} requests, each answered once; "
              f"replica 1 failures={r1['failures']} ejections="
              f"{r1['ejections']} readmissions={r1['readmissions']}; "
              f"ejection to re-admission (replica: ms) "
              + ", ".join(f"{rid}: {t:.1f}" for rid, t in router.readmit_ms)
              + "; stragglers " + ", ".join(
                  f"{rid}: {rep['stragglers']}"
                  for rid, rep in st["replicas"].items()) + "; "
              f"{n} untagged results bit-identical; {jobs} jobs = form (a) "
              "launches")

    # ---- the load ladder ----------------------------------------------
    with ReplicaRouter.for_seqrec(params, cfg, n_replicas=2, hedge=False,
                                  degrade_high=256, degrade_low=64,
                                  degrade_k_cap=4, recover_patience=3,
                                  **kw) as router:
        router.warmup()
        reset_counts()
        base = 100 * N_REQUESTS
        burst = 16 * MAX_BATCH
        for j in range(burst):
            router.submit(Request(base + j, hist[j], k=K))
        for _ in range(20):
            router.pump()
            if router.level == 3:
                break
        if router.level != 3:
            raise AssertionError(f"ladder reached level {router.level}, "
                                 "not 3")
        for j in range(burst, burst + MAX_BATCH):       # shed at submit
            router.submit(Request(base + j, hist[j], k=K))
        res = {r.request_id: r for r in router.drain(timeout_s=120.0)}
        t0 = time.monotonic()
        while router.level:
            router.pump(block=True, timeout=0.01)
            if time.monotonic() - t0 > 30:
                raise AssertionError("ladder did not recover to level 0")
        settle(router)
        jobs = launched_jobs(router)
        expect_counts("router ladder", read_counts(), pq_topk_fused=jobs)
        tags = {}
        for rid, r in res.items():
            tags[r.degraded] = tags.get(r.degraded, 0) + 1
            w = fused_out[rid - base]
            if r.degraded == "load_shed":
                ok = r.shed and r.items.size == 0
            elif r.degraded == "k_cap":
                ok = (r.items.shape == (4,)
                      and np.array_equal(r.items, w.items[:4])
                      and np.array_equal(r.scores, w.scores[:4]))
            else:
                ok = r.degraded == "" and np.array_equal(r.items, w.items) \
                    and np.array_equal(r.scores, w.scores)
            if not ok:
                raise AssertionError(f"ladder: request {rid} ({r.degraded!r})"
                                     " is wrong or untagged")
        if sorted(res) != list(range(base, base + burst + MAX_BATCH)) \
                or tags.get("k_cap", 0) < 1 or tags.get("load_shed", 0) < 1:
            raise AssertionError(f"ladder: results {tags}")
        st = router.stats()
        print(f"router ladder: burst of {burst} + {MAX_BATCH} -> level 3, "
              f"tags {tags} (k_cap results are the exact top-4 prefixes, "
              f"load_shed ones shed), degrade_events="
              f"{int(st['degrade_events'])} recover_events="
              f"{int(st['recover_events'])}, level back at 0")

    # ---- scaling: K = 1, 2, 4 ------------------------------------------
    print(f"engine pqtopk_fused (same run): mRT={fz['mRT_ms']:.3f}ms "
          f"p99={fz['p99_ms']:.3f}ms {fz['req_s']:.1f} req/s")
    # A closed loop's p50 is mostly its own queue (window / throughput), so
    # every K is driven at the same windows (latency at equal load) and at
    # two batches a replica (the fleet kept busy).
    for n_rep in ROUTER_SCALING:
        for window in sorted(set(SCALING_WINDOWS)
                             | {2 * n_rep * MAX_BATCH}):
            what = f"K={n_rep} window={window}"
            with ReplicaRouter.for_seqrec(params, cfg, n_replicas=n_rep,
                                          hedge=False, **calm) as router:
                router.warmup()
                reset_counts()
                res, wall = drive(router, hist, window=window)
                settle(router)
                jobs = launched_jobs(router)
                expect_counts(f"router {what}", read_counts(),
                              pq_topk_fused=jobs)
                check_untagged(f"router {what}", res, fused_out)
                router_line(f"scaling K={n_rep}", router, res, wall,
                            window=window)

    # ---- the durable mutable fabric, K=2 ---------------------------------
    t0 = time.monotonic()
    mstate = MutableHeadState.build(params["item_emb"]["codes"], cfg.pq.b,
                                    device=dev)
    shadow = mstate.clone()
    rng = np.random.default_rng(6)
    mhist = request_stream(cfg, (DURABLE_BATCHES + 20) * MAX_BATCH, seed=7)
    with tempfile.TemporaryDirectory() as log_dir, \
            ReplicaRouter.for_seqrec_mutable(
                params, cfg, mstate, n_replicas=2, k=K, max_batch=MAX_BATCH,
                log=CatalogueLog(log_dir), hedge=False, eject_after=1,
                cooldown_ms=20.0, degrade_high=1 << 30, device=dev) as router:
        router.warmup()
        print(f"router durable: capacity={mstate.cap} ladder="
              f"{router.engines[0].ladder} built in "
              f"{time.monotonic() - t0:.1f}s")
        reset_counts()
        res, b = {}, 0
        while b < DURABLE_BATCHES or router.replicas[1].readmissions == 0:
            batch = mhist[b * MAX_BATCH:(b + 1) * MAX_BATCH]
            more, _ = drive(router, batch, base=b * MAX_BATCH)
            res.update(more)
            if b < DURABLE_BATCHES:
                router.apply_mutations(_churn_ops(shadow, rng, CHURN_OPS,
                                                  cfg.pq.b))
            if b == CRASH_AT_BATCH:
                router.crash_replica(1)
                n_catchup = router.catchup_events
            if router.replicas[1].readmissions and \
                    router.catchup_events <= n_catchup:
                raise AssertionError("durable: replica 1 re-admitted "
                                     "before it recovered from the log")
            b += 1
            if b >= DURABLE_BATCHES + 20:
                raise AssertionError("durable: replica 1 never re-admitted")
        t_wait = time.monotonic()
        while any(rep["lag"] for rep in router.stats()["replicas"].values()):
            router.pump(block=True, timeout=0.01)
            if time.monotonic() - t_wait > 30:
                raise AssertionError("durable: replicas never caught up")
        settle(router)
        jobs = launched_jobs(router)
        expect_counts("router durable K=2", read_counts(),
                      pq_topk_fused_live=jobs, pq_scores=jobs)
        writer = router._writer_state
        for rid in range(2):
            st = router._replica_states[rid]
            same = (st.free == writer.free and st.n_rows == writer.n_rows
                    and torch.equal(st.codes, writer.codes)
                    and torch.equal(st.live, writer.live)
                    and all((getattr(st.state, f) is None
                             and getattr(writer.state, f) is None)
                            or torch.equal(getattr(st.state, f),
                                           getattr(writer.state, f))
                            for f in ARRAY_FIELDS))
            if not same:
                raise AssertionError(f"durable: replica {rid}'s catalogue "
                                     "differs from the writer's")
        live = writer.live.cpu().numpy()
        for r in res.values():
            if r.shed or r.items.shape != (K,) or r.lsn < 0:
                raise AssertionError(f"durable: request {r.request_id}: {r}")
        # A final batch per replica against the masked oracle.
        seen, tries = set(), 0
        while seen != {0, 1}:
            lo = 2 * tries * MAX_BATCH
            batches = [mhist[lo:lo + MAX_BATCH],
                       mhist[lo + MAX_BATCH:lo + 2 * MAX_BATCH]]
            got, _ = drive(router, batches[0] + batches[1],
                           base=10 ** 7 + 2 * tries * MAX_BATCH)
            for q, hb in enumerate(batches):
                rows = [got[10 ** 7 + (2 * tries + q) * MAX_BATCH + j]
                        for j in range(MAX_BATCH)]
                ov, oi = masked_oracle(params, cfg, writer, hb)
                for j, r in enumerate(rows):
                    if r.degraded or not live[r.items].all() or not (
                            np.array_equal(r.items, oi[j])
                            and np.array_equal(r.scores, ov[j])):
                        raise AssertionError(f"durable: final batch on "
                                             f"replica {r.replica} differs "
                                             "from the masked oracle")
                seen |= {r.replica for r in rows}
            tries += 1
            if tries > 10:
                raise AssertionError("durable: a replica served no batch")
        settle(router)
        st = router.stats()
        print(f"router durable K=2: {len(res)} requests over {b} batches, "
              f"{CHURN_OPS} logged ops between the first {DURABLE_BATCHES}; "
              f"committed_lsn={int(st['committed_lsn'])} catchup_events="
              f"{int(st['catchup_events'])} stale_served="
              f"{int(st['stale_served'])}; replica 1 crashed after batch "
              f"{CRASH_AT_BATCH}, recovered from the log in "
              + ", ".join(f"{t:.1f}ms" for t in router.recovery_ms)
              + ", re-admitted after it, "
              + ", ".join(f"{t:.1f}ms" for _, t in router.readmit_ms)
              + " after the crash; both replicas' catalogues equal the "
              "writer's bit for "
              f"bit; final batches on replicas 0 and 1 equal the masked "
              f"oracle; {jobs} jobs = form (d) launches = pq_scores launches")
    print(f"router phase: {time.monotonic() - t_phase:.1f}s")


TRAIN_STEPS, TRAIN_FAIL_AT, TRAIN_CKPT_EVERY = 20, 12, 5
TRAIN_TOL = dict(rtol=1e-5, atol=1e-5)   # card against CPU: the contract
SERVE_TRAINED_BATCHES = 20


class _Tee:
    """Standard output kept as well as shown (the launchers' lines)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def run_launcher(argv):
    """``repro_torch.launch.train.main(argv)`` on the card, with its
    printed lines, its peak device memory (and what was held before),
    and its wall seconds."""
    import contextlib
    import gc
    import torch
    from repro_torch.launch import train as train_launcher
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    tee = _Tee(sys.stdout)
    t0 = time.monotonic()
    with contextlib.redirect_stdout(tee):
        res = train_launcher.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    return (res, tee.text(), torch.cuda.max_memory_allocated(), held,
            time.monotonic() - t0)


def launcher_line(what, res, peak, held, wall, batch):
    losses = res["losses"]
    ms = statistics.median(res["wall_s"]) * 1e3
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise AssertionError(f"train {what}: non-finite losses {losses}")
    print(f"train {what}: {len(losses)} steps of B={batch}, losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, median step {ms:.3f}ms "
          f"({batch / ms * 1e3:.1f} rows/s), peak "
          f"{peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} GiB above "
          f"the {held / 2**30:.3f} GiB held), {wall:.1f}s in all")
    return ms


def profile_step(fn, top=8,
                 label="train profile (forward+backward, B=32, one step)"):
    """One ``fn()`` under ``torch.profiler``: the device time by kernel
    (self time, summed over calls), the largest ``top`` and the total."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if not rows:
        print(f"{label}: the profiler saw no device time")
        return
    print(f"{label}: device "
          f"{total:.3f}ms in {sum(r[1] for r in rows)} kernel launches; "
          "largest: " + "; ".join(f"{k[:60]} x{c} {ms:.3f}ms"
                                  for ms, c, k in rows[:top]))


def train_phase(dev):
    """Training on the card (``repro_torch.launch.train``, the train step,
    the checkpoints):

    1. the launcher at full width (sasrec-recjpq, B=32, 20 steps, a
       checkpoint every 5, a failure injected at step 12): it must resume
       from step 10 and finish, its losses finite and the last below the
       first; the final checkpoint restored into fresh templates equals
       the final state tensor for tensor; then one step's split (host
       batch, forward and backward, AdamW update; median of 5);
    2. one step at B=4 from the trained state on the card and on the CPU
       (the port's CPU path is the oracle here), loss, grad norm, every
       parameter and moment within rtol=atol=1e-5;
    3. one step at the config's ``train_seq`` shape: 4,096 sequences as
       128 microbatches of 32;
    4. the trained weights served: 20 batches of 64 through
       ``pqtopk_fused`` and ``pqtopk_kernel``, bit-identical to the plain
       ``pqtopk``, launching 20 fused and 0 ``pq_scores``, then 0 and 20;
    5. gbert4rec-recjpq at full width (10 steps of 32) and each recsys
       kind at its ``train_batch`` (3 steps) through the launcher;
    6. the example (``examples/train_sasrec_recjpq.py --steps 100``).
    The serve check's launch counts are checked on their own; they are
    not the main path's and do not enter the ``kernels`` line."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.interop import to_device
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import seqrec
    from repro_torch.training import checkpoint, optimizer, train_loop, tree
    t_phase = time.monotonic()
    arch = get_config("sasrec-recjpq")
    cfg = arch.model
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # ---- 1. the launcher at full width, with a restart ---------------
        ck = os.path.join(tmp, "sasrec")
        res, text, peak, held, wall = run_launcher([
            "--arch", "sasrec-recjpq", "--steps", str(TRAIN_STEPS),
            "--batch", "32", "--ckpt", ck, "--ckpt-every",
            str(TRAIN_CKPT_EVERY), "--fail-at", str(TRAIN_FAIL_AT),
            "--log-every", "1"])
        resumed = TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
        if f"resumed from step {resumed}\n" not in text \
                or f"finished {TRAIN_STEPS} steps" not in text:
            raise AssertionError("train launcher: no resume from step "
                                 f"{resumed} or no finish line")
        step_ms = launcher_line("sasrec-recjpq launcher", res, peak, held,
                                wall, 32)
        if not res["losses"][-1] < res["losses"][0]:
            raise AssertionError(f"train: loss did not fall {res['losses']}")
        params, state = res["params"], res["opt_state"]
        gen = torch.Generator().manual_seed(0)
        fresh = seqrec.init_seqrec(gen, cfg, device=dev)
        mgr = checkpoint.CheckpointManager(ck)
        out = mgr.restore(TRAIN_STEPS, {
            "params": fresh, "opt_state": train_loop.init_opt_state(
                fresh, optimizer.AdamWConfig())})
        n_leaves = 0
        for a, b in zip(tree.leaves_with_path(out), tree.leaves_with_path(
                {"params": params, "opt_state": state})):
            if a[0] != b[0] or a[1].dtype != b[1].dtype \
                    or not torch.equal(a[1], b[1]):
                raise AssertionError(f"restored checkpoint differs at {a[0]}")
            n_leaves += 1
        print(f"train checkpoint: step {mgr.latest_step()} restored into "
              f"fresh templates equals the final state ({n_leaves} tensors, "
              "bit for bit)")
        del fresh, out

        # The split of one step (synchronized between the parts).
        ocfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=100)
        data, loss_fn, _ = train_launcher.make_data(arch, 32, device=dev)
        parts = {"host batch": [], "forward+backward": [], "AdamW update": []}
        p, s = params, state
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(data).items()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, _, grads = train_loop.value_and_grad(loss_fn, p, batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            p, s, _ = optimizer.adamw_update(grads, s, p, ocfg,
                                             frozen=optimizer.default_frozen)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            del grads, batch
            if i:
                for k, t in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                    parts[k].append(t * 1e3)
        split = {k: statistics.median(v) for k, v in parts.items()}
        total = sum(split.values())
        profile_step(lambda: train_loop.value_and_grad(loss_fn, p, {
            k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}))
        print("train step split (B=32, S=199, 256 negatives; median of 5, "
              "synchronized): " + ", ".join(f"{k} {v:.3f}ms"
                                            for k, v in split.items())
              + f"; sum {total:.3f}ms ({32 / total * 1e3:.1f} seq/s); the "
              f"launcher's median step {step_ms:.3f}ms")
        del p, s

        # ---- 2. the card against the CPU, one step at B=4 ----------------
        data4, _, _ = train_launcher.make_data(arch, 4, device=dev)
        b4 = next(data4)
        step = train_loop.make_train_step(loss_fn, ocfg)
        gp, gs, gm = step(params, state, {k: torch.from_numpy(v).to(dev)
                                          for k, v in b4.items()})
        t0 = time.monotonic()
        cp, cs, cm = step(to_device(params, "cpu"), to_device(state, "cpu"),
                          {k: torch.from_numpy(v) for k, v in b4.items()})
        cpu_s = time.monotonic() - t0
        errs = {k: abs(float(gm[k]) - float(cm[k])) for k in
                ("loss", "grad_norm", "lr")}
        worst = 0.0
        for (path, g), (_, c) in zip(
                tree.leaves_with_path({"params": gp, "opt_state": gs}),
                tree.leaves_with_path({"params": cp, "opt_state": cs})):
            if g.is_floating_point():
                torch.testing.assert_close(g.cpu(), c, **TRAIN_TOL,
                                           msg=lambda m: f"{path}: {m}")
                worst = max(worst, (g.cpu() - c).abs().max().item())
            elif not torch.equal(g.cpu(), c):
                raise AssertionError(f"card and CPU differ at {path}")
        for k in ("loss", "grad_norm", "lr"):
            torch.testing.assert_close(gm[k].cpu(), cm[k], **TRAIN_TOL)
        print(f"train card vs CPU (B=4, full width, one step from the "
              f"trained state; the CPU step took {cpu_s:.1f}s): "
              + ", ".join(f"{k} abs err {v:.3e}" for k, v in errs.items())
              + f", largest parameter/moment abs err {worst:.3e}; within "
              "rtol=atol=1e-5")
        del gp, gs, cp, cs, data4

        # ---- 3. the config's train_seq shape, accumulated ----------------
        dims = arch.shape("train_seq").dims
        gb, ga = dims["global_batch"], dims["global_batch"] // 32
        t0 = time.monotonic()
        big, _, _ = train_launcher.make_data(arch, gb, device=dev)
        t1 = time.monotonic()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(big).items()}
        torch.cuda.synchronize()
        t2 = time.monotonic()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        acc = train_loop.make_train_step(loss_fn, ocfg, grad_accum=ga)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        _, _, m = acc(params, state, batch)
        loss = float(m["loss"])
        seq_s = time.perf_counter() - t3
        if loss != loss:
            raise AssertionError("train_seq: NaN loss")
        peak = torch.cuda.max_memory_allocated()
        print(f"train train_seq: {gb} sequences x {dims['seq_len'] - 1} "
              f"positions x {cfg.n_negatives} negatives as grad_accum={ga} "
              f"microbatches of {gb // ga}: step {seq_s * 1e3:.1f}ms "
              f"({gb / seq_s:.1f} seq/s), loss {loss:.4f}, peak "
              f"{peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} above "
              f"the {held / 2**30:.3f} held); data {t1 - t0:.1f}s to build, "
              f"{t2 - t1:.1f}s a batch on the host and its copy")
        del batch, big, m

        # ---- 4. the trained weights, served --------------------------------
        rng = np.random.default_rng(11)
        seqs = [torch.from_numpy(rng.integers(
            1, cfg.n_items + 1, (MAX_BATCH, cfg.max_seq_len)).astype(
            np.int32)).to(dev) for _ in range(SERVE_TRAINED_BATCHES)]
        with torch.inference_mode():
            want = [seqrec.serve_topk(params, x, cfg, k=K, method="pqtopk")
                    for x in seqs]
            for method, kern in (("pqtopk_fused", "pq_topk_fused"),
                                 ("pqtopk_kernel", "pq_scores")):
                seqrec.serve_topk(params, seqs[0], cfg, k=K, method=method)
                torch.cuda.synchronize()
                reset_counts()
                got = [seqrec.serve_topk(params, x, cfg, k=K, method=method)
                       for x in seqs]
                torch.cuda.synchronize()
                counts = read_counts()
                expect_counts(f"serve trained {method}", counts,
                              **{kern: SERVE_TRAINED_BATCHES})
                for (gi, gv), (wi, wv) in zip(got, want):
                    if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
                        raise AssertionError(f"trained weights: {method} "
                                             "differs from pqtopk")
        print(f"train serve: the trained weights, {SERVE_TRAINED_BATCHES} "
              f"batches of {MAX_BATCH}, pqtopk_fused and pqtopk_kernel "
              "bit-identical to pqtopk (ids and scores)")
        del params, state, res, seqs, want, got
        reset_counts()

        # ---- 5. the other archs through the launcher -----------------------
        res, _, peak, held, wall = run_launcher([
            "--arch", "gbert4rec-recjpq", "--steps", "10", "--batch", "32",
            "--log-every", "1"])
        launcher_line("gbert4rec-recjpq", res, peak, held, wall, 32)
        del res
        for name in RECSYS_ARCHS:
            spec = get_config(name)
            n = spec.shape("train_batch").dims["global_batch"]
            res, _, peak, held, wall = run_launcher([
                "--arch", name, "--steps", "3", "--batch", str(n),
                "--log-every", "1"])
            launcher_line(f"{name} train_batch", res, peak, held, wall, n)
            del res

        # ---- 6. the example --------------------------------------------------
        from repro_torch.examples import train_sasrec_recjpq as example
        gc.collect()
        torch.cuda.empty_cache()
        ex = example.main(["--steps", "100", "--ckpt",
                           os.path.join(tmp, "example"), "--device", "cuda"])
        if not (ex["losses"][-1] < ex["losses"][0]
                and 0.0 <= ex["ndcg"] <= 1.0):
            raise AssertionError("example: loss did not fall or bad NDCG")
        print(f"train example: codebook {ex['codebook_s']:.1f}s, "
              f"{ex['seq_per_s']:.1f} seq/s, NDCG@10 model "
              f"{ex['ndcg']:.4f} popularity {ex['pop_ndcg']:.4f}")
        del ex
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train phase: {time.monotonic() - t_phase:.1f}s")


# ---- the LM family: decode with the PQ vocabulary head ----------------

LM_HEADS = ("pqtopk_fused", "pqtopk_kernel", "pqtopk", "pqtopk_pruned",
            "dense")
# Kernel launches of one head call (the pruned cascade: the greedy seed's
# scores kernel, then the fused kernel over its compacted tile list).
LM_HEAD_LAUNCHES = {"pqtopk_fused": {"pq_topk_fused": 1},
                    "pqtopk_kernel": {"pq_scores": 1}, "pqtopk": {},
                    "pqtopk_pruned": {"pq_topk_fused": 1, "pq_scores": 1},
                    "dense": {}}
LM_STEPS = 3                        # checked decode steps at B=128
LM_KS = (64, 8)                     # 64 = the fused kernel's candidate cap
LM_ENGINE_REQUESTS, LM_ENGINE_NEW = 256, 16
RING_LEN, RING_STEPS = 2048, 1100   # past the 1,024-slot rings
CPU_LEN, CPU_STEPS = 64, 4
# Tolerances on phi as a relative Frobenius error ||a - b|| / ||b||,
# measured on the card (PERF.md, section 6), for the ring against the
# windowed prefill and for the card against the CPU.  The full configs'
# bfloat16 rounds too coarsely to see a ring fault (a few dozen of 1,024
# slots wrong moves phi less than bfloat16 does), so both checks also run
# with the same weights cast to float32, where they are held tight and
# planted ring faults must exceed the limit.
LM_REL_TOL = {"bfloat16": 2e-2, "float32": 3e-5}
RING_FAULT_DUP = (32, 1)            # slots overwritten by their neighbours


def _nbytes(tree):
    import torch
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size() \
        if isinstance(tree, torch.Tensor) else 0


def lm_model(arch, n_layers, dev):
    """The full-width config cut to ``n_layers``, random weights drawn on
    the card from seed 0.  -> (arch config, model config, params)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    full = get_config(arch)
    cfg = replace(full.model, n_layers=n_layers)
    t0 = time.monotonic()
    params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    print(f"lm init {arch}: {n_layers} of {full.model.n_layers} layers, d="
          f"{cfg.d_model}, d_ff {cfg.d_ff}, heads {cfg.attention.n_heads}/"
          f"{cfg.attention.n_kv_heads}x{cfg.attention.head_dim}, vocab "
          f"{cfg.vocab}, {cfg.param_dtype}, PQ head m={cfg.pq_head.m} b="
          f"{cfg.pq_head.b} {params['pq_head']['codes'].dtype}; weights "
          f"{_nbytes(params) / 1e9:.2f} GB drawn on the card in "
          f"{time.monotonic() - t0:.3f}s")
    return full, cfg, params


def rel_err(got, want):
    """(||got - want|| / ||want||, max |got - want|) in float32."""
    d = (got.float() - want.float())
    return (float(d.norm() / want.float().norm()), float(d.abs().max()))


def lm_steps(what, params, cfg, caches, tokens):
    """``LM_STEPS`` decode steps at positions 0, 1, ...: the backbone's
    host ms (synchronized), then every head on the step's phi, each timed
    (host clock, median of 3) and its launches counted; the kernel heads
    bit-identical to plain ``pqtopk`` at each k of ``LM_KS``.  -> (phi of
    the last step, {name: median ms}, {kernel: launches read from the
    counts over every checked head call})."""
    import collections
    import torch
    from repro_torch.models import transformer as T
    ms = {name: [] for name in ("backbone",) + LM_HEADS}
    launched = collections.Counter()
    for pos in range(LM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        phi = T._decode_backbone(params, tokens[pos], pos, caches, cfg)
        torch.cuda.synchronize()
        ms["backbone"].append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(phi).all()):
            raise AssertionError(f"{what}: non-finite phi at step {pos}")
        for k in LM_KS:
            want = T._decode_head(params, phi, cfg, k, "pqtopk")
            for method in LM_HEADS:
                reset_counts()
                got = T._decode_head(params, phi, cfg, k, method)
                torch.cuda.synchronize()
                counts = read_counts()
                launched.update(counts)
                expect = {n: LM_HEAD_LAUNCHES[method].get(n, 0)
                          for n in counts}
                if counts != expect:
                    raise AssertionError(f"{what} {method} k={k} launched "
                                         f"{counts}, expected {expect}")
                if method in ("pqtopk_fused", "pqtopk_kernel",
                              "pqtopk_pruned"):
                    compare(f"{what} {method} k={k} step {pos}",
                            (got[1], got[0]), (want[1], want[0]))
                elif got[0].shape != (phi.shape[0], k) or not bool(
                        torch.isfinite(got[1]).all()):
                    raise AssertionError(f"{what} {method}: bad top-{k}")
        for method in LM_HEADS:
            ms[method].append(host_ms(lambda: T._decode_head(
                params, phi, cfg, LM_KS[0], method), reps=3))
        print(f"lm {what} step {pos}: backbone {ms['backbone'][-1]:.3f}ms; "
              + ", ".join(f"{m} {ms[m][-1]:.3f}" for m in LM_HEADS)
              + f" ms (k={LM_KS[0]}, host clock)")
    med = {name: statistics.median(v) for name, v in ms.items()}
    print(f"lm {what}: median over {LM_STEPS} steps: backbone "
          f"{med['backbone']:.3f}ms, heads "
          + ", ".join(f"{m} {med[m]:.3f}" for m in LM_HEADS)
          + "ms; pqtopk_fused, pqtopk_kernel, pqtopk_pruned bit-identical "
          f"to pqtopk at k={LM_KS}; launches per head call "
          f"{LM_HEAD_LAUNCHES}, counted over the checked calls "
          f"{dict(launched)}")
    return phi, med, dict(launched)


def lm_float32(params, cfg):
    """The backbone's weights cast to float32 and the config to match (the
    PQ head, which the backbone never reads, left out)."""
    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return t.float() if t.is_floating_point() else t
    return ({k: cast(v) for k, v in params.items() if k != "pq_head"},
            replace(cfg, dtype="float32", param_dtype="float32"))


def _clone_caches(caches):
    return [{n: t.clone() for n, t in c.items()} for c in caches]


def lm_ring(params, cfg, toks):
    """``RING_STEPS`` decode steps at B=2 into gemma3's rings and a global
    cache of ``RING_LEN`` slots, the last phi held to
    ``LM_REL_TOL[cfg.dtype]`` against ``lm_prefill`` over the same tokens.
    The last step is also run from two planted ring faults and their
    readings printed: "no wrap" (the slots written past the wrap hold
    positions 0, 1, ... again, as a ring that stopped at its end would)
    and "dup n" (n of ``RING_FAULT_DUP`` slots of every ring overwritten
    by their neighbours).  In float32 each fault must exceed the
    limit."""
    import torch
    from repro_torch.models import transformer as T
    tol = LM_REL_TOL[cfg.dtype]
    flags = T.layer_types(cfg)
    caches = T.init_caches(cfg, 2, RING_LEN, device=toks.device)
    ring = min(cfg.attention.window, RING_LEN)
    n_wrapped = RING_STEPS - 1 - ring     # ring slots rewritten before the
    rings = [i for i, g in enumerate(flags) if not g]   # last step
    t0 = time.monotonic()
    with torch.no_grad():
        for pos in range(RING_STEPS - 1):
            T._decode_backbone(params, toks[:, pos], pos, caches, cfg)
            if pos == n_wrapped - 1:
                early = {i: {n: t[:, :n_wrapped].clone()
                             for n, t in caches[i].items()} for i in rings}
        before = _clone_caches(caches)
        last = RING_STEPS - 1
        phi = T._decode_backbone(params, toks[:, last], last, caches, cfg)
        torch.cuda.synchronize()
        t_dec = time.monotonic() - t0
        want = T.lm_prefill(params, toks, cfg).float()
        faults = {}
        for fault in (0,) + RING_FAULT_DUP:
            bad = _clone_caches(before)
            for i in rings:
                for n, t in bad[i].items():
                    if fault:
                        t[:, :fault] = t[:, fault:2 * fault]
                    else:
                        t[:, :n_wrapped] = early[i][n]
            name = f"dup {fault}" if fault else f"no wrap ({n_wrapped} slots)"
            faults[name] = rel_err(T._decode_backbone(
                params, toks[:, last], last, bad, cfg), want)[0]
    rel, mx = rel_err(phi, want)
    print(f"lm ring gemma3-27b {cfg.dtype}: B=2, {RING_STEPS} decode steps "
          f"into rings of {ring} and a global cache of {RING_LEN} "
          f"({t_dec / RING_STEPS * 1e3:.3f} ms a step), last phi against "
          f"lm_prefill over the same tokens: rel {rel:.3e} max abs "
          f"{mx:.3e} (tolerance rel {tol}); planted faults at the last "
          f"step, rel: " + ", ".join(f"{f} {r:.3e}"
                                     for f, r in faults.items()))
    if not rel <= tol:
        raise AssertionError(f"lm ring {cfg.dtype}: rel error {rel} > {tol}")
    if cfg.dtype == "float32" and not min(faults.values()) > tol:
        raise AssertionError(f"lm ring float32: a planted fault {faults} "
                             f"within the tolerance {tol}")


def lm_vs_cpu(params, cpu_params, cfg, toks, dev):
    """``CPU_STEPS`` decode steps at B=2, max_len ``CPU_LEN``, on the card
    and on the CPU from the same weights: the last phi within
    ``LM_REL_TOL[cfg.dtype]``.  -> the card's last phi."""
    import torch
    from repro_torch.models import transformer as T
    tol = LM_REL_TOL[cfg.dtype]
    caches_g, caches_c = (T.init_caches(cfg, 2, CPU_LEN, device=d)
                          for d in (dev, "cpu"))
    t0 = time.monotonic()
    with torch.no_grad():
        for pos in range(CPU_STEPS):
            pg = T._decode_backbone(params, torch.from_numpy(toks[pos])
                                    .to(dev), pos, caches_g, cfg)
            pc = T._decode_backbone(cpu_params, torch.from_numpy(toks[pos]),
                                    pos, caches_c, cfg)
    rel, mx = rel_err(pg.cpu(), pc)
    print(f"lm card vs CPU {cfg.name} {cfg.dtype}: B=2, {CPU_STEPS} steps, "
          f"phi rel {rel:.3e} max abs {mx:.3e} (tolerance rel {tol}; "
          f"{time.monotonic() - t0:.1f}s)")
    if not rel <= tol:
        raise AssertionError(f"lm card vs CPU {cfg.dtype}: rel error {rel}")
    return pg


def lm_engine(params, cfg, dev, n_slots, max_len):
    """``DecodeEngine`` with the fused head: ``LM_ENGINE_REQUESTS`` one-token
    prompts, ``LM_ENGINE_NEW`` tokens each.  Prints tokens/s, step ms
    (median, p99; host clock, each step ends on its host read) and peak
    device memory above what was held; form (a) launched once a step."""
    import gc
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import DecodeEngine, Request

    def decode_fn(tokens, pos, caches):
        ids, _, caches = T.lm_decode_step(params, tokens, pos.max(), caches,
                                          cfg, head_method="pqtopk_fused")
        return ids[:, 0], caches

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    eng = DecodeEngine(decode_fn, lambda b: T.init_caches(
        cfg, b, max_len, device=dev), n_slots=n_slots, max_len=max_len,
        device=dev)
    rng = np.random.default_rng(3)
    for i in range(LM_ENGINE_REQUESTS):
        eng.submit(Request(i, rng.integers(0, cfg.vocab, 1), k=1))
    reset_counts()
    steps = []
    t0 = time.monotonic()
    while eng.waiting or any(eng.slot_req):
        t = time.perf_counter()
        eng.step(LM_ENGINE_NEW)
        steps.append((time.perf_counter() - t) * 1e3)
    wall = time.monotonic() - t0
    counts = read_counts()
    expect_counts("lm engine (pqtopk_fused)", counts,
                  pq_topk_fused=len(steps))
    n_tok = sum(len(t) for _, t in eng.finished)
    if len(eng.finished) != LM_ENGINE_REQUESTS or n_tok != \
            LM_ENGINE_REQUESTS * LM_ENGINE_NEW or not all(
                0 <= x < cfg.vocab for _, t in eng.finished for x in t):
        raise AssertionError("lm engine: wrong finished requests")
    peak = torch.cuda.max_memory_allocated()
    print(f"lm engine {cfg.name}: {n_slots} slots, max_len {max_len}, "
          f"{LM_ENGINE_REQUESTS} requests x {LM_ENGINE_NEW} tokens in "
          f"{len(steps)} steps, {n_tok / wall:.1f} tokens/s, step ms median "
          f"{statistics.median(steps):.3f} p99 "
          f"{float(np.percentile(steps, 99)):.3f}, peak "
          f"{peak / 2**30:.3f} GiB ({(peak - held) / 2**30:.3f} GiB above "
          f"the {held / 2**30:.3f} GiB held), {wall:.1f}s")
    del eng
    return {"tokens_per_s": n_tok / wall, "launches": counts}


def vocab_kernels(label, head, phi, n_sms):
    """Both pqtopk kernels at an LM's vocabulary head: S from ``phi`` on
    the head's int32 codes, ``pq_scores`` and form (a) at k =
    ``LM_KS[0]``, each bit-exact against its plain version, timed (device
    time), its plain version and library call timed, and bounded.  ->
    {kernel: record fields but ``launches``}."""
    import torch
    from repro_torch.core import scoring
    from repro_torch.kernels.pqtopk import kernel, ops, ref
    codes = head["codes"]
    s = scoring.subid_scores(head["sub_emb"], phi).contiguous()
    n, m = codes.shape
    bq, _, b = s.shape
    k = LM_KS[0]
    tile = kernel.DEFAULT_TILE
    dev = codes.device
    idx = torch.arange(ops.n_tiles(n, tile), dtype=torch.int32, device=dev)
    rec = {}
    err = compare(f"{label} pq_scores", (kernel.pq_scores_cuda(codes, s),),
                  (ref.pq_scores(codes, s),))
    flat = codes.long() + torch.arange(m, device=dev) * b
    table = s.permute(1, 2, 0).reshape(m * b, bq).contiguous()
    bnd, by, terms = bound_ms(n * m * 4 + bq * m * b * 4 + bq * n * 4,
                              bq * n * (m - 1), bq * n * m, n_sms)
    rec["pq_scores"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: kernel.pq_scores_cuda(codes, s), 20,
                      graph=True),
        "plain_ms": time_ms(lambda: ref.pq_scores(codes, s), 3),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": time_ms(lambda: torch.nn.functional.embedding_bag(
            flat, table, mode="sum"), 20, graph=True)}
    print(f"bound {label} pq_scores: {terms} ms on {n_sms} SMs")
    err = compare(f"{label} pq_topk_fused",
                  kernel.pq_topk_fused_cuda(codes, s, k, idx, n_items=n,
                                            tile=tile),
                  ref.pq_topk_slots(codes, s, k, idx, n_items=n, tile=tile))
    bnd, by, terms = bound_ms(
        n * m * 4 + bq * m * b * 4 + idx.numel() * 4
        + bq * idx.numel() * k * 8, bq * n * (m - 1), bq * n * m, n_sms)
    rec["pq_topk_fused"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: kernel.pq_topk_fused_cuda(
            codes, s, k, idx, n_items=n, tile=tile), 20, graph=True),
        "plain_ms": time_ms(lambda: ref.pq_topk_slots(
            codes, s, k, idx, n_items=n, tile=tile), 3),
        "bound_ms": bnd, "bound_by": by, "library_ms": None}
    print(f"bound {label} pq_topk_fused: {terms} ms on {n_sms} SMs")
    for name, r in rec.items():
        print(f"kernel {name} ({label}: B={bq}, N={n}, m={m}, b={b}, "
              f"{codes.dtype}, k={k}): {r['ms']:.4f}ms plain "
              f"{r['plain_ms']:.4f}ms bound {r['bound_ms']:.4f}ms "
              f"({r['bound_by']}) library {r['library_ms']}")
    return rec


def lm_phase(dev, n_sms):
    """The LM family on the card (ROADMAP A 7a): gemma3-27b at full width
    cut to 6 layers (one 5:1 period) at ``decode_32k`` (B=128, 32,768
    slots): decode steps with every head, the int32 vocabulary kernels'
    times, the decode engine, the ring past its wrap against the windowed
    prefill, the card against the CPU; then qwen2.5-14b cut to 2 layers
    (stacked caches) at B=128, max_len 4,096.  -> kernel records' fields
    for the LM head shape."""
    import gc
    import numpy as np
    import torch
    from repro_torch.core import scoring
    from repro_torch.interop import to_device
    from repro_torch.models import transformer as T
    t_phase = time.monotonic()
    print(f"lm phase: {torch.cuda.memory_allocated() / 2**30:.3f} GiB held "
          "at its start")
    full, cfg, params = lm_model("gemma3-27b", 6, dev)
    dims = full.shape("decode_32k").dims
    bq, max_len = dims["global_batch"], dims["seq_len"]
    rng = np.random.default_rng(5)

    # ---- 1. decode steps at decode_32k, every head ----------------------
    caches = T.init_caches(cfg, bq, max_len, device=dev)
    print(f"lm caches gemma3-27b B={bq} max_len {max_len}: "
          + ", ".join(f"{c['k'].shape[1]}" for c in caches) + " slots, "
          f"{_nbytes(caches) / 1e9:.2f} GB")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (LM_STEPS, bq))
                              .astype(np.int32)).to(dev)
    phi, _, steps_g = lm_steps("gemma3-27b", params, cfg, caches, tokens)
    profile_step(lambda: T._decode_backbone(params, tokens[0], 0, caches,
                                            cfg),
                 label=f"lm profile (gemma3-27b backbone, B={bq}, one step)")

    # ---- 2. the vocabulary kernels at the decode shape ------------------
    head = params["pq_head"]
    codes = head["codes"]
    rec = vocab_kernels("lm head", head, phi, n_sms)
    del caches, phi
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 3. DecodeEngine, the fused head ---------------------------------
    eng = lm_engine(params, cfg, dev, bq, max_len)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4. the ring past its wrap, against the windowed prefill ---------
    # ---- 5. the card against the CPU -------------------------------------
    # Both in the config's bfloat16, then with the weights cast to float32.
    ring_toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, RING_STEPS))
                                 .astype(np.int32)).to(dev)
    cpu_toks = rng.integers(0, cfg.vocab, (CPU_STEPS, 2)).astype(np.int32)
    lm_ring(params, cfg, ring_toks)
    cpu_params = to_device(params, "cpu")
    t0 = time.monotonic()
    pg = lm_vs_cpu(params, cpu_params, cfg, cpu_toks, dev)
    with torch.no_grad():
        fused = T._decode_head(params, pg, cfg, 64, "pqtopk_fused")
        plain = T._decode_head(cpu_params, pg.cpu(), cfg, 64, "pqtopk")
        s_g = scoring.subid_scores(head["sub_emb"], pg).contiguous()
        from repro_torch.core import topk as topk_lib
        same_s = topk_lib.topk(scoring.score_pqtopk(
            cpu_params["pq_head"]["codes"], s_g.cpu()), 64)
    phi_bits = same_bits((fused[1].cpu(), fused[0].cpu()),
                         (plain[1], plain[0]))
    if not torch.equal(fused[0].cpu(), plain[0]):
        raise AssertionError("lm card vs CPU: top-64 ids differ")
    compare("lm card fused vs CPU plain on the card's S",
            (fused[1].cpu(), fused[0].cpu()), same_s)
    print(f"lm card vs CPU gemma3-27b: the card's fused top-64 against the "
          f"CPU's plain pqtopk on the card's phi: ids equal, values "
          f"bit-identical {phi_bits}; on the card's S bit-identical "
          f"({time.monotonic() - t0:.1f}s)")
    del cpu_params, pg, fused, plain, s_g
    p32, cfg32 = lm_float32(params, cfg)
    lm_ring(p32, cfg32, ring_toks)
    lm_vs_cpu(p32, to_device(p32, "cpu"), cfg32, cpu_toks, dev)
    del p32, params, head, codes, ring_toks
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6. qwen2.5-14b: the stacked-cache path --------------------------
    _, qcfg, qparams = lm_model("qwen2.5-14b", 2, dev)
    qcaches = T.init_caches(qcfg, bq, 4096, device=dev)
    print(f"lm caches qwen2.5-14b B={bq} max_len 4096: stacked "
          f"{tuple(qcaches['k'].shape)}, {_nbytes(qcaches) / 1e9:.2f} GB")
    qtok = torch.from_numpy(rng.integers(0, qcfg.vocab, (LM_STEPS, bq))
                            .astype(np.int32)).to(dev)
    steps_q = lm_steps("qwen2.5-14b", qparams, qcfg, qcaches, qtok)[2]
    del qparams, qcaches
    gc.collect()
    torch.cuda.empty_cache()
    print(f"lm phase: {time.monotonic() - t_phase:.1f}s")
    # Launches on each kernel's LM path, as the counts read them: the
    # engine's fused head, and every checked head call of both models.
    for name, r in rec.items():
        parts = {"engine": eng["launches"].get(name, 0),
                 "gemma3 steps": steps_g.get(name, 0),
                 "qwen2.5 steps": steps_q.get(name, 0)}
        r["launches"] = sum(parts.values())
        print(f"lm launches {name}: {r['launches']} ({parts})")
    return rec


# ---- mixture-of-experts LMs: decode through the PQ vocabulary head ----

MOE_SORT_LEN = 4096                 # slots of the sort-against-dense steps
# The sort impl against the dense one, rel (each MoE layer's output, and
# phi after LM_STEPS steps), measured on the card (PERF.md, section 6):
# in bfloat16 the sort impl adds each token's expert outputs in bfloat16,
# the dense one in float32 (FFN 4.7e-3, phi 2.2e-2 after 3 steps of 4
# layers); with the weights cast to float32 only the sum order differs,
# so the limit there is the LM phase's float32 one (LM_REL_TOL).
MOE_SORT_TOL = {"bfloat16": 5e-2, "float32": 3e-5}
MOE_TRAIN_B, MOE_TRAIN_S = 8, 64    # one AdamW step; S = the launcher's


def moe_layer_inputs(params, cfg, token, pos, caches):
    """One decode step (the caches written in place) with each MoE layer's
    input recorded -> (phi, [(layer's moe params, its input)])."""
    from repro_torch.models import moe as M, transformer as T
    seen = []
    real = M.moe_ffn

    def spy(p, mcfg, x, act, impl="dense"):
        seen.append((p, x))
        return real(p, mcfg, x, act, impl)

    M.moe_ffn = spy
    try:
        phi = T._decode_backbone(params, token, pos, caches, cfg)
    finally:
        M.moe_ffn = real
    return phi, seen


def moe_routing_check(what, cfg, seen):
    """On each recorded MoE input: the dense dispatch and the sort
    dispatch keep the same (token, expert) pairs, and the two impls'
    outputs agree within ``MOE_SORT_TOL[cfg.dtype]``.  -> (pairs kept,
    pairs chosen, worst rel error)."""
    import torch
    from repro_torch.models import moe as M
    mc = cfg.moe
    kept = chosen = 0
    worst = 0.0
    for p, x in seen:
        b, s, d = x.shape
        g, tg = M._groups(b * s)
        c = M._capacity(tg, mc)
        _, gates, sel = M._route(p, mc, x.reshape(g, tg, d))
        dispatch, _ = M._dense_dispatch(sel, gates, mc.n_experts, c)
        slot, st, _, keep, _ = M._sort_dispatch(sel, gates, mc.n_experts, c)
        by_sort = torch.zeros((g, tg, mc.n_experts), dtype=torch.bool,
                              device=x.device)
        rows = torch.arange(g, device=x.device)[:, None].expand_as(st)
        by_sort[rows[keep], st[keep], torch.div(
            slot[keep], c, rounding_mode="floor")] = True
        if not torch.equal(dispatch.sum(-1) > 0, by_sort):
            raise AssertionError(f"{what}: the dense and sort dispatches "
                                 "keep different pairs")
        kept += int(keep.sum())
        chosen += keep.numel()
        dense = M.moe_ffn(p, mc, x, cfg.act, impl="dense")[0]
        worst = max(worst, rel_err(M.moe_ffn(p, mc, x, cfg.act,
                                             impl="sort")[0], dense)[0])
    if not worst <= MOE_SORT_TOL[cfg.dtype]:
        raise AssertionError(f"{what}: sort against dense rel {worst}")
    return kept, chosen, worst


def moe_sort_steps(params, cfg, tokens, dev):
    """``LM_STEPS`` decode steps with each impl from fresh caches of
    ``MOE_SORT_LEN`` slots: routing checked on every MoE input of the
    dense steps, each step's phi of the sort impl within
    ``MOE_SORT_TOL[cfg.dtype]`` of the dense impl's, and each impl's
    backbone ms (host clock, synchronized, median)."""
    import torch
    from repro_torch.models import transformer as T
    bq = tokens.shape[1]
    scfg = replace(cfg, moe_impl="sort")
    caches = {impl: T.init_caches(cfg, bq, MOE_SORT_LEN, device=dev)
              for impl in ("dense", "sort")}
    ms = {"dense": [], "sort": []}
    kept = chosen = 0
    worst_ffn = worst_phi = 0.0
    with torch.no_grad():
        for pos in range(LM_STEPS):
            phi_d, seen = moe_layer_inputs(params, cfg, tokens[pos], pos,
                                           caches["dense"])
            k_, c_, w_ = moe_routing_check(f"moe {cfg.name} step {pos}",
                                           cfg, seen)
            kept, chosen, worst_ffn = kept + k_, chosen + c_, max(
                worst_ffn, w_)
            del seen
            phi_s = T._decode_backbone(params, tokens[pos], pos,
                                       caches["sort"], scfg)
            worst_phi = max(worst_phi, rel_err(phi_s, phi_d)[0])
        for impl, c in caches.items():
            icfg = scfg if impl == "sort" else cfg
            for _ in range(LM_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                T._decode_backbone(params, tokens[0], 0, c, icfg)
                torch.cuda.synchronize()
                ms[impl].append((time.perf_counter() - t0) * 1e3)
    tol = MOE_SORT_TOL[cfg.dtype]
    print(f"moe sort {cfg.name} {cfg.dtype}: B={bq}, {MOE_SORT_LEN} slots, "
          f"{LM_STEPS} steps: dense and sort dispatches keep the same pairs ({kept} of "
          f"{chosen} chosen; capacity {cfg.moe.capacity_factor}), FFN rel "
          f"{worst_ffn:.3e}, phi rel {worst_phi:.3e} (tolerance rel "
          f"{tol}); backbone ms dense "
          f"{statistics.median(ms['dense']):.3f} sort "
          f"{statistics.median(ms['sort']):.3f}")
    if not worst_phi <= tol:
        raise AssertionError(f"moe sort {cfg.name}: phi rel {worst_phi}")


def moe_train_step(dev):
    """One AdamW step of qwen3-moe-30b-a3b at full width cut to 2 layers,
    B=``MOE_TRAIN_B``, S=``MOE_TRAIN_S``: step ms (host clock,
    synchronized; a first step, then the timed one), loss, aux (finite,
    above 0.5 a layer) and peak memory above what was held."""
    import gc
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt_lib, train_loop
    _, cfg, params = lm_model("qwen3-moe-30b-a3b", 2, dev)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2,
                               moment_dtype=cfg.moment_dtype)
    step = train_loop.make_train_step(lambda p, b: T.lm_loss(p, b, cfg),
                                      ocfg)
    opt = train_loop.init_opt_state(params, ocfg)
    tok = np.random.default_rng(9).integers(
        0, cfg.vocab, (2, MOE_TRAIN_B, MOE_TRAIN_S + 1))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ms = []
    for i in range(2):
        batch = {"tokens": torch.from_numpy(tok[i, :, :-1].astype(np.int32))
                 .to(dev),
                 "targets": torch.from_numpy(tok[i, :, 1:].astype(np.int32))
                 .to(dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    loss, aux = float(metrics["loss"]), float(metrics["aux"])
    print(f"moe train {cfg.name}: {cfg.n_layers} layers, B={MOE_TRAIN_B} "
          f"S={MOE_TRAIN_S}, AdamW: step ms {ms[0]:.3f} (first) "
          f"{ms[1]:.3f}; loss {loss:.4f} nll {float(metrics['nll']):.4f} "
          f"aux {aux:.4f}; peak {peak / 2**30:.3f} GiB "
          f"({(peak - held) / 2**30:.3f} GiB above the "
          f"{held / 2**30:.3f} GiB held)")
    if not (np.isfinite(loss) and aux > 0.5 * cfg.n_layers):
        raise AssertionError(f"moe train: loss {loss}, aux {aux}")
    del params, opt, step


def moe_phase(dev, n_sms):
    """The mixture-of-experts LMs on the card (ROADMAP A 7b):
    qwen3-moe-30b-a3b at full width cut to 4 layers at ``decode_32k``
    (B=128, 32,768 slots; dense dispatch): decode steps with every head,
    the sort dispatch against the dense one, ``DecodeEngine``, the card
    against the CPU (bf16 and cast to f32), both vocabulary kernels at
    its head shape, one AdamW step at 2 layers; then dbrx-132b cut to 2
    layers at B=128, 4,096 slots.  -> {kernel: launches counted on the MoE
    heads}."""
    import collections
    import gc
    import numpy as np
    import torch
    from repro_torch.interop import to_device
    from repro_torch.models import transformer as T
    t_phase = time.monotonic()
    print(f"moe phase: {torch.cuda.memory_allocated() / 2**30:.3f} GiB held "
          "at its start")
    launched = collections.Counter()
    full, cfg, params = lm_model("qwen3-moe-30b-a3b", 4, dev)
    mc = cfg.moe
    dims = full.shape("decode_32k").dims
    bq, max_len = dims["global_batch"], dims["seq_len"]
    expert_gb = _nbytes(T._layer(params, cfg, 0)["moe"]) / 1e9
    print(f"moe {cfg.name}: {mc.n_experts} experts top-{mc.top_k}, "
          f"d_ff_expert {mc.d_ff_expert}, capacity factor "
          f"{mc.capacity_factor} ({expert_gb:.2f} GB of experts a layer)")
    rng = np.random.default_rng(6)

    # ---- 1. decode steps at decode_32k, every head ----------------------
    caches = T.init_caches(cfg, bq, max_len, device=dev)
    print(f"moe caches {cfg.name} B={bq} max_len {max_len}: stacked "
          f"{tuple(caches['k'].shape)}, {_nbytes(caches) / 1e9:.2f} GB")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (LM_STEPS, bq))
                              .astype(np.int32)).to(dev)
    phi, _, counts = lm_steps(cfg.name, params, cfg, caches, tokens)
    launched.update(counts)
    profile_step(lambda: T._decode_backbone(params, tokens[0], 0, caches,
                                            cfg),
                 label=f"moe profile ({cfg.name} backbone, B={bq}, one step)")
    del caches
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 2. the vocabulary kernels at this head's shape ------------------
    rec = vocab_kernels("moe head", params["pq_head"], phi, n_sms)
    del phi

    # ---- 3. the sort dispatch against the dense one, bf16 and f32 --------
    moe_sort_steps(params, cfg, tokens, dev)
    moe_sort_steps(*lm_float32(params, cfg), tokens, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4. DecodeEngine, the fused head ---------------------------------
    launched.update(lm_engine(params, cfg, dev, bq, max_len)["launches"])
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 5. the card against the CPU, bf16 and cast to f32 ---------------
    cpu_toks = rng.integers(0, cfg.vocab, (CPU_STEPS, 2)).astype(np.int32)
    t0 = time.monotonic()
    lm_vs_cpu(params, to_device(params, "cpu"), cfg, cpu_toks, dev)
    p32, cfg32 = lm_float32(params, cfg)
    lm_vs_cpu(p32, to_device(p32, "cpu"), cfg32, cpu_toks, dev)
    print(f"moe card vs CPU: {time.monotonic() - t0:.1f}s")
    del p32, params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6. one training step ---------------------------------------------
    moe_train_step(dev)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 7. dbrx-132b: 16 wide experts ------------------------------------
    _, dcfg, dparams = lm_model("dbrx-132b", 2, dev)
    dcaches = T.init_caches(dcfg, bq, 4096, device=dev)
    print(f"moe caches {dcfg.name} B={bq} max_len 4096: stacked "
          f"{tuple(dcaches['k'].shape)}, {_nbytes(dcaches) / 1e9:.2f} GB")
    dtok = torch.from_numpy(rng.integers(0, dcfg.vocab, (LM_STEPS, bq))
                            .astype(np.int32)).to(dev)
    launched.update(lm_steps(dcfg.name, dparams, dcfg, dcaches, dtok)[2])
    del dparams, dcaches
    gc.collect()
    torch.cuda.empty_cache()
    for name, r in rec.items():
        print(f"kernel {name} (moe head): {r['ms']:.4f}ms plain "
              f"{r['plain_ms']:.4f}ms bound {r['bound_ms']:.4f}ms "
              f"({r['bound_by']}) library {r['library_ms']} launches "
              f"{launched.get(name, 0)} (the checked head calls of both "
              "models and the engine's fused head)")
    print(f"moe phase: {time.monotonic() - t_phase:.1f}s")
    return dict(launched)


# ---- GraphSAGE: sampled, full-batch and batched-graph training ---------

GNN_ARCH = "graphsage-reddit"
GNN_EDGE_CUT = 10                   # minibatch_lg's edges, cut tenfold
GNN_MB_STEPS = 20
GNN_TRAIN_NODES = 196_615           # ogbn-products' train split
GNN_TOL = 1e-5                      # card against CPU, rel, loss and grads


def gnn_config(dims):
    """graphsage-reddit with the shape's class count (the reference's
    ``launch/steps.py`` rule)."""
    from repro_torch.configs.base import get_config
    return replace(get_config(GNN_ARCH).model, n_classes=dims["n_classes"])


def gnn_minibatch(dev, shape):
    """``minibatch_lg``: 20 AdamW steps of fanout-sampled batches, each
    step split into host sampling and gather, the copy to the card, and
    the step on the card (host clock, synchronized; medians)."""
    import numpy as np
    import torch
    from repro_torch.data import graph as G
    from repro_torch.models import gnn as GNN
    from repro_torch.training import optimizer as opt_lib, train_loop
    d = shape.dims
    n_edges = d["n_edges"] // GNN_EDGE_CUT
    t0 = time.monotonic()
    g = G.synthetic_graph(d["n_nodes"], n_edges, d["d_feat"],
                          d["n_classes"], seed=0)
    sampler = G.NeighborSampler(g)
    t_graph = time.monotonic() - t0
    cfg = gnn_config(d)
    params = GNN.init_gnn(torch.Generator(device=dev).manual_seed(0), cfg,
                          d["d_feat"])
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=2,
                               total_steps=GNN_MB_STEPS)
    step = train_loop.make_train_step(
        lambda p, b: GNN.gnn_minibatch_loss(p, b, cfg), ocfg)
    opt = train_loop.init_opt_state(params, ocfg)
    rng = np.random.default_rng(1)
    split = {"host": [], "copy": [], "device": []}
    losses = []
    for _ in range(GNN_MB_STEPS):
        t0 = time.perf_counter()
        batch = sampler.sample_batch(
            rng.integers(0, g.n_nodes, d["batch_nodes"]), d["fanout"], rng)
        t1 = time.perf_counter()
        dbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params, opt, metrics = step(params, opt, dbatch)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, a, b in (("host", t0, t1), ("copy", t1, t2),
                           ("device", t2, t3)):
            split[name].append((b - a) * 1e3)
        losses.append(float(metrics["loss"]))
    nbytes = sum(v.nbytes for v in batch.values())
    med = {k: statistics.median(v) for k, v in split.items()}
    if not np.isfinite(losses).all():
        raise AssertionError(f"gnn minibatch_lg: losses {losses}")
    print(f"gnn minibatch_lg {cfg.name}: N={g.n_nodes}, E={n_edges} (cut "
          f"{GNN_EDGE_CUT}x from {d['n_edges']}), d_feat {d['d_feat']}, "
          f"{cfg.n_classes} classes, batch {d['batch_nodes']} fanout "
          f"{d['fanout']}; graph and sampler made on the host in "
          f"{t_graph:.1f}s; {GNN_MB_STEPS} AdamW steps, losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; median ms: host sampling "
          f"and gather {med['host']:.3f}, copy {med['copy']:.3f} "
          f"({nbytes / 1e6:.1f} MB, {nbytes / med['copy'] / 1e6:.2f} GB/s), "
          f"step on the card {med['device']:.3f} (host clock)")


def gnn_full_batch(dev, shape):
    """``ogb_products`` at full size: a full-batch ``gnn_loss`` forward and
    backward and an AdamW step, twice (host clock, synchronized), with the
    peak memory above what was held; then one more under the profiler."""
    import gc
    import numpy as np
    import torch
    from repro_torch.data import graph as G
    from repro_torch.models import gnn as GNN
    from repro_torch.training import optimizer as opt_lib, train_loop
    d = shape.dims
    t0 = time.monotonic()
    g = G.synthetic_graph(d["n_nodes"], d["n_edges"], d["d_feat"],
                          d["n_classes"], seed=0)
    mask = np.zeros(g.n_nodes, np.float32)
    mask[np.random.default_rng(2).permutation(g.n_nodes)[
        :GNN_TRAIN_NODES]] = 1.0
    t_graph = time.monotonic() - t0
    batch = {"feats": g.feats, "edges": g.edges, "labels": g.labels,
             "label_mask": mask}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    del g
    cfg = gnn_config(d)
    params = GNN.init_gnn(torch.Generator(device=dev).manual_seed(0), cfg,
                          d["d_feat"])
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    step = train_loop.make_train_step(
        lambda p, b: GNN.gnn_loss(p, b, cfg), ocfg)
    opt = train_loop.init_opt_state(params, ocfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ms, losses = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise AssertionError(f"gnn ogb_products: losses {losses}")
    profile_step(lambda: step(params, opt, batch),
                 label="gnn profile (ogb_products, one full-batch step)")
    print(f"gnn ogb_products {cfg.name}: N={d['n_nodes']}, "
          f"E={d['n_edges']}, d_feat {d['d_feat']}, {cfg.n_classes} "
          f"classes, {GNN_TRAIN_NODES} labelled; graph made on the host in "
          f"{t_graph:.1f}s; full-batch step (forward, backward, AdamW) ms "
          f"{ms[0]:.3f} (first) {ms[1]:.3f}; losses {losses[0]:.4f} -> "
          f"{losses[1]:.4f}; peak {peak / 2**30:.3f} GiB "
          f"({(peak - held) / 2**30:.3f} GiB above the {held / 2**30:.3f} "
          "GiB held)")
    del batch, params, opt, step


def gnn_vs_cpu(dev, shape):
    """``full_graph_sm`` (full batch) or ``molecule`` (128 small graphs):
    the loss and every gradient on the card against the CPU from the same
    weights and batch, each within ``GNN_TOL`` (rel)."""
    import numpy as np
    import torch
    from repro_torch.data import graph as G
    from repro_torch.models import gnn as GNN
    from repro_torch.training import tree
    d = shape.dims
    cfg = gnn_config(d)
    if shape.name == "molecule":
        batch = G.molecule_batch(d["graph_batch"], d["n_nodes"],
                                 d["n_edges"], d["d_feat"], d["n_classes"],
                                 seed=3)
        loss_fn = GNN.gnn_graph_batch_loss
    else:
        g = G.synthetic_graph(d["n_nodes"], d["n_edges"], d["d_feat"],
                              d["n_classes"], seed=2)
        batch = {"feats": g.feats, "edges": g.edges, "labels": g.labels,
                 "label_mask": np.random.default_rng(4).integers(
                     0, 2, g.n_nodes).astype(np.float32)}
        loss_fn = GNN.gnn_loss
    params = GNN.init_gnn(torch.Generator().manual_seed(0), cfg, d["d_feat"])
    out = {}
    for where in ("cpu", dev):
        p = tree.tree_map(
            lambda x: x.detach().to(where).requires_grad_(True), params)
        leaves = tree.leaves(p)
        loss, _ = loss_fn(p, {k: torch.from_numpy(v).to(where)
                              for k, v in batch.items()}, cfg)
        loss.backward()
        out[str(where)] = [loss.detach().cpu()] + [x.grad.cpu()
                                                   for x in leaves]
    errs = [rel_err(a, b)[0] for a, b in zip(out[str(dev)], out["cpu"],
                                             strict=True)]
    print(f"gnn card vs CPU {shape.name}: loss {float(out['cpu'][0]):.6f}, "
          f"rel loss {errs[0]:.3e}, gradients max rel {max(errs[1:]):.3e} "
          f"over {len(errs) - 1} leaves (tolerance rel {GNN_TOL})")
    if not max(errs) <= GNN_TOL:
        raise AssertionError(f"gnn card vs CPU {shape.name}: rel {errs}")


def gnn_phase(dev):
    """GraphSAGE on the card (ROADMAP A 7c), graphsage-reddit at full
    width (2 layers, d_hidden 128, mean aggregator): ``minibatch_lg``
    (edges cut tenfold), ``ogb_products`` at full size, ``full_graph_sm``
    and ``molecule`` against the CPU, and the train launcher."""
    import gc
    import torch
    from repro_torch.configs.base import get_config
    t_phase = time.monotonic()
    arch = get_config(GNN_ARCH)
    for name, fn in (("minibatch_lg", gnn_minibatch),
                     ("ogb_products", gnn_full_batch),
                     ("full_graph_sm", gnn_vs_cpu), ("molecule", gnn_vs_cpu)):
        t0 = time.monotonic()
        fn(dev, arch.shape(name))
        gc.collect()
        torch.cuda.empty_cache()
        print(f"gnn {name}: {time.monotonic() - t0:.1f}s")
    res, _, peak, held, wall = run_launcher(
        ["--arch", GNN_ARCH, "--steps", "30", "--batch", "1024"])
    launcher_line(f"{GNN_ARCH} launcher", res, peak, held, wall, 1024)
    print(f"gnn phase: {time.monotonic() - t_phase:.1f}s")


EB_SRC = "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu"
RECSYS_ARCHS = ("bst", "dcn-v2", "dien", "fm")


def build_all():
    """Build every kernel library at once: one nvcc per source, started
    together; print each kernel instance's ptxas report as the compiler
    wrote it, and fail if a pqtopk instance for a width the configs use
    (m = 2, 4, 6, 8) has a stack frame.  Returns {package: library
    path}."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.kernels.pqtopk import kernel as pq_kernel
    mods = {"pqtopk": pq_kernel, "embedding_bag": eb_kernel}
    with ThreadPoolExecutor(len(mods)) as pool:
        futs = {name: pool.submit(mod.build) for name, mod in mods.items()}
        libs = {name: f.result() for name, f in futs.items()}
    framed = []
    for name, lib in libs.items():
        entry, frame = "", ""
        for line in nvcc.report_path(lib).read_text().splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            elif "stack frame" in line:
                frame = line.strip()
            elif "registers" in line:
                print(f"ptxas {entry}: {line.split(':', 1)[1].strip()}; "
                      f"{frame}")
                if name == "pqtopk" and any(f"Li{w}E" in entry
                                            for w in (2, 4, 6, 8)) \
                        and not frame.startswith("0 bytes stack frame"):
                    framed.append(entry)
    if framed:
        raise AssertionError(f"stack frames in {framed}")
    return libs


def print_plans(n_sms):
    """The launch plans of the main path's and the recsys shapes' kernel
    calls (kernel.plan_launch): queries per lookup, ring, shared memory and
    the warps an SM holds (shared memory allowing; ptxas's registers above
    say whether registers allow the same)."""
    from repro_torch.kernels.pqtopk import kernel
    shapes = [("pq_scores main", "scores", dict(m=8, b=512, bq=64,
                                                code_bytes=2, n=1_271_638)),
              ("pq_topk_fused main", "fused", dict(m=8, b=512, bq=64,
                                                   code_bytes=2, tile=2048)),
              ("pq_topk_fused live", "fused", dict(m=8, b=512, bq=64,
                                                   code_bytes=2, tile=2048,
                                                   live=True)),
              ("pq_topk_fused 2D bt=8", "fused", dict(
                  m=8, b=512, bq=64, code_bytes=2, tile=2048, batch_tile=8))]
    shapes += [(f"pq_topk_fused B=1 m={m}", "fused",
                dict(m=m, b=256, bq=1, code_bytes=4, tile=2048))
               for m in (2, 4, 6, 8)]
    for what, kind, kw in shapes:
        p = kernel.plan_launch(kind, **kw)
        print(f"plan {what}: qb={p.qb} chunk={p.chunk} depth={p.depth} "
              f"smem={p.smem}B, {p.blocks_per_sm} block(s) of "
              f"{kernel.THREADS} threads = "
              f"{p.blocks_per_sm * kernel.THREADS // 32} warps per SM "
              f"({n_sms} SMs)")


def bag_inputs(v, d, n_bags, bag, weighted, seed, dev, row0=False):
    """A table (``row0``: row 0 holds NaN and +-inf), indices in [-1, v)
    (bags 0 and n_bags-1 all padding) and weights, from numpy with
    ``seed``."""
    import numpy as np
    import torch
    from repro_torch.kernels.embedding_bag import ref
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    if row0:
        ref.plant_row0(table)
    idx = rng.integers(-1, v, (n_bags, bag)).astype(np.int32)
    idx[[0, n_bags - 1]] = -1
    w = rng.uniform(0, 1, (n_bags, bag)).astype(np.float32)
    return (torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev),
            torch.from_numpy(w).to(dev) if weighted else None)


def check_embedding_bag(dev):
    """Phase 1: the kernel through its wrapper against the plain version,
    bit for bit, over ``ref.GRID``, ``ref.LAYOUT_GRID`` (the kernel's
    other layouts) and ``ref.ROW0_GRID`` (row 0 NaN and +-inf; each case
    with all-padding bags); each call must launch the kernel once.
    Returns the max abs error over entries finite in both."""
    import torch
    from repro_torch.kernels.embedding_bag import kernel, ops, ref
    err = 0.0
    cases = ([(c, False) for c in ref.GRID + ref.LAYOUT_GRID]
             + [(c, True) for c in ref.ROW0_GRID])
    for i, ((v, d, n_bags, bag, mode, weighted), row0) in enumerate(cases):
        table, idx, w = bag_inputs(v, d, n_bags, bag, weighted, i, dev, row0)
        before = kernel.embedding_bag_cuda.launches
        got = ops.embedding_bag(table, idx, w, mode=mode)
        torch.cuda.synchronize()
        if kernel.embedding_bag_cuda.launches != before + 1:
            raise AssertionError(f"embedding_bag {v}x{d}: launched "
                                 f"{kernel.embedding_bag_cuda.launches - before}"
                                 " times, expected 1")
        want = ref.embedding_bag(table, idx, w, mode)
        both = torch.isfinite(got) & torch.isfinite(want)
        err = max(err, torch.where(both, got - want, 0.0).abs().max().item())
        if not same_bits((got,), (want,)):
            raise AssertionError(
                f"embedding_bag V={v} d={d} n_bags={n_bags} bag={bag} {mode} "
                f"weighted={weighted} row0={row0}: value bits differ from "
                "the plain version")
        pad0 = got[0].isnan().all() if row0 else torch.equal(
            got[0], torch.zeros_like(got[0]))
        if not pad0:
            raise AssertionError(f"embedding_bag row0={row0}: an all-padding "
                                 "bag is not 0 (NaN with a NaN row 0)")
    print(f"kernel check embedding_bag: {len(cases)} shapes (the reference's "
          "grid, d from 3 to 600, bags past 32 slots, n_bags not a multiple "
          "of 8 and past 8,192, all-padding bags, row 0 NaN and +-inf) "
          "bit-exact")
    return err


def bag_bytes(idx, d, weighted):
    """The least traffic of one embedding-bag call on this data: each
    distinct row it reads (row 0 too where a slot is padding), each index,
    each weight where the bag is weighted (an unweighted bag's mask is
    derived from its indices), and the (n_bags, d) output, in f32.
    Returns (bytes, distinct rows read)."""
    import torch
    live = idx >= 0
    rows = torch.unique(idx[live])
    n_rows = rows.numel() + int(bool((~live).any())
                                and not bool((rows == 0).any()))
    n_slots = idx.numel()
    return (n_rows * 4 * d + n_slots * 4 + (n_slots * 4 if weighted else 0)
            + idx.shape[0] * 4 * d), n_rows


def bag_path(name, table, idx, w, mode, n_sms):
    """Phase 2, one input: ``lookup_bag(use_kernel=True)`` with the launch
    count set to 0 just before and read just after (one launch), held
    bit for bit against the plain version; then the kernel and its plain
    version timed (each applies the padding mask itself; the kernel in
    turns with any ``embedding_bag.cu`` baseline), ``F.embedding_bag`` on
    the folded weights and the byte bound of :func:`bag_bytes`.  Returns
    (output, record)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import kernel, ref
    from repro_torch.models import embedding
    kernel.embedding_bag_cuda.launches = 0
    out = embedding.lookup_bag(table, idx, w, mode=mode, use_kernel=True)
    torch.cuda.synchronize()
    launches = kernel.embedding_bag_cuda.launches
    if launches != 1:
        raise AssertionError(f"{name}: lookup_bag launched embedding_bag "
                             f"{launches} times, expected 1")
    want = ref.embedding_bag(table, idx, w, mode)
    err = (out - want).abs().max().item()
    if not same_bits((out,), (want,)):
        raise AssertionError(f"{name}: {int((out != want).sum())} values "
                             "differ from the plain version")
    idx32 = idx.to(torch.int32).contiguous()
    wf = ref.fold_weights(idx32, w).contiguous()
    idx0 = idx32.clamp(min=0)
    n_bags, bag = idx.shape
    d = table.shape[1]
    if mode == "mean":
        lib_fn = lambda: F.embedding_bag(
            idx0, table, per_sample_weights=wf, mode="sum") \
            / wf.sum(1).clamp(min=1.0)[:, None]
    else:
        lib_fn = lambda: F.embedding_bag(idx0, table, per_sample_weights=wf,
                                         mode="sum")
    lib_out = lib_fn()
    torch.testing.assert_close(lib_out, out, rtol=1e-5, atol=1e-6)
    w32 = None if w is None else w.to(torch.float32).contiguous()
    rec = {"ms": compare_timed(
               f"embedding_bag {name}",
               lambda: kernel.embedding_bag_cuda(table, idx32, w32,
                                                 mode=mode),
               lambda bl: bl.embedding_bag(table, idx32, w32, wf, mode),
               kind="embedding_bag"),
           "plain_ms": time_ms(lambda: ref.bag_reduce(table, idx32, w32,
                                                      mode), 5),
           "library_ms": time_ms(lib_fn, 20, graph=True)}
    nbytes, n_rows = bag_bytes(idx32, d, weighted=w is not None)
    bnd, by, terms = bound_ms(nbytes, 2 * n_bags * bag * d, 0, n_sms)
    rec.update(bound_ms=bnd, bound_by=by, launches=launches, max_abs_err=err)
    print(f"bag {name}: table {tuple(table.shape)} n_bags={n_bags} bag={bag} "
          f"{mode}: kernel {rec['ms']:.4f}ms plain {rec['plain_ms']:.4f}ms "
          f"F.embedding_bag {rec['library_ms']:.4f}ms bound {bnd:.4f}ms "
          f"({by}: {nbytes / 1e6:.1f} MB, {n_rows} distinct rows of "
          f"{n_bags * bag} slots; {terms}); bit-exact, launches "
          f"{launches}")
    if any(bl.kind == "embedding_bag" for bl in BASELINES.values()):
        # Only beside an embedding_bag baseline: one sort of the indices,
        # the least a pass that deduplicated the batch's rows would add.
        sort_ms = time_ms(lambda: torch.sort(idx32.reshape(-1)), 20,
                          graph=True)
        print(f"bag {name}: torch.sort of its indices {sort_ms:.4f}ms")
    return out, rec


def recsys_models(dev, n_sms):
    """Phases 2 and 3: each recsys config at full width, one at a time
    (freed before the next).  Init on the CPU generator (seed 0), then to
    the card; BST's item table and DCN-v2's largest table carry the
    substrate's bag path (phase 2); every config serves ``serve_p99``
    against the same function on the CPU, ``retrieval_cand`` through the
    fused kernel (bit-identical to ``pqtopk``), and DCN-v2 also
    ``serve_bulk`` and the other flat methods.  The model paths launch
    ``embedding_bag`` 0 times and the fused kernel once per
    ``retrieve_topk``.  Returns the bag records by name."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.recsys_data import ctr_batch
    from repro_torch.core import scoring
    from repro_torch.interop import to_device
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.kernels.pqtopk import kernel as pq_kernel, ops as pq_ops
    from repro_torch.models import recsys
    bags = {}
    for arch in RECSYS_ARCHS:
        spec = get_config(arch)
        cfg = spec.model
        t0 = time.monotonic()
        cpu_params = recsys.init_recsys(torch.Generator().manual_seed(0), cfg,
                                        device="cpu")
        t_draw = time.monotonic() - t0
        params = to_device(cpu_params, dev)
        torch.cuda.synchronize()
        n_rows = cfg.total_rows()
        print(f"init {arch}: {len(cfg.table_rows)} tables, {n_rows} rows x "
              f"{cfg.embed_dim} f32 ({n_rows * cfg.embed_dim * 4 / 1e9:.3f} "
              f"GB), catalogue N={cfg.n_items} m={cfg.pq.m} b={cfg.pq.b} "
              f"{params['item_emb']['codes'].dtype}: drawn on the CPU in "
              f"{t_draw:.1f}s, on the card in {time.monotonic() - t0:.1f}s")
        with torch.inference_mode():
            if arch == "bst":
                # (a) The item halves of the histories, mean-pooled by
                # lookup_bag, against user_query's lookup_fields pooling.
                table = params["emb"]["tables"][0]
                for shape in ("serve_p99", "serve_bulk"):
                    n = spec.shape(shape).dims["global_batch"]
                    batch = recsys.batch_tensors(ctr_batch(cfg, n, 0), dev)
                    hist = batch["seq"][:, :, 0]
                    out, rec = bag_path(f"bst {shape}", table, hist, None,
                                        "mean", n_sms)
                    torch.testing.assert_close(
                        out, recsys.user_query(params, batch, cfg),
                        rtol=1e-5, atol=1e-6)
                    print(f"bag bst {shape}: matches user_query's pooled "
                          "history (rtol=1e-5, atol=1e-6)")
                    bags[f"bst {shape}"] = rec
                    del batch, hist, out
            if arch == "dcn-v2":
                # (b) The largest Criteo table, weighted sum, 25% padding.
                big = int(np.argmax(cfg.table_rows))
                table = params["emb"]["tables"][big]
                rng = np.random.default_rng(7)
                idx = rng.integers(0, table.shape[0], (4096, 8))
                idx[rng.random(idx.shape) < 0.25] = -1
                w = rng.uniform(0, 1, idx.shape).astype(np.float32)
                _, bags["dcn-v2 criteo"] = bag_path(
                    f"dcn-v2 table {big}",
                    table, torch.from_numpy(idx.astype(np.int32)).to(dev),
                    torch.from_numpy(w).to(dev), "sum", n_sms)

            # ---- phase 3: the model paths, counts at 0 ----------------
            p99 = ctr_batch(cfg, spec.shape("serve_p99").dims["global_batch"],
                            0)
            b_p99 = recsys.batch_tensors(p99, dev)
            b_one = recsys.batch_tensors(ctr_batch(cfg, 1, 1), dev)
            bulk = (recsys.batch_tensors(ctr_batch(
                cfg, spec.shape("serve_bulk").dims["global_batch"], 2), dev)
                if arch == "dcn-v2" else None)
            eb_kernel.embedding_bag_cuda.launches = 0
            pq_kernel.pq_topk_fused_cuda.launches = 0
            logits = recsys.ctr_logits(params, b_p99, cfg)
            ids, vals = recsys.retrieve_topk(params, b_one, cfg, k=K,
                                             method="pqtopk_fused")
            bulk_logits = (recsys.ctr_logits(params, bulk, cfg)
                           if bulk is not None else None)
            torch.cuda.synchronize()
            got = {"embedding_bag": eb_kernel.embedding_bag_cuda.launches,
                   "pq_topk_fused": pq_kernel.pq_topk_fused_cuda.launches}
            print(f"path {arch} (ctr_logits serve_p99"
                  f"{', serve_bulk' if bulk is not None else ''}, "
                  f"retrieve_topk pqtopk_fused): launches {got}; the model "
                  "paths do not run embedding_bag, as in the reference")
            if got != {"embedding_bag": 0, "pq_topk_fused": 1}:
                raise AssertionError(f"{arch}: launched {got}, expected "
                                     "embedding_bag 0 and pq_topk_fused 1")

            want = recsys.ctr_logits(cpu_params, recsys.batch_tensors(
                p99, "cpu"), cfg)
            if logits.shape != (len(want),) or not bool(
                    torch.isfinite(logits).all()):
                raise AssertionError(f"{arch}: bad logits {logits.shape}")
            torch.testing.assert_close(logits.cpu(), want, rtol=1e-4,
                                       atol=1e-4)
            err = (logits.cpu() - want).abs().max().item()
            p99_ms = time_ms(lambda: recsys.ctr_logits(params, b_p99, cfg),
                             10)
            print(f"serve_p99 {arch}: B={len(want)} ctr_logits "
                  f"{p99_ms:.4f}ms; matches the CPU run (max abs diff "
                  f"{err:.3e}, rtol=atol=1e-4)")
            if bulk_logits is not None:
                n_bulk = bulk_logits.shape[0]
                if not bool(torch.isfinite(bulk_logits).all()):
                    raise AssertionError(f"{arch}: non-finite bulk logits")
                head = {k: v[:512].cpu() for k, v in bulk.items()}
                torch.testing.assert_close(
                    bulk_logits[:512].cpu(),
                    recsys.ctr_logits(cpu_params, head, cfg),
                    rtol=1e-4, atol=1e-4)
                bulk_ms = time_ms(lambda: recsys.ctr_logits(params, bulk,
                                                            cfg), 5)
                print(f"serve_bulk {arch}: B={n_bulk} ctr_logits "
                      f"{bulk_ms:.4f}ms ({n_bulk / bulk_ms * 1e3:.0f} "
                      "rows/s); first 512 rows match the CPU run")
            ev, ei = recsys.retrieve_topk(params, b_one, cfg, k=K,
                                          method="pqtopk")[::-1]
            if not (torch.equal(ids, ei) and torch.equal(vals, ev)):
                raise AssertionError(f"{arch}: pqtopk_fused differs from "
                                     "pqtopk")
            if ids.shape != (1, K) or ids.min() < 0 \
                    or ids.max() >= cfg.n_items:
                raise AssertionError(f"{arch}: bad ids {ids}")
            # The fused kernel alone at this shape, and the query side.
            head = params["item_emb"]
            s_q = scoring.subid_scores(head["sub_emb"], recsys.user_query(
                params, b_one, cfg)).contiguous()
            n = head["codes"].shape[0]
            tile = min(2048, -(-n // 128) * 128)
            idx = torch.arange(pq_ops.n_tiles(n, tile), dtype=torch.int32,
                               device=dev)
            split = {"user_query": time_ms(lambda: recsys.user_query(
                         params, b_one, cfg), 10),
                     "fused kernel": compare_timed(
                         f"pq_topk_fused {arch} B=1",
                         lambda: pq_kernel.pq_topk_fused_cuda(
                             head["codes"], s_q, K, idx, n_items=n,
                             tile=tile),
                         lambda bl: bl.pq_topk_fused(
                             head["codes"], s_q, K, idx, n_items=n,
                             tile=tile))}
            methods = ("pqtopk_fused", "pqtopk") + (
                ("dense", "recjpq", "pqtopk_onehot")
                if arch == "dcn-v2" else ())
            times = {}
            for method in methods:
                fn = lambda: recsys.retrieve_topk(params, b_one, cfg, k=K,
                                                  method=method)
                if method in ("dense", "recjpq", "pqtopk_onehot"):
                    # Sequential and matmul sums round differently from
                    # tree_sum: values within 1e-5 of the exact route.
                    torch.testing.assert_close(fn()[1], ev, rtol=1e-5,
                                               atol=1e-5)
                times[method] = time_ms(fn, 10)
            print(f"retrieval_cand {arch}: N={cfg.n_items} B=1 k={K} "
                  + ", ".join(f"{m} {t:.4f}ms" for m, t in times.items())
                  + " (pqtopk_fused's parts: " + ", ".join(f"{m} {t:.4f}ms"
                                            for m, t in split.items())
                  + "); pqtopk_fused bit-identical to pqtopk"
                  + ("; dense, recjpq, pqtopk_onehot within 1e-5"
                     if arch == "dcn-v2" else ""))
            del b_p99, b_one, bulk, logits, bulk_logits
        del params, cpu_params
        gc.collect()
        torch.cuda.empty_cache()
    return bags


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", action="append", default=[],
                    metavar="LABEL=SOURCE",
                    help="another pqtopk.cu (the earlier C interface, or this "
                         "tree's) or embedding_bag.cu to build and time "
                         "against this tree's kernel, in turns, at every "
                         "timing of that kernel; its outputs must be "
                         "bit-identical")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="LABEL=SOURCE",
                    help="as --baseline, but timed only (a source that "
                         "computes something else, for a timing split)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    import torch
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.core import retrieval_head, scoring
    from repro_torch.core.pq import widen
    from repro_torch.kernels.pqtopk import kernel, ops, ref
    from repro_torch.models import seqrec

    dev = torch.device("cuda")
    t_start = time.monotonic()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    libs = build_all()
    print(f"build: {time.monotonic() - t0:.1f}s -> "
          + ", ".join(os.path.relpath(p, ROOT) for p in libs.values()))
    specs = ([(a.split("=", 1), True) for a in args.baseline]
             + [(a.split("=", 1), False) for a in args.variant])
    if specs:
        from concurrent.futures import ThreadPoolExecutor
        t0 = time.monotonic()
        with ThreadPoolExecutor(len(specs)) as pool:
            built = list(pool.map(lambda sp: Baseline(*sp[0], sp[1]), specs))
        for bl, ((label, source), check) in zip(built, specs):
            BASELINES[label] = bl
            print(f"baseline {label}: {source}"
                  + ("" if check else " (timed only)"))
        print(f"baselines built in {time.monotonic() - t0:.1f}s")

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print_plans(n_sms)
    max_err = check_kernels(dev)
    for name, e in check_specials(dev).items():
        max_err[name] = max(max_err.get(name, 0.0), e)
    max_err["embedding_bag"] = check_embedding_bag(dev)
    max_err["pq_topk_fused_live"] = max(max_err["pq_topk_fused_live"],
                                        check_live_kernel(dev))
    forms = skewed_cascade(dev, n_sms)
    hier = hier_phase(dev, n_sms)
    stream = stream_phase(dev, n_sms)
    max_err["pq_topk_fused"] = max(
        [max_err["pq_topk_fused"], hier["host"]["max_abs_err"],
         stream["max_abs_err"]] + [hier[(n, "split")][1]["max_abs_err"]
                                   for n in HIER_SIZES])

    # ---- full-width model, served through the engine ----------------
    cfg = get_config("sasrec-recjpq").model
    t0 = time.monotonic()
    params = seqrec.init_seqrec(torch.Generator().manual_seed(0), cfg,
                                device=dev)
    torch.cuda.synchronize()
    print(f"init: {cfg.name} N={cfg.n_items} d={cfg.d_model} m={cfg.pq.m} "
          f"b={cfg.pq.b} codes={params['item_emb']['codes'].dtype} in "
          f"{time.monotonic() - t0:.1f}s")
    launches, path_stats, outs = serve_paths(params, cfg, dev)
    fused_out = outs["pqtopk_fused"]
    shard = sharded_phase(params, cfg, dev, outs, n_sms)
    for name, e in shard["err"].items():
        max_err[name] = max(max_err[name], e)
    live_rec = mutable_path(params, cfg, dev, n_sms, path_stats)
    router_phase(params, cfg, dev, fused_out, path_stats)
    train_phase(dev)
    lm = lm_phase(dev, n_sms)

    # ---- every method once, on one full batch ------------------------
    rng = np.random.default_rng(2)
    seqs = torch.from_numpy(rng.integers(
        1, cfg.n_items + 1, (MAX_BATCH, cfg.max_seq_len)).astype(np.int32)
    ).to(dev)
    head = params["item_emb"]
    with torch.inference_mode():
        phi = seqrec.sequence_embedding(params, seqs, cfg)
        backbone_ms = time_ms(
            lambda: seqrec.sequence_embedding(params, seqs, cfg), 5)
        print(f"backbone: B={MAX_BATCH} S={cfg.max_seq_len} {backbone_ms:.3f}ms")
        results, method_ms = {}, {}
        for method in ("pqtopk", "pqtopk_kernel", "pqtopk_fused",
                       "pqtopk_pruned", "recjpq", "pqtopk_onehot", "dense",
                       "pqtopk_approx"):
            fn = lambda: retrieval_head.top_items(head, phi, K, method=method,
                                                  pq_cfg=cfg.pq)
            results[method] = fn()
            method_ms[method] = time_ms(fn, 3)
            print(f"method {method}: scoring+top-k {method_ms[method]:.3f}ms")
        ev, ei = results["pqtopk"]
        for method in ("pqtopk_kernel", "pqtopk_fused", "pqtopk_pruned"):
            v, i = results[method]
            if not (torch.equal(v, ev) and torch.equal(i, ei)):
                raise AssertionError(f"{method} differs from pqtopk")
        # Sequential (recjpq, onehot) and matmul (dense) sums round
        # differently from tree_sum: values within 1e-5 of the exact route.
        for method in ("recjpq", "pqtopk_onehot", "dense"):
            v, _ = results[method]
            torch.testing.assert_close(v, ev, rtol=1e-5, atol=1e-5)
        av, _ = results["pqtopk_approx"]
        if not (torch.equal(av[:, 0], ev[:, 0]) and torch.all(av <= ev[:, :1])):
            raise AssertionError("pqtopk_approx: top-1 differs from exact")
        print("methods: pqtopk, pqtopk_kernel, pqtopk_fused, pqtopk_pruned "
              "bit-identical; recjpq, pqtopk_onehot, dense within "
              "rtol=atol=1e-5")

        # ---- kernel timings at the main path's shapes ----------------
        codes = head["codes"]
        s = scoring.subid_scores(head["sub_emb"], phi).contiguous()
        n, m = codes.shape
        bq, _, b = s.shape
        tile = min(2048, -(-n // 128) * 128)
        idx = torch.arange(ops.n_tiles(n, tile), dtype=torch.int32,
                           device=dev)
        code_b = codes.element_size()
        # The same batch through the cascade with super-tiles: random codes
        # put every sub-id in every tile, so every super survives and the
        # bound work grows by the super count.
        from repro_torch.core import pruning
        sup_state = super_model(params, cfg)[0]["item_emb"]["pruned"]
        _, _, fst = pruning.cascade_topk_ingraph(codes, s, K, head["pruned"],
                                                 return_stats=True)
        hv, hi, hst = pruning.cascade_topk_ingraph(codes, s, K, sup_state,
                                                   return_stats=True)
        if not (torch.equal(hv, ev) and torch.equal(hi, ei)):
            raise AssertionError("super-tile cascade differs from pqtopk")
        flat_b = pruning.tile_bounds(head["pruned"], s)
        sup_b = pruning.bounds_from_parts("bitmask",
                                          sup_state.super_meta_arrays(), s)
        seeds = {"flat seed": time_ms(lambda: pruning.theta_seed_ingraph(
                     codes, s, flat_b, K, tile=sup_state.tile), 5),
                 "super seed": time_ms(lambda: pruning.theta_seed_ingraph(
                     codes, s, sup_b, K, tile=sup_state.tile * HIER_FACTOR),
                     5),
                 "flat cascade": host_ms(lambda: pruning.cascade_topk_ingraph(
                     codes, s, K, head["pruned"])),
                 "super cascade": host_ms(lambda: pruning.cascade_topk_ingraph(
                     codes, s, K, sup_state))}
        print(f"model cascade with super-tiles of {HIER_FACTOR}: T="
              f"{sup_state.n_tiles} S={sup_state.n_super} n_super_survived="
              f"{hst['n_super_survived']} bounds_computed "
              f"{fst['bounds_computed']} -> {hst['bounds_computed']}, "
              f"n_survived {fst['n_survived']} -> {hst['n_survived']}; "
              + ", ".join(f"{k} {v:.4f}ms" for k, v in seeds.items())
              + " (seeds device time, cascades host clock); bit-identical "
              "to pqtopk")
        recs = []
        scores_ms = compare_timed(
            "pq_scores", lambda: kernel.pq_scores_cuda(codes, s),
            lambda bl: bl.pq_scores(codes, s))
        scores_plain = time_ms(lambda: ref.pq_scores(codes, s), 5)
        # One library call computing the same sums: embedding_bag over the
        # flattened (m*b, B) table, split k offset by k*b.
        flat = widen(codes) + torch.arange(m, device=dev) * b
        table = s.permute(1, 2, 0).reshape(m * b, bq).contiguous()
        emb_ms = time_ms(lambda: torch.nn.functional.embedding_bag(
            flat, table, mode="sum"), 20, graph=True)
        bnd, by, terms = bound_ms(
            n * m * code_b + bq * m * b * 4 + bq * n * 4, bq * n * (m - 1),
            bq * n * m, n_sms)
        print(f"bound pq_scores: {terms} ms on {n_sms} SMs")
        src = "src/repro_torch/kernels/pqtopk/csrc/pqtopk.cu"
        recs.append({
            "name": "pq_scores", "route": "cuda", "source": src,
            "replaces": "src/repro/kernels/pqtopk/kernel.py:100",
            "launches": launches["pqtopk_kernel"]["pq_scores"],
            "max_abs_err": max_err["pq_scores"], "ms": scores_ms,
            "plain_ms": scores_plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": emb_ms})
        topk_ms = compare_timed(
            "pq_topk_fused", lambda: kernel.pq_topk_fused_cuda(
                codes, s, K_KERNEL, idx, n_items=n, tile=tile),
            lambda bl: bl.pq_topk_fused(codes, s, K_KERNEL, idx, n_items=n,
                                        tile=tile))
        topk_plain = time_ms(lambda: ref.pq_topk_slots(
            codes, s, K_KERNEL, idx, n_items=n, tile=tile), 3)
        n_slots = idx.numel()
        bnd, by, terms = bound_ms(
            n * m * code_b + bq * m * b * 4 + n_slots * 4
            + bq * n_slots * K_KERNEL * 8, bq * n * (m - 1), bq * n * m,
            n_sms)
        print(f"bound pq_topk_fused: {terms} ms on {n_sms} SMs")
        recs.append({
            "name": "pq_topk_fused", "route": "cuda", "source": src,
            "replaces": "src/repro/kernels/pqtopk/kernel.py:145",
            "launches": launches["pqtopk_fused"]["pq_topk_fused"],
            "max_abs_err": max_err["pq_topk_fused"], "ms": topk_ms,
            "plain_ms": topk_plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None})
    # The pruned forms, timed on the skewed catalogue (the random-weight
    # model's bounds prune nothing); launches from the pruned engines.
    recs.append({
        "name": "pq_topk_fused_sentinel", "route": "cuda", "source": src,
        "replaces": "src/repro/kernels/pqtopk/kernel.py:170",
        "launches": launches["pqtopk_pruned"]["pq_topk_fused"],
        "max_abs_err": max_err["pq_topk_fused"],
        **forms["pq_topk_fused_sentinel"], "library_ms": None})
    recs.append({
        "name": "pq_topk_fused_2d", "route": "cuda", "source": src,
        "replaces": "src/repro/kernels/pqtopk/kernel.py:156",
        "launches": launches["pqtopk_pruned_grouped"]["pq_topk_fused_2d"],
        "max_abs_err": max_err["pq_topk_fused_2d"],
        **forms["pq_topk_fused_2d"], "library_ms": None})
    recs.append({
        "name": "pq_topk_fused_live", "route": "cuda", "source": src,
        "replaces": "src/repro/kernels/pqtopk/kernel.py:148",
        "max_abs_err": max_err["pq_topk_fused_live"], **live_rec,
        "library_ms": None})
    for name, line in (("pq_scores", 100), ("pq_topk_fused", 145)):
        recs.append({"name": f"{name}_lm_head", "route": "cuda",
                     "source": src,
                     "replaces": f"src/repro/kernels/pqtopk/kernel.py:{line}",
                     **lm[name]})
    bags = recsys_models(dev, n_sms)
    moe = moe_phase(dev, n_sms)
    for r in recs:      # the MoE heads' launches join the LM-head rows
        if r["name"].endswith("_lm_head"):
            r["launches"] += moe.get(r["name"][:-len("_lm_head")], 0)
            print(f"lm launches {r['name']} with the MoE heads: "
                  f"{r['launches']}")
    gnn_phase(dev)
    bulk = bags["bst serve_bulk"]
    recs.append({
        "name": "embedding_bag", "route": "cuda", "source": EB_SRC,
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:35",
        "launches": sum(b["launches"] for b in bags.values()),
        "max_abs_err": max([max_err["embedding_bag"]]
                           + [b["max_abs_err"] for b in bags.values()]),
        **{k: bulk[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}})
    for n in HIER_SIZES:
        rec = hier[(n, "split")][1]
        print(f"kernel pq_topk_fused (b) hier tail N={n}: {rec['ms']:.4f}ms "
              f"plain {rec['plain_ms']:.4f}ms bound {rec['bound_ms']:.4f}ms "
              f"({rec['bound_by']}) launches 1 per cascade on {card}")
    print(f"kernel pq_topk_fused (a) stream chunk: {stream['kernel_ms']:.4f}"
          f"ms launches {stream['launches']} on {card}")
    for r in recs:
        print(f"kernel {r['name']}: {r['ms']:.4f}ms plain {r['plain_ms']:.4f}"
              f"ms bound {r['bound_ms']:.4f}ms ({r['bound_by']}) library "
              f"{r['library_ms']} launches {r['launches']} on {card}")
    print(f"total: {time.monotonic() - t_start:.1f}s")
    if COMPARISONS:
        print(json.dumps({"comparisons": COMPARISONS, "card": card}))
    print(json.dumps({"kernels": recs}))
    print(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
