"""RQ2 on one GPU: PQTopK over very large simulated catalogues (the paper's
pre-computing scenario, up to 10^9 items), and the hierarchical super-tile
cascade against the flat one.

The backbone is left out (random S), codes are uint8 (b=256), so a
billion-item catalogue is 8 GB of host memory.

``--mode stream`` scores the catalogue in chunks with a running top-k:

* **uint8 over the wire.**  Each chunk goes to the device as uint8, which
  the fused kernel reads natively (``ops.pq_topk``, the identity tile
  list); nothing is widened on the host.
* **ids never wrap.**  The device sees chunk-local int32 ids only; the
  int64 offset ``id_base + start`` is added on the host, so ids past 2^31
  stay exact.
* **no padding rows.**  A ragged last chunk is scored at its own length:
  the kernel masks the padding of its last tile.

``--mode hier`` runs the flat and the hierarchical cascade
(``pruning.with_super``) on a tile-coherent catalogue, holds both against
the one-shot fused route bit for bit, and reports the bound work
(``bounds_computed``) of each.

  PYTHONPATH=src python -m repro_torch.examples.billion_item_sim --items 1e7
  PYTHONPATH=src python -m repro_torch.examples.billion_item_sim \\
      --items 1e9 --chunk 2e7
  PYTHONPATH=src python -m repro_torch.examples.billion_item_sim \\
      --mode hier --items 16777216

``--device`` defaults to ``cuda`` (it raises without a card); ``--device
cpu`` runs the kernels' plain versions, for small ``--items`` only.
"""
from __future__ import annotations

import argparse
import resource
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import pruning
from repro_torch.kernels.pqtopk import ops

K = 10
#: The reference's ``--mode hier`` S (B=2, m=8, b=256, seed 0: its
#: ``jax.random`` draw, saved as float32), so a run without JAX can score
#: the reference's exact inputs; :func:`make_popularity_scores` draws the
#: same distribution from a ``torch.Generator``.
REFERENCE_S = Path(__file__).resolve().parent / "rq2_reference_s.npy"


def merge_topk_host(best_v, best_i, v, i_local, start, k):
    """Fold one chunk's winners into the running top-k on the host.

    ``i_local`` are chunk-local int32 ids and ``start`` a Python int,
    added here in int64 numpy so an id never wraps.  Order is (score
    descending, id ascending), the one-shot top-k's tie-break."""
    cand_v = np.concatenate([best_v, np.asarray(v, np.float32)], axis=1)
    cand_i = np.concatenate(
        [best_i, np.asarray(i_local, np.int64) + np.int64(start)], axis=1)
    out_v = np.empty((cand_v.shape[0], k), np.float32)
    out_i = np.empty((cand_v.shape[0], k), np.int64)
    for q in range(cand_v.shape[0]):
        order = np.lexsort((cand_i[q], -cand_v[q]))[:k]
        out_v[q] = cand_v[q][order]
        out_i[q] = cand_i[q][order]
    return out_v, out_i


def streaming_pqtopk(codes: np.ndarray, s: torch.Tensor, k: int,
                     chunk: int, id_base: int = 0):
    """Chunked PQTopK with a running top-k on the host: device memory stays
    at one chunk of codes whatever N is.  ``codes`` (N, m) uint8 lie on
    the host; ``s`` (B, m, b) f32 on the device that scores them.

    -> ``(values (B, k) f32, ids (B, k) int64, n_chunks)``; ids are
    ``id_base`` + row, so one host of a sharded catalogue can emit global
    ids past 2^31.  A chunk contributes at most ``min(k, rows)`` winners,
    so with k > chunk the survivors carry over across merges."""
    n = codes.shape[0]
    chunk = int(min(chunk, n))
    bq = s.shape[0]
    best_v = np.full((bq, k), -np.inf, np.float32)
    best_i = np.full((bq, k), -1, np.int64)
    n_chunks = 0
    for start in range(0, n, chunk):
        part = torch.from_numpy(codes[start:start + chunk]).to(s.device)
        v, i = ops.pq_topk(part, s, min(k, part.shape[0]))
        best_v, best_i = merge_topk_host(best_v, best_i, v.cpu().numpy(),
                                         i.cpu().numpy(), id_base + start, k)
        n_chunks += 1
    return best_v, best_i, n_chunks


def make_clustered_codes(n: int, m: int, b: int, grain: int,
                         width: int = 8, seed: int = 0) -> np.ndarray:
    """A popularity-sorted, tile-coherent catalogue: every ``grain``
    consecutive items draw their codes from one band [base, base + width),
    bases rising across groups.  With S that decays in the code index
    (:func:`make_popularity_scores`) a few coherent regions hold every
    high scorer: the regime the super level exists for."""
    rng = np.random.default_rng(seed)
    n_groups = -(-n // grain)
    span = max(1, b - width)
    base = np.minimum((np.arange(n_groups, dtype=np.int64) * span)
                      // max(1, n_groups - 1), span - 1)
    codes = np.empty((n, m), np.uint8)
    for g in range(n_groups):
        lo, hi = g * grain, min((g + 1) * grain, n)
        codes[lo:hi] = base[g] + rng.integers(0, width, (hi - lo, m))
    return codes


def make_popularity_scores(bq: int, m: int, b: int, seed: int = 0,
                           scale: float = 4.0) -> torch.Tensor:
    """S (B, m, b) decaying in the code index, plus noise from a seeded
    ``torch.Generator``: low codes (the first bands) score high."""
    decay = -scale * torch.arange(b, dtype=torch.float32) / b
    noise = 0.5 * torch.randn((bq, m, b),
                              generator=torch.Generator().manual_seed(seed))
    return decay[None, None, :] + noise


def peak_rss_mb() -> float:
    """Process high-water RSS in MB (``ru_maxrss`` is KB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _median_s(fn, device: torch.device, repeats: int) -> float:
    """Median seconds of ``fn()`` after a warm-up: CUDA events around each
    call after a synchronize on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def run_hier_compare(n: int, *, m: int = 8, b: int = 256, tile: int = 1024,
                     factor: int = pruning.DEFAULT_SUPER_FACTOR,
                     bq: int = 2, k: int = K, repeats: int = 3,
                     backend: str = "bitmask", seed: int = 0,
                     device="cuda", s=None) -> dict:
    """The flat and the hierarchical cascade on a tile-coherent catalogue of
    ``n`` items: mismatches of either against the other and against the
    one-shot fused route, the bound work of each (``bounds_computed``),
    their median times and the peak RSS.  ``s`` (B, m, b), when given,
    replaces :func:`make_popularity_scores`."""
    dev = resolve_device(device)
    tile = min(tile, n)
    codes = torch.from_numpy(make_clustered_codes(
        n, m, b, grain=tile * factor, seed=seed)).to(dev)
    s = (make_popularity_scores(bq, m, b, seed=seed) if s is None
         else torch.tensor(np.asarray(s, np.float32))).to(dev)
    bq = s.shape[0]
    flat = pruning.build_pruned_state(codes, b, tile, backend=backend)
    hier = pruning.with_super(flat, factor)
    fv, fi, fstats = pruning.cascade_topk_ingraph(codes, s, k, flat,
                                                  return_stats=True)
    hv, hi, hstats = pruning.cascade_topk_ingraph(codes, s, k, hier,
                                                  return_stats=True)
    ov, oi = ops.pq_topk(codes, s, k)
    mismatches = int((fv != hv).sum() + (fi != hi).sum() + (hv != ov).sum()
                     + (hi != oi).sum())
    flat_bounds = int(fstats["bounds_computed"])
    hier_bounds = int(hstats["bounds_computed"])
    return {
        "n_items": n, "m": m, "b": b, "tile": tile,
        "super_factor": factor, "backend": backend, "k": k, "bq": bq,
        "n_tiles": flat.n_tiles, "n_super": hier.n_super,
        "flat_bounds": flat_bounds, "hier_bounds": hier_bounds,
        "bound_reduction": flat_bounds / max(hier_bounds, 1),
        "n_super_survived": int(hstats["n_super_survived"]),
        "mismatches": mismatches,
        "flat_s": _median_s(lambda: pruning.cascade_topk_ingraph(
            codes, s, k, flat), dev, repeats),
        "hier_s": _median_s(lambda: pruning.cascade_topk_ingraph(
            codes, s, k, hier), dev, repeats),
        "peak_rss_mb": peak_rss_mb(), "device": str(dev),
    }


def _main_stream(args, dev) -> None:
    n, chunk = int(args.items), int(args.chunk)
    print(f"simulating |I| = {n:,} items, m={args.m}, b={args.b} "
          f"(codes: {n * args.m / 1e9:.2f} GB uint8) on {dev}")
    rng = np.random.default_rng(0)
    codes = rng.integers(0, args.b, (n, args.m), dtype=np.uint8)
    s = torch.randn((1, args.m, args.b),
                    generator=torch.Generator().manual_seed(0)).to(dev)
    streaming_pqtopk(codes[:min(n, chunk)], s, K, chunk)    # warm-up
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        v, i, n_chunks = streaming_pqtopk(codes, s, K, chunk)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"PQTopK scoring + top-{K}: median {med * 1e3:.1f} ms/user "
          f"({n / med / 1e6:.1f}M items/s, {n_chunks} chunks, host clock, "
          f"peak RSS {peak_rss_mb():.0f} MB)")
    print("top items:", i[0][:5], "scores:", np.round(v[0][:5], 3))


def _main_hier(args, dev) -> None:
    n = int(args.items)
    for backend in ("bitmask", "range"):
        r = run_hier_compare(n, m=args.m, b=args.b, tile=int(args.tile),
                             factor=int(args.factor), repeats=args.repeats,
                             backend=backend, device=dev)
        print(f"[hier/{backend}] N={r['n_items']:,} T={r['n_tiles']} "
              f"S={r['n_super']} bounds {r['flat_bounds']} -> "
              f"{r['hier_bounds']} ({r['bound_reduction']:.1f}x) "
              f"mismatches={r['mismatches']} "
              f"flat {r['flat_s'] * 1e3:.1f} ms / hier "
              f"{r['hier_s'] * 1e3:.1f} ms on {r['device']}, peak RSS "
              f"{r['peak_rss_mb']:.0f} MB")
        if r["mismatches"]:
            raise SystemExit(f"hier/{backend}: exactness violated "
                             f"({r['mismatches']} mismatches)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["stream", "hier"], default="stream")
    ap.add_argument("--items", type=float, default=1e7)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--chunk", type=float, default=1e7)
    ap.add_argument("--tile", type=float, default=1024)
    ap.add_argument("--factor", type=float,
                    default=pruning.DEFAULT_SUPER_FACTOR)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.mode == "hier":
        _main_hier(args, dev)
    else:
        _main_stream(args, dev)


if __name__ == "__main__":
    main()
