#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch``, holds each against
its plain PyTorch version on the card, then serves the full-width
SASRec-RecJPQ model (N=1,271,638 items, d=512, m=8, b=512, uint16 codes;
random weights from a fixed seed) through ``RetrievalEngine`` with the
fused kernel, and checks every batch against the plain ``pqtopk`` route.
Prints the card's name and power limit, kernel and per-method timings, a
JSON line of kernel records, and last ``{"ok": true, "device": ...}``.
Any failed phase raises and exits non-zero; without a CUDA device it exits
non-zero before doing anything.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events),
    after one warm-up run."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def check_kernels(dev):
    """Each kernel against its plain version, bit-exact, on several code
    dtypes and shapes.  Returns the max abs error seen per kernel."""
    import torch
    from repro_torch.kernels.pqtopk import kernel, ops, ref
    err = {"pq_scores": 0.0, "pq_topk_fused": 0.0}
    cases = [(torch.int8, 100_003, 8, 128), (torch.uint8, 100_003, 8, 256),
             (torch.uint16, 100_003, 8, 512), (torch.int32, 100_003, 8, 512),
             (torch.uint8, 4_097, 3, 100), (torch.int32, 50_001, 3, 100),
             (torch.uint16, 1_271_639, 8, 512)]
    for i, (dtype, n, m, b) in enumerate(cases):
        bq = 64 if n > 1_000_000 else 5
        codes, s = pq_inputs(n, m, b, bq, dtype, seed=i, dev=dev)
        got = kernel.pq_scores_cuda(codes, s)
        want = ref.pq_scores(codes, s)
        e = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"pq_scores {dtype} N={n} m={m} b={b}: "
                                 f"max abs err {e}")
        err["pq_scores"] = max(err["pq_scores"], e)
        tile = min(2048, -(-n // 128) * 128)
        nt = ops.n_tiles(n, tile)
        lists = [torch.arange(nt, dtype=torch.int32)]
        if n < 1_000_000:       # sentinels, repeats, the padding tile
            lists.append(torch.tensor([-1, nt - 1, 0, -1, nt, 0, -1],
                                      dtype=torch.int32))
        for idx in lists:
            for k in (1, 16, 100):
                idx_d = idx.to(dev)
                gv, gi = kernel.pq_topk_fused_cuda(codes, s, k, idx_d,
                                                   n_items=n, tile=tile)
                wv, wi = ref.pq_topk_slots(codes, s, k, idx_d, n_items=n,
                                           tile=tile)
                both = torch.isfinite(gv) & torch.isfinite(wv)
                e = torch.where(both, gv - wv, 0.0).abs().max().item()
                err["pq_topk_fused"] = max(err["pq_topk_fused"], e)
                if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
                    bad = gv != wv
                    raise AssertionError(
                        f"pq_topk_fused {dtype} N={n} m={m} b={b} k={k}: "
                        f"{int(bad.sum())} values and "
                        f"{int((gi != wi).sum())} ids differ")
        fv, fi = ops.pq_topk(codes, s, 10)
        if fi[0, :3].tolist() != [3, n // 2, n - 1]:
            raise AssertionError(f"tie order {fi[0, :3].tolist()}")
        torch.cuda.synchronize()
        print(f"kernel check: {dtype} N={n} m={m} b={b} B={bq}: bit-exact")
    return err


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


def main() -> int:
    import torch
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
    from repro_torch.serving.engine import RetrievalEngine

    dev = torch.device("cuda")
    t_start = time.monotonic()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    lib = kernel.build()
    print(f"build: {time.monotonic() - t0:.1f}s -> "
          f"{os.path.relpath(lib, ROOT)}")
    entry = ""
    for line in (kernel.BUILD_DIR / "ptxas.log").read_text().splitlines():
        if "Compiling entry" in line:
            entry = line
        elif "registers" in line and "ItLi8E" in entry:   # uint16, m=8
            name = "pq_scores" if "pq_scores" in entry else "pq_topk_fused"
            print(f"ptxas {name}<uint16, m=8>: {line.split(':', 1)[1].strip()}")

    max_err = check_kernels(dev)

    # ---- full-width model, served through the engine ----------------
    cfg = get_config("sasrec-recjpq").model
    t0 = time.monotonic()
    params = seqrec.init_seqrec(torch.Generator().manual_seed(0), cfg,
                                device=dev)
    torch.cuda.synchronize()
    print(f"init: {cfg.name} N={cfg.n_items} d={cfg.d_model} m={cfg.pq.m} "
          f"b={cfg.pq.b} codes={params['item_emb']['codes'].dtype} in "
          f"{time.monotonic() - t0:.1f}s")
    engines = {m: RetrievalEngine.for_seqrec(params, cfg, k=K,
                                             max_batch=MAX_BATCH, method=m,
                                             device=dev)
               for m in ("pqtopk_fused", "pqtopk_kernel", "pqtopk")}
    for eng in engines.values():                 # warm both buckets
        serve(eng, request_stream(cfg, MAX_BATCH + 1, seed=1))
        eng.latencies_ms.clear()

    # Each path is served with the counts at 0 and read just after; each
    # must launch its own kernel once per batch and the other not at all.
    n_batches = -(-N_REQUESTS // MAX_BATCH)
    outs, launches = {}, {}
    for method, own in (("pqtopk_fused", "pq_topk_fused"),
                        ("pqtopk_kernel", "pq_scores"), ("pqtopk", None)):
        kernel.pq_scores_cuda.launches = 0
        kernel.pq_topk_fused_cuda.launches = 0
        outs[method] = serve(engines[method], request_stream(cfg))
        got = {"pq_topk_fused": kernel.pq_topk_fused_cuda.launches,
               "pq_scores": kernel.pq_scores_cuda.launches}
        want = {name: n_batches if name == own else 0 for name in got}
        print(f"path {method}: launches {got}")
        if got != want:
            raise AssertionError(f"path {method} launched {got}, expected "
                                 f"{want}")
        if own:
            launches[own] = got[own]
    out_fused, out_kern, out_plain = (outs[m] for m in (
        "pqtopk_fused", "pqtopk_kernel", "pqtopk"))
    for rid, want in out_plain.items():
        for name, out in (("pqtopk_fused", out_fused),
                          ("pqtopk_kernel", out_kern)):
            got = out[rid]
            if got.shed or not (np.array_equal(got.items, want.items)
                                and np.array_equal(got.scores,
                                                   want.scores)):
                raise AssertionError(f"{name} request {rid} differs from "
                                     "pqtopk")
        if want.items.shape != (K,) or not np.all(np.isfinite(want.scores)) \
                or want.items.min() < 0 or want.items.max() > cfg.n_items:
            raise AssertionError(f"request {rid}: bad result {want}")
    for name, eng in engines.items():
        st = eng.stats()
        print(f"engine {name}: served {int(st['count'])} mRT="
              f"{st['mRT_ms']:.3f}ms p99={st['p99_ms']:.3f}ms "
              f"n_compiles={int(st['n_compiles'])} shed={int(st['shed'])}")
    print(f"engine: {N_REQUESTS} requests in {n_batches} batches, every "
          "batch of pqtopk_fused and pqtopk_kernel bit-identical to pqtopk; "
          "p99 is near the slowest batch (a request's latency is its "
          "batch's)")

    # ---- every flat method once, on one full batch -------------------
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
        for method in ("pqtopk", "pqtopk_kernel", "pqtopk_fused", "recjpq",
                       "pqtopk_onehot", "dense", "pqtopk_approx"):
            fn = lambda: retrieval_head.top_items(head, phi, K, method=method)
            results[method] = fn()
            method_ms[method] = time_ms(fn, 3)
            print(f"method {method}: scoring+top-k {method_ms[method]:.3f}ms")
        ev, ei = results["pqtopk"]
        for method in ("pqtopk_kernel", "pqtopk_fused"):
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
        print("methods: pqtopk, pqtopk_kernel, pqtopk_fused bit-identical; "
              "recjpq, pqtopk_onehot, dense within rtol=atol=1e-5")

        # ---- kernel timings at the main path's shapes ----------------
        codes = head["codes"]
        s = scoring.subid_scores(head["sub_emb"], phi).contiguous()
        n, m = codes.shape
        bq, _, b = s.shape
        tile = min(2048, -(-n // 128) * 128)
        idx = torch.arange(ops.n_tiles(n, tile), dtype=torch.int32,
                           device=dev)
        code_b = codes.element_size()
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        recs = []
        scores_ms = time_ms(lambda: kernel.pq_scores_cuda(codes, s), 20)
        scores_plain = time_ms(lambda: ref.pq_scores(codes, s), 5)
        # One library call computing the same sums: embedding_bag over the
        # flattened (m*b, B) table, split k offset by k*b.
        flat = widen(codes) + torch.arange(m, device=dev) * b
        table = s.permute(1, 2, 0).reshape(m * b, bq).contiguous()
        emb_ms = time_ms(lambda: torch.nn.functional.embedding_bag(
            flat, table, mode="sum"), 20)
        bnd, by, terms = bound_ms(
            n * m * code_b + bq * m * b * 4 + bq * n * 4, bq * n * (m - 1),
            bq * n * m, n_sms)
        print(f"bound pq_scores: {terms} ms on {n_sms} SMs")
        recs.append({
            "name": "pq_scores", "route": "cuda",
            "source": "src/repro_torch/kernels/pqtopk/csrc/pqtopk.cu",
            "replaces": "src/repro/kernels/pqtopk/kernel.py:100",
            "launches": launches["pq_scores"],
            "max_abs_err": max_err["pq_scores"], "ms": scores_ms,
            "plain_ms": scores_plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": emb_ms})
        topk_ms = time_ms(lambda: kernel.pq_topk_fused_cuda(
            codes, s, 16, idx, n_items=n, tile=tile), 20)
        topk_plain = time_ms(lambda: ref.pq_topk_slots(
            codes, s, 16, idx, n_items=n, tile=tile), 3)
        n_slots = idx.numel()
        bnd, by, terms = bound_ms(
            n * m * code_b + bq * m * b * 4 + n_slots * 4
            + bq * n_slots * 16 * 8, bq * n * (m - 1), bq * n * m, n_sms)
        print(f"bound pq_topk_fused: {terms} ms on {n_sms} SMs")
        recs.append({
            "name": "pq_topk_fused", "route": "cuda",
            "source": "src/repro_torch/kernels/pqtopk/csrc/pqtopk.cu",
            "replaces": "src/repro/kernels/pqtopk/kernel.py:145",
            "launches": launches["pq_topk_fused"],
            "max_abs_err": max_err["pq_topk_fused"], "ms": topk_ms,
            "plain_ms": topk_plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": None})
    for r in recs:
        print(f"kernel {r['name']}: {r['ms']:.4f}ms plain {r['plain_ms']:.4f}"
              f"ms bound {r['bound_ms']:.4f}ms ({r['bound_by']}) library "
              f"{r['library_ms']} launches {r['launches']} at N={n} B={bq} "
              f"m={m} b={b} on {card}")
    print(f"total: {time.monotonic() - t_start:.1f}s")
    print(json.dumps({"kernels": recs}))
    print(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
