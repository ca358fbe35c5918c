"""Timing of the serving fabric on one card, beside the smoke's checks.

Two measurements of full-width ``sasrec-recjpq`` (N=1,271,638, d=512, m=8,
b=512; random weights from seed 0), fused route, B=64, k=10, over the
smoke's 6,400 random histories:

``engine``: the single fused engine of two or more source trees, each in
a process of its own, in turns A, B, B, A (each run serves the histories
three times and reports each round's mRT, p99 and req/s, and the host
time of each batch's prepare, launch and complete), so two
versions of the engine are compared within one call on one card:

  PYTHONPATH=src python -m repro_torch.examples.fabric_timing engine \\
      --tree parent=PATH_TO_OTHER_CHECKOUT --tree change=.

``idle``: the device's idle share while the single engine and
``ReplicaRouter`` fabrics of 1, 2 and 4 replicas serve (hedging off,
closed loops of 128 and 512 requests and of two batches a replica), from a
``torch.profiler`` trace of the device's activity: busy is the union of
every kernel's and copy's interval on any stream, idle share is one less
busy over the span from the first device event to the last.  The req/s
of the traced run is printed beside an untraced run's:

  PYTHONPATH=src python -m repro_torch.examples.fabric_timing idle

Both print the card's name and power limit (``nvidia-smi``) first and one
JSON object last.  Needs a CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

N_REQUESTS, MAX_BATCH, K = 6400, 64, 10
ROUNDS = 3                    # serves of the histories per engine run
REPLICAS = (1, 2, 4)
# Closed-loop windows of the idle runs (as the smoke's scaling lines): two
# batches, two batches a replica, two batches a replica of the largest fleet.
WINDOWS = (2 * MAX_BATCH, 2 * max(REPLICAS) * MAX_BATCH)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def request_stream(n_items, max_seq_len, n=N_REQUESTS, seed=0):
    """``n`` user histories of 2..max_seq_len random items (the smoke's)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, n_items + 1, int(rng.integers(2, max_seq_len + 1)))
            for _ in range(n)]


def model():
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import seqrec
    cfg = get_config("sasrec-recjpq").model
    params = seqrec.init_seqrec(torch.Generator().manual_seed(0), cfg,
                                device=torch.device("cuda"))
    return params, cfg


def serve(engine, histories):
    """Submit in batches of MAX_BATCH and drain each (the launcher's way)."""
    from repro_torch.serving.engine import Request
    for i in range(0, len(histories), MAX_BATCH):
        for j, h in enumerate(histories[i:i + MAX_BATCH], start=i):
            engine.submit(Request(j, h, k=K))
        engine.drain()


PHASES = ("prepare", "launch", "complete")


def serve_rounds():
    """One tree's engine: build, warm both buckets, serve ROUNDS times.
    Each round also reports the median host time of each batch's
    ``prepare`` (padding and the copy to the card), ``launch`` (queueing
    the serve function) and ``complete`` (the wait for the card and the
    results' slicing)."""
    from repro_torch.serving.engine import RetrievalEngine
    params, cfg = model()
    eng = RetrievalEngine.for_seqrec(params, cfg, k=K, max_batch=MAX_BATCH,
                                     method="pqtopk_fused", device="cuda")
    split = {name: [] for name in PHASES}
    for name, times in split.items():
        def timed(*a, _fn=getattr(eng, name), _times=times, **kw):
            t0 = time.perf_counter()
            r = _fn(*a, **kw)
            _times.append(time.perf_counter() - t0)
            return r
        setattr(eng, name, timed)
    hist = request_stream(cfg.n_items, cfg.max_seq_len)
    serve(eng, request_stream(cfg.n_items, cfg.max_seq_len, MAX_BATCH + 1, 1))
    out = []
    for _ in range(ROUNDS):
        eng.latencies_ms.clear()
        for times in split.values():
            times.clear()
        t0 = time.monotonic()
        serve(eng, hist)
        wall = time.monotonic() - t0
        st = eng.stats()
        out.append({"mRT_ms": st["mRT_ms"], "p99_ms": st["p99_ms"],
                    "req_s": len(hist) / wall,
                    **{f"{name}_ms": float(np.median(times)) * 1e3
                       for name, times in split.items()}})
    return out


def engine_ab(trees):
    """Each tree's engine in its own process, in turns A, B, ..., B, A."""
    here = os.path.abspath(__file__)

    def env(path):
        return {**os.environ,
                "PYTHONPATH": os.path.join(os.path.abspath(path), "src")}

    t0 = time.monotonic()                 # build every tree's kernels at once
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels.pqtopk import "
         "kernel; kernel.build()"], env=env(path)) for _, path in trees]
    if any(p.wait() for p in builds):
        raise RuntimeError("a tree's kernels did not build")
    print(f"built {len(trees)} trees in {time.monotonic() - t0:.1f}s")
    order = list(trees) + list(reversed(trees))
    runs = {label: [] for label, _ in trees}
    for label, path in order:
        got = subprocess.run(
            [sys.executable, here, "_serve"],
            env=env(path), capture_output=True, text=True, timeout=600)
        if got.returncode:
            sys.stderr.write(got.stderr)
            raise RuntimeError(f"{label}: the serve run failed")
        rows = json.loads(got.stdout.strip().splitlines()[-1])
        runs[label] += rows
        for r in rows:
            print(f"engine {label}: mRT={r['mRT_ms']:.4f}ms "
                  f"p99={r['p99_ms']:.4f}ms {r['req_s']:.1f} req/s; "
                  "per batch " + " ".join(
                      f"{name}={r[name + '_ms']:.4f}ms" for name in PHASES))
    keys = ["mRT_ms", "p99_ms", "req_s"] + [f"{n}_ms" for n in PHASES]
    summary = {label: {key: float(np.median([r[key] for r in rows]))
                       for key in keys}
               for label, rows in runs.items()}
    for label, s in summary.items():
        print(f"engine {label} median of {len(runs[label])} rounds: "
              + " ".join(f"{key}={s[key]:.4f}" for key in keys))
    return {"engine": summary, "order": [label for label, _ in order]}


def device_busy(prof):
    """(busy ms, span ms) of the trace's device activity: the union of the
    kernels' and copies' intervals over every stream, and the time from
    the first one's start to the last one's end."""
    spans = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1e3
        dur = (e.duration_ns() if hasattr(e, "duration_ns")
               else e.duration_us() * 1e3)
        spans.append((start, start + dur))
    if not spans:
        raise RuntimeError("the trace holds no device activity")
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    first = lo
    last = max(e for _, e in spans)
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    return busy / 1e6, (last - first) / 1e6


def drive(router, histories, window, base):
    """Closed loop: at most ``window`` requests unanswered, request ids
    ``base + j``; wall seconds."""
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
    router.drain(timeout_s=120.0)
    if len(router._done_ids) - done0 != len(histories):
        raise AssertionError("a request went unanswered")
    return time.monotonic() - t0


def idle_share():
    """The engine's and each fabric's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import RetrievalEngine
    from repro_torch.serving.router import ReplicaRouter
    params, cfg = model()
    hist = request_stream(cfg.n_items, cfg.max_seq_len)
    out = {}

    def traced(name, run):
        wall = run(0)                                     # untraced
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced_wall = run(len(hist))
            torch.cuda.synchronize()
        busy, span = device_busy(prof)
        out[name] = {"req_s": len(hist) / wall,
                     "traced_req_s": len(hist) / traced_wall,
                     "device_busy_ms": busy, "span_ms": span,
                     "idle_share": 1.0 - busy / span}
        r = out[name]
        print(f"idle {name}: {r['req_s']:.1f} req/s untraced, "
              f"{r['traced_req_s']:.1f} traced; device busy {busy:.3f} of "
              f"{span:.3f} ms, idle share {r['idle_share']:.4f}")

    eng = RetrievalEngine.for_seqrec(params, cfg, k=K, max_batch=MAX_BATCH,
                                     method="pqtopk_fused", device="cuda")
    serve(eng, request_stream(cfg.n_items, cfg.max_seq_len, MAX_BATCH + 1, 1))

    def engine_run(_base):
        t0 = time.monotonic()
        serve(eng, hist)
        return time.monotonic() - t0

    traced("engine", engine_run)
    for n in REPLICAS:
        for w in sorted(set(WINDOWS) | {2 * n * MAX_BATCH}):
            with ReplicaRouter.for_seqrec(
                    params, cfg, n_replicas=n, hedge=False,
                    degrade_high=1 << 30, k=K, max_batch=MAX_BATCH,
                    method="pqtopk_fused", device="cuda") as router:
                router.warmup()
                traced(f"K={n} window={w}",
                       lambda base: drive(router, hist, w, base))
    return {"idle": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("engine")
    a.add_argument("--tree", action="append", required=True,
                   metavar="LABEL=PATH", help="a checkout of the repo")
    sub.add_parser("idle")
    sub.add_parser("_serve")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fabric_timing: no CUDA device", file=sys.stderr)
        return 1
    if args.cmd == "_serve":
        print(json.dumps(serve_rounds()))
        return 0
    print(f"card: {card_line()}")
    if args.cmd == "engine":
        res = engine_ab([t.split("=", 1) for t in args.tree])
    else:
        res = idle_share()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
