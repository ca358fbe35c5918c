"""Serving example (the paper's deployment mode): batched top-K retrieval
requests through the ``RetrievalEngine`` at Booking.com catalogue scale,
comparing the scoring methods' mRT — a live miniature of Table 3.

  PYTHONPATH=src python -m repro_torch.examples.serve_catalogue \\
      --requests 128 [--device cpu]

With ``--kill-and-recover`` it instead demonstrates the durable catalogue
path: churn a mutable catalogue through a checksummed WAL, tear the writer
mid-append at ``--crash-at``, then stand a new catalogue up from
``CatalogueLog.recover()`` and check that it — and everything served from
it — is bit-identical to an oracle that replayed the durable prefix.
Exits non-zero on any mismatch:

  PYTHONPATH=src python -m repro_torch.examples.serve_catalogue \\
      --kill-and-recover --items 2000 --d-model 64 --requests 16 \\
      --crash-at 11 [--device cpu]

The port's twin of the reference's ``examples/serve_catalogue.py``;
``--device`` defaults to ``cuda``.
"""
import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import PQConfig, SeqRecConfig
from repro_torch.core.mutation import MutableHeadState, apply_op
from repro_torch.models import seqrec
from repro_torch.serving.catalogue_log import CatalogueLog
from repro_torch.serving.engine import Request, RetrievalEngine
from repro_torch.training.fault_tolerance import SimulatedFailure


def _config(args, name):
    return SeqRecConfig(name=name, backbone="sasrec", n_items=args.items,
                        d_model=args.d_model, n_blocks=2, n_heads=8,
                        d_ff=args.d_model, max_seq_len=args.seq_len,
                        pq=PQConfig(m=8, b=256))


def _churn(mstate, rng, n):
    """n random valid ops, applied to ``mstate`` as drawn."""
    ops = []
    for _ in range(n):
        live = np.flatnonzero(mstate.live.cpu().numpy())
        live = live[live > 0]
        row = rng.integers(0, mstate.b, mstate.m, np.int64)
        kind = rng.choice(["insert", "delete", "update"], p=[0.3, 0.35, 0.35])
        if kind == "insert" and not mstate.free \
                and mstate.n_rows >= mstate.cap:
            kind = "delete"
        if kind == "insert":
            op = ("insert", row)
        elif kind == "delete":
            op = ("delete", int(rng.choice(live)))
        else:
            op = ("update", int(rng.choice(live)), row)
        apply_op(mstate, op)
        ops.append(op)
    return ops


def _served(engine, specs):
    for rid, seq in specs:
        engine.submit(Request(rid, seq, k=10))
    return {r.request_id: r for r in engine.drain()}


def kill_and_recover(args, dev):
    """Kill-and-recover demonstration; exits non-zero on parity loss."""
    def fail(msg):
        print(f"FAIL: {msg}")
        sys.exit(1)

    cfg = _config(args, "serve-durable")
    params = seqrec.init_seqrec(torch.Generator().manual_seed(0), cfg,
                                device=dev)
    rng = np.random.default_rng(0)
    specs = [(i, rng.integers(1, args.items + 1, rng.integers(3, 20)))
             for i in range(args.requests)]
    log_dir = args.log_dir or tempfile.mkdtemp(prefix="serve_catalogue_wal_")

    mstate = MutableHeadState.build(params["item_emb"]["codes"], cfg.pq.b,
                                    tile=64, device=dev)
    base = mstate.clone()                   # lsn-0 image for the oracle
    stream = []                             # every op ever handed to append

    # ---- process 1: serve + churn through the WAL, then tear ----------
    log = CatalogueLog(log_dir, fsync_every=4,
                       snapshot_every=args.snapshot_every)
    log.snapshot(mstate)                    # genesis
    eng = RetrievalEngine.for_seqrec_mutable(params, cfg, mstate, k=10,
                                             max_batch=args.max_batch,
                                             calibrate=False, device=dev)
    log.fail_at_lsn = args.crash_at
    torn = False
    try:
        for _ in range(args.batches):
            ops = _churn(mstate.clone(), rng, args.churn)
            for op in ops:
                stream.append(op)
                log.append(op)              # append-before-apply (WAL)
                apply_op(mstate, op)
            eng.swap_head_state(mstate)     # no new serve variant
            log.maybe_snapshot(mstate)
    except SimulatedFailure:
        torn = True
        print(f"writer torn mid-append at lsn {args.crash_at} "
              f"(half a record is on disk)")
    if not torn:
        fail(f"--crash-at {args.crash_at} never fired; raise --batches")
    _served(eng, specs)                     # the old catalogue still serves

    # ---- process 2: recover the durable prefix from the log -----------
    log2 = CatalogueLog(log_dir, fsync_every=4)
    state, lsn = log2.recover(verify=True, device=dev)
    print(f"recovered {log_dir} at lsn {lsn} "
          f"(torn bytes dropped: {log2.torn_bytes_dropped}, "
          f"snapshots: {int(log2.stats()['n_snapshots'])})")
    if lsn != args.crash_at - 1:
        fail(f"recovered lsn {lsn}, expected durable prefix "
             f"{args.crash_at - 1}")

    # the oracle replays exactly the durable prefix from the lsn-0 image
    oracle = base.clone()
    for op in stream[:lsn]:
        apply_op(oracle, op)
    for name in ("codes", "live"):
        if not torch.equal(getattr(state, name), getattr(oracle, name)):
            fail(f"recovered catalogue diverges from oracle on {name!r}")
    if state.free != oracle.free or state.n_rows != oracle.n_rows:
        fail("recovered freelist/occupancy diverges from oracle")

    # and everything SERVED from the recovered state is bit-identical
    rec_eng = RetrievalEngine.for_seqrec_mutable(
        params, cfg, state, k=10, max_batch=args.max_batch,
        ladder=eng.ladder, calibrate=False, device=dev)
    ora_eng = RetrievalEngine.for_seqrec_mutable(
        params, cfg, oracle, k=10, max_batch=args.max_batch,
        ladder=eng.ladder, calibrate=False, device=dev)
    got, want = _served(rec_eng, specs), _served(ora_eng, specs)
    for rid in want:
        if not (np.array_equal(got[rid].items, want[rid].items)
                and np.array_equal(got[rid].scores, want[rid].scores)):
            fail(f"served results diverge on request {rid}")
    # the recovered log is a live writer: commits keep flowing
    log2.append_many(_churn(oracle, rng, 3))
    log2.sync()
    print(f"recovery parity OK: {len(want)} requests bit-identical, "
          f"log continues at lsn {log2.lsn}")
    log2.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=34_742)   # Booking.com
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=50)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--kill-and-recover", action="store_true",
                    help="durable-WAL demo: tear the writer, recover, "
                         "verify bit-parity (exits non-zero on mismatch)")
    ap.add_argument("--log-dir", default=None,
                    help="WAL directory (default: fresh temp dir)")
    ap.add_argument("--crash-at", type=int, default=11,
                    help="LSN whose append tears mid-record")
    ap.add_argument("--churn", type=int, default=4,
                    help="mutation ops per committed batch")
    ap.add_argument("--batches", type=int, default=5,
                    help="churn batches to attempt before/through the tear")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="cut an LSN-keyed snapshot every N committed ops")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.kill_and_recover:
        return kill_and_recover(args, dev)

    cfg = _config(args, "serve-example")
    params = seqrec.init_seqrec(torch.Generator().manual_seed(0), cfg,
                                device=dev)
    rng = np.random.default_rng(0)
    streams = [rng.integers(1, args.items + 1, rng.integers(3, args.seq_len))
               for _ in range(args.requests)]

    for method in ("dense", "recjpq", "pqtopk", "pqtopk_fused"):
        def serve_fn(seqs, k, _method=method):
            return seqrec.serve_topk(params, seqs, cfg, k=k, method=_method)

        engine = RetrievalEngine(serve_fn, seq_len=args.seq_len, k=10,
                                 max_batch=args.max_batch, method=method,
                                 device=dev)
        t0 = time.monotonic()
        for i, s in enumerate(streams):
            engine.submit(Request(i, s, k=10))
        results = engine.drain()
        wall = time.monotonic() - t0
        st = engine.stats()
        print(f"{method:12s} {len(results)} reqs in {wall:6.2f}s "
              f"({len(results) / wall:7.1f} req/s)  mRT={st['mRT_ms']:8.2f}ms "
              f"p99={st['p99_ms']:8.2f}ms on {dev}")


if __name__ == "__main__":
    main()
