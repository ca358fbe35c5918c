"""Durable versioned mutation through the port's replicated fabric, on the
CPU, mirroring ``tests/test_router_durable.py``, and against the JAX
reference's router:

* the same op stream through both packages' routers writes the same WAL
  and meta bytes and snapshots of the same arrays, and each package
  recovers the other's log to the same catalogue (atol=0);
* ``apply_mutations`` is WAL-first, replicas converge on the writer's
  state bit for bit, propagation adds no serve variant, and every Result
  carries its replica's applied LSN;
* results served past the staleness budget are tagged, never silently
  stale; a crashed replica recovers from the log and is re-admitted only
  after it has caught up; after a torn writer crash a new router recovers
  the durable prefix;
* the serve launcher's ``--replicas --mutable --crash-replica-at`` prints
  the reference's lines and writes its WAL, and the example's
  ``--kill-and-recover`` exits 0.

Every router is used as a context manager and every wait is bounded."""
import json
import os
import re
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import mutation as jmutation
from repro.launch import serve as jserve
from repro.models import seqrec as jseqrec
from repro.serving import catalogue_log as jlog
from repro.serving import router as jrouter
from repro_torch.configs.base import get_reduced
from repro_torch.core.mutation import apply_op
from repro_torch.core.pruning import ARRAY_FIELDS
from repro_torch.examples import serve_catalogue
from repro_torch.interop import mutable_state_from_jax, params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.serving.catalogue_log import CatalogueLog
from repro_torch.serving.engine import Request, RetrievalEngine
from repro_torch.serving.router import ReplicaRouter
from repro_torch.training.fault_tolerance import SimulatedFailure

JCFG = jget_reduced("sasrec-recjpq").model
CFG = get_reduced("sasrec-recjpq").model
K = 5


@pytest.fixture(scope="module")
def jparams():
    return jseqrec.init_seqrec(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _jstate(jparams):
    return jmutation.MutableHeadState.build(jparams["item_emb"]["codes"],
                                            JCFG.pq.b, tile=64)


def _mk_state(jparams):
    return mutable_state_from_jax(_jstate(jparams))


def _gen_ops(shadow, rng, n=10):
    """n random valid ops, applied to ``shadow`` as they are drawn (the
    caller's oracle of what the fleet should converge to)."""
    ops = []
    for _ in range(n):
        live = np.flatnonzero(shadow.live.numpy())
        live = live[live > 0]
        kind = rng.choice(["insert", "delete", "update"], p=[0.3, 0.35, 0.35])
        row = np.asarray(rng.integers(0, shadow.b, shadow.m, np.int64),
                         shadow.codes.numpy().dtype)
        if kind == "insert" and not shadow.free \
                and shadow.n_rows >= shadow.cap:
            kind = "delete"
        if kind == "insert":
            op = ("insert", row)
        elif kind == "delete":
            op = ("delete", int(rng.choice(live)))
        else:
            op = ("update", int(rng.choice(live)), row)
        apply_op(shadow, op)
        ops.append(op)
    return ops


def _specs(n, base=0, seed=0):
    rng = np.random.default_rng(seed)
    return [(base + i, rng.integers(1, CFG.n_items + 1, 8)) for i in range(n)]


def _serve(router, n, base=0, seed=9):
    for rid_, seq in _specs(n, base=base, seed=seed):
        router.submit(Request(rid_, seq, k=K))
    return router.drain(timeout_s=60.0)


def _wait(cond, timeout_s=30.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout_s:
            return False
        time.sleep(0.01)
    return True


def _caught_up(router):
    return lambda: all(
        rep["lag"] == 0 for rep in router.stats()["replicas"].values())


def _assert_same_state(got, want):
    """Two port states: the same catalogue, bookkeeping and metadata."""
    assert torch.equal(got.codes, want.codes)
    assert torch.equal(got.live, want.live)
    assert got.free == want.free and got.n_rows == want.n_rows
    for f in ARRAY_FIELDS:
        g, w = getattr(got.state, f), getattr(want.state, f)
        assert (g is None) == (w is None), f
        assert g is None or torch.equal(g, w), f


def _oracle(params, shadow, ladder):
    return RetrievalEngine.for_seqrec_mutable(
        params, CFG, shadow, k=K, max_batch=8, ladder=ladder,
        calibrate=False, device="cpu")


# ---- the two packages' logs ------------------------------------------------

@pytest.fixture(scope="module")
def logs(jparams, params, tmp_path_factory):
    """One op stream through the reference's router and the port's, each
    logging to its own directory -> (shadow, reference dir, port dir, port
    replica states after catch-up)."""
    root = tmp_path_factory.mktemp("logs")
    jdir, tdir = str(root / "reference"), str(root / "port")
    tstate = _mk_state(jparams)
    shadow = tstate.clone()
    rng = np.random.default_rng(0)
    kw = dict(n_replicas=2, k=K, max_batch=8, calibrate=False, hedge=False)
    with jrouter.ReplicaRouter.for_seqrec_mutable(
            jparams, JCFG, _jstate(jparams),
            log=jlog.CatalogueLog(jdir, fsync_every=4, snapshot_every=16),
            **kw) as jr, \
            ReplicaRouter.for_seqrec_mutable(
                params, CFG, tstate, device="cpu",
                log=CatalogueLog(tdir, fsync_every=4, snapshot_every=16),
                **kw) as tr:
        for _ in range(5):
            ops = _gen_ops(shadow, rng, 10)
            assert jr.apply_mutations(ops) == tr.apply_mutations(ops)
        assert _wait(_caught_up(jr)) and _wait(_caught_up(tr))
        jr.log.close()
        tr.log.close()
        states = [tr._replica_states[r].clone() for r in range(2)]
        assert tr.stats()["committed_lsn"] == 50.0
    return shadow, jdir, tdir, states


def test_same_op_stream_writes_identical_log_files(logs):
    """The WAL and meta are byte-identical; the snapshots hold the same
    steps and the same arrays, byte for byte (an archive's bytes also
    carry its write time, so the arrays are compared, not the zip)."""
    shadow, jdir, tdir, states = logs
    for name in ("wal.log", "meta.json"):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    snaps = sorted(os.listdir(os.path.join(jdir, "snapshots")))
    assert snaps == sorted(os.listdir(os.path.join(tdir, "snapshots")))
    assert len(snaps) == 3                    # lsn 0 (genesis), 20, 40
    for step in snaps:
        paths = [os.path.join(d, "snapshots", step) for d in (jdir, tdir)]
        groups = []
        for p in paths:
            with open(os.path.join(p, "manifest.json")) as f:
                groups.append(json.load(f)["groups"])
        assert groups[0] == groups[1]
        with np.load(os.path.join(paths[0], "catalogue.npz")) as a, \
                np.load(os.path.join(paths[1], "catalogue.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes(), (step, key)
    # Every replica converged on the writer's catalogue, bit for bit.
    for st in states:
        _assert_same_state(st, shadow)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_recovers_the_others_log(logs, writer):
    shadow, jdir, tdir, _ = logs
    log_dir = jdir if writer == "reference" else tdir
    t, lsn = CatalogueLog(log_dir, read_only=True).recover(device="cpu")
    j, jlsn = jlog.CatalogueLog(log_dir, read_only=True).recover()
    assert lsn == jlsn == 50
    for got in (t, mutable_state_from_jax(j)):
        assert torch.equal(got.codes, shadow.codes)
        assert torch.equal(got.live, shadow.live)
        assert got.free == shadow.free and got.n_rows == shadow.n_rows
    _assert_same_state(t, mutable_state_from_jax(j))


# ---- behaviour, mirroring tests/test_router_durable.py ---------------------

def test_mutations_propagate_zero_new_variants_and_watermarks(
        jparams, params, tmp_path):
    log = CatalogueLog(str(tmp_path), fsync_every=4)
    mstate = _mk_state(jparams)
    shadow = mstate.clone()
    rng = np.random.default_rng(0)
    with ReplicaRouter.for_seqrec_mutable(
            params, CFG, mstate, n_replicas=2, k=K, max_batch=8,
            calibrate=False, log=log, hedge=False, device="cpu") as router:
        router.warmup()
        r0 = _serve(router, 16, base=0, seed=0)
        assert all(r.lsn == 0 for r in r0)          # pre-mutation watermark
        compiles0 = [rep["n_compiles"]
                     for rep in router.stats()["replicas"].values()]
        ops = _gen_ops(shadow, rng, n=12)
        deleted = [op[1] for op in ops if op[0] == "delete"]
        assert router.apply_mutations(ops) == 12
        assert _wait(_caught_up(router)), "replicas never caught up"
        r1 = _serve(router, 16, base=100, seed=1)
        st = router.stats()
        assert [rep["n_compiles"]
                for rep in st["replicas"].values()] == compiles0
        assert st["committed_lsn"] == 12.0 and st["stale_served"] == 0.0
        assert st["log"]["lsn"] == 12.0
        for r in r1:
            assert r.lsn == 12 and not r.degraded and not r.shed
            assert not np.isin(r.items, deleted).any()
        oracle = _oracle(params, shadow, router.engines[0].ladder)
        for rid_, seq in _specs(16, base=100, seed=1):
            oracle.submit(Request(rid_, seq, k=K))
        want = {r.request_id: r for r in oracle.drain()}
        for r in r1:
            np.testing.assert_array_equal(r.items, want[r.request_id].items)
            np.testing.assert_array_equal(r.scores,
                                          want[r.request_id].scores)


def test_stale_tagging_and_immutable_guards(jparams, params):
    mstate = _mk_state(jparams)
    shadow = mstate.clone()
    rng = np.random.default_rng(1)
    with ReplicaRouter.for_seqrec_mutable(
            params, CFG, mstate, n_replicas=1, k=K, max_batch=8,
            calibrate=False, staleness_budget=2, device="cpu") as router:
        router.warmup()
        with pytest.raises(ValueError):
            router.apply_mutations([("delete", 0)])   # padding row
        assert router.stats()["committed_lsn"] == 0.0
        router.pause_mutations(0)
        router.apply_mutations(_gen_ops(shadow, rng, n=5))
        stale = _serve(router, 8, base=0, seed=2)
        assert router.stats()["stale_served"] >= 1.0
        for r in stale:                    # lag 5 > budget 2: all tagged
            assert r.degraded == "stale_catalogue" and r.lsn == 0
            assert not r.shed and r.items.shape == (K,)
        router.resume_mutations(0)
        assert _wait(_caught_up(router))
        for r in _serve(router, 8, base=100, seed=3):
            assert r.lsn == 5 and not r.degraded
    with ReplicaRouter.for_seqrec(params, CFG, n_replicas=1, k=K,
                                  max_batch=8, method="pqtopk_pruned",
                                  calibrate=False, device="cpu") as plain:
        with pytest.raises(ValueError, match="immutable"):
            plain.apply_mutations([("delete", 1)])
        with pytest.raises(ValueError, match="mutable fabric"):
            plain.crash_replica(0)
        assert all(r.lsn == -1 for r in _serve(plain, 4))
    with pytest.raises(ValueError, match="its own"):
        ReplicaRouter([RetrievalEngine(lambda s, k: None, seq_len=4,
                                       device="cpu")] * 2,
                      replica_states=[mstate, mstate])


def test_crash_replica_recovers_with_gated_readmission(jparams, params,
                                                       tmp_path):
    log = CatalogueLog(str(tmp_path), fsync_every=4)
    mstate = _mk_state(jparams)
    shadow = mstate.clone()
    rng = np.random.default_rng(2)
    with ReplicaRouter.for_seqrec_mutable(
            params, CFG, mstate, n_replicas=2, k=K, max_batch=8,
            calibrate=False, log=log, hedge=False, eject_after=1,
            cooldown_ms=20.0, device="cpu") as router:
        router.warmup()
        router.apply_mutations(_gen_ops(shadow, rng, n=6))
        assert _wait(_caught_up(router))
        all_results = list(_serve(router, 16, base=0))
        # Crash replica 1 and freeze its catch-up: probes answer but the
        # health FSM refuses re-admission while recovery is pending.
        router.pause_mutations(1)
        router.crash_replica(1)
        router.apply_mutations(_gen_ops(shadow, rng, n=4))
        base = 1000
        for _ in range(6):
            all_results += _serve(router, 8, base=base, seed=base)
            base += 8
        assert router.replicas[1].readmissions == 0, \
            "re-admitted before catching up"
        router.resume_mutations(1)
        while router.replicas[1].readmissions == 0:
            all_results += _serve(router, 8, base=base, seed=base)
            base += 8
            assert base < 3000, "replica 1 never re-admitted"
        st = router.stats()
        assert st["catchup_events"] >= 1.0 and len(router.recovery_ms) >= 1
        assert st["replicas"][1]["lag"] == 0
        assert st["replicas"][1]["applied_lsn"] == 10
        assert router.readmit_ms and router.readmit_ms[-1][0] == 1 \
            and router.readmit_ms[-1][1] > 0
        seen = sorted(r.request_id for r in all_results)
        assert seen == sorted(router._expected)
        # The recovered replica's catalogue is the writer's, bit for bit
        # (genesis snapshot + the whole log replayed in order).
        _assert_same_state(router._replica_states[1], shadow)
        oracle = _oracle(params, shadow, router.engines[0].ladder)
        specs = _specs(16, base=9000, seed=7)
        for rid_, seq in specs:
            router.submit(Request(rid_, seq, k=K))
            oracle.submit(Request(rid_, seq, k=K))
        got = {r.request_id: r for r in router.drain(timeout_s=60.0)}
        want = {r.request_id: r for r in oracle.drain()}
        for i in got:
            if got[i].degraded or got[i].shed:
                continue
            np.testing.assert_array_equal(got[i].items, want[i].items)
            np.testing.assert_array_equal(got[i].scores, want[i].scores)


def test_writer_torn_crash_and_full_router_recovery(jparams, params,
                                                    tmp_path):
    log = CatalogueLog(str(tmp_path), fsync_every=4)
    mstate = _mk_state(jparams)
    shadow = mstate.clone()            # tracks the DURABLE prefix only
    rng = np.random.default_rng(3)
    with ReplicaRouter.for_seqrec_mutable(
            params, CFG, mstate, n_replicas=2, k=K, max_batch=8,
            calibrate=False, log=log, hedge=False, device="cpu") as router:
        ladder = router.engines[0].ladder
        router.apply_mutations(_gen_ops(shadow, rng, n=6))
        batch2 = _gen_ops(shadow.clone(), rng, n=5)   # NOT applied to shadow
        log.fail_at_lsn = 9            # third op of batch2 tears
        with pytest.raises(SimulatedFailure, match="mid-append"):
            router.apply_mutations(batch2)
        for op in batch2[:2]:
            apply_op(shadow, op)
        assert _wait(_caught_up(router))
        assert all(r.lsn == 8 for r in _serve(router, 8))
        with pytest.raises(RuntimeError, match="crashed"):
            router.apply_mutations([("delete", 1)])

    log2 = CatalogueLog(str(tmp_path), fsync_every=4)
    assert log2.torn_bytes_dropped > 0
    state, lsn = log2.recover(verify=True, device="cpu")
    assert lsn == 8
    assert torch.equal(state.codes, shadow.codes)
    assert torch.equal(state.live, shadow.live)
    assert state.free == shadow.free and state.n_rows == shadow.n_rows
    with ReplicaRouter.for_seqrec_mutable(
            params, CFG, state, n_replicas=2, k=K, max_batch=8,
            calibrate=False, ladder=ladder, log=log2, hedge=False,
            device="cpu") as router2:
        assert router2.stats()["committed_lsn"] == 8.0
        oracle = _oracle(params, shadow, ladder)
        specs = _specs(16, base=0, seed=11)
        for rid_, seq in specs:
            router2.submit(Request(rid_, seq, k=K))
            oracle.submit(Request(rid_, seq, k=K))
        got = {r.request_id: r for r in router2.drain(timeout_s=60.0)}
        want = {r.request_id: r for r in oracle.drain()}
        assert set(got) == set(want)
        for i in got:
            assert got[i].lsn == 8
            np.testing.assert_array_equal(got[i].items, want[i].items)
            np.testing.assert_array_equal(got[i].scores, want[i].scores)
        assert router2.apply_mutations(_gen_ops(shadow, rng, n=3)) == 11
        assert _wait(_caught_up(router2))
        assert all(r.lsn == 11 for r in _serve(router2, 8, base=100))


# ---- the serve launcher and the example -----------------------------------

def _line_keys(out):
    return [re.findall(r"([\w\[\]]+)=", line) for line in out.splitlines()
            if "=" in line]


def test_serve_cli_replicated_mutable_matches_reference(tmp_path, capsys):
    flags = ["--reduced", "--replicas", "2", "--mutable", "--churn-steps",
             "4", "--max-batch", "8", "--requests", "32",
             "--crash-replica-at", "1:5"]
    results = tserve.main(flags + ["--device", "cpu", "--log-dir",
                                   str(tmp_path / "t")])
    out = capsys.readouterr().out
    assert sorted(r.request_id for r in results) == list(range(32))
    assert "chaos: crashing replica 1 at lsn 8" in out
    assert "replicas=2 mutable=True durable=True" in out
    assert "catchup_events=1" in out and "log: lsn=16 " in out
    jserve.main(flags + ["--log-dir", str(tmp_path / "j")])
    jout = capsys.readouterr().out
    assert _line_keys(out) == _line_keys(jout)

    def summary(text):
        # The log line's fsync count depends on whether replica 1's
        # recovery synced before or after the last appends, and the
        # reference's byte count on a race in its sync (an append during
        # a worker's fsync is left unflushed until close): neither is
        # compared across packages.  The port's bytes are its file's.
        return [re.sub(r" (bytes|fsyncs)=\d+", "", ln)
                for ln in text.splitlines()
                if ln.startswith(("chaos", "log"))]
    assert summary(out) == summary(jout)
    port_bytes, fsyncs = map(int, re.search(
        r"^log: .* bytes=(\d+) fsyncs=(\d+)", out, re.M).groups())
    assert port_bytes == os.path.getsize(tmp_path / "t" / "wal.log")
    assert fsyncs in (1, 2)
    for name in ("wal.log", "meta.json"):
        with open(tmp_path / "t" / name, "rb") as a, \
                open(tmp_path / "j" / name, "rb") as b:
            assert a.read() == b.read(), name


def test_example_kill_and_recover_exits_zero(tmp_path, capsys):
    serve_catalogue.main(["--kill-and-recover", "--items", "2000",
                          "--d-model", "64", "--requests", "16",
                          "--crash-at", "11", "--device", "cpu",
                          "--log-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "recovered" in out and "at lsn 10" in out
    assert "recovery parity OK: 16 requests bit-identical" in out
    with pytest.raises(SystemExit) as exc:       # the tear never fires
        serve_catalogue.main(["--kill-and-recover", "--items", "2000",
                              "--d-model", "64", "--requests", "4",
                              "--crash-at", "999", "--device", "cpu",
                              "--log-dir", str(tmp_path / "again")])
    assert exc.value.code == 1 and "never fired" in capsys.readouterr().out
