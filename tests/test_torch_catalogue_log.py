"""The port's durable catalogue (``repro_torch.serving.catalogue_log`` and
``repro_torch.training.checkpoint``) against the JAX reference.

The write-ahead log and the snapshots are byte-compatible: a log written by
either package recovers in the other, bit for bit.  Also torn-tail
truncation, the fallback past a corrupt snapshot, the named error with no
snapshot, and the ``--mutable`` serve launcher on the CPU."""
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mutation as jm
from repro.launch import serve as jserve
from repro.serving import catalogue_log as jlog
from repro_torch.core import mutation as tm
from repro_torch.interop import mutable_state_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.serving import catalogue_log as tlog
from repro_torch.training.checkpoint import CorruptCheckpointError
from repro_torch.training.fault_tolerance import SimulatedFailure

M, B_SUB, TILE = 8, 512, 64
N0 = 500                       # capacity 512 = 8 tiles


def _codes(seed=0):
    return np.random.default_rng(seed).integers(0, B_SUB, (N0, M)).astype(
        np.uint16)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _assert_same(t, j):
    """A port state ``t`` against a reference state ``j``: the same
    catalogue, freelist, high-water mark and pruning metadata."""
    _eq(t.codes.numpy(), j.codes)
    _eq(t.live.numpy(), j.live)
    assert t.free == [int(x) for x in j.free] and t.n_rows == j.n_rows
    for g, w in zip(t.state.meta_arrays(),
                    mutable_state_from_jax(j).state.meta_arrays()):
        assert torch.equal(g, w)


def test_ops_encode_to_the_reference_bytes():
    row = np.array([0, 1, 511, 300, 7, 8, 9, 10])
    for op in (("insert", row), ("delete", 12345), ("update", 7, row)):
        assert tlog.encode_op(op) == jlog.encode_op(op)
        got, want = tlog.decode_op(tlog.encode_op(op)), jlog.decode_op(
            jlog.encode_op(op))
        assert got[0] == want[0] and str(got[1:]) == str(want[1:])
    with pytest.raises(ValueError, match="op kind"):
        tlog.encode_op(("rename", 1))


@pytest.mark.parametrize("backend", ["bitmask", "range"])
def test_reference_log_recovers_in_the_port(tmp_path, backend):
    j = jm.MutableHeadState.build(jnp.asarray(_codes(1)), B_SUB, TILE,
                                  backend=backend)
    rng = np.random.default_rng(2)
    with jlog.CatalogueLog(str(tmp_path), snapshot_every=40) as log:
        log.snapshot(j)
        for _ in range(12):
            log.append_many(jserve._churn_ops(j, rng, 8, B_SUB))
            log.maybe_snapshot(j)
        lsn = log.lsn
    reader = tlog.CatalogueLog(str(tmp_path), read_only=True)
    assert reader.lsn == lsn == 96 and reader.latest_snapshot_lsn() == 80
    t, got_lsn = reader.recover(device="cpu", verify=True)
    assert got_lsn == lsn
    j.retighten()                         # verify=True retightened t
    _assert_same(t, j)
    # Point-in-time recovery to an older LSN replays up to it exactly.
    t50, at = reader.recover(upto=50, device="cpu")
    j50, jat = jlog.CatalogueLog(str(tmp_path), read_only=True).recover(
        upto=50)
    assert at == jat == 50
    _assert_same(t50, j50)                # the same replay, stale tiles too


@pytest.mark.parametrize("backend", ["bitmask", "range"])
def test_port_log_recovers_in_the_reference(tmp_path, backend):
    t = tm.MutableHeadState.build(torch.from_numpy(_codes(3)), B_SUB, TILE,
                                  backend=backend)
    shadow = t.clone()
    rng = np.random.default_rng(4)
    with tlog.CatalogueLog(str(tmp_path), snapshot_every=30) as log:
        log.snapshot(t)
        for _ in range(10):
            ops = tserve._churn_ops(shadow, rng, 8, B_SUB)
            log.append_many(ops)
            for op in ops:
                tm.apply_op(t, op)
            log.maybe_snapshot(t)
        st = log.stats()
    assert st["lsn"] == 80.0 and st["n_snapshots"] == 3.0
    j, lsn = jlog.CatalogueLog(str(tmp_path), read_only=True).recover(
        verify=True)
    assert lsn == 80
    _assert_same(tlog.CatalogueLog(str(tmp_path)).recover(
        device="cpu", verify=True)[0], j)
    _eq(t.codes.numpy(), j.codes)
    _eq(t.live.numpy(), j.live)
    assert t.free == [int(x) for x in j.free]


@pytest.mark.parametrize("backend", ["bitmask", "range"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_super_factor_log_recovers_in_the_other_package(tmp_path, writer,
                                                        backend):
    """A catalogue with a super level (factor 4: capacity 512 = 2 supers of
    4 tiles), logged by one package and recovered by the other: the meta
    carries the factor, and the recovered state matches at both levels."""
    rng = np.random.default_rng(12)
    if writer == "reference":
        w = jm.MutableHeadState.build(jnp.asarray(_codes(11)), B_SUB, TILE,
                                      backend=backend, super_factor=4)
        log_mod, churn = jlog, jserve._churn_ops
    else:
        w = tm.MutableHeadState.build(torch.from_numpy(_codes(11)), B_SUB,
                                      TILE, backend=backend, super_factor=4)
        log_mod, churn = tlog, tserve._churn_ops
    with log_mod.CatalogueLog(str(tmp_path), snapshot_every=24) as log:
        log.snapshot(w)
        for _ in range(8):
            log.append_many(churn(w, rng, 6, B_SUB))
            log.maybe_snapshot(w)
    assert tlog.CatalogueLog(str(tmp_path), read_only=True).meta()[
        "super_factor"] == 4
    t, lsn = tlog.CatalogueLog(str(tmp_path), read_only=True).recover(
        device="cpu", verify=True)
    j, jlsn = jlog.CatalogueLog(str(tmp_path), read_only=True).recover(
        verify=True)
    assert lsn == jlsn == 48 and t.super_factor == j.super_factor == 4
    assert t.state.n_super == j.state.n_super == 2
    _assert_same(t, j)
    want = mutable_state_from_jax(j).state
    for f in ("super_packed", "super_lo", "super_hi"):
        got, exp = getattr(t.state, f), getattr(want, f)
        assert (got is None) == (exp is None), f
        if got is not None:
            assert torch.equal(got, exp), f
    _eq(t.codes.numpy(), np.asarray(w.codes))
    _eq(t.live.numpy(), np.asarray(w.live))


def test_torn_tail_is_cut_and_recovery_stops_before_it(tmp_path):
    t = tm.MutableHeadState.build(torch.from_numpy(_codes(5)), B_SUB, TILE)
    log = tlog.CatalogueLog(str(tmp_path), fsync_every=4)
    log.snapshot(t)
    log.fail_at_lsn = 11                  # the third of the 4-op batches
    rng = np.random.default_rng(6)
    with pytest.raises(SimulatedFailure, match="lsn 11"):
        for _ in range(4):
            before = t.clone()
            ops = tserve._churn_ops(t, rng, 4, B_SUB)
            log.append_many(ops)
    with pytest.raises(RuntimeError, match="crashed"):
        log.append(("delete", 1))
    size = os.path.getsize(log.path)
    # A reader stops at the tear without cutting it; a writer cuts it.
    assert tlog.CatalogueLog(str(tmp_path), read_only=True).lsn == 10
    assert os.path.getsize(log.path) == size
    writer = tlog.CatalogueLog(str(tmp_path))
    assert writer.lsn == 10 and writer.torn_bytes_dropped > 0
    assert os.path.getsize(log.path) == size - writer.torn_bytes_dropped
    assert jlog.CatalogueLog(str(tmp_path), read_only=True).lsn == 10
    got, lsn = writer.recover(device="cpu", verify=True)
    for op in ops[:2]:                    # LSNs 9 and 10 made it to disk
        tm.apply_op(before, op)
    assert lsn == 10
    assert torch.equal(got.codes, before.codes) and got.free == before.free
    assert torch.equal(got.live, before.live)
    assert writer.append(("delete", int(torch.nonzero(got.live)[1, 0]))) \
        == 11


def test_append_during_another_threads_sync_is_flushed_by_the_next(
        tmp_path, monkeypatch):
    """The replicated fabric syncs from a worker thread while the caller
    appends.  An append that lands while that sync is in its fsync must
    still count as unsynced, so the next sync puts it on disk."""
    log = tlog.CatalogueLog(str(tmp_path))
    log.append(("delete", 1))
    fsync, appender = os.fsync, []

    def fsync_racing_an_append(fd):
        if not appender:
            appender.append(threading.Thread(
                target=log.append, args=(("delete", 2),)))
            appender[0].start()
            appender[0].join(0.2)        # give it the time it needs
        fsync(fd)

    monkeypatch.setattr(tlog.os, "fsync", fsync_racing_an_append)
    log.sync()
    appender[0].join(10.0)
    assert not appender[0].is_alive() and log.lsn == 2
    log.sync()
    assert [lsn for lsn, _ in tlog.CatalogueLog(
        str(tmp_path), read_only=True).read_ops()] == [1, 2]


def test_recover_falls_back_past_a_corrupt_snapshot(tmp_path):
    t = tm.MutableHeadState.build(torch.from_numpy(_codes(7)), B_SUB, TILE)
    rng = np.random.default_rng(8)
    with tlog.CatalogueLog(str(tmp_path)) as log:
        log.snapshot(t)
        log.append_many(tserve._churn_ops(t, rng, 10, B_SUB))
        log.snapshot(t)
        log.append_many(tserve._churn_ops(t, rng, 10, B_SUB))
    newest = os.path.join(tmp_path, "snapshots", "step_0000000010",
                          "catalogue.npz")
    with open(newest, "r+b") as f:
        f.seek(200)
        f.write(b"\xff\xff\xff\xff")
    log = tlog.CatalogueLog(str(tmp_path))
    assert log.latest_snapshot_lsn() == 0      # step 10 fails its CRC
    got, lsn = log.recover(device="cpu", verify=True)
    assert lsn == 20
    assert torch.equal(got.codes, t.codes) and torch.equal(got.live, t.live)
    assert got.free == t.free and got.n_rows == t.n_rows
    j, jlsn = jlog.CatalogueLog(str(tmp_path), read_only=True).recover()
    assert jlsn == 20
    _eq(got.codes.numpy(), j.codes)


def test_recover_without_snapshot_raises_named_error(tmp_path):
    with pytest.raises(CorruptCheckpointError, match="never attached"):
        tlog.CatalogueLog(str(tmp_path)).recover(device="cpu")
    t = tm.MutableHeadState.build(torch.from_numpy(_codes(9)), B_SUB, TILE)
    log = tlog.CatalogueLog(str(tmp_path))
    log.snapshot(t)
    bigger = tm.MutableHeadState.build(torch.from_numpy(_codes(9)), B_SUB,
                                       TILE, capacity=1024)
    with pytest.raises(ValueError, match="shape changed"):
        log.snapshot(bigger)
    with pytest.raises(CorruptCheckpointError, match="at or before lsn"):
        tlog.CatalogueLog(str(tmp_path), read_only=True).recover(
            upto=-1, device="cpu")


def test_serve_cli_mutable_logs_and_recovers(tmp_path, capsys):
    log_dir = str(tmp_path / "log")
    base = ["--reduced", "--device", "cpu", "--max-batch", "8", "--mutable"]
    tserve.main(base + ["--requests", "32", "--churn-steps", "4",
                        "--log-dir", log_dir, "--snapshot-every", "8"])
    out = capsys.readouterr().out
    assert "method=pqtopk_pruned" in out and "n_compiles=2" in out
    assert "catalogue: capacity=2002 n_live=" in out and "n_swaps=4" in out
    assert "log: lsn=16 " in out and "snapshots=3" in out
    tserve.main(base + ["--requests", "8", "--log-dir", log_dir,
                        "--recover"])
    out = capsys.readouterr().out
    assert "recovered catalogue from" in out and "at lsn 16" in out
    for bad, why in ((["--chaos"], "needs --replicas > 1"),
                     (["--crash-replica-at", "1:4"], "--replicas > 1 and "
                      "--log-dir"),
                     (["--replicas", "2", "--chaos"], "immutable fabric"),
                     (["--replicas", "2", "--fail-at", "1"], "ONE engine")):
        with pytest.raises(SystemExit, match=why):
            tserve.main(base + bad)
    for bad, why in ((["--method", "pqtopk_fused"], "live-mask"),
                     (["--recover"], "needs --log-dir")):
        with pytest.raises(SystemExit, match=why):
            tserve.main(base + bad)
    with pytest.raises(SystemExit, match="needs --mutable"):
        tserve.main(["--reduced", "--device", "cpu", "--log-dir", log_dir])
    with pytest.raises(SystemExit, match="requires --mutable"):
        tserve.main(["--reduced", "--device", "cpu", "--churn-steps", "2"])


def test_serve_cli_super_factor_matches_the_reference_launcher(tmp_path,
                                                              capsys):
    """``--super-factor`` with ``--mutable``: the launcher's catalogue has the
    super level, and its WAL is byte-identical to the reference launcher's
    with the same flags; the refusal of ``--query-grouping`` beside it is
    the config's."""
    flags = ["--reduced", "--max-batch", "8", "--mutable", "--requests", "24",
             "--churn-steps", "3", "--super-factor", "4"]
    tserve.main(flags + ["--device", "cpu", "--log-dir",
                         str(tmp_path / "t")])
    out = capsys.readouterr().out
    assert "catalogue: capacity=" in out and "n_swaps=3" in out
    jserve.main(flags + ["--log-dir", str(tmp_path / "j")])
    capsys.readouterr()
    for name in ("wal.log", "meta.json"):
        with open(tmp_path / "t" / name, "rb") as a, \
                open(tmp_path / "j" / name, "rb") as b:
            assert a.read() == b.read(), name
    t, _ = tlog.CatalogueLog(str(tmp_path / "t")).recover(device="cpu")
    assert t.super_factor == 4 and t.state.has_super
    with pytest.raises(ValueError, match="mutually exclusive"):
        tserve.main(["--reduced", "--device", "cpu", "--super-factor", "4",
                     "--query-grouping"])
