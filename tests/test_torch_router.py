"""The port's replicated serving fabric (``repro_torch.serving.router``)
against the JAX reference's, on the CPU.

Deterministic parity: the replica fault plan and failure injector, the
micro-batcher's partial-batch deadline, ``prepare``'s ladder knobs and the
``stats()`` key sets equal the reference's.  Behaviour, mirroring
``tests/test_router_chaos.py``: exactly one Result per request through
crashes, re-dispatch, hedging and load shedding; every untagged result
bit-identical to the port's own single engine serving the same batches and
within the engine tests' policy (rtol=atol=1e-5, the same items on
clear-gap rows) of the JAX single engine.  Parameters are the reference's
``init_seqrec``, carried over by ``interop``.  Every router is used as a
context manager and every loop is bounded; no assertion rests on how fast
the host is."""
import dataclasses
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import mutation as jmutation
from repro.launch import serve as jserve
from repro.models import seqrec as jseqrec
from repro.serving import engine as jengine
from repro.serving import router as jrouter
from repro.training import fault_tolerance as jft
from repro_torch.configs.base import get_reduced
from repro_torch.core.mutation import MutableHeadState
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.serving.engine import MicroBatcher, Request, RetrievalEngine
from repro_torch.serving.router import ReplicaRouter
from repro_torch.training import fault_tolerance as tft

# 8192 items -> 4 pruning tiles at the default 2048 tile, so LADDER's single
# 1-tile rung is non-exhaustive and the rung-pinned route really differs.
JCFG = dataclasses.replace(jget_reduced("sasrec-recjpq").model, n_items=8192)
CFG = dataclasses.replace(get_reduced("sasrec-recjpq").model, n_items=8192)
LADDER = (1,)
K = 5
BIG_K = 16          # above the degrade k-cap's pow2 bucket, so capping bites


@pytest.fixture(scope="module")
def jparams():
    return jseqrec.init_seqrec(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _request_specs(n, seed=0):
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n):
        seq = rng.integers(1, CFG.n_items + 1, int(rng.integers(2, 16)))
        specs.append((i, seq, BIG_K if i % 3 == 0 else K))
    return specs


def _engine(params, **kw):
    return RetrievalEngine.for_seqrec(params, CFG, k=K, max_batch=8,
                                      method="pqtopk_pruned", ladder=LADDER,
                                      calibrate=False, device="cpu", **kw)


def _serve(engine, specs, req_cls=Request):
    for rid_, payload, kreq in specs:
        engine.submit(req_cls(rid_, payload, k=kreq))
    return {r.request_id: r for r in engine.drain()}


@pytest.fixture(scope="module")
def oracle_results(params):
    """The port's single engine over the same requests in the same batches
    of 8: no router, no faults, no degradation."""
    return _serve(_engine(params), _request_specs(260))


@pytest.fixture(scope="module")
def reference_results(jparams):
    """The JAX package's single engine over the same requests."""
    eng = jengine.RetrievalEngine.for_seqrec(
        jparams, JCFG, k=K, max_batch=8, method="pqtopk_pruned",
        ladder=LADDER, calibrate=False)
    return _serve(eng, _request_specs(260), jengine.Request)


def _mk_router(params, **kw):
    kw.setdefault("n_replicas", 3)
    kw.setdefault("max_batch", 8)
    kw.setdefault("method", "pqtopk_pruned")
    kw.setdefault("ladder", LADDER)
    kw.setdefault("calibrate", False)
    return ReplicaRouter.for_seqrec(params, CFG, k=K, device="cpu", **kw)


def _pump_until(router, cond, timeout_s=30.0, sleep_s=0.01):
    t0 = time.monotonic()
    while not cond():
        router.pump()
        if time.monotonic() - t0 > timeout_s:
            return False
        time.sleep(sleep_s)
    return True


def _parity(results, oracle, reference):
    """Untagged, unshed results: bit-identical to the port's engine, and
    within 1e-5 of the reference's with the same items where the scores
    leave clear gaps.  -> (rows checked, clear-gap rows)."""
    checked = clear = 0
    for r in results:
        if r.shed or r.degraded or r.request_id not in oracle:
            continue
        o = oracle[r.request_id]
        np.testing.assert_array_equal(
            r.items, o.items,
            err_msg=f"request {r.request_id} on replica {r.replica}")
        np.testing.assert_array_equal(r.scores, o.scores)
        w = reference[r.request_id]
        np.testing.assert_allclose(r.scores, w.scores, rtol=1e-5, atol=1e-5)
        gaps = -np.diff(w.scores)
        if np.all((gaps > 1e-4) | (gaps == 0)):
            np.testing.assert_array_equal(r.items, w.items)
            clear += 1
        checked += 1
    return checked, clear


# ---- deterministic parity with the reference ------------------------------

@pytest.mark.parametrize("crash,slow", [
    ((), ()), (((1, 4),), ()), ((), ((0, 3),)),
    (((0, 2), (5, 6)), ((1, 7),))])
def test_fault_plan_and_injector_match_reference(crash, slow):
    got = tft.ReplicaFaultPlan(crash_windows=crash, slow_windows=slow,
                               slow_ms=250.0)
    want = jft.ReplicaFaultPlan(crash_windows=crash, slow_windows=slow,
                                slow_ms=250.0)
    for idx in range(-1, 10):
        assert got.mode(idx) == want.mode(idx)
        fates = []
        for plan in (got, want):
            try:
                fates.append(("ok", plan.check(idx)))
            except (tft.SimulatedFailure, jft.SimulatedFailure) as exc:
                fates.append(("crash", str(exc)))
        assert fates[0] == fates[1]
    steps = tuple(w[0] for w in crash) or (3,)
    fi, fj = (tft.FailureInjector(fail_at_steps=steps),
              jft.FailureInjector(fail_at_steps=steps))
    for step in list(range(8)) * 2:           # each step fires once only
        outs = []
        for inj, err in ((fi, tft.SimulatedFailure),
                         (fj, jft.SimulatedFailure)):
            try:
                inj.check(step)
                outs.append(None)
            except err as exc:
                outs.append(str(exc))
        assert outs[0] == outs[1]


@pytest.mark.parametrize("max_wait_ms", [0.0, 2.0, 10.0])
def test_micro_batcher_ready_matches_reference(max_wait_ms):
    got = MicroBatcher(max_batch=4, max_wait_ms=max_wait_ms)
    want = jengine.MicroBatcher(max_batch=4, max_wait_ms=max_wait_ms)
    t0 = 1000.0
    for b in (got, want):
        assert b.oldest_wait_ms(now=t0) == 0.0 and not b.ready(now=t0)
    for i in range(6):
        got.submit(Request(i, np.arange(3)))
        want.submit(jengine.Request(i, np.arange(3)))
        for b in (got, want):
            b._enq_t[-1] = t0 + i * 1e-3          # injected clock
        for dt in (0.0, 1e-3, 2.5e-3, 20e-3):
            now = t0 + i * 1e-3 + dt
            assert got.oldest_wait_ms(now) == want.oldest_wait_ms(now)
            assert got.ready(now) == want.ready(now)
    assert ([r.request_id for r in got.next_batch()]
            == [r.request_id for r in want.next_batch()])
    assert list(got._enq_t) == list(want._enq_t)


def test_prepare_k_cap_and_rung_pin_match_reference():
    got = RetrievalEngine(lambda s, k: None, seq_len=4, k=5, max_k=64,
                          device="cpu", serve_fn_pinned=lambda s, k: None)
    want = jengine.RetrievalEngine(lambda s, k: None, seq_len=4, k=5,
                                   max_k=64, jit_serve=False,
                                   serve_fn_pinned=lambda s, k: None)
    plain = RetrievalEngine(lambda s, k: None, seq_len=4, k=5, max_k=64,
                            device="cpu")
    for ks in ([1], [5], [16, 3], [40], [200]):
        for k_cap in (None, 0, 1, 3, 8, 16, 100):
            for rung_pin in (False, True):
                outs = []
                for eng, req in ((got, Request), (want, jengine.Request)):
                    _, prep = eng.prepare(
                        [req(i, np.arange(1, 4), k=k)
                         for i, k in enumerate(ks)],
                        k_cap=k_cap, rung_pin=rung_pin)
                    outs.append((prep.kk, prep.degraded))
                assert outs[0] == outs[1], (ks, k_cap, rung_pin)
                _, prep = plain.prepare([Request(0, np.arange(1, 4), k=ks[0])],
                                        k_cap=k_cap, rung_pin=rung_pin)
                assert "rung_pin" not in prep.degraded   # no pinned route


@pytest.mark.parametrize("mutable", [False, True])
def test_stats_keys_match_reference(mutable):
    jeng = jengine.RetrievalEngine(lambda s, k: None, seq_len=4,
                                   jit_serve=False)
    teng = RetrievalEngine(lambda s, k: None, seq_len=4, device="cpu")
    jkw, tkw = {}, {}
    if mutable:
        codes = np.random.default_rng(0).integers(0, 16, (100, 4))
        jkw["replica_states"] = [jmutation.MutableHeadState.build(
            jnp.asarray(codes, jnp.int32), 16, tile=32)]
        tkw["replica_states"] = [MutableHeadState.build(
            torch.from_numpy(codes.astype(np.int32)), 16, tile=32)]
    with jrouter.ReplicaRouter([jeng], **jkw) as jr, \
            ReplicaRouter([teng], **tkw) as tr:
        want, got = jr.stats(), tr.stats()
    assert set(got) == set(want)
    assert set(got["replicas"][0]) == set(want["replicas"][0])
    assert {k: v for k, v in got.items() if k != "replicas"} == \
        {k: v for k, v in want.items() if k != "replicas"}


# ---- behaviour, mirroring tests/test_router_chaos.py ----------------------

def test_flagship_exactly_once_and_parity(params, oracle_results,
                                          reference_results):
    """>= 200 requests over K=3 replicas with replica 1 crash-looping, the
    ladder driven through a degrade -> recover cycle, and the crashed
    replica ejected and re-admitted; every untagged result bit-identical to
    the port's engine and close to the reference's."""
    plans = {1: tft.ReplicaFaultPlan(crash_windows=((0, 3),))}
    with _mk_router(params, fault_plans=plans, suspect_after=1,
                    eject_after=1, cooldown_ms=20.0,
                    hedge_floor_ms=500.0,
                    degrade_high=64, degrade_low=8,
                    degrade_patience=1, recover_patience=2) as router:
        router.warmup(ks=[BIG_K])
        specs = _request_specs(260)
        all_results = []
        # Phase 1 (steady state): trickle 120 requests with pumping.
        for rid_, payload, kreq in specs[:120]:
            router.submit(Request(rid_, payload, k=kreq))
            if rid_ % 8 == 7:
                router.pump()
        all_results += router.drain(timeout_s=60.0)
        extra = 10_000
        rng = np.random.default_rng(42)
        while router.replicas[1].readmissions == 0:
            for j in range(8):
                router.submit(Request(
                    extra + j, rng.integers(1, CFG.n_items + 1, 8), k=K))
            extra += 8
            router.drain(timeout_s=60.0)
            assert extra < 11_000, "replica 1 never re-admitted"
        st = router.stats()
        assert st["replicas"][1]["ejections"] >= 1
        assert st["replicas"][1]["readmissions"] >= 1
        assert len(router.readmit_ms) >= 1
        # Phase 2 (overload): the burst walks the ladder; BIG_K requests
        # come back k-capped and tagged.
        for rid_, payload, kreq in specs[120:]:
            router.submit(Request(rid_, payload, k=kreq))
        router.pump()
        assert router.level >= 1
        phase2 = router.drain(timeout_s=60.0)
        all_results += phase2
        assert any(r.degraded for r in phase2)
        assert _pump_until(router, lambda: router.level == 0)
        st = router.stats()
        assert st["degrade_events"] >= 1 and st["recover_events"] >= 1
        assert router._expected == router._done_ids
        seen = [r.request_id for r in all_results if r.request_id < 10_000]
        assert sorted(seen) == list(range(260))
        checked, clear = _parity(all_results, oracle_results,
                                 reference_results)
        assert checked >= 10 and clear >= 8
        tags = set(st["degraded_results"])
        assert tags and tags <= {"k_cap", "rung_pin", "k_cap+rung_pin",
                                 "load_shed", "redispatch_exhausted"}
        assert st["p50_ms"] is not None and st["p99_ms"] is not None
        for rep in st["replicas"].values():
            assert {"state", "strikes", "ejections", "readmissions",
                    "queue_depth"} <= set(rep)


def test_healthy_fabric_matches_engine_and_reference(params, oracle_results,
                                                     reference_results):
    """No faults, no overload: every result is untagged and served by one
    of the three replicas, bit for bit the port's engine's."""
    with _mk_router(params, hedge=False) as router:
        router.warmup(ks=[BIG_K])
        for rid_, payload, kreq in _request_specs(96):
            router.submit(Request(rid_, payload, k=kreq))
            if rid_ % 8 == 7:
                router.pump()
        results = router.drain(timeout_s=60.0)
        st = router.stats()
    assert sorted(r.request_id for r in results) == list(range(96))
    assert not any(r.degraded or r.shed or r.hedged for r in results)
    assert {r.replica for r in results} <= {0, 1, 2}
    assert sum(rep["completed"] for rep in st["replicas"].values()) == 12
    checked, clear = _parity(results, oracle_results, reference_results)
    assert checked == 96 and clear >= 8


def test_exactly_once_under_crash_and_redispatch(params):
    plans = {0: tft.ReplicaFaultPlan(crash_windows=((2, 5),))}
    with _mk_router(params, n_replicas=2, fault_plans=plans,
                    eject_after=1, cooldown_ms=10.0,
                    hedge=False) as router:
        router.warmup()
        n = 64
        rng = np.random.default_rng(3)
        for i in range(n):
            router.submit(Request(i, rng.integers(1, CFG.n_items + 1, 8),
                                  k=K))
            if i % 16 == 15:
                router.pump()
        results = router.drain(timeout_s=60.0)
        ids = sorted(r.request_id for r in results)
        assert ids == list(range(n))
        assert all(not r.shed for r in results)
        assert router.stats()["redispatched"] >= 1


def test_hedge_rescues_straggler_and_suppresses_duplicate(params):
    plans = {0: tft.ReplicaFaultPlan(slow_windows=((0, 2),), slow_ms=400.0)}
    with _mk_router(params, n_replicas=2, fault_plans=plans,
                    eject_after=10, hedge_floor_ms=40.0) as router:
        router.warmup()
        rng = np.random.default_rng(4)
        for i in range(8):
            router.submit(Request(i, rng.integers(1, CFG.n_items + 1, 8),
                                  k=K))
        results = router.drain(timeout_s=60.0)
        assert sorted(r.request_id for r in results) == list(range(8))
        st = router.stats()
        assert st["hedges"] >= 1 and st["hedge_wins"] >= 1
        assert any(r.hedged for r in results)
        assert _pump_until(router,
                           lambda: router.duplicates_suppressed >= 1)


def test_degradation_ladder_tags_and_recovers(params):
    with _mk_router(params, n_replicas=2, hedge=False,
                    degrade_high=24, degrade_low=4,
                    degrade_patience=1, recover_patience=3) as router:
        router.warmup(ks=[BIG_K])
        rng = np.random.default_rng(5)
        nxt = 0

        def burst(n):
            nonlocal nxt
            for _ in range(n):
                router.submit(Request(
                    nxt, rng.integers(1, CFG.n_items + 1, 8), k=BIG_K))
                nxt += 1

        burst(40)
        router.pump()
        assert router.level >= 1
        while router.level < 3:
            burst(8)
            router.pump()
            assert nxt < 400, "ladder never reached level 3"
        burst(8)                              # level 3: shed at submit
        results = router.drain(timeout_s=60.0)
        by_tag = {}
        for r in results:
            by_tag.setdefault(r.degraded, []).append(r)
        assert len(by_tag.get("load_shed", [])) >= 1
        for r in by_tag["load_shed"]:
            assert r.shed and r.items.size == 0
        capped = by_tag.get("k_cap", []) + by_tag.get("k_cap+rung_pin", [])
        assert capped, f"no k-capped results; tags: {list(by_tag)}"
        for r in capped:
            assert r.items.shape[0] <= 8     # BIG_K=16 capped to bucket 8
        assert any("rung_pin" in t for t in by_tag), list(by_tag)
        assert _pump_until(router, lambda: router.level == 0)
        assert router.recover_events >= 1
        assert sorted(r.request_id for r in results) == list(range(nxt))


def test_rung_pinned_results_are_tagged_never_silent(params):
    with _mk_router(params, n_replicas=2, hedge=False,
                    recover_patience=10_000) as router:
        assert all(e.has_pinned for e in router.engines)
        router.warmup()
        router.level = 2                      # hold the ladder at rung-pin
        rng = np.random.default_rng(6)
        for i in range(8):
            router.submit(Request(i, rng.integers(1, CFG.n_items + 1, 8),
                                  k=K))
        results = router.drain(timeout_s=60.0)
        assert sorted(r.request_id for r in results) == list(range(8))
        for r in results:
            assert r.degraded == "rung_pin"   # k=K is not capped
            assert not r.shed and r.items.shape[0] == K
            assert np.isfinite(r.scores).all()


def test_router_single_replica_degenerates_to_engine(params):
    eng = _engine(params)
    rng = np.random.default_rng(8)
    seqs = [rng.integers(1, CFG.n_items + 1, 8) for _ in range(8)]
    for i, s in enumerate(seqs):
        eng.submit(Request(i, s, k=K))
    want = {r.request_id: r for r in eng.drain()}
    with _mk_router(params, n_replicas=1) as router:
        assert not router.hedge_enabled
        router.warmup()
        for i, s in enumerate(seqs):
            router.submit(Request(i, s, k=K))
        got = {r.request_id: r for r in router.drain(timeout_s=60.0)}
    assert set(got) == set(want)
    for i in want:
        np.testing.assert_array_equal(got[i].items, want[i].items)
        np.testing.assert_array_equal(got[i].scores, want[i].scores)
        assert got[i].replica == 0 and want[i].replica == -1


def test_all_replicas_ejected_forces_probe_liveness(params):
    plans = {0: tft.ReplicaFaultPlan(crash_windows=((0, 2),)),
             1: tft.ReplicaFaultPlan(crash_windows=((0, 2),))}
    with _mk_router(params, n_replicas=2, fault_plans=plans,
                    eject_after=1, cooldown_ms=5_000.0,   # absurd cooldown
                    hedge=False) as router:
        router.warmup()
        rng = np.random.default_rng(9)
        for i in range(16):
            router.submit(Request(i, rng.integers(1, CFG.n_items + 1, 8),
                                  k=K))
        results = router.drain(timeout_s=60.0)
        assert sorted(r.request_id for r in results) == list(range(16))
        assert all(not r.shed for r in results)


def test_sharded_routes_and_dead_workers_raise(params):
    # Sharded replicas are ported (tests/test_torch_sharded.py); a mesh
    # whose lead device is not the replicas' device is refused.
    from repro_torch.launch.mesh import ShardMesh
    mesh = ShardMesh(["meta"] * 2)
    with pytest.raises(ValueError, match="lead device"):
        ReplicaRouter.for_seqrec(params, CFG, n_replicas=2, device="cpu",
                                 sharded_mesh=mesh)
    # A worker that dies on an unexpected error surfaces at the next pump.
    eng = RetrievalEngine(lambda s, k: 1 / 0, seq_len=4, device="cpu")
    with ReplicaRouter([eng]) as router:
        router.submit(Request(0, np.arange(1, 4)))
        with pytest.raises(RuntimeError, match="worker died"):
            router.drain(timeout_s=30.0)


# ---- the serve launcher ---------------------------------------------------

def _line_keys(out):
    """Each printed line's sequence of ``key=`` names (values vary)."""
    return [re.findall(r"([\w\[\]]+)=", line) for line in out.splitlines()
            if "=" in line and not line.startswith("chaos:")]


def test_serve_cli_replicated_chaos_prints_reference_lines(capsys):
    flags = ["--reduced", "--replicas", "3", "--chaos", "--requests", "24",
             "--max-batch", "4"]
    results = tserve.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert sorted(r.request_id for r in results) == list(range(24))
    assert "replicas=3 method=pqtopk_fused chaos=True" in out
    assert "replica[2] state=" in out
    jserve.main(flags)
    assert _line_keys(out) == _line_keys(capsys.readouterr().out)
