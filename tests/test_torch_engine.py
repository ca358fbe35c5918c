"""The port's serving engine and serve launcher, on the CPU: the reference's
``stats()`` schema and bucketing rules, serve-variant memoisation,
left-padding, deadline and ``--fail-at`` shedding, and results equal to the
port's own ``serve_topk``."""
import functools
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import pruning as jpruning
from repro.models import seqrec as jseqrec
from repro.serving import engine as jengine
from repro_torch.configs import base as tcfg
from repro_torch.interop import params_from_jax
from repro_torch.configs.base import get_reduced
from repro_torch.launch import serve as tserve
from repro_torch.models import seqrec
from repro_torch.serving.engine import MicroBatcher, Request, RetrievalEngine
from repro_torch.training.fault_tolerance import ServeFaultInjector

CFG = get_reduced("sasrec-recjpq").model


@pytest.fixture(scope="module")
def params():
    return seqrec.init_seqrec(torch.Generator().manual_seed(0), CFG)


def _engine(params, cfg=CFG, **kw):
    kw.setdefault("device", "cpu")
    return RetrievalEngine.for_seqrec(params, cfg, **kw)


def _history(rng, n=None):
    n = int(rng.integers(1, 3 * CFG.max_seq_len)) if n is None else n
    return rng.integers(1, CFG.n_items + 1, n)


def test_stats_schema_matches_reference(params):
    ref = jengine.RetrievalEngine(lambda s, k: None, seq_len=4,
                                  jit_serve=False).stats()
    eng = _engine(params)
    assert set(eng.stats()) == set(ref)
    assert eng.stats()["mRT_ms"] is None and eng.stats()["count"] == 0.0
    rng = np.random.default_rng(0)
    for i in range(5):
        eng.submit(Request(i, _history(rng)))
    assert len(eng.drain()) == 5
    st = eng.stats()
    assert set(st) == set(ref)
    assert st["count"] == 5.0 and st["mRT_ms"] > 0 and st["p99_ms"] > 0
    assert all(isinstance(v, float) for v in st.values())


def test_bucketing_and_batch_k_match_reference(params):
    for n in range(1, 80):
        assert MicroBatcher.bucket(n, 64) == jengine.MicroBatcher.bucket(n, 64)
    eng = _engine(params, k=10)
    ref = jengine.RetrievalEngine(lambda s, k: None, seq_len=4, k=10,
                                  max_k=eng.max_k, jit_serve=False)
    assert eng.max_k == 1000          # min(n_items, fused kernel tile)
    for ks in ([1], [10], [11, 3], [0, 17], [5000], [-3, 999]):
        assert eng.batch_k(ks) == ref.batch_k(ks)


def test_variants_memoised_per_bucket_and_k(params):
    eng = _engine(params, max_batch=8)
    rng = np.random.default_rng(1)
    for size, k in ((3, 10), (4, 10), (5, 10), (3, 20), (3, 20), (8, 10)):
        for i in range(size):
            eng.submit(Request(i, _history(rng), k=k))
        out = eng.drain()
        assert [len(r.items) for r in out] == [k] * size
    # (4,16), (8,16), (4,32): three variants.
    assert eng.stats()["n_compiles"] == 3.0


def test_left_padding_and_results_match_serve_topk(params):
    eng = _engine(params, k=5, max_batch=4)
    rng = np.random.default_rng(2)
    hists = [_history(rng, n) for n in (1, 7, CFG.max_seq_len, 40)]
    results, prep = eng.prepare([Request(i, h, k=5)
                                   for i, h in enumerate(hists)])
    assert results == []
    want = np.zeros((4, CFG.max_seq_len), np.int32)
    for i, h in enumerate(hists):
        tail = h[-CFG.max_seq_len:]
        want[i, -len(tail):] = tail
    np.testing.assert_array_equal(prep.seqs.numpy(), want)
    got = eng.complete(eng.launch(prep))
    ids, vals = seqrec.serve_topk(params, torch.from_numpy(want), CFG, k=8,
                                  method="pqtopk_fused")
    for i, r in enumerate(got):
        np.testing.assert_array_equal(r.items, ids[i, :5].numpy())
        np.testing.assert_array_equal(r.scores, vals[i, :5].numpy())


@pytest.mark.parametrize("fail_repeats,shed", [(1, False), (3, True)])
def test_fail_at_retries_then_sheds(params, fail_repeats, shed):
    faults = ServeFaultInjector(fail_at_batches=(1,),
                                fail_repeats=fail_repeats)
    eng = _engine(params, max_batch=4, faults=faults, max_retries=2,
                  retry_backoff_ms=0.0)
    rng = np.random.default_rng(3)
    for i in range(12):
        eng.submit(Request(i, _history(rng)))
    out = eng.drain()
    assert len(out) == 12
    st = eng.stats()
    assert st["retried"] == min(fail_repeats, 2)
    assert st["shed"] == (4.0 if shed else 0.0)
    assert [r.shed for r in out] == [False] * 4 + [shed] * 4 + [False] * 4
    assert all(len(r.items) == (0 if r.shed else 10) for r in out)


def test_expired_requests_shed_before_dispatch(params):
    eng = _engine(params)
    rng = np.random.default_rng(4)
    eng.submit(Request(0, _history(rng), arrival=time.monotonic() - 1.0,
                       deadline_ms=10.0))
    eng.submit(Request(1, _history(rng)))
    out = {r.request_id: r for r in eng.drain()}
    assert out[0].shed and out[0].timed_out and len(out[0].items) == 0
    assert not out[1].shed and len(out[1].items) == 10
    assert eng.stats()["timeouts"] == 1.0


def test_cuda_entry_points_refuse_without_a_card(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _engine(params, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--reduced", "--requests", "2"])


def test_serve_cli_prints_summary(capsys):
    results = tserve.main(["--reduced", "--requests", "20", "--max-batch",
                           "8", "--device", "cpu", "--fail-at", "3",
                           "--fail-repeats", "3", "--method", "pqtopk"])
    out = capsys.readouterr().out
    assert "served 20 requests" in out and "method=pqtopk" in out
    assert "mRT=" in out and "p99=" in out and "n_compiles=" in out
    assert "shed=8" in out          # batch 3 = the 2nd of the timed stream
    assert sum(r.shed for r in results) == 8


@functools.cache
def _pruned_models(grouped):
    """The reduced SASRec at 6,000 items (3 pruning tiles) with clustered
    codes, in the reference's tree (its own init) and the port's
    (``interop``), grouping on or off."""
    base = jcfg.get_reduced("sasrec-recjpq").model
    pq = replace(base.pq, query_grouping=grouped, n_groups=8)
    jc = replace(base, n_items=6000, pq=pq)
    tc = replace(CFG, n_items=6000, pq=tcfg.PQConfig(**vars(pq)))
    jp = jseqrec.init_seqrec(jax.random.PRNGKey(1), jc)
    rng = np.random.default_rng(1)
    n = jc.n_items + 1
    centers = (np.arange(n) / n * pq.b).astype(np.int64)
    codes = np.clip(centers[:, None] + rng.integers(-1, 2, (n, pq.m)), 0,
                    pq.b - 1).astype(pq.code_dtype)
    item = {**jp["item_emb"], "codes": jnp.asarray(codes),
            "sub_emb": jp["item_emb"]["sub_emb"] * 25.0}
    item["pruned"] = jpruning.build_pruned_state(item["codes"], pq.b, 2048)
    jp = {**jp, "item_emb": item}
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jc, tc, jp, tp


@pytest.mark.parametrize("grouped", [False, True])
def test_pruned_engine_matches_reference(grouped):
    """The pruned engine: ladder from given survival stats, the calibration
    pass's counts (group-aware when grouped), ``stats()`` keys,
    ``rung_counts`` and results, against the reference engine."""
    jc, tc, jp, tp = _pruned_models(grouped)
    counts = [0, 0, 0, 1]
    ref = jengine.RetrievalEngine.for_seqrec(
        jp, jc, k=5, max_batch=8, method="pqtopk_pruned",
        survival_stats=counts)
    eng = RetrievalEngine.for_seqrec(tp, tc, k=5, max_batch=8,
                                     method="pqtopk_pruned",
                                     survival_stats=counts, device="cpu")
    assert eng.ladder == ref.ladder == (1, 2, 3)
    assert eng.max_k == ref.max_k and eng.has_pinned == ref.has_pinned
    assert RetrievalEngine._observe_survival(
        tp, tc, k=5, max_batch=8, n_batches=1) == jengine.RetrievalEngine._observe_survival(jp, jc, k=5, max_batch=8,
                                                     n_batches=1)
    rng = np.random.default_rng(6)
    hists = [rng.integers(1, 6001, int(rng.integers(2, 16)))
             for _ in range(24)]
    outs = []
    for e in (ref, eng):
        for i, h in enumerate(hists):
            e.submit(jengine.Request(i, h, k=5) if e is ref
                     else Request(i, h, k=5))
        outs.append({r.request_id: r for r in e.drain()})
    rs, ts = ref.stats(), eng.stats()
    assert set(ts) == set(rs)
    for key in ("ladder", "rung_counts", "rung_hit_fraction", "count",
                "n_compiles"):
        assert ts[key] == rs[key], key
    assert sum(ts["rung_counts"].values()) == 3
    for i in range(len(hists)):
        np.testing.assert_allclose(outs[1][i].scores, outs[0][i].scores,
                                   rtol=1e-5, atol=1e-5)
        assert outs[1][i].degraded == ""
    # The exhaustive route gives the same winners on the port.
    fused = _engine(tp, cfg=tc, k=5, max_batch=8, method="pqtopk_fused")
    for i, h in enumerate(hists):
        fused.submit(Request(i, h, k=5))
    for r in fused.drain():
        np.testing.assert_array_equal(r.items, outs[1][r.request_id].items)
        np.testing.assert_array_equal(r.scores, outs[1][r.request_id].scores)


def test_pruned_engine_pins_and_skips_calibration():
    _, tc, _, tp = _pruned_models(False)
    eng = RetrievalEngine.for_seqrec(tp, tc, k=5, max_batch=8,
                                     method="pqtopk_pruned", ladder=(1,),
                                     device="cpu")
    assert eng.ladder == (1,) and eng.has_pinned
    rng = np.random.default_rng(8)
    for i in range(8):
        eng.submit(Request(i, rng.integers(1, 6001, 5), k=5))
    out = eng.run_once(rung_pin=True)
    assert len(out) == 8 and {r.degraded for r in out} == {"rung_pin"}
    assert eng.stats()["n_compiles"] == 1.0
    plain = RetrievalEngine.for_seqrec(tp, tc, k=5, method="pqtopk_pruned",
                                       calibrate=False, device="cpu")
    assert plain.ladder is None and not plain.has_pinned
    assert "ladder" not in plain.stats()
    with pytest.raises(ValueError, match="pinned"):
        plain._variant(8, 8, pinned=True)


def test_serve_cli_pruned_prints_ladder(capsys):
    tserve.main(["--reduced", "--requests", "12", "--max-batch", "4",
                 "--device", "cpu", "--method", "pqtopk_pruned",
                 "--query-grouping", "--n-groups", "2", "--bound-backend",
                 "range", "--seed-policy", "adaptive"])
    out = capsys.readouterr().out
    assert "method=pqtopk_pruned" in out
    # Two warm-up batches (buckets 1 and 4), then 12 requests in 3.
    assert "ladder=(1,) rung_hit_fraction=0.00 rung_counts={0: 5}" in out
    tserve.main(["--reduced", "--requests", "4", "--device", "cpu",
                 "--method", "pqtopk_pruned", "--no-calibrate"])
    assert "ladder=" not in capsys.readouterr().out


def _served(eng, hists, base, req_cls):
    for i, h in enumerate(hists):
        eng.submit(req_cls(base + i, h, k=5))
    return {r.request_id: r for r in eng.drain()}


def _assert_close_results(got, want):
    """Scores within 1e-5 (the backbones agree to a tolerance, not to
    bits) and the same items on rows whose scores leave clear gaps;
    returns the number of rows whose items were compared."""
    n_clear = 0
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_allclose(g.scores, w.scores, rtol=1e-5, atol=1e-5)
        gaps = -np.diff(w.scores)
        if np.all((gaps > 1e-4) | (gaps == 0)):
            np.testing.assert_array_equal(g.items, w.items)
            n_clear += 1
    return n_clear


def test_mutable_engine_matches_reference_and_hot_swaps():
    """``for_seqrec_mutable`` on one state in both packages (the reference's
    ``MutableHeadState`` carried over by ``interop``): the ladder, the
    live-masked calibration counts and the results agree before and after
    a churn step and a swap; the swap adds no serve variant; the port's
    results are the masked exhaustive oracle's, bit for bit."""
    from repro.core import mutation as jmutation
    from repro_torch.core import scoring
    from repro_torch.interop import mutable_state_from_jax
    from repro_torch.kernels.pqtopk import ops as tops
    jc, tc, jp, tp = _pruned_models(False)
    jst = jmutation.MutableHeadState.build(jp["item_emb"]["codes"], jc.pq.b)
    rng = np.random.default_rng(14)
    for iid in rng.choice(np.arange(1, 6001), 300, replace=False):
        jst.delete(int(iid))
    tst = mutable_state_from_jax(jst)
    assert tst.cap == 8192 and tst.state.n_tiles == 4
    counts = [0, 1, 1, 2]
    ref = jengine.RetrievalEngine.for_seqrec_mutable(
        jp, jc, jst, k=5, max_batch=8, survival_stats=counts)
    eng = RetrievalEngine.for_seqrec_mutable(
        tp, tc, tst, k=5, max_batch=8, survival_stats=counts, device="cpu")
    assert eng.ladder == ref.ladder and eng.max_k == ref.max_k
    merged = {**tp, "item_emb": {**tp["item_emb"], **tst.head_arrays()}}
    jmerged = {**jp, "item_emb": {**jp["item_emb"], **jst.head_arrays()}}
    assert RetrievalEngine._observe_survival(
        merged, tc, k=5, max_batch=8, n_batches=1) == \
        jengine.RetrievalEngine._observe_survival(jmerged, jc, k=5,
                                                  max_batch=8, n_batches=1)
    hists = [rng.integers(1, 6001, int(rng.integers(2, 16)))
             for _ in range(16)]
    n_clear = _assert_close_results(_served(eng, hists, 0, Request),
                                    _served(ref, hists, 0, jengine.Request))
    n_compiles = eng.stats()["n_compiles"]
    ops = tserve._churn_ops(tst, rng, 40, tc.pq.b)
    for op in ops:
        jmutation.apply_op(jst, op)
    assert torch.equal(tst.live, torch.from_numpy(np.array(jst.live)))
    eng.swap_head_state(tst)
    ref.swap_head_state(jst)
    got = _served(eng, hists, 100, Request)
    n_clear += _assert_close_results(got, _served(ref, hists, 100,
                                                  jengine.Request))
    assert n_clear >= 8
    st, rst = eng.stats(), ref.stats()
    assert st["n_compiles"] == n_compiles and st["n_swaps"] == 1.0
    assert set(st) == set(rst) and rst["n_swaps"] == 1.0
    dead = np.flatnonzero(~tst.live.numpy())
    assert not any(np.isin(r.items, dead).any() for r in got.values())
    # Bit for bit: the masked exhaustive oracle on the served batch.
    _, prep = eng.prepare([Request(i, h, k=5) for i, h in
                           enumerate(hists[:8])])
    res = eng.complete(eng.launch(prep))
    with torch.inference_mode():
        phi = seqrec.sequence_embedding(merged, prep.seqs, tc)
        s = scoring.subid_scores(merged["item_emb"]["sub_emb"], phi)
        sc = torch.where(tst.live[None, :], tops.pq_scores(tst.codes, s),
                         float("-inf"))
        ov, oi = tops._merge_slot_winners(sc[:, None, :], torch.arange(
            tst.cap, dtype=torch.int32).expand(8, 1, -1), prep.kk)
    for i, r in enumerate(res):
        np.testing.assert_array_equal(r.items, oi[i, :5].numpy())
        np.testing.assert_array_equal(r.scores, ov[i, :5].numpy())


def test_mutable_engine_swap_validation():
    from dataclasses import replace as dc_replace

    from repro_torch.core.mutation import MutableHeadState
    _, tc, _, tp = _pruned_models(False)
    codes = tp["item_emb"]["codes"]
    mstate = MutableHeadState.build(codes, tc.pq.b)
    eng = RetrievalEngine.for_seqrec_mutable(tp, tc, mstate, k=5,
                                             max_batch=8, calibrate=False,
                                             device="cpu")
    assert eng.ladder is None and eng.stats()["n_swaps"] == 0.0
    with pytest.raises(ValueError, match="structure"):
        eng.swap_head_state({"codes": mstate.codes, "live": mstate.live})
    bigger = MutableHeadState.build(codes, tc.pq.b, capacity=4 * mstate.cap)
    with pytest.raises(ValueError, match="capacity"):
        eng.swap_head_state(bigger)                  # a new engine's job
    with pytest.raises(ValueError, match="static fields"):
        eng.swap_head_state({**mstate.head_arrays(), "pruned": dc_replace(
            mstate.state, backend="range")})
    with pytest.raises(ValueError, match="dtypes"):
        eng.swap_head_state({**mstate.head_arrays(),
                             "codes": mstate.codes.long()})
    assert eng.stats()["n_swaps"] == 0.0
    eng.swap_head_state(mstate.clone())
    assert eng.stats()["n_swaps"] == 1.0
    plain = RetrievalEngine.for_seqrec(tp, tc, k=5, max_batch=8,
                                       method="pqtopk_pruned",
                                       calibrate=False, device="cpu")
    with pytest.raises(ValueError, match="swappable"):
        plain.swap_head_state(mstate)
    assert "n_swaps" not in plain.stats()
