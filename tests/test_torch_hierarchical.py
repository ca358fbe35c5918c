"""The port's hierarchical super-tiles and host two-pass cascade
(``repro_torch.core.pruning``, ``core.mutation``, ``core.retrieval_head``)
against the JAX reference, bit for bit (atol=0).

Mirrors the single-device cases of ``tests/test_hierarchical.py``: the
super arrays of ``with_super``, the flat and hierarchical cascades with
every stats key, super-ladder escalation, the grouping refusal, mutable
churn with loosen-only supers and retighten parity, the capacity grain and
``survival_count``; then ``cascade_topk`` and ``top_items_pruned``.
Inputs are numpy from a seed, through both packages; the reference's
cascade runs jitted, as it serves."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PQConfig as JPQConfig
from repro.core import mutation as jm
from repro.core import pruning as jp
from repro.core import retrieval_head as jrh
from repro_torch.configs.base import PQConfig as TPQConfig
from repro_torch.core import mutation as tm
from repro_torch.core import pruning as tp
from repro_torch.core import retrieval_head as trh
from repro_torch.interop import (mutable_state_from_jax, params_from_jax,
                                 pruned_state_from_jax)
from repro_torch.kernels.pqtopk import ops as tops

BACKENDS = ("bitmask", "range")
M, B_SUB = 4, 16


def _case(n, m=M, b=B_SUB, bq=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, b, (n, m)).astype(np.uint8),
            rng.standard_normal((bq, m, b)).astype(np.float32))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _host(v):
    return v if isinstance(v, str) else np.asarray(v).item()


def _arrays(st):
    """Every tensor field of a state as numpy (uint32 words as int32)."""
    out = {}
    for f in tp.ARRAY_FIELDS:
        a = getattr(st, f)
        if a is not None:
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            out[f] = a.view(np.int32) if a.dtype == np.uint32 else a
    return out


def _assert_same_arrays(t, j):
    got, want = _arrays(t), _arrays(j)
    assert got.keys() == want.keys()
    for f in want:
        _eq(got[f], want[f])


def _jax_cascade(jc, js, k, jst, live=None, **kw):
    """The reference's cascade, jitted (the backend name is static)."""
    def run(c, s, st, lv):
        v, i, stats = jp.cascade_topk_ingraph(c, s, k, st, live=lv,
                                              return_stats=True, **kw)
        return v, i, {key: x for key, x in stats.items()
                      if key != "bound_backend"}
    v, i, stats = jax.jit(run)(jc, js, jst, live)
    return v, i, {**stats, "bound_backend": jst.backend}


def _assert_cascades_agree(tc, ts, jc, js, k, tst, jst, tlive=None,
                           jlive=None, **kw):
    """Values, ids and every STATS_KEYS entry; returns the port's stats."""
    jv, ji, jstats = _jax_cascade(jc, js, k, jst, live=jlive, **kw)
    tv, ti, tstats = tp.cascade_topk_ingraph(tc, ts, k, tst, live=tlive,
                                             return_stats=True, **kw)
    _eq(tv.numpy(), jv)
    _eq(ti.numpy(), ji)
    assert set(tstats) == set(jstats) == tp.STATS_KEYS
    for key in tp.STATS_KEYS:
        assert _host(tstats[key]) == _host(jstats[key]), key
    return tv, ti, tstats


# ---------------------------------------------------------------------------
# with_super
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,tile,factor", [(1000, 32, 4), (999, 16, 8),
                                           (257, 32, 4), (4096, 64, 64)])
def test_with_super_matches_reference(backend, n, tile, factor):
    """The super arrays bit for bit (a ragged last super included), each
    super's bound dominating its children's, and ``factor <= 1``
    stripping the level."""
    codes, s = _case(n, seed=n)
    jst = jp.with_super(jp.build_pruned_state(jnp.asarray(codes), B_SUB,
                                              tile, backend=backend), factor)
    tst = tp.build_pruned_state(torch.from_numpy(codes), B_SUB, tile,
                                backend=backend, super_factor=factor)
    _assert_same_arrays(tst, jst)
    _assert_same_arrays(pruned_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jst)), jst)
    for f in ("super_factor", "n_super", "supers_per_shard", "n_tiles",
              "tiles_per_shard", "has_super"):
        assert getattr(tst, f) == getattr(jst, f), f
    ts = torch.from_numpy(s)
    child = tp.tile_bounds(tst, ts)
    sup = tp.bounds_from_parts(backend, tst.super_meta_arrays(), ts)
    _eq(sup.numpy(), jp.bounds_from_parts(backend, jst.super_meta_arrays(),
                                          jnp.asarray(s)))
    for g in range(tst.n_super):
        assert bool((sup[:, g:g + 1] >= child[:, g * factor:
                                              (g + 1) * factor]).all())
    flat = tp.with_super(tst, 1)
    assert not flat.has_super and flat.super_meta_arrays() == (
        (None, None) if backend == "range" else (None,))


def test_or_reduce_matches_a_plain_or():
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -2 ** 31, 2 ** 31, (3, 7, 5), dtype=np.int64).astype(np.int32))
    want = x[:, 0]
    for j in range(1, 7):
        want = want | x[:, j]
    assert torch.equal(tp._or_reduce_axis(x, 1), want)


def test_super_helpers_match_reference():
    for n_super in (1, 3, 10, 16, 17, 1526, 16384):
        assert tp.default_super_ladder(n_super) == \
            jp.default_super_ladder(n_super)
    rng = np.random.default_rng(2)
    mask = rng.random(40) < 0.3
    values = np.sort(rng.choice(1000, 40, replace=False)).astype(np.int32)
    for n_slots in (None, 40, 7, 1):
        for got, want in zip(
                tp.compact_values(torch.from_numpy(mask),
                                  torch.from_numpy(values), n_slots),
                jp.compact_values(jnp.asarray(mask), jnp.asarray(values),
                                  n_slots)):
            _eq(got.numpy(), want)
    assert tp.DEFAULT_SUPER_FACTOR == jp.DEFAULT_SUPER_FACTOR == 64


# ---------------------------------------------------------------------------
# the cascade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [512, 999, 1021])
def test_hier_cascade_matches_reference(backend, n):
    """Flat and hierarchical, each against the reference's (values, ids,
    every stats key), and both equal to the exhaustive fused route."""
    codes, s = _case(n, seed=n)
    k = 7
    jc, js = jnp.asarray(codes), jnp.asarray(s)
    tc, ts = torch.from_numpy(codes), torch.from_numpy(s)
    jst = jp.build_pruned_state(jc, B_SUB, 32, backend=backend)
    jsth = jp.with_super(jst, 4)
    tst = tp.build_pruned_state(tc, B_SUB, 32, backend=backend)
    tsth = tp.with_super(tst, 4)
    fv, fi, _ = _assert_cascades_agree(tc, ts, jc, js, k, tst, jst)
    hv, hi, stats = _assert_cascades_agree(tc, ts, jc, js, k, tsth, jsth)
    ev, ei = tops.pq_topk(tc, ts, k)
    for v, i in ((fv, fi), (hv, hi)):
        assert torch.equal(v, ev) and torch.equal(i, ei)
    assert stats["n_super"] == tsth.n_super
    assert stats["bounds_computed"] > tsth.n_super


@pytest.mark.parametrize("backend", BACKENDS)
def test_super_ladder_escalation_exact_at_every_rung(backend):
    """Tiny super rungs drive every escalation branch (the exhaustive rung
    included) with the reference's stats; pinned at both levels, the port
    still takes the reference's rungs and returns its (possibly inexact)
    answer."""
    codes, s = _case(1024, seed=5)
    k = 9
    jc, js = jnp.asarray(codes), jnp.asarray(s)
    tc, ts = torch.from_numpy(codes), torch.from_numpy(s)
    jsth = jp.with_super(jp.build_pruned_state(jc, B_SUB, 32,
                                               backend=backend), 4)
    tsth = tp.build_pruned_state(tc, B_SUB, 32, backend=backend,
                                 super_factor=4)
    ev, ei = tops.pq_topk(tc, ts, k)
    hits = set()
    for sup_ladder in [(1,), (1, 2), (2, 4, 8), None]:
        for ladder in (None, (1, 2)):
            v, i, st = _assert_cascades_agree(
                tc, ts, jc, js, k, tsth, jsth, super_ladder=sup_ladder,
                ladder=ladder)
            assert torch.equal(v, ev) and torch.equal(i, ei)
            hits.add(st["super_rung_hit"])
        _assert_cascades_agree(tc, ts, jc, js, k, tsth, jsth,
                               super_ladder=sup_ladder, ladder=(1, 2),
                               pin_rung=True)
    assert len(hits) > 1, hits


def test_hier_rejects_query_grouping():
    codes, s = _case(512)
    tsth = tp.build_pruned_state(torch.from_numpy(codes), B_SUB, 32,
                                 super_factor=4)
    jsth = jp.with_super(jp.build_pruned_state(jnp.asarray(codes), B_SUB,
                                               32), 4)
    with pytest.raises(ValueError, match="query_grouping") as want:
        jp.cascade_topk_ingraph(jnp.asarray(codes), jnp.asarray(s), 5, jsth,
                                query_grouping=True, n_groups=2)
    with pytest.raises(ValueError, match="query_grouping") as got:
        tp.cascade_topk_ingraph(torch.from_numpy(codes), torch.from_numpy(s),
                                5, tsth, query_grouping=True, n_groups=2)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="mutually exclusive"):
        TPQConfig(m=4, b=16, super_factor=4, query_grouping=True)


@pytest.mark.parametrize("backend", BACKENDS)
def test_hier_reduces_bound_work_on_clustered_codes(backend):
    """A tile-coherent catalogue: pass 0 prunes supers, bounds_computed <
    T, with the reference's counts."""
    rng = np.random.default_rng(0)
    n, m, b, tile, factor = 1 << 13, 4, 64, 64, 8
    grain = tile * factor
    codes = np.empty((n, m), np.uint8)
    for g in range(n // grain):
        base = (g * 48) // max(1, n // grain - 1)
        codes[g * grain:(g + 1) * grain] = base + rng.integers(
            0, 8, (grain, m))
    s = (-4.0 * np.arange(b, dtype=np.float32) / b)[None, None, :] \
        + 0.5 * rng.standard_normal((2, m, b)).astype(np.float32)
    jc, js = jnp.asarray(codes), jnp.asarray(s)
    tc, ts = torch.from_numpy(codes), torch.from_numpy(s)
    jsth = jp.with_super(jp.build_pruned_state(jc, b, tile,
                                               backend=backend), factor)
    tsth = tp.build_pruned_state(tc, b, tile, backend=backend,
                                 super_factor=factor)
    v, i, st = _assert_cascades_agree(tc, ts, jc, js, 10, tsth, jsth)
    ev, ei = tops.pq_topk(tc, ts, 10)
    assert torch.equal(v, ev) and torch.equal(i, ei)
    assert st["bounds_computed"] < tsth.n_tiles
    assert st["n_super_survived"] < tsth.n_super


@pytest.mark.parametrize("backend", BACKENDS)
def test_survival_count_on_a_super_state(backend):
    """Seeded from the super bounds, as the serve path seeds: the
    reference's count, which is the hierarchical cascade's n_survived."""
    codes, s = _case(1024, seed=9)
    jsth = jp.with_super(jp.build_pruned_state(jnp.asarray(codes), B_SUB, 32,
                                               backend=backend), 4)
    tsth = tp.build_pruned_state(torch.from_numpy(codes), B_SUB, 32,
                                 backend=backend, super_factor=4)
    for policy in ("greedy", "adaptive"):
        want = jax.jit(lambda c, s_, st: jp.survival_count(
            c, s_, 8, st, seed_policy=policy))(jnp.asarray(codes),
                                               jnp.asarray(s), jsth)
        got = tp.survival_count(torch.from_numpy(codes), torch.from_numpy(s),
                                8, tsth, seed_policy=policy)
        assert int(got) == int(want) > 0
        _, _, st = tp.cascade_topk_ingraph(
            torch.from_numpy(codes), torch.from_numpy(s), 8, tsth,
            seed_policy=policy, return_stats=True)
        assert st["n_survived"] == int(got)


# ---------------------------------------------------------------------------
# the mutable catalogue with a super level
# ---------------------------------------------------------------------------

def _mutable_pair(backend, n=300, capacity=1024, seed=11):
    codes = np.random.default_rng(seed).integers(0, B_SUB, (n, M)).astype(
        np.uint8)
    j = jm.MutableHeadState.build(jnp.asarray(codes), B_SUB, tile=32,
                                  backend=backend, super_factor=4,
                                  capacity=capacity)
    t = tm.MutableHeadState.build(torch.from_numpy(codes), B_SUB, tile=32,
                                  backend=backend, super_factor=4,
                                  capacity=capacity)
    return t, j


def _churn(mgrs, rng):
    """Inserts, deletes and updates applied to every manager in turn (the
    reference's test mix, plus inserts into emptied tiles)."""
    def each(fn):
        for mgr in mgrs:
            fn(mgr)
    for _ in range(25):
        row = rng.integers(0, B_SUB, M)
        each(lambda mgr: mgr.insert(row))
    for i in range(1, 60, 7):
        each(lambda mgr: mgr.delete(i))
    for i in range(61, 120, 11):
        row = rng.integers(0, B_SUB, M)
        each(lambda mgr: mgr.update(i, row))
    for i in range(1, 32):                # empty tile 0 but for row 0 ...
        if bool(mgrs[0].live[i]):
            each(lambda mgr: mgr.delete(i))
    for i in range(32, 64):               # ... and tile 1 entirely
        if bool(mgrs[0].live[i]):
            each(lambda mgr: mgr.delete(i))
    for _ in range(6):                    # freed slots, FIFO: the sixth
        row = rng.integers(0, B_SUB, M)   # lands in the empty tile 1
        each(lambda mgr: mgr.insert(row))
    assert bool(mgrs[0].live[36]) and int(mgrs[0].live[32:64].sum()) == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_mutable_super_churn_and_cascade_match_reference(backend):
    """Op for op, the port's manager holds the reference's arrays at both
    levels; after the churn the masked hierarchical cascade equals the
    reference's (every stats key) and the exhaustive masked oracle."""
    t, j = _mutable_pair(backend)
    assert t.cap == j.cap and t.state.n_super == j.state.n_super
    _churn([t, j], np.random.default_rng(12))
    _assert_same_arrays(t.state, j.state)
    _eq(t.codes.numpy(), j.codes)
    _eq(t.live.numpy(), j.live)
    _eq(t.staleness, j.staleness)
    s = np.random.default_rng(2).standard_normal((3, M, B_SUB)).astype(
        np.float32)
    ts, js = torch.from_numpy(s), jnp.asarray(s)
    tv, ti, _ = _assert_cascades_agree(t.codes, ts, j.codes, js, 7, t.state,
                                       j.state, tlive=t.live, jlive=j.live)
    sc = torch.where(t.live[None, :], tops.pq_scores(t.codes, ts),
                     float("-inf"))
    ov, oi = torch.sort(sc, dim=1, descending=True, stable=True)
    assert torch.equal(tv, ov[:, :7]) and torch.equal(ti.long(), oi[:, :7])
    # The reference's manager crosses over whole, super arrays included.
    _assert_same_arrays(mutable_state_from_jax(j).state, j.state)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mutable_super_retighten_parity(backend):
    """A full retighten equals the from-scratch oracle at both levels and
    the reference's retightened state; a partial one matches the
    reference's too."""
    t, j = _mutable_pair(backend, n=400, seed=3)
    _churn([t, j], np.random.default_rng(3))
    t2, j2 = t.clone(), j.clone()
    assert t2.retighten(max_tiles=3) == j2.retighten(max_tiles=3)
    _assert_same_arrays(t2.state, j2.state)
    assert t.retighten() == j.retighten()
    oracle = t.rebuild_oracle()
    assert oracle.has_super and t.state.has_super
    _assert_same_arrays(t.state, oracle)
    _assert_same_arrays(t.state, j.state)
    _assert_same_arrays(oracle, j.rebuild_oracle())


@pytest.mark.parametrize("backend", BACKENDS)
def test_mutable_super_capacity_is_super_grain_multiple(backend):
    for n, cap in ((100, None), (300, 1000), (5000, None)):
        t = tm.MutableHeadState.build(torch.zeros((n, M), dtype=torch.uint8),
                                      B_SUB, tile=32, backend=backend,
                                      super_factor=4, capacity=cap)
        j = jm.MutableHeadState.build(jnp.zeros((n, M), jnp.uint8), B_SUB,
                                      tile=32, backend=backend,
                                      super_factor=4, capacity=cap)
        assert t.cap == j.cap and t.cap % (32 * 4) == 0
        assert t.state.n_tiles % 4 == 0 and t.super_factor == 4
        _assert_same_arrays(t.state, j.state)


# ---------------------------------------------------------------------------
# the host two-pass cascade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,tile,k,seed_tiles", [
    (999, 32, 7, 2), (1021, 64, 40, 1), (512, 32, 9, 4), (200, 512, 5, 2)])
def test_host_cascade_matches_reference(n, tile, k, seed_tiles):
    """``cascade_topk`` (the sentinel-tile slot list) against the
    reference's: values, ids and every stats key; the pass-1 pieces
    (dense metadata, theta, mask) bit for bit."""
    codes, s = _case(n, seed=n + tile)
    jc, js = jnp.asarray(codes), jnp.asarray(s)
    tc, ts = torch.from_numpy(codes), torch.from_numpy(s)
    t_tile = min(tile, n)
    jmeta = jp.build_tile_metadata(jc, B_SUB, t_tile)
    tmeta = tp.build_tile_metadata(tc, B_SUB, t_tile)
    assert (tmeta.tile, tmeta.n_tiles, tmeta.n_items) == (
        jmeta.tile, jmeta.n_tiles, jmeta.n_items)
    _eq(tmeta.present.numpy(), jmeta.present)
    for got, want in zip(
            tp.pruned_pass1(tc, tmeta.present, ts, k, tile=t_tile,
                            n_seed=seed_tiles),
            jp.pruned_pass1(jc, jmeta.present, js, k, tile=t_tile,
                            n_seed=seed_tiles)):
        _eq(got.numpy(), want)
    jv, ji, jstats = jp.cascade_topk(jc, js, k, tile=tile,
                                     seed_tiles=seed_tiles,
                                     return_stats=True)
    tv, ti, tstats = tp.cascade_topk(tc, ts, k, tile=tile,
                                     seed_tiles=seed_tiles,
                                     return_stats=True)
    _eq(tv.numpy(), jv)
    _eq(ti.numpy(), ji)
    assert set(tstats) == set(jstats) == tp.STATS_KEYS
    for key in tp.STATS_KEYS:
        assert _host(tstats[key]) == _host(jstats[key]), key
    ev, ei = tops.pq_topk(tc, ts, k)
    assert torch.equal(tv, ev) and torch.equal(ti, ei)
    for n_surv in (0, 1, 5, 8, 33):
        assert tp.slot_bucket(n_surv, k, t_tile) == jp.slot_bucket(
            n_surv, k, t_tile)


def test_tile_metadata_cache_evicts_with_its_codes():
    codes = torch.from_numpy(_case(300)[0])
    meta = tp.get_tile_metadata(codes, B_SUB, 32)
    assert tp.get_tile_metadata(codes, B_SUB, 32) is meta
    key = (id(codes), B_SUB, 32)
    assert key in tp._META_CACHE
    del codes
    import gc
    gc.collect()
    assert key not in tp._META_CACHE


def test_top_items_pruned_matches_reference():
    """``retrieval_head.top_items_pruned`` on one head in both packages (the
    reference's weights carried over): the reference's winners and stats,
    and the exhaustive route's.  d = m, so S is one product per entry and
    the same bits in both packages (the jitted matmul of the reference's
    route may round a wider one differently)."""
    jparams = jrh.init(jax.random.PRNGKey(3), 5000, 4, JPQConfig(m=4, b=16))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    phi = np.random.default_rng(4).standard_normal((3, 4)).astype(np.float32)
    jv, ji, jstats = jrh.top_items_pruned(jparams, jnp.asarray(phi), 10,
                                          tile=256, return_stats=True)
    tv, ti, tstats = trh.top_items_pruned(tparams, torch.from_numpy(phi), 10,
                                          tile=256, return_stats=True)
    _eq(tv.numpy(), jv)
    _eq(ti.numpy(), ji)
    for key in tp.STATS_KEYS:
        assert _host(tstats[key]) == _host(jstats[key]), key
    ev, ei = trh.top_items(tparams, torch.from_numpy(phi), 10,
                           method="pqtopk")
    assert torch.equal(tv, ev) and torch.equal(ti, ei)
    with pytest.raises(ValueError, match="PQ head"):
        trh.top_items_pruned({"table": torch.zeros(4, 4)},
                             torch.from_numpy(phi), 2)


@pytest.mark.parametrize("backend", BACKENDS)
def test_head_with_super_serves_pruned_route_like_reference(backend):
    """``retrieval_head.init`` with ``PQConfig.super_factor`` builds the
    super level; the head carried over from the reference serves
    ``pqtopk_pruned`` with its winners and rung (d = m: S the same bits in
    both packages)."""
    jcfg = JPQConfig(m=4, b=16, bound_backend=backend, super_factor=4)
    tcfg = TPQConfig(m=4, b=16, bound_backend=backend, super_factor=4)
    jparams = jrh.init(jax.random.PRNGKey(5), 20_000, 4, jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert tparams["pruned"].has_super
    own = trh.init(torch.Generator().manual_seed(0), 20_000, 4, tcfg)
    assert own["pruned"].super_factor == 4 and own["pruned"].n_super == 3
    phi = np.random.default_rng(6).standard_normal((4, 4)).astype(np.float32)
    jv, ji, jr = jrh.top_items(jparams, jnp.asarray(phi), 10,
                               method="pqtopk_pruned", pq_cfg=jcfg,
                               ladder=(2, 4), return_rung=True)
    tv, ti, tr = trh.top_items(tparams, torch.from_numpy(phi), 10,
                               method="pqtopk_pruned", pq_cfg=tcfg,
                               ladder=(2, 4), return_rung=True)
    _eq(tv.numpy(), jv)
    _eq(ti.numpy(), ji)
    assert tr == int(jr)
    # A head without a state rebuilds it with the config's super level.
    bare = {k: v for k, v in tparams.items() if k != "pruned"}
    bv, bi = trh.top_items(bare, torch.from_numpy(phi), 10,
                           method="pqtopk_pruned", pq_cfg=tcfg)
    assert torch.equal(bv, tv) and torch.equal(bi, ti)


def test_super_state_fields_survive_replace():
    st = tp.build_pruned_state(torch.from_numpy(_case(999)[0]), B_SUB, 32,
                               super_factor=4)
    moved = st.to("cpu")
    assert dataclasses.asdict(moved).keys() == dataclasses.asdict(st).keys()
    assert torch.equal(moved.super_packed, st.super_packed)
