"""The port's mutable catalogue (``repro_torch.core.mutation`` and the
tombstone-masked cascade) against the JAX reference, bit for bit.

One seeded op stream goes through the reference's ``MutableHeadState``
and the port's; after every op the codes, live mask, metadata, staleness,
freelist order and slot high-water mark must agree.  The masked cascade
is held against the reference's jitted cascade (values, ids, stats) and,
under churn, against an exhaustive masked oracle.  Inputs are numpy from
a seed; states cross over through ``interop``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mutation as jm
from repro.core import pruning as jp
from repro_torch.core import mutation as tm
from repro_torch.core import pruning as tp
from repro_torch.interop import mutable_state_from_jax, pruned_state_from_jax
from repro_torch.kernels.pqtopk import ops as tops

M, B_SUB, TILE, K = 4, 16, 64, 8
N0 = 500                       # initial rows -> capacity 512 = 8 tiles


def _codes(n=N0, dtype="int8", seed=0):
    return np.random.default_rng(seed).integers(0, B_SUB, (n, M)).astype(
        dtype)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _meta(st):
    """The backend's metadata as numpy (presence words as int32 bits)."""
    return [np.asarray(a).view(np.int32) if np.asarray(a).dtype == np.uint32
            else np.asarray(a) for a in st.meta_arrays()]


def _assert_same_state(t, j, where=""):
    _eq(t.codes.numpy(), j.codes)
    _eq(t.live.numpy(), j.live)
    for g, w in zip(_meta(t.state), _meta(j.state)):
        np.testing.assert_array_equal(g, w, err_msg=where)
    _eq(t.staleness, j.staleness)
    assert t.free == [int(x) for x in j.free], where
    assert (t.n_rows, t.n_mutations) == (j.n_rows, j.n_mutations), where


def _draw_op(j, rng):
    """One valid op drawn against the reference's state (a third each of
    insert, delete and update; a full catalogue turns an insert into a
    delete)."""
    live = np.flatnonzero(np.asarray(j.live))
    live = live[live > 0]
    u, row = rng.random(), rng.integers(0, B_SUB, M)
    if u < 0.3 and (j.free or j.n_rows < j.cap):
        return ("insert", row)
    if u < 0.65 and live.size > K + 4:
        return ("delete", int(rng.choice(live)))
    return ("update", int(rng.choice(live)), row)


def _pair(backend, dtype="int8", n=N0, seed=0, capacity=None):
    codes = _codes(n, dtype, seed)
    j = jm.MutableHeadState.build(jnp.asarray(codes), B_SUB, TILE,
                                  backend=backend, capacity=capacity)
    t = tm.MutableHeadState.build(torch.from_numpy(codes), B_SUB, TILE,
                                  backend=backend, capacity=capacity)
    return t, j


@pytest.mark.parametrize("backend", ["bitmask", "range"])
@pytest.mark.parametrize("dtype", ["int8", "uint16"])
def test_op_stream_matches_reference(backend, dtype):
    t, j = _pair(backend, dtype)
    assert t.cap == j.cap == 512 and t.state.n_tiles == 8
    _assert_same_state(t, j, "build")
    _assert_same_state(mutable_state_from_jax(j), j, "interop")
    rng = np.random.default_rng(1)
    kinds = set()
    for step in range(240):
        op = _draw_op(j, rng)
        kinds.add(op[0])
        assert tm.apply_op(t, op) == jm.apply_op(j, op)
        _assert_same_state(t, j, f"step {step} {op[0]}")
    assert kinds == {"insert", "delete", "update"}
    assert t.stats() == j.stats()
    assert t.stats()["stale_tiles"] > 0


@pytest.mark.parametrize("backend", ["bitmask", "range"])
def test_retighten_matches_rebuild_oracle(backend):
    t, j = _pair(backend, seed=2)
    rng = np.random.default_rng(3)
    for _ in range(150):
        op = _draw_op(j, rng)
        tm.apply_op(t, op)
        jm.apply_op(j, op)
    # A partial retighten (stalest first) then the rest, as the reference.
    assert t.retighten(max_tiles=3) == j.retighten(max_tiles=3)
    _assert_same_state(t, j, "partial")
    assert t.retighten() == j.retighten()
    assert t.stats()["stale_tiles"] == 0.0
    for g, w in zip(t.state.meta_arrays(), t.rebuild_oracle().meta_arrays()):
        assert torch.equal(g, w)
    _assert_same_state(t, j, "full")


def test_insert_into_empty_range_tile_sets_its_range():
    """The range backend's first insert into a tile with no live row sets
    the range; widening the masked build's [0, 0] clamp would leave it
    looser than the rebuild oracle."""
    t, j = _pair("range", n=64, capacity=256)      # tiles 1..3 all dead
    _eq(t.state.code_lo[2].numpy(), np.zeros(M, np.int16))
    row = np.array([9, 3, 12, 5])
    for mgr in (t, j):
        for _ in range(64):                          # fill tile 1
            mgr.insert(np.full(M, 1))
    assert t.insert(row) == j.insert(jnp.asarray(row)) == 2 * TILE
    _eq(t.state.code_lo[2].numpy(), row)
    _eq(t.state.code_hi[2].numpy(), row)
    _assert_same_state(t, j)
    for g, w in zip(t.state.meta_arrays(), t.rebuild_oracle().meta_arrays()):
        assert torch.equal(g, w)


@pytest.mark.parametrize("backend", ["bitmask", "range"])
def test_masked_build_matches_reference(backend):
    """``build_pruned_state_masked`` with random tombstones and one fully
    dead tile (range: clamped to [0, 0]); ``live=None`` is the unmasked
    build."""
    codes = _codes(700, "uint16", seed=4)            # a ragged last tile
    live = np.random.default_rng(5).random(700) > 0.1
    live[128:192] = False                            # tile 2 all dead
    jst = jp.build_pruned_state_masked(jnp.asarray(codes), jnp.asarray(live),
                                       B_SUB, TILE, backend=backend)
    tst = tp.build_pruned_state_masked(torch.from_numpy(codes),
                                       torch.from_numpy(live), B_SUB, TILE,
                                       backend=backend)
    for g, w in zip(_meta(tst), _meta(jst)):
        _eq(g, w)
    conv = pruned_state_from_jax(jst)
    for g, w in zip(tst.meta_arrays(), conv.meta_arrays()):
        assert torch.equal(g, w)
    if backend == "range":
        assert not tst.code_lo[2].any() and not tst.code_hi[2].any()
    else:
        assert not tst.packed[2].any()
    plain = tp.build_pruned_state(torch.from_numpy(codes), B_SUB, TILE,
                                  backend=backend)
    for g, w in zip(plain.meta_arrays(), tp.build_pruned_state_masked(
            torch.from_numpy(codes), None, B_SUB, TILE,
            backend=backend).meta_arrays()):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="live mask shape"):
        tp.build_pruned_state_masked(torch.from_numpy(codes),
                                     torch.ones(5, dtype=torch.bool), B_SUB,
                                     TILE)


# ---------------------------------------------------------------------------
# the live-masked cascade
# ---------------------------------------------------------------------------

def _hot_catalogue(backend, seed=6):
    """A clustered capacity-padded catalogue with tombstones, one dead tile
    and dead rows planted on the best scores of the hot code window, and
    skewed scores: (jax state, port state, jax S, port S)."""
    rng = np.random.default_rng(seed)
    n, bq = 1000, 24
    centers = (np.arange(n) / n * B_SUB).astype(np.int64)
    codes = np.clip(centers[:, None] + rng.integers(-1, 2, (n, M)), 0,
                    B_SUB - 1).astype(np.int8)
    codes[[40, 41, 600]] = 0                         # dead high scorers
    j = jm.MutableHeadState.build(jnp.asarray(codes), B_SUB, TILE,
                                  backend=backend)   # capacity 1024
    for iid in [40, 41, 600] + list(range(192, 256)) + list(
            rng.choice(np.arange(1, n), 80, replace=False)):
        if bool(j.live[int(iid)]):
            j.delete(int(iid))
    g = rng.standard_normal((bq, M, B_SUB))
    g = np.sign(g) * np.abs(g) ** 3
    g[:, :, :2] += 6.0
    for q in range(bq):
        w = 4 + (q * (B_SUB - 6)) // bq
        g[q, :, w:w + 2] += 3.0
    s = g.astype(np.float32)
    return j, mutable_state_from_jax(j), jnp.asarray(s), torch.from_numpy(s)


def _jax_cascade(c, s, st, lv, **kw):
    def run(c, s, st, lv):
        v, i, stats = jp.cascade_topk_ingraph(c, s, K, st, live=lv,
                                              return_stats=True, **kw)
        return v, i, {key: x for key, x in stats.items()
                      if key != "bound_backend"}
    return jax.jit(run)(c, s, st, lv)


def _masked_oracle(codes, live, s, k=K):
    """Every capacity row scored in ``tree_sum`` order, dead -> -inf, stable
    top-k, ``-inf`` winners -> the capacity id."""
    sc = torch.where(live[None, :], tops.pq_scores(codes, s), float("-inf"))
    v, i = tops._merge_slot_winners(sc[:, None, :], torch.arange(
        codes.shape[0], dtype=torch.int32).expand(sc.shape[0], 1, -1), k)
    return tops._remap_dead(v, i, codes.shape[0])


@pytest.mark.parametrize("backend", ["bitmask", "range"])
@pytest.mark.parametrize("grouped", [False, True])
def test_live_cascade_matches_reference(backend, grouped):
    j, t, js, ts = _hot_catalogue(backend)
    for kw in (dict(ladder=(2, 4, 8)), dict(seed_policy="adaptive")):
        kw.update(query_grouping=grouped, n_groups=4)
        jv, ji, jstats = _jax_cascade(j.codes, js, j.state, j.live, **kw)
        tv, ti, tstats = tp.cascade_topk_ingraph(
            t.codes, ts, K, t.state, live=t.live, return_stats=True, **kw)
        _eq(tv.numpy(), jv)
        _eq(ti.numpy(), ji)
        for key in tp.STATS_KEYS - {"bound_backend"}:
            assert np.asarray(tstats[key]).item() == \
                np.asarray(jstats[key]).item(), key
        ov, oi = _masked_oracle(t.codes, t.live, ts)
        assert torch.equal(tv, ov) and torch.equal(ti, oi)
        assert not np.isin(ti.numpy(), np.flatnonzero(~t.live.numpy())).any()
    assert tstats["n_survived"] < tstats["n_tiles"]
    count = (tp.survival_count_grouped(t.codes, ts, K, t.state, n_groups=4,
                                       live=t.live) if grouped else
             tp.survival_count(t.codes, ts, K, t.state, live=t.live))
    want = jax.jit(lambda c, s, st, lv: (
        jp.survival_count_grouped(c, s, K, st, n_groups=4, live=lv)
        if grouped else jp.survival_count(c, s, K, st, live=lv)))(
            j.codes, js, j.state, j.live)
    assert int(count) == int(want)
    with pytest.raises(ValueError, match="live mask covers"):
        tp.cascade_topk_ingraph(t.codes, ts, K, t.state, live=t.live[:-1])


@pytest.mark.parametrize("backend", ["bitmask", "range"])
@pytest.mark.parametrize("grouped", [False, True])
def test_churn_exactness(backend, grouped):
    """>= 200 interleaved mutation and query steps: every query equals the
    exhaustive masked oracle, and no tombstoned item surfaces."""
    t = tm.MutableHeadState.build(torch.from_numpy(_codes(seed=7)), B_SUB,
                                  TILE, backend=backend)
    rng = np.random.default_rng(8 + grouped)
    n_queries = 0
    for step in range(220):
        if rng.random() < 0.25 or step == 219:
            s = torch.from_numpy(rng.standard_normal(
                (5, M, B_SUB)).astype(np.float32))
            ha = t.head_arrays()
            v, i = tp.cascade_topk_ingraph(
                ha["codes"], s, K, ha["pruned"], live=ha["live"],
                query_grouping=grouped, n_groups=2, ladder=(2, 4))
            ov, oi = _masked_oracle(ha["codes"], ha["live"], s)
            assert torch.equal(v, ov) and torch.equal(i, oi), step
            dead = np.flatnonzero(~ha["live"].numpy())
            assert not np.isin(i.numpy(), dead).any(), step
            n_queries += 1
        else:
            live = np.flatnonzero(t.live.numpy())
            live = live[live > 0]
            u, row = rng.random(), rng.integers(0, B_SUB, M)
            if u < 0.3 and (t.free or t.n_rows < t.cap):
                t.insert(row)
            elif u < 0.65 and live.size > K + 4:
                t.delete(int(rng.choice(live)))
            else:
                t.update(int(rng.choice(live)), row)
    assert n_queries >= 40 and t.stats()["stale_tiles"] > 0


# ---------------------------------------------------------------------------
# refusals, clone, capacity
# ---------------------------------------------------------------------------

def test_capacity_freelist_and_validation_match_reference():
    codes = _codes(62, seed=9)
    j = jm.MutableHeadState.build(jnp.asarray(codes), B_SUB, tile=16)
    t = tm.MutableHeadState.build(torch.from_numpy(codes), B_SUB, tile=16)
    assert t.cap == j.cap == tm.next_pow2(62) == 64
    row = np.arange(M) % B_SUB
    for mgr, mod in ((t, tm), (j, jm)):
        assert {mgr.insert(row), mgr.insert(row)} == {62, 63}
        with pytest.raises(mod.CapacityError):
            mgr.insert(row)
        mgr.delete(62)
        mgr.delete(63)
        assert mgr.insert(row) == 62                  # FIFO freelist reuse
        for bad in (lambda: mgr.delete(0), lambda: mgr.delete(1063),
                    lambda: mgr.update(63, row), lambda: mgr.insert(row[:2]),
                    lambda: mgr.delete(63)):
            with pytest.raises(ValueError):
                bad()
        with pytest.raises(ValueError, match="unknown catalogue op"):
            mod.apply_op(mgr, ("rename", 3))
    _assert_same_state(t, j)
    # A super level rounds the capacity up to whole supers (64 rows here).
    assert tm.MutableHeadState.build(torch.from_numpy(codes), B_SUB, tile=16,
                                     super_factor=4).cap == 64 == \
        jm.MutableHeadState.build(jnp.asarray(codes), B_SUB, tile=16,
                                  super_factor=4).cap
    with pytest.raises(ValueError, match="bound backend"):
        tm.MutableHeadState.build(torch.from_numpy(codes), B_SUB,
                                  backend="bloom")


def test_clone_copies_every_tensor():
    t, _ = _pair("bitmask", seed=10)
    c = t.clone()
    before = [x.clone() for x in (t.codes, t.live, t.state.packed)]
    c.update(5, np.full(M, 15))
    c.delete(6)
    c.insert(np.zeros(M))
    for x, y in zip((t.codes, t.live, t.state.packed), before):
        assert torch.equal(x, y)
    assert t.free == [] and t.n_mutations == 0 and c.n_mutations == 3
    assert not torch.equal(c.codes, t.codes)


def test_live_guard_matches_reference():
    """A head carrying a tombstone mask refuses every method but the pruned
    cascade, with the reference's message word for word."""
    from repro.core import retrieval_head as jrh
    from repro_torch.core import retrieval_head as trh
    codes = _codes(64, seed=11)
    rng = np.random.default_rng(12)
    sub = rng.standard_normal((M, B_SUB, 8)).astype(np.float32)
    phi = rng.standard_normal((2, M * 8)).astype(np.float32)
    live = np.ones(64, bool)
    for method in ("pqtopk", "pqtopk_fused", "dense"):
        with pytest.raises(ValueError, match="tombstone") as want:
            jrh.top_items({"codes": jnp.asarray(codes), "sub_emb": jnp.asarray(
                sub), "live": jnp.asarray(live)}, jnp.asarray(phi), K,
                method=method)
        with pytest.raises(ValueError, match="tombstone") as got:
            trh.top_items({"codes": torch.from_numpy(codes),
                           "sub_emb": torch.from_numpy(sub),
                           "live": torch.from_numpy(live)},
                          torch.from_numpy(phi), K, method=method)
        assert str(got.value) == str(want.value)
