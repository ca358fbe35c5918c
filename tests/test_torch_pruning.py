"""The port's pruned cascade (``repro_torch.core.pruning``) against the JAX
reference's ``repro.core.pruning``, bit for bit.

Inputs are numpy from a seed.  The reference's states reach the port
through ``interop.pruned_state_from_jax``, so both cascades read the same
metadata; the port's own builder is held against the reference's
separately.  The reference scores compacted tiles through its XLA path
(the CPU route of ``ops.pq_topk_tiles``), the port through the fused
kernel's plain version; both are exact top-k with ties to the lowest id.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as jp
from repro.kernels.pqtopk import ops as jops
from repro_torch.core import pruning as tp
from repro_torch.interop import pruned_state_from_jax
from repro_torch.kernels.pqtopk import ops as tops

N, M, B_SUB, TILE = 15_000, 4, 64, 512        # 30 tiles, the last ragged


def _case(kind, bq, n=N, m=M, b=B_SUB, seed=0):
    """Codes (N, m) int32 and S (B, m, b) f32.  ``uniform``: random codes
    and normal scores (bounds prune nothing); ``hot``: clustered codes and
    skewed scores with the lowest codes boosted for every query (the
    batch-any route prunes most tiles); ``mixed``: each query boosts its
    own code window (per-query grouping's regime), after
    ``tests/test_perquery_pruning.py``."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return (rng.integers(0, b, (n, m)).astype(np.int32),
                rng.standard_normal((bq, m, b)).astype(np.float32))
    centers = (np.arange(n) / n * b).astype(np.int64)
    codes = np.clip(centers[:, None] + rng.integers(-1, 2, (n, m)), 0, b - 1)
    g = rng.standard_normal((bq, m, b))
    g = np.sign(g) * np.abs(g) ** 3
    if kind == "hot":
        g[:, :, :4] += 6.0
    else:
        for q in range(bq):
            w = (q * b) // bq
            g[q, :, max(0, w - 1):w + 3] += 6.0
    return codes.astype(np.int32), g.astype(np.float32)


@functools.cache
def _states(kind, bq, backend):
    """(jax codes, jax s, jax state, torch codes, torch s, torch state)."""
    codes, s = _case(kind, bq)
    jc, js = jnp.asarray(codes), jnp.asarray(s)
    jst = jp.build_pruned_state(jc, B_SUB, TILE, backend=backend)
    tst = pruned_state_from_jax(jax.tree_util.tree_map(np.asarray, jst))
    return jc, js, jst, torch.from_numpy(codes), torch.from_numpy(s), tst


def _jax_cascade(jc, js, k, jst, **kw):
    """The reference's cascade, compiled as its serving path compiles it
    (the bound-backend name is static, so it rides outside the jit)."""
    def run(c, s, st):
        v, i, stats = jp.cascade_topk_ingraph(c, s, k, st, return_stats=True,
                                              **kw)
        return v, i, {key: x for key, x in stats.items()
                      if key != "bound_backend"}
    v, i, stats = jax.jit(run)(jc, js, jst)
    return v, i, {**stats, "bound_backend": jst.backend}


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _host(v):
    return v if isinstance(v, str) else np.asarray(v).item()


# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [16, 32, 33, 100, 256])
def test_pack_unpack_match_reference(b):
    present = np.random.default_rng(b).random((7, 3, b)) < 0.3
    want = np.asarray(jp.pack_presence(jnp.asarray(present)))
    got = tp.pack_presence(torch.from_numpy(present))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    _eq(got.numpy(), want.view(np.int32))
    _eq(tp.unpack_presence(got, b).numpy(), present)
    assert tp.packed_words(b) == jp.packed_words(b)


@pytest.mark.parametrize("backend", ["bitmask", "range"])
@pytest.mark.parametrize("code_dtype,n,m,b,tile", [
    ("int32", 15_000, 4, 64, 512), ("uint8", 4_097, 3, 100, 2048),
    ("uint16", 9_000, 8, 512, 1000), ("int8", 700, 2, 16, 2048)])
def test_metadata_matches_reference(backend, code_dtype, n, m, b, tile):
    codes = np.random.default_rng(n).integers(0, b, (n, m)).astype(code_dtype)
    codes[-5:] = 3                        # a narrow last tile for the ranges
    jst = jp.build_pruned_state(jnp.asarray(codes), b, tile, backend=backend)
    tst = tp.build_pruned_state(torch.from_numpy(codes), b, tile,
                                backend=backend)
    for f in ("tile", "n_items", "b", "shards", "n_local", "backend",
              "super_factor", "n_tiles", "nbytes", "bool_nbytes"):
        assert getattr(tst, f) == getattr(jst, f), f
    if backend == "range":
        _eq(tst.code_lo.numpy(), jst.code_lo)
        _eq(tst.code_hi.numpy(), jst.code_hi)
        assert tst.code_lo.dtype == torch.int16 and tst.packed is None
        _eq(tp.degenerate_tile_mask(tst).numpy(), jp.degenerate_tile_mask(jst))
    else:
        _eq(tst.packed.numpy(), np.asarray(jst.packed).view(np.int32))
        assert tp.degenerate_tile_mask(tst) is None
    conv = pruned_state_from_jax(jax.tree_util.tree_map(np.asarray, jst))
    for a, c in zip(tst.meta_arrays(), conv.meta_arrays()):
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# bounds, theta, survival, grouping, compaction, ladders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["bitmask", "range"])
@pytest.mark.parametrize("kind", ["hot", "mixed", "uniform"])
def test_bounds_match_reference(backend, kind):
    jc, js, jst, tc, ts, tst = _states(kind, 24, backend)
    want = np.asarray(jax.jit(jp.tile_bounds)(jst, js))
    got = tp.tile_bounds(tst, ts)
    _eq(got.numpy(), want)
    deg_j, deg_t = jp.degenerate_tile_mask(jst), tp.degenerate_tile_mask(tst)
    for bnd in (want.max(axis=0), want):
        _eq(tp.seed_order_key(torch.tensor(bnd), deg_t).numpy(),
            jp.seed_order_key(jnp.asarray(bnd), deg_j))
    # A one-item tile's bound is that item's score, bit for bit.
    one = tp.build_pruned_state(tc[:64], B_SUB, 1, backend=backend)
    _eq(tp.tile_bounds(one, ts).numpy(),
        tops.pq_scores(tc[:64], ts).numpy())


@pytest.mark.parametrize("backend", ["bitmask", "range"])
@pytest.mark.parametrize("policy", ["greedy", "adaptive"])
@pytest.mark.parametrize("perquery", [False, True])
def test_theta_and_masks_match_reference(backend, policy, perquery):
    kind = "mixed" if perquery else "hot"
    jc, js, jst, tc, ts, tst = _states(kind, 24, backend)
    bounds = jax.jit(jp.tile_bounds)(jst, js)
    tb = torch.tensor(np.asarray(bounds))
    kw = dict(tile=TILE, seed_policy=policy, seed_tiles=2, seed_max_tiles=16,
              seed_stab_tol=0.05)
    jfn = jp.theta_seed_perquery if perquery else jp.theta_seed_ingraph
    tfn = tp.theta_seed_perquery if perquery else tp.theta_seed_ingraph
    jt, jn, jsf = jax.jit(lambda c, s, b, d: jfn(c, s, b, 10, degenerate=d,
                                                 **kw))(
        jc, js, bounds, jp.degenerate_tile_mask(jst))
    tt, tn, tsf = tfn(tc, ts, tb, 10,
                      degenerate=tp.degenerate_tile_mask(tst), **kw)
    _eq(tt.numpy(), jt)
    assert tn == int(jn) and tsf.item() == float(jsf)
    if policy == "adaptive":
        assert tn > 2                      # at least one growth stage ran
    _eq(tp.survival_mask(tb, tt).numpy(), jp.survival_mask(bounds, jt))
    _eq(tp.survival_mask_perquery(tb, tt).numpy(),
        jp.survival_mask_perquery(bounds, jt))


@pytest.mark.parametrize("n_groups,bq", [(8, 24), (4, 24), (2, 8), (1, 8)])
def test_grouping_and_compaction_match_reference(n_groups, bq):
    rng = np.random.default_rng(n_groups * 100 + bq)
    mask = rng.random((bq, 30)) < 0.15
    mask[:, :3] |= rng.random((bq, 3)) < 0.8        # overlapping hot tiles
    mask[1] = False                                  # an empty query
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    if n_groups > 1:
        _eq(tp.group_queries(tm, n_groups).numpy(),
            jp.group_queries(jm, n_groups))
    bt = tops.group_batch_tile(bq, n_groups)
    assert bt == jops.group_batch_tile(bq, n_groups)
    for got, want in zip(
            tp.group_and_compact(tm, n_groups=n_groups, batch_tile=bt),
            jp.group_and_compact(jm, n_groups=n_groups, batch_tile=bt)):
        _eq(got.numpy(), want)
    for n_slots in (None, 30, 5, 1):
        for got, want in zip(tp.compact_mask(tm[0], n_slots),
                             jp.compact_mask(jm[0], n_slots)):
            _eq(got.numpy(), want)


def test_ladders_match_reference():
    rng = np.random.default_rng(0)
    count_lists = [[], [0], [621] * 9, [1, 2, 3, 700], list(rng.integers(
        0, 621, 40)), [5, 5, 5, 5, 600], [300, 310]]
    for counts in count_lists:
        for n_tiles, k, tile in ((621, 10, 2048), (30, 100, 64), (1, 5, 1001)):
            for headroom in (1, 2, 4):
                assert tp.calibrate_ladder(counts, n_tiles, k, tile,
                                           headroom=headroom) == \
                    jp.calibrate_ladder(counts, n_tiles, k, tile,
                                        headroom=headroom)
    for ladder in (None, (), (3,), (700, 2, 2, 64), (0, 620, 621)):
        for n_tiles, k, tile in ((621, 10, 2048), (4, 5000, 2048)):
            assert tp.normalize_ladder(ladder, n_tiles, k, tile) == \
                jp.normalize_ladder(ladder, n_tiles, k, tile)
    for policy in ("greedy", "adaptive"):
        for args in ((2, 16, 10, 2048, 621), (3, 5, 5000, 2048, 30),
                     (1, 64, 10, 512, 8)):
            assert tp.seed_schedule(policy, *args) == \
                jp.seed_schedule(policy, *args)


# ---------------------------------------------------------------------------
# the cascade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["bitmask", "range"])
@pytest.mark.parametrize("policy", ["greedy", "adaptive"])
@pytest.mark.parametrize("grouped", [False, True])
def test_cascade_matches_reference(backend, policy, grouped):
    """Values, ids and every STATS_KEYS entry, with a ladder whose small
    rungs the pruned cases can take.  The batch-any cases run on the
    ``hot`` catalogue (flat survival is sparse) and the grouped ones on
    ``mixed`` (per-query survival is)."""
    jc, js, jst, tc, ts, tst = (_states("mixed", 24, backend) if grouped
                                else _states("hot", 8, backend))
    k = 10
    runs = [dict(ladder=(2, 8, 16))]
    if backend == "bitmask" and policy == "greedy":
        runs += [dict(ladder=None), dict(ladder=(2,), pin_rung=True)]
    rungs = set()
    for extra in runs:
        kw = dict(seed_policy=policy, query_grouping=grouped, n_groups=8,
                  **extra)
        jv, ji, jstats = _jax_cascade(jc, js, k, jst, **kw)
        tv, ti, tstats = tp.cascade_topk_ingraph(tc, ts, k, tst,
                                                 return_stats=True, **kw)
        _eq(tv.numpy(), jv)
        _eq(ti.numpy(), ji)
        assert ti.dtype == torch.int32
        assert set(tstats) == set(jstats) == tp.STATS_KEYS == jp.STATS_KEYS
        for key in tp.STATS_KEYS:
            assert _host(tstats[key]) == _host(jstats[key]), key
        rungs.add(tstats["rung_hit"])
        if not extra.get("pin_rung"):
            # Exact: the exhaustive fused route's winners, ties included.
            ev, ei = tops.pq_topk(tc, ts, k)
            assert torch.equal(tv, ev) and torch.equal(ti, ei)
    if grouped:
        assert tstats["n_groups"] == 3
        assert tstats["pairs_scored"] < tstats["pairs_union"]
    assert tstats["n_survived"] < tstats["n_tiles"]
    assert min(rungs) < 3, rungs           # a non-exhaustive rung was taken


@pytest.mark.parametrize("backend", ["bitmask", "range"])
@pytest.mark.parametrize("grouped", [False, True])
def test_survival_counts_match_reference(backend, grouped):
    jc, js, jst, tc, ts, tst = _states("mixed", 24, backend)
    if grouped:
        want = jax.jit(lambda c, s, st: jp.survival_count_grouped(
            c, s, 10, st, n_groups=8))(jc, js, jst)
        got = tp.survival_count_grouped(tc, ts, 10, tst, n_groups=8)
    else:
        want = jax.jit(lambda c, s, st: jp.survival_count(c, s, 10, st))(
            jc, js, jst)
        got = tp.survival_count(tc, ts, 10, tst)
    assert int(got) == int(want) > 0


def test_later_slices_raise():
    """What the flat cascade still refuses.  The later slices are ported:
    super-tiles (``tests/test_torch_hierarchical.py``) and the shard-aligned
    layout (``tests/test_torch_sharded.py``), which builds as the
    reference's does and crosses ``interop``."""
    jc, js, jst, tc, ts, tst = _states("hot", 24, "bitmask")
    assert tp.build_pruned_state(tc, B_SUB, TILE, super_factor=4).has_super
    sharded = tp.build_pruned_state(tc, B_SUB, TILE, shards=2)
    assert (sharded.shards, sharded.n_local) == (2, N // 2)
    _eq(sharded.packed.numpy(), np.asarray(jp.build_pruned_state(
        jc, B_SUB, TILE, shards=2).packed).view(np.int32))
    # The tombstone mask is ported (test_torch_mutation.py); a mask of
    # the wrong length is refused.
    with pytest.raises(ValueError, match="live"):
        tp.cascade_topk_ingraph(tc, ts, 10, tst,
                                live=torch.ones(N - 1, dtype=torch.bool))
    with pytest.raises(ValueError, match="live"):
        tops.pq_topk_tiles(tc, ts, 10, torch.arange(3, dtype=torch.int32),
                           tile=TILE, live=torch.ones(N + 1, dtype=torch.bool))
    from dataclasses import replace
    with pytest.raises(ValueError, match="shards=1"):
        tp.cascade_topk_ingraph(tc, ts, 10, replace(tst, shards=2))
    assert pruned_state_from_jax(jax.tree_util.tree_map(
        np.asarray, replace(jst, shards=2))).shards == 2
    assert pruned_state_from_jax(jax.tree_util.tree_map(
        np.asarray, jp.with_super(jst, 4))).n_super == 8       # 30 tiles
