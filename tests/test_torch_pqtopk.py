"""The port's PQTopK kernel wrappers against the JAX reference.

On the CPU the wrappers run the kernels' plain versions; the reference runs
its Pallas kernels in interpret mode, as ``tests/test_pqtopk_fused.py``
does.  Scores, winners and ids must agree bit for bit.  The CUDA kernels
themselves are held against the plain versions in
``test_torch_kernels_cuda.py``, on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pqtopk import kernel as jkernel, ops as jops
from repro_torch.configs import base as tconfigs
from repro_torch.kernels.pqtopk import kernel as tkernel, ops as tops
from repro_torch.kernels.pqtopk import ref as tref


def _inputs(n, m, b, bq, code_dtype="int32", seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b, (n, m)).astype(code_dtype)
    s = rng.standard_normal((bq, m, b)).astype(np.float32)
    return codes, s


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plant_ties(codes, s):
    """Rows 3, N/2 and N-1 share row 3's codes (equal scores), and query 0
    scores them highest, so the winners tie across tiles."""
    codes = codes.copy()
    codes[[codes.shape[0] // 2, -1]] = codes[3]
    s = s.copy()
    s[0, np.arange(codes.shape[1]), codes[3].astype(np.int64)] = 50.0
    return codes, s


@pytest.mark.parametrize("code_dtype,n,m,b", [
    ("int8", 777, 8, 128), ("uint8", 1001, 3, 100), ("uint16", 1999, 8, 512),
    ("int32", 513, 3, 100), ("int32", 700, 2, 256), ("int32", 700, 4, 256),
    ("int32", 700, 6, 256)])
def test_pq_scores_bitexact(code_dtype, n, m, b):
    codes, s = _inputs(n, m, b, 5, code_dtype)
    ref = np.asarray(jops.pq_scores(jnp.asarray(codes), jnp.asarray(s),
                                    tile=256, interpret=True))
    got = tops.pq_scores(_t(codes), _t(s)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tref.pq_scores(_t(codes), _t(s)).numpy(),
                                  ref)


@pytest.mark.parametrize("code_dtype,n,m,b,k,tile", [
    ("uint16", 1999, 8, 512, 10, 256), ("uint8", 1001, 3, 100, 16, 128),
    ("int32", 300, 4, 16, 7, 2048), ("int32", 1500, 2, 256, 10, 512),
    ("int32", 1500, 4, 256, 16, 512), ("int32", 1500, 6, 256, 10, 1024)])
def test_pq_topk_bitexact_with_ties(code_dtype, n, m, b, k, tile):
    codes, s = _plant_ties(*_inputs(n, m, b, 3, code_dtype, seed=1))
    rv, ri = (np.asarray(a) for a in jops.pq_topk(
        jnp.asarray(codes), jnp.asarray(s), k, tile=tile, interpret=True))
    v, i = tops.pq_topk(_t(codes), _t(s), k, tile=tile)
    np.testing.assert_array_equal(v.numpy(), rv)
    np.testing.assert_array_equal(i.numpy(), ri)
    assert list(ri[0, :3]) == [3, n // 2, n - 1]       # lowest id first
    pv, pi = tref.pq_topk(_t(codes), _t(s), k)
    np.testing.assert_array_equal(pv.numpy(), rv)
    np.testing.assert_array_equal(pi.numpy(), ri)


def test_pq_topk_slots_match_fused_call_with_sentinels():
    """Slot level, as the fused kernel writes it: a hand-made tile list with
    ``-1`` sentinel slots and the all-padding tile past the catalogue."""
    n, m, b, k, tile, bt = 1000, 4, 64, 5, 128, 8
    codes, s = _plant_ties(*_inputs(n, m, b, 6, "uint8", seed=2))
    tile_idx = np.array([0, 5, -1, 7, 3, tops.sentinel_tile(n, tile), -1],
                        np.int32)
    jc = jops._pad_codes(jnp.asarray(codes), tile, sentinel=True)
    js = jops._pad_batch(jnp.asarray(s), bt)
    rv, ri = (np.asarray(a)[:6] for a in jkernel.pq_topk_fused_call(
        jc, js, k, tile_idx=jnp.asarray(tile_idx), n_items=n, tile=tile,
        batch_tile=bt, interpret=True))
    v, i = tops.pq_topk_slots(_t(codes), _t(s), k, _t(tile_idx), n_items=n,
                              tile=tile)
    np.testing.assert_array_equal(v.numpy(), rv)
    np.testing.assert_array_equal(i.numpy(), ri)
    assert np.all(rv[:, 2] == -np.inf) and np.all(ri[:, 2] == n)
    assert np.all(rv[:, 5] == -np.inf)
    mv, mi = tops._merge_slot_winners(v, i, k)
    jv, ji = jops._merge_slot_winners(jnp.asarray(rv), jnp.asarray(ri), k)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))


def test_tile_rule_and_padding_helpers():
    for n in (1, 127, 128, 1000, 2048, 5000, 1_271_638):
        for tile in (128, 2048):
            assert tops.n_tiles(n, tile) == jops.n_tiles(n, tile)
            assert tops.sentinel_tile(n, tile) == jops.sentinel_tile(n, tile)
    for bq in (1, 7, 8, 64, 200):
        assert tops.effective_batch_tile(bq) == jops.effective_batch_tile(bq)
    codes, s = _inputs(300, 3, 16, 5, "uint16")
    for sentinel in (False, True):
        np.testing.assert_array_equal(
            tops._pad_codes(_t(codes), 128, sentinel=sentinel).numpy(),
            np.asarray(jops._pad_codes(jnp.asarray(codes), 128,
                                       sentinel=sentinel)))
    np.testing.assert_array_equal(tops._pad_batch(_t(s), 8).numpy(),
                                  np.asarray(jops._pad_batch(jnp.asarray(s),
                                                             8)))
    with pytest.raises(ValueError, match="k=129 > tile=128"):
        tops.pq_topk(_t(codes[:100]), _t(s), 129)


def test_cuda_wrappers_refuse_cpu_tensors():
    codes, s = _inputs(100, 3, 16, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.pq_scores_cuda(_t(codes), _t(s))
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.pq_topk_fused_cuda(_t(codes), _t(s), 3,
                                   torch.zeros(1, dtype=torch.int32),
                                   n_items=100, tile=128)
    assert tkernel.pq_scores_cuda.launches == 0
    assert tkernel.pq_topk_fused_cuda.launches == 0


def _config_widths():
    """(arch, m, b, code bytes, N) of every config the port ships (an
    LM's PQ head scores its vocabulary)."""
    out = []
    for arch in sorted(tconfigs._REGISTRY):
        model = tconfigs.get_config(arch).model
        lm = isinstance(model, tconfigs.LMConfig)
        pq = model.pq_head if lm else model.pq
        out.append((arch, pq.m, pq.b, np.dtype(pq.code_dtype).itemsize,
                    model.vocab if lm else model.n_items))
    return out


@pytest.mark.parametrize("arch,m,b,code_bytes,n", _config_widths())
def test_launch_plan_fits_every_config(arch, m, b, code_bytes, n):
    """Every config's catalogue gets a plan within the card's shared memory
    at B=1 and 64: the scores kernel, the fused kernel's 1D form and its 2D
    form at batch tiles 8, 16 and 128, with and without the live mask; the
    layout's regions do not overlap and QB divides the batch tile."""
    tile = min(tkernel.DEFAULT_TILE, -(-n // 128) * 128)
    for bq in (1, 64):
        plans = [tkernel.plan_launch("scores", m=m, b=b, bq=bq,
                                     code_bytes=code_bytes, n=n)]
        for bt in (0, 8, 16, 128):
            for live in (False, True):
                plan = tkernel.plan_launch(
                    "fused", m=m, b=b, bq=bq, code_bytes=code_bytes,
                    tile=tile, batch_tile=bt, live=live)
                assert bt == 0 or bt % plan.qb == 0
                assert plan.sc_off >= plan.qb * m * b * 4
                assert plan.cand_off - plan.sc_off == 2 * plan.qb * tile * 4
                assert plan.chunk <= tile
                if live:
                    assert plan.stage_bytes - plan.live_off >= plan.chunk + 15
                plans.append(plan)
        for plan in plans:
            assert plan.smem <= tkernel.MAX_SMEM
            assert plan.blocks_per_sm >= 1
            assert plan.qb == (1 if bq == 1 else 4)
            assert plan.smem == plan.ring_off + plan.depth * plan.stage_bytes
            assert plan.depth >= 2
            assert all(x % 16 == 0 for x in (plan.ring_off, plan.stage_bytes,
                                             plan.live_off))
            assert plan.live_off >= plan.chunk * m * code_bytes + 15
    # The main path's plans: QB=4, whole 2048-row tiles in the ring (two
    # stages for the fused kernel, whose score buffers take the room of a
    # third; four, the ring budget, for the scores kernel), one 512-thread
    # block an SM.
    if arch == "sasrec-recjpq":
        fused = tkernel.plan_launch("fused", m=m, b=b, bq=64,
                                    code_bytes=code_bytes, tile=tile)
        assert (fused.qb, fused.chunk, fused.depth,
                fused.blocks_per_sm) == (4, 2048, 2, 1)
        scores = tkernel.plan_launch("scores", m=m, b=b, bq=64,
                                     code_bytes=code_bytes, n=n)
        assert (scores.qb, scores.chunk, scores.depth,
                scores.blocks_per_sm) == (4, 2048, 4, 1)


@pytest.mark.parametrize("tile", [683, 1001, 1025, 2047])
@pytest.mark.parametrize("bq", [1, 2, 64])
def test_launch_plan_aligns_odd_tiles(tile, bq):
    """Tiles that are not multiples of 4 (a small catalogue's pruning tile,
    a sharded state's tile split into parts): the score buffers are padded
    to the 16-byte grid, so the candidate buffers and the ring stay on it
    at every QB (the kernel refuses a plan whose ring is off it)."""
    for live in (False, True):
        plan = tkernel.plan_launch("fused", m=8, b=512, bq=bq, code_bytes=2,
                                   tile=tile, live=live)
        need = 2 * plan.qb * tile * 4
        assert 0 <= plan.cand_off - plan.sc_off - need < 16
        assert plan.cand_off % 16 == 0 and plan.ring_off % 16 == 0
        assert plan.ring_off - plan.cand_off >= tkernel.CANDS_BYTES


@pytest.mark.parametrize("bq,batch_tile,qb", [
    (1, 0, 1), (2, 0, 2), (3, 0, 2), (4, 0, 4), (9, 0, 4), (65, 0, 4),
    (64, 8, 4), (64, 6, 2), (64, 5, 1), (3, 8, 2), (1, 16, 1)])
def test_launch_plan_lane_layout(bq, batch_tile, qb):
    """QB is the largest of 4, 2, 1 that the batch fills and that divides
    the 2D table's batch tile (a query chunk never straddles two rows)."""
    plan = tkernel.plan_launch("fused", m=8, b=512, bq=bq, code_bytes=2,
                               tile=2048, batch_tile=batch_tile)
    assert plan.qb == qb


def test_launch_plan_shrinks_the_ring_then_refuses():
    """Wide rows shrink the ring's chunks below the tile; a shape whose S
    does not fit for one query even with the smallest ring raises before
    any launch."""
    plan = tkernel.plan_launch("fused", m=64, b=512, bq=64, code_bytes=4,
                               tile=2048)
    assert plan.qb == 1 and plan.chunk < 2048
    assert plan.smem <= tkernel.MAX_SMEM
    for kind in ("scores", "fused"):
        with pytest.raises(ValueError, match="no launch plan fits"):
            tkernel.plan_launch(kind, m=64, b=1024, bq=1, code_bytes=4,
                                n=5000, tile=2048)
    with pytest.raises(ValueError, match="unknown kernel"):
        tkernel.plan_launch("dense", m=8, b=512, bq=1, code_bytes=2)


def test_build_line_targets_hopper_without_fast_math(tmp_path):
    cmd = tkernel.nvcc_command(tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-O3" in cmd and "-shared" in cmd
    assert not any("fast" in a or "ftz" in a for a in cmd)
    assert tkernel.SOURCE.exists()
    assert str(tkernel.SOURCE) == cmd[-1]


def _table_2d(n_tiles, bt_rows, n_slots, seed):
    """A 2D tile table whose rows differ: ascending survivors, then ``-1``
    tails of different lengths (one row all ``-1``)."""
    rng = np.random.default_rng(seed)
    table = np.full((bt_rows, n_slots), -1, np.int32)
    for j in range(bt_rows - 1):
        live = np.sort(rng.choice(n_tiles, size=n_slots - j - 1,
                                  replace=False))
        table[j, :len(live)] = live
    return table


@pytest.mark.parametrize("bt,k", [(8, 1), (8, 5), (16, 16)])
def test_pq_topk_slots_2d_matches_fused_call(bt, k):
    """The 2D (batch tile, slot) table at slot level: batch tile j's
    queries score row j; ``-1`` entries emit (-inf, N)."""
    n, m, b, tile = 1000, 4, 64, 128
    n_rows = 3
    bq = n_rows * bt
    codes, s = _plant_ties(*_inputs(n, m, b, bq, "uint8", seed=3))
    table = _table_2d(tops.n_tiles(n, tile), n_rows, 6, seed=bt + k)
    jc = jops._pad_codes(jnp.asarray(codes), tile, sentinel=True)
    rv, ri = (np.asarray(a) for a in jkernel.pq_topk_fused_call(
        jc, jnp.asarray(s), k, tile_idx=jnp.asarray(table), n_items=n,
        tile=tile, batch_tile=bt, interpret=True))
    v, i = tops.pq_topk_slots(_t(codes), _t(s), k, _t(table), n_items=n,
                              tile=tile, batch_tile=bt)
    np.testing.assert_array_equal(v.numpy(), rv)
    np.testing.assert_array_equal(i.numpy(), ri)
    assert np.all(rv[-bt:] == -np.inf) and np.all(ri[-bt:] == n)
    with pytest.raises(ValueError, match="rows"):
        tops.pq_topk_slots(_t(codes), _t(s), k, _t(table[:2]), n_items=n,
                           tile=tile, batch_tile=bt)


@pytest.mark.parametrize("grouped", [False, True])
def test_pq_topk_tiles_and_ladder_match_reference(grouped):
    """The cascade's scoring stage: compacted lists (1D with ``-1`` tails,
    or 2D rows), merged across slots, against the reference's route; and
    the rung the ladder takes for a survivor count."""
    n, m, b, k, bq = 5000, 4, 64, 7, 24
    codes, s = _plant_ties(*_inputs(n, m, b, bq, "int32", seed=4))
    tile = 512
    nt = tops.n_tiles(n, tile)
    bt = tops.group_batch_tile(bq, 8)
    if grouped:
        full = _table_2d(nt, bq // bt, nt, seed=5)
        full[:, 0] = 0                   # every row holds the tied row 3
        full[-1, 1:] = -1
    else:
        full = np.full(nt, -1, np.int32)
        full[:4] = [0, 2, 5, nt - 1]
    jc, js = jnp.asarray(codes), jnp.asarray(s)
    rv, ri = (np.asarray(a) for a in jops.pq_topk_tiles(
        jc, js, k, jnp.asarray(full), tile=tile, batch_tile=bt))
    v, i = tops.pq_topk_tiles(_t(codes), _t(s), k, _t(full), tile=tile,
                              batch_tile=bt)
    np.testing.assert_array_equal(v.numpy(), rv)
    np.testing.assert_array_equal(i.numpy(), ri)
    assert ri[0, 0] == 3                 # tied rows: the lowest id first
    budgets = (2, 4, nt)
    lists = [full[..., :r] for r in budgets]
    for count in (0, 2, 3, 4, 5, nt):
        jv, ji, jr = jops.pq_topk_tiles_ladder(
            jc, js, k, [jnp.asarray(x) for x in lists], jnp.int32(count),
            tile=tile, batch_tile=bt)
        tv, ti, tr = tops.pq_topk_tiles_ladder(
            _t(codes), _t(s), k, [_t(x) for x in lists], count, tile=tile,
            batch_tile=bt)
        assert tr == int(jr)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _live_mask(n, tile, seed):
    """~10% random tombstones, tile 1 fully dead, and the three tied rows
    (3, N/2, N-1) dead: the masked winners must come from inside the
    tiles, past the dead top scorers."""
    live = np.random.default_rng(seed).random(n) > 0.1
    live[tile:2 * tile] = False
    live[[3, n // 2, n - 1]] = False
    return live


def _jax_live(live, n_padded, tile):
    """The reference kernel's (N/tile, tile) int8 layout: padding rows
    dead."""
    lv = np.zeros(n_padded, np.int8)
    lv[:live.shape[0]] = live
    return jnp.asarray(lv.reshape(-1, tile))


@pytest.mark.parametrize("form", ["identity", "sentinel", "2d"])
def test_pq_topk_slots_live_matches_fused_call(form):
    """Form (d), the tombstone mask, at slot level in each list form: dead
    rows score -inf inside the tile top-k, before the per-slot
    selection."""
    n, m, b, k, tile, bt = 1000, 4, 64, 5, 128, 8
    codes, s = _plant_ties(*_inputs(n, m, b, 2 * bt, "uint16", seed=9))
    live = _live_mask(n, tile, seed=10)
    nt = tops.n_tiles(n, tile)
    if form == "identity":
        tile_idx, batch_tile = np.arange(nt, dtype=np.int32), 0
    elif form == "sentinel":
        tile_idx = np.array([0, 1, 3, nt - 1, -1, -1], np.int32)
        batch_tile = 0
    else:
        tile_idx, batch_tile = _table_2d(nt, 2, 5, seed=11), bt
        tile_idx[0, :2] = [0, 1]
    jc = jops._pad_codes(jnp.asarray(codes), tile, sentinel=True)
    rv, ri = (np.asarray(a) for a in jkernel.pq_topk_fused_call(
        jc, jnp.asarray(s), k, tile_idx=jnp.asarray(tile_idx), n_items=n,
        tile=tile, batch_tile=bt, live=_jax_live(live, jc.shape[0], tile),
        interpret=True))
    v, i = tops.pq_topk_slots(_t(codes), _t(s), k, _t(tile_idx), n_items=n,
                              tile=tile, batch_tile=batch_tile,
                              live=_t(live))
    np.testing.assert_array_equal(v.numpy(), rv)
    np.testing.assert_array_equal(i.numpy(), ri)
    got = i.numpy()[np.isfinite(v.numpy())]
    assert got.size and live[got].all()
    assert not np.array_equal(v.numpy(), tops.pq_topk_slots(
        _t(codes), _t(s), k, _t(tile_idx), n_items=n, tile=tile,
        batch_tile=batch_tile)[0].numpy())


@pytest.mark.parametrize("grouped", [False, True])
def test_pq_topk_tiles_live_matches_reference(grouped):
    """The scoring stage with the mask, merged across slots: ``-inf``
    winners (a tile list holding fewer than k live items) get the id N on
    both sides."""
    n, m, b, k, bq, tile = 3000, 4, 64, 7, 16, 256
    codes, s = _plant_ties(*_inputs(n, m, b, bq, "int32", seed=12))
    live = _live_mask(n, tile, seed=13)
    live[:tile] = False
    live[5] = True                     # tile 0 holds one live item
    nt = tops.n_tiles(n, tile)
    bt = tops.group_batch_tile(bq, 2)
    if grouped:
        idx = np.full((bq // bt, nt), -1, np.int32)
        idx[0, :1] = [0]                # one live item for this row
        idx[1, :3] = [0, 2, nt - 1]
    else:
        idx = np.full(nt, -1, np.int32)
        idx[:2] = [0, 1]                # one live item in all
    rv, ri = (np.asarray(a) for a in jops.pq_topk_tiles(
        jnp.asarray(codes), jnp.asarray(s), k, jnp.asarray(idx), tile=tile,
        batch_tile=bt, live=jnp.asarray(live)))
    v, i = tops.pq_topk_tiles(_t(codes), _t(s), k, _t(idx), tile=tile,
                              batch_tile=bt, live=_t(live))
    np.testing.assert_array_equal(v.numpy(), rv)
    np.testing.assert_array_equal(i.numpy(), ri)
    assert (i.numpy()[:bt, 1:] == n).all() and (i.numpy()[:bt, 0] == 5).all()
    with pytest.raises(ValueError, match="live mask shape"):
        tops.pq_topk_tiles(_t(codes), _t(s), k, _t(idx), tile=tile,
                           batch_tile=bt, live=_t(live[:-1]))


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _reference_slots(scores, tile_idx, k, n, tile):
    """The reference fused kernel's per-slot selection (its ``_tile_topk``
    over each tile, rows past ``n`` masked to ``-inf``, global ids; a
    ``-1`` slot gives ``(-inf, n)``) on given scores (B, N)."""
    bq = scores.shape[0]
    padded = jnp.pad(scores, ((0, 0), (0, (-n) % tile + tile)),
                     constant_values=0.0)
    blocks = jkernel.pick_blocks(tile, k)
    vs, ids = [], []
    for t in tile_idx.tolist():
        if t < 0:
            vs.append(jnp.full((bq, k), -jnp.inf, jnp.float32))
            ids.append(jnp.full((bq, k), n, jnp.int32))
            continue
        col = t * tile + jnp.arange(tile)
        sc = jnp.where(col[None, :] < n, padded[:, t * tile:(t + 1) * tile],
                       -jnp.inf)
        v, c = jkernel._tile_topk(sc, k, blocks)
        vs.append(v)
        ids.append(c + t * tile)
    return (np.asarray(jnp.stack(vs, 1)), np.asarray(jnp.stack(ids, 1)))


@pytest.mark.parametrize("code_dtype,n,m,b,tile", [
    ("uint8", 1000, 4, 64, 128), ("int32", 1500, 1, 16, 256),
    ("uint16", 2100, 8, 512, 1024)])
def test_planted_specials_follow_lax_top_k_order(code_dtype, n, m, b, tile):
    """Scores at -0.0, +0.0, +-NaN and +-inf (``ref.plant_specials``): the
    port's scores against the reference's jnp oracle (``score_pqtopk``),
    its per-slot winners (identity list and a ``-1`` sentinel) against the
    reference kernel's selection (``_tile_topk``) on those scores, its
    cross-slot merge against the reference's, and its global top-k
    against ``lax.top_k``: value bits and ids, atol=0.  The last slot's
    top-k passes the ``-inf`` padding, which ranks below real -inf items
    and above real -NaN ones.

    The reference's Pallas kernels score with one-hot products, where
    0 * inf is NaN and a +0.0 product turns a -0.0 sum into +0.0, so on
    these inputs they depart from their own oracle; the port's kernels
    gather, as the oracle does, and are held to it."""
    from repro.core import scoring as jscoring, topk as jtopk
    codes, s = tref.plant_specials(*_inputs(n, m, b, 3, code_dtype, seed=7),
                                   tile)
    jc, js = jnp.asarray(codes), jnp.asarray(s)
    tc, ts = _t(codes), _t(s)
    want = jscoring.score_pqtopk(jc, js)
    for got in (tops.pq_scores(tc, ts), tref.pq_scores(tc, ts)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    planted = {int(x) for x in np.unique(_bits(want))}
    assert {0x80000000, 0, 0x7f800000, 0xff800000} <= planted
    assert {0x7fc00000, 0xffc00000} <= planted          # +NaN and -NaN
    nt = tops.n_tiles(n, tile)
    idx = np.array(list(range(nt)) + [-1], np.int32)
    for k in (5, 16, 100):
        rv, ri = (np.asarray(a) for a in jtopk.topk(want, k))
        for v, i in (tops.pq_topk(tc, ts, k, tile=tile),
                     tref.pq_topk(tc, ts, k)):
            np.testing.assert_array_equal(_bits(v.numpy()), _bits(rv))
            np.testing.assert_array_equal(i.numpy(), ri)
        sv, si = _reference_slots(want, idx, k, n, tile)
        v, i = tops.pq_topk_slots(tc, ts, k, _t(idx), n_items=n, tile=tile)
        np.testing.assert_array_equal(_bits(v.numpy()), _bits(sv))
        np.testing.assert_array_equal(i.numpy(), si)
        mv, mi = tops._merge_slot_winners(v, i, k)
        jv, ji = jops._merge_slot_winners(jnp.asarray(sv), jnp.asarray(si), k)
        np.testing.assert_array_equal(_bits(mv.numpy()), _bits(jv))
        np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(mi.numpy(), ri)
    # The last real slot at k=100: real -inf items, then the padding ids
    # (>= n, also -inf), then real -NaN items.
    lv, li = _bits(sv[0, nt - 1]), si[0, nt - 1]
    pad = np.flatnonzero(li >= n)
    assert pad.size and (lv[pad] == 0xff800000).all()
    assert (lv[:pad[0]][-3:] == 0xff800000).all()
    assert (lv[pad[-1] + 1:] > 0xff800000).all()       # -NaN bits
