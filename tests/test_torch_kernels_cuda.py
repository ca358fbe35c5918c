"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no JAX, so it runs on a GPU host without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Every test here needs a CUDA device and skips on a host without one."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import kernel as eb_kernel
from repro_torch.kernels.embedding_bag import ops as eb_ops, ref as eb_ref
from repro_torch.kernels.pqtopk import kernel as tkernel, ops as tops
from repro_torch.kernels.pqtopk import ref as tref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits_equal(got, want):
    """Bit for bit, NaN payloads and signed zeros included."""
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


def _inputs(n, m, b, bq, code_dtype, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b, (n, m)).astype(code_dtype)
    codes[[n // 2, n - 1]] = codes[3]                    # tied rows
    s = rng.standard_normal((bq, m, b)).astype(np.float32)
    s[0, np.arange(m), codes[3].astype(np.int64)] = 50.0
    return torch.from_numpy(codes), torch.from_numpy(s)


@pytest.mark.parametrize("code_dtype,n,m,b", [
    ("int8", 777, 8, 128), ("uint8", 4097, 3, 100), ("uint16", 5001, 8, 512),
    ("int32", 513, 5, 100), ("int32", 3001, 2, 256), ("int32", 3001, 4, 256),
    ("int32", 3001, 6, 256), ("int32", 2049, 8, 256)])
def test_kernels_match_plain_versions(cuda_device, code_dtype, n, m, b):
    codes, s = _inputs(n, m, b, 11, code_dtype, seed=5)
    gc, gs = codes.to(cuda_device), s.to(cuda_device)
    before = tkernel.pq_scores_cuda.launches
    torch.testing.assert_close(tops.pq_scores(gc, gs).cpu(),
                               tref.pq_scores(codes, s), rtol=0, atol=0)
    assert tkernel.pq_scores_cuda.launches == before + 1
    tile = min(2048, -(-n // 128) * 128)
    idx = torch.tensor(list(range(tops.n_tiles(n, tile))) + [-1],
                       dtype=torch.int32)
    got = tops.pq_topk_slots(gc, gs, 16, idx.to(cuda_device), n_items=n,
                             tile=tile)
    want = tref.pq_topk_slots(codes, s, 16, idx, n_items=n, tile=tile)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    v, i = tops.pq_topk(gc, gs, 10)
    assert i[0, :3].tolist() == [3, n // 2, n - 1]


@pytest.mark.parametrize("bt,k,tile", [(8, 1, 2048), (8, 16, 1000),
                                       (16, 100, 256)])
def test_fused_kernel_2d_table_matches_plain_version(cuda_device, bt, k,
                                                     tile):
    """The 2D (batch tile, slot) table: rows that differ, ``-1`` tails,
    an all-``-1`` row, a ragged last batch tile, any tile width."""
    n, m, b = 20_011, 8, 512
    codes, s = _inputs(n, m, b, 3 * bt - 3, "uint16", seed=7)
    nt = tops.n_tiles(n, tile)
    rng = np.random.default_rng(bt + k)
    table = np.full((3, 6), -1, np.int32)
    table[0] = np.sort(rng.choice(nt, 6, replace=False))
    table[1, :3] = np.sort(rng.choice(nt, 3, replace=False))
    idx = torch.from_numpy(table)
    gc, gs, gi = (t.to(cuda_device) for t in (codes, s, idx))
    before = (tkernel.pq_topk_fused_cuda.launches,
              tkernel.pq_topk_fused_cuda.launches_2d)
    got = tops.pq_topk_slots(gc, gs, k, gi, n_items=n, tile=tile,
                             batch_tile=bt)
    want = tref.pq_topk_slots(codes, s, k, idx, n_items=n, tile=tile,
                              batch_tile=bt)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    assert (tkernel.pq_topk_fused_cuda.launches,
            tkernel.pq_topk_fused_cuda.launches_2d) == (before[0],
                                                        before[1] + 1)
    with pytest.raises(ValueError, match="rows"):
        tkernel.pq_topk_fused_cuda(gc, gs, k, gi[:1].contiguous(),
                                   n_items=n, tile=tile, batch_tile=bt)


@pytest.mark.parametrize("m", [2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("bq", [1, 3, 9, 65])
def test_lane_layouts_match_plain_versions(cuda_device, m, bq):
    """Each width instance (m = 2, 4, 6, 8; the generic path at 3 and 5)
    at the lane layouts' edges: B=1 (QB=1), 3 (QB=2), 9 and 65 (a last
    query chunk of one query); both kernels, the fused one on a list with
    ``-1`` slots and a ragged last tile at k = 1, 16, 100, on 2D tables at
    batch tiles 8 and 16, and with the ``live`` mask."""
    n, b, tile = 5003, 256, 2048
    codes, s = _inputs(n, m, b, bq, "int32", seed=100 * m + bq)
    gc, gs = codes.to(cuda_device), s.to(cuda_device)
    torch.testing.assert_close(tops.pq_scores(gc, gs).cpu(),
                               tref.pq_scores(codes, s), rtol=0, atol=0)
    nt = tops.n_tiles(n, tile)
    idx = torch.tensor([0, -1, nt - 1, 1], dtype=torch.int32)
    live = torch.from_numpy(np.random.default_rng(m + bq).random(n) > 0.2)
    for k in (1, 16, 100):
        for lv in (None, live):
            got = tops.pq_topk_slots(
                gc, gs, k, idx.to(cuda_device), n_items=n, tile=tile,
                live=None if lv is None else lv.to(cuda_device))
            want = tref.pq_topk_slots(codes, s, k, idx, n_items=n, tile=tile,
                                      live=lv)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    for bt in (8, 16):
        rows = -(-bq // bt)
        table = np.full((rows, 3), -1, np.int32)
        table[0] = [0, 2, 1]
        table[rows - 1, :1] = [nt - 1]
        table = torch.from_numpy(table)
        for k in (1, 16, 100):
            got = tops.pq_topk_slots(gc, gs, k, table.to(cuda_device),
                                     n_items=n, tile=tile, batch_tile=bt)
            want = tref.pq_topk_slots(codes, s, k, table, n_items=n,
                                      tile=tile, batch_tile=bt)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


def test_pruned_cascade_matches_exhaustive_route(cuda_device):
    """The cascade on the card, batch-any (1D list with ``-1`` tail) and
    grouped (2D table), against the exhaustive fused route, bit for bit."""
    from repro_torch.core import pruning
    n, m, b, bq = 40_000, 8, 256, 24
    rng = np.random.default_rng(9)
    centers = (np.arange(n) / n * b).astype(np.int64)
    codes = torch.from_numpy(np.clip(
        centers[:, None] + rng.integers(-1, 2, (n, m)), 0, b - 1
    ).astype(np.uint8)).to(cuda_device)
    g = rng.standard_normal((bq, m, b))
    g = np.sign(g) * np.abs(g) ** 3
    for q in range(bq):
        w = (q * b) // bq
        g[q, :, max(0, w - 1):w + 3] += 6.0
    s = torch.from_numpy(g.astype(np.float32)).to(cuda_device)
    ev, ei = tops.pq_topk(codes, s, 10)
    for backend in ("bitmask", "range"):
        state = pruning.build_pruned_state(codes, b, backend=backend)
        for grouped in (False, True):
            v, i, st = pruning.cascade_topk_ingraph(
                codes, s, 10, state, ladder=(2, 8), query_grouping=grouped,
                return_stats=True)
            assert torch.equal(v, ev) and torch.equal(i, ei)
            assert st["n_groups"] == (3 if grouped else 1)


@pytest.mark.parametrize("form,tile", [("identity", 2048), ("sentinel", 1000),
                                       ("2d", 2048), ("2d", 1000)])
def test_fused_kernel_live_matches_plain_version(cuda_device, form, tile):
    """Form (d), the tombstone mask, in each list form: ~10% random
    tombstones, one fully dead tile and dead capacity padding; counted in
    ``launches_live`` only."""
    n_real, cap, m, b, bt = 9_001, 16_384, 8, 512, 8
    codes, s = _inputs(cap, m, b, 2 * bt + 3, "uint16", seed=11)
    rng = np.random.default_rng(12)
    live = torch.from_numpy(rng.random(cap) > 0.1)
    live[n_real:] = False                           # capacity padding
    live[tile:2 * tile] = False                     # one dead tile
    live[3] = False                                 # a dead top scorer
    nt = tops.n_tiles(cap, tile)
    if form == "identity":
        idx, batch_tile = torch.arange(nt, dtype=torch.int32), 0
    elif form == "sentinel":
        idx = torch.tensor([0, 1, 4, nt - 1, -1, -1], dtype=torch.int32)
        batch_tile = 0
    else:
        table = np.full((3, 5), -1, np.int32)
        table[0] = [0, 1, 2, 4, nt - 1]
        table[1, :2] = [1, 3]
        idx, batch_tile = torch.from_numpy(table), bt
    gc, gs, gi, gl = (t.to(cuda_device) for t in (codes, s, idx, live))
    before = (tkernel.pq_topk_fused_cuda.launches,
              tkernel.pq_topk_fused_cuda.launches_2d,
              tkernel.pq_topk_fused_cuda.launches_live)
    for k in (1, 16, 100):
        got = tops.pq_topk_slots(gc, gs, k, gi, n_items=cap, tile=tile,
                                 batch_tile=batch_tile, live=gl)
        want = tref.pq_topk_slots(codes, s, k, idx, n_items=cap, tile=tile,
                                  batch_tile=batch_tile, live=live)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
        ids = want[1][torch.isfinite(want[0])]
        assert live[ids.long()].all()
    assert (tkernel.pq_topk_fused_cuda.launches,
            tkernel.pq_topk_fused_cuda.launches_2d,
            tkernel.pq_topk_fused_cuda.launches_live) == (
                before[0], before[1], before[2] + 3)
    with pytest.raises(ValueError, match="live"):
        tkernel.pq_topk_fused_cuda(gc, gs, 4, gi, n_items=cap, tile=tile,
                                   batch_tile=batch_tile, live=gl[:-1])


def test_mutable_cascade_matches_masked_oracle(cuda_device):
    """The live-masked cascade on the card after churn, batch-any and
    grouped, against the exhaustive masked route, bit for bit."""
    from repro_torch.core import pruning
    from repro_torch.core.mutation import MutableHeadState
    n, m, b, bq = 30_000, 8, 256, 24
    rng = np.random.default_rng(13)
    centers = (np.arange(n) / n * b).astype(np.int64)
    codes = torch.from_numpy(np.clip(
        centers[:, None] + rng.integers(-1, 2, (n, m)), 0, b - 1
    ).astype(np.uint16)).to(cuda_device)
    for backend in ("bitmask", "range"):
        mstate = MutableHeadState.build(codes, b, backend=backend)
        for iid in rng.choice(np.arange(1, n), 3000, replace=False):
            mstate.delete(int(iid))
        for _ in range(50):
            mstate.insert(rng.integers(0, b, m))
        s = torch.from_numpy(rng.standard_normal((bq, m, b)).astype(
            np.float32)).to(cuda_device)
        sc = torch.where(mstate.live[None, :],
                         tref.pq_scores(mstate.codes, s), float("-inf"))
        ov, oi = tops._merge_slot_winners(sc[:, None, :], torch.arange(
            mstate.cap, dtype=torch.int32, device=cuda_device).expand(
                bq, 1, -1), 10)
        for grouped in (False, True):
            v, i = pruning.cascade_topk_ingraph(
                mstate.codes, s, 10, mstate.state, live=mstate.live,
                query_grouping=grouped, ladder=(4, 8))
            assert torch.equal(v, ov) and torch.equal(i, oi)


def _clustered(n, m, b, grain, seed):
    """A tile-coherent uint8 catalogue and S decaying in the code index
    (the hierarchical route's regime; ``examples/billion_item_sim``)."""
    from repro_torch.examples import billion_item_sim as sim
    return (torch.from_numpy(sim.make_clustered_codes(n, m, b, grain,
                                                      seed=seed)),
            sim.make_popularity_scores(3, m, b, seed=seed))


@pytest.mark.parametrize("backend", ["bitmask", "range"])
def test_hier_cascade_matches_exhaustive_route(cuda_device, backend):
    """Flat and hierarchical cascades on the card, bit-identical to the
    one-shot fused route and to each other; the hierarchical one gathers
    fewer bounds and launches form (b) once and ``pq_scores`` once."""
    from repro_torch.core import pruning
    n, m, b, tile, factor = 300_001, 8, 256, 1024, 16
    codes, s = _clustered(n, m, b, tile * factor, seed=3)
    codes, s = codes.to(cuda_device), s.to(cuda_device)
    ev, ei = tops.pq_topk(codes, s, 10)
    flat = pruning.build_pruned_state(codes, b, tile, backend=backend)
    hier = pruning.with_super(flat, factor)
    fv, fi, fst = pruning.cascade_topk_ingraph(codes, s, 10, flat,
                                               return_stats=True)
    before = (tkernel.pq_topk_fused_cuda.launches,
              tkernel.pq_scores_cuda.launches)
    hv, hi, hst = pruning.cascade_topk_ingraph(codes, s, 10, hier,
                                               return_stats=True)
    assert (tkernel.pq_topk_fused_cuda.launches,
            tkernel.pq_scores_cuda.launches) == (before[0] + 1,
                                                 before[1] + 1)
    for v, i in ((fv, fi), (hv, hi)):
        assert torch.equal(v, ev) and torch.equal(i, ei)
    assert hst["bounds_computed"] < fst["bounds_computed"] == flat.n_tiles
    assert hst["n_survived"] == fst["n_survived"]
    assert int(pruning.survival_count(codes, s, 10, hier)) == \
        hst["n_survived"]


def test_host_cascade_sentinel_tiles_match_plain_version(cuda_device):
    """The host cascade's slot list, padded with the past-the-end tile: the
    kernel against its plain version, and the cascade against the in-graph
    one and the exhaustive route."""
    from repro_torch.core import pruning
    n, m, b, tile = 200_003, 8, 256, 1024
    codes, s = _clustered(n, m, b, tile * 8, seed=4)
    gc, gs = codes.to(cuda_device), s.to(cuda_device)
    nt = tops.n_tiles(n, tile)
    idx = torch.tensor([0, 3, nt - 1, nt, nt, nt], dtype=torch.int32)
    for k in (1, 10, 100):
        got = tops.pq_topk_slots(gc, gs, k, idx.to(cuda_device), n_items=n,
                                 tile=tile)
        want = tref.pq_topk_slots(codes, s, k, idx, n_items=n, tile=tile)
        _bits_equal([g.cpu() for g in got], want)
    ev, ei = tops.pq_topk(gc, gs, 10)
    v, i, st = pruning.cascade_topk(gc, gs, 10, tile=tile,
                                    return_stats=True)
    iv, ii = pruning.cascade_topk_ingraph(
        gc, gs, 10, pruning.build_pruned_state(gc, b, tile))
    assert torch.equal(v, ev) and torch.equal(i, ei)
    assert torch.equal(iv, ev) and torch.equal(ii, ei)
    assert st["n_scored"] > st["n_survived"]       # sentinel tiles listed


def test_mutable_super_cascade_matches_masked_oracle(cuda_device):
    """A mutable catalogue with a super level on the card, after churn:
    the hierarchical masked cascade (form d) against the exhaustive masked
    route, and a full retighten against the oracle at both levels."""
    from repro_torch.core import pruning
    from repro_torch.core.mutation import MutableHeadState
    n, m, b, bq = 30_000, 8, 256, 24
    rng = np.random.default_rng(14)
    codes = torch.from_numpy(rng.integers(0, b, (n, m)).astype(
        np.uint8)).to(cuda_device)
    for backend in ("bitmask", "range"):
        mstate = MutableHeadState.build(codes, b, tile=1024,
                                        backend=backend, super_factor=4)
        assert mstate.cap % 4096 == 0 and mstate.state.n_super == 8
        for iid in rng.choice(np.arange(1, n), 3000, replace=False):
            mstate.delete(int(iid))
        for _ in range(50):
            mstate.insert(rng.integers(0, b, m))
        s = torch.from_numpy(rng.standard_normal((bq, m, b)).astype(
            np.float32)).to(cuda_device)
        sc = torch.where(mstate.live[None, :],
                         tref.pq_scores(mstate.codes, s), float("-inf"))
        ov, oi = tops._merge_slot_winners(sc[:, None, :], torch.arange(
            mstate.cap, dtype=torch.int32, device=cuda_device).expand(
                bq, 1, -1), 10)
        before = tkernel.pq_topk_fused_cuda.launches_live
        v, i = pruning.cascade_topk_ingraph(
            mstate.codes, s, 10, mstate.state, live=mstate.live,
            ladder=(4, 8), super_ladder=(2,))
        assert tkernel.pq_topk_fused_cuda.launches_live == before + 1
        assert torch.equal(v, ov) and torch.equal(i, oi)
        mstate.retighten()
        want = mstate.rebuild_oracle()
        for f in ("packed", "code_lo", "code_hi", "super_packed",
                  "super_lo", "super_hi"):
            got, exp = getattr(mstate.state, f), getattr(want, f)
            assert (got is None) == (exp is None)
            assert got is None or torch.equal(got, exp), f


def test_stream_matches_one_shot_route(cuda_device):
    """The chunked stream (uint8 chunks, form a each, host merge) against
    the one-shot fused route over the whole catalogue on the card."""
    from repro_torch.examples import billion_item_sim as sim
    rng = np.random.default_rng(15)
    codes = rng.integers(0, 256, (1_000_003, 8), dtype=np.uint8)
    s = torch.from_numpy(rng.standard_normal((2, 8, 256)).astype(
        np.float32)).to(cuda_device)
    before = tkernel.pq_topk_fused_cuda.launches
    v, i, n_chunks = sim.streaming_pqtopk(codes, s, 10, 300_000,
                                          id_base=2 ** 33)
    assert n_chunks == 4 and tkernel.pq_topk_fused_cuda.launches == \
        before + 4
    ov, oi = tops.pq_topk(torch.from_numpy(codes).to(cuda_device), s, 10)
    np.testing.assert_array_equal(v, ov.cpu().numpy())
    np.testing.assert_array_equal(i, oi.cpu().numpy().astype(np.int64)
                                  + 2 ** 33)


@pytest.mark.parametrize("v,d,n_bags,bag,mode,weighted", eb_ref.GRID)
def test_embedding_bag_matches_plain_version(cuda_device, v, d, n_bags, bag,
                                             mode, weighted):
    """Bit for bit: the kernel and its plain version take the same steps
    (slot order, product then add, IEEE division)."""
    rng = np.random.default_rng(v + d)
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, v, (n_bags, bag)).astype(
        np.int32))
    w = (torch.from_numpy(rng.uniform(0, 1, (n_bags, bag)).astype(
        np.float32)) if weighted else None)
    before = eb_kernel.embedding_bag_cuda.launches
    got = eb_ops.embedding_bag(table.to(cuda_device), idx.to(cuda_device),
                               None if w is None else w.to(cuda_device),
                               mode=mode)
    torch.cuda.synchronize()
    assert eb_kernel.embedding_bag_cuda.launches == before + 1
    torch.testing.assert_close(got.cpu(), eb_ref.embedding_bag(
        table, idx, w, mode), rtol=0, atol=0)


@pytest.mark.parametrize("v,d,n_bags,bag,mode,weighted", eb_ref.LAYOUT_GRID)
def test_embedding_bag_layouts_match_plain_version(
        cuda_device, v, d, n_bags, bag, mode, weighted):
    """The kernel's other layouts (``ref.LAYOUT_GRID``: batches past one
    wave of warps, 4-float loads, several passes over a wide row): bit
    for bit against the plain version."""
    rng = np.random.default_rng(v + d + n_bags)
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, v, (n_bags, bag)).astype(
        np.int32))
    w = (torch.from_numpy(rng.uniform(0, 1, (n_bags, bag)).astype(
        np.float32)) if weighted else None)
    table, idx = table.to(cuda_device), idx.to(cuda_device)
    w = None if w is None else w.to(cuda_device)
    _bits_equal((eb_ops.embedding_bag(table, idx, w, mode=mode),),
                (eb_ref.embedding_bag(table, idx, w, mode),))


def test_embedding_bag_all_padding_bag(cuda_device):
    table = torch.randn(32, 8, device=cuda_device)
    idx = torch.full((4, 3), -1, dtype=torch.int32, device=cuda_device)
    idx[1, 0] = 5
    for mode in ("sum", "mean"):
        out = eb_ops.embedding_bag(table, idx, mode=mode)
        assert torch.equal(out[[0, 2, 3]], torch.zeros(3, 8,
                                                       device=cuda_device))
        assert torch.equal(out[1], table[5])


def test_embedding_bag_launch_counter_and_refusals(cuda_device):
    table = torch.randn(50, 10, device=cuda_device)
    idx = torch.randint(-1, 50, (7, 4), dtype=torch.int32,
                        device=cuda_device)
    w = torch.rand(7, 4, device=cuda_device)
    before = eb_kernel.embedding_bag_cuda.launches
    eb_kernel.embedding_bag_cuda(table, idx, w, mode="sum")
    eb_kernel.embedding_bag_cuda(table, idx, w, mode="mean")
    assert eb_kernel.embedding_bag_cuda.launches == before + 2
    with pytest.raises(ValueError, match="CUDA device"):
        eb_kernel.embedding_bag_cuda(table.cpu(), idx.cpu(), w.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        eb_kernel.embedding_bag_cuda(table.t().contiguous().t(), idx, w)
    with pytest.raises(ValueError, match="float32"):
        eb_kernel.embedding_bag_cuda(table.double(), idx, w)
    with pytest.raises(ValueError, match="float32"):
        eb_kernel.embedding_bag_cuda(table, idx.long(), w)
    with pytest.raises(ValueError, match="mode"):
        eb_kernel.embedding_bag_cuda(table, idx, w, mode="max")
    with pytest.raises(ValueError, match="empty table"):
        eb_kernel.embedding_bag_cuda(table[:0], idx, w)
    assert eb_kernel.embedding_bag_cuda.launches == before + 2


@pytest.mark.parametrize("m,bq", [(1, 5), (4, 1), (8, 9), (8, 65)])
def test_planted_specials_match_plain_versions(cuda_device, m, bq):
    """Scores at -0.0, +0.0, +-NaN and +-inf (``ref.plant_specials``; at
    m = 1 a planted -NaN reaches the scores, at m > 1 the card's adds
    return +NaN): ``pq_scores`` and its top-k, and the fused kernel in all
    four forms, at k = 1, 16, 100, against the plain versions run on the
    card, bit for bit."""
    n, b, tile, bt = 9_001, 64, 2048, 8
    rng = np.random.default_rng(m + bq)
    codes, s = tref.plant_specials(
        rng.integers(0, b, (n, m)).astype(np.uint8),
        rng.standard_normal((bq, m, b)).astype(np.float32), tile, seed=m)
    gc = torch.from_numpy(codes).to(cuda_device)
    gs = torch.from_numpy(s).to(cuda_device)
    sc = tops.pq_scores(gc, gs)
    _bits_equal((sc,), (tref.pq_scores(gc, gs),))
    for k in (1, 16, 100):
        from repro_torch.core import topk as ttopk
        _bits_equal(ttopk.topk(sc, k), tref.pq_topk(gc, gs, k))
    nt = tops.n_tiles(n, tile)
    live = torch.from_numpy(rng.random(n) > 0.1).to(cuda_device)
    table = np.full((-(-bq // bt), 4), -1, np.int32)
    table[-1, :2] = [0, nt - 1]
    table[0] = [0, 1, 2, nt - 1]
    forms = [(torch.arange(nt, dtype=torch.int32), 0, None),
             (torch.tensor([nt - 1, -1, 0, -1], dtype=torch.int32), 0, None),
             (torch.from_numpy(table), bt, None),
             (torch.arange(nt, dtype=torch.int32), 0, live)]
    for idx, batch_tile, lv in forms:
        gi = idx.to(cuda_device)
        for k in (1, 16, 100):
            _bits_equal(
                tops.pq_topk_slots(gc, gs, k, gi, n_items=n, tile=tile,
                                   batch_tile=batch_tile, live=lv),
                tref.pq_topk_slots(gc, gs, k, gi, n_items=n, tile=tile,
                                   batch_tile=batch_tile, live=lv))
    _bits_equal(tops.pq_topk(gc, gs, 16), tref.pq_topk(gc, gs, 16))


@pytest.mark.parametrize("v,d,n_bags,bag,mode,weighted", eb_ref.ROW0_GRID)
def test_embedding_bag_nan_inf_row0(cuda_device, v, d, n_bags, bag, mode,
                                    weighted):
    """Row 0 holds NaN and +-inf: padded slots read it times 0, so the
    kernel and its plain version give NaN in the same places, bit for
    bit."""
    rng = np.random.default_rng(v + d + bag)
    table = eb_ref.plant_row0(torch.from_numpy(
        rng.standard_normal((v, d)).astype(np.float32)))
    idx = torch.from_numpy(rng.integers(-1, v, (n_bags, bag)).astype(
        np.int32))
    w = (torch.from_numpy(rng.uniform(0, 1, (n_bags, bag)).astype(
        np.float32)) if weighted else None)
    table, idx = table.to(cuda_device), idx.to(cuda_device)
    w = None if w is None else w.to(cuda_device)
    _bits_equal((eb_ops.embedding_bag(table, idx, w, mode=mode),),
                (eb_ref.embedding_bag(table, idx, w, mode),))


def _in_threads(fns):
    """Run each fn on a thread of its own; re-raise the first error."""
    import threading
    errors, threads = [], []
    for fn in fns:
        def run(fn=fn):
            try:
                fn()
            except BaseException as exc:      # re-raised below
                errors.append(exc)
        threads.append(threading.Thread(target=run))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "a launch thread hung"
    if errors:
        raise errors[0]


def test_fused_kernel_concurrent_streams_at_different_plans(cuda_device):
    """Two threads, each on its own stream, launch the fused kernel 200
    times each at batch sizes whose plans differ (QB 4, 2 and 1, with and
    without the live bytes: different shared-memory sizes); every output
    is bit-exact against the plain version and the counts are exact."""
    n, m, b, tile, k = 50_021, 8, 512, 2048, 16
    codes, s64 = _inputs(n, m, b, 64, "uint16", seed=21)
    gc = codes.to(cuda_device)
    idx = torch.arange(tops.n_tiles(n, tile), dtype=torch.int32,
                       device=cuda_device)
    live = (torch.rand(n, generator=torch.Generator().manual_seed(3)) > 0.2
            ).to(cuda_device)
    ss = {bq: s64[:bq].contiguous().to(cuda_device) for bq in (64, 2, 1)}
    plans = {(bq, lv): tkernel.plan_launch(
        "fused", m=m, b=b, bq=bq, code_bytes=2, tile=tile, live=lv).smem
        for bq in ss for lv in (False, True)}
    assert len(set(plans.values())) >= 4           # the race needs sizes
    want = {(bq, lv): tref.pq_topk_slots(gc, ss[bq], k, idx, n_items=n,
                                         tile=tile,
                                         live=live if lv else None)
            for bq in ss for lv in (False, True)}
    torch.cuda.synchronize()
    counts0 = (tkernel.pq_topk_fused_cuda.launches,
               tkernel.pq_topk_fused_cuda.launches_live)
    schedules = {0: [(64, False), (1, True), (2, False)],
                 1: [(2, True), (64, True), (1, False)]}
    outs = {0: [], 1: []}

    def worker(tid):
        stream = torch.cuda.Stream(cuda_device)
        with torch.cuda.stream(stream):
            for i in range(200):
                bq, lv = schedules[tid][i % 3]
                outs[tid].append(((bq, lv), tkernel.pq_topk_fused_cuda(
                    gc, ss[bq], k, idx, n_items=n, tile=tile,
                    live=live if lv else None)))
        stream.synchronize()

    _in_threads([lambda: worker(0), lambda: worker(1)])
    n_live = sum(schedules[tid][i % 3][1] for tid in (0, 1)
                 for i in range(200))
    assert [key for key, _ in outs[0] + outs[1]] == [
        schedules[tid][i % 3] for tid in (0, 1) for i in range(200)]
    assert (tkernel.pq_topk_fused_cuda.launches - counts0[0],
            tkernel.pq_topk_fused_cuda.launches_live - counts0[1]) \
        == (400 - n_live, n_live)
    for tid in outs:
        for key, got in outs[tid]:
            _bits_equal(got, want[key])


def test_embedding_bag_counts_launches_from_two_threads(cuda_device):
    v, d, n_bags, bag = 5000, 16, 64, 8
    g = torch.Generator().manual_seed(1)
    gt, gi, gw = (x.to(cuda_device) for x in (
        torch.randn((v, d), generator=g),
        torch.randint(-1, v, (n_bags, bag), generator=g).to(torch.int32),
        torch.rand((n_bags, bag), generator=g)))
    want = eb_ref.bag_reduce(gt, gi, gw, mode="sum")
    torch.cuda.synchronize()
    before = eb_kernel.embedding_bag_cuda.launches
    outs = {0: [], 1: []}

    def worker(tid):
        stream = torch.cuda.Stream(cuda_device)
        with torch.cuda.stream(stream):
            for _ in range(200):
                outs[tid].append(eb_kernel.embedding_bag_cuda(gt, gi, gw,
                                                              mode="sum"))
        stream.synchronize()

    _in_threads([lambda: worker(0), lambda: worker(1)])
    assert eb_kernel.embedding_bag_cuda.launches - before == 400
    for got in outs[0] + outs[1]:
        _bits_equal([got], [want])


def test_router_on_the_card_matches_the_engine(cuda_device):
    """Two replicas, each on its worker thread and stream, serve the reduced
    model's fused route; every result is the single engine's, bit for bit,
    batch for batch, and the fused kernel ran once per launched job."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.models import seqrec
    from repro_torch.serving.engine import Request, RetrievalEngine
    from repro_torch.serving.router import ReplicaRouter
    cfg = get_reduced("sasrec-recjpq").model
    params = seqrec.init_seqrec(torch.Generator().manual_seed(0), cfg,
                                device=cuda_device)
    rng = np.random.default_rng(0)
    hists = [rng.integers(1, cfg.n_items + 1, int(rng.integers(2, 16)))
             for _ in range(128)]
    eng = RetrievalEngine.for_seqrec(params, cfg, k=5, max_batch=8,
                                     method="pqtopk_fused",
                                     device=cuda_device)
    for i, h in enumerate(hists):
        eng.submit(Request(i, h, k=5))
    want = {r.request_id: r for r in eng.drain()}
    with ReplicaRouter.for_seqrec(params, cfg, n_replicas=2, k=5,
                                  max_batch=8, method="pqtopk_fused",
                                  device=cuda_device, hedge=False) as router:
        router.warmup()
        before = tkernel.pq_topk_fused_cuda.launches
        for i, h in enumerate(hists):
            router.submit(Request(i, h, k=5))
            if i % 8 == 7:
                router.pump()
        got = {r.request_id: r for r in router.drain(timeout_s=120.0)}
        st = router.stats()
    assert set(got) == set(want)
    jobs = sum(rep["completed"] for rep in st["replicas"].values())
    assert jobs == 16
    assert tkernel.pq_topk_fused_cuda.launches - before == jobs
    assert {r.replica for r in got.values()} == {0, 1}
    for i, w in want.items():
        assert not got[i].degraded and not got[i].shed
        np.testing.assert_array_equal(got[i].items, w.items)
        np.testing.assert_array_equal(got[i].scores, w.scores)


def _sharded_head(n, m, b, d, seed, device):
    """A tile-coherent uint16 head (item i's codes near i*b/N) whose lowest
    eight codes every query of the batch of 64 prefers (so the cascade
    prunes), on ``device``."""
    rng = np.random.default_rng(seed)
    centers = (np.arange(n) / n * b).astype(np.int64)
    codes = np.clip(centers[:, None] + rng.integers(-2, 3, (n, m)), 0, b - 1)
    sub = rng.standard_normal((m, b, d // m)).astype(np.float32)
    sub[:, :8] += 2.0
    phi = (rng.standard_normal((64, d)) + 1.0).astype(np.float32)
    return ({"codes": torch.from_numpy(codes.astype(np.uint16)).to(device),
             "sub_emb": torch.from_numpy(sub).to(device)},
            torch.from_numpy(phi).to(device))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_routes_match_flat_routes(cuda_device, n_shards):
    """Shards on one card (``["cuda:0"] * S``, N = 100,003 dividing by
    neither): the sharded fused and scores-kernel routes, and the sharded
    cascade batch-any, grouped and with super-tiles at the engine's
    k_hint (a 2,048 + pad tile, scored as kernel-sized parts), each
    bit-identical to the flat fused route; the fused route launches its
    kernel once per shard."""
    from repro_torch.configs.base import PQConfig
    from repro_torch.core import retrieval_head as trh
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(n_shards, ["cuda:0"] * n_shards)
    params, phi = _sharded_head(100_003, 8, 512, 64, seed=n_shards,
                                device=cuda_device)
    fv, fi = trh.top_items(params, phi, 10, method="pqtopk_fused")
    for method in ("pqtopk_fused", "pqtopk_kernel"):
        before = (tkernel.pq_topk_fused_cuda.launches,
                  tkernel.pq_scores_cuda.launches)
        v, i = trh.top_items_sharded(params, phi, 10, mesh, method=method)
        _bits_equal((v, i), (fv, fi))
        fused = tkernel.pq_topk_fused_cuda.launches - before[0]
        scores = tkernel.pq_scores_cuda.launches - before[1]
        assert (fused, scores) == ((n_shards, 0) if method == "pqtopk_fused"
                                   else (0, n_shards))
    for cfg in (PQConfig(m=8, b=512), PQConfig(m=8, b=512,
                                               query_grouping=True),
                PQConfig(m=8, b=512, super_factor=4)):
        p = trh.ensure_sharded_pruned_state(params, mesh, k_hint=2048,
                                            super_factor=cfg.super_factor)
        assert p["pruned"].tile == 2048 + (-100_003) % n_shards
        v, i, st = trh.top_items_pruned_sharded(p, phi, 10, mesh,
                                                pq_cfg=cfg, ladder=(4, 8),
                                                return_stats=True)
        _bits_equal((v, i), (fv, fi))
        assert st["n_survived"] < st["n_tiles"], st


@pytest.mark.parametrize("tile", [683, 1001, 1025])
@pytest.mark.parametrize("bq", [1, 2, 5])
def test_fused_kernel_odd_tiles_match_plain_version(cuda_device, tile, bq):
    """Odd item tiles (a small catalogue's pruning tile; a sharded state's
    2,049-row tile scored as three 683-row parts) at every QB, 1D with
    sentinels and with the live mask: bit-exact against the plain version
    (the launch plan keeps its buffers on the 16-byte grid)."""
    codes, s = _inputs(5003, 8, 512, bq, np.uint16, seed=tile + bq)
    gc, gs = codes.to(cuda_device), s.to(cuda_device)
    nt = tops.n_tiles(5003, tile)
    idx = torch.tensor([0, 2, nt - 1, -1], dtype=torch.int32)
    live = torch.from_numpy(np.random.default_rng(tile).random(5003) > 0.2)
    for lv in (None, live):
        got = tops.pq_topk_slots(gc, gs, 16, idx.to(cuda_device),
                                 n_items=5003, tile=tile,
                                 live=None if lv is None else
                                 lv.to(cuda_device))
        want = tref.pq_topk_slots(codes, s, 16, idx, n_items=5003,
                                  tile=tile, live=lv)
        _bits_equal([g.cpu() for g in got], want)


@pytest.mark.parametrize("n,bq", [(262_144, 128), (152_064, 5)])
@pytest.mark.parametrize("k", [8, 64])
def test_lm_vocab_head_shapes_match_plain_versions(cuda_device, n, bq, k):
    """The LM decode head's shape: int32 codes, m=8, b=256, a vocabulary
    of 262,144 (gemma3) or 152,064 (qwen2.5) tokens, tiles of 2,048, and
    k up to the fused kernel's 64-candidate buffer: ``pq_scores`` and the
    fused kernel's form (a) bit for bit against their plain versions."""
    codes, s = _inputs(n, 8, 256, bq, np.int32, seed=k + bq)
    gc, gs = codes.to(cuda_device), s.to(cuda_device)
    _bits_equal([tops.pq_scores(gc, gs).cpu()], [tref.pq_scores(codes, s)])
    idx = torch.arange(tops.n_tiles(n, 2048), dtype=torch.int32)
    got = tops.pq_topk_slots(gc, gs, k, idx.to(cuda_device), n_items=n,
                             tile=2048)
    want = tref.pq_topk_slots(codes, s, k, idx, n_items=n, tile=2048)
    _bits_equal([g.cpu() for g in got], want)
    v, i = tops.pq_topk(gc, gs, k)
    assert i[0, :3].tolist() == [3, n // 2, n - 1]


def test_lm_decode_step_heads_on_the_card(cuda_device):
    """A reduced gemma3 decode on the card: the fused head launches form
    (a) once a step and matches plain ``pqtopk`` bit for bit at k=64, as
    do the scores kernel's head and the pruned cascade."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.models import transformer as T
    cfg = get_reduced("gemma3-27b").model
    params = T.init_lm(torch.Generator().manual_seed(0), cfg,
                       device=cuda_device)
    caches = T.init_caches(cfg, 4, 16, device=cuda_device)
    tok = torch.tensor([1, 7, 99, 300], dtype=torch.int32,
                       device=cuda_device)
    for pos in range(10):                     # past the 8-slot rings
        phi = T._decode_backbone(params, tok, pos, caches, cfg)
        tok = T._decode_head(params, phi, cfg, 1, "pqtopk")[0][:, 0]
    want = T._decode_head(params, phi, cfg, 64, "pqtopk")
    for method in ("pqtopk_fused", "pqtopk_kernel", "pqtopk_pruned"):
        before = (tkernel.pq_topk_fused_cuda.launches,
                  tkernel.pq_scores_cuda.launches)
        got = T._decode_head(params, phi, cfg, 64, method)
        _bits_equal(got, want)
        if method == "pqtopk_fused":
            assert (tkernel.pq_topk_fused_cuda.launches,
                    tkernel.pq_scores_cuda.launches) == (before[0] + 1,
                                                         before[1])
        if method == "pqtopk_kernel":
            assert (tkernel.pq_topk_fused_cuda.launches,
                    tkernel.pq_scores_cuda.launches) == (before[0],
                                                         before[1] + 1)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b"])
def test_moe_decode_on_the_card(cuda_device, arch):
    """A reduced MoE LM on the card: the dense and sort dispatches route
    alike (the same experts, the same kept pairs) and agree within float32
    rounding (2e-5 relative); the fused head launches form (a) once a step
    and matches plain ``pqtopk`` bit for bit at k=64."""
    import dataclasses
    from repro_torch.configs.base import get_reduced
    from repro_torch.models import moe as M, transformer as T
    cfg = get_reduced(arch).model
    params = T.init_lm(torch.Generator().manual_seed(0), cfg,
                       device=cuda_device)
    x = torch.randn((128, 1, cfg.d_model), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    blk = T._layer(params, cfg, 0)["moe"]
    g, tg = M._groups(128)
    _, gates, sel = M._route(blk, cfg.moe, x.reshape(g, tg, -1))
    c = M._capacity(tg, cfg.moe)
    dispatch, _ = M._dense_dispatch(sel, gates, cfg.moe.n_experts, c)
    keep = M._sort_dispatch(sel, gates, cfg.moe.n_experts, c)[3]
    assert int(dispatch.sum()) == int(keep.sum())
    dense = M.moe_ffn(blk, cfg.moe, x, cfg.act, impl="dense")[0]
    sort = M.moe_ffn(blk, cfg.moe, x, cfg.act, impl="sort")[0]
    assert float((dense - sort).norm() / dense.norm()) < 2e-5
    tok = torch.arange(4, dtype=torch.int32, device=cuda_device) * 7
    for impl in ("dense", "sort"):
        icfg = dataclasses.replace(cfg, moe_impl=impl)
        caches = T.init_caches(icfg, 4, 8, device=cuda_device)
        for pos in range(3):
            phi = T._decode_backbone(params, tok, pos, caches, icfg)
            want = T._decode_head(params, phi, icfg, 64, "pqtopk")
            before = tkernel.pq_topk_fused_cuda.launches
            got = T._decode_head(params, phi, icfg, 64, "pqtopk_fused")
            assert tkernel.pq_topk_fused_cuda.launches == before + 1
            _bits_equal(got, want)
            tok = want[0][:, 0]


def test_gnn_losses_on_the_card_match_the_cpu(cuda_device):
    """GraphSAGE's three losses and their gradients on the card against
    the same weights and batches on the CPU, within float32 rounding
    (rtol=atol=1e-5): ``index_add`` adds with atomics on the card, in no
    fixed order."""
    from repro_torch.configs.base import get_reduced
    from repro_torch.data import graph as G
    from repro_torch.models import gnn as M
    from repro_torch.training import tree
    cfg = get_reduced("graphsage-reddit").model
    g = G.synthetic_graph(2000, 16000, 32, cfg.n_classes, seed=0)
    rng = np.random.default_rng(1)
    full = {"feats": g.feats, "edges": g.edges, "labels": g.labels,
            "label_mask": rng.integers(0, 2, g.n_nodes).astype(np.float32)}
    mini = G.NeighborSampler(g).sample_batch(
        rng.integers(0, g.n_nodes, 64), (5, 3), rng)
    mol = G.molecule_batch(16, 30, 64, 32, cfg.n_classes, seed=2)
    params = M.init_gnn(torch.Generator().manual_seed(0), cfg, 32)
    for loss, batch in ((M.gnn_loss, full), (M.gnn_minibatch_loss, mini),
                        (M.gnn_graph_batch_loss, mol)):
        out = {}
        for dev in ("cpu", cuda_device):
            p = tree.tree_map(
                lambda x: x.detach().to(dev).requires_grad_(True), params)
            leaves = tree.leaves(p)
            val, _ = loss(p, {k: torch.from_numpy(v).to(dev)
                              for k, v in batch.items()}, cfg)
            val.backward()
            out[str(dev)] = [val.detach().cpu()] + [x.grad.cpu()
                                                    for x in leaves]
        for a, b in zip(out["cuda"], out["cpu"], strict=True):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_analysis_registry_on_the_card(cuda_device):
    """The serve-path analysis over the whole registry on the card: every
    pass passes (sync-debug warnings included), and each entry's recorded
    launches equal its documented ones and the CUDA counters' rise."""
    from repro_torch.analysis import entrypoints as ep
    from repro_torch.analysis import run_default
    report = run_default(device="cuda")
    assert report.ok, report.render()
    for name in ep.REGISTRY:
        info = report.result(name, "host-reads").info
        assert info["launches"] == info["cuda_launches"] \
            == ep.DOCUMENTED[name][0], (name, info)
        assert info["host_reads"] == ep.DOCUMENTED[name][1], (name, info)
        assert info["cuda_uploads"] == ep.DOCUMENTED[name][2], (name, info)


def test_powersgd_mesh_step_on_the_card_matches_the_cpu(cuda_device):
    """Two PowerSGD steps of a widened reduced SASRec-RecJPQ on the 8
    positions of ``make_test_mesh(multi_pod=True)`` on ``cuda:0`` against
    the same steps on CPU positions (the second with each pod's own
    residual): loss, every pod's residual and every parameter within
    rtol=atol=1e-5, and on the card each compressed leaf's error-feedback
    identity g_hat + e' == g + e per pod within 1e-5 of its largest
    value."""
    import dataclasses
    from repro_torch.configs.base import get_reduced
    from repro_torch.data.sequences import SeqRecDataset
    from repro_torch.distributed.sharding import Varying
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import seqrec
    from repro_torch.training import optimizer, train_loop, tree
    c = get_reduced("sasrec-recjpq").model
    cfg = dataclasses.replace(c, d_model=64, d_ff=1024,
                              pq=dataclasses.replace(c.pq, assign="random"))
    params = seqrec.init_seqrec(torch.Generator().manual_seed(0), cfg)
    it = SeqRecDataset.synthetic(64, cfg.n_items, 10, cfg.max_seq_len,
                                 seed=0).batches(8, cfg.n_negatives,
                                                 backbone=cfg.backbone, seed=1)
    batches = [next(it) for _ in range(2)]
    ocfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    worst, out = [0.0], {}

    def identity(key, g, e, g_hat, new_e):
        for gi, ei, ni in zip(g, e, new_e):
            want = gi.float() + ei.float()
            worst[0] = max(worst[0], float((g_hat + ni - want).abs().max()
                                           / want.abs().max()))

    for dev in ("cpu", cuda_device):
        mesh = make_test_mesh(multi_pod=True, devices=[dev] * 8)
        step = train_loop.make_train_step(
            lambda p, b: seqrec.seqrec_loss(p, b, cfg), ocfg,
            powersgd_axis="pod", mesh=mesh)
        p = tree.tree_map(lambda x: x.to(dev), params)
        s = train_loop.init_opt_state(p, ocfg, powersgd=True)
        for b in batches:
            p, s, m = step(p, s, {k: torch.from_numpy(v).to(dev)
                                  for k, v in b.items()},
                           trace={"leaf": identity} if dev is cuda_device
                           else {})
        out[str(dev)] = (m["loss"].cpu(), p, s["ef"])
    assert worst[0] <= 1e-5
    (gl, gp, ge), (cl, cp, ce) = out[str(cuda_device)], out["cpu"]
    torch.testing.assert_close(gl, cl, rtol=1e-5, atol=1e-5)
    for (path, a), (_, b) in zip(tree.leaves_with_path(gp),
                                 tree.leaves_with_path(cp)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5,
                                   msg=lambda s: f"{path}: {s}")
    n_pod = 0
    for (path, a), (_, b) in zip(tree.leaves_with_path(ge),
                                 tree.leaves_with_path(ce)):
        if isinstance(a, Varying):
            n_pod += 1
            for x, y in zip(a.parts, b.parts, strict=True):
                torch.testing.assert_close(x.cpu(), y, rtol=1e-5, atol=1e-5,
                                           msg=lambda s: f"{path}: {s}")
    assert n_pod >= 2
