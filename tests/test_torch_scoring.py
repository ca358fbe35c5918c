"""Parity of the port's scoring, top-k, PQ embedding and configs with the
JAX reference, on the CPU.  The same numpy inputs go through both
packages; the PQ routes must agree bit for bit (atol=0), the matmul
routes to float32 rounding."""
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import pq as jpq, scoring as jscoring, topk as jtopk
from repro_torch.configs import base as tcfg
from repro_torch.core import pq as tpq, scoring as tscoring, topk as ttopk

CODE_DTYPES = ("int8", "uint8", "uint16", "int32")


def _pq_inputs(n, m, b, bq, code_dtype="int32", seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b, (n, m)).astype(code_dtype)
    s = rng.standard_normal((bq, m, b)).astype(np.float32)
    return codes, s


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_parts", [1, 2, 3, 5, 7, 8, 9])
def test_tree_sum_matches_reference_order(n_parts):
    rng = np.random.default_rng(n_parts)
    parts = [rng.standard_normal(257).astype(np.float32) * 10 ** (i % 5)
             for i in range(n_parts)]
    ref = np.asarray(jscoring.tree_sum([jnp.asarray(p) for p in parts]))
    got = tscoring.tree_sum([_t(p) for p in parts]).numpy()
    np.testing.assert_array_equal(got, ref)


CAPACITY = {"int8": 128, "uint8": 256, "uint16": 65_536, "int32": 2 ** 31}
PQ_SHAPES = [(dt, m, b) for dt in CODE_DTYPES
             for m, b in [(8, 512), (3, 100), (4, 16)] if b <= CAPACITY[dt]]


@pytest.mark.parametrize("code_dtype,m,b", PQ_SHAPES)
def test_pq_routes_bitexact(code_dtype, m, b):
    codes, s = _pq_inputs(1001, m, b, 3, code_dtype)
    jc, js = jnp.asarray(codes), jnp.asarray(s)
    tc, ts = _t(codes), _t(s)
    for name in ("score_pqtopk", "score_recjpq"):
        ref = np.asarray(getattr(jscoring, name)(jc, js))
        got = getattr(tscoring, name)(tc, ts).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=name)
    ref = np.asarray(jscoring.score_pqtopk_onehot(jc, js))
    got = tscoring.score_pqtopk_onehot(tc, ts).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    ids = np.array([0, 17, 1000, 17, 5])
    ref = np.asarray(jscoring.score_items_pqtopk(jc, js, jnp.asarray(ids)))
    got = tscoring.score_items_pqtopk(tc, ts, _t(ids)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_dense_and_subid_scores_match():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((300, 32)).astype(np.float32)
    phi = rng.standard_normal((4, 32)).astype(np.float32)
    sub = rng.standard_normal((4, 16, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tscoring.score_dense(_t(w), _t(phi)).numpy(),
        np.asarray(jscoring.score_dense(jnp.asarray(w), jnp.asarray(phi))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tscoring.subid_scores(_t(sub), _t(phi)).numpy(),
        np.asarray(jscoring.subid_scores(jnp.asarray(sub), jnp.asarray(phi))),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tscoring.subid_scores(_t(sub), _t(phi[:, :31]))


def _planted_ties(bq=3, n=20_000, seed=2):
    rng = np.random.default_rng(seed)
    # Few distinct values: every top-k crosses ties.
    x = rng.integers(0, 7, (bq, n)).astype(np.float32)
    x[0, [5, 9, 19_999]] = 100.0
    x[1, -3:] = 50.0
    x[2, :] = 1.0
    return x


@pytest.mark.parametrize("k", [1, 10, 64])
def test_topk_routes_break_ties_like_lax_top_k(k):
    x = _planted_ties()
    rv, ri = (np.asarray(a) for a in jtopk.topk(jnp.asarray(x), k))
    for fn, args in ((ttopk.topk, ()), (ttopk.tiled_topk, (4096,)),
                     (ttopk.tiled_topk, (8192,))):
        v, i = fn(_t(x), k, *args)
        np.testing.assert_array_equal(v.numpy(), rv)
        np.testing.assert_array_equal(i.numpy(), ri)
        assert i.dtype == torch.int32
    jv, ji = (np.asarray(a) for a in jtopk.tiled_topk(jnp.asarray(x), k, 4096))
    np.testing.assert_array_equal(ji, ri)
    av, ai = (np.asarray(a) for a in
              jtopk.approx_topk_maxblock(jnp.asarray(x), k))
    v, i = ttopk.approx_topk_maxblock(_t(x), k)
    np.testing.assert_array_equal(v.numpy(), av)
    np.testing.assert_array_equal(i.numpy(), ai)


def _bits(a):
    return np.asarray(a).view(np.uint32)


def test_topk_total_order_probes():
    """+0.0 ranks above -0.0; +NaN first, -NaN last (below -inf)."""
    nan = np.float32(np.nan)
    for x, k, ids in (([-0., 0., -0., 0., 1., -1.], 4, [4, 1, 3, 0]),
                      ([nan, -nan, 1., -np.inf], 4, [0, 2, 3, 1])):
        x = np.array([x], np.float32)
        rv, ri = jtopk.topk(jnp.asarray(x), k)
        v, i = ttopk.topk(_t(x), k)
        assert np.asarray(ri)[0].tolist() == ids == i[0].tolist()
        np.testing.assert_array_equal(_bits(v.numpy()), _bits(rv))


def _planted_specials(bq=3, n=20_000, seed=11):
    """Few distinct values, with +-0, +-inf and NaNs of both signs and two
    payloads each: every top-k crosses ties at every edge of the order.
    Row 2 is mostly -NaN and -inf, so its top-k reaches the bottom (and
    the tiled route's -inf padding, which ranks above -NaN)."""
    rng = np.random.default_rng(seed)
    special = np.array([0x80000000, 0, 0x7f800000, 0xff800000, 0x7fc00000,
                        0x7fc00001, 0xffc00000, 0xffc00001, 0x3f800000,
                        0xbf800000], np.uint32).view(np.float32)
    x = special[rng.integers(0, special.size, (bq, n))]
    x[2] = special[rng.choice([3, 6, 7], n, p=[0.002, 0.499, 0.499])]
    x[2, rng.integers(0, n, 5)] = special[rng.integers(0, 2, 5)]
    return x


@pytest.mark.parametrize("k", [4, 16, 64])
def test_topk_routes_follow_lax_top_k_total_order(k):
    x = _planted_specials()
    rv, ri = jtopk.topk(jnp.asarray(x), k)
    for fn, args in ((ttopk.topk, ()), (ttopk.tiled_topk, (4096,)),
                     (ttopk.tiled_topk, (8192,))):
        v, i = fn(_t(x), k, *args)
        want_v, want_i = (rv, ri) if fn is ttopk.topk else \
            jtopk.tiled_topk(jnp.asarray(x), k, *args)
        np.testing.assert_array_equal(_bits(v.numpy()), _bits(want_v))
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("k", [4, 16])
def test_approx_topk_maxblock_matches_reference_on_specials(k):
    """Blocks whose maximum is -0.0 or +0.0 (with the first maximum a
    -0.0), +-inf, and one NaN of either sign: the reference's ``max``
    propagates the NaN and gives +0.0 over mixed zeros, its ``argmax`` the
    first maximum.  (With several NaNs in one block the reference's NaN
    bits follow its reduction order, which the port does not model.)"""
    rng = np.random.default_rng(12)
    n_blocks, width = 2 * k, 97
    x = -rng.uniform(1, 2, (2, n_blocks * width)).astype(np.float32)
    blk = x.reshape(2, n_blocks, width)
    for j in range(n_blocks):
        cols = rng.choice(width, 4, replace=False)
        if j == 5:
            blk[:, j, cols[0]] = np.nan
        elif j == 6:
            blk[:, j, cols] = [np.inf, 1.0, -np.inf, 0.0]
        elif j % 4 == 0:
            blk[:, j, cols] = [-0.0, 0.0, -0.0, -np.inf]
        elif j % 4 == 1:
            blk[:, j, cols] = [-0.0, -0.0, -np.inf, -0.0]
        elif j % 4 == 2:
            blk[:, j, cols[:2]] = [-np.nan, np.inf]
        else:
            blk[:, j, :] = -np.inf
    av, ai = jtopk.approx_topk_maxblock(jnp.asarray(x), k)
    v, i = ttopk.approx_topk_maxblock(_t(x), k)
    np.testing.assert_array_equal(_bits(v.numpy()), _bits(av))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ai))
    top = set(_bits(av).ravel().tolist())
    assert {0, 0x7fc00000} <= top and (k < 16 or 0x80000000 in top)


@pytest.mark.parametrize("method", ["pqtopk", "pqtopk_fused",
                                    "pqtopk_kernel"])
def test_top_items_ranks_planted_signed_zeros(method):
    """A serve method end to end on S planted with -0.0 and +0.0 sub-ids:
    with one dimension per split, S = phi * sub_emb is -0.0 where phi > 0
    meets a -0.0 sub-embedding, and items whose codes hit only those
    entries score -0.0; codes mixing in a +0.0 entry score +0.0.  Every
    other score is below -m, so the top-k is the zeros, +0.0 first."""
    from repro.core import retrieval_head as jhead
    from repro_torch.core import retrieval_head as thead
    rng = np.random.default_rng(13)
    n, m, b, k = 3000, 4, 32, 40
    sub = -rng.uniform(1, 2, (m, b, 1)).astype(np.float32)
    sub[:, 0], sub[:, 1] = -0.0, 0.0
    codes = rng.integers(2, b, (n, m)).astype(np.int32)
    zero = rng.choice(n, 30, replace=False)
    codes[zero[:12]] = 0
    codes[zero[12:]] = rng.integers(0, 2, (18, m))
    codes[zero[12:], 0] = 1
    phi = rng.uniform(0.5, 1.5, (3, m)).astype(np.float32)
    jp = {"codes": jnp.asarray(codes), "sub_emb": jnp.asarray(sub)}
    tp = {"codes": _t(codes), "sub_emb": _t(sub)}
    rv, ri = (np.asarray(a) for a in jhead.top_items(
        jp, jnp.asarray(phi), k, method="pqtopk"))
    v, i = thead.top_items(tp, _t(phi), k, method=method)
    np.testing.assert_array_equal(_bits(v.numpy()), _bits(rv))
    np.testing.assert_array_equal(i.numpy(), ri)
    for q in range(3):                         # 18 +0.0, then 12 -0.0
        np.testing.assert_array_equal(
            _bits(rv[q, :30]), [0] * 18 + [0x80000000] * 12)
        assert (codes[ri[q, 18:30]] == 0).all()


@pytest.mark.parametrize("code_dtype", ["uint8", "uint16", "int32"])
def test_reconstruct_matches(code_dtype):
    b = 512 if code_dtype != "uint8" else 256
    pqc = jcfg.PQConfig(m=8, b=b, code_dtype=code_dtype)
    codes, _ = _pq_inputs(50, 8, b, 1, code_dtype, seed=3)
    cent = np.random.default_rng(4).standard_normal((8, b, 4)) \
        .astype(np.float32)
    jp = {"codes": jnp.asarray(codes), "sub_emb": jnp.asarray(cent)}
    tp = {"codes": _t(codes), "sub_emb": _t(cent)}
    ids = np.array([[0, 3, 49], [7, 7, 1]])
    np.testing.assert_array_equal(
        tpq.reconstruct(tp, _t(ids)).numpy(),
        np.asarray(jpq.reconstruct(jp, jnp.asarray(ids))))
    np.testing.assert_array_equal(tpq.reconstruct_all(tp).numpy(),
                                  np.asarray(jpq.reconstruct_all(jp)))
    tpc = tcfg.PQConfig(m=8, b=b, code_dtype=code_dtype)
    assert tpq.code_nbytes(tpc) == jpq.code_nbytes(pqc)
    assert tpq.compression_ratio(tpc, 10_000, 32) == \
        jpq.compression_ratio(pqc, 10_000, 32)


def test_init_pq_embedding_codes_in_storage_dtype():
    pqc = tcfg.PQConfig(m=8, b=512, code_dtype="uint16")
    p = tpq.init_pq_embedding(torch.Generator().manual_seed(0), pqc, 5000, 64)
    assert p["codes"].dtype == torch.uint16
    assert tuple(p["codes"].shape) == (5000, 8)
    wide = tpq.widen(p["codes"])
    assert int(wide.min()) >= 0 and int(wide.max()) < 512
    assert int(wide.max()) > 255          # codes use the full 9-bit range
    assert tuple(p["sub_emb"].shape) == (8, 512, 8)
    again = tpq.init_pq_embedding(torch.Generator().manual_seed(0), pqc,
                                  5000, 64)
    assert torch.equal(tpq.widen(again["codes"]), wide)
    given = np.arange(16).reshape(2, 8) * 30
    p = tpq.init_pq_embedding(torch.Generator(), pqc, 2, 64, codes=given)
    np.testing.assert_array_equal(tpq.widen(p["codes"]).numpy(), given)
    with pytest.raises(ValueError):
        tpq.init_pq_embedding(torch.Generator(), pqc, 2, 60)


@pytest.mark.parametrize("arch", ["sasrec-recjpq", "gbert4rec-recjpq"])
def test_configs_match_reference(arch):
    for getter in ("get_config", "get_reduced"):
        jc = getattr(jcfg, getter)(arch)
        tc = getattr(tcfg, getter)(arch)
        assert asdict(tc.model) == asdict(jc.model)
        assert tc.arch_id == jc.arch_id and tc.family == jc.family
        assert [asdict(s) for s in tc.shapes] == [asdict(s) for s in jc.shapes]
    with pytest.raises(ValueError):
        tcfg.PQConfig(b=512, code_dtype="uint8")
