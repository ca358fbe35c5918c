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
