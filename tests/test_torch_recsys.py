"""The port's recsys family (DCN-v2, BST, DIEN, FM) against the JAX
reference.

Configs are compared field by field, ``ctr_batch`` bit for bit.  Each
reduced kind starts from the reference's own ``init_recsys(PRNGKey(0))``
carried over with ``interop.params_from_jax``; ``ctr_logits`` and
``user_query`` are held at rtol=atol=1e-5 (float32, and the two
frameworks' matmuls sum in different orders), ``retrieve_topk`` with ids
equal and values within 1e-6.  ``gru_scan`` and the layers the models use
take numpy inputs from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.data import recsys_data as jdata
from repro.models import layers as jlayers, recsys as jrecsys
from repro_torch.configs import base as tcfg
from repro_torch.data import recsys_data as tdata
from repro_torch.interop import params_from_jax
from repro_torch.models import layers as tlayers, recsys as trecsys

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("dcn-v2", "bst", "dien", "fm")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """Per arch: (reference config, port config, reference params, the
    same params carried to the port)."""
    out = {}
    for arch in ARCHS:
        jc = jcfg.get_reduced(arch).model
        jp = jrecsys.init_recsys(jax.random.PRNGKey(0), jc)
        out[arch] = (jc, tcfg.get_reduced(arch).model, jp,
                     params_from_jax(_np_tree(jp)))
    return out


def _batches(jc, tc, n=6, seed=3):
    batch = jdata.ctr_batch(jc, n, seed)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            trecsys.batch_tensors(batch, "cpu"))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_reference(arch, reduced):
    get_j = jcfg.get_reduced if reduced else jcfg.get_config
    get_t = tcfg.get_reduced if reduced else tcfg.get_config
    j, t = get_j(arch), get_t(arch)
    assert (t.arch_id, t.family, t.source) == (j.arch_id, j.family, j.source)
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
    assert t.model.total_rows() == j.model.total_rows()
    assert [dataclasses.asdict(s) for s in t.shapes] == \
        [dataclasses.asdict(s) for s in j.shapes]
    assert t.shape("serve_bulk").dims["global_batch"] == 262_144


def test_full_width_table_sizes():
    """The full-width configs' embedding tables, as the slice's notes
    state them (rows x width x 4 bytes)."""
    dcn, fm = tcfg.get_config("dcn-v2").model, tcfg.get_config("fm").model
    assert dcn.total_rows() == 33_762_577 and len(dcn.table_rows) == 26
    assert max(dcn.table_rows) == 10_131_227
    assert fm.n_sparse == len(fm.table_rows) == 39
    assert fm.total_rows() == 33_762_577 + 13 * 64
    bst = tcfg.get_config("bst").model
    assert bst.table_rows[0] * bst.embed_dim * 4 == 512_000_000


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_ctr_batch_bit_identical(arch, reduced):
    cfg_j = (jcfg.get_reduced if reduced else jcfg.get_config)(arch).model
    cfg_t = (tcfg.get_reduced if reduced else tcfg.get_config)(arch).model
    for seed in (0, 7):
        want = jdata.ctr_batch(cfg_j, 9, seed)
        got = tdata.ctr_batch(cfg_t, 9, seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    stream_j, stream_t = (jdata.ctr_batches(cfg_j, 4, 5),
                          tdata.ctr_batches(cfg_t, 4, 5))
    for _ in range(2):
        a, b = next(stream_j), next(stream_t)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_recsys_trees(models, arch):
    """The reference's tree converts leaf for leaf (lists stay lists, FM's
    0-d bias stays 0-d, the pruned state field for field), and the port's
    own ``init_recsys`` draws a tree of the same paths, shapes and
    dtypes."""
    jc, tc, jp, tp = models[arch]
    own = trecsys.init_recsys(torch.Generator().manual_seed(0), tc,
                              device="cpu")
    jstate = jp["item_emb"]["pruned"]
    for state in (tp["item_emb"]["pruned"], own["item_emb"]["pruned"]):
        for f in ("tile", "n_items", "b", "shards", "backend", "n_tiles"):
            assert getattr(state, f) == getattr(jstate, f), f
    np.testing.assert_array_equal(tp["item_emb"]["pruned"].packed.numpy(),
                                  np.asarray(jstate.packed).view(np.int32))
    jflat = jax.tree_util.tree_flatten_with_path(
        {**jp, "item_emb": {k: v for k, v in jp["item_emb"].items()
                            if k != "pruned"}})[0]
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            (tuple(v.shape), str(v.dtype)) for path, v in jflat}

    def walk(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k != "pruned":
                    yield from walk(v, prefix + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from walk(v, prefix + (i,))
        else:
            yield prefix, tree

    for tree in (tp, own):
        got = {path: (tuple(t.shape), str(t.dtype).split(".")[-1])
               for path, t in walk(tree)}
        assert got == want
    for path, v in jflat:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        leaf = tp
        for k in key:
            leaf = leaf[k]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(v))


@pytest.mark.parametrize("arch", ARCHS)
def test_ctr_logits_and_user_query_match(models, arch):
    jc, tc, jp, tp = models[arch]
    jb, tb = _batches(jc, tc)
    want = np.asarray(jax.jit(lambda p, b: jrecsys.ctr_logits(p, b, jc))(
        jp, jb))
    got = trecsys.ctr_logits(tp, tb, tc)
    assert got.shape == (6,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_q = np.asarray(jax.jit(lambda p, b: jrecsys.user_query(p, b, jc))(
        jp, jb))
    got_q = trecsys.user_query(tp, tb, tc)
    assert got_q.shape == (6, tc.embed_dim)
    np.testing.assert_allclose(got_q.numpy(), want_q, **TOL)


def _with_linear(jp, seed):
    """FM's reference init has all-zero linear weights; give them values
    so the linear term is exercised."""
    rng = np.random.default_rng(seed)
    lin = {"w": [jnp.asarray(rng.standard_normal(w.shape).astype(np.float32))
                 for w in jp["linear"]["w"]],
           "b": jnp.asarray(np.float32(0.3))}
    return {**jp, "linear": lin}


def test_fm_linear_term_matches():
    jc, tc = jcfg.get_reduced("fm").model, tcfg.get_reduced("fm").model
    jp = _with_linear(jrecsys.init_recsys(jax.random.PRNGKey(1), jc), 2)
    tp = params_from_jax(_np_tree(jp))
    jb, tb = _batches(jc, tc, seed=4)
    np.testing.assert_allclose(
        trecsys.ctr_logits(tp, tb, tc).numpy(),
        np.asarray(jrecsys.ctr_logits(jp, jb, jc)), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("method", ["pqtopk", "pqtopk_fused"])
def test_retrieve_topk_matches(models, arch, method):
    jc, tc, jp, tp = models[arch]
    jb, tb = _batches(jc, tc)
    rid, rv = (np.asarray(a) for a in jax.jit(
        lambda p, b: jrecsys.retrieve_topk(p, b, jc, k=10, method=method))(
            jp, jb))
    ids, vals = trecsys.retrieve_topk(tp, tb, tc, k=10, method=method)
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (6, 10)
    np.testing.assert_array_equal(ids.numpy(), rid)
    np.testing.assert_allclose(vals.numpy(), rv, rtol=0, atol=1e-6)
    pv, pi = trecsys.retrieve_topk(tp, tb, tc, k=10, method="pqtopk")[::-1]
    assert torch.equal(ids, pi) and torch.equal(vals, pv)


def _gru_params(d_in, d_h, seed):
    rng = np.random.default_rng(seed)
    scale = (d_in + d_h) ** -0.5
    return {"wx": (rng.standard_normal((d_in, 3 * d_h)) * scale
                   ).astype(np.float32),
            "wh": (rng.standard_normal((d_h, 3 * d_h)) * scale
                   ).astype(np.float32),
            "b": (0.1 * rng.standard_normal(3 * d_h)).astype(np.float32)}


@pytest.mark.parametrize("attention", [False, True])
def test_gru_scan_matches(attention):
    p = _gru_params(5, 7, seed=0)
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((3, 6, 5)).astype(np.float32)
    att = rng.uniform(0, 1, (3, 6)).astype(np.float32) if attention else None
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = np.asarray(jrecsys.gru_scan(
        jp, jnp.asarray(xs), None if att is None else jnp.asarray(att)))
    got = trecsys.gru_scan({k: _t(v) for k, v in p.items()}, _t(xs),
                           None if att is None else _t(att))
    assert got.shape == (3, 6, 7)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_augru_zero_attention_takes_the_candidate():
    """AUGRU with attention 0 zeroes the update gate, so each step's state
    is the candidate n: shape and finiteness hold, and the states differ
    from the plain GRU's (the reference's own check,
    ``tests/test_models_unit.py::test_augru_attention_gates_update``)."""
    p = {k: _t(v) for k, v in _gru_params(4, 6, seed=2).items()}
    xs = _t(np.random.default_rng(3).standard_normal((2, 5, 4))
            .astype(np.float32))
    hs = trecsys.gru_scan(p, xs, torch.zeros(2, 5))
    hs_plain = trecsys.gru_scan(p, xs)
    assert hs.shape == (2, 5, 6) and torch.isfinite(hs).all()
    assert float((hs - hs_plain).abs().max()) > 1e-6
    # Step by step: z = 0, so h_t = n_t from h_{t-1}.
    h = torch.zeros(2, 6)
    for t in range(5):
        hw = h @ p["wh"]
        r, _, n = (xs[:, t] @ p["wx"] + hw + p["b"]).split(6, dim=-1)
        h = torch.tanh(n + (torch.sigmoid(r) - 1.0) * hw[:, 12:])
        torch.testing.assert_close(hs[:, t], h, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "sqrelu", "tanh",
                                  "sigmoid"])
def test_activation_matches_reference(name):
    x = (np.random.default_rng(4).standard_normal((3, 33)) * 3
         ).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.activation(name)(_t(x)).numpy(),
        np.asarray(jlayers.activation(name)(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gated", [False, True])
def test_mlp_matches_reference(gated):
    """The plain (BST's) and gated MLP on the same weights."""
    rng = np.random.default_rng(5)
    p = {n: {"w": rng.standard_normal(s).astype(np.float32)}
         for n, s in (("up", (12, 20)), ("down", (20, 12)),
                      ("gate", (12, 20)))}
    if not gated:
        del p["gate"]
    x = rng.standard_normal((4, 12)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.mlp({k: {"w": _t(v["w"])} for k, v in p.items()}, _t(x),
                    "relu").numpy(),
        np.asarray(jlayers.mlp(jax.tree_util.tree_map(jnp.asarray, p),
                               jnp.asarray(x), "relu")), **TOL)
    own = tlayers.mlp_init(torch.Generator().manual_seed(0), 12, 20,
                           gated=gated)
    assert sorted(own) == sorted(p)
