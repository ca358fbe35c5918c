"""The port's backbone and flat serving path against the JAX reference.

Weights and inputs are numpy from a seed, in the reference's parameter
layout; the port takes them through ``interop.params_from_jax``, which is
also held against the reference's own ``init_seqrec`` tree.  The
backbone is held at rtol=atol=1e-5 (float32, and the two frameworks'
matmuls sum in different orders); ids are compared where the reference's
own top-(k+1) gaps exceed 1e-4 (or are exact ties), so that no ulp-level difference in phi can
legally reorder them."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.configs.base import AttentionConfig as JAttn
from repro.core import retrieval_head as jretrieval
from repro.models import attention as jattn, layers as jlayers
from repro.models import seqrec as jseqrec
from repro_torch.configs import base as tcfg
from repro_torch.configs.base import AttentionConfig as TAttn
from repro_torch.interop import params_from_jax
from repro_torch.models import attention as tattn, layers as tlayers
from repro_torch.models import seqrec as tseqrec

TOL = dict(rtol=1e-5, atol=1e-5)
FLAT_METHODS = ("dense", "recjpq", "pqtopk", "pqtopk_onehot",
                "pqtopk_kernel", "pqtopk_fused", "pqtopk_approx")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _seqs(cfg, bq=8, seed=0):
    """Left-padded histories of assorted lengths (row 0 is all padding
    but its last item)."""
    rng = np.random.default_rng(seed)
    seqs = np.zeros((bq, cfg.max_seq_len), np.int32)
    for r in range(bq):
        n = 1 if r == 0 else int(rng.integers(2, cfg.max_seq_len + 1))
        seqs[r, -n:] = rng.integers(1, cfg.n_items + 1, n)
    return seqs


def _numpy_params(cfg, seed=0):
    """A seqrec parameter tree in the reference's layout, drawn with numpy.
    Sub-embeddings are wider than the reference's init so that top-k
    scores spread out."""
    rng = np.random.default_rng(seed)
    d, f32 = cfg.d_model, np.float32

    def dense(d_in, d_out):
        return {"w": (rng.standard_normal((d_in, d_out))
                      * d_in ** -0.5).astype(f32)}

    def norm():
        return {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(f32),
                "bias": (0.1 * rng.standard_normal(d)).astype(f32)}

    tree = {
        "item_emb": {
            "codes": rng.integers(0, cfg.pq.b, (cfg.n_items + 1, cfg.pq.m))
            .astype(cfg.pq.code_dtype),
            "sub_emb": (0.5 * rng.standard_normal(
                (cfg.pq.m, cfg.pq.b, d // cfg.pq.m))).astype(f32)},
        "pos_emb": {"table": (0.1 * rng.standard_normal(
            (cfg.max_seq_len, d))).astype(f32)},
        "final_norm": norm(),
        "blocks": [{"attn": {n: dense(d, d) for n in ("wq", "wk", "wv", "wo")},
                    "ln1": norm(), "ln2": norm(),
                    "mlp": {"up": dense(d, cfg.d_ff),
                            "down": dense(cfg.d_ff, d)}}
                   for _ in range(cfg.n_blocks)],
    }
    if cfg.backbone == "bert4rec":
        tree["mask_emb"] = (0.1 * rng.standard_normal(d)).astype(f32)
    return tree


@functools.cache
def _model(arch):
    jc = jcfg.get_reduced(arch).model
    tc = tcfg.get_reduced(arch).model
    tree = _numpy_params(jc)
    return jc, tc, jax.tree_util.tree_map(jnp.asarray, tree), \
        params_from_jax(tree)


def test_layers_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    for kind in ("layernorm", "rmsnorm"):
        np.testing.assert_allclose(
            tlayers.apply_norm(tp, _t(x), kind).numpy(),
            np.asarray(jlayers.apply_norm(jp, jnp.asarray(x), kind)), **TOL)
    np.testing.assert_allclose(
        tlayers.activation("gelu")(_t(x)).numpy(),
        np.asarray(jlayers.activation("gelu")(jnp.asarray(x))), **TOL)
    with pytest.raises(ValueError):
        tlayers.activation("swish")       # not in the reference's table
    w = {"w": rng.standard_normal((16, 24)).astype(np.float32),
         "b": rng.standard_normal(24).astype(np.float32)}
    np.testing.assert_allclose(
        tlayers.dense({k: _t(v) for k, v in w.items()}, _t(x)).numpy(),
        np.asarray(jlayers.dense({k: jnp.asarray(v) for k, v in w.items()},
                                 jnp.asarray(x))), **TOL)
    mp = {"up": {"w": w["w"]},
          "down": {"w": rng.standard_normal((24, 16)).astype(np.float32)}}
    np.testing.assert_allclose(
        tlayers.mlp({k: {"w": _t(v["w"])} for k, v in mp.items()}, _t(x),
                    "gelu").numpy(),
        np.asarray(jlayers.mlp(jax.tree_util.tree_map(jnp.asarray, mp),
                               jnp.asarray(x), "gelu")), **TOL)
    q = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
    pos = np.arange(7)[None, :]
    np.testing.assert_allclose(
        tlayers.apply_rope(_t(q), _t(pos), 10_000.0).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                                      10_000.0)), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_chunk", [1024, 4])
def test_attention_matches(causal, kv_chunk):
    rng = np.random.default_rng(1)
    d, s = 16, 10
    jc, tc = JAttn(n_heads=2, n_kv_heads=2, head_dim=8), \
        TAttn(n_heads=2, n_kv_heads=2, head_dim=8)
    jp = jattn.attention_init(jax.random.PRNGKey(3), jc, d)
    tp = {k: {"w": _t(np.asarray(v["w"]))} for k, v in jp.items()}
    x = rng.standard_normal((3, s, d)).astype(np.float32)
    np.testing.assert_allclose(
        tattn.full_attention(tp, tc, _t(x), causal=causal,
                             kv_chunk=kv_chunk).numpy(),
        np.asarray(jax.jit(lambda p, x: jattn.full_attention(
            p, jc, x, causal=causal, kv_chunk=kv_chunk))(jp, jnp.asarray(x))),
        **TOL)
    q, k, v = (rng.standard_normal((2, s, 4, 8)).astype(np.float32)
               for _ in range(3))
    kv = rng.standard_normal((2, s, 2, 8)).astype(np.float32)
    for kk, vv in ((k, v), (kv, kv * 0.5)):      # MHA and grouped (G=2)
        np.testing.assert_allclose(
            tattn.chunked_attention(_t(q), _t(kk), _t(vv), causal=causal,
                                    kv_chunk=kv_chunk).numpy(),
            np.asarray(jax.jit(lambda *a: jattn.chunked_attention(
                *a, causal=causal, kv_chunk=kv_chunk))(
                    jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv))),
            **TOL)


@pytest.mark.parametrize("arch", ["sasrec-recjpq", "gbert4rec-recjpq"])
def test_sequence_embedding_matches(arch):
    jc, tc, jp, tp = _model(arch)
    seqs = _seqs(tc)
    ref = np.asarray(jax.jit(lambda p, s: jseqrec.sequence_embedding(
        p, s, jc))(jp, jnp.asarray(seqs)))
    got = tseqrec.sequence_embedding(tp, _t(seqs), tc).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    if arch == "sasrec-recjpq":
        np.testing.assert_allclose(
            tseqrec.seqrec_hidden(tp, _t(seqs), tc).numpy(),
            np.asarray(jax.jit(lambda p, s: jseqrec.seqrec_hidden(
                p, s, jc))(jp, jnp.asarray(seqs))),
            **TOL)


@pytest.mark.parametrize("arch", ["sasrec-recjpq", "gbert4rec-recjpq"])
def test_serve_topk_every_flat_method(arch):
    jc, tc, jp, tp = _model(arch)
    k = 10
    seqs = _seqs(tc, bq=12, seed=4)
    # The reference's serve path once, whole; for the other routes its phi
    # feeds the head directly (serve_topk's flat body) to skip re-tracing
    # the backbone per route.
    phi = jax.jit(lambda p, s: jseqrec.sequence_embedding(p, s, jc))(
        jp, jnp.asarray(seqs))
    n_checked = {}
    for method in FLAT_METHODS:
        # The block-max route's blocks depend on k, so it is compared at k
        # (k-1 gaps); every other route at k+1 (k gaps).
        kr = k if method == "pqtopk_approx" else k + 1
        if method == "pqtopk_fused":
            out = jax.jit(lambda p, s: jseqrec.serve_topk(
                p, s, jc, k=kr, method=method))(jp, jnp.asarray(seqs))
        else:
            out = jretrieval.top_items(jp["item_emb"], phi, kr,
                                       method=method)[::-1]
        rid, rv = (np.asarray(a) for a in out)
        ids, vals = tseqrec.serve_topk(tp, _t(seqs), tc, k=k, method=method)
        assert ids.dtype == torch.int32 and tuple(ids.shape) == (12, k)
        np.testing.assert_allclose(vals.numpy(), rv[:, :k], **TOL)
        # A zero gap is two items with the same codes: the same vector,
        # which scores identically in both packages and ties to the lower
        # id.  Any other gap must be wide enough that rounding cannot swap.
        gaps = -np.diff(rv, axis=1)
        clear = np.all((gaps > 1e-4) | (gaps == 0), axis=1)
        np.testing.assert_array_equal(ids.numpy()[clear], rid[clear, :k])
        n_checked[method] = int(clear.sum())
    # Every route must have its ids compared on some rows, not just the sum.
    assert min(n_checked.values()) >= 4, n_checked


PRUNED_CONFIGS = (("bitmask", "greedy", False), ("range", "adaptive", False),
                  ("bitmask", "adaptive", True), ("range", "greedy", True))


def test_serve_topk_pruned_is_slice_two():
    """``pqtopk_pruned`` (port slice two) through ``interop``: the
    reference's pruned state converted field for field, both cascades on
    a clustered catalogue of several tiles, each bound backend, seed
    policy and grouping mode, values within 1e-5 and ids equal on clear
    rows (counted per configuration)."""
    from dataclasses import replace

    from repro.core import pruning as jpruning
    base_j = jcfg.get_reduced("sasrec-recjpq").model
    n_items = 6000                                       # 3 pruning tiles
    rng = np.random.default_rng(7)
    centers = (np.arange(n_items + 1) / (n_items + 1) * base_j.pq.b
               ).astype(np.int64)
    codes = np.clip(centers[:, None] + rng.integers(-1, 2, (
        n_items + 1, base_j.pq.m)), 0, base_j.pq.b - 1).astype(
            base_j.pq.code_dtype)
    seqs = _seqs(replace(base_j, n_items=n_items), bq=24, seed=5)
    n_checked = {}
    for backend, policy, grouped in PRUNED_CONFIGS:
        jpq = replace(base_j.pq, bound_backend=backend, seed_policy=policy,
                      query_grouping=grouped, n_groups=8)
        jc = replace(base_j, n_items=n_items, pq=jpq)
        tc = replace(tcfg.get_reduced("sasrec-recjpq").model,
                     n_items=n_items, pq=tcfg.PQConfig(**vars(jpq)))
        tree = _numpy_params(jc)
        tree["item_emb"]["codes"] = codes
        tree["item_emb"]["pruned"] = jax.tree_util.tree_map(
            np.asarray, jpruning.build_pruned_state(
                jnp.asarray(codes), jpq.b, 2048, backend=backend))
        tp = params_from_jax(tree)
        assert tp["item_emb"]["pruned"].backend == backend
        k = 10
        rid, rv, _ = (np.asarray(a) for a in jax.jit(
            lambda p, s: jseqrec.serve_topk(
                p, s, jc, k=k + 1, method="pqtopk_pruned", ladder=(1, 2),
                return_rung=True))(
                    jax.tree_util.tree_map(jnp.asarray, tree),
                    jnp.asarray(seqs)))
        ids, vals, rung = tseqrec.serve_topk(tp, _t(seqs), tc, k=k,
                                             method="pqtopk_pruned",
                                             ladder=(1, 2), return_rung=True)
        assert ids.dtype == torch.int32 and tuple(ids.shape) == (24, k)
        assert rung in (0, 1, 2)
        np.testing.assert_allclose(vals.numpy(), rv[:, :k], **TOL)
        gaps = -np.diff(rv, axis=1)
        clear = np.all((gaps > 1e-4) | (gaps == 0), axis=1)
        np.testing.assert_array_equal(ids.numpy()[clear], rid[clear, :k])
        n_checked[(backend, policy, grouped)] = int(clear.sum())
        # The pruned route is exact: the fused route's winners on the port.
        fids, fvals = tseqrec.serve_topk(tp, _t(seqs), tc, k=k,
                                         method="pqtopk_fused")
        assert torch.equal(ids, fids) and torch.equal(vals, fvals)
    assert min(n_checked.values()) >= 4, n_checked
    with pytest.raises(ValueError, match="return_rung"):
        tseqrec.serve_topk(tp, _t(seqs), tc, method="pqtopk", return_rung=True)
    with pytest.raises(ValueError, match="pin_rung"):
        tseqrec.serve_topk(tp, _t(seqs), tc, method="pqtopk", pin_rung=True)


def test_interop_and_init_trees_agree():
    jc = jcfg.get_reduced("gbert4rec-recjpq").model
    tc = tcfg.get_reduced("gbert4rec-recjpq").model
    jp = jseqrec.init_seqrec(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(_np_tree(jp))
    assert "pruned" in jp["item_emb"] and "pruned" in tp["item_emb"]
    assert tp["item_emb"]["codes"].dtype == torch.uint8
    own = tseqrec.init_seqrec(torch.Generator().manual_seed(0), tc)
    jstate = jp["item_emb"]["pruned"]
    for state in (tp["item_emb"]["pruned"], own["item_emb"]["pruned"]):
        for f in ("tile", "n_items", "b", "shards", "n_local", "backend",
                  "super_factor", "n_tiles", "nbytes"):
            assert getattr(state, f) == getattr(jstate, f), f
        assert state.packed.dtype == torch.int32
        assert tuple(state.packed.shape) == jstate.packed.shape
    np.testing.assert_array_equal(
        tp["item_emb"]["pruned"].packed.numpy(),
        np.asarray(jstate.packed).view(np.int32))
    jflat = jax.tree_util.tree_flatten_with_path(
        {**jp, "item_emb": {k: v for k, v in jp["item_emb"].items()
                            if k != "pruned"}})[0]

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
        want = {tuple(getattr(k, "key", getattr(k, "idx", None))
                      for k in path): (tuple(v.shape), str(v.dtype))
                for path, v in jflat}
        assert got == want
