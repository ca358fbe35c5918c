"""The port's LM decode path against the JAX reference, on the CPU: the
KV caches and phi step by step (gemma3's 8-slot rings wrap), every head
method, the decode engine, and ports of the reference's own decode tests.

Weights are the reference's ``init_lm(PRNGKey(0))`` with norm scales and
biases redrawn from a numpy seed, and caches its ``init_caches``, both
carried over by ``interop``.  Tolerances: caches and phi at rtol=atol=1e-5
(float32; the frameworks' matmuls sum in different orders); top-k ids
equal and values within 1e-5.  On the reference's own phi every head
gives the same ids, and every PQ head is bit-exact from the reference's
sub-id scores S = phi x sub_emb on (the scoring gathers and adds in the
reference's order; S itself is a float32 matmul, so its last bits
follow each framework's sum order, as do the dense head's values, held
within 1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import retrieval_head as jretrieval, scoring as jscoring
from repro.models import transformer as JT
from repro.serving.engine import DecodeEngine as JDecodeEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs import base as tcfg
from repro_torch.core import retrieval_head as tretrieval
from repro_torch.interop import params_from_jax
from repro_torch.models import attention as tattn, transformer as TT
from repro_torch.serving.engine import DecodeEngine, Request

from test_torch_lm import ARCHS, TOL, _model, _np, _t, _walk

HEADS = ("dense", "pqtopk", "pqtopk_kernel", "pqtopk_fused",
         "pqtopk_pruned", "pqtopk_approx")
STEPS = 12           # past reduced gemma3's 8-slot rings
GLOBAL_STEPS = 4     # the all-global archs have no ring to wrap
MAX_LEN = 16


def _reference_head(jp, phi, jc, k, method):
    """The reference's ``lm_decode_step`` head (transformer.py:247-266)
    on a given phi, jitted as in the decode step -> (ids, values)."""
    ids, vals = jax.jit(lambda p, x: _head(p, x, jc, k, method))(jp, phi)
    return np.asarray(ids), np.asarray(vals)


def _head(jp, phi, jc, k, method):
    if method == "dense":
        w = (jp["embed"]["table"] if jc.tie_embeddings
             else jp["head"]["w"].T)
        vals, ids = jax.lax.top_k(
            jnp.einsum("bd,vd->bv", phi, w.astype(jnp.float32)), k)
    elif method in TT.TOP_ITEMS_HEADS:
        vals, ids = jretrieval.top_items(jp["pq_head"], phi, k,
                                         method=method, pq_cfg=jc.pq_head)
    else:
        vals, ids = jax.lax.top_k(
            jretrieval.score_all(jp["pq_head"], phi, method), k)
    return ids, vals


def _reference_decode(jc):
    """The reference's jitted decode step, also returning its phi (read at
    its "phi" constraint)."""
    seen = {}

    def constrain(x, name):
        seen[name] = x
        return x

    def step(p, t, pos, c):
        orig = JT.constrain
        JT.constrain = constrain
        try:
            ids, vals, c = JT.lm_decode_step(p, t, pos, c, jc, k=8,
                                             head_method="pqtopk")
        finally:
            JT.constrain = orig
        return ids, vals, c, seen["phi"]

    return jax.jit(step)


def _cache_leaves(caches):
    return [leaf for _, leaf in _walk(caches)]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_every_head_match(arch, monkeypatch):
    """Decode steps from one cache state (twelve for gemma3, whose rings
    wrap; four for the all-global archs): caches and phi at every step
    within TOL, and the step's pqtopk top-8 equal (the port reading
    its cache in 5-slot slices, the last one ragged, to cover the slicing
    the card's 32,768-slot caches take).  Then every head method on the
    last step: on the port's phi the same ids and values within TOL; on
    the reference's phi the same ids, and each PQ head bit-exact from the
    reference's S on."""
    monkeypatch.setattr(tattn, "DEFAULT_KV_CHUNK", 5)
    jc, tc, jp, tp = _model(arch)
    bq = 3
    jcache = JT.init_caches(jc, bq, MAX_LEN)
    tcache = params_from_jax(_np(jcache))
    if arch == "gemma3-27b":
        lens = [leaf.shape[1] for leaf in _cache_leaves(tcache)]
        assert lens == [8] * 10 + [MAX_LEN] * 2          # five rings, one global
    step = _reference_decode(jc)
    n = STEPS if arch == "gemma3-27b" else GLOBAL_STEPS
    tokens = np.random.default_rng(11).integers(
        0, jc.vocab, (n, bq)).astype(np.int32)
    for pos in range(n):
        jids, jvals, jcache, jphi = step(jp, jnp.asarray(tokens[pos]),
                                         jnp.int32(pos), jcache)
        tphi = TT._decode_backbone(tp, _t(tokens[pos]), pos, tcache, tc)
        tids, tvals = TT._decode_head(tp, tphi, tc, 8, "pqtopk")
        np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi),
                                   err_msg=f"phi at {pos}", **TOL)
        for got, want in zip(_cache_leaves(tcache), _cache_leaves(
                _np(jcache)), strict=True):
            np.testing.assert_allclose(got.numpy(), want,
                                       err_msg=f"cache at {pos}", **TOL)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), **TOL)
    k = 8
    want = {m: _reference_head(jp, jphi, jc, k, m) for m in HEADS}
    for method in HEADS:
        ids, vals = TT._decode_head(tp, tphi, tc, k, method)
        np.testing.assert_array_equal(ids.numpy(), want[method][0],
                                      err_msg=method)
        np.testing.assert_allclose(vals.numpy(), want[method][1],
                                   err_msg=method, **TOL)
        ids, vals = TT._decode_head(tp, _t(np.asarray(jphi)), tc, k, method)
        np.testing.assert_array_equal(ids.numpy(), want[method][0],
                                      err_msg=method)
        np.testing.assert_allclose(vals.numpy(), want[method][1],
                                   err_msg=method, **TOL)
    ref_s = _t(np.asarray(jscoring.subid_scores(
        jp["pq_head"]["sub_emb"].astype(jnp.float32), jphi)))
    monkeypatch.setattr(tretrieval, "_subid_scores", lambda params, phi: ref_s)
    for method in HEADS[1:]:
        ids, vals = TT._decode_head(tp, _t(np.asarray(jphi)), tc, k, method)
        np.testing.assert_array_equal(ids.numpy(), want[method][0],
                                      err_msg=method)
        np.testing.assert_array_equal(vals.numpy(), want[method][1],
                                      err_msg=method)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_decode_matches_forward(arch):
    """The reference's test, extended to every dense arch: greedy decode's
    top-1 at the last position is the full forward's argmax; and past
    gemma3's ring wrap (12 tokens, window 8), decode's phi equals the
    windowed forward's last hidden state within TOL."""
    _, tc, _, tp = _model(arch)
    n = STEPS if arch == "gemma3-27b" else 8
    tokens = np.random.default_rng(1).integers(0, tc.vocab, (1, n))
    tokens = _t(tokens.astype(np.int32))
    hidden, _ = TT.lm_hidden(tp, tokens, tc)
    logits_full = TT.unembed(tp, hidden, tc)
    caches = TT.init_caches(tc, 1, MAX_LEN)
    for pos in range(n):
        phi = TT._decode_backbone(tp, tokens[:, pos], pos, caches, tc)
    ids, _ = TT._decode_head(tp, phi, tc, tc.vocab, "dense")
    assert int(ids[0, 0]) == int(torch.argmax(logits_full[0, -1]))
    np.testing.assert_allclose(phi.numpy(),
                               TT.lm_prefill(tp, tokens, tc).numpy(), **TOL)


def test_gemma3_sliding_window_cache_shapes():
    cfg = tcfg.get_reduced("gemma3-27b").model
    caches = TT.init_caches(cfg, 2, 128)
    assert isinstance(caches, list)
    flags = TT.layer_types(cfg)
    for i, c in enumerate(caches):
        expected = 128 if flags[i] else cfg.attention.window
        assert c["k"].shape[1] == expected
        assert c["k"].dtype == torch.float32
    assert not flags[:5].any() and flags[5]   # 5 local : 1 global
    stacked = TT.init_caches(tcfg.get_reduced("qwen2.5-14b").model, 2, 16)
    assert tuple(stacked["k"].shape) == (2, 2, 16, 2, 16)


def test_grouped_head_inside_lm_decode_step():
    """The reference's test: with per-query grouping on, the pruned head
    inside the decode step is bit-identical to plain pqtopk (and both to
    the reference's pqtopk step from the same weights; grouping is a
    serving option, so the ungrouped model's weights serve)."""
    jmodel, tmodel, jp, tp = _model("qwen2.5-14b")
    group = dict(query_grouping=True, n_groups=2)
    jc = dataclasses.replace(
        jmodel, pq_head=dataclasses.replace(jmodel.pq_head, **group))
    tc = dataclasses.replace(
        tmodel, pq_head=dataclasses.replace(tmodel.pq_head, **group))
    tok = np.asarray([3, 5], np.int32)
    outs = {}
    for meth in ("pqtopk", "pqtopk_pruned"):
        ids, vals, _ = TT.lm_decode_step(tp, _t(tok), 0,
                                         TT.init_caches(tc, 2, 16), tc, k=8,
                                         head_method=meth)
        outs[meth] = (ids.numpy(), vals.numpy())
    np.testing.assert_array_equal(outs["pqtopk_pruned"][0],
                                  outs["pqtopk"][0])
    np.testing.assert_array_equal(outs["pqtopk_pruned"][1],
                                  outs["pqtopk"][1])
    jids, jvals, _ = jax.jit(lambda p, t, c: JT.lm_decode_step(
        p, t, jnp.int32(0), c, jc, k=8, head_method="pqtopk"))(
            jp, jnp.asarray(tok), JT.init_caches(jc, 2, 16))
    np.testing.assert_array_equal(outs["pqtopk"][0], np.asarray(jids))
    np.testing.assert_allclose(outs["pqtopk"][1], np.asarray(jvals), **TOL)


def test_decode_engine_slots():
    """The reference's test, against the reference's engine: 6 requests
    over 4 slots, 4 tokens each, and the same finished tokens from the
    same weights."""
    jc, tc, jp, tp = _model("qwen2.5-14b")
    n_slots, max_len = 4, 32

    def jdecode(tokens, pos, caches):
        ids, _, caches = JT.lm_decode_step(jp, tokens, pos.max(), caches,
                                           jc, k=4)
        return ids[:, 0], caches

    def tdecode(tokens, pos, caches):
        assert tokens.dtype == pos.dtype == torch.int32
        ids, _, caches = TT.lm_decode_step(tp, tokens, pos.max(), caches,
                                           tc, k=4)
        return ids[:, 0], caches

    jeng = JDecodeEngine(jdecode, lambda b: JT.init_caches(jc, b, max_len),
                         n_slots=n_slots, max_len=max_len)
    teng = DecodeEngine(tdecode, lambda b: TT.init_caches(tc, b, max_len),
                        n_slots=n_slots, max_len=max_len, device="cpu")
    for i in range(6):
        jeng.submit(JRequest(i, np.asarray([i + 1]), k=1))
        teng.submit(Request(i, np.asarray([i + 1]), k=1))
    jfin, tfin = jeng.run(max_new=4), teng.run(max_new=4)
    assert len(tfin) == 6
    for req, toks in tfin:
        assert len(toks) == 4
    assert [(r.request_id, t) for r, t in tfin] == \
        [(r.request_id, t) for r, t in jfin]


def test_decode_engine_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(lambda t, p, c: (t, c), lambda b: None, n_slots=2,
                     max_len=8)
