"""The port's mixture-of-experts FFN (``models/moe.py``) and the MoE LMs'
``moe_impl="sort"`` path against the JAX reference, on the CPU.

Each impl is held against its own reference twin: the output and the aux
loss at float32 rtol=atol=1e-5 (the frameworks' products sum in
different orders), the routing exactly — the chosen experts (read from
the reference's ``lax.top_k``), and the capacity decisions: the dense
impl's 0/1 dispatch tensor (its first einsum's operand), the sort impl's
slots, tokens and keep mask (its group dispatch's outputs).  The
reference's own MoE tests are ported as they stand.  The dense LM path
(the configs' own impl) is covered by the parametrisations of
``tests/test_torch_lm.py`` and ``tests/test_torch_lm_decode.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoE
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.interop import params_from_jax
from repro_torch.models import layers as tlayers, moe as TM
from repro_torch.models import transformer as TT

from test_torch_lm import (MOE_ARCHS, TOL, _model, _np, _t, _tokens, _walk,
                           launcher_matches_reference)
from test_torch_lm_decode import HEADS, _cache_leaves, _reference_head

D = 8
# (n_experts, top_k, capacity_factor, x shape, gated, n_shared)
CASES = {
    "ungated": (4, 2, 16.0, (1, 64, D), False, 0),
    "gated": (4, 2, 16.0, (2, 32, D), True, 0),
    "shared": (8, 2, 1.25, (2, 16, D), True, 1),
    "drops": (4, 2, 0.5, (1, 64, D), True, 0),
    # 6,145 tokens: the group loop lowers 3 groups to 1 (6,145 is odd and
    # not a multiple of 3), so one group holds every token.
    "one_group_of_6145": (8, 1, 0.25, (1, 6145, D), True, 0),
}


def _cfgs(e, k, cf, ns):
    return (JMoE(e, k, 16, n_shared=ns, capacity_factor=cf),
            TMoE(e, k, 16, n_shared=ns, capacity_factor=cf))


def _reference_moe(monkeypatch, jp, jc, x, act, impl):
    """The reference's ``moe_ffn``, jitted, with its routing read back ->
    (out, aux, sel, dispatch (dense) or (slot, st, keep) (sort))."""
    seen = {}
    top_k, einsum, vmap = jax.lax.top_k, jnp.einsum, jax.vmap

    def spy_top_k(a, k):
        out = top_k(a, k)
        seen.setdefault("sel", out[1])
        return out

    def spy_einsum(spec, *ops, **kw):
        if spec == "gtec,gtd->gecd":
            seen["routing"] = ops[0]
        return einsum(spec, *ops, **kw)

    def spy_vmap(f):
        vf = vmap(f)

        def run(*args):
            out = vf(*args)
            if isinstance(out, tuple) and len(out) == 5:
                _, slot, st, _, keep = out
                seen["routing"] = (slot, st, keep)
            return out
        return run

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(jnp, "einsum", spy_einsum)
    monkeypatch.setattr(jax, "vmap", spy_vmap)

    def run(p, a):
        seen.clear()
        out, aux = JM.moe_ffn(p, jc, a, act, impl=impl)
        return out, aux, seen["sel"], seen["routing"]

    out = jax.jit(run)(jp, jnp.asarray(x))
    monkeypatch.undo()
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("impl", ["dense", "sort"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference(monkeypatch, case, impl):
    e, k, cf, shape, gated, ns = CASES[case]
    jc, tc = _cfgs(e, k, cf, ns)
    jp = JM.moe_init(jax.random.PRNGKey(0), jc, D, gated=gated)
    tp = params_from_jax(_np(jp))
    assert tp["router"]["w"].dtype == torch.float32
    assert ("shared" in tp) == bool(ns) and ("gate" in tp) == gated
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    act = "silu" if gated else "relu"
    jout, jaux, jsel, jrouting = _reference_moe(monkeypatch, jp, jc, x, act,
                                                impl)
    out, aux = TM.moe_ffn(tp, tc, _t(x), act, impl=impl)
    assert out.shape == x.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), jout, **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)

    g, tg = TM._groups(x.shape[0] * x.shape[1])
    assert g == jsel.shape[0]
    _, gates, sel = TM._route(tp, tc, _t(x).reshape(g, tg, D))
    np.testing.assert_array_equal(sel.numpy(), jsel)
    c = TM._capacity(tg, tc)
    if impl == "dense":
        dispatch, _ = TM._dense_dispatch(sel, gates, e, c)
        np.testing.assert_array_equal(dispatch.numpy(), jrouting)
        kept = int(dispatch.sum())
    else:
        slot, st, _, keep, _ = TM._sort_dispatch(sel, gates, e, c)
        for got, want in zip((slot, st, keep), jrouting, strict=True):
            np.testing.assert_array_equal(got.numpy(), want)
        kept = int(keep.sum())
    pairs = x.shape[0] * x.shape[1] * k
    assert (kept < pairs) == (case in ("drops", "one_group_of_6145"))


def test_moe_aux_formulas():
    """The two impls' aux losses are each the reference's own formula, and
    they differ (ROADMAP C10): without drops the dense one counts all k
    choices (k times the sort one); with drops it counts only the kept
    pairs, while the sort one counts the choices before any drop."""
    x = np.random.default_rng(1).standard_normal((1, 64, D)).astype(
        np.float32)
    aux = {}
    for cf in (16.0, 0.5):
        jc, tc = _cfgs(4, 2, cf, 0)
        tp = params_from_jax(_np(JM.moe_init(jax.random.PRNGKey(0), jc, D,
                                             gated=False)))
        aux[cf] = [float(TM.moe_ffn(tp, tc, _t(x), "relu", impl=i)[1])
                   for i in ("dense", "sort")]
    np.testing.assert_allclose(aux[16.0][0], 2 * aux[16.0][1], rtol=1e-6)
    assert aux[0.5][1] == aux[16.0][1]          # sort: before the drops
    assert aux[0.5][0] < aux[16.0][0]           # dense: after them


def test_moe_refuses_an_unknown_impl():
    _, tc = _cfgs(4, 2, 1.25, 0)
    tp = TM.moe_init(torch.Generator().manual_seed(0), tc, D, gated=False)
    with pytest.raises(ValueError, match="unknown moe impl"):
        TM.moe_ffn(tp, tc, torch.zeros(1, 4, D), "relu", impl="ragged")


def test_moe_init_tree_matches_reference():
    """The port's own draw: the reference's leaves, shapes and dtypes (the
    router float32 beside bfloat16 experts) and scales."""
    jc, tc = _cfgs(4, 2, 1.25, 1)
    tp = TM.moe_init(torch.Generator().manual_seed(0), tc, 64, gated=True,
                     dtype=torch.bfloat16)
    jp = jax.eval_shape(lambda key: JM.moe_init(key, jc, 64, gated=True,
                                                dtype=jnp.bfloat16),
                        jax.random.PRNGKey(0))
    got = [(p, tuple(v.shape), str(v.dtype).split(".")[-1])
           for p, v in _walk(tp)]
    want = [(p, tuple(v.shape), str(v.dtype)) for p, v in _walk(jp)]
    assert got == want
    np.testing.assert_allclose(float(tp["up"].float().std()), 64 ** -0.5,
                               rtol=0.05)
    np.testing.assert_allclose(float(tp["down"].float().std()), 16 ** -0.5,
                               rtol=0.05)


def test_params_from_jax_moe_tree():
    """``params_from_jax`` carries a bfloat16 MoE ``init_lm`` tree over by
    its bits: stacked (L, E, ...) experts in bfloat16 beside the float32
    (L, d, E) router."""
    arch = "qwen3-moe-30b-a3b"
    jc, tc, jp, tp = _model(arch, "bfloat16")
    moe = tp["layers"]["moe"]
    assert moe["router"]["w"].dtype == torch.float32
    assert tuple(moe["router"]["w"].shape) == (tc.n_layers, tc.d_model,
                                               tc.moe.n_experts)
    assert moe["up"].dtype == moe["gate"].dtype == moe["down"].dtype \
        == torch.bfloat16
    assert tuple(moe["down"].shape) == (tc.n_layers, tc.moe.n_experts,
                                        tc.moe.d_ff_expert, tc.d_model)
    backbone = [{k: v for k, v in tree.items() if k != "pq_head"}
                for tree in (tp, _np(jp))]
    for (path, got), (_, want) in zip(*map(_walk, backbone), strict=True):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32),
                                      err_msg=path)


# ---- the reference's own MoE tests, ported ----------------------------------

@pytest.mark.parametrize("impl", ["dense", "sort"])
def test_moe_impls_equivalent_no_drops(impl):
    """``tests/test_distributed.py``'s oracle, at its tolerance."""
    cfg = TMoE(n_experts=4, top_k=2, d_ff_expert=8, capacity_factor=16.0)
    p = TM.moe_init(torch.Generator().manual_seed(0), cfg, 8, gated=False)
    x = torch.randn((1, 16, 8), generator=torch.Generator().manual_seed(1))
    ref, _ = TM.moe_ffn(p, cfg, x, "relu", impl="dense")
    out, _ = TM.moe_ffn(p, cfg, x, "relu", impl=impl)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-4)


def test_moe_sort_capacity_drops_consistent():
    cfg = TMoE(n_experts=4, top_k=2, d_ff_expert=8, capacity_factor=0.5)
    p = TM.moe_init(torch.Generator().manual_seed(0), cfg, 8, gated=True)
    x = torch.randn((1, 64, 8), generator=torch.Generator().manual_seed(1))
    for impl in ("dense", "sort"):
        out, aux = TM.moe_ffn(p, cfg, x, "silu", impl=impl)
        assert torch.isfinite(out).all()
        assert np.isfinite(float(aux))


def test_moe_routing_topk_and_capacity():
    """``tests/test_models_unit.py``'s: the load-balance loss is near 1 for
    a random router."""
    cfg = TMoE(n_experts=4, top_k=2, d_ff_expert=16, capacity_factor=2.0)
    p = TM.moe_init(torch.Generator().manual_seed(0), cfg, 8, gated=True)
    x = torch.randn((2, 16, 8), generator=torch.Generator().manual_seed(1))
    out, aux = TM.moe_ffn(p, cfg, x, "silu")
    assert out.shape == x.shape
    assert torch.isfinite(out).all()
    assert float(aux) > 0.5


def test_moe_matches_dense_single_expert():
    """1 expert top-1 == the plain MLP with the same weights."""
    cfg = TMoE(n_experts=1, top_k=1, d_ff_expert=16, capacity_factor=8.0)
    p = TM.moe_init(torch.Generator().manual_seed(0), cfg, 8, gated=True)
    x = torch.randn((1, 8, 8), generator=torch.Generator().manual_seed(1))
    out, _ = TM.moe_ffn(p, cfg, x, "silu")
    mlp_p = {name: {"w": p[name][0]} for name in ("up", "gate", "down")}
    np.testing.assert_allclose(out.numpy(),
                               tlayers.mlp(mlp_p, x, "silu").numpy(),
                               rtol=1e-4, atol=1e-5)


# ---- the MoE LMs with moe_impl="sort" -------------------------------------

def _sort_model(arch):
    """The MoE arch with the sort impl, remat off (``test_torch_lm.py``
    holds remat on and off to the same gradients)."""
    jc, tc, jp, tp = _model(arch)
    return (dataclasses.replace(jc, moe_impl="sort", remat=False),
            dataclasses.replace(tc, moe_impl="sort", remat=False), jp, tp)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sort_lm_loss_and_gradients_match(arch):
    """``lm_loss`` (nll and the summed aux) and every weight's gradient
    (the PQ head left out) with the sort impl, within TOL."""
    jc, tc, jp, _ = _sort_model(arch)
    jp = {k: v for k, v in jp.items() if k != "pq_head"}
    tok = _tokens(tc, seed=4)
    batch = {"tokens": tok, "targets": np.roll(tok, 1, 1)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, b, jc), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(_np(jp))
    leaves = [leaf.requires_grad_(True) for _, leaf in _walk(tp)]
    loss, metrics = TT.lm_loss(tp, {k: _t(v) for k, v in batch.items()}, tc)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    aux = float(metrics["aux"].detach())
    np.testing.assert_allclose(aux, float(jm["aux"]), **TOL)
    assert aux > 0.5 * tc.n_layers
    want = list(_walk(_np(jg)))
    assert [p for p, _ in _walk(tp)] == [p for p, _ in want]
    for (path, w), leaf in zip(want, leaves, strict=True):
        np.testing.assert_allclose(leaf.grad.numpy(), w, err_msg=path, **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sort_decode_steps_and_every_head_match(arch):
    """3 decode steps with the sort impl from one cache state: phi and the
    stacked caches within TOL at each step; then every head on the last
    phi gives the reference's ids."""
    jc, tc, jp, tp = _sort_model(arch)
    bq = 3
    jcache = JT.init_caches(jc, bq, 8)
    tcache = params_from_jax(_np(jcache))
    tokens = np.random.default_rng(11).integers(
        0, jc.vocab, (3, bq)).astype(np.int32)
    step = jax.jit(lambda p, t, pos, c: JT.lm_decode_step(
        p, t, pos, c, jc, k=8))
    for pos in range(3):
        jids, _, jcache = step(jp, jnp.asarray(tokens[pos]), jnp.int32(pos),
                               jcache)
        phi = TT._decode_backbone(tp, _t(tokens[pos]), pos, tcache, tc)
        tids, _ = TT._decode_head(tp, phi, tc, 8, "pqtopk")
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        for got, want in zip(_cache_leaves(tcache),
                             _cache_leaves(_np(jcache)), strict=True):
            np.testing.assert_allclose(got.numpy(), want, **TOL)
    for method in HEADS:
        ids, _ = TT._decode_head(tp, phi, tc, 8, method)
        np.testing.assert_array_equal(
            ids.numpy(), _reference_head(jp, jnp.asarray(phi.numpy()), jc, 8,
                                         method)[0], err_msg=method)


def test_train_launcher_moe_matches_reference_steps(capsys):
    """``--arch qwen3-moe-30b-a3b --reduced --device cpu`` for 3 steps,
    each step's loss (nll + 0.01 aux) within 1e-5 of the reference's
    train step from the same weights on the same batches."""
    launcher_matches_reference("qwen3-moe-30b-a3b", capsys)
