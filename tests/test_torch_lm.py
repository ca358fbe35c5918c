"""The port's dense LM family (configs, layers, attention, forward, loss,
training launcher) against the JAX reference, on the CPU.

Each reduced model starts from the reference's own ``init_lm(PRNGKey(0))``
with its norm scales and biases redrawn from a numpy seed (the reference
inits them to ones and zeros, which would hide a swapped or skipped
norm), carried over by ``interop.params_from_jax``.  Tolerances: float32
at rtol=atol=1e-5 (the backbone's contract: the two frameworks' matmuls
sum in different orders); the bfloat16 model at rtol=atol=6e-2, about
four bfloat16 ulps at the hidden state's largest magnitudes (measured:
max abs error 0.047 where the hidden state reaches 3.17)."""
import ast
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.launch import train as jtrain
from repro.models import attention as jattn, layers as jlayers
from repro.models import transformer as JT
from repro.training import optimizer as jopt, train_loop as jtl
from repro_torch.configs import base as tcfg
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn, layers as tlayers
from repro_torch.models import transformer as TT

ARCHS = ("gemma3-27b", "qwen2.5-14b", "nemotron-4-340b")
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _redraw_norms(tree, rng):
    """Norm scales to 1 + 0.1 N(0, 1) and biases to 0.1 N(0, 1), in the
    leaf's dtype; everything else kept."""
    if isinstance(tree, list):
        return [_redraw_norms(v, rng) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("scale", "bias", "b") and not isinstance(v, dict):
            a = np.asarray(v)
            noise = 0.1 * rng.standard_normal(a.shape)
            out[k] = jnp.asarray((1.0 if k == "scale" else 0.0) + noise,
                                 a.dtype)
        else:
            out[k] = _redraw_norms(v, rng)
    return out


@functools.cache
def _model(arch, dtype="float32"):
    """(reference cfg, port cfg, reference params, port params).  Another
    ``dtype`` casts the float32 model's weights to the dtypes of the
    reference's own init in that dtype (its ``abstract_lm``), as that
    init draws in float32 and casts."""
    jc, tc = jcfg.get_reduced(arch).model, tcfg.get_reduced(arch).model
    if dtype != "float32":
        jc = dataclasses.replace(jc, dtype=dtype, param_dtype=dtype)
        tc = dataclasses.replace(tc, dtype=dtype, param_dtype=dtype)
        jp = jax.tree_util.tree_map(lambda a, s: a.astype(s.dtype),
                                    _model(arch)[2], JT.abstract_lm(jc))
    else:
        jp = _redraw_norms(jax.jit(lambda key: JT.init_lm(key, jc))(
            jax.random.PRNGKey(0)), np.random.default_rng(7))
    return jc, tc, jp, params_from_jax(_np(jp))


def _layer0(jp):
    """The reference's first layer, sliced on the host (no compile)."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)[0]),
                                  jp["layers"])


def _tokens(cfg, shape=(2, 12), seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def _walk(tree, prefix=""):
    """(path, leaf) of a dict/list tree in the reference's leaf order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ---- configs --------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for get in ("get_config", "get_reduced"):
        j, t = getattr(jcfg, get)(arch), getattr(tcfg, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.model.param_count() == j.model.param_count()
        assert t.model.active_param_count() == j.model.active_param_count()
        assert (t.model.q_dim, t.model.kv_dim) == (j.model.q_dim,
                                                  j.model.kv_dim)
        flags = [t.model.attention.layer_is_global(i)
                 for i in range(t.model.n_layers)]
        assert flags == [j.model.attention.layer_is_global(i)
                         for i in range(j.model.n_layers)]
    assert t.model.pq_head.code_dtype == "int32"
    for sub in (True, False):
        for dec in (True, False):
            assert [dataclasses.asdict(s) for s in tcfg.lm_shapes(
                sub_quadratic=sub, decoder=dec)] == \
                [dataclasses.asdict(s) for s in jcfg.lm_shapes(
                    sub_quadratic=sub, decoder=dec)]
    assert arch in tcfg.list_archs()
    assert set(tcfg.list_archs()) <= set(jcfg.list_archs())
    moe = dataclasses.replace(
        tcfg.get_reduced(arch).model,
        moe=tcfg.MoEConfig(n_experts=4, top_k=2, d_ff_expert=32))
    jmoe = dataclasses.replace(
        jcfg.get_reduced(arch).model,
        moe=jcfg.MoEConfig(n_experts=4, top_k=2, d_ff_expert=32))
    assert moe.param_count() == jmoe.param_count()
    assert moe.active_param_count() == jmoe.active_param_count()


def test_moe_lm_is_refused():
    cfg = dataclasses.replace(
        tcfg.get_reduced("qwen2.5-14b").model,
        moe=tcfg.MoEConfig(n_experts=4, top_k=2, d_ff_expert=32))
    with pytest.raises(NotImplementedError, match="A 7b"):
        TT.init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match="A 7b"):
        TT.init_caches(cfg, 2, 8)


# ---- layers and attention -------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_in_dtype(dtype):
    """Init draws float32 then casts; dense, norms and the MLP against the
    reference in ``dtype`` (float32 at 1e-5, bfloat16 at BF16_TOL)."""
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    g = torch.Generator().manual_seed(0)
    p = tlayers.mlp_init(g, 16, 24, gated=True, dtype=tdt)
    ref = tlayers.mlp_init(torch.Generator().manual_seed(0), 16, 24,
                           gated=True)
    for name in ("up", "down", "gate"):
        assert p[name]["w"].dtype == tdt
        assert torch.equal(p[name]["w"], ref[name]["w"].to(tdt))
    d = tlayers.dense_init(g, 16, 8, bias=True, dtype=tdt)
    assert d["w"].dtype == d["b"].dtype == tdt
    assert tlayers.embedding_init(g, 10, 16, tdt)["table"].dtype == tdt
    n = tlayers.norm_init(16, "layernorm", tdt)
    assert n["scale"].dtype == n["bias"].dtype == tdt
    jref = jax.jit(lambda key: jlayers.mlp_init(key, 16, 24, gated=True,
                                                dtype=jdt))(
        jax.random.PRNGKey(0))
    assert all(a.dtype == jdt for a in jax.tree_util.tree_leaves(jref))

    tol = TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 5, 16)) * 2, jdt)
    tx = params_from_jax(_np(x))
    mp = {k: {"w": jnp.asarray(rng.standard_normal(s) * 0.3, jdt)}
          for k, s in (("up", (16, 24)), ("gate", (16, 24)),
                       ("down", (24, 16)))}
    tmp = params_from_jax(_np(mp))
    for act in ("silu", "gelu", "sqrelu"):
        got = tlayers.mlp(tmp, tx, act)
        assert got.dtype == tdt
        want = jax.jit(lambda p, a: jlayers.mlp(p, a, act))(mp, x)
        np.testing.assert_allclose(got.float().numpy(), _f32(want), **tol)
    npar = {"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(16), jdt),
            "bias": jnp.asarray(0.1 * rng.standard_normal(16), jdt)}
    for kind in ("rmsnorm", "layernorm"):
        np.testing.assert_allclose(
            tlayers.apply_norm(params_from_jax(_np(npar)), tx, kind)
            .float().numpy(), _f32(jax.jit(lambda p, a: jlayers.apply_norm(
                p, a, kind))(npar, x)), **tol)


def test_project_qkv_with_qk_norm():
    jc, tc, jp, tp = _model("gemma3-27b")
    blk_j = _layer0(jp)["attn"]
    blk_t = TT._layer(tp, tc, 0)["attn"]
    assert set(blk_t) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    x = np.random.default_rng(2).standard_normal(
        (2, 6, tc.d_model)).astype(np.float32)
    pos = np.arange(6)[None, :]
    want = jax.jit(lambda p, a, ps: jattn._project_qkv(p, jc.attention, a,
                                                       ps))(
        blk_j, jnp.asarray(x), jnp.asarray(pos))
    got = tattn._project_qkv(blk_t, tc.attention, _t(x), _t(pos))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("kv_chunk", [4, 1024])
def test_windowed_chunked_attention(kv_chunk):
    """The sliding window, and the reference's traced-window form at
    ``window = s + 1`` (its global layers), against the reference."""
    rng = np.random.default_rng(3)
    s = 11
    q = rng.standard_normal((2, s, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, 2, 8)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    dyn = jax.jit(lambda a, b, c, w: jattn._chunked_attention_dyn_window(
        a, b, c, causal=True, window=w, kv_chunk=kv_chunk))
    for window in (3, 8, s + 1):
        got = tattn.chunked_attention(_t(q), _t(k), _t(v), window=window,
                                      kv_chunk=kv_chunk).numpy()
        np.testing.assert_allclose(got, np.asarray(jax.jit(
            lambda a, b, c: jattn.chunked_attention(
                a, b, c, window=window, kv_chunk=kv_chunk))(jq, jk, jv)),
            **TOL)
        np.testing.assert_allclose(got, np.asarray(dyn(
            jq, jk, jv, jnp.int32(window))), **TOL)
    np.testing.assert_allclose(
        tattn.chunked_attention(_t(q), _t(k), _t(v), window=0,
                                kv_chunk=kv_chunk).numpy(),
        tattn.chunked_attention(_t(q), _t(k), _t(v), window=s + 1,
                                kv_chunk=kv_chunk).numpy(), **TOL)
    jc, tc, jp, tp = _model("gemma3-27b")
    blk_j = _layer0(jp)["attn"]
    x = rng.standard_normal((2, s, tc.d_model)).astype(np.float32)
    full = jax.jit(lambda p, a, g: jattn.full_attention(
        p, jc.attention, a, is_global=g, kv_chunk=kv_chunk))
    for is_global in (True, False):
        np.testing.assert_allclose(
            tattn.full_attention(TT._layer(tp, tc, 0)["attn"], tc.attention,
                                 _t(x), is_global=is_global,
                                 kv_chunk=kv_chunk).numpy(),
            np.asarray(full(blk_j, jnp.asarray(x), jnp.asarray(is_global))),
            **TOL)


# ---- forward, loss, gradients ---------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_and_loss_match(arch):
    jc, tc, jp, tp = _model(arch)
    tok = _tokens(tc)
    tgt = np.roll(tok, -1, 1)
    batch = {"tokens": tok, "targets": tgt}
    (jh, jaux), (jl, jm) = jax.jit(lambda p, b: (
        JT.lm_hidden(p, b["tokens"], jc), JT.lm_loss(p, b, jc)))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    th, taux = TT.lm_hidden(tp, _t(tok), tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(
        TT.unembed(tp, th, tc).numpy(),
        np.asarray(JT.unembed(jp, jh, jc)), **TOL)
    # The reference's lm_prefill is lm_hidden's last position.
    np.testing.assert_allclose(TT.lm_prefill(tp, _t(tok), tc).numpy(),
                               np.asarray(jh[:, -1, :]), **TOL)
    tl, tm = TT.lm_loss(tp, {k: _t(v) for k, v in batch.items()}, tc)
    assert set(tm) == set(jm) == {"nll", "aux"}
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradients_match(arch):
    """Every weight's gradient (the PQ head, which the loss never reads,
    left out), with remat on and off: both within TOL of the reference's
    and bit-identical to each other."""
    jc, tc, jp, _ = _model(arch)
    jp = {k: v for k, v in jp.items() if k != "pq_head"}
    tok = _tokens(tc, seed=4)
    batch = {"tokens": tok, "targets": np.roll(tok, 1, 1)}
    jg = jax.jit(jax.grad(lambda p, b: JT.lm_loss(p, b, jc)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    want = list(_walk(_np(jg)))
    grads = {}
    for remat in (True, False):
        tp = params_from_jax(_np(jp))
        leaves = [leaf.requires_grad_(True) for _, leaf in _walk(tp)]
        loss, _ = TT.lm_loss(tp, {k: _t(v) for k, v in batch.items()},
                             dataclasses.replace(tc, remat=remat))
        loss.backward()
        grads[remat] = [leaf.grad for leaf in leaves]
        assert [p for p, _ in _walk(tp)] == [p for p, _ in want]
        for (path, w), g in zip(want, grads[remat], strict=True):
            np.testing.assert_allclose(g.numpy(), w, err_msg=path, **TOL)
    assert all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))


def test_grad_cast_cotangent_dtype():
    """Identity forward; the cotangent leaves in the requested dtype:
    bfloat16 values for a float32 input (the reference hands back a
    bfloat16 cotangent; autograd stores it in the input's float32), and
    a bfloat16 gradient for a bfloat16 input."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(7).astype(np.float32)
    w = rng.standard_normal(7).astype(np.float32)
    jg = jax.grad(lambda a: (JT._grad_cast(a, jnp.bfloat16) * w).sum())(
        jnp.asarray(x))
    assert jg.dtype == jnp.bfloat16
    tx = _t(x).requires_grad_(True)
    y = TT._grad_cast(tx, torch.bfloat16)
    assert torch.equal(y, _t(x))
    (y * _t(w)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), _f32(jg))
    assert not np.array_equal(tx.grad.numpy(), w)
    xb = _t(x).to(torch.bfloat16).requires_grad_(True)
    (TT._grad_cast(xb, torch.bfloat16).float() * _t(w)).sum().backward()
    assert xb.grad.dtype == torch.bfloat16


def test_bfloat16_gemma3_hidden():
    """Reduced gemma3 with dtype and param_dtype bfloat16: the weights
    cross by their bits, and ``lm_hidden`` agrees at BF16_TOL."""
    jc, tc, jp, tp = _model("gemma3-27b", "bfloat16")
    assert tp["layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert tp["pq_head"]["sub_emb"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["embed"]["table"].float().numpy(), _f32(jp["embed"]["table"]))
    tok = _tokens(tc)
    jh, _ = jax.jit(lambda p, t: JT.lm_hidden(p, t, jc))(jp, jnp.asarray(tok))
    th, _ = TT.lm_hidden(tp, _t(tok), tc)
    assert th.dtype == torch.bfloat16
    np.testing.assert_allclose(th.float().numpy(), _f32(jh), **BF16_TOL)


def test_init_lm_tree_matches_reference():
    """The port's own init: the reference's tree, shapes and dtypes
    (``abstract_lm``: stacked layers, the PQ head with its pruning state)
    and the reference's 0.02 embedding scale."""
    for arch in ARCHS:
        tc = tcfg.get_reduced(arch).model
        tp = TT.init_lm(torch.Generator().manual_seed(0), tc)
        jp = JT.abstract_lm(jcfg.get_reduced(arch).model)
        got = [(p, tuple(v.shape), str(v.dtype).split(".")[-1])
               for p, v in _walk({k: v for k, v in tp.items()
                                  if k != "pq_head"})]
        want = [(p, tuple(v.shape), str(v.dtype))
                for p, v in _walk({k: v for k, v in jp.items()
                                   if k != "pq_head"})]
        assert got == want
        for name in ("codes", "sub_emb"):
            assert tuple(tp["pq_head"][name].shape) == \
                jp["pq_head"][name].shape
            assert str(tp["pq_head"][name].dtype).split(".")[-1] == \
                str(jp["pq_head"][name].dtype)
        assert tp["pq_head"]["pruned"].n_items == tc.vocab
        np.testing.assert_allclose(float(tp["embed"]["table"].std()), 0.02,
                                   rtol=0.05)


# ---- the training launcher -------------------------------------------------

def test_train_launcher_lm_matches_reference_steps(capsys):
    """``--arch qwen2.5-14b --reduced --device cpu`` for 3 steps: each
    step's loss within 1e-5 of the reference's train step run from the
    same weights (the launcher's own draw) on the same batches."""
    arch = "qwen2.5-14b"
    out = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "3", "--batch", "4", "--log-every", "1"])
    assert "finished 3 steps" in capsys.readouterr().out
    jarch = jcfg.get_reduced(arch)
    tc = tcfg.get_reduced(arch).model
    init = TT.init_lm(torch.Generator().manual_seed(0), tc)
    jp = jax.tree_util.tree_map(
        jnp.asarray, {k: _to_numpy(v) for k, v in init.items()
                      if k != "pq_head"})
    ocfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3,
                            moment_dtype=jarch.model.moment_dtype)
    step = jax.jit(jtl.make_train_step(
        lambda p, b: JT.lm_loss(p, b, jarch.model), ocfg))
    opt = jtl.init_opt_state(jp, ocfg)
    data, _, _ = jtrain.make_data(jarch, 4)
    losses = []
    for _ in range(3):
        jp, opt, metrics = step(jp, opt, {k: jnp.asarray(v)
                                          for k, v in next(data).items()})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(out["losses"], losses, **TOL)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.numpy()


# ---- the port stands alone -------------------------------------------------

def test_port_imports_no_jax_or_reference():
    """No module of the port, and not ``chip_smoke.py``, imports ``jax``
    or the reference package ``repro``."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [f"{f.relative_to(ROOT)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
