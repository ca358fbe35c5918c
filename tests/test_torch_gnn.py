"""The port's GraphSAGE family (``data/graph.py``, ``models/gnn.py``, the
train launcher's ``gnn`` branch) against the JAX reference, on the CPU.

The graph data are bit-identical from the same seed and generator.  The
models start from the reference's ``init_gnn(PRNGKey(0))`` with its zero
biases redrawn from a numpy seed (a zero bias would hide a dropped one),
carried over by ``interop.params_from_jax``; the three losses and every
weight's gradient agree at float32 rtol=atol=1e-5 (the frameworks'
products sum in different orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.data import graph as jgraph
from repro.launch import train as jtrain
from repro.models import gnn as JG
from repro.training import optimizer as jopt, train_loop as jtl
from repro_torch.configs import base as tcfg
from repro_torch.data import graph as tgraph
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as ttrain
from repro_torch.models import gnn as TG

from test_torch_lm import TOL, _np, _redraw_norms, _t, _to_numpy, _walk

ARCH = "graphsage-reddit"
D_FEAT = 12


def _cfgs(aggregator="mean"):
    jc, tc = jcfg.get_reduced(ARCH).model, tcfg.get_reduced(ARCH).model
    return (dataclasses.replace(jc, aggregator=aggregator),
            dataclasses.replace(tc, aggregator=aggregator))


def _weights(jc, d_feat=D_FEAT):
    jp = _redraw_norms(JG.init_gnn(jax.random.PRNGKey(0), jc, d_feat),
                       np.random.default_rng(7))
    return jp, params_from_jax(_np(jp))


def _full_batch(seed=3):
    g = tgraph.synthetic_graph(200, 1000, D_FEAT, 7, seed=seed)
    mask = np.random.default_rng(seed).integers(0, 2, g.n_nodes)
    return {"feats": g.feats, "edges": g.edges, "labels": g.labels,
            "label_mask": mask.astype(np.float32)}


def _minibatch():
    g = tgraph.synthetic_graph(300, 2400, D_FEAT, 7, seed=4)
    rng = np.random.default_rng(5)
    return tgraph.NeighborSampler(g).sample_batch(
        rng.integers(0, g.n_nodes, 16), (5, 3), rng)


def _losses_match(loss, jloss, batch, jc, tc):
    """The port's loss and its gradient against the reference's jitted
    ``value_and_grad`` from the same weights and batch."""
    jp, tp = _weights(jc)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, b, jc), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [leaf.requires_grad_(True) for _, leaf in _walk(tp)]
    tl, tm = loss(tp, {k: _t(v) for k, v in batch.items()}, tc)
    tl.backward()
    assert set(tm) == set(jm) == {"nll"}
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    want = list(_walk(_np(jg)))
    assert [p for p, _ in _walk(tp)] == [p for p, _ in want]
    for (path, w), leaf in zip(want, leaves, strict=True):
        np.testing.assert_allclose(leaf.grad.numpy(), w, err_msg=path, **TOL)


# ---- data -------------------------------------------------------------------

def test_graph_data_bit_identical():
    for args in ((500, 3000, 8, 5, 0), (1, 4, 3, 2, 9)):
        j, t = jgraph.synthetic_graph(*args), tgraph.synthetic_graph(*args)
        for name in ("edges", "feats", "labels"):
            a, b = getattr(j, name), getattr(t, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert j.n_nodes == t.n_nodes and j.n_classes == t.n_classes
    g = tgraph.synthetic_graph(500, 3000, 8, 5, seed=0)
    js = jgraph.NeighborSampler(jgraph.synthetic_graph(500, 3000, 8, 5))
    ts = tgraph.NeighborSampler(g)
    jr, tr = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(3):   # the generators stay in step across batches
        nodes = tr.integers(0, g.n_nodes, 32)
        np.testing.assert_array_equal(nodes, jr.integers(0, g.n_nodes, 32))
        jb, tb = js.sample_batch(nodes, (6, 4), jr), ts.sample_batch(
            nodes, (6, 4), tr)
        assert set(jb) == set(tb) == {"feats_b", "feats_n1", "feats_n2",
                                      "labels"}
        for name in jb:
            assert jb[name].dtype == tb[name].dtype
            np.testing.assert_array_equal(jb[name], tb[name])
    assert tb["feats_n2"].shape == (32, 6, 4, 8)
    jm, tm = (mod.molecule_batch(12, 30, 64, 16, 2, seed=1)
              for mod in (jgraph, tgraph))
    assert set(jm) == set(tm)
    for name in jm:
        assert jm[name].dtype == tm[name].dtype
        np.testing.assert_array_equal(jm[name], tm[name])


def test_sampler_self_loops_where_degree_zero():
    """A node with no in-edges samples itself (the reference's rule)."""
    g = tgraph.Graph(edges=np.array([[0, 1], [2, 1]], np.int32),
                     feats=np.zeros((3, 2), np.float32),
                     labels=np.zeros(3, np.int32), n_classes=2)
    nbrs = tgraph.NeighborSampler(g).sample_neighbors(
        np.array([0, 1, 2]), 4, np.random.default_rng(0))
    assert (nbrs[0] == 0).all() and (nbrs[2] == 2).all()
    assert set(nbrs[1]) <= {0, 2}


def test_gnn_config_matches_reference():
    for get in ("get_config", "get_reduced"):
        j, t = getattr(jcfg, get)(ARCH), getattr(tcfg, get)(ARCH)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert isinstance(t.model, tcfg.GNNConfig)
    assert [dataclasses.asdict(s) for s in tcfg.gnn_shapes()] == \
        [dataclasses.asdict(s) for s in jcfg.gnn_shapes()]


# ---- the model --------------------------------------------------------------

def test_init_gnn_tree_matches_reference():
    """The port's own draw: the reference's tree (a list of layers),
    shapes, dtypes and scales; ``params_from_jax`` keeps the list."""
    jc, tc = _cfgs()
    tp = TG.init_gnn(torch.Generator().manual_seed(0), tc, 602)
    jp = JG.abstract_gnn(jc, 602)
    got = [(p, tuple(v.shape), str(v.dtype).split(".")[-1])
           for p, v in _walk(tp)]
    assert got == [(p, tuple(v.shape), str(v.dtype)) for p, v in _walk(jp)]
    assert isinstance(tp["layers"], list)
    assert isinstance(_weights(jc)[1]["layers"], list)
    np.testing.assert_allclose(float(tp["layers"][0]["w_self"]["w"].std()),
                               602 ** -0.5, rtol=0.05)


@pytest.mark.parametrize("aggregator", ["mean", "sum"])
def test_gnn_loss_matches(aggregator):
    jc, tc = _cfgs(aggregator)
    _losses_match(TG.gnn_loss, JG.gnn_loss, _full_batch(), jc, tc)


def test_gnn_forward_matches():
    jc, tc = _cfgs()
    jp, tp = _weights(jc)
    b = _full_batch(seed=6)
    want = jax.jit(lambda p, f, e: JG.gnn_forward(p, f, e, jc))(
        jp, jnp.asarray(b["feats"]), jnp.asarray(b["edges"]))
    np.testing.assert_allclose(
        TG.gnn_forward(tp, _t(b["feats"]), _t(b["edges"]), tc).numpy(),
        np.asarray(want), **TOL)


def test_gnn_minibatch_loss_matches():
    jc, tc = _cfgs()
    _losses_match(TG.gnn_minibatch_loss, JG.gnn_minibatch_loss, _minibatch(),
                  jc, tc)


def test_gnn_graph_batch_loss_matches():
    jc, tc = _cfgs()
    batch = tgraph.molecule_batch(8, 10, 20, D_FEAT, 7, seed=2)
    _losses_match(TG.gnn_graph_batch_loss, JG.gnn_graph_batch_loss, batch,
                  jc, tc)


# ---- the training launcher --------------------------------------------------

def test_train_launcher_gnn_matches_reference_steps(capsys):
    """``--arch graphsage-reddit --reduced --device cpu`` for 4 steps: each
    step's loss within 1e-5 of the reference's train step run from the
    same weights (the launcher's own draw) on the reference launcher's
    batches (the same fanout samples)."""
    out = ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--steps", "4", "--batch", "16", "--log-every", "1"])
    assert "finished 4 steps" in capsys.readouterr().out
    jarch = jcfg.get_reduced(ARCH)
    tc = tcfg.get_reduced(ARCH).model
    jp = jax.tree_util.tree_map(jnp.asarray, _to_numpy(TG.init_gnn(
        torch.Generator().manual_seed(0), tc, 32)))
    ocfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4,
                            moment_dtype=jarch.model.moment_dtype)
    step = jax.jit(jtl.make_train_step(
        lambda p, b: JG.gnn_minibatch_loss(p, b, jarch.model), ocfg))
    opt = jtl.init_opt_state(jp, ocfg)
    data, _, _ = jtrain.make_data(jarch, 16)
    losses = []
    for _ in range(4):
        jp, opt, metrics = step(jp, opt, {k: jnp.asarray(v)
                                          for k, v in next(data).items()})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(out["losses"], losses, **TOL)
