"""The port's sharding module and meshes against the JAX reference on the
CPU: parameter rules and shardings for every registry arch at full width
(abstract trees, so nothing is allocated), the three activation plans on
both production meshes, ``strip_axis``, ``constrain`` and the meshes'
factories, and the models' constrain points in order.

The reference's specs are read on ``AbstractMesh`` (no devices needed)
and its constraints from the jaxpr of each forward on a one-device mesh
with Auto axes (``jax.sharding.Mesh``; ``jax.make_mesh`` gives Explicit
axes, which ``with_sharding_constraint`` refuses: ROADMAP C3).  Specs are
compared exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, Mesh, PartitionSpec as JP

from repro.analysis.core import find_eqns
from repro.configs import get_reduced as jget_reduced
from repro.configs.base import get_config as jget_config
from repro.data import recsys_data as jrdata
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.models import gnn as JG, recsys as JR, seqrec as JS
from repro.models import transformer as JT
from repro_torch.configs.base import get_config, get_reduced, list_archs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import gnn as TG, recsys as TR, seqrec as TS
from repro_torch.models import transformer as TT

AXES3 = ("pod", "data", "model")
PROD = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), AXES3)}


def _spec(spec):
    """A spec (either package's) as a tuple of None / name / tuple."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def _port_mesh(multi_pod):
    return tmesh.make_production_mesh(multi_pod=multi_pod,
                                      devices=["meta"] * (
                                          512 if multi_pod else 256))


def _ref_mesh(multi_pod):
    return AbstractMesh(*PROD[multi_pod])


# ---- twins of the reference's tests/test_distributed.py ---------------------

def test_param_rules_match_lm_paths():
    rules = shd.lm_param_rules(scan_layers=True)
    assert shd._match(rules, "layers/mlp/up/w", 3) == \
        shd.P(None, "data", "model")
    assert shd._match(rules, "layers/moe/up", 4) == \
        shd.P(None, "model", "data", None)
    assert shd._match(rules, "pq_head/codes", 2) == shd.P("model", None)
    assert shd._match(rules, "final_norm/scale", 1) == shd.P()
    for scan in (True, False):
        assert [(p, _spec(s)) for p, s in shd.lm_param_rules(scan)] == \
            [(p, _spec(s)) for p, s in jshd.lm_param_rules(scan)]
    assert [(p, _spec(s)) for p, s in shd.gnn_param_rules()] == \
        [(p, _spec(s)) for p, s in jshd.gnn_param_rules()]


def test_param_shardings_drop_nondividing_axes():
    one = tmesh.ShardMesh(["cpu"], ("data", "model"), (1, 1))
    params = {"embed": {"table": torch.empty((7, 5), device="meta")}}
    out = shd.param_shardings(one, params, shd.lm_param_rules())
    assert isinstance(out["embed"]["table"], shd.NamedSharding)
    assert out["embed"]["table"].spec == shd.P("model", "data")
    assert out["embed"]["table"].mesh is one
    two = tmesh.ShardMesh(["cpu"] * 4, ("data", "model"), (2, 2))
    assert shd.param_shardings(two, params, shd.lm_param_rules())[
        "embed"]["table"].spec == shd.P(None, None)


def test_strip_axis():
    mesh = tmesh.make_mesh(1, ["cpu"])
    plan = shd.ShardingPlan(mesh, {
        "a": shd.P(("pod", "data"), "model", None),
        "b": shd.P("pod", None),
        "c": shd.P(("pod",), "model"),
    })
    out = shd.strip_axis(plan, "pod")
    assert out.specs["a"] == shd.P("data", "model", None)
    assert out.specs["b"] == shd.P(None, None)
    assert out.specs["c"] == shd.P(None, "model")
    ref = jshd.strip_axis(jshd.ShardingPlan(None, {
        k: JP(*v) for k, v in plan.specs.items()}), "pod")
    assert {k: _spec(v) for k, v in out.specs.items()} == \
        {k: _spec(v) for k, v in ref.specs.items()}


def test_constrain_noop_without_plan():
    x = torch.ones((4, 4))
    assert shd.constrain(x, "hidden") is x
    assert shd.current_plan() is None


def test_constrain_applies_inside_plan():
    """The reference's own twin fails under JAX 0.9 (C3); held to its
    oracle: the values unchanged and the spec recorded, a spec longer
    than the tensor skipped, an unknown name a no-op."""
    mesh = tmesh.make_mesh(1, ["cpu"])
    plan = shd.ShardingPlan(mesh, {"hidden": shd.P("model", None),
                                   "cube": shd.P(None, None, "model")})
    x = torch.ones((4, 4))
    with shd.activation_plan(plan) as active, \
            shd.record_constraints() as rec:
        assert shd.current_plan() is active is plan
        y = shd.constrain(x, "hidden")
        assert shd.constrain(x, "cube") is x
        assert shd.constrain(x, "absent") is x
    assert y is x and float(y.sum()) == 16
    assert rec == [("hidden", shd.P("model", None), (4, 4))]
    assert shd.current_plan() is None
    bad = shd.ShardingPlan(mesh, {"hidden": shd.P("data", None)})
    with shd.activation_plan(bad), pytest.raises(ValueError, match="data"):
        shd.constrain(x, "hidden")


# ---- meshes ---------------------------------------------------------------------

class _FakeJax:
    """Stands in for ``jax`` inside ``repro.launch.mesh``: n devices, and
    ``make_mesh`` returns what it was asked for."""

    def __init__(self, n):
        self.n = n

    def devices(self):
        return list(range(self.n))

    @staticmethod
    def make_mesh(shape, axes):
        return tuple(shape), tuple(axes)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_meshes_match_reference(monkeypatch, multi_pod):
    """``make_production_mesh`` and ``make_test_mesh`` give the reference's
    axes and shapes (``make_test_mesh`` for 1..16 devices), in row-major
    device order; with ``devices=None`` they ask for one GPU each."""
    monkeypatch.setattr(jmesh, "jax", _FakeJax(512))
    shape, axes = jmesh.make_production_mesh(multi_pod=multi_pod)
    mesh = _port_mesh(multi_pod)
    assert mesh.axis_names == axes
    assert tuple(mesh.shape.values()) == shape and mesh.size == np.prod(shape)
    for n in range(1, 17):
        monkeypatch.setattr(jmesh, "jax", _FakeJax(n))
        want = jmesh.make_test_mesh(multi_pod=multi_pod)
        got = tmesh.make_test_mesh(multi_pod=multi_pod,
                                   devices=[f"cpu:{i}" for i in range(n)])
        assert (tuple(got.shape.values()), got.axis_names) == want, n
        assert [d.index for d in got.devices] == list(range(n))
    grid = tmesh.make_test_mesh(multi_pod=True,
                                devices=[f"cpu:{i}" for i in range(8)])
    assert grid.device_at(pod=1).index == 4 and \
        grid.device_at(pod=1, data=1, model=1).index == 7
    assert [d.index for d in grid.axis_devices("pod")] == [0, 4]
    assert [d.index for d in grid.axis_devices("model")] == [0, 1]
    if torch.cuda.device_count() < 512:
        with pytest.raises(RuntimeError, match="GPU"):
            tmesh.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(ValueError):
        tmesh.ShardMesh(["cpu"] * 3, AXES3, (2, 1, 2))


# ---- parameter shardings and plans, spec for spec ------------------------------

def _rules(arch, mod):
    fam = arch.family
    if fam == "seqrec":
        return mod.seqrec_param_rules()
    if fam == "recsys":
        return mod.recsys_param_rules()
    if fam == "lm":
        return mod.lm_param_rules(arch.model.scan_layers)
    return mod.gnn_param_rules()


def _abstract_pair(arch, ref_arch):
    fam = arch.family
    if fam == "seqrec":
        return (TS.abstract_seqrec(arch.model),
                JS.abstract_seqrec(ref_arch.model))
    if fam == "recsys":
        return (TR.abstract_recsys(arch.model),
                JR.abstract_recsys(ref_arch.model))
    if fam == "lm":
        return TT.abstract_lm(arch.model), JT.abstract_lm(ref_arch.model)
    d_feat = arch.shapes[0].dims["d_feat"]
    return (TG.abstract_gnn(arch.model, d_feat),
            JG.abstract_gnn(ref_arch.model, d_feat))


def _port_specs(tree, path=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_specs(v, path + (k,)))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_port_specs(v, path + (i,)))
    elif isinstance(tree, shd.NamedSharding):
        out[shd.path_str(path)] = _spec(tree.spec)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            val = getattr(tree, f.name)
            if isinstance(val, shd.NamedSharding):
                out.update(_port_specs(val, path + (f.name,)))
    return out


@pytest.mark.parametrize("arch_id", list_archs())
def test_param_shardings_match_reference(arch_id):
    """Every registry arch at full width, with its family's rules, on the
    single- and multi-pod production meshes: the same spec per leaf."""
    arch, ref_arch = get_config(arch_id), jget_config(arch_id)
    port, ref = _abstract_pair(arch, ref_arch)
    for multi_pod in (False, True):
        got = _port_specs(shd.param_shardings(_port_mesh(multi_pod), port,
                                              _rules(arch, shd)))
        want = {jshd.path_str(p): _spec(s.spec) for p, s in
                jax.tree_util.tree_flatten_with_path(jshd.param_shardings(
                    _ref_mesh(multi_pod), ref, _rules(ref_arch, jshd)))[0]}
        assert got == want
    rep = shd.replicated(_port_mesh(False), port)
    assert set(_port_specs(rep).values()) == {()}


def test_activation_plans_match_reference():
    """The LM plan under every flag, the recsys and GNN plans, and the
    batch axes, on both production meshes."""
    for multi_pod in (False, True):
        pm, rm = _port_mesh(multi_pod), _ref_mesh(multi_pod)
        assert shd.batch_axes(pm) == jshd.batch_axes(rm)
        pairs = [(shd.recsys_activation_plan(pm),
                  jshd.recsys_activation_plan(rm)),
                 (shd.gnn_activation_plan(pm), jshd.gnn_activation_plan(rm))]
        for seq in (False, True):
            for tp in (False, True):
                for vocab in (False, True):
                    kw = dict(shard_seq=seq, tp_internal=tp, vocab_tp=vocab)
                    pairs.append((shd.lm_activation_plan(pm, **kw),
                                  jshd.lm_activation_plan(rm, **kw)))
        for port, ref in pairs:
            assert port.mesh is pm
            assert {k: _spec(v) for k, v in port.specs.items()} == \
                {k: _spec(v) for k, v in ref.specs.items()}
            for name in port.specs:
                assert _spec(port.sharding(name).spec) == \
                    _spec(ref.sharding(name).spec)
            assert port.sharding("absent") is None
            stripped = shd.strip_axis(port, "pod")
            assert {k: _spec(v) for k, v in stripped.specs.items()} == \
                {k: _spec(v) for k, v in jshd.strip_axis(ref, "pod")
                 .specs.items()}


# ---- the models' constrain points, in order --------------------------------------

def _ref_points(fn, plan, *args):
    """The reference's constraints in the jaxpr of ``fn`` (its parameters
    abstract: only shapes are read)."""
    with jshd.activation_plan(plan):
        jx = jax.make_jaxpr(fn)(*args)
    return [(_spec(e.params["sharding"].spec),
             tuple(e.invars[0].aval.shape))
            for e, _ in find_eqns(jx, {"sharding_constraint"})]


def _port_points(fn, plan, *args):
    with shd.activation_plan(plan), shd.record_constraints() as rec, \
            torch.no_grad():
        fn(*args)
    return [(_spec(spec), shape) for _, spec, shape in rec], \
        [name for name, _, _ in rec]


def _plans(kind):
    """The family's standard plan (with the Megatron-SP extras) in both
    packages, on a one-device (pod, data, model) mesh."""
    jm = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1), AXES3)
    tm = tmesh.ShardMesh(["cpu"], AXES3, (1, 1, 1))

    def build(mod, mesh):
        lm = mod.lm_activation_plan(mesh, tp_internal=True)
        if kind == "lm":
            return lm
        if kind == "gnn":
            return mod.gnn_activation_plan(mesh)
        specs = dict(mod.recsys_activation_plan(mesh).specs)
        for name in ("mlp_hidden", "attn_q_heads", "phi"):
            specs[name] = lm.specs[name]
        return mod.ShardingPlan(mesh, specs)

    return build(jshd, jm), build(shd, tm)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_constrain_points_match_reference_jaxpr():
    """A reduced seqrec (serve and loss), recsys (DCN-v2's logits, BST and
    FM retrieval), LM (loss with unrolled layers, one decode step with the
    dense head) and GNN forward, each under its plan: the port records the
    reference's ``sharding_constraint`` equations, spec and shape, in
    order, and every one of the reference's 14 points is reached."""
    names = set()
    rng = np.random.default_rng(0)

    # seqrec
    jp, tp = _plans("seqrec")
    jc, tc = jget_reduced("sasrec-recjpq").model, get_reduced(
        "sasrec-recjpq").model
    jpar = JS.abstract_seqrec(jc)
    tpar = TS.init_seqrec(torch.Generator().manual_seed(0), tc)
    seq = rng.integers(1, tc.n_items + 1, (2, tc.max_seq_len)).astype(
        np.int32)
    for jfn, tfn in (
            (lambda p, s: JS.serve_topk(p, s, jc, k=5),
             lambda p, s: TS.serve_topk(p, s, tc, k=5)),
            (lambda p, s: JS.seqrec_loss(p, {"input_seq": s, "targets": s,
                                             "negatives": s[..., None]}, jc),
             lambda p, s: TS.seqrec_loss(p, {"input_seq": s, "targets": s,
                                             "negatives": s[..., None]},
                                         tc))):
        got, seen = _port_points(tfn, tp, tpar, _t(seq))
        assert got == _ref_points(jfn, jp, jpar, jnp.asarray(seq))
        names |= set(seen)

    # recsys
    jp, tp = _plans("recsys")
    for arch in ("dcn-v2", "bst", "fm"):
        jc, tc = jget_reduced(arch).model, get_reduced(arch).model
        jpar = JR.abstract_recsys(jc)
        tpar = TR.init_recsys(torch.Generator().manual_seed(0), tc,
                              device="cpu")
        batch = next(jrdata.ctr_batches(jc, 4, seed=1))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: _t(v) for k, v in batch.items()}
        fns = [(lambda p, b: JR.retrieve_topk(p, b, jc, k=5),
                lambda p, b: TR.retrieve_topk(p, b, tc, k=5))]
        if arch == "dcn-v2":
            fns.append((lambda p, b: JR.ctr_logits(p, b, jc),
                        lambda p, b: TR.ctr_logits(p, b, tc)))
        for jfn, tfn in fns:
            got, seen = _port_points(tfn, tp, tpar, tb)
            assert got == _ref_points(jfn, jp, jpar, jb)
            names |= set(seen)

    # LM: unrolled layers, so the points sit in one order in both
    jp, tp = _plans("lm")
    jc = dataclasses.replace(jget_reduced("qwen2.5-14b").model,
                             scan_layers=False)
    tc = dataclasses.replace(get_reduced("qwen2.5-14b").model,
                             scan_layers=False)
    jpar = JT.abstract_lm(jc)
    tpar = TT.init_lm(torch.Generator().manual_seed(0), tc)
    tok = rng.integers(0, tc.vocab, (2, 8)).astype(np.int32)
    got, seen = _port_points(
        lambda p, t: TT.lm_loss(p, {"tokens": t, "targets": t}, tc), tp,
        tpar, _t(tok))
    assert got == _ref_points(
        lambda p, t: JT.lm_loss(p, {"tokens": t, "targets": t}, jc), jp,
        jpar, jnp.asarray(tok))
    names |= set(seen)
    jcache = JT.init_caches(jc, 2, 8)
    tcache = TT.init_caches(tc, 2, 8)
    for head in ("dense", "pqtopk"):
        got, seen = _port_points(
            lambda p, t, c: TT.lm_decode_step(p, t, 3, c, tc, k=4,
                                              head_method=head),
            tp, tpar, _t(tok[:, 0]), tcache)
        assert got == _ref_points(
            lambda p, t, c: JT.lm_decode_step(p, t, jnp.int32(3), c, jc,
                                              k=4, head_method=head),
            jp, jpar, jnp.asarray(tok[:, 0]), jcache)
        names |= set(seen)

    # GNN
    jp, tp = _plans("gnn")
    jc, tc = jget_reduced("graphsage-reddit").model, get_reduced(
        "graphsage-reddit").model
    jpar = JG.abstract_gnn(jc, 8)
    tpar = TG.init_gnn(torch.Generator().manual_seed(0), tc, 8)
    feats = rng.standard_normal((10, 8)).astype(np.float32)
    edges = rng.integers(0, 10, (24, 2)).astype(np.int32)
    got, seen = _port_points(lambda p, f, e: TG.gnn_forward(p, f, e, tc),
                             tp, tpar, _t(feats), _t(edges))
    assert got == _ref_points(lambda p, f, e: JG.gnn_forward(p, f, e, jc),
                              jp, jpar, jnp.asarray(feats),
                              jnp.asarray(edges))
    names |= set(seen)
    assert names == {"seq_hidden", "phi", "attn_q_heads", "mlp_hidden",
                     "hidden", "logits", "scores", "edge_feats"}
