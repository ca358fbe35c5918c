"""The port's dry-run step builders (``launch/steps.py``) against the
reference's, on the CPU -- the twin of ``tests/test_launch_steps.py``.

Every (arch x active shape) bundle builds on meta with the reference's
argument shapes and dtypes, ``meta`` and ``donate``.  Reduced steps of
every family run in both packages on the same inputs: the port's
``materialize`` draws them from a seed, and the same values (uint32
presence words from the port's int32 bits, bfloat16 exactly) go into the
reference's jitted step, run without its activation plan.  Shapes are
cut as well as the model (``get_reduced`` keeps the full shape dims), and
both packages get the same override.  Tolerances: float outputs at
rtol=atol=1e-5 (the frameworks' float32 sums differ in order); top-k ids
equal wherever the values are not tied within that tolerance."""
import dataclasses
import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_reduced as jget_reduced
from jax.sharding import AbstractMesh

from repro.launch import steps as jsteps
from repro_torch.configs.base import get_config, get_reduced, list_archs
from repro_torch.launch import steps
from repro_torch.training import tree as tree_lib

from test_torch_abstract import assert_same_tree

TOL = dict(rtol=1e-5, atol=1e-5)
#: Shape dims of the reduced steps (the rest kept).
CUT = {"global_batch": 2, "seq_len": 16, "batch_nodes": 8, "fanout": (3, 2),
       "graph_batch": 4, "n_candidates": 64, "d_feat": 16}
GRAPH_CUT = {"full_graph_sm": (300, 1200), "ogb_products": (300, 1200),
             "minibatch_lg": (300, 1200), "molecule": (30, 64)}


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def cut(arch):
    """``arch`` with every shape's dims cut to :data:`CUT` (graphs to a few
    hundred nodes); the same function cuts either package's config."""
    def dims(sh):
        d = {k: CUT.get(k, v) for k, v in sh.dims.items()}
        if sh.name in GRAPH_CUT:
            d["n_nodes"], d["n_edges"] = GRAPH_CUT[sh.name]
        return d
    return dataclasses.replace(arch, shapes=tuple(
        dataclasses.replace(sh, dims=dims(sh)) for sh in arch.shapes))


def cells():
    return [(a, sh.name) for a in list_archs()
            for sh in get_config(a).active_shapes()]


@pytest.mark.parametrize("arch_id,shape_name", cells())
def test_bundle_matches_reference(arch_id, shape_name, mesh):
    """Full width, on meta: one device per argument, the reference's
    argument trees leaf for leaf, its ``meta`` key for key and its
    ``donate``."""
    port = steps.build_step(arch_id, shape_name)
    ref = jsteps.build_step(arch_id, shape_name, mesh)
    assert len(port.args) == len(port.in_shardings) == len(ref.args)
    assert all(d == torch.device("meta") for d in port.in_shardings)
    assert_same_tree(list(port.args), list(ref.args))
    assert port.meta == ref.meta
    assert port.donate == ref.donate
    assert port.plan is None
    assert port.name == ref.name


VARIANT_CELLS = [
    ("qwen2.5-14b", "decode_32k", "pruned_range_head"),
    ("qwen2.5-14b", "decode_32k", "perquery_head"),
    ("gemma3-27b", "decode_32k", "fused_head"),
    ("qwen2.5-14b", "train_4k", "seqpar_tp_dots"),
    ("qwen3-moe-30b-a3b", "train_4k", "moe_sort"),
    ("sasrec-recjpq", "serve_users", "hier_head"),
    ("sasrec-recjpq", "serve_users", "mutable_head"),
    ("sasrec-recjpq", "serve_users", "pruned_range_head"),
    ("gbert4rec-recjpq", "serve_users", "perquery_head"),
    ("fm", "retrieval_cand", "fused_head"),
]


@pytest.mark.parametrize("arch_id,shape_name,variant", VARIANT_CELLS)
def test_variant_bundle_matches_reference(arch_id, shape_name, variant,
                                          mesh):
    port = steps.build_step(arch_id, shape_name, variant=variant)
    ref = jsteps.build_step(arch_id, shape_name, mesh, variant)
    assert_same_tree(list(port.args), list(ref.args))
    assert port.meta == ref.meta


@pytest.mark.parametrize("variant", [
    "noseq", "seqpar_tp", "vocab_tp", "moe_sort_vocab_tp", "gradrs",
    "seqpar_gradrs", "powersgd", "sharded_head", "sharded_fused",
    "sharded_head_bm"])
def test_mesh_variants_build_on_one_device(variant):
    """On one device a variant that only changes shardings, or reads a
    mesh axis, builds the baseline's step: the same arguments (PowerSGD
    without its ``pod`` axis keeps no error feedback), one device per
    argument and no plan."""
    arch = _two_layers(get_config("qwen2.5-14b"))
    port = steps.build_step("qwen2.5-14b", "train_4k", variant=variant,
                            arch_override=arch)
    base = steps.build_step("qwen2.5-14b", "train_4k", arch_override=arch)
    assert [(p, t.shape, t.dtype) for p, t in
            tree_lib.leaves_with_path(list(port.args))] == \
        [(p, t.shape, t.dtype) for p, t in
         tree_lib.leaves_with_path(list(base.args))]
    assert "ef" not in port.args[1]
    assert all(d == torch.device("meta") for d in port.in_shardings)
    assert port.plan is None and port.mesh is None
    assert port.meta == dict(base.meta, variant=variant)


# ---------------------------------------------------------------------------
# bundles over the production meshes, spec for spec
# ---------------------------------------------------------------------------

PROD = {"single": ((16, 16), ("data", "model")),
        "multi": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def port_mesh(kind):
    from repro_torch.launch.mesh import make_production_mesh
    return make_production_mesh(multi_pod=kind == "multi",
                                devices=["meta"] * math.prod(PROD[kind][0]))


def _norm(spec):
    """A spec of either package as a tuple of None / name / tuple of
    names (a one-name tuple as the name, an empty one as None)."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else (e or None)
        out.append(e)
    return tuple(out)


def assert_same_shardings(port, ref, kind):
    """``in_shardings`` leaf for leaf with ``args`` and spec for spec with
    the reference's, on the port's mesh; the plans name the same specs."""
    mesh = port_mesh(kind)
    assert port.mesh is mesh
    got = tree_lib.leaves(list(port.in_shardings))
    want = jax.tree.leaves(list(ref.in_shardings))
    assert len(got) == len(want) == len(tree_lib.leaves(list(port.args)))
    assert all(sh.mesh is mesh for sh in got)
    assert [_norm(sh.spec) for sh in got] == [_norm(sh.spec) for sh in want]
    assert {k: _norm(v) for k, v in port.plan.specs.items()} == \
        {k: _norm(v) for k, v in ref.plan.specs.items()}
    assert port.plan.mesh is mesh


@pytest.fixture(scope="module")
def cached_abstract():
    """Both packages' abstract parameter trees memoised by config: pure
    functions of it (meta tensors and ``ShapeDtypeStruct``s, never run
    here), which every variant of a cell rebuilds."""
    from repro.models import recsys as JR, seqrec as JS, transformer as JT
    from repro_torch.models import recsys as TR, seqrec as TS
    from repro_torch.models import transformer as TT
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((JT, "abstract_lm"), (TT, "abstract_lm"),
                          (JS, "abstract_seqrec"), (TS, "abstract_seqrec"),
                          (JR, "abstract_recsys"), (TR, "abstract_recsys")):
            mp.setattr(mod, name, functools.lru_cache(maxsize=None)(
                getattr(mod, name)))
        yield


@pytest.mark.parametrize("mesh_kind", sorted(PROD))
@pytest.mark.parametrize("arch_id,shape_name", cells())
def test_mesh_bundle_matches_reference(arch_id, shape_name, mesh_kind,
                                       cached_abstract):
    """Every active cell at full width on both production meshes (the
    LMs cut to 2 layers in both packages): the reference's ``build_step``
    on ``AbstractMesh`` gives the oracle for the arguments, shardings,
    plan, ``donate`` and ``meta``."""
    port = steps.build_step(arch_id, shape_name, port_mesh(mesh_kind),
                            arch_override=_two_layers(get_config(arch_id)))
    ref = jsteps.build_step(arch_id, shape_name,
                            AbstractMesh(*PROD[mesh_kind]),
                            arch_override=_two_layers(jget_config(arch_id)))
    assert_same_tree(list(port.args), list(ref.args))
    assert_same_shardings(port, ref, mesh_kind)
    assert (port.donate, port.meta, port.name) == (ref.donate, ref.meta,
                                                   ref.name)


#: One cell per shape kind of each family, every variant name of its
#: family on it.  The LMs are cut to 2 layers in both packages (their
#: specs do not depend on the depth).
MESH_VARIANT_CELLS = [("qwen2.5-14b", "train_4k"),
                      ("qwen2.5-14b", "prefill_32k"),
                      ("qwen2.5-14b", "decode_32k"),
                      ("qwen3-moe-30b-a3b", "train_4k"),
                      ("sasrec-recjpq", "serve_users"),
                      ("sasrec-recjpq", "train_seq"),
                      ("fm", "retrieval_cand")]


def _two_layers(arch):
    if arch.family != "lm":
        return arch
    return dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, n_layers=2))


@pytest.mark.parametrize("arch_id,shape_name,variant", [
    (a, s, v) for a, s in MESH_VARIANT_CELLS
    for v in steps.VARIANTS[get_config(a).family]])
def test_mesh_variant_matches_reference(arch_id, shape_name, variant,
                                       cached_abstract):
    for kind in sorted(PROD):
        port = steps.build_step(
            arch_id, shape_name, port_mesh(kind), variant,
            arch_override=_two_layers(get_config(arch_id)))
        ref = jsteps.build_step(
            arch_id, shape_name, AbstractMesh(*PROD[kind]), variant,
            arch_override=_two_layers(jget_config(arch_id)))
        assert_same_tree(list(port.args), list(ref.args))
        assert_same_shardings(port, ref, kind)
        assert port.meta == ref.meta


def test_variant_names_cover_the_reference():
    """Every variant name the reference's builders compare against is in
    the port's list of its family, and the lists' sizes are the matrix's
    (18 LM, 19 seqrec, 5 recsys, 1 GNN names)."""
    src = open(jsteps.__file__).read()
    names = set(re.findall(
        r'"((?:sharded_|moe_sort|vocab_tp|seqpar|noseq|powersgd|gradrs)'
        r'[a-z_]*[a-z]|[a-z_]+_head)"', src)) - {"pq_head"}   # a param key
    known = set().union(*steps.VARIANTS.values())
    assert names <= known, names - known
    assert {f: len(v) for f, v in steps.VARIANTS.items()} == \
        {"lm": 18, "seqrec": 19, "recsys": 5, "gnn": 1}


def test_documented_skips_raise():
    with pytest.raises(ValueError, match="documented skip"):
        steps.build_step("qwen2.5-14b", "long_500k")


def test_cell_count_matches_brief():
    assigned = [a for a in list_archs()
                if a not in ("sasrec-recjpq", "gbert4rec-recjpq")]
    assert sum(len(get_config(a).active_shapes()) for a in assigned) == 36
    assert sum(1 for a in assigned for s in get_config(a).shapes
               if s.skip_reason) == 4
    assert sum(len(get_config(a).active_shapes())
               for a in ("sasrec-recjpq", "gbert4rec-recjpq")) == 4
    assert len(cells()) == 40


# ---------------------------------------------------------------------------
# reduced steps in both packages
# ---------------------------------------------------------------------------

def to_numpy(t: torch.Tensor, want_dtype) -> np.ndarray:
    """A port tensor as the reference's numpy array of ``want_dtype``,
    bits kept (bf16 exactly, uint16 codes and uint32 words by view)."""
    name = jnp.dtype(want_dtype).name
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(jnp.bfloat16)
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    return a.view(np.uint32) if name == "uint32" else a


def reference_args(port_args, ref_args):
    """The port's argument values in the reference's trees."""
    flat, treedef = jax.tree.flatten(tuple(ref_args))
    leaves = tree_lib.leaves(list(port_args))
    assert len(leaves) == len(flat)
    return jax.tree.unflatten(treedef, [
        jnp.asarray(to_numpy(t, r.dtype)) for t, r in zip(leaves, flat)])


def assert_topk_close(ids, vals, jids, jvals):
    """Values within :data:`TOL`; ids equal except where neighbouring
    values tie within it (the frameworks may order such a pair either
    way).  Row by row, the ids are the same set, apart from a tied run
    that ends the row (its ties may reach past the k-th item)."""
    vals, jvals = vals.float().numpy(), np.asarray(jvals, np.float32)
    np.testing.assert_allclose(vals, jvals, **TOL)
    ids, jids = ids.numpy(), np.asarray(jids)
    gap = np.abs(np.diff(jvals, axis=-1))
    tied = np.zeros_like(ids, dtype=bool)
    tied[..., 1:] |= gap <= 2e-5
    tied[..., :-1] |= gap <= 2e-5
    assert (ids == jids)[~tied].all()
    k = ids.shape[-1]
    for row, jrow, trow in zip(ids.reshape(-1, k), jids.reshape(-1, k),
                               tied.reshape(-1, k)):
        keep = np.ones(k, dtype=bool)
        for i in range(k - 1, -1, -1):     # the tied run that ends the row
            if not trow[i]:
                break
            keep[i] = False
        assert sorted(row[keep]) == sorted(jrow[keep])


def assert_close_tree(port, ref):
    got = [t for t in tree_lib.leaves(port) if t.is_floating_point()]
    want = [r for r in jax.tree.leaves(ref)
            if jnp.issubdtype(r.dtype, jnp.floating)]
    assert len(got) == len(want)
    for t, r in zip(got, want):
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(r, np.float32), **TOL)


def run_both(arch_id, shape_name, variant, mesh):
    arch = cut(get_reduced(arch_id))
    port = steps.build_step(arch_id, shape_name, "cpu", variant,
                            arch_override=arch, seed=3)
    ref = jsteps.build_step(arch_id, shape_name, mesh, variant,
                            arch_override=cut(jget_reduced(arch_id)))
    jargs = reference_args(port.args, ref.args)
    want = jax.jit(ref.step_fn)(*jargs)
    got = port.step_fn(*port.args)
    return port, got, want


PARITY_CELLS = [
    ("qwen2.5-14b", "train_4k", "baseline"),
    ("qwen2.5-14b", "decode_32k", "fused_head"),
    ("qwen3-moe-30b-a3b", "decode_32k", "moe_sort"),
    ("sasrec-recjpq", "serve_users", "baseline"),
    ("dcn-v2", "train_batch", "baseline"),
    ("graphsage-reddit", "full_graph_sm", "baseline"),
]


@pytest.mark.parametrize("arch_id,shape_name,variant", PARITY_CELLS)
def test_reduced_step_matches_reference(arch_id, shape_name, variant, mesh):
    port, got, want = run_both(arch_id, shape_name, variant, mesh)
    kind = port.meta["kind"]
    if kind == "train":
        (p, o, mets), (jp, jo, jmets) = got, want
        np.testing.assert_allclose(float(mets["loss"]),
                                   float(jmets["loss"]), **TOL)
        assert_close_tree(p, jp)
        assert_close_tree(o, jo)
    elif kind == "decode":
        (ids, vals, caches), (jids, jvals, jcaches) = got, want
        assert_topk_close(ids, vals, jids, jvals)
        assert_close_tree(caches, jcaches)
    else:
        (ids, vals), (jids, jvals) = got, want
        assert_topk_close(ids, vals, jids, jvals)


def test_materialize_draws_valid_ids():
    """Ids below their tables' rows, codes below b, the pruning state
    built from the drawn codes, optimizer state zero."""
    from repro_torch.core import pruning
    arch = cut(get_reduced("sasrec-recjpq"))
    b = steps.build_step("sasrec-recjpq", "train_seq", "cpu",
                         arch_override=arch)
    params, opt, batch = b.args
    emb = params["item_emb"]
    assert int(emb["codes"].view(torch.int16).max()) < emb["sub_emb"].shape[1]
    want = pruning.build_pruned_state(emb["codes"], emb["sub_emb"].shape[1])
    assert torch.equal(emb["pruned"].packed, want.packed)
    for key in ("input_seq", "targets", "negatives"):
        assert batch[key].dtype == torch.int32
        assert 0 <= int(batch[key].min()) and int(
            batch[key].max()) <= arch.model.n_items
    assert all(not t.any() for t in tree_lib.leaves(opt))
    again = steps.build_step("sasrec-recjpq", "train_seq", "cpu",
                             arch_override=arch)
    assert all(torch.equal(x, y) for x, y in zip(
        tree_lib.leaves(list(b.args)), tree_lib.leaves(list(again.args))))
