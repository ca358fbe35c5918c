"""The port's abstract state (meta tensors: shapes and dtypes, no storage)
against the reference's ``ShapeDtypeStruct`` trees, on the CPU.

Every tree is compared leaf for leaf in the reference's flatten order
(dict keys sorted, list items in order, a pruning state's array fields in
registration order): the path, the shape and the dtype.  The one dtype
the port carries differently is the presence words' ``uint32``, held as
``int32`` with the same bits."""
import dataclasses
import resource

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import pq as jpq, pruning as jpruning
from repro.core import retrieval_head as jretrieval
from repro.models import attention as jattn, gnn as JG, recsys as JR
from repro.models import seqrec as JS, transformer as JT
from repro.training import optimizer as jopt, train_loop as jtrain_loop
from repro_torch.configs.base import (PQConfig, get_config, get_reduced,
                                      list_archs)
from repro_torch.core import pq as tpq, pruning as tpruning
from repro_torch.core import retrieval_head as tretrieval
from repro_torch.models import attention as tattn, gnn as TG, recsys as TR
from repro_torch.models import seqrec as TS, transformer as TT
from repro_torch.training import optimizer as topt, train_loop as ttrain_loop
from repro_torch.training import tree as tree_lib

ARRAY_FIELDS = tpruning.ARRAY_FIELDS
#: The reference's dtype names as the port's (uint32 carried as int32).
CARRY = {"uint32": "int32"}


def ref_leaves(tree, path=()):
    """(path, leaf) of a reference tree in jax's flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from ref_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from ref_leaves(v, path + (i,))
    elif dataclasses.is_dataclass(tree):
        for f in ARRAY_FIELDS:
            yield from ref_leaves(getattr(tree, f), path + (f,))
    else:
        yield path, tree


def assert_same_tree(port, ref, *, meta=True):
    """Leaf for leaf: path, shape, dtype (uint32 -> int32), every port
    leaf on meta when ``meta``."""
    got = list(tree_lib.leaves_with_path(port))
    want = list(ref_leaves(ref))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, x), (_, y) in zip(got, want):
        dt = CARRY.get(jnp.dtype(y.dtype).name, jnp.dtype(y.dtype).name)
        assert (tuple(x.shape), str(x.dtype)) == (
            tuple(y.shape), f"torch.{dt}"), path
        if meta:
            assert x.is_meta, path


def _abstract(arch_id, arch, ref_arch):
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


@pytest.mark.parametrize("arch_id", list_archs())
def test_abstract_params_match_reference_at_full_config(arch_id):
    """Each registry arch's abstract parameter tree at full width equals
    the reference's ``jax.eval_shape`` tree leaf for leaf, on meta."""
    port, ref = _abstract(arch_id, get_config(arch_id),
                          jget_config(arch_id))
    assert_same_tree(port, ref)


def test_abstract_lm_allocates_nothing():
    """nemotron-4-340b's tree (680 GB of bf16) builds on meta in well
    under a GB of host memory, and draws from no generator."""
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state().clone()
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    params = TT.abstract_lm(get_config("nemotron-4-340b").model)
    grown_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_lib.leaves(params))
    assert nbytes > 600e9
    assert all(t.is_meta for t in tree_lib.leaves(params))
    assert grown_kb < 1 << 20
    assert torch.equal(gen.get_state(), state)


def _init(arch):
    gen = torch.Generator().manual_seed(0)
    cfg = arch.model
    if arch.family == "seqrec":
        return TS.abstract_seqrec(cfg), TS.init_seqrec(gen, cfg)
    if arch.family == "recsys":
        return TR.abstract_recsys(cfg), TR.init_recsys(gen, cfg,
                                                       device="cpu")
    if arch.family == "lm":
        return TT.abstract_lm(cfg), TT.init_lm(gen, cfg)
    d_feat = 16
    return TG.abstract_gnn(cfg, d_feat), TG.init_gnn(gen, cfg, d_feat)


@pytest.mark.parametrize("arch_id", list_archs())
def test_abstract_params_match_init_at_reduced_config(arch_id):
    """At the reduced config, the abstract tree has ``init_*``'s structure,
    shapes and dtypes (the pruning state's static fields too)."""
    abstract, real = _init(get_reduced(arch_id))
    got = list(tree_lib.leaves_with_path(abstract))
    want = list(tree_lib.leaves_with_path(real))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, x), (_, y) in zip(got, want):
        assert x.is_meta and not y.is_meta, path
        assert (x.shape, x.dtype) == (y.shape, y.dtype), path
    for path, leaf, owner in tree_lib.walk(abstract):
        if owner is not None:
            real_owner = next(o for p, _, o in tree_lib.walk(real)
                              if p == path)
            static = [f.name for f in dataclasses.fields(owner)
                      if f.name not in ARRAY_FIELDS]
            assert [getattr(owner, f) for f in static] == [
                getattr(real_owner, f) for f in static]


PRUNED_CASES = {
    "flat": dict(n_items=1_271_639, m=8, b=512),
    "shards4": dict(n_items=1_271_639, m=8, b=512, shards=4),
    "super4": dict(n_items=1_000_003, m=8, b=256, super_factor=4),
    "range": dict(n_items=1_000_003, m=8, b=256, backend="range",
                  super_factor=4),
}


@pytest.mark.parametrize("case", sorted(PRUNED_CASES))
def test_abstract_pruned_state_matches_reference(case):
    kw = PRUNED_CASES[case]
    port = tpruning.abstract_pruned_state(**kw)
    ref = jpruning.abstract_pruned_state(**kw)
    static = [f.name for f in dataclasses.fields(port)
              if f.name not in ARRAY_FIELDS]
    assert [getattr(port, f) for f in static] == [getattr(ref, f)
                                                  for f in static]
    assert_same_tree({"s": port}, {"s": ref})


@pytest.mark.parametrize("pq", [None, PQConfig(m=8, b=512,
                                               code_dtype="uint16")],
                         ids=["dense", "pq"])
def test_abstract_head_and_pq_embedding_match_reference(pq):
    from repro.configs.base import PQConfig as JPQConfig
    jq = None if pq is None else JPQConfig(m=8, b=512, code_dtype="uint16")
    assert_same_tree(tretrieval.abstract(1_000_001, 512, pq),
                     jretrieval.abstract(1_000_001, 512, jq))
    if pq is not None:
        assert_same_tree(tpq.abstract_pq_embedding(pq, 7, 64),
                         jpq.abstract_pq_embedding(jq, 7, 64))


@pytest.mark.parametrize("arch_id", ["sasrec-recjpq", "qwen2.5-14b",
                                     "graphsage-reddit"])
def test_abstract_optimizer_state_matches_reference(arch_id):
    """``abstract_adamw`` (moments for every leaf, integer ones too),
    ``init_opt_state(abstract=True)`` and ``abstract_adafactor`` (factored
    rows) against the reference's, at full width."""
    port, ref = _abstract(arch_id, get_config(arch_id),
                          jget_config(arch_id))
    cfg = topt.AdamWConfig(moment_dtype="bfloat16")
    jcfg = jopt.AdamWConfig(moment_dtype="bfloat16")
    assert_same_tree(topt.abstract_adamw(port, cfg),
                     jopt.abstract_adamw(ref, jcfg))
    assert_same_tree(ttrain_loop.init_opt_state(port, cfg, abstract=True),
                     jtrain_loop.init_opt_state(ref, jcfg, abstract=True))
    assert_same_tree(
        topt.abstract_adafactor(port, topt.AdafactorConfig()),
        jopt.abstract_adafactor(ref, jopt.AdafactorConfig()))
    assert_same_tree(
        ttrain_loop.init_opt_state(port, cfg, powersgd=True, abstract=True),
        jtrain_loop.init_opt_state(ref, jcfg, powersgd=True, abstract=True))


@pytest.mark.parametrize("arch_id", ["qwen2.5-14b", "gemma3-27b"])
def test_abstract_caches_match_reference(arch_id):
    """All-global stacked archs: one (L, B, S, H, D) pair; gemma3: a
    per-layer list, sliding layers with min(window, max_len) slots."""
    cfg, jcfg = get_config(arch_id).model, jget_config(arch_id).model
    for batch, max_len in ((128, 32_768), (1, 524_288)):
        port = TT.init_caches(cfg, batch, max_len, abstract=True)
        ref = JT.init_caches(jcfg, batch, max_len, abstract=True)
        assert isinstance(port, dict) == isinstance(ref, dict)
        assert_same_tree(port, ref)
    a, ja = cfg.attention, jcfg.attention
    for is_global in (True, False):
        assert_same_tree(
            tattn.abstract_cache(4, 4096, a, is_global=is_global),
            jattn.abstract_cache(4, 4096, ja, is_global=is_global))


@pytest.mark.parametrize("arch_id", list_archs())
def test_active_shapes_match_reference(arch_id):
    port = get_config(arch_id).active_shapes()
    ref = jget_config(arch_id).active_shapes()
    assert [(s.name, s.kind, dict(s.dims)) for s in port] == [
        (s.name, s.kind, dict(s.dims)) for s in ref]
    assert all(not s.skip_reason for s in port)


def test_eval_shape_runs_without_storage():
    """``tree.eval_shape`` is ``jax.eval_shape``: outputs on meta, the
    function run on shape-only tensors."""
    out = tree_lib.eval_shape(lambda n: {"a": torch.zeros(n, 3) @
                                         torch.ones(3, 2),
                                         "b": [torch.arange(n)]}, 5)
    assert out["a"].is_meta and tuple(out["a"].shape) == (5, 2)
    assert out["b"][0].dtype == torch.int64
    assert jax.eval_shape(lambda: jnp.zeros((5, 2))).shape == (5, 2)
