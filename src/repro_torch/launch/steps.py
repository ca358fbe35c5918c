"""Step builders for the dry-run matrix: for every (arch x shape x variant)
the step a user would run, with its arguments on a device and nothing
computed yet, on one device or over a mesh.

  step_fn        -- the step, a function of the arguments
  args           -- its arguments: on ``"meta"`` (the default) shapes and
                    dtypes only, as the reference's ``ShapeDtypeStruct``s
  in_shardings   -- one device per argument on one device; over a mesh a
                    tree of :class:`~repro_torch.distributed.sharding.
                    NamedSharding` per argument, leaf for leaf with it
  donate         -- argnums the step may overwrite (the reference's)
  plan           -- ``None`` on one device; over a mesh the activation
                    :class:`~repro_torch.distributed.sharding.ShardingPlan`
                    to run under
  meta           -- the reference's ``meta``, key for key

The reference's ``launch/steps.py``, branch for branch.  A mesh is a
:class:`~repro_torch.launch.mesh.ShardMesh` over named axes, such as
``make_production_mesh(devices=["meta"] * 256)``: its specs are the
reference's on the same axes, each axis that does not divide its
dimension dropped (:func:`_fit`).  The single controller runs the step
on whole tensors on the mesh's lead device; the shardings say where each
would lie, and the item-sharded variants (``sharded_*``) run their shard
bodies over the mesh's ``model`` axis.  Argument dtypes are the
reference's (int32 tokens, ids and edges; a step widens what a torch op
needs as int64 inside).

On one device a variant that only changes shardings builds the
baseline's step, and one that reads a mesh axis follows the reference's
rule for a mesh without it: ``powersgd`` builds the plain train step
(no ``pod`` axis), ``*gradrs`` constrains nothing, and the ``sharded_*``
variants run over one shard on the arguments' device.
:func:`materialize` gives a bundle's arguments values on a device, drawn
from a seed (codes below ``b``, ids below their table's rows, the pruning
metadata built from the drawn codes, optimizer state zero).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.launch.mesh import ShardMesh, make_mesh
from repro_torch.training import optimizer as opt_lib, train_loop
from repro_torch.training import tree as tree_lib

#: Every variant name the builders read, by family (``baseline`` first);
#: as in the reference, any other name builds the baseline's step.
VARIANTS = {
    "lm": ("baseline", "pqtopk_head", "dense_head", "onehot_head",
           "fused_head", "pruned_head", "pruned_range_head", "perquery_head",
           "approx_head", "noseq", "seqpar_tp", "seqpar_tp_dots", "vocab_tp",
           "vocab_tp_gradrs", "moe_sort", "moe_sort_vocab_tp", "powersgd",
           "gradrs"),
    "seqrec": ("baseline", "dense_head", "recjpq_head", "onehot_head",
               "fused_head", "pruned_head", "pruned_range_head",
               "mutable_head", "approx_head", "perquery_head", "hier_head",
               "sharded_head", "sharded_head_bm", "sharded_onehot",
               "sharded_fused", "sharded_perquery", "sharded_pruned",
               "sharded_pruned_range", "sharded_hier"),
    "recsys": ("baseline", "dense_head", "recjpq_head", "onehot_head",
               "fused_head"),
    "gnn": ("baseline",),
}


@dataclass
class StepBundle:
    name: str
    step_fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    donate: Tuple[int, ...]
    plan: Any
    meta: Dict[str, Any]
    arch: Optional[ArchConfig] = None
    shape: Optional[ShapeSpec] = None
    mesh: Optional[ShardMesh] = None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _opt_cfg(model) -> opt_lib.AdamWConfig:
    return opt_lib.AdamWConfig(lr=1e-4, warmup_steps=100, total_steps=10_000,
                               moment_dtype=model.moment_dtype)


# ---------------------------------------------------------------------------
# shardings of the arguments (the reference's helpers)
# ---------------------------------------------------------------------------

def _fit(mesh, x, spec: P) -> NamedSharding:
    """``spec`` on ``mesh`` for ``x``: axes absent from the mesh left out,
    and a dimension whose axes do not divide it replicated."""
    fixed = []
    for dim, ax in enumerate(spec):
        if ax is None:
            fixed.append(None)
            continue
        axes = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,))
                     if a in mesh.axis_names)
        size = math.prod(mesh.shape[a] for a in axes)
        fixed.append(axes if axes and x.shape[dim] % size == 0 else None)
    fixed += [None] * (x.dim() - len(fixed))
    return NamedSharding(mesh, P(*fixed))


def _tree_shardings(mesh, tree, spec_fn) -> Any:
    return tree_lib.tree_map(lambda x: _fit(mesh, x, spec_fn(x)), tree)


def _batch_spec(mesh) -> Tuple[str, ...]:
    return shd.batch_axes(mesh)


def _rows_spec(b_axes):
    """The batch over ``b_axes``, the other dimensions whole."""
    return lambda x: P(b_axes, *([None] * (x.dim() - 1)))


def _opt_shardings(mesh, opt_abs, param_shard):
    """Optimizer moments mirror the parameter shardings; a moment of lower
    rank than its parameter's spec (error feedback of a frozen integer
    leaf is a scalar) is replicated."""
    repl = NamedSharding(mesh, P())

    def like(tree):
        return tree_lib.tree_map(
            lambda t, s: s if len(s.spec) <= t.dim() else repl, tree,
            param_shard)
    return {"step": repl, "m": like(opt_abs["m"]), "v": like(opt_abs["v"]),
            **({"ef": like(opt_abs["ef"])} if "ef" in opt_abs else {})}


def _bundle(arch, shape, step_fn, args, donate, meta, mesh=None,
            in_shardings=None, plan=None) -> StepBundle:
    if mesh is None:
        in_shardings = (torch.device("meta"),) * len(args)
    return StepBundle(name=f"{arch.arch_id}__{shape.name}", step_fn=step_fn,
                      args=args, in_shardings=in_shardings, donate=donate,
                      plan=plan, meta=meta, arch=arch, shape=shape,
                      mesh=mesh)


def _train_bundle(arch, shape, params_abs, loss_fn, batch_abs, meta, mesh,
                  p_shard, b_shard, plan, *, powersgd=False,
                  grad_shardings=False):
    ocfg = _opt_cfg(arch.model)
    opt_abs = train_loop.init_opt_state(params_abs, ocfg, abstract=True,
                                        powersgd=powersgd)
    step = train_loop.make_train_step(
        loss_fn, ocfg, powersgd_axis="pod" if powersgd else None,
        mesh=mesh if powersgd else None,
        grad_shardings=p_shard if grad_shardings else None)
    shards = None if mesh is None else (
        p_shard, _opt_shardings(mesh, opt_abs, p_shard), b_shard)
    return _bundle(arch, shape, step, (params_abs, opt_abs, batch_abs),
                   (0, 1), meta, mesh, shards, plan)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

LM_HEADS = {"pqtopk_head": "pqtopk", "dense_head": "dense",
            "onehot_head": "pqtopk_onehot", "fused_head": "pqtopk_fused",
            "pruned_head": "pqtopk_pruned",
            "pruned_range_head": "pqtopk_pruned",
            "perquery_head": "pqtopk_pruned", "approx_head": "pqtopk_approx"}


def _lm_bundle(arch: ArchConfig, shape: ShapeSpec, variant: str, mesh
               ) -> StepBundle:
    from repro_torch.models import transformer as T
    cfg = arch.model
    if variant == "pruned_range_head" and cfg.pq_head is not None:
        cfg = replace(cfg, pq_head=replace(cfg.pq_head,
                                           bound_backend="range"))
    if variant == "perquery_head" and cfg.pq_head is not None:
        cfg = replace(cfg, pq_head=replace(cfg.pq_head, query_grouping=True))
    if variant == "seqpar_tp_dots":
        cfg = replace(cfg, remat=False)   # trade memory for recompute flops
    moe_sort = variant in ("moe_sort", "moe_sort_vocab_tp") \
        and cfg.moe is not None
    if moe_sort:
        cfg = replace(cfg, moe_impl="sort")
    arch = replace(arch, model=cfg)
    params_abs = T.abstract_lm(cfg)
    bsz, seq = shape.dims["global_batch"], shape.dims["seq_len"]
    plan = p_shard = None
    if mesh is not None:
        plan = shd.lm_activation_plan(
            mesh, shard_seq=variant != "noseq",
            tp_internal=variant in ("seqpar_tp", "seqpar_tp_dots"),
            vocab_tp=variant.startswith("vocab_tp"))
        if moe_sort and variant.endswith("vocab_tp"):
            plan = shd.lm_activation_plan(mesh, shard_seq=True,
                                          vocab_tp=True)
        b_axes = _batch_spec(mesh)
        p_shard = shd.param_shardings(mesh, params_abs,
                                      shd.lm_param_rules(cfg.scan_layers))

    if shape.kind == "train":
        batch_abs = {"tokens": _meta((bsz, seq), torch.int32),
                     "targets": _meta((bsz, seq), torch.int32)}
        powersgd = (variant == "powersgd" and mesh is not None
                    and "pod" in mesh.axis_names)
        b_shard = None
        if mesh is not None:
            b_shard = _tree_shardings(mesh, batch_abs,
                                      lambda x: P(b_axes, None))
        if powersgd:
            # Inside the manual-pod region the pod axis leaves every
            # activation spec, and the (un)embedding is replicated (the
            # reference's partitioner workaround, kept spec for spec).
            plan = shd.strip_axis(plan, "pod")
            repl = NamedSharding(mesh, P())
            for key in ("embed", "head"):
                if key in p_shard:
                    p_shard[key] = tree_lib.tree_map(lambda _: repl,
                                                     p_shard[key])
        return _train_bundle(
            arch, shape, params_abs, lambda p, b: T.lm_loss(p, b, cfg),
            batch_abs, {"kind": "train", "tokens": bsz * seq}, mesh,
            p_shard, b_shard, plan, powersgd=powersgd,
            grad_shardings=mesh is not None and variant.endswith("gradrs"))

    if shape.kind == "prefill":
        tok_abs = _meta((bsz, seq), torch.int32)
        shards = None if mesh is None else (
            p_shard, _fit(mesh, tok_abs, P(b_axes, None)))
        return _bundle(arch, shape, lambda p, t: T.lm_prefill(p, t, cfg),
                       (params_abs, tok_abs), (),
                       {"kind": "prefill", "tokens": bsz * seq}, mesh,
                       shards, plan)

    # decode (decode_32k / long_500k): one token, KV cache of seq_len.
    caches_abs = T.init_caches(cfg, bsz, seq, abstract=True)
    tok_abs, pos_abs = _meta((bsz,), torch.int32), _meta((), torch.int32)
    head = LM_HEADS.get(variant, "pqtopk")
    shards = None
    if mesh is not None:
        # Batch over data when it divides; sequence over model (+data for
        # B=1).  Stacked caches (L, B, S, H, D) keep L whole.
        if bsz >= max(mesh.shape.get("data", 1), 1):
            cache_spec = (b_axes, "model", None, None)
        else:
            cache_spec = (None, ("data", "model"), None, None)
        if isinstance(caches_abs, dict):
            cache_spec = (None,) + cache_spec
        shards = (p_shard, _fit(mesh, tok_abs, P(b_axes)),
                  NamedSharding(mesh, P()),
                  _tree_shardings(mesh, caches_abs,
                                  lambda x: P(*cache_spec)))

    def decode(p, tok, pos, caches):
        return T.lm_decode_step(p, tok, pos, caches, cfg, k=64,
                                head_method=head)

    return _bundle(arch, shape, decode,
                   (params_abs, tok_abs, pos_abs, caches_abs), (3,),
                   {"kind": "decode", "tokens": bsz, "kv_len": seq,
                    "head": head}, mesh, shards, plan)


# ---------------------------------------------------------------------------
# SeqRec family (the paper's models)
# ---------------------------------------------------------------------------

SEQREC_METHODS = {"dense_head": "dense", "recjpq_head": "recjpq",
                  "onehot_head": "pqtopk_onehot",
                  "fused_head": "pqtopk_fused",
                  "pruned_head": "pqtopk_pruned",
                  "pruned_range_head": "pqtopk_pruned",
                  "mutable_head": "pqtopk_pruned",
                  "approx_head": "pqtopk_approx",
                  "sharded_head": "pqtopk",
                  "sharded_head_bm": "pqtopk",
                  "sharded_onehot": "pqtopk_onehot",
                  "sharded_fused": "pqtopk_fused",
                  "perquery_head": "pqtopk_pruned",
                  "sharded_perquery": "pqtopk_pruned",
                  "sharded_pruned": "pqtopk_pruned",
                  "sharded_pruned_range": "pqtopk_pruned",
                  "hier_head": "pqtopk_pruned",
                  "sharded_hier": "pqtopk_pruned"}


def _seqrec_bundle(arch: ArchConfig, shape: ShapeSpec, variant: str, mesh
                   ) -> StepBundle:
    from repro_torch.models import seqrec as SR
    cfg = arch.model
    if variant in ("pruned_range_head", "sharded_pruned_range"):
        cfg = replace(cfg, pq=replace(cfg.pq, bound_backend="range"))
    if variant in ("perquery_head", "sharded_perquery"):
        cfg = replace(cfg, pq=replace(cfg.pq, query_grouping=True))
    if variant in ("hier_head", "sharded_hier"):
        cfg = replace(cfg, pq=replace(cfg.pq, super_factor=4))
    arch = replace(arch, model=cfg)
    params_abs = SR.abstract_seqrec(cfg)
    if variant == "mutable_head":
        # The streaming catalogue's tombstone mask rides with the head, as
        # the engine threads it (core/mutation.py): head data, one cascade.
        emb = params_abs["item_emb"]
        params_abs = {**params_abs, "item_emb": {
            **emb, "live": _meta((emb["codes"].shape[0],), torch.bool)}}
    bsz, seq = shape.dims["global_batch"], shape.dims["seq_len"]
    plan = p_shard = None
    if mesh is not None:
        plan = shd.lm_activation_plan(mesh, shard_seq=False)
        b_axes = _batch_spec(mesh)
        p_shard = shd.param_shardings(mesh, params_abs,
                                      shd.seqrec_param_rules())

    if shape.kind == "train":
        batch_abs = {
            "input_seq": _meta((bsz, seq), torch.int32),
            "targets": _meta((bsz, seq), torch.int32),
            "negatives": _meta((bsz, seq, cfg.n_negatives), torch.int32),
        }
        b_shard = None if mesh is None else _tree_shardings(
            mesh, batch_abs, _rows_spec(b_axes))
        return _train_bundle(arch, shape, params_abs,
                             lambda p, b: SR.seqrec_loss(p, b, cfg),
                             batch_abs,
                             {"kind": "train", "tokens": bsz * seq}, mesh,
                             p_shard, b_shard, plan)

    # serve_users: retrieval over the full catalogue.
    method = SEQREC_METHODS.get(variant, "pqtopk")
    sharded = variant.startswith("sharded_")
    seq_abs = _meta((bsz, seq), torch.int32)
    shards = None
    if mesh is not None:
        serve_b_axes = b_axes
        if variant.endswith("_bm"):
            # The backbone's batch over every axis, not data alone.
            serve_b_axes = tuple(mesh.axis_names)
            plan = shd.ShardingPlan(mesh, {
                "seq_hidden": P(serve_b_axes, None, None),
                "phi": P(serve_b_axes, None),
            })
        shards = (p_shard, _fit(mesh, seq_abs, P(serve_b_axes, None)))

    def serve(p, seqs):
        shard_mesh = None
        if sharded:
            shard_mesh = mesh if mesh is not None else make_mesh(
                1, [seqs.device])
        return SR.serve_topk(p, seqs, cfg, k=10, method=method,
                             sharded_mesh=shard_mesh)

    return _bundle(arch, shape, serve, (params_abs, seq_abs), (),
                   {"kind": "retrieval", "users": bsz,
                    "n_items": cfg.n_items, "method": method}, mesh, shards,
                   plan)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def _recsys_batch_abs(cfg, bsz: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if cfg.kind in ("dcn", "fm"):
        if cfg.n_dense:
            out["dense"] = _meta((bsz, cfg.n_dense), torch.float32)
        out["sparse"] = _meta((bsz, cfg.n_sparse), torch.int32)
    else:
        out["seq"] = _meta((bsz, cfg.seq_len, 2), torch.int32)
        out["target"] = _meta((bsz, 2), torch.int32)
    return out


RECSYS_METHODS = {"dense_head": "dense", "recjpq_head": "recjpq",
                  "onehot_head": "pqtopk_onehot",
                  "fused_head": "pqtopk_fused"}


def _recsys_bundle(arch: ArchConfig, shape: ShapeSpec, variant: str, mesh
                   ) -> StepBundle:
    from repro_torch.models import recsys as R
    cfg = arch.model
    params_abs = R.abstract_recsys(cfg)
    bsz = shape.dims["global_batch"]
    plan = p_shard = None
    if mesh is not None:
        plan = shd.recsys_activation_plan(mesh)
        b_axes = _batch_spec(mesh)
        p_shard = shd.param_shardings(mesh, params_abs,
                                      shd.recsys_param_rules())

    def batch_shards(batch_abs):
        return None if mesh is None else _tree_shardings(
            mesh, batch_abs, _rows_spec(b_axes))

    if shape.kind == "train":
        batch_abs = dict(_recsys_batch_abs(cfg, bsz),
                         label=_meta((bsz,), torch.float32))
        return _train_bundle(arch, shape, params_abs,
                             lambda p, b: R.ctr_loss(p, b, cfg), batch_abs,
                             {"kind": "train", "examples": bsz}, mesh,
                             p_shard, batch_shards(batch_abs), plan)

    batch_abs = _recsys_batch_abs(cfg, bsz)
    shards = None if mesh is None else (p_shard, batch_shards(batch_abs))
    if shape.kind == "serve":
        return _bundle(arch, shape, lambda p, b: R.ctr_logits(p, b, cfg),
                       (params_abs, batch_abs), (),
                       {"kind": "serve", "examples": bsz}, mesh, shards,
                       plan)

    # retrieval_cand: PQTopK over the candidate catalogue.
    method = RECSYS_METHODS.get(variant, "pqtopk")

    def retrieve(p, b):
        return R.retrieve_topk(p, b, cfg, k=10, method=method)

    return _bundle(arch, shape, retrieve, (params_abs, batch_abs), (),
                   {"kind": "retrieval",
                    "n_candidates": shape.dims["n_candidates"],
                    "method": method}, mesh, shards, plan)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def _gnn_bundle(arch: ArchConfig, shape: ShapeSpec, variant: str, mesh
                ) -> StepBundle:
    from repro_torch.models import gnn as G
    cfg = arch.model
    d = shape.dims
    if shape.name == "minibatch_lg":
        f1, f2 = d["fanout"]
        bn = d["batch_nodes"]
        batch_abs = {
            "feats_b": _meta((bn, d["d_feat"]), torch.float32),
            "feats_n1": _meta((bn, f1, d["d_feat"]), torch.float32),
            "feats_n2": _meta((bn, f1, f2, d["d_feat"]), torch.float32),
            "labels": _meta((bn,), torch.int32),
        }
        loss = G.gnn_minibatch_loss
        specs = None
    elif shape.name == "molecule":
        gbatch, n, e = d["graph_batch"], d["n_nodes"], d["n_edges"]
        batch_abs = {
            "feats": _meta((gbatch * n, d["d_feat"]), torch.float32),
            "edges": _meta((gbatch * e, 2), torch.int32),
            "graph_ids": _meta((gbatch * n,), torch.int32),
            "labels": _meta((gbatch,), torch.int32),
        }
        loss = G.gnn_graph_batch_loss
        specs = {"feats": ("all", None), "edges": ("all", None),
                 "graph_ids": ("all",), "labels": ("all",)}
    else:  # full_graph_sm / ogb_products: full-batch edge-list training
        batch_abs = {
            "feats": _meta((d["n_nodes"], d["d_feat"]), torch.float32),
            "edges": _meta((d["n_edges"], 2), torch.int32),
            "labels": _meta((d["n_nodes"],), torch.int32),
            "label_mask": _meta((d["n_nodes"],), torch.float32),
        }
        loss = G.gnn_loss
        # Node arrays replicated, the edge list over every device.
        specs = {"feats": (), "edges": ("all", None), "labels": (),
                 "label_mask": ()}
    n_classes = d.get("n_classes", cfg.n_classes)
    if n_classes != cfg.n_classes:
        cfg = replace(cfg, n_classes=n_classes)
        arch = replace(arch, model=cfg)
    params_abs = G.abstract_gnn(cfg, d["d_feat"])
    plan = p_shard = b_shard = None
    if mesh is not None:
        plan = shd.gnn_activation_plan(mesh)
        p_shard = shd.param_shardings(mesh, params_abs,
                                      shd.gnn_param_rules())
        all_axes = tuple(mesh.axis_names)
        if specs is None:
            b_shard = _tree_shardings(mesh, batch_abs,
                                      _rows_spec(_batch_spec(mesh)))
        else:
            b_shard = {k: _fit(mesh, batch_abs[k], P(*(
                all_axes if e == "all" else e for e in spec)))
                for k, spec in specs.items()}
    return _train_bundle(
        arch, shape, params_abs,
        functools.partial(lambda p, b, c: loss(p, b, c), c=cfg), batch_abs,
        {"kind": "train", "shape": shape.name}, mesh, p_shard, b_shard,
        plan)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_BUILDERS = {
    "lm": _lm_bundle,
    "seqrec": _seqrec_bundle,
    "recsys": _recsys_bundle,
    "gnn": _gnn_bundle,
}


def build_step(arch_id: str, shape_name: str, mesh_or_device="meta",
               variant: str = "baseline",
               arch_override: Optional[ArchConfig] = None,
               seed: int = 0) -> StepBundle:
    """The (arch, shape, variant) step.  ``mesh_or_device`` a device: the
    one-device bundle with its arguments on it; a :class:`ShardMesh`: the
    mesh bundle (shardings and plan over its axes) with its arguments on
    the mesh's lead device.  On meta the arguments are stand-ins (no
    storage); elsewhere values drawn by :func:`materialize` from
    ``seed``."""
    arch = arch_override if arch_override is not None else get_config(arch_id)
    shape = arch.shape(shape_name)
    if shape.skip_reason:
        raise ValueError(
            f"{arch_id}/{shape_name} is a documented skip: {shape.skip_reason}")
    mesh = mesh_or_device if isinstance(mesh_or_device, ShardMesh) else None
    device = mesh.lead if mesh is not None else torch.device(mesh_or_device)
    bundle = _BUILDERS[arch.family](arch, shape, variant, mesh)
    bundle.meta["variant"] = variant
    bundle.meta["family"] = arch.family
    if device.type != "meta":
        bundle = materialize(bundle, device, seed)
    return bundle


# ---------------------------------------------------------------------------
# values for a bundle's arguments
# ---------------------------------------------------------------------------

def _int_high(bundle: StepBundle, argnum: int, key):
    """Exclusive upper bound of an integer argument leaf's values (a list
    for an id array with one table per last-axis column)."""
    cfg, fam = bundle.arch.model, bundle.meta["family"]
    if fam == "lm":
        if key in ("tokens", "targets") or argnum == 1:
            return cfg.vocab
        if argnum == 2:                       # the decode position
            return bundle.shape.dims["seq_len"]
    if fam == "seqrec":
        return cfg.n_items + 1                # ids 1..N, 0 = padding
    if fam == "recsys":
        if key == "sparse":
            return list(cfg.table_rows)
        if key in ("seq", "target"):
            return list(cfg.table_rows[:2])
    if fam == "gnn" and key == "labels":
        return cfg.n_classes
    raise ValueError(f"no value range for argument {argnum} {key!r} of "
                     f"{bundle.name}")


def _randint(high, shape, gen, dtype, device) -> torch.Tensor:
    """Uniform ints below ``high`` (a list: one bound per last-axis
    column), drawn on the CPU and moved to ``device``."""
    if isinstance(high, list):
        cols = [torch.randint(0, h, tuple(shape[:-1]), generator=gen)
                for h in high]
        out = torch.stack(cols, dim=-1)
    else:
        out = torch.randint(0, high, tuple(shape), generator=gen)
    return out.to(dtype).to(device)


def _float(x, gen, device, scale=0.05, centre=0.0):
    out = torch.randn(tuple(x.shape), generator=gen, device=gen.device)
    return (out * scale + centre).to(x.dtype).to(device)


def _fill_params(tree, gen_cpu, gen_dev, device):
    """Params: floats N(0, 0.05^2) (norm scales around 1), PQ codes below
    ``b`` with their pruning metadata built from them, a ``live`` mask,
    the FM/recsys tables as any float leaf."""
    from repro_torch.core import pruning
    if isinstance(tree, list):
        return [_fill_params(v, gen_cpu, gen_dev, device) for v in tree]
    if not isinstance(tree, dict):
        return _float(tree, gen_dev, device)
    out = {}
    for key in sorted(tree):
        v = tree[key]
        if key == "pruned":
            continue
        if key == "codes":
            out[key] = _randint(tree["sub_emb"].shape[1], v.shape, gen_cpu,
                                v.dtype, device)
        elif key == "live":
            out[key] = (torch.rand(tuple(v.shape), generator=gen_cpu)
                        < 0.9).to(device)
        elif isinstance(v, (dict, list)):
            out[key] = _fill_params(v, gen_cpu, gen_dev, device)
        else:
            out[key] = _float(v, gen_dev, device,
                              centre=1.0 if key == "scale" else 0.0)
    if "pruned" in tree:
        st = tree["pruned"]
        out["pruned"] = pruning.build_pruned_state(
            out["codes"], st.b, st.tile, backend=st.backend,
            super_factor=st.super_factor)
    return out


def _fill_batch(bundle, argnum, tree, gen_cpu, gen_dev, device):
    if not isinstance(tree, dict):
        return _fill_leaf(bundle, argnum, None, tree, gen_cpu, gen_dev,
                          device)
    out = {}
    for key in sorted(tree):
        x = tree[key]
        if key == "edges":
            out[key] = _randint(tree["feats"].shape[0], x.shape, gen_cpu,
                                x.dtype, device)
        elif key == "graph_ids":
            per = x.shape[0] // tree["labels"].shape[0]
            out[key] = (torch.arange(x.shape[0]) // per).to(x.dtype).to(
                device)
        else:
            out[key] = _fill_leaf(bundle, argnum, key, x, gen_cpu, gen_dev,
                                  device)
    return out


def _fill_leaf(bundle, argnum, key, x, gen_cpu, gen_dev, device):
    if x.is_floating_point():
        if key in ("label", "label_mask"):
            return (torch.rand(tuple(x.shape), generator=gen_cpu) < 0.5).to(
                x.dtype).to(device)
        return _float(x, gen_dev, device, scale=1.0)
    return _randint(_int_high(bundle, argnum, key), x.shape, gen_cpu,
                    x.dtype, device)


def materialize(bundle: StepBundle, device, seed: int = 0) -> StepBundle:
    """``bundle`` with its arguments given values on ``device``, drawn from
    ``seed`` in argument order: integers on a CPU generator, floats on a
    generator on ``device``.  Params as :func:`_fill_params`; optimizer
    state zero (step 0); KV caches and float inputs N(0, 1); ids below
    their table's rows, labels below the class count, graph ids in
    contiguous blocks."""
    device = torch.device(device)
    gen_cpu = torch.Generator().manual_seed(seed)
    gen_dev = (torch.Generator(device=device).manual_seed(seed)
               if device.type == "cuda" else gen_cpu)
    args = []
    for i, a in enumerate(bundle.args):
        if i == 0:
            args.append(_fill_params(a, gen_cpu, gen_dev, device))
        elif isinstance(a, dict) and "step" in a:
            args.append(tree_lib.tree_map(
                lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device),
                a))
        elif isinstance(a, list) or (isinstance(a, dict) and "k" in a):
            args.append(tree_lib.tree_map(
                lambda t: _float(t, gen_dev, device, scale=1.0), a))
        else:
            args.append(_fill_batch(bundle, i, a, gen_cpu, gen_dev, device))
    return replace(bundle, args=tuple(args),
                   in_shardings=bundle.in_shardings if bundle.mesh
                   is not None else (device,) * len(args))
