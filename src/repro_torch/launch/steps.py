"""Step builders for the dry-run matrix: for every (arch x shape x variant)
the step a user would run, with its arguments on a device and nothing
computed yet.

  step_fn        -- the step, a function of the arguments
  args           -- its arguments: on ``"meta"`` (the default) shapes and
                    dtypes only, as the reference's ``ShapeDtypeStruct``s
  in_shardings   -- one ``torch.device`` per argument (one device until the
                    dry run over the multi-axis mesh, ROADMAP A 6c)
  donate         -- argnums the step may overwrite (the reference's)
  plan           -- ``None``: no activation plan on one device
  meta           -- the reference's ``meta``, key for key

The reference's ``launch/steps.py``, branch for branch, on one device.
Argument dtypes are the reference's (int32 tokens, ids and edges; a step
widens what a torch op needs as int64 inside).  Variants that change the
computation on one device are built; those that change only shardings
or need a mesh axis raise ``NotImplementedError`` naming A 6c.
:func:`materialize` gives a bundle's arguments values on a device, drawn
from a seed (codes below ``b``, ids below their table's rows, the pruning
metadata built from the drawn codes, optimizer state zero).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec, get_config
from repro_torch.training import optimizer as opt_lib, train_loop
from repro_torch.training import tree as tree_lib

#: Variants that shard (or need a mesh axis) and so wait for ROADMAP A 6c.
MESH_VARIANTS = ("noseq", "seqpar_tp", "moe_sort_vocab_tp", "powersgd")
MESH_PREFIXES = ("vocab_tp", "sharded_")
MESH_SUFFIXES = ("gradrs", "_bm")


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


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _opt_cfg(model) -> opt_lib.AdamWConfig:
    return opt_lib.AdamWConfig(lr=1e-4, warmup_steps=100, total_steps=10_000,
                               moment_dtype=model.moment_dtype)


def check_variant(variant: str) -> None:
    if (variant in MESH_VARIANTS or variant.startswith(MESH_PREFIXES)
            or variant.endswith(MESH_SUFFIXES)):
        raise NotImplementedError(
            f"variant {variant!r} changes shardings or needs a mesh axis: "
            "its dry run over the multi-axis mesh is not ported yet "
            "(ROADMAP A 6c)")


def _bundle(arch, shape, step_fn, args, donate, meta) -> StepBundle:
    return StepBundle(name=f"{arch.arch_id}__{shape.name}", step_fn=step_fn,
                      args=args, in_shardings=(torch.device("meta"),)
                      * len(args), donate=donate, plan=None, meta=meta,
                      arch=arch, shape=shape)


def _train_bundle(arch, shape, params_abs, loss_fn, batch_abs, meta):
    ocfg = _opt_cfg(arch.model)
    opt_abs = train_loop.init_opt_state(params_abs, ocfg, abstract=True)
    step = train_loop.make_train_step(loss_fn, ocfg)
    return _bundle(arch, shape, step, (params_abs, opt_abs, batch_abs),
                   (0, 1), meta)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

LM_HEADS = {"pqtopk_head": "pqtopk", "dense_head": "dense",
            "onehot_head": "pqtopk_onehot", "fused_head": "pqtopk_fused",
            "pruned_head": "pqtopk_pruned",
            "pruned_range_head": "pqtopk_pruned",
            "perquery_head": "pqtopk_pruned", "approx_head": "pqtopk_approx"}


def _lm_bundle(arch: ArchConfig, shape: ShapeSpec, variant: str
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
    if variant == "moe_sort" and cfg.moe is not None:
        cfg = replace(cfg, moe_impl="sort")
    arch = replace(arch, model=cfg)
    params_abs = T.abstract_lm(cfg)
    bsz, seq = shape.dims["global_batch"], shape.dims["seq_len"]

    if shape.kind == "train":
        batch_abs = {"tokens": _meta((bsz, seq), torch.int32),
                     "targets": _meta((bsz, seq), torch.int32)}
        return _train_bundle(arch, shape, params_abs,
                             lambda p, b: T.lm_loss(p, b, cfg), batch_abs,
                             {"kind": "train", "tokens": bsz * seq})

    if shape.kind == "prefill":
        return _bundle(arch, shape, lambda p, t: T.lm_prefill(p, t, cfg),
                       (params_abs, _meta((bsz, seq), torch.int32)), (),
                       {"kind": "prefill", "tokens": bsz * seq})

    # decode (decode_32k / long_500k): one token, KV cache of seq_len.
    caches_abs = T.init_caches(cfg, bsz, seq, abstract=True)
    head = LM_HEADS.get(variant, "pqtopk")

    def decode(p, tok, pos, caches):
        return T.lm_decode_step(p, tok, pos, caches, cfg, k=64,
                                head_method=head)

    return _bundle(arch, shape, decode,
                   (params_abs, _meta((bsz,), torch.int32),
                    _meta((), torch.int32), caches_abs), (3,),
                   {"kind": "decode", "tokens": bsz, "kv_len": seq,
                    "head": head})


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
                  "perquery_head": "pqtopk_pruned",
                  "hier_head": "pqtopk_pruned"}


def _seqrec_bundle(arch: ArchConfig, shape: ShapeSpec, variant: str
                   ) -> StepBundle:
    from repro_torch.models import seqrec as SR
    cfg = arch.model
    if variant == "pruned_range_head":
        cfg = replace(cfg, pq=replace(cfg.pq, bound_backend="range"))
    if variant == "perquery_head":
        cfg = replace(cfg, pq=replace(cfg.pq, query_grouping=True))
    if variant == "hier_head":
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

    if shape.kind == "train":
        batch_abs = {
            "input_seq": _meta((bsz, seq), torch.int32),
            "targets": _meta((bsz, seq), torch.int32),
            "negatives": _meta((bsz, seq, cfg.n_negatives), torch.int32),
        }
        return _train_bundle(arch, shape, params_abs,
                             lambda p, b: SR.seqrec_loss(p, b, cfg),
                             batch_abs,
                             {"kind": "train", "tokens": bsz * seq})

    # serve_users: retrieval over the full catalogue.
    method = SEQREC_METHODS.get(variant, "pqtopk")

    def serve(p, seqs):
        return SR.serve_topk(p, seqs, cfg, k=10, method=method)

    return _bundle(arch, shape, serve,
                   (params_abs, _meta((bsz, seq), torch.int32)), (),
                   {"kind": "retrieval", "users": bsz,
                    "n_items": cfg.n_items, "method": method})


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


def _recsys_bundle(arch: ArchConfig, shape: ShapeSpec, variant: str
                   ) -> StepBundle:
    from repro_torch.models import recsys as R
    cfg = arch.model
    params_abs = R.abstract_recsys(cfg)
    bsz = shape.dims["global_batch"]

    if shape.kind == "train":
        batch_abs = dict(_recsys_batch_abs(cfg, bsz),
                         label=_meta((bsz,), torch.float32))
        return _train_bundle(arch, shape, params_abs,
                             lambda p, b: R.ctr_loss(p, b, cfg), batch_abs,
                             {"kind": "train", "examples": bsz})

    if shape.kind == "serve":
        return _bundle(arch, shape, lambda p, b: R.ctr_logits(p, b, cfg),
                       (params_abs, _recsys_batch_abs(cfg, bsz)), (),
                       {"kind": "serve", "examples": bsz})

    # retrieval_cand: PQTopK over the candidate catalogue.
    method = RECSYS_METHODS.get(variant, "pqtopk")

    def retrieve(p, b):
        return R.retrieve_topk(p, b, cfg, k=10, method=method)

    return _bundle(arch, shape, retrieve,
                   (params_abs, _recsys_batch_abs(cfg, bsz)), (),
                   {"kind": "retrieval",
                    "n_candidates": shape.dims["n_candidates"],
                    "method": method})


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def _gnn_bundle(arch: ArchConfig, shape: ShapeSpec, variant: str
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
    elif shape.name == "molecule":
        gbatch, n, e = d["graph_batch"], d["n_nodes"], d["n_edges"]
        batch_abs = {
            "feats": _meta((gbatch * n, d["d_feat"]), torch.float32),
            "edges": _meta((gbatch * e, 2), torch.int32),
            "graph_ids": _meta((gbatch * n,), torch.int32),
            "labels": _meta((gbatch,), torch.int32),
        }
        loss = G.gnn_graph_batch_loss
    else:  # full_graph_sm / ogb_products: full-batch edge-list training
        batch_abs = {
            "feats": _meta((d["n_nodes"], d["d_feat"]), torch.float32),
            "edges": _meta((d["n_edges"], 2), torch.int32),
            "labels": _meta((d["n_nodes"],), torch.int32),
            "label_mask": _meta((d["n_nodes"],), torch.float32),
        }
        loss = G.gnn_loss
    n_classes = d.get("n_classes", cfg.n_classes)
    if n_classes != cfg.n_classes:
        cfg = replace(cfg, n_classes=n_classes)
        arch = replace(arch, model=cfg)
    params_abs = G.abstract_gnn(cfg, d["d_feat"])
    return _train_bundle(
        arch, shape, params_abs,
        functools.partial(lambda p, b, c: loss(p, b, c), c=cfg), batch_abs,
        {"kind": "train", "shape": shape.name})


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_BUILDERS = {
    "lm": _lm_bundle,
    "seqrec": _seqrec_bundle,
    "recsys": _recsys_bundle,
    "gnn": _gnn_bundle,
}


def build_step(arch_id: str, shape_name: str, device="meta",
               variant: str = "baseline",
               arch_override: Optional[ArchConfig] = None,
               seed: int = 0) -> StepBundle:
    """The (arch, shape, variant) step with its arguments on ``device``:
    meta stand-ins (no storage), or on another device values drawn by
    :func:`materialize` from ``seed``."""
    arch = arch_override if arch_override is not None else get_config(arch_id)
    shape = arch.shape(shape_name)
    if shape.skip_reason:
        raise ValueError(
            f"{arch_id}/{shape_name} is a documented skip: {shape.skip_reason}")
    check_variant(variant)
    bundle = _BUILDERS[arch.family](arch, shape, variant)
    bundle.meta["variant"] = variant
    bundle.meta["family"] = arch.family
    if torch.device(device).type != "meta":
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
                   in_shardings=(device,) * len(args))
