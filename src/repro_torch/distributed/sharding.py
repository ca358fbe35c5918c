"""Sharding on a mesh (``launch/mesh.py``): the collectives of the
manual regions, per-shard row blocks, the parameter sharding rules and
the activation plans.

The reference's manual regions run one ``shard_map`` whose bodies call
``lax.all_gather``, ``pmax`` and ``psum``.  Here a body runs per position
on that position's device (:func:`on_device` with the position,
:func:`manual_axis_map`), and each collective is a plain function over
the per-position list that merges on the mesh's lead device, in position
order: :func:`all_gather` concatenates, :func:`pmax` and :func:`psum`
stack and reduce, :func:`replicate` sends a lead tensor back to every
device.  A value that a region returns unmerged is :class:`Varying`: one
tensor per position, as the reference's ``check_vma=False`` outputs hold
one buffer per device whatever their spec says.  Each of these helpers,
and each block a region cuts and each constraint, runs through
:func:`repro_torch.kernels.cost.mesh_op`, which reports it to the dry
run's partitioned count.

:func:`shard_rows` gives each shard its own contiguous block of a
row-sharded tensor (the catalogue's codes, its ``live`` mask, a pruned
state's tile metadata), padded with zero rows to ``S * n_local`` as the
reference's ``jnp.pad`` does.

The rules (``*_param_rules``) and :func:`param_shardings` map a parameter
tree to a tree of :class:`NamedSharding` (mesh and :class:`P` spec), an
axis that does not divide its dimension dropped.  The activation plans
name a spec per activation; inside :func:`activation_plan` the models'
:func:`constrain` points look theirs up.  A spec says where a tensor would
lie: the single controller keeps every tensor whole (GSPMD changes no
values), so :func:`constrain` returns its input and records the point
(:func:`record_constraints`), which is what a partitioned count reads.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import cost

AXIS = "model"


class P(tuple):
    """A partition spec: per dimension, a mesh axis name (or a tuple of
    names) or ``None`` (replicated).  As in JAX, a one-name tuple is that
    name and an empty tuple is ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else (e or None))
            if isinstance(e, tuple) else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# devices and collectives
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def on_device(dev: torch.device,
              position: Optional[Tuple[str, int]] = None):
    """Context in which a shard's body runs: the device's CUDA context (its
    allocations and its current stream), or nothing on the CPU; with
    ``position`` (``(axis, index)``) the body is that position's of a
    manual region (:func:`repro_torch.kernels.cost.at_position`)."""
    with (torch.cuda.device(dev) if dev.type == "cuda"
          else contextlib.nullcontext()), cost.at_position(position):
        yield


def same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device
    return (cur() if a.index is None else a.index) == \
        (cur() if b.index is None else b.index)


def to_device(x, dev: torch.device):
    """A tensor on ``dev`` (itself where it already lies); anything else
    as it is."""
    if isinstance(x, torch.Tensor) and not same_device(x.device, dev):
        return x.to(dev)
    return x


def replicate(x: torch.Tensor, mesh, axis: Optional[str] = None
              ) -> List[torch.Tensor]:
    """``x`` on every device of the mesh, or with ``axis`` on every
    position's device of that axis (no copy where it already lies)."""
    devs = mesh.devices if axis is None else mesh.axis_devices(axis)
    return cost.mesh_op("replicate", lambda: [to_device(x, d) for d in devs],
                        (x,), mesh=mesh, axis=axis)


def _gathered(parts: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    return [p if same_device(p.device, mesh.lead) else p.to(mesh.lead)
            for p in parts]


def all_gather(parts: Sequence[torch.Tensor], mesh,
               dim: int = 1) -> torch.Tensor:
    """The shards' tensors on the lead device, concatenated along ``dim``
    in shard order (``lax.all_gather(..., tiled=True)``)."""
    return cost.mesh_op(
        "all_gather", lambda: torch.cat(_gathered(parts, mesh), dim=dim),
        parts, mesh=mesh, dim=dim)


def pmax(parts: Sequence[torch.Tensor], mesh) -> torch.Tensor:
    """Elementwise max over the shards, on the lead device."""
    return cost.mesh_op(
        "pmax", lambda: torch.stack(_gathered(parts, mesh)).amax(dim=0),
        parts, mesh=mesh)


def psum(parts: Sequence[torch.Tensor], mesh) -> torch.Tensor:
    """Elementwise sum over the shards, on the lead device."""
    return cost.mesh_op(
        "psum", lambda: torch.stack(_gathered(parts, mesh)).sum(dim=0),
        parts, mesh=mesh)


def pmean(parts: Sequence[torch.Tensor], mesh) -> torch.Tensor:
    """Elementwise mean over the positions (``lax.pmean``: the sum over
    the count), on the lead device."""
    return psum(parts, mesh) / len(parts)


def host_values(parts: Sequence[torch.Tensor], mesh, what: str,
                largest: int) -> list:
    """Every shard's tensor read to the host in ONE read: stacked on the
    lead device, then one ``tolist`` -> a list per shard.  The read is
    ``kernels.cost.host_read``'s, named ``what``; on meta every value is
    ``largest`` (the most the shapes allow)."""
    def stand_in():
        return [largest if p.dim() == 0 else [largest] * p.shape[0]
                for p in parts]
    return cost.mesh_op("host_values", lambda: cost.host_read(
        what, lambda: torch.stack(_gathered(parts, mesh)).tolist(),
        stand_in, of=parts), parts, mesh=mesh)


# ---------------------------------------------------------------------------
# manual regions
# ---------------------------------------------------------------------------


class Varying:
    """One value per position of a manual axis: what a region returns
    under a spec that does not name the axis, unmerged.  The reference's
    regions run with ``check_vma=False``, so such an output keeps each
    device's own buffer although its spec says "replicated" (PowerSGD's
    per-pod error feedback is one).  A host read (a checkpoint,
    :meth:`host`) sees position 0's, as the reference's does."""

    __slots__ = ("parts",)

    def __init__(self, parts: Sequence[Any]):
        self.parts = tuple(parts)

    @property
    def shape(self):
        return self.parts[0].shape

    def dim(self) -> int:
        return self.parts[0].dim()

    def host(self):
        """Position 0's value."""
        return self.parts[0]

    def to(self, device) -> "Varying":
        """Every position's value on ``device``."""
        return Varying([p.to(device) for p in self.parts])

    def __repr__(self) -> str:
        return f"Varying({len(self.parts)} x {tuple(self.shape)})"


def _spec_dim(spec, axis: str) -> Optional[int]:
    """The dimension whose spec entry names ``axis`` (alone, or as the
    major axis of a tuple), or None."""
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if axis in names:
            if names[0] != axis:
                raise NotImplementedError(
                    f"spec {spec}: the manual axis {axis!r} must be the "
                    "major axis of its dimension")
            return d
    return None


def _tree_map(fn, tree, *rest):
    from repro_torch.training import tree as tree_lib
    return tree_lib.tree_map(fn, tree, *rest)


def _block(x, dim: Optional[int], i: int, n: int, dev: torch.device):
    if isinstance(x, Varying):
        return to_device(x.parts[i], dev)
    if dim is not None and isinstance(x, torch.Tensor):
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} of size {size} does not "
                             f"divide into {n} positions")
        x = x.narrow(dim, i * (size // n), size // n)
    return to_device(x, dev)


def manual_axis_map(fn: Callable, mesh, in_specs, out_specs, *,
                    axis_names=None) -> Callable:
    """The repo's manual region (the reference's ``shard_map`` with
    ``axis_names``): ``fn`` runs once per position of the manual axis, in
    turn, under that position's device (:meth:`ShardMesh.axis_devices`).

    ``in_specs`` has one :class:`P` per argument, applied to every leaf of
    it: a leaf whose spec names the axis gets its position's contiguous
    block of that dimension, a :class:`Varying` leaf its position's value,
    any other leaf the whole.  ``out_specs`` (one :class:`P`, or one per
    output of a tuple): an output whose spec names the axis is gathered
    along that dimension on the lead device; any other output comes back
    as a tree of :class:`Varying` leaves (the reference's
    ``check_vma=False``).  The other axes are automatic: the body sees
    whole tensors, as GSPMD changes no values.  Collectives are not called
    inside ``fn``; they merge the region's outputs afterwards."""
    names = tuple(axis_names) if axis_names is not None else \
        tuple(mesh.axis_names)
    if len(names) != 1:
        raise NotImplementedError(
            f"manual regions over one axis only, not {names}")
    axis = names[0]
    devs = mesh.axis_devices(axis)
    n = len(devs)
    single = isinstance(out_specs, P)

    def block(x, d, i, dev):
        if d is None or not isinstance(x, torch.Tensor):
            return _block(x, d, i, n, dev)
        return cost.mesh_op("block", lambda: _block(x, d, i, n, dev), (x,),
                            mesh=mesh, axis=axis, dim=d, index=i)

    def mapped(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"{len(args)} arguments for {len(in_specs)} "
                            "in_specs")
        outs = []
        for i, dev in enumerate(devs):
            with on_device(dev, (axis, i)):
                local = [_tree_map(lambda x, d=_spec_dim(spec, axis):
                                   block(x, d, i, dev), a)
                         for a, spec in zip(args, in_specs)]
                out = fn(*local)
            outs.append((out,) if single else tuple(out))
        specs = (out_specs,) if single else tuple(out_specs)
        merged = []
        for j, spec in enumerate(specs):
            parts = [o[j] for o in outs]
            d = _spec_dim(spec, axis)
            if d is not None:
                merged.append(_tree_map(
                    lambda *xs, d=d: all_gather(xs, mesh, dim=d), *parts))
            else:
                merged.append(_tree_map(lambda *xs: Varying(xs), *parts))
        return merged[0] if single else tuple(merged)

    return mapped


# ---------------------------------------------------------------------------
# per-shard row blocks
# ---------------------------------------------------------------------------

# Copied blocks (a padded last shard, or a shard on another device), keyed
# by the source tensor's identity and the mesh's devices and checked
# against its version counter, so an in-place write (a catalogue
# mutation) is seen; a finalizer evicts the entry with its source.
_BLOCKS: dict = {}
_BLOCKS_LOCK = threading.Lock()


def _version(x: torch.Tensor):
    try:
        return x._version
    except RuntimeError:            # an inference tensor keeps no counter
        return None


def _copied_blocks(x: torch.Tensor, devs, n_local: int, need):
    key = (id(x), devs)
    ver = _version(x)
    with _BLOCKS_LOCK:
        hit = _BLOCKS.get(key)
        if hit is not None and ver is not None and hit[0] == ver:
            return hit[1]
        blocks = {}
        for i in need:
            block = x[i * n_local:min((i + 1) * n_local, x.shape[0])]
            short = n_local - block.shape[0]
            if short:
                block = torch.cat([block, block.new_zeros(
                    (short,) + tuple(x.shape[1:]))])
            blocks[i] = block.to(devs[i]).contiguous()
        # Another thread's stream may read these next: let the copies land.
        for dev in {devs[i] for i in need}:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        if ver is not None:
            if hit is None:
                weakref.finalize(x, _BLOCKS.pop, key, None)
            _BLOCKS[key] = (ver, blocks)
        return blocks


def shard_rows(x: torch.Tensor, mesh, axis: str = AXIS
               ) -> List[torch.Tensor]:
    """``x`` (N, ...) as S contiguous (n_local, ...) blocks, one per
    position of ``axis`` (S = ``mesh.shape[axis]``), n_local =
    ceil(N / S), block i on that position's device
    (:meth:`ShardMesh.axis_devices`); rows past N are zeros.  On a mesh
    with other axes their positions hold the same blocks (the reference's
    ``P(axis, None)``), so each block exists once.  A full block already
    on its device is a view (no copy); the others are copied once per
    version of ``x``."""
    return cost.mesh_op("shard_rows", lambda: _shard_rows(x, mesh, axis),
                        (x,), mesh=mesh, axis=axis, dim=0)


def _shard_rows(x: torch.Tensor, mesh, axis: str) -> List[torch.Tensor]:
    devs = mesh.axis_devices(axis)
    n = x.shape[0]
    n_local = -(-n // len(devs))
    out, need = [None] * len(devs), []
    for i, dev in enumerate(devs):
        lo, hi = i * n_local, (i + 1) * n_local
        if hi <= n and x.is_contiguous() and same_device(x.device, dev):
            out[i] = x[lo:hi]
        else:
            need.append(i)
    if need:
        blocks = _copied_blocks(x, devs, n_local, need)
        for i in need:
            out[i] = blocks[i]
    return out


# ---------------------------------------------------------------------------
# shardings, activation plans and constraints
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: P


_PLAN: contextvars.ContextVar[Optional["ShardingPlan"]] = \
    contextvars.ContextVar("activation_plan", default=None)
_RECORD: contextvars.ContextVar[Optional[list]] = \
    contextvars.ContextVar("constraint_record", default=None)


class ShardingPlan:
    """Named activation specs bound to a mesh."""

    def __init__(self, mesh, specs: Dict[str, P]):
        self.mesh = mesh
        self.specs = dict(specs)

    def sharding(self, name: str) -> Optional[NamedSharding]:
        spec = self.specs.get(name)
        if spec is None:
            return None
        return NamedSharding(self.mesh, spec)


@contextlib.contextmanager
def activation_plan(plan: Optional[ShardingPlan]):
    tok = _PLAN.set(plan)
    try:
        yield plan
    finally:
        _PLAN.reset(tok)


def current_plan() -> Optional[ShardingPlan]:
    return _PLAN.get()


def strip_axis(plan: ShardingPlan, axis: str) -> ShardingPlan:
    """Plan view with ``axis`` removed from every spec -- used inside
    regions that are manual over that axis (PowerSGD's pod exchange)."""
    def fix(spec: P) -> P:      # P makes a 1-tuple its name, () None
        return P(*(tuple(a for a in e if a != axis) if isinstance(e, tuple)
                   else None if e == axis else e for e in spec))
    return ShardingPlan(plan.mesh, {k: fix(v) for k, v in plan.specs.items()})


@contextlib.contextmanager
def record_constraints():
    """Collects ``(name, spec, shape)`` for every constraint applied inside
    the block, in order (:func:`constrain` points by their activation
    name; :func:`with_sharding_constraint` by the name it is given)."""
    rec: List[Tuple[Optional[str], P, Tuple[int, ...]]] = []
    tok = _RECORD.set(rec)
    try:
        yield rec
    finally:
        _RECORD.reset(tok)


def with_sharding_constraint(x: torch.Tensor, sharding: NamedSharding,
                             name: Optional[str] = None) -> torch.Tensor:
    """``x`` itself, its values unchanged: the single controller keeps
    every tensor whole.  The spec must fit ``x`` and name axes of its
    mesh; the point is recorded (:func:`record_constraints`)."""
    spec = sharding.spec
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} too long for a {x.dim()}-D tensor")
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None and a not in sharding.mesh.shape:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                                 f"the mesh {sharding.mesh.axis_names}")
    rec = _RECORD.get()
    if rec is not None:
        rec.append((name, spec, tuple(x.shape)))
    return cost.mesh_op("constraint", lambda: x, (x,), sharding=sharding)


def gradients(params: Sequence[torch.Tensor],
              grads: Sequence[Optional[torch.Tensor]]):
    """``grads`` itself, each the gradient of the same place's parameter:
    a record point at which a partitioned count gives each gradient its
    parameter's sharding, as GSPMD carries a parameter's sharding back to
    its gradient (a data-parallel partial sum all-reduced, or
    reduce-scattered onto a sharded parameter)."""
    return cost.mesh_op("gradients", lambda: grads, tuple(params),
                        grads=tuple(grads))


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """The named activation constraint if a plan is active (a spec longer
    than ``x``'s rank is skipped, as in the reference); ``x`` itself
    either way."""
    plan = _PLAN.get()
    if plan is None:
        return x
    sh = plan.sharding(name)
    if sh is None or len(sh.spec) > x.dim():
        return x
    return with_sharding_constraint(x, sh, name)


def device_put(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``x`` placed by ``sharding`` on its mesh: the whole tensor on the
    lead device, carrying ``.sharding`` as the reference's placed array
    does (a new tensor object; ``x`` is not tagged)."""
    with_sharding_constraint(x, sharding)
    out = to_device(x, sharding.mesh.lead)
    if out is x:
        out = x.view_as(x)
    out.sharding = sharding
    return out


# ---------------------------------------------------------------------------
# standard activation plans
# ---------------------------------------------------------------------------


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def lm_activation_plan(mesh, *, shard_seq: bool = True,
                       tp_internal: bool = False,
                       vocab_tp: bool = False) -> ShardingPlan:
    """``tp_internal`` = Megatron-style sequence-parallel TP: the residual
    stream stays seq-sharded over 'model', while the d_ff intermediate and
    the query heads inside each layer are model-sharded."""
    b = batch_axes(mesh)
    seq = "model" if shard_seq else None
    # Logits: seq kept model-sharded through the head when it is; with seq
    # unsharded, the vocab dimension is sharded instead (classic TP head).
    logits = P(b, seq, None) if (shard_seq and not vocab_tp) \
        else P(b, None, "model")
    extra = {}
    if tp_internal:
        extra = {
            "mlp_hidden": P(b, None, "model"),
            "attn_q_heads": P(b, None, "model", None),
        }
    return ShardingPlan(mesh, {
        "tokens": P(b, None),
        "hidden": P(b, seq, None),
        "logits": logits,
        **extra,
        "phi": P(b, None),                    # (B, d) decode hidden
        "kv_cache": P(b, "model", None, None),
        "kv_cache_batch1": P(None, ("data", "model"), None, None),
        "moe_group": P(b, seq, None, None),
        "scores": P(b, "model"),              # (B, N) item scores
    })


def recsys_activation_plan(mesh) -> ShardingPlan:
    b = batch_axes(mesh)
    return ShardingPlan(mesh, {
        "batch": P(b),
        "dense_feats": P(b, None),
        "sparse_ids": P(b, None),
        "hidden": P(b, None),
        "seq_hidden": P(b, None, None),
        "scores": P(b, "model"),
    })


def gnn_activation_plan(mesh) -> ShardingPlan:
    all_axes = tuple(mesh.axis_names)
    return ShardingPlan(mesh, {
        "edges": P(all_axes),                 # edge lists over all devices
        "edge_feats": P(all_axes, None),
        "node_feats": P(None, None),          # replicated
        "batch_nodes": P(batch_axes(mesh)),
    })


# ---------------------------------------------------------------------------
# parameter sharding rules (path pattern -> P)
# ---------------------------------------------------------------------------


def _match(rules, path: str, ndim: int) -> P:
    for pat, spec in rules:
        if re.search(pat, path):
            if len(spec) > ndim:
                raise ValueError(f"spec {spec} too long for {path} ndim={ndim}")
            return spec
    return P()


def path_str(path) -> str:
    """A tree path (dict keys, list indices, dataclass field names) as the
    reference's ``"a/b/0"`` string."""
    return "/".join(str(p) for p in path)


def lm_param_rules(scan_layers: bool = True):
    """Stacked layer params have a leading L dim (unsharded).  2-D weight
    matrices: FSDP dim over 'data', TP dim over 'model'; experts over
    'model' (EP); embedding/vocab over 'model'."""
    l = (None,) if scan_layers else ()
    return [
        # MoE experts: (L, E, d, f) -- E over model, d over data.
        (r"layers/.*moe/(up|gate)$", P(*l, "model", "data", None)),
        (r"layers/.*moe/down$",      P(*l, "model", None, "data")),
        (r"layers/.*moe/router/w$",  P(*l, None, "model")),
        (r"layers/.*moe/shared/.*/w$", P(*l, "data", "model")),
        # Attention + dense MLP 2-D mats: (L, d_in, d_out).
        (r"layers/.*(wq|wk|wv|up|gate)/w$", P(*l, "data", "model")),
        (r"layers/.*(wo|down)/w$",          P(*l, "model", "data")),
        (r"layers/.*/b$", P(*l, "model")),
        (r"layers/.*(scale|bias)$", P(*l, None)),
        # Embedding + unembedding: vocab over model, d over data.
        (r"(embed|head)/table$", P("model", "data")),
        (r"head/w$", P("data", "model")),
        # PQ head: codes over model (items), sub-embeddings replicated.
        (r"pq_head/codes$", P("model", None)),
        (r"pq_head/sub_emb$", P()),
        (r".*", P()),
    ]


def seqrec_param_rules():
    return [
        (r"item_emb/codes$", P("model", None)),
        (r"item_emb/sub_emb$", P()),
        (r"item_emb/table$", P("model", None)),
        (r".*/(wq|wk|wv|up|gate)/w$", P(None, "model")),
        (r".*/(wo|down)/w$", P("model", None)),
        (r".*", P()),
    ]


def recsys_param_rules():
    return [
        (r"tables/.*", P("model", None)),      # embedding rows over model
        (r"item_emb/codes$", P("model", None)),
        (r"item_emb/(sub_emb|table)$", P()),
        (r"mlp/.*w$", P(None, "model")),
        (r".*", P()),
    ]


def gnn_param_rules():
    return [(r".*", P())]        # GraphSAGE params are tiny: replicate


def _axis_size(mesh, ax) -> int:
    size = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        size *= mesh.shape[a]
    return size


def _map_leaves(fn, tree, path=()):
    """``fn(path, leaf)`` over a parameter tree (dicts, lists, tuples and
    dataclasses such as the pruned states, whose tensor fields are its
    leaves), keeping its structure; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v, path + (i,)) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_leaves(fn, getattr(tree, f.name), path + (f.name,))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    return fn(path, tree)


def param_shardings(mesh, params: Any, rules) -> Any:
    """A parameter tree (of tensors, real or on meta) -> the same tree of
    :class:`NamedSharding`.  An axis that does not divide its dimension is
    dropped (that dimension replicated), as in the reference."""

    def leaf(path, x):
        spec = _match(rules, path_str(path), x.dim())
        return NamedSharding(mesh, P(*(
            None if ax is None or x.shape[d] % _axis_size(mesh, ax) else ax
            for d, ax in enumerate(spec))))

    return _map_leaves(leaf, params)


def replicated(mesh, tree: Any) -> Any:
    return _map_leaves(lambda _, __: NamedSharding(mesh, P()), tree)
