"""Dry run: run every (arch x shape) cell's step once on meta tensors (no
storage), count what it does, and write one JSON artifact per cell -- the
reference's ``launch/dryrun.py``, on one card (``--mesh card``) or over
the production meshes (``single``: (data=16, model=16); ``multi``:
(pod=2, data=16, model=16)) with every position on ``"meta"``.

Where the reference lowers and compiles with XLA and reads its cost and
memory analyses, this runs the eager step under :class:`StepCounter`, a
dispatch mode that counts every aten op:

* flops: ``torch.utils.flop_counter``'s formulas (the products), by the
  product's dtype;
* bytes: each op's tensor inputs and outputs (a view adds nothing; an
  in-place op's aliased output adds nothing);
* kernel launches and their work, from the kernel wrappers' record
  (:mod:`repro_torch.kernels.cost`): their bytes join ``bytes_per_device``
  and their adds and lookups stand under a key of their own;
* memory: the arguments, outputs and donated arguments, and the peak of
  the bytes the step allocates and still holds (each storage once,
  whatever its views; a tensor autograd saved for backward stays live);
* which arguments the step reads: an argument is read when an op that
  is not a view and not a shape-only factory (``zeros_like`` and kin), or
  a kernel launch, takes it or a view of it.  An argument consulted only
  for its shape or dtype is unread, as XLA drops it (``jit``'s
  ``keep_unused=False``).

Every record's ``memory`` has ``argument_size_in_bytes``, the bytes of
the arguments the step reads (XLA's convention), and
``state_size_in_bytes``, those of every argument; over a mesh both are
per device, each argument's shard under its ``in_shardings``.  A card
record's counts are the device's.  A mesh record holds the whole step's
counts under ``step_total`` (the single controller runs the step on whole
tensors) and, in the reference's keys, the partitioned step's share of
one device (:class:`PartitionCounter`): flops, bytes, kernel launches and
work, the peak above the arguments, the outputs, and the collectives
(:func:`parse_collectives`'s format, per-device result bytes; also by
mesh axis and for the gradients), with ``unruled_ops``, the ops the
sharding propagator has no rule for, and ``replicated_retries``, the ops
whose rule refused their placements and took one more mesh axis
replicated.

The roofline divides by the H100 SXM's data-sheet peaks (989 TFLOP/s
bf16 dense, 67 TFLOP/s float32 outside the tensor cores -- the port runs
float32 with TF32 off -- and 3.35 TB/s of HBM, at 700 W).  It has two
memory terms: ``memory_s``, the eager step's traffic (every op's inputs
and outputs, so every copy the port's op sequence makes, needed or not),
and ``min_memory_s``, the step's arguments read once and its fresh
outputs written once, which no op sequence changes.  ``bound_s`` takes
the first and ``min_bound_s`` the second; one card has no collectives
(``collective_s`` 0), a mesh record's are its collective bytes over
each axis's link (:func:`link_bytes_per_s`).  A host read of a meta
tensor (the pruned cascade's survivor counts, ROADMAP D1) takes the
largest value the shapes allow,
and the artifact says ``"rung": "max"``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # 40 cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch sasrec-recjpq \\
      --shape serve_users --variant fused_head
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both \\
      --workers 6                                  # 80 mesh records
"""
from __future__ import annotations

import argparse
import functools
import itertools
import json
import os
import sys
import time
import traceback
import weakref
from collections import defaultdict
from dataclasses import replace
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import get_config, list_archs
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import cost
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.training import tree as tree_lib

#: H100 SXM peaks, NVIDIA data sheet (dense, 700 W).
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = cost.HBM_BYTES_PER_S
CARD_HBM_BYTES = 80e9               # the data sheet's 80 GB
DEFAULT_OUT = "artifacts/dryrun_torch"
MESHES = ("card", "single", "multi")
#: Ops that take a tensor for its shape, dtype and device only.
_SHAPE_ONLY = frozenset(
    getattr(torch.ops.aten, n) for n in (
        "empty_like", "zeros_like", "ones_like", "full_like", "rand_like",
        "randn_like", "randint_like", "new_empty", "new_empty_strided",
        "new_zeros", "new_ones", "new_full"))


def _flat_tensors(seq) -> list:
    """The tensors of an op's arguments or outputs (lists one deep, as
    aten passes them)."""
    out = []
    for a in seq:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (tuple, list)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage while it lives (its address; a
    storage's Python object may be made anew at each call, so its ``id``
    may be reused)."""
    return t.untyped_storage()._cdata


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree`` (a tree of the port's
    nodes, :class:`PrunedHeadState` included)."""
    seen = {}
    for t in tree_lib.leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


class StepCounter(TorchDispatchMode):
    """Counts flops (by dtype), bytes and peak live bytes of the aten ops
    run under it, and the kernel launches of ``recorder`` (whose wrappers'
    own ops it leaves out)."""

    def __init__(self, recorder: cost.Recorder):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.rec = recorder
        recorder.on_launch = self._on_launch
        self.flops: Dict[str, int] = defaultdict(int)
        self.bytes = 0
        self.kernel_bytes = 0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._live: Dict[int, int] = {}
        self._refs: Dict[int, Any] = {}
        self.read: set = set()          # storages ops read (storage_key)

    def _free(self, key, _ref):
        self.live -= self._live.pop(key, 0)
        self._refs.pop(key, None)

    def _track(self, tensors):
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self._refs[key] = weakref.ref(st, functools.partial(self._free,
                                                                key))
            self.live += n
        self.peak = max(self.peak, self.live)

    def _on_launch(self, name, work, outputs, reads=()):
        self.kernel_bytes += work.bytes
        self.read.update(storage_key(t) for t in reads)
        self._track(_flat_tensors(
            outputs if isinstance(outputs, tuple) else (outputs,)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _flat_tensors(args)
        if kwargs:
            ins += _flat_tensors(kwargs.values())
        if not func.is_view and func.overloadpacket not in _SHAPE_ONLY:
            self.read.update(storage_key(t) for t in ins)
        if self.rec.hidden:
            return out
        self.n_ops += 1
        outs = ([out] if isinstance(out, torch.Tensor)
                else _flat_tensors(out) if isinstance(out, (tuple, list))
                else [])
        in_st = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs if id(t.untyped_storage()) not in in_st]
        if func._schema.is_mutable or fresh:
            self.bytes += sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t in fresh)
        formula = self._flop_registry.get(func.overloadpacket)
        if formula is not None and ins:
            self.flops[str(ins[0].dtype).replace("torch.", "")] += int(
                formula(*args, **kwargs, out_val=out))
        self._track(fresh)
        return out


# ---------------------------------------------------------------------------
# the partitioned count: one device's share of a step over a mesh
# ---------------------------------------------------------------------------

#: The reference's collective kinds (``parse_collectives``'s HLO names).
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")
#: One way, per GPU: NVLink 4 (H100 SXM data sheet: 900 GB/s
#: bidirectional per GPU) inside an 8-GPU node, and the node's network
#: across nodes (DGX H100: one 400 Gb/s ConnectX-7 NDR port per GPU).
NVLINK_BYTES_PER_S = 450e9
NETWORK_BYTES_PER_S = 50e9
#: Mesh positions map to nodes eight consecutive positions at a time
#: (row-major over the mesh's axes).
GPUS_PER_NODE = 8


@functools.lru_cache(maxsize=None)
def _dt():
    """``torch.distributed.tensor``'s sharding propagator and the private
    pieces the partitioned count uses, imported here alone (lazily: the
    package imports no ``torch.distributed`` at import time)."""
    from types import SimpleNamespace
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    from torch.distributed.tensor._op_schema import OpSchema
    prop = DTensor._op_dispatcher.sharding_propagator
    infos = [prop.op_to_schema_info,
             getattr(prop, "op_to_schema_info_for_single_dim_strategy", {})]
    ruled = [prop.op_strategy_funcs, prop.op_to_rules,
             getattr(prop, "op_single_dim_strategy_funcs", {})]
    return SimpleNamespace(
        # What a rule raises where it refuses the placements it is given
        # (torch 2.13: RuntimeError for an uneven unflatten, say); any
        # other exception (an API change, a malformed question) is a
        # fault and fails the record.
        refusals=(RuntimeError, NotImplementedError, AssertionError,
                  ValueError),
        DeviceMesh=DeviceMesh, Partial=Partial, Replicate=Replicate,
        Shard=Shard, DTensorSpec=DTensorSpec, TensorMeta=TensorMeta,
        OpSchema=OpSchema, prop=prop,
        schema_info=lambda op: next((d[op] for d in infos if op in d), None),
        has_rule=lambda op: any(op in d for d in ruled))


@functools.lru_cache(maxsize=None)
def device_mesh(names: tuple, sizes: tuple):
    """A ``DeviceMesh`` of the shape of a mesh, as rank 0 sees it.  It
    starts no process group: the propagator reads only its shape and
    rank 0's coordinates."""
    import math
    return _dt().DeviceMesh(
        "cpu", torch.arange(math.prod(sizes)).reshape(sizes),
        mesh_dim_names=names, _init_backend=False, _rank=0)


def placements_for(spec, axis_names) -> tuple:
    """A :class:`~repro_torch.distributed.sharding.P` spec (or a device:
    the whole tensor on it) -> one placement per mesh axis, in the mesh's
    order: ``Shard(dim)`` on each axis a dimension's entry names (alone or
    in a tuple; several axes on one dimension split it in the mesh's
    order), ``Replicate()`` on every other."""
    dt = _dt()
    out = [dt.Replicate()] * len(axis_names)
    if isinstance(spec, shd.NamedSharding):
        spec = spec.spec
    if not isinstance(spec, tuple):
        return tuple(out)
    for d, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                out[list(axis_names).index(ax)] = dt.Shard(d)
    return tuple(out)


def local_shape(shape, placements, sizes) -> tuple:
    """Device 0's block of a tensor of ``shape`` under ``placements`` on a
    mesh of ``sizes``: each sharded dimension divided by its axes' sizes,
    rounded up (the first block of an uneven split is the largest)."""
    out = list(shape)
    for pl, n in zip(placements, sizes):
        d = getattr(pl, "dim", None)      # Shard and _StridedShard
        if d is not None and d < len(out):
            out[d] = -(-out[d] // n)
    return tuple(out)


def parse_collectives(events) -> Dict[str, Dict[str, int]]:
    """The reference's ``parse_collectives`` for a partitioned count:
    ``(kind, axis, bytes, ...)`` events -> ``{kind: {"count", "bytes"}}``
    with each collective's per-device result bytes summed."""
    out: Dict[str, Dict[str, int]] = {}
    for kind, _axis, nbytes, *_ in events:
        rec = out.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += nbytes
    return out


def link_bytes_per_s(mesh, axis: str) -> float:
    """The link a collective over ``axis`` crosses: NVLink where every
    group of the axis lies inside one node of :data:`GPUS_PER_NODE`
    consecutive positions, the node's network otherwise."""
    names = list(mesh.axis_names)
    stride = 1
    for a in names[names.index(axis) + 1:]:
        stride *= mesh.shape[a]
    span = stride * mesh.shape[axis]
    inside = span <= GPUS_PER_NODE and GPUS_PER_NODE % span == 0
    return NVLINK_BYTES_PER_S if inside else NETWORK_BYTES_PER_S


def _is_strided(p) -> bool:
    return type(p).__name__ == "_StridedShard"


def _is_split(p) -> bool:
    """``Shard`` or ``_StridedShard``."""
    return getattr(p, "dim", None) is not None


def _transforms(src, dst):
    """The steps from ``src`` to ``dst`` placements, one mesh axis each:
    ``(axis index, collective kind or None)``.  Reductions, gathers and
    all-to-alls come first, the last axis first (a split made over a
    later axis is undone before an earlier one's); local slices (from a
    whole value) come after them."""
    moved = [j for j in range(len(src)) if src[j] != dst[j]]
    first = [j for j in reversed(moved) if not src[j].is_replicate()]
    return [(j, _collective_kind(src[j], dst[j])) for j in first] + [
        (j, None) for j in moved if src[j].is_replicate()]


def _collective_kind(src, dst) -> Optional[str]:
    if src.is_partial():
        return "all-reduce" if dst.is_replicate() else (
            "reduce-scatter" if _is_split(dst) else None)
    if _is_split(src):
        return "all-gather" if dst.is_replicate() else (
            "all-to-all" if _is_split(dst) else None)
    return None                     # a local slice, or nothing


_FRESH = "fresh"                 # a buffer not yet placed
_COUNTS = itertools.count()
#: Ops that make a view's shape as a new tensor.
_VIEW_COPIES = frozenset((torch.ops.aten._unsafe_view.default,
                          torch.ops.aten.reshape.default))


def _index_copy_rule(args, kwargs, src, flat):
    """``index_copy(_)(self, dim, index, source)``, which
    ``torch.distributed.tensor`` has no rule for (a KV cache's write):
    each device writes the rows of ``self`` it holds, ``self`` and the
    output keep their placements, ``source`` takes them but whole along
    ``dim``, ``index`` is whole."""
    self_t, dim = args[0], args[1] % args[0].dim()
    pl = src[id(self_t)]
    whole_dim = tuple(_dt().Replicate() if _is_split(p) and p.dim == dim
                      else p for p in pl)
    repl = tuple(_dt().Replicate() for _ in pl)
    wants = [pl, repl, whole_dim][:len(flat)]
    return wants, [pl]


def _pad_rule(args, kwargs, src, flat):
    """``constant_pad_nd(self, pad, value)`` (``F.pad``; torch 2.11's
    propagator has no rule for it, 2.13's has): a dimension that is
    padded is made whole first, any other keeps its split; a partial sum
    stays partial under a zero pad."""
    self_t, pad = args[0], args[1]
    value = args[2] if len(args) > 2 else kwargs.get("value", 0)
    padded = {self_t.dim() - 1 - i for i in range(len(pad) // 2)
              if pad[2 * i] or pad[2 * i + 1]}
    pl = tuple(_dt().Replicate() if (_is_split(p) and p.dim in padded)
               or (p.is_partial() and value) else p
               for p in src[id(self_t)])
    return [pl], [pl]


def _index_rule(args, kwargs, src, flat):
    """``index(self, indices)`` with one index tensor, at dimension ``p``
    (a table's rows gathered by ids), mesh axis by mesh axis: where the
    ids are split, they keep their split (a batch stays split) and
    ``self`` is made whole; else where ``self``'s rows are split, each
    device gathers the rows it holds and the output is a partial sum (the
    vocabulary-parallel lookup); else ``self``'s split carries over.
    torch 2.11's rule gathers the ids' batch whole and 2.13's splits the
    rows' width instead, so one rule of this count's own keeps the count
    the same on both.  Any other form -> ``None`` (the propagator's
    rule)."""
    self_t, indices = args[0], args[1]
    where = [i for i, x in enumerate(indices) if x is not None]
    if len(where) != 1:
        return None
    p, idx = where[0], indices[where[0]]
    dt = _dt()
    spl, ipl = src[id(self_t)], src[id(idx)]
    if any(_is_strided(q) or q.is_partial() for q in spl + ipl):
        return None
    shift = idx.dim() - 1
    want, out = [], []
    for a, b in zip(spl, ipl):
        if _is_split(b):
            want.append(dt.Replicate())
            out.append(dt.Shard(b.dim + p))
        elif _is_split(a) and a.dim == p:
            want.append(a)
            out.append(dt.Partial())
        elif _is_split(a):
            want.append(a)
            out.append(dt.Shard(a.dim + shift if a.dim > p else a.dim))
        else:
            want.append(a)
            out.append(a)
    want = tuple(want)
    wants = [want if t is self_t else ipl if t is idx else src[id(t)]
             for t in flat]
    return wants, [tuple(out)]


def _pointwise_rule(args, kwargs, src, flat):
    """A pointwise op without a rule of the propagator's
    (``log_sigmoid_forward`` and ``_backward``, in the seqrec and recsys
    losses): the inputs of the first input's shape take the placements of
    the first of them that is split (a partial sum made whole: the op is
    not linear), and so do the outputs; an input of another shape (the
    forward's scratch buffer, empty on the card) is whole."""
    dt = _dt()
    shape = flat[0].shape
    same = [t for t in flat if t.shape == shape]
    ref = next((t for t in same if any(_is_split(p) for p in src[id(t)])),
               same[0])
    pl = tuple(dt.Replicate() if p.is_partial() else p for p in src[id(ref)])
    repl = tuple(dt.Replicate() for _ in pl)
    return [pl if t.shape == shape else repl for t in flat], [pl, pl]


#: Rules of this count's own, for ops the propagator of a torch version
#: has none for, or answers otherwise than another version; a rule may
#: decline a form (``None``) and leave it to the propagator.
_OWN_RULES = {torch.ops.aten.index_copy_: _index_copy_rule,
              torch.ops.aten.index_copy: _index_copy_rule,
              torch.ops.aten.constant_pad_nd: _pad_rule,
              torch.ops.aten.index: _index_rule,
              torch.ops.aten.log_sigmoid_forward: _pointwise_rule,
              torch.ops.aten.log_sigmoid_backward: _pointwise_rule}
#: The propagator's answers, kept across counts in this process.
_PROPAGATED: Dict[Any, Any] = {}


class PartitionCounter(StepCounter):
    """:class:`StepCounter` (the whole step's counts) and, beside it, one
    device's share of the step partitioned over ``mesh`` (shadow
    propagation): the step runs as ever, one controller on whole tensors,
    while each tensor carries the placements it would have on the mesh.

    * Each argument leaf starts from its ``in_shardings`` entry
      (:func:`placements_for`).
    * Each aten op goes through ``torch.distributed.tensor``'s sharding
      propagator: its output placements are kept, and each input
      redistribution it asks for is a collective over the mesh axes
      involved (Shard->Replicate all-gather, Partial->Replicate all-reduce,
      Partial->Shard reduce-scatter, Shard(i)->Shard(j) all-to-all;
      Replicate->Shard is a local slice).  A reduced input keeps its
      reduced placements (the reduction is done once); a gather of one
      tensor is kept beside it for its later uses.  Flops, bytes and live
      bytes are taken at device 0's block of each tensor; a reduction's
      result counts toward the peak while its op runs, a kept gather
      while its tensor lives.
    * Where the propagator alone gives no or a poor answer: a rule it
      refuses is asked again with one more mesh axis replicated at a
      time (and listed, ``retried``); a strided split (a merge of split
      dimensions) is asked as the plain split; a fresh buffer is placed
      where it is first read; ``index_copy``, ``constant_pad_nd``,
      ``index`` and ``log_sigmoid`` have rules of this count's own
      (:data:`_OWN_RULES`).
      An op without any rule all-gathers its sharded inputs, gives a
      replicated output and is listed (``unruled``).
    * A step's outputs are whole: a partial sum among them is reduced
      (:meth:`finish`).
    * A constraint point (``sharding.with_sharding_constraint``)
      redistributes to its spec, as GSPMD's constraint does, and a
      gradient takes its parameter's placements (``sharding.gradients``).
    * A manual region's body runs for one position at a time
      (``cost.at_position``, or the position its inputs were cut for):
      only position 0's work is the device's, the others' ops are skipped.
      The region's blocks move nothing; its merges are collectives over
      its axis with their per-device result bytes (``all_gather`` and
      ``host_values`` all-gathers, ``pmax`` and ``psum`` all-reduces,
      ``replicate`` whatever reaching a replicated value takes).
    * A kernel launch is a custom call: its sharded inputs are gathered
      first, its work is as recorded and its outputs are replicated.

    A collective over an axis of size 1 moves nothing and is not
    counted."""

    def __init__(self, recorder: cost.Recorder, mesh):
        super().__init__(recorder)
        from torch.utils.weak import WeakTensorKeyDictionary
        recorder.on_mesh_op = self._on_mesh_op
        self.mesh = mesh
        self.names = tuple(mesh.axis_names)
        self.sizes = tuple(mesh.shape[a] for a in self.names)
        self.dmesh = device_mesh(self.names, self.sizes)
        # Each tensor's (placements, position) rides on the tensor, under a
        # name of this count's own (a tensor's attributes live and die
        # with it, and a lookup there is cheaper than a weak mapping's).
        self._key = f"_partition_{next(_COUNTS)}"
        self._gathers = WeakTensorKeyDictionary()  # tensor -> kept gathers
        self.dev_flops: Dict[str, int] = defaultdict(int)
        self.dev_bytes = 0
        self.dev_kernel_bytes = 0
        self.dev_launches: Dict[str, int] = dict.fromkeys(cost.FORMS, 0)
        self.dev_work = {f: {"bytes": 0, "adds": 0, "lookups": 0}
                         for f in cost.FORMS}
        self.events: list = []          # (kind, axis, bytes, origin)
        self._origin = ""               # what the next collective serves
        self.unruled: Dict[str, int] = defaultdict(int)
        self.retried: Dict[str, int] = defaultdict(int)
        self.dev_live = 0
        self.dev_peak = 0
        self._dev: Dict[int, int] = {}
        self._dev_refs: Dict[int, Any] = {}
        self._repl = tuple(_dt().Replicate() for _ in self.names)

    # -- placements ---------------------------------------------------------

    def seed(self, tensor: torch.Tensor, sharding) -> None:
        """Start ``tensor`` (an argument leaf) at ``sharding``."""
        setattr(tensor, self._key,
                (placements_for(sharding, self.names), None))

    def _pl(self, t: torch.Tensor) -> tuple:
        hit = t.__dict__.get(self._key)
        if hit is not None and hit[0] is _FRESH:
            self._place(t, self._repl)
            return self._repl
        pl = hit[0] if hit is not None and hit[0] is not None else self._repl
        # A placement that no longer fits (a rank change in place): whole.
        if any(_is_split(p) and p.dim >= max(t.dim(), 1) for p in pl):
            return self._repl
        return pl

    def _pos(self, t: torch.Tensor):
        hit = t.__dict__.get(self._key)
        return None if hit is None else hit[1]

    def _set(self, t: torch.Tensor, pl, pos) -> None:
        setattr(t, self._key, (pl, pos))

    def _fresh(self, t: torch.Tensor) -> bool:
        hit = t.__dict__.get(self._key)
        return hit is not None and hit[0] is _FRESH

    def _place(self, t: torch.Tensor, pl) -> None:
        """Give a fresh buffer its placements; it is written and held from
        here."""
        self._set(t, tuple(pl), self._pos(t))
        self.dev_bytes += self._local_bytes(t, pl)
        self._dev_track([t])

    def _spec(self, t: torch.Tensor, pl):
        dt = _dt()
        return dt.DTensorSpec(self.dmesh, tuple(pl), dt.TensorMeta(
            t.shape, t.stride(), t.dtype))

    def _local_bytes(self, t: torch.Tensor, pl) -> int:
        n = 1
        for s in local_shape(t.shape, pl, self.sizes):
            n *= s
        return n * t.element_size()

    # -- accounting -----------------------------------------------------------

    def _collective(self, kind: str, axis: str, nbytes: int) -> None:
        self.events.append((kind, axis, int(nbytes), self._origin))

    def _dev_free(self, key, _ref):
        self.dev_live -= self._dev.pop(key, 0)
        self._dev_refs.pop(key, None)

    def _dev_track(self, tensors, extra: int = 0) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._dev:
                continue
            n = self._local_bytes(t, self._pl(t))
            self._dev[key] = n
            self._dev_refs[key] = weakref.ref(
                st, functools.partial(self._dev_free, key))
            self.dev_live += n
        self.dev_peak = max(self.dev_peak, self.dev_live + extra)

    def _redistribute(self, t: torch.Tensor, src, dst) -> int:
        """Count the collectives that take ``t`` from ``src`` to ``dst``
        placements -> the bytes of a reduction's result (a per-device
        buffer while the op runs; the reduced value then replaces the
        partial one).  A gather's result is kept beside ``t`` while it
        lives and counts toward the live bytes: the same gather of the
        same tensor is not made again (XLA shares one collective among its
        uses)."""
        src, dst = tuple(src), tuple(dst)
        if src == dst:
            return 0
        kept = self._gathers.get(t)
        if kept is not None and (src, dst) in kept:
            return 0
        cur, held = list(src), 0
        for j, kind in _transforms(src, dst):
            cur[j] = dst[j]
            if kind is None or self.sizes[j] == 1:
                continue
            n = self._local_bytes(t, cur)
            self._collective(kind, self.names[j], n)
            held += n
        if held and not any(p.is_partial() for p in src):
            n = self._local_bytes(t, dst)
            if kept is None:
                kept = self._gathers[t] = {}
                weakref.finalize(t, self._drop_gathers, kept)
            kept[(src, dst)] = n
            self.dev_live += n
            return 0
        return held

    def _drop_gathers(self, kept) -> None:
        self.dev_live -= sum(kept.values())

    def _reduce_sticky(self, t, src, dst) -> None:
        """A reduced input keeps its reduced placements."""
        if any(a.is_partial() for a in src):
            self._set(t, tuple(b if a.is_partial() else a
                               for a, b in zip(src, dst)), self._pos(t))

    # -- positions ------------------------------------------------------------

    def _position(self, ins):
        """The position an op runs at: the running body's, else the one
        its inputs were made at; ``"mixed"`` where they come from several
        positions of one axis (a merge made of plain ops)."""
        pos = cost.current_position()
        if pos is not None:
            return tuple(pos)
        seen = {self._pos(t) for t in ins} - {None}
        if len(seen) > 1:
            return "mixed"
        return next(iter(seen), None)

    def _skip(self, pos, outs) -> bool:
        """Another position's op: tag its outputs, count nothing."""
        if pos is None or pos == "mixed" or pos[1] == 0:
            return False
        for t in outs:
            self._set(t, None, pos)
        return True

    # -- dispatch -------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.rec.hidden or self.rec.in_mesh_op:
            return out
        self._origin = str(func)
        self._partition(func, args, kwargs, out)
        return out

    def _partition(self, func, args, kwargs, out) -> None:
        from torch.utils._pytree import tree_map_only
        ins = _flat_tensors(args)
        if kwargs:
            ins += _flat_tensors(kwargs.values())
        outs = ([out] if isinstance(out, torch.Tensor)
                else _flat_tensors(out) if isinstance(out, (tuple, list))
                else [])
        pos = self._position(ins)
        if self._skip(pos, outs):
            return
        # A fresh buffer (a factory's, or a shape-only op's of a new shape)
        # takes its placements at its first use, as GSPMD carries a
        # consumer's sharding back to the buffer it reads: those of the
        # op's other input of its shape.  An op with no such input whose
        # outputs have the buffer's shape (a scatter into it, a unary op)
        # passes the choice on to the next reader; any other op places it
        # as its first other input of its rank, or whole.
        fresh_in = [t for t in ins if self._fresh(t)]
        if fresh_in:
            same = {t: next((u for u in ins if not self._fresh(u)
                             and u.shape == t.shape), None)
                    for t in fresh_in}
            if not func.is_view and outs and all(
                    u is None for u in same.values()) and all(
                    any(o.shape == t.shape for t in fresh_in) for o in outs):
                for o in outs:
                    self._set(o, _FRESH, pos)
                return
            for t in fresh_in:
                ref = same[t] if same[t] is not None else next(
                    (u for u in ins if not self._fresh(u)
                     and u.dim() == t.dim()), None)
                self._place(t, self._repl if ref is None else self._pl(ref))
        held = 0
        if pos == "mixed":
            # Values of several positions met in one op: a gather over
            # their axis of what the op returns.
            axis = next(p[0] for p in map(self._pos, ins) if p)
            for t in outs:
                n = self._local_bytes(t, self._repl)
                self._collective("all-gather", axis, n)
                held += n
            pos = None
        src = {id(t): self._pl(t) for t in ins}
        if not ins or (func.overloadpacket in _SHAPE_ONLY and outs
                       and outs[0].shape != ins[0].shape):
            for t in outs:              # placed where it is first read
                self._set(t, _FRESH, pos)
            return
        want, out_pl = self._propagate(func, args, kwargs, src, out)
        for t in ins:
            if src[id(t)] != want[id(t)]:
                held += self._redistribute(t, src[id(t)], want[id(t)])
                self._reduce_sticky(t, src[id(t)], want[id(t)])
        if out_pl is None or len(out_pl) < len(outs):
            out_pl = [self._repl] * len(outs)
        for t, pl in zip(outs, out_pl):
            self._set(t, pl or self._repl, pos)
        in_st = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs if id(t.untyped_storage()) not in in_st]
        if func._schema.is_mutable or fresh:
            self.dev_bytes += sum(self._local_bytes(t, want[id(t)])
                                  for t in ins) \
                + sum(self._local_bytes(t, self._pl(t)) for t in fresh)
        formula = self._flop_registry.get(func.overloadpacket)
        if formula is not None and ins:
            def local(t, pl):
                return torch.empty(local_shape(t.shape, pl, self.sizes),
                                   dtype=t.dtype, device="meta")
            largs, lkw = tree_map_only(
                torch.Tensor, lambda t: local(t, want[id(t)]),
                (tuple(args), kwargs))
            lout = tree_map_only(torch.Tensor,
                                 lambda t: local(t, self._pl(t)), out)
            self.dev_flops[str(ins[0].dtype).replace("torch.", "")] += int(
                formula(*largs, **lkw, out_val=lout))
        self._dev_track(fresh, held)

    def _propagate(self, func, args, kwargs, src, out=None):
        """The propagator's answer for ``func`` on inputs at ``src`` ->
        (the placements each input must take, the outputs' placements).
        Where its rule refuses these placements (an uneven split, say),
        the inputs are replicated over one more mesh axis at a time, the
        last first, until it accepts them; an op with no rule at all
        replicates its inputs and its outputs and is listed.  Answers are
        kept by op, shapes, placements and the other arguments (a model's
        layers repeat them)."""
        flat = _flat_tensors(args) + _flat_tensors(kwargs.values())
        repl = self._repl
        if all(src[id(t)] == repl for t in flat):
            # Whole inputs give whole outputs, whatever the op.
            return src, [repl] * (len(out) if isinstance(out, (tuple, list))
                                  else 1)

        if func is torch.ops.aten.select.int:
            # Where a row is taken does not change where it lies.
            args = (args[0], args[1], 0)

        def sig(x):
            if isinstance(x, torch.Tensor):
                return (tuple(x.shape), x.stride(), x.dtype, src[id(x)])
            if isinstance(x, (list, tuple)):
                return tuple(sig(y) for y in x)
            return x
        try:
            key = (self.names, self.sizes, func, sig(args),
                   tuple((k, sig(v)) for k, v in kwargs.items()))
            hit = _PROPAGATED.get(key)
        except TypeError:               # an unhashable argument
            key = hit = None
        if hit is None:
            hit = self._propagate_uncached(func, args, kwargs, src, flat)
            if key is not None:
                _PROPAGATED[key] = hit
        wants, out_pl, retried = hit
        if out_pl is None:
            self.unruled[str(func)] += 1
        elif retried:
            self.retried[str(func)] += 1
        return {id(t): w for t, w in zip(flat, wants)}, out_pl

    def _propagate_uncached(self, func, args, kwargs, src, flat):
        """-> (each input's placements, the outputs', whether the answer
        took one more mesh axis replicated)."""
        dt = _dt()
        own = _OWN_RULES.get(func.overloadpacket)
        got = None if own is None else own(args, kwargs, src, flat)
        if got is not None:
            return (*got, False)
        if not dt.has_rule(func):
            return [self._repl] * len(flat), None, False
        # A split that a merge of split dimensions left strided (the rows
        # of a (B, S) -> (B * S) view) is asked as the plain split of the
        # same dimension: the rows of a product may lie in any order, and
        # the propagator's rules know plain splits best.  An output split
        # the same way over the same axis is strided again.
        strided = {j: p for pl in src.values() for j, p in enumerate(pl)
                   if _is_strided(p)}
        orig = [src[id(t)] for t in flat]

        def restrided(got):
            if got is None or not strided:
                return got
            wants, outs = got
            wants = [tuple(o[j] if _is_strided(o[j]) and _is_split(w)
                           and w.dim == o[j].dim else w
                           for j, w in enumerate(pl))
                     for pl, o in zip(wants, orig)]
            return wants, [None if pl is None else tuple(
                type(strided[j])(p.dim, split_factor=strided[j].split_factor)
                if j in strided and _is_split(p) and p.dim == strided[j].dim
                else p for j, p in enumerate(pl)) for pl in outs]

        got = None
        if not strided or func.is_view or func in _VIEW_COPIES:
            # A view's rule reads strided splits (it makes them).
            got = self._ask(func, args, kwargs, src, flat)
        tried = {key: tuple(dt.Shard(p.dim) if _is_strided(p) else p
                            for p in pl) for key, pl in src.items()}
        if got is None and strided:
            got = restrided(self._ask(func, args, kwargs, tried, flat))
        if got is not None:
            return (*got, False)
        for k in range(len(self.names) - 1, -1, -1):
            tried = {key: tuple(dt.Replicate() if j >= k else p
                                for j, p in enumerate(pl))
                     for key, pl in tried.items()}
            got = restrided(self._ask(func, args, kwargs, tried, flat))
            if got is not None:
                return (*got, True)
        return [self._repl] * len(flat), None, False

    def _ask(self, func, args, kwargs, pls, flat):
        """One question to the propagator: ``func`` on inputs at ``pls``
        -> (each input's placements, the outputs'), or ``None`` where its
        rule refuses them."""
        from torch.utils._pytree import tree_flatten, tree_map_only
        dt = _dt()
        try:
            osh = dt.prop.propagate_op_sharding(dt.OpSchema(
                func, tree_map_only(
                    torch.Tensor, lambda t: self._spec(t, pls[id(t)]),
                    tuple(args)),
                tree_map_only(torch.Tensor,
                              lambda t: self._spec(t, pls[id(t)]), kwargs),
                schema_info=dt.schema_info(func)))
        except dt.refusals:
            return None
        n = len(self.names)
        wants = [pls[id(t)] for t in flat]
        if osh.redistribute_schema is not None:
            got = [x for x in tree_flatten(
                (osh.redistribute_schema.args_schema,
                 osh.redistribute_schema.kwargs_schema))[0]
                   if isinstance(x, dt.DTensorSpec)]
            for i, sp in enumerate(got[:len(wants)]):
                wants[i] = tuple(sp.placements)
        spec = osh.output_spec
        specs = ([spec] if not isinstance(spec, (tuple, list))
                 else list(spec))
        outs = [None if x is None else tuple(x.placements) for x in specs]
        if any(len(pl) != n for pl in wants + [o for o in outs if o]):
            return None                 # an answer for another mesh
        return wants, outs

    def _on_launch(self, name, work, outputs, reads=()):
        super()._on_launch(name, work, outputs, reads)
        self._origin = name
        outs = _flat_tensors(outputs if isinstance(outputs, tuple)
                             else (outputs,))
        pos = self._position(list(reads))
        if self._skip(pos, outs):
            return
        if pos == "mixed":
            pos = None
        held = 0
        for t in reads:                 # a custom call: inputs gathered
            held += self._redistribute(t, self._pl(t), self._repl)
            self._reduce_sticky(t, self._pl(t), self._repl)
        self.dev_launches[name] += 1
        w = self.dev_work[name]
        w["bytes"] += work.bytes
        w["adds"] += work.adds
        w["lookups"] += work.lookups
        self.dev_kernel_bytes += work.bytes
        for t in outs:
            self._set(t, self._repl, pos)
        self._dev_track(outs, held)

    # -- the sharding helpers -------------------------------------------------

    def _merge_axis(self, parts, info) -> Optional[str]:
        for t in parts:
            p = self._pos(t) if isinstance(t, torch.Tensor) else None
            if p is not None:
                return p[0]
        if info.get("axis") is not None:
            return info["axis"]
        names = info["mesh"].axis_names
        return names[0] if len(names) == 1 else shd.AXIS

    def _on_mesh_op(self, kind, parts, out, info) -> None:
        self._origin = kind
        pos = cost.current_position()
        if pos is not None and pos[1] != 0:
            for t in _flat_tensors(out if isinstance(out, (tuple, list))
                                   else (out,)):
                self._set(t, None, tuple(pos))
            return
        if kind == "gradients":
            for p, g in zip(parts, info["grads"]):
                if g is None or (self._pos(g) or ("", 0))[1] != 0:
                    continue
                dst = self._pl(p)
                if self._fresh(g):
                    self._place(g, dst)
                    continue
                held = self._redistribute(g, self._pl(g), dst)
                self._set(g, dst, self._pos(g))
                self.dev_peak = max(self.dev_peak, self.dev_live + held)
            return
        if kind == "constraint":
            (x,) = parts
            if (self._pos(x) or ("", 0))[1] != 0:
                return
            dst = placements_for(info["sharding"], self.names)
            if self._fresh(x):
                self._place(x, dst)
                return
            src = self._pl(x)
            held = self._redistribute(x, src, dst)
            self._set(x, dst, self._pos(x))
            self.dev_peak = max(self.dev_peak, self.dev_live + held)
            return
        axis = self._merge_axis(parts, info)
        ax = self.names.index(axis) if axis in self.names else None
        if kind in ("block", "shard_rows"):
            (x,) = parts
            blocks = [out] if kind == "block" else list(out)
            first = info.get("index", 0)
            src = self._pl(x)
            dst = list(src)
            if ax is not None:
                dst[ax] = _dt().Shard(info["dim"])
            held = self._redistribute(x, src, dst) if first == 0 else 0
            if ax is not None:
                dst[ax] = _dt().Replicate()
            for i, blk in enumerate(blocks, start=first):
                self._set(blk, tuple(dst) if i == 0 else None, (axis, i))
            self.dev_peak = max(self.dev_peak, self.dev_live + held)
            return
        if kind == "replicate":
            (x,) = parts
            src = self._pl(x)
            dst = list(src)
            for i, a in enumerate(self.names):
                if info.get("axis") in (None, a):
                    dst[i] = _dt().Replicate()
            held = self._redistribute(x, src, dst)
            self._set(x, tuple(dst), self._pos(x))
            for i, t in enumerate(out):
                if t is not x:
                    self._set(t, tuple(dst) if i == 0 else None,
                              (info.get("axis") or axis, i))
            self.dev_peak = max(self.dev_peak, self.dev_live + held)
            return
        # Merges of the positions' values: all_gather, pmax, psum and
        # host_values.
        p0 = parts[0]
        pl = self._pl(p0)
        if ax is not None and self.sizes[ax] > 1:
            if kind == "host_values":
                n = sum(self._local_bytes(t, pl) for t in parts)
            else:
                n = self._local_bytes(out, pl)
            self._collective("all-reduce" if kind in ("pmax", "psum")
                             else "all-gather", axis, n)
        if isinstance(out, torch.Tensor):
            self._set(out, pl, None)
            self._dev_track([out])

    # -- results -------------------------------------------------------------

    def finish(self, outs) -> None:
        """A step returns whole values: an output that is a partial sum is
        reduced (an all-reduce over its axes), as XLA reduces one before
        returning it; outputs that share a storage are reduced once."""
        self._origin = "output"
        done = set()
        for t in tree_lib.leaves(outs):
            t = t.parts[0] if isinstance(t, shd.Varying) else t
            if not isinstance(t, torch.Tensor) or self._fresh(t):
                continue
            src = self._pl(t)
            key = id(t.untyped_storage())
            if key in done:
                self._set(t, tuple(_dt().Replicate() if p.is_partial()
                                   else p for p in src), self._pos(t))
                continue
            done.add(key)
            if any(p.is_partial() for p in src):
                dst = tuple(_dt().Replicate() if p.is_partial() else p
                            for p in src)
                held = self._redistribute(t, src, dst)
                self._set(t, dst, self._pos(t))
                self.dev_peak = max(self.dev_peak, self.dev_live + held)

    def output_bytes(self, outs) -> int:
        """Per-device bytes of the step's outputs (each storage once; a
        :class:`~repro_torch.distributed.sharding.Varying` output holds
        position 0's)."""
        seen = {}
        for t in tree_lib.leaves(outs):
            if isinstance(t, shd.Varying):
                t = t.parts[0]
            if isinstance(t, torch.Tensor):
                seen[id(t.untyped_storage())] = self._local_bytes(
                    t, self._pl(t))
        return sum(seen.values())

    def totals(self) -> Dict[str, Any]:
        colls = parse_collectives(self.events)
        by_axis: Dict[str, Any] = {}
        for kind, axis, n, _ in self.events:
            rec = by_axis.setdefault(axis, {}).setdefault(
                kind, {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += n
        adds = sum(w["adds"] for w in self.dev_work.values())
        lookups = sum(w["lookups"] for w in self.dev_work.values())
        return {
            "flops_by_dtype": dict(self.dev_flops),
            "flops": sum(self.dev_flops.values()),
            "bytes": self.dev_bytes + self.dev_kernel_bytes,
            "aten_bytes": self.dev_bytes,
            "kernel_bytes": self.dev_kernel_bytes,
            "kernel_ops": {"adds": adds, "lookups": lookups},
            "launches": dict(self.dev_launches),
            "kernel_work": {k: dict(v) for k, v in self.dev_work.items()
                            if self.dev_launches[k]},
            "peak_bytes": self.dev_peak,
            "collectives": colls,
            "collectives_by_axis": by_axis,
            "collective_bytes": sum(v["bytes"] for v in colls.values()),
            "gradient_collectives": parse_collectives(
                e for e in self.events if e[3] == "gradients"),
            "events": list(self.events),
            "collective_s": sum(
                sum(v["bytes"] for v in kinds.values())
                / link_bytes_per_s(self.mesh, axis)
                for axis, kinds in by_axis.items()),
            "unruled_ops": dict(sorted(self.unruled.items())),
            "replicated_retries": dict(sorted(self.retried.items())),
        }


def _argument_leaves(bundle):
    """``(argnum, leaf, its sharding)`` for every argument leaf."""
    for i, (arg, shards) in enumerate(zip(bundle.args,
                                          bundle.in_shardings)):
        leaves = tree_lib.leaves(arg)
        shard_leaves = ([shards] * len(leaves)
                        if isinstance(shards, torch.device)
                        else tree_lib.leaves(shards))
        if len(shard_leaves) != len(leaves):
            raise ValueError(f"argument {i} of {bundle.name}: "
                             f"{len(leaves)} leaves, {len(shard_leaves)} "
                             "shardings")
        for t, sh in zip(leaves, shard_leaves):
            yield i, t, sh


def _measure(bundle) -> Dict[str, Any]:
    """Run ``bundle.step_fn(*bundle.args)`` once, under its activation
    plan, inside a :class:`StepCounter` -> its counts, the step's outputs'
    bytes, the storages of the arguments it read and the run's seconds;
    for a bundle over a mesh, inside a :class:`PartitionCounter`, with one
    device's share under ``"device"``."""
    with cost.recording() as rec:
        if bundle.mesh is None:
            counter = StepCounter(rec)
        else:
            counter = PartitionCounter(rec, bundle.mesh)
            for _, t, sh in _argument_leaves(bundle):
                counter.seed(t, sh)
        t0 = time.perf_counter()
        with shd.activation_plan(bundle.plan), counter:
            out = bundle.step_fn(*bundle.args)
        secs = time.perf_counter() - t0
    kern = rec.totals()
    outs = list(out) if isinstance(out, tuple) else out
    device = None
    if bundle.mesh is not None:
        counter.finish(outs)
        device = counter.totals()
        device["output_bytes"] = counter.output_bytes(outs)
        arg_st = {}
        for _, t, sh in _argument_leaves(bundle):
            arg_st[id(t.untyped_storage())] = shard_bytes(t, sh)
        out_st = {}
        for t in tree_lib.leaves(outs):
            t = t.parts[0] if isinstance(t, shd.Varying) else t
            if isinstance(t, torch.Tensor) and \
                    id(t.untyped_storage()) not in arg_st:
                out_st[id(t.untyped_storage())] = counter._local_bytes(
                    t, counter._pl(t))
        device["min_bytes"] = sum(arg_st.values()) + sum(out_st.values())
    return {
        "device": device,
        "flops_by_dtype": dict(counter.flops),
        "flops": sum(counter.flops.values()),
        "bytes": counter.bytes + counter.kernel_bytes,
        "aten_bytes": counter.bytes,
        "kernel_bytes": counter.kernel_bytes,
        "kernel_ops": {"adds": kern["adds"], "lookups": kern["lookups"]},
        "launches": dict(rec.launches),
        "stand_ins": sorted(set(rec.stand_ins)),
        "peak_bytes": counter.peak,
        "aten_ops": counter.n_ops,
        "output_bytes": storage_bytes(outs),
        "min_bytes": storage_bytes([list(bundle.args), outs]),   # each once
        "read_storages": counter.read,
        "seconds": secs,
    }


def shard_bytes(t: torch.Tensor, sharding) -> int:
    """Bytes of ``t``'s block on one device under ``sharding``: a
    :class:`~repro_torch.distributed.sharding.NamedSharding` divides each
    dimension by the sizes of the mesh axes its spec names (the builders'
    specs divide their dimensions); a device holds all of its storage."""
    if not isinstance(sharding, shd.NamedSharding):
        return t.untyped_storage().nbytes()
    n = _nbytes(t)
    for entry in sharding.spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                n //= sharding.mesh.shape[ax]
    return n


def argument_bytes(bundle, read_storages) -> Dict[str, int]:
    """Per device: ``argument_size_in_bytes``, the shards of the arguments
    the step read (XLA's convention: an unread argument is dropped);
    ``state_size_in_bytes``, those of every argument; and
    ``alias_size_in_bytes``, those of the donated arguments.  An argument
    counts once however many of its leaves share its storage."""
    out = {"argument_size_in_bytes": 0, "state_size_in_bytes": 0,
           "alias_size_in_bytes": 0}
    seen = set()
    for i, t, sh in _argument_leaves(bundle):
        key = storage_key(t)
        if key in seen:
            continue
        seen.add(key)
        n = shard_bytes(t, sh)
        out["state_size_in_bytes"] += n
        out["argument_size_in_bytes"] += n if key in read_storages else 0
        out["alias_size_in_bytes"] += n if i in bundle.donate else 0
    return out


def roofline(flops_by_dtype: Dict[str, int], nbytes: float,
             kernel_ops: Dict[str, int], min_bytes: float,
             n_sms: int = cost.H100_SMS,
             collective_s: float = 0.0) -> Dict[str, Any]:
    """Seconds at the H100's peaks: products by dtype, the kernels' adds
    and S lookups (the slower of the two), and HBM bytes twice -- the eager
    step's traffic ``nbytes`` and ``min_bytes``, the arguments read once
    and the fresh outputs written once.  ``bound_s`` takes the first and
    ``min_bound_s`` the second, which does not grow with the copies the
    op sequence makes.  ``collective_s`` (a partitioned step's collective
    bytes over its links, :func:`link_bytes_per_s`) joins both bounds."""
    compute = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
                  for dt, f in flops_by_dtype.items())
    _, _, terms = cost.bound_ms(0, kernel_ops["adds"], kernel_ops["lookups"],
                                n_sms)
    out = {"compute_s": compute, "memory_s": nbytes / HBM_BW,
           "min_memory_s": min_bytes / HBM_BW,
           "kernel_ops_s": max(terms["adds"], terms["lookups"]) / 1e3,
           "collective_s": collective_s}
    for pre, mem in (("", "memory_s"), ("min_", "min_memory_s")):
        cand = {k: out[k] for k in ("compute_s", mem, "kernel_ops_s",
                                    "collective_s")}
        out[pre + "bound_by"] = max(cand, key=cand.get).removesuffix(
            "_s").removeprefix("min_")
        out[pre + "bound_s"] = max(cand.values())
    return out


def extrapolate_lm(arch_id: str, shape_name: str, device="meta",
                   variant: str = "baseline", arch_override=None):
    """The reference's scan correction: count the cell at n_layers=1 and
    2 (``scan_layers=False``), then

       per_layer = f(2) - f(1);  outside = f(1) - per_layer
       total     = outside + per_layer * L

    for flops, bytes and collective bytes; ``device`` a mesh: one
    device's share of each (the partitioned count), as the reference's
    is on its ``single`` mesh.  The eager count has no scan to
    undercount, so the direct count is exact at any depth; this is kept
    beside it to compare with the reference's artifacts.  It equals the
    direct count where every layer does the same work, and misses
    gemma3's global layers (its L=1 and L=2 are both local; ROADMAP
    C13)."""
    arch = arch_override if arch_override is not None else get_config(
        arch_id)
    cfg = arch.model
    per = {}
    for n_layers in (1, 2):
        sub = replace(arch, model=replace(cfg, n_layers=n_layers,
                                          scan_layers=False))
        bundle = steps.build_step(arch_id, shape_name, device, variant,
                                  arch_override=sub)
        m = _measure(bundle)
        d = m["device"] or {**m, "collective_bytes": 0}
        per[n_layers] = (d["flops"], d["bytes"], d["collective_bytes"])
    (f1, b1, c1), (f2, b2, c2) = per[1], per[2]
    L = cfg.n_layers
    return {
        "flops_per_device": (f1 - (f2 - f1)) + (f2 - f1) * L,
        "bytes_per_device": (b1 - (b2 - b1)) + (b2 - b1) * L,
        "collective_bytes_per_device": (c1 - (c2 - c1)) + (c2 - c1) * L,
        "per_layer": {"flops": f2 - f1, "bytes": b2 - b1,
                      "collective_bytes": c2 - c1},
        "outside": {"flops": f1 - (f2 - f1), "bytes": b1 - (b2 - b1),
                    "collective_bytes": c1 - (c2 - c1)},
    }


def mesh_for(mesh_kind: str):
    """``"card"`` -> the one-device bundle's device (meta); ``"single"`` /
    ``"multi"`` -> the production mesh with every position on meta."""
    if mesh_kind not in MESHES:
        raise ValueError(f"mesh {mesh_kind!r}: one of {MESHES}")
    if mesh_kind == "card":
        return "meta"
    multi = mesh_kind == "multi"
    return make_production_mesh(multi_pod=multi,
                                devices=["meta"] * (512 if multi else 256))


def run_cell(arch_id: str, shape_name: str, mesh_kind: str = "card",
             variant: str = "baseline", out_dir: str = DEFAULT_OUT, *,
             verbose: bool = True, arch_override=None) -> Dict[str, Any]:
    """Build the cell's bundle on meta (one card, or the ``single`` or
    ``multi`` production mesh), count one run of its step, write
    ``<arch>__<shape>__<mesh>__<variant>.json`` to ``out_dir`` and return
    it.  A failure is recorded in the artifact (``error``, ``traceback``),
    not raised."""
    result: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
        "variant": variant, "devices": 1, "ok": False,
    }
    t0 = time.perf_counter()
    try:
        where = mesh_for(mesh_kind)
        if mesh_kind != "card":
            result["devices"] = where.size
            result["mesh_shape"] = dict(where.shape)
        bundle = steps.build_step(arch_id, shape_name, where, variant,
                                  arch_override=arch_override)
        t_lower = time.perf_counter() - t0
        m = _measure(bundle)
        args = argument_bytes(bundle, m["read_storages"])
        result.update({"ok": True, "lower_s": round(t_lower, 2),
                       "compile_s": round(m["seconds"], 2)})
        if mesh_kind == "card":
            state = args["state_size_in_bytes"]
            result.update({
                "memory": {**args,
                           "output_size_in_bytes": m["output_bytes"],
                           "temp_size_in_bytes": m["peak_bytes"],
                           "generated_code_size_in_bytes": None},
                "fits_one_card": state + m["peak_bytes"] <= CARD_HBM_BYTES,
                "flops_per_device": m["flops"],
                "flops_by_dtype": m["flops_by_dtype"],
                "bytes_per_device": m["bytes"],
                "aten_bytes_per_device": m["aten_bytes"],
                "kernel_bytes_per_device": m["kernel_bytes"],
                "kernel_ops_per_device": m["kernel_ops"],
                "kernel_launches": m["launches"],
                "aten_ops": m["aten_ops"],
                "collectives": {},
                "collective_bytes_per_device": 0,
            })
        else:
            dev = m["device"]
            state = args["state_size_in_bytes"]
            result.update({
                "memory": {**args,
                           "output_size_in_bytes": dev["output_bytes"],
                           "temp_size_in_bytes": dev["peak_bytes"],
                           "generated_code_size_in_bytes": None},
                "state_fits_card": state <= CARD_HBM_BYTES,
                "fits_card": state + dev["peak_bytes"] <= CARD_HBM_BYTES,
                "flops_per_device": dev["flops"],
                "flops_by_dtype": dev["flops_by_dtype"],
                "bytes_per_device": dev["bytes"],
                "aten_bytes_per_device": dev["aten_bytes"],
                "kernel_bytes_per_device": dev["kernel_bytes"],
                "kernel_ops_per_device": dev["kernel_ops"],
                "kernel_launches_per_device": dev["launches"],
                "kernel_work_per_device": dev["kernel_work"],
                "collectives": dev["collectives"],
                "collectives_by_axis": dev["collectives_by_axis"],
                "collective_bytes_per_device": dev["collective_bytes"],
                "gradient_collectives": dev["gradient_collectives"],
                "unruled_ops": dev["unruled_ops"],
                "replicated_retries": dev["replicated_retries"],
                "roofline": roofline(dev["flops_by_dtype"], dev["bytes"],
                                     dev["kernel_ops"], dev["min_bytes"],
                                     collective_s=dev["collective_s"]),
                "step_total": {
                    "flops": m["flops"],
                    "flops_by_dtype": m["flops_by_dtype"],
                    "bytes": m["bytes"], "aten_bytes": m["aten_bytes"],
                    "kernel_bytes": m["kernel_bytes"],
                    "kernel_ops": m["kernel_ops"],
                    "peak_bytes": m["peak_bytes"],
                    "output_bytes": m["output_bytes"],
                    "aten_ops": m["aten_ops"]},
                "kernel_launches": m["launches"],
            })
        result["meta"] = bundle.meta
        if m["stand_ins"]:
            result["rung"] = "max"
            result["stand_ins"] = m["stand_ins"]
        if bundle.meta.get("family") == "lm" and mesh_kind != "multi":
            # As the reference: on one card and on the single-pod mesh.
            result["corrected"] = extrapolate_lm(
                arch_id, shape_name, where, variant,
                arch_override=arch_override)
        if mesh_kind == "card":
            result["roofline"] = roofline(m["flops_by_dtype"], m["bytes"],
                                          m["kernel_ops"], m["min_bytes"])
        if verbose:
            print(f"--- {arch_id} / {shape_name} / {mesh_kind} / {variant}")
            print({k: result.get(k) for k in (
                "memory", "flops_by_dtype", "bytes_per_device",
                "collectives", "step_total", "kernel_launches")
                if k in result})
    except Exception as e:  # noqa: BLE001 -- record the failure
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = (traceback.format_exc()[-4000:]
                               .replace(repo_root + os.sep, ""))
        if verbose:
            print(f"FAILED {arch_id}/{shape_name}/{mesh_kind}: "
                  f"{result['error']}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{arch_id}__{shape_name}__{mesh_kind}__{variant}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def iter_cells(archs=None, shapes=None, meshes=("card",)):
    for mesh_kind in meshes:
        if mesh_kind not in MESHES:
            raise ValueError(f"mesh {mesh_kind!r}: one of {MESHES}")
    for arch_id in (archs or list_archs()):
        cfg = get_config(arch_id)
        for sh in cfg.active_shapes():
            if shapes and sh.name not in shapes:
                continue
            for mesh_kind in meshes:
                yield arch_id, sh.name, mesh_kind


def _cost_rank(cell) -> int:
    """Cells that take longest on meta first: LM train and prefill, and a
    grouped cascade (its queries grouped in a Python loop, ROADMAP D2)."""
    arch_id, shape_name = cell[0], cell[1]
    if "perquery" in cell[-1]:
        return 0
    kind = get_config(arch_id).shape(shape_name).kind
    return {"train": 0, "prefill": 1}.get(kind, 2) \
        if get_config(arch_id).family == "lm" else 3


def run_matrix(cells, out_dir: str = DEFAULT_OUT, variant: str = "baseline",
               workers: int = 1):
    """:func:`run_cell` for each ``(arch, shape, mesh)`` of ``cells`` (or
    ``(arch, shape, mesh, variant)``, which overrides ``variant``), in
    ``workers`` processes (spawned: each imports torch afresh and touches
    no card), longest first -> the artifacts in ``cells``' order."""
    cells = [tuple(c) + (variant,) * (4 - len(c)) for c in cells]
    if workers <= 1:
        return [run_cell(*c, out_dir, verbose=False) for c in cells]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    order = sorted(range(len(cells)), key=lambda i: _cost_rank(cells[i]))
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=sys.path.insert, initargs=(0, src)) as pool:
        futs = {i: pool.submit(run_cell, *cells[i], out_dir, verbose=False)
                for i in order}
        return [futs[i].result() for i in range(len(cells))]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=MESHES + ("both",), default="card",
                    help="one card (the default), the (data=16, model=16) "
                         "mesh 'single', the (pod=2, data=16, model=16) "
                         "mesh 'multi', or 'both' meshes")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: an eager step has no HLO")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes that run cells at once (meta only)")
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo has no counterpart: the port runs eagerly and "
                 "lowers nothing")
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)

    todo, n_skip = [], 0
    for cell in iter_cells(args.arch, args.shape, meshes):
        path = os.path.join(args.out, "__".join(cell + (args.variant,))
                            + ".json")
        if not args.force and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("ok"):
                    n_skip += 1
                    continue
        todo.append(cell)
    n_ok = n_fail = 0
    for (arch_id, shape_name, mesh_kind), res in zip(
            todo, run_matrix(todo, args.out, args.variant, args.workers)):
        n_ok += int(res["ok"])
        n_fail += int(not res["ok"])
        status = "OK" if res["ok"] else "FAIL"
        print(f"[{status}] {arch_id:20s} {shape_name:14s} {mesh_kind:6s} "
              f"compile={res.get('compile_s', '-')}s")
    print(f"done: {n_ok} ok, {n_fail} failed, {n_skip} cached")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
