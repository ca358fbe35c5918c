"""Item sharding on a shard mesh: the collectives of the sharded routes,
per-shard row blocks, and the parameter sharding rules.

The reference's sharded routes run one ``shard_map`` whose bodies call
``lax.all_gather``, ``pmax`` and ``psum``.  Here a body runs per shard on
that shard's device (:func:`on_device`), and each collective is a plain
function over the per-shard list that merges on the mesh's lead device,
in shard order: :func:`all_gather` concatenates, :func:`pmax` and
:func:`psum` stack and reduce, :func:`replicate` sends a lead tensor back
to every shard's device.

:func:`shard_rows` gives each shard its own contiguous block of a
row-sharded tensor (the catalogue's codes, its ``live`` mask, a pruned
state's tile metadata), padded with zero rows to ``S * n_local`` as the
reference's ``jnp.pad`` does.

The rules (:func:`seqrec_param_rules`, :func:`recsys_param_rules`) and
:func:`param_shardings` are the reference's serve-path ones: a parameter
tree maps to a tree of :class:`P` specs, an axis that does not divide its
dimension dropped.  A spec names where a leaf would lie; placing a whole
model by its specs is not ported (the sharded routes place what they
shard).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
import weakref
from typing import Any, List, Sequence

import torch

from repro_torch.kernels import cost

AXIS = "model"


class P(tuple):
    """A partition spec: per dimension, a mesh axis name (or a tuple of
    names) or ``None`` (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# devices and collectives
# ---------------------------------------------------------------------------


def on_device(dev: torch.device):
    """Context in which a shard's body runs: the device's CUDA context (its
    allocations and its current stream), or nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device
    return (cur() if a.index is None else a.index) == \
        (cur() if b.index is None else b.index)


def replicate(x: torch.Tensor, mesh) -> List[torch.Tensor]:
    """``x`` on every shard's device (no copy where it already lies)."""
    return [x if same_device(x.device, d) else x.to(d) for d in mesh.devices]


def _gathered(parts: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    return [p if same_device(p.device, mesh.lead) else p.to(mesh.lead)
            for p in parts]


def all_gather(parts: Sequence[torch.Tensor], mesh,
               dim: int = 1) -> torch.Tensor:
    """The shards' tensors on the lead device, concatenated along ``dim``
    in shard order (``lax.all_gather(..., tiled=True)``)."""
    return torch.cat(_gathered(parts, mesh), dim=dim)


def pmax(parts: Sequence[torch.Tensor], mesh) -> torch.Tensor:
    """Elementwise max over the shards, on the lead device."""
    return torch.stack(_gathered(parts, mesh)).amax(dim=0)


def psum(parts: Sequence[torch.Tensor], mesh) -> torch.Tensor:
    """Elementwise sum over the shards, on the lead device."""
    return torch.stack(_gathered(parts, mesh)).sum(dim=0)


def host_values(parts: Sequence[torch.Tensor], mesh, what: str,
                largest: int) -> list:
    """Every shard's tensor read to the host in ONE read: stacked on the
    lead device, then one ``tolist`` -> a list per shard.  The read is
    ``kernels.cost.host_read``'s, named ``what``; on meta every value is
    ``largest`` (the most the shapes allow)."""
    def stand_in():
        return [largest if p.dim() == 0 else [largest] * p.shape[0]
                for p in parts]
    return cost.host_read(
        what, lambda: torch.stack(_gathered(parts, mesh)).tolist(),
        stand_in, of=parts)


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


def _copied_blocks(x: torch.Tensor, mesh, n_local: int, need):
    key = (id(x), mesh.devices)
    ver = _version(x)
    with _BLOCKS_LOCK:
        hit = _BLOCKS.get(key)
        if hit is not None and ver is not None and hit[0] == ver:
            return hit[1]
        blocks = {}
        for i in need:
            dev = mesh.devices[i]
            block = x[i * n_local:min((i + 1) * n_local, x.shape[0])]
            short = n_local - block.shape[0]
            if short:
                block = torch.cat([block, block.new_zeros(
                    (short,) + tuple(x.shape[1:]))])
            blocks[i] = block.to(dev).contiguous()
        # Another thread's stream may read these next: let the copies land.
        for dev in {mesh.devices[i] for i in need}:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        if ver is not None:
            if hit is None:
                weakref.finalize(x, _BLOCKS.pop, key, None)
            _BLOCKS[key] = (ver, blocks)
        return blocks


def shard_rows(x: torch.Tensor, mesh) -> List[torch.Tensor]:
    """``x`` (N, ...) as S contiguous (n_local, ...) blocks, n_local =
    ceil(N / S), block i on shard i's device; rows past N are zeros.  A
    full block already on its device is a view (no copy); the others are
    copied once per version of ``x``."""
    s = mesh.shape[AXIS]
    n = x.shape[0]
    n_local = -(-n // s)
    out, need = [None] * s, []
    for i, dev in enumerate(mesh.devices):
        lo, hi = i * n_local, (i + 1) * n_local
        if hi <= n and x.is_contiguous() and same_device(x.device, dev):
            out[i] = x[lo:hi]
        else:
            need.append(i)
    if need:
        blocks = _copied_blocks(x, mesh, n_local, need)
        for i in need:
            out[i] = blocks[i]
    return out


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


def _axis_size(mesh, ax) -> int:
    size = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        size *= mesh.shape[a]
    return size


def param_shardings(mesh, params: Any, rules) -> Any:
    """A parameter tree (dicts, lists, pruned states) -> the same tree of
    :class:`P` specs.  An axis that does not divide its dimension is
    dropped (that dimension replicated), as in the reference."""

    def leaf(path, x):
        spec = _match(rules, path_str(path), x.dim())
        return P(*(None if ax is None or x.shape[d] % _axis_size(mesh, ax)
                   else ax for d, ax in enumerate(spec)))

    def walk(path, tree):
        if isinstance(tree, dict):
            return {k: walk(path + [k], v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(path + [i], v) for i, v in enumerate(tree)]
        if dataclasses.is_dataclass(tree):
            return dataclasses.replace(tree, **{
                f.name: walk(path + [f.name], getattr(tree, f.name))
                for f in dataclasses.fields(tree)
                if isinstance(getattr(tree, f.name), torch.Tensor)})
        return leaf(path, tree)

    return walk([], params)
