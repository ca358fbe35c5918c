"""Parameter interop with the reference package, through numpy.

``params_from_jax`` takes a reference parameter tree — ``init_seqrec``'s,
``init_recsys``'s for any of the four recsys kinds, ``init_lm``'s (its
stacked (L, ...) layer leaves, bfloat16 leaves, an MoE layer's float32
router beside its bfloat16 (L, E, ...) experts, and the PQ head with its
pruning state) or ``init_gnn``'s (a list of layers) — with its leaves
as numpy arrays (or anything ``np.asarray`` accepts) and returns the same
tree of torch tensors: dicts stay dicts, lists (the recsys tables, cross
layers, MLP towers, FM linear weights) stay lists, and a 0-d leaf (FM's
bias) stays 0-d.  The layouts already agree: dense weights stay
``(d_in, d_out)``, codes keep their storage dtype (``uint16`` at b=512).  The pruned-cascade metadata ``item_emb.pruned`` (the reference's
``PrunedHeadState``, a dataclass) becomes the port's
:class:`~repro_torch.core.pruning.PrunedHeadState`, field for field; its
``uint32`` presence words are carried as ``int32`` with the same bits, and
a super level's arrays and a shard-aligned layout cross over with the
rest.
``mutable_state_from_jax`` carries a reference ``MutableHeadState`` over
whole (codes, live mask, pruning metadata and host bookkeeping), so both
packages can start from one mutable catalogue.  ``opt_state_from_jax``
carries an optimizer state over (AdamW's ``{"step", "m", "v"}``,
Adafactor's ``{"step", "v"}`` with its per-leaf dicts), so both packages
can run the same steps from the same state; ``bfloat16`` moments keep
their bits.  ``params_from_jax`` also carries ``init_caches``' KV caches
over (the stacked pair or the per-layer list), so both packages can
decode from one cache state.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.mutation import MutableHeadState
from repro_torch.core.pruning import ARRAY_FIELDS, PrunedHeadState


def _array(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def pruned_state_from_jax(state: Any, device="cpu") -> PrunedHeadState:
    """The reference's ``PrunedHeadState`` (numpy leaves) -> the port's,
    super-tile arrays and a shard-aligned layout (``shards > 1``)
    included."""
    fields = {f.name: getattr(state, f.name)
              for f in dataclasses.fields(state)}
    for name in ARRAY_FIELDS:
        if fields[name] is not None:
            fields[name] = _array(fields[name], device)
    return PrunedHeadState(**fields)


def mutable_state_from_jax(mstate: Any, device="cpu") -> MutableHeadState:
    """The reference's ``MutableHeadState`` -> the port's, on ``device``:
    codes, live mask, the pruning state, staleness, the freelist in
    order, the slot high-water mark and the mutation count."""
    out = MutableHeadState(
        _array(mstate.codes, device),
        _array(mstate.live, device),
        pruned_state_from_jax(mstate.state, device),
        staleness=np.array(mstate.staleness, np.int64),
        free=[int(x) for x in mstate.free], n_rows=int(mstate.n_rows))
    out.n_mutations = int(mstate.n_mutations)
    return out


def _convert(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    if dataclasses.is_dataclass(tree):
        return pruned_state_from_jax(tree, device)
    return _array(tree, device)


def params_from_jax(tree: Any, device="cpu") -> Any:
    """A reference parameter tree (seqrec, recsys, LM or GNN, stacked
    layers included) or LM cache state (a stacked ``{"k", "v"}`` pair or a list
    of per-layer pairs) -> the port's, on ``device``, dtypes kept."""
    return _convert(tree, device)


def opt_state_from_jax(state: Any, device="cpu") -> Any:
    """A reference optimizer state -> the port's, on ``device``: the
    step counter as an int32 0-d tensor and the moments in
    ``params_from_jax``'s tree (the pruning metadata's moments included)."""
    return _convert(state, device)


def to_device(tree: Any, device) -> Any:
    """A parameter tree with every tensor (and pruned state) moved to
    ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device)
