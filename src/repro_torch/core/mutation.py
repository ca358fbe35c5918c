"""Streaming catalogue mutation over the pruned PQ head.

The port of the reference's ``core/mutation.py``.  The cascade's exactness
needs only tile bounds that *dominate* the live items' scores, so:

* **insert** ORs the new row's presence bits into its tile (bitmask) or
  widens the tile's code range (range): exact, never stale;
* **delete** clears the row's ``live`` flag and leaves the metadata alone:
  the bound stays a superset (looser, still dominating), and the fused
  kernel masks the dead row to ``-inf`` inside its tile's top-k.  A
  per-tile staleness counter records the debt;
* **update** is delete's loosening plus insert's OR-in on the same row.

:meth:`MutableHeadState.retighten` rebuilds the stalest tiles exactly; a
full retighten is bit-identical to
:func:`repro_torch.core.pruning.build_pruned_state_masked` over the current
codes and live mask (:meth:`~MutableHeadState.rebuild_oracle`).

With a super level (``super_factor > 1``) every mutation loosens the
row's super as it loosens its tile (OR in the row, widen the hull), and a
tile that an insert makes tighter (the first live row of an empty range
tile) has its super recomputed from the children.  Retighten recomputes
each touched super once, after its children, so a full retighten equals
the oracle at both levels.

**In place, on one stream.**  JAX arrays never change, so the reference's
mutations return new arrays and its ``clone()`` shares them.  PyTorch
tensors are mutable: here every mutation writes the manager's tensors in
place (a row of codes, one live flag, one tile's metadata), queued on the
current CUDA stream behind the kernels of the batch served before it, so
one stream keeps the order without a host wait.  The serving engine reads
the same tensors (:meth:`~MutableHeadState.head_arrays`); a swap swaps
references, never bytes.  :meth:`~MutableHeadState.clone` therefore copies
every tensor: two managers never share one.

``uint16`` codes (b=512) have few PyTorch operations, so rows are written
through the codes' ``int16`` view, as :mod:`repro_torch.core.pq` reads
them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import pq as pq_lib
from repro_torch.core.pruning import (ARRAY_FIELDS, BOUND_BACKENDS,
                                      DEFAULT_PRUNE_TILE, PrunedHeadState,
                                      _build_code_ranges_masked,
                                      _build_present_masked, _or_reduce_axis,
                                      build_pruned_state_masked,
                                      pack_presence, with_super)

_NUMPY_CODE_TYPES = {torch.int8: np.int8, torch.uint8: np.uint8,
                     torch.int16: np.int16, torch.uint16: np.uint16,
                     torch.int32: np.int32}


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


class CapacityError(RuntimeError):
    """Raised by insert when every capacity slot is live (the caller must
    rebuild at a larger capacity: a shape change, hence a new engine)."""


def _storage(codes: torch.Tensor) -> torch.Tensor:
    """The codes as a tensor that takes row writes (``uint16`` through its
    ``int16`` view)."""
    return codes.view(torch.int16) if codes.dtype == torch.uint16 else codes


def _clone_state(st: PrunedHeadState) -> PrunedHeadState:
    return dataclasses.replace(st, **{f: getattr(st, f).clone()
                                      for f in ARRAY_FIELDS
                                      if getattr(st, f) is not None})


class MutableHeadState:
    """Manager of a mutable PQ catalogue and its pruning metadata.

    Holds capacity-padded tensors with fixed shapes — ``codes`` (cap, m),
    ``live`` (cap,) bool, a flat :class:`PrunedHeadState` over the padded
    catalogue — plus host bookkeeping: a FIFO freelist of tombstoned slots
    (insert reuses them, so capacity bounds *live* items, not mutations)
    and a per-tile staleness counter for lazy re-tightening.  Row 0 is the
    id-0 padding row and stays live."""

    def __init__(self, codes: torch.Tensor, live: torch.Tensor,
                 state: PrunedHeadState, staleness: np.ndarray, free: list,
                 n_rows: int):
        self.codes = codes
        self.live = live
        self.state = state
        self.staleness = staleness
        self.free = free
        self.n_rows = n_rows          # high-water mark of ever-used slots
        self.n_mutations = 0

    # -- construction -----------------------------------------------------

    @classmethod
    def build(cls, codes: torch.Tensor, b: int,
              tile: int = DEFAULT_PRUNE_TILE, *, backend: str = "bitmask",
              capacity: Optional[int] = None, super_factor: int = 0,
              device=None) -> "MutableHeadState":
        """Pad ``codes`` (n, m) to a power-of-two capacity (at least one
        tile, a tile multiple, so every tile is full), mark rows [0, n)
        live and build exact live-masked tile metadata, on ``device``
        (default: the codes' device).  ``capacity`` gives extra insert
        headroom; a later capacity change is a shape change.
        ``super_factor > 1`` adds the super level, and the capacity is
        then a ``tile * super_factor`` multiple, so every super has
        ``super_factor`` children."""
        if backend not in BOUND_BACKENDS:
            raise ValueError(f"unknown bound backend {backend!r}")
        dev = codes.device if device is None else resolve_device(device)
        n, m = codes.shape
        tile = max(1, min(int(tile), n))
        super_factor = 0 if super_factor <= 1 else int(super_factor)
        grain = tile * super_factor if super_factor else tile
        cap = next_pow2(max(n, 1)) if capacity is None else int(capacity)
        cap = max(cap, tile, n)
        cap = -(-cap // grain) * grain
        codes_cap = torch.zeros((cap, m), dtype=codes.dtype, device=dev)
        _storage(codes_cap)[:n] = _storage(codes).to(dev)
        live = torch.zeros((cap,), dtype=torch.bool, device=dev)
        live[:n] = True
        state = with_super(build_pruned_state_masked(
            codes_cap, live, b, tile, backend=backend), super_factor)
        return cls(codes_cap, live, state,
                   staleness=np.zeros(state.n_tiles, np.int64), free=[],
                   n_rows=n)

    # -- properties -------------------------------------------------------

    @property
    def cap(self) -> int:
        return self.codes.shape[0]

    @property
    def m(self) -> int:
        return self.codes.shape[1]

    @property
    def tile(self) -> int:
        return self.state.tile

    @property
    def b(self) -> int:
        return self.state.b

    @property
    def backend(self) -> str:
        return self.state.backend

    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    @property
    def super_factor(self) -> int:
        return self.state.super_factor

    # -- mutations --------------------------------------------------------

    def _check_row(self, row) -> torch.Tensor:
        """``row`` (m,) in the codes' dtype, as its storage view, on the
        codes' device (values cast as the reference's ``jnp.asarray(row,
        codes.dtype)`` casts them)."""
        if isinstance(row, torch.Tensor):
            row = row.cpu().numpy()
        arr = np.asarray(row).astype(_NUMPY_CODE_TYPES[self.codes.dtype])
        if arr.shape != (self.m,):
            raise ValueError(f"item row shape {arr.shape} != ({self.m},)")
        if arr.dtype == np.uint16:
            arr = arr.view(np.int16)
        return torch.from_numpy(arr).to(self.codes.device)

    def _set_row(self, slot: int, row: torch.Tensor) -> None:
        _storage(self.codes)[slot] = row
        self.live[slot] = True

    def _absorb(self, slot: int, row: torch.Tensor) -> None:
        """OR/widen tile metadata so it covers ``row`` at ``slot``: the
        exact-on-insert half of every mutation, at both levels."""
        t = slot // self.tile
        st = self.state
        g = t // st.super_factor if st.has_super else None
        sub = pq_lib.widen(row.view(self.codes.dtype))                # (m,)
        if self.backend == "range":
            c = sub.to(torch.int16)
            t0 = t * self.tile
            if int(self.live[t0:t0 + self.tile].sum()) == 1:
                # The tile's only live row: SET its range.  The masked build
                # clamps an empty tile to [0, 0], and widening could never
                # lift that phantom lo=0 (the tile would stay looser than
                # the rebuild oracle).  Exact now, so its debt is gone; the
                # child got tighter, which widening cannot express, so its
                # super is recomputed from the children.
                st.code_lo[t] = c
                st.code_hi[t] = c
                self.staleness[t] = 0
                if g is not None:
                    self._recompute_super(g)
            else:
                st.code_lo[t] = torch.minimum(st.code_lo[t], c)
                st.code_hi[t] = torch.maximum(st.code_hi[t], c)
                if g is not None:
                    st.super_lo[g] = torch.minimum(st.super_lo[g], c)
                    st.super_hi[g] = torch.maximum(st.super_hi[g], c)
        else:
            present = torch.zeros((1, self.m, self.b), dtype=torch.bool,
                                  device=self.codes.device)
            present[0, torch.arange(self.m, device=sub.device), sub] = True
            word = pack_presence(present)[0]
            st.packed[t] |= word
            if g is not None:
                st.super_packed[g] |= word

    def _recompute_super(self, g: int) -> None:
        """Super ``g``'s metadata from its children as they are now (OR of
        the words, hull of the ranges): dominating whether or not the
        children are stale, exact once they are."""
        st = self.state
        kids = slice(g * st.super_factor, (g + 1) * st.super_factor)
        if st.backend == "range":
            st.super_lo[g] = st.code_lo[kids].amin(dim=0)
            st.super_hi[g] = st.code_hi[kids].amax(dim=0)
        else:
            st.super_packed[g] = _or_reduce_axis(st.packed[kids], 0)

    def insert(self, row) -> int:
        """Add an item; returns its slot (= item id).  Reuses the oldest
        tombstoned slot when one exists.  Exact: the new row's bits enter
        the tile metadata at once; a reused slot's tile keeps its
        staleness (the dead predecessor's bits are still there)."""
        row = self._check_row(row)
        if self.free:
            slot = self.free.pop(0)
        elif self.n_rows < self.cap:
            slot = self.n_rows
            self.n_rows += 1
        else:
            raise CapacityError(
                f"catalogue capacity {self.cap} exhausted ({self.n_live} "
                f"live); rebuild with MutableHeadState.build(capacity="
                f"{self.cap * 2}) and a new engine at the new shape")
        self._set_row(slot, row)
        self._absorb(slot, row)
        self.n_mutations += 1
        return slot

    def delete(self, item_id: int) -> None:
        """Tombstone an item: live flag off, metadata untouched (bounds go
        stale but still dominate), slot queued for reuse."""
        item_id = int(item_id)
        if not (0 < item_id < self.cap):
            raise ValueError(f"item id {item_id} out of range (0, {self.cap})"
                             " — row 0 is the reserved padding id")
        if not bool(self.live[item_id]):
            raise ValueError(f"item {item_id} is not live")
        self.live[item_id] = False
        self.free.append(item_id)
        self.staleness[item_id // self.tile] += 1
        self.n_mutations += 1

    def update(self, item_id: int, row) -> None:
        """Re-code a live item in place: the new codes are absorbed
        (exact), the old codes' bits linger (stale)."""
        item_id = int(item_id)
        if not (0 <= item_id < self.cap) or not bool(self.live[item_id]):
            raise ValueError(f"item {item_id} is not live")
        row = self._check_row(row)
        self._set_row(item_id, row)
        self._absorb(item_id, row)
        self.staleness[item_id // self.tile] += 1
        self.n_mutations += 1

    # -- durability hooks (serving/catalogue_log.py) ----------------------

    def clone(self) -> "MutableHeadState":
        """An independent manager over a copy of the current state: every
        tensor is copied (mutations write in place), and so is the host
        bookkeeping (the FIFO freelist's order decides which slot the next
        insert reuses)."""
        c = MutableHeadState(self.codes.clone(), self.live.clone(),
                             _clone_state(self.state), self.staleness.copy(),
                             list(self.free), self.n_rows)
        c.n_mutations = self.n_mutations
        return c

    @classmethod
    def from_snapshot(cls, codes, live, free, n_rows: int, b: int,
                      tile: int, *, backend: str = "bitmask",
                      super_factor: int = 0,
                      device="cuda") -> "MutableHeadState":
        """A manager from durably stored arrays: capacity-padded ``codes``
        and ``live`` (numpy or tensors), the freelist IN ORDER and the slot
        high-water mark.  The metadata is rebuilt exactly from codes + live,
        so the restored state is :meth:`rebuild_oracle` of the snapshot and
        staleness restarts at zero; ``super_factor > 1`` re-attaches the
        super level."""
        dev = resolve_device(device)
        codes = torch.as_tensor(codes).to(dev)
        live = torch.as_tensor(live).to(device=dev, dtype=torch.bool)
        state = with_super(build_pruned_state_masked(
            codes, live, b, tile, backend=backend), super_factor)
        return cls(codes, live, state,
                   staleness=np.zeros(state.n_tiles, np.int64),
                   free=[int(s) for s in free], n_rows=int(n_rows))

    # -- maintenance ------------------------------------------------------

    def retighten(self, tile_ids=None,
                  max_tiles: Optional[int] = None) -> List[int]:
        """Exactly rebuild the stalest tiles' metadata (off the serve path).
        Default: every tile with staleness > 0, stalest first;
        ``max_tiles`` bounds the work per call.  Returns the tile ids
        re-tightened.  Each touched super is recomputed once, after its
        children.  After all stale tiles the state is bit-identical to
        :meth:`rebuild_oracle`."""
        if tile_ids is None:
            order = np.argsort(-self.staleness, kind="stable")
            tile_ids = [int(t) for t in order if self.staleness[t] > 0]
        else:
            tile_ids = [int(t) for t in tile_ids]
        if max_tiles is not None:
            tile_ids = tile_ids[:int(max_tiles)]
        st, tile = self.state, self.tile
        for t in tile_ids:
            rows = self.codes[t * tile:(t + 1) * tile]
            lv = self.live[t * tile:(t + 1) * tile]
            if st.backend == "range":
                lo, hi = _build_code_ranges_masked(rows, lv, tile)
                st.code_lo[t], st.code_hi[t] = lo[0], hi[0]
            else:
                st.packed[t] = pack_presence(
                    _build_present_masked(rows, lv, st.b, tile))[0]
            self.staleness[t] = 0
        if st.has_super:
            for g in sorted({t // st.super_factor for t in tile_ids}):
                self._recompute_super(g)
        return tile_ids

    def rebuild_oracle(self) -> PrunedHeadState:
        """From-scratch exact state over the current codes and live mask,
        with the same super level: the bit-parity reference for retighten
        and the churn tests."""
        return with_super(build_pruned_state_masked(
            self.codes, self.live, self.b, self.tile, backend=self.backend),
            self.super_factor)

    # -- serving snapshot -------------------------------------------------

    def head_arrays(self) -> Dict[str, object]:
        """The serving head: merge into ``params["item_emb"]`` or hand to
        ``engine.swap_head_state``.  Shapes, dtypes and devices never change
        under mutation, so a swap never adds a serve variant."""
        return {"codes": self.codes, "pruned": self.state,
                "live": self.live}

    def stats(self) -> Dict[str, float]:
        return {"capacity": float(self.cap), "n_live": float(self.n_live),
                "n_free": float(len(self.free)),
                "n_mutations": float(self.n_mutations),
                "stale_tiles": float(int((self.staleness > 0).sum())),
                "max_staleness": float(int(self.staleness.max()))}


def apply_op(state: MutableHeadState, op) -> Optional[int]:
    """Apply one logged mutation op: ``("insert", row)``, ``("delete",
    item_id)`` or ``("update", item_id, row)``.  Validation happens before
    any write, so a rejected op leaves the state untouched; replaying a
    logged stream in LSN order is deterministic (the FIFO freelist decides
    slot reuse)."""
    kind = op[0]
    if kind == "insert":
        return state.insert(op[1])
    if kind == "delete":
        state.delete(op[1])
        return None
    if kind == "update":
        state.update(op[1], op[2])
        return None
    raise ValueError(f"unknown catalogue op kind {kind!r}")
