"""Durable catalogue state: a checksummed mutation write-ahead log (WAL)
and LSN-keyed snapshots.

The port of the reference's ``serving/catalogue_log.py``, byte for byte
on disk, so a log and snapshots written by either package recover in the
other.

* **Write-ahead log** — every ``("insert", row)`` / ``("delete", id)`` /
  ``("update", id, row)`` op is appended to ``wal.log`` as one checksummed
  record carrying a log sequence number (LSN, from 1)::

      header  = <IIQ  magic, payload_len, lsn     (16 bytes)
      payload = op tag (1 byte) + operands        (rows as int16 LE)
      footer  = <I    crc32(header + payload)     (4 bytes)

  Appends are fsync-batched: the file is flushed every ``fsync_every``
  records or on :meth:`CatalogueLog.sync`.

* **Torn-tail recovery** — opening the log for writing scans it and
  truncates at the last valid record (a torn, checksum-broken or
  LSN-discontinuous record ends the log).  Read-only scans stop at the
  same boundary without truncating.

* **Snapshots** — :meth:`CatalogueLog.snapshot` stores the catalogue
  (codes, tombstone mask, freelist in order, slot high-water mark) through
  :class:`~repro_torch.training.checkpoint.CheckpointManager`, keyed by
  the LSN.  Pruning metadata is not stored: recovery rebuilds it exactly
  from codes and live.

* **Recovery** = the newest valid snapshot + replay of the log tail in LSN
  order through the mutation API, which is deterministic (FIFO freelist),
  so the recovered catalogue is bit-identical to the writer's at that LSN.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import BinaryIO, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.mutation import MutableHeadState, apply_op
from repro_torch.core.pruning import ARRAY_FIELDS
from repro_torch.training.checkpoint import (CheckpointManager,
                                             CorruptCheckpointError)
from repro_torch.training.fault_tolerance import SimulatedFailure

_MAGIC = 0x4C414357                      # "WCAL"
_HEADER = struct.Struct("<IIQ")          # magic, payload_len, lsn
_CRC = struct.Struct("<I")
_IID = struct.Struct("<q")

# One op is a tag plus at most one item id and one code row; a bigger
# payload length in a header means the scan ran into garbage.
_MAX_PAYLOAD = 1 << 20


def encode_op(op) -> bytes:
    """Serialise one mutation op.  Code rows are stored as int16 LE, wide
    enough for any sub-id vocabulary (b <= 32768) and independent of the
    in-memory code dtype, which the catalogue meta records."""
    kind = op[0]
    if kind == "insert":
        return b"I" + np.asarray(op[1], np.int16).tobytes()
    if kind == "delete":
        return b"D" + _IID.pack(int(op[1]))
    if kind == "update":
        return (b"U" + _IID.pack(int(op[1]))
                + np.asarray(op[2], np.int16).tobytes())
    raise ValueError(f"unknown catalogue op kind {kind!r}")


def decode_op(payload: bytes):
    tag = payload[:1]
    if tag == b"I":
        return ("insert", np.frombuffer(payload[1:], np.int16))
    if tag == b"D":
        return ("delete", _IID.unpack(payload[1:9])[0])
    if tag == b"U":
        return ("update", _IID.unpack(payload[1:9])[0],
                np.frombuffer(payload[9:], np.int16))
    raise ValueError(f"unknown op tag {tag!r}")


def _records(f: BinaryIO) -> Iterator[Tuple[int, int, bytes]]:
    """Yield ``(lsn, end offset, payload)`` for each valid record of an open
    log, stopping (never raising) at the first torn, checksum-broken or
    LSN-discontinuous one: past a crash point nothing was acknowledged."""
    prev_lsn = 0
    while True:
        header = f.read(_HEADER.size)
        if len(header) < _HEADER.size:
            return                                 # clean EOF or torn header
        magic, plen, lsn = _HEADER.unpack(header)
        if magic != _MAGIC or plen > _MAX_PAYLOAD:
            return                                 # garbage header
        body = f.read(plen + _CRC.size)
        if len(body) < plen + _CRC.size:
            return                                 # torn payload or crc
        payload, crc = body[:plen], _CRC.unpack(body[plen:])[0]
        if zlib.crc32(header + payload) != crc:
            return                                 # corrupt record
        if lsn != prev_lsn + 1 and prev_lsn != 0:
            return                                 # sequence gap
        prev_lsn = lsn
        yield lsn, f.tell(), payload


def _scan(path: str) -> Tuple[List[Tuple[int, int]], int]:
    """The log's valid records ``[(lsn, end offset)]`` and the byte offset
    just past the last one."""
    if not os.path.exists(path):
        return [], 0
    with open(path, "rb") as f:
        records = [(lsn, end) for lsn, end, _ in _records(f)]
    return records, records[-1][1] if records else 0


class CatalogueLog:
    """Append-only checksummed WAL + versioned snapshots for one mutable
    catalogue.  One writer per log directory; any number of read-only
    scans (:meth:`read_ops`, :meth:`recover`), which stop at the last
    complete record like a post-crash scan."""

    def __init__(self, log_dir: str, *, fsync_every: int = 32,
                 snapshot_every: int = 0, keep_snapshots: int = 3,
                 read_only: bool = False):
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, "wal.log")
        self.snap_dir = os.path.join(log_dir, "snapshots")
        self.fsync_every = max(1, int(fsync_every))
        self.snapshot_every = int(snapshot_every)
        self.keep_snapshots = int(keep_snapshots)
        self.read_only = read_only
        os.makedirs(log_dir, exist_ok=True)

        records, valid_end = _scan(self.path)
        size = os.path.getsize(self.path) if os.path.exists(self.path) else 0
        self.torn_bytes_dropped = size - valid_end
        self.lsn = records[-1][0] if records else 0
        if not read_only and size > valid_end:
            # Torn tail from a writer crash: cut it so the next append
            # extends a clean log.
            with open(self.path, "r+b") as f:
                f.truncate(valid_end)
        self._fh = None
        # Held by append, sync and close: the replicated fabric syncs from
        # a replica's worker thread while the caller appends, and an append
        # landing between sync's flush and its reset of ``_unsynced`` would
        # otherwise be forgotten (a later sync would skip its flush).
        self._lock = threading.RLock()
        self._unsynced = 0
        self.n_fsyncs = 0
        self.n_appends = 0
        self._crashed = False
        # Chaos hook: appending THIS lsn writes half a record, fsyncs it
        # and raises SimulatedFailure (the writer dies mid-append).
        self.fail_at_lsn: Optional[int] = None

    # -- append side ------------------------------------------------------

    def _handle(self):
        if self._fh is None:
            self._fh = open(self.path, "ab")
        return self._fh

    def append(self, op) -> int:
        """Append one op; returns its LSN.  Durability lags by up to
        ``fsync_every`` records (:meth:`sync` forces it)."""
        if self.read_only:
            raise ValueError("log opened read_only; no appends")
        if self._crashed:
            raise RuntimeError("log writer crashed mid-append; reopen the "
                               "log (torn-tail truncation) to continue")
        with self._lock:
            lsn = self.lsn + 1
            payload = encode_op(op)
            header = _HEADER.pack(_MAGIC, len(payload), lsn)
            record = header + payload + _CRC.pack(
                zlib.crc32(header + payload))
            fh = self._handle()
            if self.fail_at_lsn is not None and lsn == self.fail_at_lsn:
                fh.write(record[:max(1, len(record) // 2)])
                fh.flush()
                os.fsync(fh.fileno())
                self._crashed = True
                raise SimulatedFailure(
                    f"catalogue log writer crashed mid-append at lsn {lsn} "
                    "(torn record on disk)")
            fh.write(record)
            self.lsn = lsn
            self.n_appends += 1
            self._unsynced += 1
            if self._unsynced >= self.fsync_every:
                self.sync()
            return lsn

    def append_many(self, ops) -> List[int]:
        return [self.append(op) for op in ops]

    def sync(self):
        with self._lock:
            if self._fh is not None and self._unsynced:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self.n_fsyncs += 1
                self._unsynced = 0

    def close(self):
        with self._lock:
            if self._fh is not None:
                if not self._crashed:
                    self.sync()
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- snapshots --------------------------------------------------------

    def _meta_path(self) -> str:
        return os.path.join(self.log_dir, "meta.json")

    def _write_meta(self, mstate: MutableHeadState):
        meta = {"version": 1, "capacity": mstate.cap, "m": mstate.m,
                "b": mstate.b, "tile": mstate.tile,
                "backend": mstate.backend,
                "super_factor": mstate.super_factor,
                "code_dtype": str(mstate.codes[:0].cpu().numpy().dtype)}
        existing = self.meta()
        if existing is not None:
            static = {k: existing.get(k) for k in meta}
            if static != meta:
                raise ValueError(
                    f"catalogue shape changed under the log: {static} -> "
                    f"{meta}; a capacity or layout change needs a fresh log "
                    "directory")
            return
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path())

    def meta(self) -> Optional[dict]:
        try:
            with open(self._meta_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _snap_mgr(self) -> CheckpointManager:
        return CheckpointManager(self.snap_dir, keep=self.keep_snapshots,
                                 async_save=False)

    def snapshot(self, mstate: MutableHeadState) -> int:
        """Persist the catalogue keyed by the current LSN.  The freelist is
        stored IN ORDER (padded with -1 to capacity, a fixed shape): FIFO
        reuse order is part of replay determinism."""
        if self.read_only:
            raise ValueError("log opened read_only; no snapshots")
        self._write_meta(mstate)
        self.sync()           # the log is never behind its snapshot
        free = np.full(mstate.cap, -1, np.int32)
        if mstate.free:
            free[:len(mstate.free)] = mstate.free
        flat = {"codes": mstate.codes.cpu().numpy(),
                "live": mstate.live.cpu().numpy(),
                "free": free,
                "scalars": np.asarray([mstate.n_rows, self.lsn], np.int32)}
        self._snap_mgr().save(self.lsn, {"catalogue": flat})
        return self.lsn

    def maybe_snapshot(self, mstate: MutableHeadState) -> Optional[int]:
        """Snapshot once ``snapshot_every`` ops have accumulated since the
        newest snapshot (0 disables)."""
        if self.snapshot_every <= 0:
            return None
        last = self.latest_snapshot_lsn()
        if last is not None and self.lsn - last < self.snapshot_every:
            return None
        return self.snapshot(mstate)

    def latest_snapshot_lsn(self) -> Optional[int]:
        steps = self._snap_mgr().valid_steps()
        return steps[-1] if steps else None

    # -- read / recover side ----------------------------------------------

    def read_ops(self, after: int = 0,
                 upto: Optional[int] = None) -> Iterator[Tuple[int, object]]:
        """Yield ``(lsn, op)`` for every valid record with ``after < lsn
        <= upto``.  A pure read: stops at a torn tail, never truncates,
        safe while the writer appends."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            for lsn, _, payload in _records(f):
                if upto is not None and lsn > upto:
                    return
                if lsn > after:
                    yield lsn, decode_op(payload)

    def recover(self, *, upto: Optional[int] = None, verify: bool = False,
                device="cuda") -> Tuple[MutableHeadState, int]:
        """Newest valid snapshot (at or before ``upto``) + tail replay, on
        ``device`` -> ``(state, lsn)``.

        Crash damage does not raise: a torn log tail is ignored and a
        corrupt snapshot falls back to the previous valid one.  A log
        directory that never held a snapshot raises
        :class:`CorruptCheckpointError`.  ``verify=True`` retightens the
        replayed state and checks every metadata tensor equals
        ``rebuild_oracle()``'s, bit for bit."""
        dev = resolve_device(device)
        meta = self.meta()
        if meta is None:
            raise CorruptCheckpointError(
                f"no catalogue meta under {self.log_dir!r}; the log was "
                "never attached to a catalogue (snapshot() writes it)")
        cap, m = meta["capacity"], meta["m"]
        templates = {"catalogue": {
            "codes": np.zeros((cap, m), np.dtype(meta["code_dtype"])),
            "live": np.zeros((cap,), np.bool_),
            "free": np.zeros((cap,), np.int32),
            "scalars": np.zeros((2,), np.int32)}}
        mgr = self._snap_mgr()
        if upto is None:
            snap_lsn, out = mgr.restore_latest(templates)
        else:
            # Point-in-time recovery: the base snapshot must not be past
            # the fence, or replay cannot wind back to it.
            snap_lsn, out = None, None
            for s in reversed([s for s in mgr.all_steps() if s <= upto]):
                if not mgr.validate_step(s):
                    continue
                try:
                    out = mgr.restore(s, templates)
                    snap_lsn = s
                    break
                except CorruptCheckpointError:
                    continue
            if snap_lsn is None:
                raise CorruptCheckpointError(
                    f"no valid snapshot at or before lsn {upto} under "
                    f"{self.snap_dir!r}")
        cat = out["catalogue"]
        n_rows, stored_lsn = (int(x) for x in cat["scalars"])
        if stored_lsn != snap_lsn:
            raise CorruptCheckpointError(
                f"snapshot step {snap_lsn} carries lsn {stored_lsn}")
        mstate = MutableHeadState.from_snapshot(
            cat["codes"], cat["live"], [int(s) for s in cat["free"] if s >= 0],
            n_rows, meta["b"], meta["tile"], backend=meta["backend"],
            super_factor=meta["super_factor"], device=dev)
        applied = snap_lsn
        for lsn, op in self.read_ops(after=snap_lsn, upto=upto):
            apply_op(mstate, op)
            applied = lsn
        if verify:
            mstate.retighten()
            want = mstate.rebuild_oracle()
            for f in ARRAY_FIELDS:
                g, w = getattr(mstate.state, f), getattr(want, f)
                if (g is None) != (w is None) or (
                        g is not None and not torch.equal(g, w)):
                    raise AssertionError(
                        f"recovered pruned.{f} differs from the rebuild "
                        "oracle")
        return mstate, applied

    # -- observability ----------------------------------------------------

    def stats(self) -> Dict[str, float]:
        size = os.path.getsize(self.path) if os.path.exists(self.path) else 0
        snaps = self._snap_mgr().valid_steps()
        return {"lsn": float(self.lsn),
                "log_bytes": float(size),
                "n_appends": float(self.n_appends),
                "n_fsyncs": float(self.n_fsyncs),
                "torn_bytes_dropped": float(self.torn_bytes_dropped),
                "n_snapshots": float(len(snaps)),
                "latest_snapshot_lsn": float(snaps[-1]) if snaps else -1.0}
