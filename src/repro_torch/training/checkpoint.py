"""Checkpointing: atomic step directories, keep-last-k, an async save
thread and checksummed restores — the reference's
``training/checkpoint.py`` for named trees of tensors (parameters,
optimizer state) and of numpy arrays (the catalogue log's snapshots).

The on-disk format is the reference's, so either package reads what the
other wrote::

    <directory>/step_%010d/<group>.npz     one npz per named tree
    <directory>/step_%010d/manifest.json   shapes, dtypes, CRC32 per npz

A tree's leaves are stored under the reference's keys: the leaf's path
(``training.tree.path_str``, in the reference's leaf order) with ``/``
replaced by ``|``, e.g. ``m|item_emb|codes`` or
``m|item_emb|pruned|packed``.  The pruning metadata's presence words,
which the port carries as int32, are written as the reference's uint32
and restored to int32 with the same bits; ``bfloat16`` leaves are written
as the reference writes them (2-byte void, ``"bfloat16"`` in the
manifest).

A step is written into a temporary directory and published by one atomic
rename, so a crash mid-save never damages an older step.  ``save`` copies
every leaf to host numpy on the caller's thread (a CUDA tensor's copy
waits for the work that produces it), so the writer thread touches its
own numpy copies only.  Every npz's CRC32 is checked before numpy parses it;
:meth:`CheckpointManager.restore_latest` falls back past corrupt steps.

A leaf kept per pod (PowerSGD's error feedback, a ``Varying``) is written
as pod 0's value, which is what the reference's host read of its
per-device buffers sees; restored, it is one tensor that every pod takes.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pruning import UINT32_FIELDS
from repro_torch.distributed.sharding import Varying, device_put
from repro_torch.training import tree as tree_lib

Flat = Dict[str, np.ndarray]

_SEP = "|"
_BF16 = np.dtype("V2")          # how numpy stores a bfloat16 array's bytes


class CorruptCheckpointError(RuntimeError):
    """A checkpoint step directory failed validation: missing or unparsable
    manifest, missing npz, or a checksum mismatch (truncation, torn write,
    bit rot)."""


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _key(path) -> str:
    return tree_lib.path_str(path).replace("/", _SEP)


def _to_host(leaf, presence: bool = False) -> np.ndarray:
    """A copy of ``leaf`` in host memory (a copy even of a CPU tensor or
    array, so the caller may change it while a writer thread runs); int32
    presence words (``presence``) as the reference's uint32; a per-pod
    leaf as pod 0's value."""
    if isinstance(leaf, Varying):
        leaf = leaf.host()
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16)
    arr = t.numpy()
    if presence and arr.dtype == np.int32:
        arr = arr.view(np.uint32)
    return arr


def _flatten(tree: Any) -> Flat:
    return {_key(path): _to_host(leaf, owner is not None
                                 and path[-1] in UINT32_FIELDS)
            for path, leaf, owner in tree_lib.walk(tree)}


def _from_host(arr: np.ndarray, template) -> Any:
    """A stored array as its template's type: numpy cast to its dtype, or a
    tensor of its dtype on its device."""
    if not isinstance(template, torch.Tensor):
        return np.asarray(arr, np.asarray(template).dtype)
    if template.dtype == torch.bfloat16:
        if arr.dtype != _BF16:
            return torch.from_numpy(np.asarray(arr, np.float32)).to(
                torch.bfloat16).to(template.device)
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.view(torch.bfloat16).to(template.device)
    if template.dtype == torch.int32 and arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    want = torch.empty((), dtype=template.dtype).numpy().dtype
    return torch.from_numpy(np.array(arr, want)).to(template.device)


def _stored(arr: np.ndarray, presence: bool) -> torch.Tensor:
    """A stored array as a tensor of its own dtype (the reference's
    ``device_put`` keeps it): ``bfloat16`` from its 2-byte void, uint32
    presence words as the port's int32 with the same bits."""
    if arr.dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    if presence and arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr))


class CheckpointManager:
    """Steps of named trees under ``directory``, the newest ``keep`` kept
    (``keep <= 0`` keeps all)."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    # -- save ---------------------------------------------------------------

    def save(self, step: int, trees: Dict[str, Any], *,
             block: bool = False) -> None:
        """Write named trees (e.g. ``{"params": ..., "opt_state": ...}``, or
        ``{"catalogue": {"codes": ..., ...}}``) as step ``step``, publish
        it atomically and drop old steps: on a writer thread when the
        manager saves asynchronously and ``block`` is False (``wait()``
        joins it), else before returning."""
        host = {name: _flatten(t) for name, t in trees.items()}
        self.wait()   # drain any in-flight async save first
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: Dict[str, Flat]) -> None:
        final = self._step_dir(step)
        tmp = final + f".tmp{os.getpid()}-{threading.get_ident()}"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "groups": {},
                    "checksums": {}}
        for name, flat in host.items():
            fname = f"{name}.npz"
            np.savez(os.path.join(tmp, fname), **flat)
            manifest["groups"][name] = {
                k: {"shape": list(v.shape), "dtype": (
                    "bfloat16" if v.dtype == _BF16 else str(v.dtype))}
                for k, v in flat.items()}
            # CRC over the bytes as written; restore re-hashes them before
            # numpy parses the archive.
            manifest["checksums"][fname] = _file_crc32(
                os.path.join(tmp, fname))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> List[int]:
        """Published steps (a manifest present), ascending."""
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and ".tmp" not in d and \
                    os.path.exists(os.path.join(self.directory, d,
                                                "manifest.json")):
                out.append(int(d[5:]))
        return sorted(out)

    def validate_step(self, step: int) -> bool:
        """True when the step has a readable manifest and every group's npz
        is present with its CRC32 (a manifest without checksums, from an
        older writer, validates by parsing each archive's member table)."""
        base = self._step_dir(step)
        try:
            with open(os.path.join(base, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return False
        checksums = manifest.get("checksums")
        for name in manifest.get("groups", {}):
            path = os.path.join(base, f"{name}.npz")
            if not os.path.exists(path):
                return False
            if checksums is not None:
                want = checksums.get(f"{name}.npz")
                if want is None or _file_crc32(path) != int(want):
                    return False
            else:
                try:
                    with np.load(path) as z:
                        _ = z.files
                except (OSError, ValueError, zipfile.BadZipFile):
                    return False
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def valid_steps(self) -> List[int]:
        return [s for s in self.all_steps() if self.validate_step(s)]

    def restore_latest(self, templates: Dict[str, Any], shardings=None,
                       ) -> Tuple[int, Dict[str, Any]]:
        """The newest step that passes validation, falling back past
        corrupt ones -> ``(step, trees)``; raises
        :class:`CorruptCheckpointError` when none does."""
        steps = self.all_steps()
        skipped = []
        for step in reversed(steps):
            if not self.validate_step(step):
                skipped.append(step)
                continue
            try:
                return step, self.restore(step, templates, shardings)
            except CorruptCheckpointError:
                skipped.append(step)   # raced a concurrent writer or GC
        raise CorruptCheckpointError(
            f"no valid checkpoint under {self.directory!r} "
            f"(steps seen: {steps}, failed validation: {skipped})")

    def restore(self, step: int, templates: Dict[str, Any], shardings=None,
                ) -> Dict[str, Any]:
        """The trees named by ``templates`` (trees of tensors or numpy
        arrays giving the structure): each stored leaf must have its
        template's shape, and comes back as its template's type (a tensor
        of its dtype on its device, or a numpy array of its dtype).

        ``shardings`` (optional; per name, a tree of ``NamedSharding`` of
        the template's structure) places every leaf on the *current* mesh
        instead -- the elastic path: the stored whole arrays do not care
        how many devices wrote them or will read them.  Such a leaf keeps
        the file's dtype, as the reference's ``device_put`` does, and
        carries its ``.sharding``."""
        base = self._step_dir(step)
        try:
            with open(os.path.join(base, "manifest.json")) as f:
                checksums = json.load(f).get("checksums")
        except (OSError, ValueError) as e:
            raise CorruptCheckpointError(
                f"step {step}: unreadable manifest ({e})") from e
        out = {}
        for name, template in templates.items():
            path = os.path.join(base, f"{name}.npz")
            if checksums is not None and f"{name}.npz" in checksums:
                if _file_crc32(path) != int(checksums[f"{name}.npz"]):
                    raise CorruptCheckpointError(
                        f"step {step}: checksum mismatch on {name}.npz "
                        "(truncated or corrupt)")
            try:
                with np.load(path) as z:
                    flat = {k: z[k] for k in z.files}
            except (OSError, ValueError, zipfile.BadZipFile) as e:
                raise CorruptCheckpointError(
                    f"step {step}: unreadable {name}.npz ({e})") from e

            def leaf(path, tmpl, sh=None, flat=flat):
                key = _key(path)
                arr = flat[key]
                if isinstance(tmpl, Varying):
                    tmpl = tmpl.host()
                if tuple(arr.shape) != tuple(np.shape(tmpl)):
                    raise ValueError(
                        f"checkpoint leaf {key}: shape {arr.shape} != "
                        f"template {tuple(np.shape(tmpl))}")
                if sh is not None:
                    return device_put(_stored(arr, bool(path) and path[-1]
                                              in UINT32_FIELDS), sh)
                return _from_host(arr, tmpl)

            shard_tree = shardings.get(name) if shardings else None
            out[name] = (tree_lib.map_with_path(leaf, template)
                         if shard_tree is None else
                         tree_lib.map_with_path(leaf, template, shard_tree))
        return out
