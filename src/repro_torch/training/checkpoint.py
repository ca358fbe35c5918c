"""Checksummed step checkpoints of flat numpy dicts: the part of the
reference's ``training/checkpoint.py`` that the catalogue log uses.

The on-disk format is the reference's, so either package reads what the
other wrote::

    <directory>/step_%010d/<group>.npz     one npz per named group
    <directory>/step_%010d/manifest.json   shapes, dtypes, CRC32 per npz

A step is written into a temporary directory and published by one atomic
rename, so a crash mid-save never damages an older step.  Every npz's
CRC32 is checked before numpy parses it; :meth:`CheckpointManager.
restore_latest` falls back past corrupt steps.  Saves are synchronous.
Checkpoints of model parameters and optimizer state come with training.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
import zlib
from typing import Dict, List, Tuple

import numpy as np

Flat = Dict[str, np.ndarray]


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


class CheckpointManager:
    """Steps of named flat dicts under ``directory``, the newest ``keep``
    kept (``keep <= 0`` keeps all)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    # -- save ---------------------------------------------------------------

    def save(self, step: int, groups: Dict[str, Flat]) -> None:
        """Write ``groups`` (e.g. ``{"catalogue": {"codes": ..., ...}}``) as
        step ``step`` and publish it atomically, then drop old steps."""
        final = self._step_dir(step)
        tmp = final + f".tmp{os.getpid()}-{threading.get_ident()}"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "groups": {},
                    "checksums": {}}
        for name, flat in groups.items():
            flat = {k: np.asarray(v) for k, v in flat.items()}
            fname = f"{name}.npz"
            np.savez(os.path.join(tmp, fname), **flat)
            manifest["groups"][name] = {
                k: {"shape": list(v.shape), "dtype": str(v.dtype)}
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

    def valid_steps(self) -> List[int]:
        return [s for s in self.all_steps() if self.validate_step(s)]

    def restore_latest(self, templates: Dict[str, Flat]
                       ) -> Tuple[int, Dict[str, Flat]]:
        """The newest step that passes validation, falling back past
        corrupt ones -> ``(step, groups)``; raises
        :class:`CorruptCheckpointError` when none does."""
        steps = self.all_steps()
        skipped = []
        for step in reversed(steps):
            if not self.validate_step(step):
                skipped.append(step)
                continue
            try:
                return step, self.restore(step, templates)
            except CorruptCheckpointError:
                skipped.append(step)   # raced a concurrent writer or GC
        raise CorruptCheckpointError(
            f"no valid checkpoint under {self.directory!r} "
            f"(steps seen: {steps}, failed validation: {skipped})")

    def restore(self, step: int, templates: Dict[str, Flat]
                ) -> Dict[str, Flat]:
        """The groups named by ``templates`` ({group: {key: array}}): each
        stored array must have its template's shape and is cast to its
        dtype."""
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
            group = {}
            for key, leaf in template.items():
                arr = flat[key]
                if tuple(arr.shape) != tuple(np.shape(leaf)):
                    raise ValueError(
                        f"checkpoint leaf {key}: shape {arr.shape} != "
                        f"template {np.shape(leaf)}")
                group[key] = np.asarray(arr, np.asarray(leaf).dtype)
            out[name] = group
        return out
