"""host-transfer: no catalogue-sized upload from the host inside a batch.

The reference flags callback primitives and large raw-numpy constants
closed over by the trace: the first re-enter Python per dispatch, the
second re-upload host data on every dispatch.  In the port:

* **uploads** — inside a warmed batch, no ``aten._to_copy`` or
  ``aten.copy_`` may move more than ``limit`` bytes (1 MiB) from a CPU
  tensor to the entry's device.  Checked on meta (the destination is
  meta) and on the card; a batch on the CPU has nothing to upload.
  Copies between tensors already on the device (the parameters, the
  catalogue) are not uploads and are not flagged.  An upload made while
  a tensor is constructed (``torch.tensor`` or ``torch.as_tensor`` of
  host data with a CUDA ``device``) does not reach a dispatch mode; on
  the card ``host-reads`` counts its synchronization (a Python-int
  position in the LM decode step costs one per layer that way).
* **callbacks** have no eager counterpart: every line of an eager route
  is Python, so there is no compiled computation for a callback to
  re-enter.  What a callback costs the reference — a synchronization per
  batch — is what ``host-reads`` counts.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.core import (AnalysisPass, EntryContext, Finding,
                                       SEV_ERROR)

#: Uploads smaller than this ride the batch for free (a request batch, a
#: slot list); bigger ones are catalogue-sized data taking the host path.
DEFAULT_UPLOAD_BYTES_LIMIT = 1 << 20


class HostTransferPass(AnalysisPass):
    name = "host-transfer"
    description = ("no copy of more than 1 MiB from the host to the "
                   "entry's device inside a warmed batch (on meta and on "
                   "the card); callbacks have no eager counterpart")
    scope = "entrypoint"
    requires_record = True

    def __init__(self, limit: int = DEFAULT_UPLOAD_BYTES_LIMIT):
        self.limit = limit

    def run(self, entrypoint: str, built: Any, ctx: Optional[EntryContext]
            ) -> Tuple[List[Finding], Dict[str, Any]]:
        findings: List[Finding] = []
        info: Dict[str, Any] = {}
        for dev in ctx.devices:
            kind = dev.split(":")[0]
            if kind == "cpu":
                continue
            ups = [c for c in ctx.record(dev).copies
                   if c.src == "cpu" and c.dst == kind]
            info[f"{kind}_uploads"] = len(ups)
            info[f"{kind}_upload_bytes"] = sum(c.nbytes for c in ups)
            for c in ups:
                if c.nbytes > self.limit:
                    findings.append(Finding(
                        self.name, entrypoint, SEV_ERROR, "host-upload",
                        f"{c.op} moves {c.nbytes} bytes from the host to "
                        f"{kind} inside the batch (limit {self.limit}): "
                        f"keep it on the device between batches",
                        details={"device": kind, "op": c.op,
                                 "nbytes": c.nbytes, "limit": self.limit}))
        return findings, info
