"""host-reads: each serve entry reads the host as often as it documents,
and launches each kernel form as often.

The twin of the reference's ``dispatch-count``.  The reference proves a
route is one compiled dispatch by tracing it into one jaxpr: any host
orchestration fails the trace.  Eager PyTorch has no single dispatch; what
it can hold a route to is its documented host reads (ROADMAP D1: the
pruned cascades read their survivor counts, the fused route reads
nothing) and its kernel launches per batch.  So:

* **the meta run completes** — on meta tensors every read outside
  ``kernels.cost.host_read`` raises (``.item()``, ``.tolist()``,
  ``nonzero``, copies out of meta have no data): the counterpart of the
  reference's trace failure, which this pass reports for either run;
* **reads** — the device run's recorded route reads (the ``result`` read
  apart) equal ``expect_host_reads``;
* **launches** — every form the batch launched, it launched as often as
  ``expect_kernels`` says (a form that was not launched at all is
  ``kernel-contract``'s missing kernel);
* **uploads** — on meta and on the card, the blocking copies from the
  host to the device equal ``expect_uploads`` (an engine's batch of
  sequences; none for a route), whatever their size (``host-transfer``
  bounds the size of every upload, blocking or not);
* **variants** — an engine's warmed batch adds no serve variant
  (``stats()["n_compiles"]`` is unchanged), as the reference's engine
  entries assert no new compile;
* **on the card** — the recorded batch also runs under
  ``torch.cuda.set_sync_debug_mode("warn")``, and the synchronizations it
  reports equal the recorded route reads, plus the result read's own
  (one for a caller's copy of device outputs; none for an engine, whose
  wait on its CUDA event the mode does not report), plus the documented
  uploads (each a blocking copy from pageable host memory).  So no
  synchronization happens outside a documented read or upload.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.core import (RESULT, AnalysisPass, EntryContext,
                                       Finding, SEV_ERROR)


class HostReadsPass(AnalysisPass):
    name = "host-reads"
    description = ("the batch runs on meta (no host read outside "
                   "cost.host_read) and, on its device, reads the host and "
                   "launches each kernel form as often as documented; "
                   "makes the documented blocking uploads; engines add "
                   "no variant; on the card every synchronization is a "
                   "documented read or upload")
    scope = "entrypoint"
    requires_record = False   # a run failure IS this pass's finding

    def run(self, entrypoint: str, built: Any, ctx: Optional[EntryContext]
            ) -> Tuple[List[Finding], Dict[str, Any]]:
        findings: List[Finding] = []
        info: Dict[str, Any] = {}
        for dev in ctx.devices:
            if ctx.record(dev) is None:
                f = ctx.failures[dev]
                findings.append(Finding(
                    self.name, entrypoint, SEV_ERROR, "run-failure",
                    f"the batch does not run on {dev} ({f.exc_type})"
                    + (": a host read outside cost.host_read on the serve "
                       "path" if dev == "meta" else ""),
                    details={"device": dev, "exc_type": f.exc_type,
                             "message": f.message[:500]}))
        if findings:
            return findings, info

        rec = ctx.record(ctx.device)
        reads = rec.route_reads
        info["host_reads"] = len(reads)
        info["result_reads"] = rec.host_reads.count(RESULT)
        info["meta_host_reads"] = len(ctx.record("meta").route_reads)
        info["launches"] = rec.launched()
        info["seconds"] = round(rec.seconds, 6)
        if len(reads) != built.expect_host_reads:
            findings.append(Finding(
                self.name, entrypoint, SEV_ERROR, "host-reads",
                f"the batch read the host {len(reads)} time(s), documented "
                f"{built.expect_host_reads}: {reads}",
                details={"reads": reads,
                         "expected": built.expect_host_reads}))
        wrong = {form: n for form, n in rec.launched().items()
                 if n != built.expect_kernels.get(form, 0)}
        if wrong:
            findings.append(Finding(
                self.name, entrypoint, SEV_ERROR, "launch-count",
                f"the batch launched {wrong}, documented "
                f"{built.expect_kernels}",
                details={"launched": rec.launched(),
                         "expected": built.expect_kernels}))
        if rec.variants is not None:
            before, after = rec.variants
            info["variants"] = after
            if after != before:
                findings.append(Finding(
                    self.name, entrypoint, SEV_ERROR, "new-variant",
                    f"a warmed batch added {after - before} serve "
                    f"variant(s)", details={"before": before,
                                            "after": after}))
        if rec.cuda_launches is not None:
            info["cuda_launches"] = {k: v for k, v in
                                     rec.cuda_launches.items() if v}
        for dev in ctx.devices:
            kind = dev.split(":")[0]
            if kind == "cpu":       # a copy to the CPU from the CPU is none
                continue
            uploads = sum(1 for c in ctx.record(dev).copies if c.src == "cpu"
                          and c.dst == kind and not c.non_blocking)
            info[f"{kind}_uploads"] = uploads
            if uploads != built.expect_uploads:
                findings.append(Finding(
                    self.name, entrypoint, SEV_ERROR, "upload-count",
                    f"the batch made {uploads} blocking upload(s) from the "
                    f"host to {kind}, documented {built.expect_uploads}",
                    details={"device": kind, "uploads": uploads,
                             "expected": built.expect_uploads}))
        if rec.sync_warnings is not None:
            # An engine's result read waits on its CUDA event (which the
            # mode does not report) and reads pinned memory: no sync.
            result_syncs = (0 if built.reads_result
                            else rec.host_reads.count(RESULT))
            want = len(reads) + built.expect_uploads + result_syncs
            info["syncs"] = len(rec.sync_warnings)
            info["result_syncs"] = result_syncs
            if len(rec.sync_warnings) != want:
                findings.append(Finding(
                    self.name, entrypoint, SEV_ERROR, "unrecorded-sync",
                    f"sync debug mode reported {len(rec.sync_warnings)} "
                    f"synchronization(s); the {len(reads)} route read(s), "
                    f"the result read and {built.expect_uploads} "
                    f"documented upload(s) account for {want}",
                    details={"syncs": len(rec.sync_warnings),
                             "expected": want, "reads": reads}))
        return findings, info
