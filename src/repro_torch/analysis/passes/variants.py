"""variants: every value that keys a serve variant, or a kernel's launch
plan, comes from a bounded set.

The twin of the reference's ``recompile-hazard``.  The port's engine
memoises one serve callable per (batch bucket, k bucket, method, pinned)
(``RetrievalEngine._variant``), and its bit parity with the reference
rests on the padded sizes (ROADMAP C4), so an unbucketed client value
would grow the memo and change the padding.  Two checks:

* **static specs** — as the reference: each declared
  :class:`~repro_torch.analysis.entrypoints.StaticArgSpec`'s sample,
  pushed through the *production* mapping (``MicroBatcher.bucket``,
  ``RetrievalEngine.batch_k``), stays inside ``allowed`` and under
  ``max_variants``;
* **launch plans** — each kernel instance (kernel, code type, m)
  caches the occupancy of ``kCacheSizes`` = 16 shared-memory sizes
  (``csrc/pqtopk.cu: LaunchCache``); a 17th size queries the occupancy
  API on every launch.  The cache is one per instance in the process,
  shared by every route, so the sizes are gathered over every entry the
  pass has seen in one analysis (each recorded launch at every batch
  bucket of its entry's ``batch_bucket`` spec), and an instance's
  union must hold at most 16.  The entry that takes an instance past
  16 fails, naming the entries that share it.  Launches made outside the
  analysis (the card's smoke runs other shapes in the same process) the
  pass cannot see; ``plan_sizes`` in its info lists each instance's
  union, so a caller can add the runs of another analysis to it.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.core import (AnalysisPass, EntryContext, Finding,
                                       SEV_ERROR)

#: ``kCacheSizes`` of ``csrc/pqtopk.cu``: shared-memory sizes a kernel
#: instance's launch cache holds.
K_CACHE_SIZES = 16
#: Widths with an instance of their own (``PQ_WIDTHS``); any other m runs
#: the generic one.
INSTANCE_WIDTHS = (2, 4, 6, 8)


def plan_smem(li, bq: int) -> Optional[int]:
    """Shared memory of ``li``'s plan at ``bq`` queries, or None when no
    plan fits (``kernel-contract`` reports that)."""
    from repro_torch.kernels.pqtopk import kernel as pq_kernel
    try:
        return pq_kernel.plan_launch(
            li.kind, m=li.m, b=li.b, bq=bq, code_bytes=li.code_bytes,
            n=li.n, tile=li.tile, batch_tile=li.batch_tile,
            live=li.live).smem
    except ValueError:
        return None


class VariantsPass(AnalysisPass):
    name = "variants"
    description = ("values keying a serve variant map into bounded bucket "
                   "sets (pow2 batch/k buckets, ladder rungs, n_groups), "
                   "and each kernel instance's launch plans fit its "
                   f"{K_CACHE_SIZES}-entry cache")
    scope = "entrypoint"
    requires_record = True

    def __init__(self):
        # instance -> shared-memory size -> the entries that launch at it
        self.plans: Dict[Tuple[str, str, int], Dict[int, List[str]]] = \
            defaultdict(dict)

    def run(self, entrypoint: str, built: Any, ctx: Optional[EntryContext]
            ) -> Tuple[List[Finding], Dict[str, Any]]:
        findings: List[Finding] = []
        info: Dict[str, Any] = {"n_specs": len(built.static_specs)}
        buckets = set()
        for spec in built.static_specs:
            image = {spec.mapper(v) for v in spec.sample}
            info[f"{spec.name}_variants"] = len(image)
            if spec.name == "batch_bucket":
                buckets = image
            if len(image) > spec.max_variants:
                findings.append(Finding(
                    self.name, entrypoint, SEV_ERROR, "unbounded-static-arg",
                    f"static arg '{spec.name}': {len(spec.sample)} client "
                    f"values map to {len(image)} variants (ceiling "
                    f"{spec.max_variants}): unbounded client values can "
                    f"key unbounded variants",
                    details={"spec": spec.name,
                             "n_sample": len(spec.sample),
                             "n_variants": len(image),
                             "max_variants": spec.max_variants,
                             "variants": sorted(image, key=repr)[:32]}))
            if spec.allowed is not None:
                stray = image - set(spec.allowed)
                if stray:
                    findings.append(Finding(
                        self.name, entrypoint, SEV_ERROR, "out-of-bucket",
                        f"static arg '{spec.name}': values "
                        f"{sorted(stray, key=repr)[:8]} escape the allowed "
                        f"bucket set",
                        details={"spec": spec.name,
                                 "stray": sorted(stray, key=repr)[:32],
                                 "allowed": sorted(spec.allowed,
                                                   key=repr)[:32]}))

        touched = set()
        for dev in ctx.devices:
            for li in ctx.record(dev).inputs:
                inst = (li.kind, li.dtype,
                        li.m if li.m in INSTANCE_WIDTHS else 0)
                touched.add(inst)
                for bq in {li.bq} | buckets:
                    smem = plan_smem(li, bq)
                    if smem is None:
                        continue
                    users = self.plans[inst].setdefault(smem, [])
                    if entrypoint not in users:
                        users.append(entrypoint)
        info["plan_sizes"] = {"/".join(map(str, inst)):
                              sorted(self.plans[inst])
                              for inst in sorted(touched)}
        for inst in sorted(touched):
            smems = self.plans[inst]
            if len(smems) > K_CACHE_SIZES:
                sharing = sorted({e for es in smems.values() for e in es})
                findings.append(Finding(
                    self.name, entrypoint, SEV_ERROR, "plan-cache",
                    f"kernel instance {inst} launches at {len(smems)} "
                    f"shared-memory sizes over {sharing}; its launch cache "
                    f"holds {K_CACHE_SIZES}, so the rest query the "
                    f"occupancy at every launch",
                    details={"instance": list(inst),
                             "sizes": sorted(smems),
                             "entrypoints": sharing}))
        return findings, info
