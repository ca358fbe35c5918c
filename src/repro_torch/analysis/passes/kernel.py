"""kernel-contract: every recorded launch is held to the H100 kernels'
contract.

The twin of the reference's ``kernel-contract``, which reads each
``pallas_call``'s grid mapping.  The port's kernels take their launch
plan from ``kernel.plan_launch``, so each recorded launch's plan inputs
(``kernels.cost.LaunchInputs``) are re-planned and checked:

* **fit** — a plan exists, its shared memory is at most ``MAX_SMEM`` and
  an SM holds at least one block of it (``kernel.py: plan_launch``,
  ``LaunchPlan.blocks_per_sm``);
* **alignment** — the plan's ``sc_off``, ``cand_off`` and ``ring_off``,
  its ``stage_bytes`` and ``live_off`` are multiples of 16, which the
  kernels' 16-byte copies need and ``csrc/pqtopk.cu: plan_ok`` checks
  (ROADMAP C6).  The kernels take any N and B, a ragged last tile masked
  inside; the ops pad codes to whole tiles and S to the batch tile
  (``ops._pad_codes``, ``_pad_batch``) only for parity checks;
* **sentinels** — every slot table a route built holds only in-range
  tile ids, ``-1`` or the past-the-end tile (``ops.sentinel_tile``); and
  a table of only such slots, at each recorded launch's shapes, gives
  ``-inf`` in every slot, id ``n_items`` in each ``-1`` slot and no
  catalogue id in a past-the-end slot (the plain version on the CPU, the
  kernel on the card; not checkable on meta, which has no values);
* **missing kernel** — every form ``expect_kernels`` lists was launched.

The reference's TPU checks have no counterpart here: the VMEM budget
(the H100's shared-memory budget is the fit check), lane and sublane
tiling (the kernels read codes from the 16-byte boundary below each ring
stage, and a ragged tile is masked, so no block shape must divide the
arrays) and the static grid (a CUDA grid is sized per launch on the host
and keys no compile).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.core import (AnalysisPass, EntryContext, Finding,
                                       SEV_ERROR)

ALIGNED_FIELDS = ("sc_off", "cand_off", "ring_off", "stage_bytes",
                  "live_off")


def _plan(li, planner):
    return planner(li.kind, m=li.m, b=li.b, bq=li.bq,
                   code_bytes=li.code_bytes, n=li.n, tile=li.tile,
                   batch_tile=li.batch_tile, live=li.live)


def _sentinel_output(li) -> Optional[str]:
    """Run ``li``'s launch on a table of only ``-1`` and past-the-end
    slots (zero codes and S, every row live) -> what is wrong, or None."""
    import torch
    from repro_torch.kernels.pqtopk import ops
    dev = li.table.device
    codes = torch.zeros((li.n, li.m), dtype=getattr(
        torch, li.dtype.split(".")[-1]), device=dev)
    s = torch.zeros((li.bq, li.m, li.b), dtype=torch.float32, device=dev)
    end = ops.sentinel_tile(li.n, li.tile)
    table = torch.full(tuple(li.table.shape), -1, dtype=torch.int32,
                       device=dev)
    table[..., 1::2] = end
    live = (torch.ones(li.n, dtype=torch.bool, device=dev) if li.live
            else None)
    vals, ids = ops.pq_topk_slots(codes, s, li.k, table, n_items=li.n_items,
                                  tile=li.tile, batch_tile=li.batch_tile,
                                  live=live)
    if not bool(torch.all(vals == float("-inf"))):
        return "a sentinel-only table scored a finite value"
    ids = ids.cpu()
    neg = (table.cpu() < 0)
    if neg.dim() == 2:    # row j serves queries j*batch_tile ..
        neg = neg.repeat_interleave(li.batch_tile, 0)[:li.bq]
    neg = neg.expand(li.bq, -1) if neg.dim() == 1 else neg
    if not bool(torch.all(ids[neg] == li.n_items)):
        return f"a -1 slot gave an id other than n_items={li.n_items}"
    if not bool(torch.all(ids[~neg] >= li.n_items)):
        return "a past-the-end slot gave a catalogue id"
    return None


class KernelContractPass(AnalysisPass):
    name = "kernel-contract"
    description = ("per recorded launch: its plan fits the H100's shared "
                   "memory with a block per SM, 16-byte-aligned offsets, "
                   "slot tables of in-range ids and sentinels that score "
                   "-inf; every documented kernel form launched")
    scope = "entrypoint"
    requires_record = True

    def __init__(self, planner: Optional[Callable] = None):
        self.planner = planner

    def run(self, entrypoint: str, built: Any, ctx: Optional[EntryContext]
            ) -> Tuple[List[Finding], Dict[str, Any]]:
        from repro_torch.kernels.pqtopk import kernel as pq_kernel
        from repro_torch.kernels.pqtopk import ops
        planner = self.planner or pq_kernel.plan_launch
        findings: List[Finding] = []
        rec = ctx.record(ctx.device)
        info: Dict[str, Any] = {"n_launches": sum(rec.launches.values())}

        for form, n in built.expect_kernels.items():
            if n and not rec.launches.get(form, 0):
                findings.append(Finding(
                    self.name, entrypoint, SEV_ERROR, "missing-kernel",
                    f"expected {n} launch(es) of {form} a batch, found "
                    f"none: the route is not reaching the kernel",
                    details={"form": form, "expected": n}))

        seen, max_smem = set(), 0
        for dev in ctx.devices:
            for li in ctx.record(dev).inputs:
                key = li.plan_key()
                if key in seen:
                    continue
                seen.add(key)
                where = f"{li.form} {key}"
                try:
                    plan = _plan(li, planner)
                except ValueError as e:
                    findings.append(Finding(
                        self.name, entrypoint, SEV_ERROR, "no-plan",
                        f"{where}: {e}", details={"launch": list(key)}))
                    continue
                max_smem = max(max_smem, plan.smem)
                if plan.smem > pq_kernel.MAX_SMEM or plan.blocks_per_sm < 1:
                    findings.append(Finding(
                        self.name, entrypoint, SEV_ERROR, "smem-fit",
                        f"{where}: {plan.smem} bytes of shared memory "
                        f"(limit {pq_kernel.MAX_SMEM}), "
                        f"{plan.blocks_per_sm} block(s) per SM",
                        details={"smem": plan.smem,
                                 "blocks_per_sm": plan.blocks_per_sm}))
                bad = {f: getattr(plan, f) for f in ALIGNED_FIELDS
                       if getattr(plan, f) % 16}
                if bad:
                    findings.append(Finding(
                        self.name, entrypoint, SEV_ERROR, "alignment",
                        f"{where}: {bad} not multiples of 16",
                        details={"fields": bad}))
        info["n_plans"] = len(seen)
        info["max_smem"] = max_smem

        if rec.device == "meta":
            info["sentinels"] = "not checkable on meta"
            return findings, info
        checked, n_tables = set(), 0
        for li in rec.inputs:
            if li.table is None:
                continue
            n_tables += 1
            ids = li.table.cpu()
            end = ops.sentinel_tile(li.n, li.tile)
            stray = ids[(ids != -1) & ((ids < 0) | (ids > end))]
            if stray.numel():
                findings.append(Finding(
                    self.name, entrypoint, SEV_ERROR, "sentinel-slot",
                    f"{li.form}: slot table holds {stray.unique().tolist()}"
                    f"; a slot is a tile id in [0, {end}), -1 or the "
                    f"past-the-end tile {end}",
                    details={"stray": stray.unique().tolist()[:16],
                             "n_tiles": end}))
            key = (li.plan_key(), li.k, li.n_items, tuple(li.table.shape))
            if key not in checked:
                checked.add(key)
                wrong = _sentinel_output(li)
                if wrong:
                    findings.append(Finding(
                        self.name, entrypoint, SEV_ERROR, "sentinel-output",
                        f"{li.form}: {wrong}", details={"launch": list(
                            li.plan_key())}))
        info["slot_tables"] = n_tables
        info["sentinel_checks"] = len(checked)
        return findings, info
