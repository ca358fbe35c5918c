"""The port's serve-path analysis (``repro_torch.analysis``) on meta and
the CPU, held to the reference's ``repro.analysis`` where the two meet.

* mechanics: the report's JSON keys and rendered table equal the
  reference's for the same findings; the registry's names and order
  equal the reference's;
* every registered entry passes every pass on meta and on the CPU, with
  its documented launches and host reads;
* one negative control per pass, each failing its pass and no other
  (skips from a shared root cause are not failures);
* parity: ``MicroBatcher.bucket`` and ``RetrievalEngine.batch_k`` map the
  variants pass's samples as the reference's do.
"""
from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.analysis import entrypoints as ep
from repro_torch.analysis import run_default
from repro_torch.analysis.core import (Finding, PassResult, Report,
                                       STATUS_PASS, run_analysis)
from repro_torch.analysis.passes import (AstLintPass, HostReadsPass,
                                         HostTransferPass,
                                         KernelContractPass, VariantsPass,
                                         default_passes)

ENTRY_PASSES = ("host-reads", "host-transfer", "variants",
                "kernel-contract")


def run_on(built, name="probe", passes=None, device="cpu") -> Report:
    """Run ``passes`` (default: the default list) on one ad-hoc entry."""
    entry = ep.Entrypoint(name, "ad-hoc test entrypoint", lambda *a: built)
    return run_analysis({name: entry}, passes or default_passes(),
                        lambda _n: built, device)


# ---------------------------------------------------------------------------
# mechanics
# ---------------------------------------------------------------------------

def test_report_json_and_table_match_the_reference():
    from repro.analysis import core as ref_core
    findings = [("host-reads", "probe", "error", "host-reads", "read twice",
                 {"reads": ["a", "b"]})]
    port = Report([PassResult("probe", "host-reads", "fail",
                              [Finding(*f) for f in findings], {"n": 1}),
                   PassResult("probe", "variants", "pass", [], {})],
                  meta={"device": "cpu"})
    ref = ref_core.Report(
        [ref_core.PassResult("probe", "host-reads", "fail",
                             [ref_core.Finding(*f) for f in findings],
                             {"n": 1}),
         ref_core.PassResult("probe", "variants", "pass", [], {})],
        meta={"device": "cpu"})
    assert json.dumps(port.to_json(), sort_keys=True) == json.dumps(
        ref.to_json(), sort_keys=True)
    assert port.render() == ref.render()
    assert port.failing_passes("probe") == ref.failing_passes("probe")
    real = run_default(["pruned_tiles_kernel"], device="meta").to_json()
    want = ref.to_json()
    assert set(real) == set(want)
    assert {tuple(r) for r in real["results"]} == {tuple(want["results"][0])}


def test_registry_names_and_order_match_the_reference():
    from repro.analysis import entrypoints as ref_ep
    assert list(ep.REGISTRY) == list(ref_ep.REGISTRY)
    assert list(ep.DOCUMENTED) == list(ep.REGISTRY)
    assert [p.name for p in default_passes()] == [
        "host-reads", "host-transfer", "variants", "kernel-contract",
        "ast-lint"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", list(ep.REGISTRY))
def test_every_entry_passes_every_pass(name, device):
    report = run_default([name], passes=list(ENTRY_PASSES), device=device)
    assert report.ok, report.render()
    assert [r.status for r in report.results] == [STATUS_PASS] * 4
    info = report.result(name, "host-reads").info
    kernels, reads, uploads = ep.DOCUMENTED[name]
    assert info["launches"] == kernels and info["host_reads"] == reads
    assert info["meta_host_reads"] == reads and info["result_reads"] == 1
    assert info["meta_uploads"] == uploads


def test_cli_writes_the_json_report(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "report.json"
    assert main(["--device", "meta", "-e", "flat_pruned", "--json",
                 str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["meta"]["device"] == "meta"
    assert {(r["entrypoint"], r["pass"]) for r in doc["results"]} == {
        ("flat_pruned", p) for p in ENTRY_PASSES} | {("<sources>",
                                                      "ast-lint")}
    assert main(["--list"]) == 0
    assert "router_durable" in capsys.readouterr().out


def test_check_serve_path_passes_with_its_negative_control():
    from repro_torch.analysis.check_serve_path import main
    assert main(["--device", "cpu"]) == 0


# ---------------------------------------------------------------------------
# negative controls: each fails its own pass and no other
# ---------------------------------------------------------------------------

def test_host_cascade_fails_host_reads_only():
    from repro_torch.analysis.check_serve_path import build_host_cascade
    report = run_on(build_host_cascade("cpu"), "host_cascade")
    assert report.failing_passes("host_cascade") == ["host-reads"]
    (err,) = report.errors
    assert err.code == "run-failure" and err.details["device"] == "meta"
    assert err.details["exc_type"] == "NotImplementedError"     # nonzero


def _fused_route():
    """flat_fused, built afresh so a test can change one thing about it."""
    return ep.build("flat_fused", "cpu")


def _uploading_route(n_floats, non_blocking):
    """flat_fused that also uploads ``n_floats`` host floats each batch."""
    built = _fused_route()
    host = torch.from_numpy(np.ones(n_floats, np.float32))

    def fn(p, seqs, mesh, _f=built.fn):
        up = host.to(seqs.device, non_blocking=non_blocking)
        out = _f(p, seqs, mesh)
        return out[0], out[1] + up[:1] * 0
    built.fn = fn
    return built


def test_upload_of_2mib_each_batch_fails_host_transfer_only():
    # Not blocking, so the batch's blocking uploads stay as documented
    # (host-reads); its size alone is at fault.
    report = run_on(_uploading_route(1 << 19, True), "uploads")  # 2 MiB
    assert report.failing_passes("uploads") == ["host-transfer"], \
        report.render()


def test_small_blocking_upload_each_batch_fails_host_reads_only():
    # 64 bytes, far under host-transfer's limit, but a blocking copy (a
    # synchronization on the card) that flat_fused does not document.
    report = run_on(_uploading_route(16, False), "small_upload")
    assert report.failing_passes("small_upload") == ["host-reads"], \
        report.render()
    (err,) = report.errors
    assert err.code == "upload-count" and err.details == {
        "device": "meta", "uploads": 1, "expected": 0}


def test_device_resident_parameters_are_not_flagged():
    report = run_on(_fused_route(), "params", device="meta")
    assert report.ok, report.render()


def test_unbucketed_k_fails_variants_only():
    from repro_torch.serving.engine import MicroBatcher
    built = _fused_route()
    built.static_specs = (ep.StaticArgSpec(
        "k_raw", sample=tuple(range(1, 64)), mapper=lambda kv: kv,
        max_variants=7),)
    report = run_on(built, "k_raw")
    assert report.failing_passes("k_raw") == ["variants"]
    assert {f.code for f in report.errors} == {"unbounded-static-arg"}
    built.static_specs = (ep.StaticArgSpec(
        "k_bucketed", sample=tuple(range(1, 64)),
        mapper=lambda kv: MicroBatcher.bucket(kv, 64), max_variants=7),)
    assert run_on(built, "k_bucketed").ok


def test_out_of_bucket_values_fail_variants_only():
    built = _fused_route()
    built.static_specs = (ep.StaticArgSpec(
        "batch_raw", sample=tuple(range(1, 9)), mapper=lambda n: n,
        allowed=ep._pow2_buckets(8), max_variants=64),)
    report = run_on(built, "batch_raw")
    assert report.failing_passes("batch_raw") == ["variants"]
    assert {f.code for f in report.errors} == {"out-of-bucket"}
    assert sorted(report.errors[0].details["stray"]) == [3, 5, 6, 7]


def _kernel_route(table, *, n=1024, m=8, b=16, bq=16, dtype=np.int8,
                  direct=False):
    """An ad-hoc route: ``ops.pq_topk_tiles`` over ``table`` (or, with
    ``direct``, the plain version called around the wrapper)."""
    from repro_torch.kernels.pqtopk import ops, ref
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(0, b, (n, m)).astype(dtype))
    s = torch.from_numpy(rng.standard_normal((bq, m, b)).astype(np.float32))
    idx = torch.tensor(table, dtype=torch.int32)

    def make_args(dev):
        return codes.to(dev), s.to(dev), idx.to(dev)

    def fn(c, sc, i):
        if direct:
            tv, ti = ref.pq_topk_slots(c, sc, 8, i, n_items=n, tile=512)
            return ops._merge_slot_winners(tv, ti, 8)
        return ops.pq_topk_tiles(c, sc, 8, i, tile=512)

    return ep.BuiltEntry(fn, make_args, {"pq_topk_fused": 1}, 0)


def test_plans_past_the_launch_cache_fail_variants_only():
    # One kernel instance (fused, int16 codes, m=8) at 17 widths b, one
    # entry each: every entry alone has one plan, but they share the
    # instance's 16-size cache, so the 17th entry fails.
    built = {f"b{b}": _kernel_route([0, 1], b=b, bq=2, dtype=np.int16)
             for b in range(16, 16 * 18, 16)}
    entries = {name: ep.Entrypoint(name, "ad-hoc", lambda *a: None)
               for name in built}
    report = run_analysis(entries, default_passes(), built.__getitem__,
                          "cpu")
    failing = {n: report.failing_passes(n) for n in built}
    assert failing == {n: ["variants"] if n == "b272" else []
                       for n in built}, report.render()
    (err,) = report.errors
    assert err.code == "plan-cache" and len(err.details["sizes"]) == 17
    assert err.details["entrypoints"] == sorted(built)


def test_plan_over_max_smem_fails_kernel_contract_only():
    # b=8192: S of one query is 256 KiB, past the 232,448 bytes a block
    # may use; the plain version on the CPU computes it all the same.
    built = _kernel_route([0, 1], b=8192, bq=2, dtype=np.int16)
    report = run_on(built, "smem")
    assert report.failing_passes("smem") == ["kernel-contract"]
    assert {f.code for f in report.errors} == {"no-plan"}


def test_offset_off_the_16_byte_grid_fails_kernel_contract_only():
    from dataclasses import replace
    from repro_torch.kernels.pqtopk import kernel as pq_kernel

    def shifted(*a, **kw):
        plan = pq_kernel.plan_launch(*a, **kw)
        return replace(plan, ring_off=plan.ring_off + 4)
    passes = [HostReadsPass(), HostTransferPass(), VariantsPass(),
              KernelContractPass(planner=shifted), AstLintPass()]
    report = run_on(ep.build("pruned_tiles_kernel", "cpu"), "shifted",
                    passes)
    assert report.failing_passes("shifted") == ["kernel-contract"]
    assert {f.code for f in report.errors} == {"alignment"}
    assert run_on(ep.build("pruned_tiles_kernel", "cpu"), "aligned").ok


def test_slot_table_holding_minus_2_fails_kernel_contract_only():
    report = run_on(_kernel_route([0, -2]), "minus2")
    assert report.failing_passes("minus2") == ["kernel-contract"]
    assert {f.code for f in report.errors} == {"sentinel-slot"}
    assert report.errors[0].details["stray"] == [-2]
    # -1 and the past-the-end tile (2 of 2) are sentinels, not strays.
    assert run_on(_kernel_route([0, -1, 2]), "sentinels").ok


def test_route_calling_the_plain_version_fails_kernel_contract_only():
    report = run_on(_kernel_route([0, -1], direct=True),
                    "direct")
    assert report.failing_passes("direct") == ["kernel-contract"]
    assert {f.code for f in report.errors} == {"missing-kernel"}


BAD_SOURCES = {
    "reference-import": "import jax\nimport jax.numpy as jnp\n",
    "import-cuda": "import torch\nX = torch.zeros(3, device='cuda')\n",
    "module-tensor": "import torch\n\n\nclass C:\n    T = torch.arange(4)\n",
    "mutable-default": "def f(x, acc=[]):\n    return acc\n",
}


@pytest.mark.parametrize("code", list(BAD_SOURCES))
def test_astlint_flags_each_hazard(tmp_path, code):
    lint = AstLintPass()
    found = {f.code for f in lint.lint_source(BAD_SOURCES[code], "bad.py")}
    assert found == {code}
    (tmp_path / "bad.py").write_text(BAD_SOURCES[code])
    report = run_analysis({}, [AstLintPass(roots=[tmp_path])], ep.build)
    assert report.failing_passes("<sources>") == ["ast-lint"]


def test_astlint_passes_clean_sources_and_the_port():
    clean = ("import torch\nfrom repro_torch.kernels import cost\n"
             "NEG_INF = float('-inf')\n\n\n"
             "def f(x, acc=None):\n"
             "    from repro_torch.kernels.pqtopk import kernel\n"
             "    kernel.build()\n"
             "    return torch.zeros(3, device='cuda') + x.cuda()\n")
    assert AstLintPass().lint_source(clean, "clean.py") == []
    assert [f.code for f in AstLintPass().lint_source(
        "from repro.core import pq\n", "x.py")] == ["reference-import"]
    findings, info = AstLintPass().run("<sources>", None, None)
    assert findings == [] and info["n_files"] > 80
    assert any(r.endswith("chip_smoke.py") for r in info["roots"])


# ---------------------------------------------------------------------------
# parity of the variant keys with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_batch", [1, 8, 64, 100])
def test_bucket_matches_the_reference(max_batch):
    from repro.serving.engine import MicroBatcher as RefBatcher
    from repro_torch.serving.engine import MicroBatcher
    sample = range(1, 2 * max_batch + 2)
    assert [MicroBatcher.bucket(n, max_batch) for n in sample] == \
        [RefBatcher.bucket(n, max_batch) for n in sample]


@pytest.mark.parametrize("k,max_k", [(5, 2048), (10, 16), (1, 1), (7, 100)])
def test_batch_k_matches_the_reference(k, max_k):
    from repro.serving.engine import RetrievalEngine as RefEngine
    from repro_torch.serving.engine import RetrievalEngine
    eng = SimpleNamespace(k=k, max_k=max_k)
    sample = list(range(-2, 70)) + [200, 1000, 10 ** 9]
    got = [RetrievalEngine.batch_k(eng, [v]) for v in sample]
    assert got == [RefEngine.batch_k(eng, [v]) for v in sample]
    assert got == [RetrievalEngine.batch_k(eng, [v, 1]) for v in sample]
