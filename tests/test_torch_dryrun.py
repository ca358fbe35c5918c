"""The port's one-card dry run (``launch/dryrun.py``) and the kernel
wrappers' meta branch and launch record (``kernels/cost.py``), on the CPU.

The counts of a step on meta equal the same counter's counts of the same
step run for real on the CPU, exactly, for flops, bytes and kernel
launches: a wrapper records its launch and its work on every device and
hides its plain version's own ops.  The peak is not held to bits there:
a CPU backward runs in the calling thread and a meta one in the device's
worker thread, so autograd frees some buffers between other ops (on the
card ``chip_smoke.py: dryrun_check`` holds it to the allocator)."""
import json

import pytest
import torch

from repro_torch.configs.base import PQConfig, get_reduced
from repro_torch.core import pruning, retrieval_head
from repro_torch.kernels import cost
from repro_torch.kernels.embedding_bag import kernel as eb_kernel
from repro_torch.kernels.embedding_bag import ops as eb_ops, ref as eb_ref
from repro_torch.kernels.pqtopk import kernel as pq_kernel
from repro_torch.kernels.pqtopk import ops as pq_ops, ref as pq_ref
from repro_torch.launch import dryrun, steps

from test_torch_steps import cut

REF_KEYS = {"arch", "shape", "mesh", "variant", "devices", "ok", "lower_s",
            "compile_s", "memory", "flops_per_device", "bytes_per_device",
            "collectives", "collective_bytes_per_device", "meta",
            "roofline"}
MEMORY_KEYS = {"argument_size_in_bytes", "state_size_in_bytes",
               "output_size_in_bytes", "temp_size_in_bytes",
               "alias_size_in_bytes", "generated_code_size_in_bytes"}

COUNT_CELLS = [
    ("qwen2.5-14b", "train_4k", "baseline"),
    ("qwen2.5-14b", "decode_32k", "fused_head"),
    ("gemma3-27b", "decode_32k", "baseline"),
    ("qwen3-moe-30b-a3b", "decode_32k", "moe_sort"),
    ("dbrx-132b", "prefill_32k", "baseline"),
    ("sasrec-recjpq", "serve_users", "fused_head"),
    ("gbert4rec-recjpq", "train_seq", "baseline"),
    ("bst", "retrieval_cand", "fused_head"),
    ("dcn-v2", "train_batch", "baseline"),
    ("dien", "serve_p99", "baseline"),
    ("fm", "serve_bulk", "baseline"),
    ("graphsage-reddit", "minibatch_lg", "baseline"),
    ("graphsage-reddit", "molecule", "baseline"),
]


def _bundle(arch_id, shape_name, variant, device, **kw):
    return steps.build_step(arch_id, shape_name, device, variant,
                            arch_override=cut(get_reduced(arch_id)), **kw)


@pytest.mark.parametrize("arch_id,shape_name,variant", COUNT_CELLS)
def test_meta_count_equals_cpu_count(arch_id, shape_name, variant):
    meta = dryrun._measure(_bundle(arch_id, shape_name, variant, "meta"))
    cpu = dryrun._measure(_bundle(arch_id, shape_name, variant, "cpu"))
    for key in ("flops_by_dtype", "bytes", "aten_bytes", "kernel_bytes",
                "kernel_ops", "launches", "aten_ops", "output_bytes"):
        assert meta[key] == cpu[key], key
    assert meta["flops"] > 0 or arch_id == "fm"
    assert not meta["stand_ins"]
    assert abs(meta["peak_bytes"] - cpu["peak_bytes"]) <= (
        0.05 * cpu["peak_bytes"])


def _head(device, live=False):
    arch = get_reduced("sasrec-recjpq")
    n, d = 5000, arch.model.d_model
    pq = PQConfig(m=4, b=16, code_dtype="uint8")
    gen = torch.Generator().manual_seed(0)
    params = retrieval_head.init(gen, n, d, pq)
    params["pruned"] = pruning.build_pruned_state(params["codes"], pq.b, 512)
    if live:
        params["live"] = torch.rand(n, generator=gen) < 0.9
    phi = torch.randn((8, d), generator=gen)
    if device == "meta":
        from repro_torch.training import tree as tree_lib
        params, phi = tree_lib.to_meta(params), tree_lib.to_meta(phi)
    return params, phi, pq


PATHS = {
    "pqtopk_fused": ({}, {"pq_topk_fused": 1}),
    "pqtopk_kernel": ({}, {"pq_scores": 1}),
    "pqtopk_pruned": ({}, {"pq_scores": 1, "pq_topk_fused": 1}),
    "pqtopk_pruned grouped": ({"query_grouping": True},
                              {"pq_topk_fused_2d": 1}),
    "pqtopk_pruned live": ({"live": True},
                           {"pq_scores": 1, "pq_topk_fused_live": 1}),
    "pqtopk": ({}, {}),
}


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_recorded_launches_per_path(path, device):
    """The launches ``PERF.md``'s kernel table gives per path: a fused
    serve one form (a), the scores kernel one ``pq_scores``, a batch-any
    pruned cascade its seed's ``pq_scores`` and one 1D list, a grouped
    one a 2D table, a mutable one the ``live`` form; on meta and on the
    CPU alike."""
    opts, want = PATHS[path]
    method = path.split()[0]
    params, phi, pq = _head(device, live=opts.get("live", False))
    if opts.get("query_grouping"):
        pq = PQConfig(m=4, b=16, code_dtype="uint8", query_grouping=True,
                      n_groups=2)
    with cost.recording() as rec:
        vals, ids = retrieval_head.top_items(params, phi, 10, method=method,
                                             pq_cfg=pq)
    assert rec.launches == {f: want.get(f, 0) for f in cost.FORMS}
    assert tuple(ids.shape) == (8, 10) and ids.is_meta == (device == "meta")
    if device == "meta" and method == "pqtopk_pruned":
        assert rec.stand_ins
    assert cost.active() is None


def _patch_no_plain(monkeypatch):
    """Make the plain versions, the builds and the library loads raise."""
    def boom(*a, **k):
        raise AssertionError("a meta call reached a plain version or nvcc")
    for mod, names in ((pq_ref, ("pq_scores", "pq_topk_slots")),
                       (eb_ref, ("bag_reduce", "embedding_bag")),
                       (pq_kernel, ("_load", "build")),
                       (eb_kernel, ("_load", "build"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)


def _pq_inputs(bq=6, n=3000, m=4, b=16, dtype=torch.int16, seed=0):
    g = torch.Generator().manual_seed(seed)
    codes = torch.randint(0, b, (n, m), generator=g).to(dtype)
    s = torch.randn((bq, m, b), generator=g)
    return codes, s


FORMS = {
    "a": dict(kind="1d", live=False),
    "b": dict(kind="sentinel", live=False),
    "c": dict(kind="2d", live=False),
    "d": dict(kind="1d", live=True),
}


def _form_call(form, codes, s, live):
    n = codes.shape[0]
    tile, k = 512, 7
    t = pq_ops.n_tiles(n, tile)
    if FORMS[form]["kind"] == "2d":
        idx = torch.tensor([[0, 2, 5, -1], [1, 3, -1, -1]], dtype=torch.int32)
        return pq_ops.pq_topk_slots(codes, s, k, idx, n_items=n, tile=tile,
                                    batch_tile=4)
    idx = torch.arange(t, dtype=torch.int32)
    if FORMS[form]["kind"] == "sentinel":
        idx = torch.tensor([0, 3, -1, -1], dtype=torch.int32)
    return pq_ops.pq_topk_slots(codes, s, k, idx, n_items=n, tile=tile,
                                live=live)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_meta_branch_matches_plain_shapes(form, monkeypatch):
    """Forms (a)-(d) of the fused kernel and ``pq_scores``: meta outputs
    with the plain version's shapes and dtypes, one launch recorded under
    its form with the same work on meta and on the CPU, and neither the
    plain version nor a build reached on meta."""
    codes, s = _pq_inputs()
    live = (torch.rand(codes.shape[0]) < 0.8) if FORMS[form]["live"] \
        else None
    with cost.recording() as rec_cpu:
        want = _form_call(form, codes, s, live)
        want_s = pq_ops.pq_scores(codes, s)
    from repro_torch.training import tree as tree_lib
    mc, ms, ml = (tree_lib.meta_like(codes), tree_lib.meta_like(s),
                  tree_lib.meta_like(live))
    _patch_no_plain(monkeypatch)
    with cost.recording() as rec_meta:
        got = _form_call(form, mc, ms, ml)
        got_s = pq_ops.pq_scores(mc, ms)
    for g, w in zip(got + (got_s,), want + (want_s,)):
        assert g.is_meta and (g.shape, g.dtype) == (w.shape, w.dtype)
    assert rec_meta.launches == rec_cpu.launches
    assert rec_meta.work == rec_cpu.work
    name = {"a": "pq_topk_fused", "b": "pq_topk_fused",
            "c": "pq_topk_fused_2d", "d": "pq_topk_fused_live"}[form]
    assert rec_meta.launches[name] == 1 and rec_meta.launches["pq_scores"] == 1


@pytest.mark.parametrize("mode,weighted", [("mean", False), ("sum", False),
                                           ("sum", True)])
def test_bag_meta_branch_matches_plain(mode, weighted, monkeypatch):
    g = torch.Generator().manual_seed(1)
    table = torch.randn((300, 10), generator=g)
    idx = torch.randint(-1, 300, (13, 5), generator=g)
    w = torch.rand((13, 5), generator=g) if weighted else None
    with cost.recording() as rec_cpu:
        want = eb_ops.embedding_bag(table, idx, w, mode=mode)
    from repro_torch.training import tree as tree_lib
    _patch_no_plain(monkeypatch)
    with cost.recording() as rec_meta:
        got = eb_ops.embedding_bag(tree_lib.meta_like(table),
                                   tree_lib.meta_like(idx),
                                   tree_lib.meta_like(w), mode=mode)
    assert got.is_meta and (got.shape, got.dtype) == (want.shape, want.dtype)
    assert rec_meta.launches == rec_cpu.launches
    assert rec_meta.launches["embedding_bag"] == 1
    assert rec_meta.work == rec_cpu.work


def test_wrappers_unchanged_outside_a_recording():
    """No recorder, no record: the CPU wrappers return their plain
    versions' results as before."""
    codes, s = _pq_inputs(seed=2)
    assert cost.active() is None
    assert torch.equal(pq_ops.pq_scores(codes, s), pq_ref.pq_scores(codes, s))
    got = pq_ops.pq_topk(codes, s, 5)
    want = pq_ref.pq_topk(codes, s, 5)
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("variant", ["pruned_head", "pruned_range_head",
                                     "perquery_head", "hier_head",
                                     "mutable_head"])
def test_pruned_variants_run_on_meta_at_the_top_rung(variant, tmp_path):
    """The cascade's host reads take their largest value on meta: every
    tile survives, the top rung runs, and the artifact says so."""
    arch = cut(get_reduced("sasrec-recjpq"))
    res = dryrun.run_cell("sasrec-recjpq", "serve_users", "card", variant,
                          str(tmp_path), verbose=False, arch_override=arch)
    assert res["ok"], res.get("error")
    assert res["rung"] == "max" and res["stand_ins"]
    launches = res["kernel_launches"]
    assert sum(launches.values()) >= 1
    lm = dryrun.run_cell("qwen2.5-14b", "decode_32k", "card", "pruned_head",
                         str(tmp_path), verbose=False,
                         arch_override=cut(get_reduced("qwen2.5-14b")))
    assert lm["ok"] and lm["rung"] == "max"


def test_extrapolation_exact_for_uniform_layers_and_short_for_gemma3():
    """The reference's L=1/L=2 formula against the direct count: equal for
    qwen2.5 (every layer alike), short for gemma3's decode, whose global
    layers attend over all 16 slots where its L=1 and L=2 local layers
    have 8 (ROADMAP C13)."""
    for shape_name in ("decode_32k", "prefill_32k"):
        arch = cut(get_reduced("qwen2.5-14b"))
        direct = dryrun._measure(steps.build_step(
            "qwen2.5-14b", shape_name, arch_override=arch))
        corr = dryrun.extrapolate_lm("qwen2.5-14b", shape_name,
                                     arch_override=arch)
        assert corr["flops_per_device"] == direct["flops"]
        assert corr["bytes_per_device"] == direct["bytes"]
    arch = cut(get_reduced("qwen2.5-14b"))
    direct = dryrun._measure(steps.build_step("qwen2.5-14b", "train_4k",
                                              arch_override=arch))
    corr = dryrun.extrapolate_lm("qwen2.5-14b", "train_4k",
                                 arch_override=arch)
    assert corr["flops_per_device"] == direct["flops"]
    arch = cut(get_reduced("gemma3-27b"))
    direct = dryrun._measure(steps.build_step("gemma3-27b", "decode_32k",
                                              arch_override=arch))
    corr = dryrun.extrapolate_lm("gemma3-27b", "decode_32k",
                                 arch_override=arch)
    assert corr["flops_per_device"] < direct["flops"]
    assert corr["bytes_per_device"] < direct["bytes"]
    print(f"gemma3 reduced decode: extrapolated flops "
          f"{corr['flops_per_device']} of {direct['flops']}, bytes "
          f"{corr['bytes_per_device']} of {direct['bytes']}")


def test_peak_tracker_on_a_hand_reckoned_chain():
    """x (1024, 1024) and w1, w2 arguments; h = x @ w1, y = h @ w2, loss =
    y.sum(), then the gradients of w1 and w2.  When dw1 is made, h, y,
    dh = dy @ w2^T, dw2 = h^T @ dy and dw1 are live (4 MiB each; dy is a
    view of the ones autograd seeds the backward with), and so are loss
    and that seed (4 bytes each): 5 * 4 MiB + 8 bytes.  A view of h
    counts once."""
    def step(x, w1, w2):
        h = x @ w1
        view = h[:, :512]
        y = h @ w2
        loss = y.sum()
        g1, g2 = torch.autograd.grad(loss, (w1, w2))
        return view, g1, g2

    args = [torch.empty((1024, 1024), device="meta") for _ in range(3)]
    args[1].requires_grad_(True)
    args[2].requires_grad_(True)
    bundle = steps.StepBundle("chain", step, tuple(args), (), (), None, {})
    m = dryrun._measure(bundle)
    assert m["peak_bytes"] == 5 * 4 * 1024 * 1024 + 8
    # Arguments read once and outputs written once: x, w1, w2; h (under
    # its view), g1 and g2.
    assert m["min_bytes"] == 6 * 4 * 1024 * 1024
    # Five products: h, y; then dh, dw2 and dw1 (x needs no gradient).
    assert m["flops_by_dtype"] == {"float32": 5 * 2 * 1024 ** 3}


def test_run_cell_writes_the_reference_keys(tmp_path):
    arch = cut(get_reduced("qwen2.5-14b"))
    res = dryrun.run_cell("qwen2.5-14b", "decode_32k", "card", "fused_head",
                          str(tmp_path), verbose=False, arch_override=arch)
    assert res["ok"], res.get("error")
    on_disk = json.loads((tmp_path / "qwen2.5-14b__decode_32k__card__"
                                      "fused_head.json").read_text())
    assert REF_KEYS | {"corrected", "fits_one_card"} <= set(on_disk)
    assert set(on_disk["memory"]) == MEMORY_KEYS
    assert on_disk["memory"]["generated_code_size_in_bytes"] is None
    assert on_disk["mesh"] == "card" and on_disk["collectives"] == {}
    assert on_disk["roofline"]["collective_s"] == 0.0
    assert on_disk["kernel_launches"]["pq_topk_fused"] == 1
    assert on_disk["memory"]["alias_size_in_bytes"] > 0   # caches donated
    assert on_disk["fits_one_card"] is True
    assert on_disk["flops_per_device"] == sum(
        on_disk["flops_by_dtype"].values())


def test_roofline_has_the_eager_and_the_least_traffic():
    """``bound_s`` divides the eager step's traffic, ``min_bound_s`` the
    arguments read once and the fresh outputs written once.  A decode
    step's eager traffic is above the least: it copies the caches' slices
    to float32."""
    bundle = _bundle("qwen2.5-14b", "decode_32k", "fused_head", "meta")
    m = dryrun._measure(bundle)
    args_b = dryrun.storage_bytes(list(bundle.args))
    assert args_b <= m["min_bytes"] <= args_b + m["output_bytes"]
    roof = dryrun.roofline(m["flops_by_dtype"], m["bytes"], m["kernel_ops"],
                           m["min_bytes"])
    assert roof["memory_s"] == m["bytes"] / dryrun.HBM_BW
    assert roof["min_memory_s"] == m["min_bytes"] / dryrun.HBM_BW
    assert roof["memory_s"] > roof["min_memory_s"]
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"],
                                  roof["kernel_ops_s"])
    assert roof["min_bound_s"] == max(roof["compute_s"],
                                      roof["min_memory_s"],
                                      roof["kernel_ops_s"])
    assert roof["bound_by"] == roof["min_bound_by"] == "memory"


def test_run_cell_records_a_failure(tmp_path):
    res = dryrun.run_cell("qwen2.5-14b", "long_500k", "card", "baseline",
                          str(tmp_path), verbose=False)
    assert res["ok"] is False
    assert res["error"].startswith("ValueError")
    assert "documented skip" in res["error"] and "traceback" in res
    assert json.loads((tmp_path / "qwen2.5-14b__long_500k__card__"
                                   "baseline.json").read_text())["ok"] is False


def test_main_runs_then_skips_a_cached_cell(tmp_path, capsys):
    argv = ["--arch", "fm", "--shape", "retrieval_cand", "--variant",
            "fused_head", "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    assert "done: 1 ok, 0 failed, 0 cached" in capsys.readouterr().out
    assert dryrun.main(argv) == 0
    assert "done: 0 ok, 0 failed, 1 cached" in capsys.readouterr().out


def test_meshes_and_mesh_variants_run(tmp_path, capsys):
    """``--mesh single|multi|both`` and the mesh variants run; the default
    matrix is still the 40 card cells; ``--save-hlo`` and an unknown
    mesh are refused."""
    for mesh in ("single", "multi"):
        cells = list(dryrun.iter_cells(meshes=(mesh,)))
        assert len(cells) == 40 and {c[2] for c in cells} == {mesh}
    argv = ["--arch", "fm", "--shape", "retrieval_cand", "--out",
            str(tmp_path)]
    assert dryrun.main(argv + ["--mesh", "both"]) == 0
    assert "done: 2 ok, 0 failed, 0 cached" in capsys.readouterr().out
    assert dryrun.main(argv + ["--mesh", "multi", "--variant",
                               "vocab_tp"]) == 0
    assert "done: 1 ok, 0 failed, 0 cached" in capsys.readouterr().out
    rec = json.loads((tmp_path / "fm__retrieval_cand__multi__vocab_tp.json"
                      ).read_text())
    assert rec["ok"] and rec["devices"] == 512
    assert rec["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    # The partitioned step's per-device counts, in the reference's keys.
    for key in ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "fits_card",
                "collectives_by_axis", "unruled_ops",
                "replicated_retries"):
        assert rec[key] is not None, key
    assert "per_device_note" not in rec
    assert set(rec["collectives"]) <= set(dryrun.COLL_KINDS)
    assert {"temp_size_in_bytes", "output_size_in_bytes"} <= {
        k for k, v in rec["memory"].items() if v is not None}
    assert rec["roofline"]["collective_s"] >= 0
    with pytest.raises(SystemExit):
        dryrun.main(["--save-hlo", "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="mesh"):
        list(dryrun.iter_cells(meshes=("pods",)))
    cells = list(dryrun.iter_cells())
    assert len(cells) == 40 and {c[2] for c in cells} == {"card"}


#: XLA's per-device ``argument_size_in_bytes`` in the reference's
#: committed records (``benchmarks/artifacts/dryrun/<name>.json``).
REFERENCE_ARGUMENT_BYTES = {
    "qwen2.5-14b__decode_32k__multi__pruned_head": 1_726_517_012,
    "qwen2.5-14b__decode_32k__single__pruned_head": 3_337_129_764,
    "sasrec-recjpq__serve_users__multi__baseline": 22_662_512,
    "sasrec-recjpq__serve_users__multi__mutable_head": 24_252_103,
    "sasrec-recjpq__serve_users__multi__perquery_head": 22_980_464,
    "sasrec-recjpq__serve_users__multi__pruned_head": 22_980_464,
    "sasrec-recjpq__serve_users__multi__pruned_range_head": 22_682_384,
    "sasrec-recjpq__serve_users__multi__sharded_pruned": 22_662_512,
    "sasrec-recjpq__serve_users__multi__sharded_pruned_range": 22_662_512,
    "sasrec-recjpq__serve_users__single__baseline": 22_713_712,
    "sasrec-recjpq__serve_users__single__mutable_head": 24_303_303,
    "sasrec-recjpq__serve_users__single__perquery_head": 23_031_664,
    "sasrec-recjpq__serve_users__single__pruned_head": 23_031_664,
    "sasrec-recjpq__serve_users__single__pruned_range_head": 22_733_584,
    "sasrec-recjpq__serve_users__single__sharded_pruned": 22_713_712,
    "sasrec-recjpq__serve_users__single__sharded_pruned_range": 22_713_712,
}
#: The arguments those steps hold but never read, per device: the flat
#: bitmask metadata (621, 8, 16) uint32 that ``pqtopk`` and the sharded
#: cascade's shard-aligned rebuild leave alone; the flat range metadata
#: (621 tiles x 8 x int16 min and max); qwen2.5's dense ``head.w``
#: (5120, 152064) bf16 over (data, model), which the pruned head skips.
#: The leaves of each step's output: sasrec-recjpq's top-k (ids, values);
#: qwen2.5's decode also returns its k and v caches.
OUTPUT_LEAVES = {"sasrec-recjpq": 2, "qwen2.5-14b": 4}
UNREAD_BYTES = {("sasrec-recjpq", "baseline"): 317_952,
                ("sasrec-recjpq", "sharded_pruned"): 317_952,
                ("sasrec-recjpq", "sharded_pruned_range"): 19_872,
                ("qwen2.5-14b", "pruned_head"): 6_082_560}


@pytest.mark.parametrize("record", sorted(REFERENCE_ARGUMENT_BYTES))
def test_mesh_argument_bytes_equal_xla(record, tmp_path):
    """The port's per-device bytes of the arguments its step reads equal
    XLA's ``argument_size_in_bytes`` to the byte, on both production
    meshes at full width; the unread arguments are exactly the ones XLA
    drops.  The mesh record's keys: the whole step's counts under
    ``step_total``, and the partitioned step's per-device counts filled
    (one device's share of the flops, its collectives in the reference's
    format, its peak and outputs)."""
    import os
    arch_id, shape_name, mesh, variant = record.split("__")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmarks", "artifacts", "dryrun",
                           record + ".json")) as f:
        xla_mem = json.load(f)["memory"]
    xla = xla_mem["argument_size_in_bytes"]
    assert xla == REFERENCE_ARGUMENT_BYTES[record]
    res = dryrun.run_cell(arch_id, shape_name, mesh, variant, str(tmp_path),
                          verbose=False)
    assert res["ok"], res.get("error")
    mem = res["memory"]
    assert mem["argument_size_in_bytes"] == xla
    assert mem["state_size_in_bytes"] - xla == UNREAD_BYTES.get(
        (arch_id, variant), 0)
    assert set(mem) == MEMORY_KEYS
    assert (mem["alias_size_in_bytes"] > 0) == ("decode" in shape_name)
    assert res["devices"] == (512 if mesh == "multi" else 256)
    assert res["state_fits_card"] is True
    assert "per_device_note" not in res
    assert 0 < res["flops_per_device"] < res["step_total"]["flops"]
    assert 0 < res["bytes_per_device"] < res["step_total"]["bytes"]
    assert mem["temp_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    # XLA's output buffer holds the outputs and its tuple's table, 8 bytes
    # a leaf.  The baseline's plain top-k stays split over the batch axes
    # in the port; XLA's, after it gathers the whole score matrix, is
    # replicated.
    table = 8 * OUTPUT_LEAVES[arch_id]
    split = (res["devices"] // res["mesh_shape"]["model"]
             if variant == "baseline" else 1)
    assert mem["output_size_in_bytes"] * split == \
        xla_mem["output_size_in_bytes"] - table
    assert set(res["collectives"]) <= set(dryrun.COLL_KINDS)
    assert res["collective_bytes_per_device"] == sum(
        v["bytes"] for v in res["collectives"].values()) > 0
    assert res["roofline"]["collective_s"] > 0
    assert res["fits_card"] is True
    assert res["unruled_ops"] == {}
    assert res["step_total"]["flops"] > 0
    # One pruned seed's pq_scores per cascade, one per model shard in a
    # sharded one; none in pqtopk or the grouped cascade.
    assert res["kernel_launches"]["pq_scores"] == {
        "baseline": 0, "perquery_head": 0, "sharded_pruned": 16,
        "sharded_pruned_range": 16}.get(variant, 1)


@pytest.mark.parametrize("work,ms,by", [
    # PERF.md's kernel table: the main path (B=64, N=1,271,638, m=8,
    # b=512, uint16, k=16) and the LM and MoE vocabulary heads (B=128,
    # m=8, b=256, int32, k=64).
    (cost.pq_scores_work(1_271_638, 8, 2, 64, 512), 0.1036, "bytes"),
    (cost.pq_topk_fused_work(1_271_638, 8, 2, 64, 512, 16, 621, 1, 2048,
                             False), 0.0778, "operations"),
    (cost.pq_scores_work(262_144, 8, 4, 128, 256), 0.0429, "bytes"),
    (cost.pq_topk_fused_work(262_144, 8, 4, 128, 256, 64, 128, 1, 2048,
                             False), 0.0321, "operations"),
    (cost.pq_scores_work(151_936, 8, 4, 128, 256), 0.0250, "bytes"),
    (cost.pq_topk_fused_work(151_936, 8, 4, 128, 256, 64, 75, 1, 2048,
                             False), 0.0186, "operations"),
])
def test_cost_formula_gives_the_kernel_tables_bounds(work, ms, by):
    got, got_by, _ = cost.bound_ms(work.bytes, work.adds, work.lookups,
                                   cost.H100_SMS)
    assert round(got, 4) == ms and got_by == by
