"""The partitioned count of the port's dry run (``launch/dryrun.py:
PartitionCounter``): one device's share of a step over a mesh, with the
collectives its placements need, on meta at small size.

Hand-reckoned steps (a column- then row-parallel MLP, a constraint point,
an op without a sharding rule) pin the rules; the data-axis oracle holds a
data-parallel step's per-device count to the one-device count of its
share of the batch; the item-sharded serve's merge and the LM's mesh
``corrected`` block are held to what they must be.

XLA is the oracle where GSPMD has one answer: the module fixture ``xla``
runs this file as a script in a child process with 8 CPU devices
(``test_torch_mesh_training.run_oracle``), where the reference compiles
the MLP, the constraint and the reduced sasrec-recjpq train step on the
same meshes and reads the collectives out of the partitioned HLO with
its own ``parse_collectives``.  A pinned record (the reduced 2-layer
qwen2.5 train step on (data=2, model=2)) makes a change of torch's
propagator that moves the counts fail here."""
import collections
import dataclasses
import json
import math
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_reduced
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import ShardMesh, make_mesh
from repro_torch.training import tree as tree_lib

#: The hand-reckoned steps' sizes, shared with the reference's child.
MLP = dict(b=8, d=16, f=32, mesh=(("data", 2), ("model", 4)))
CON = dict(b=8, d=6, mesh=(("data", 4), ("model", 2)))
TRAIN_B, TRAIN_SPLIT = 8, 4          # sequences per device, data positions


def _mesh(**axes):
    return ShardMesh(["meta"] * math.prod(axes.values()),
                     tuple(axes), tuple(axes.values()))


def _bundle(fn, args, specs, mesh, plan=None):
    return steps.StepBundle(
        name="hand", step_fn=fn, args=tuple(args),
        in_shardings=tuple(NamedSharding(mesh, s) for s in specs),
        donate=(), plan=plan, meta={}, mesh=mesh)


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _shaped(arch_id, shape_name, **dims):
    """The reduced config with ``shape_name``'s dims replaced (sequences
    cut to the reduced models' 16 positions)."""
    arch = get_reduced(arch_id)
    return dataclasses.replace(arch, shapes=tuple(
        dataclasses.replace(sh, dims={**sh.dims, "seq_len": 16, **dims})
        if sh.name == shape_name else sh for sh in arch.shapes))


@pytest.mark.parametrize("spec,names,want", [
    (P("data", None), ("data", "model"), ("S0", "R")),
    (P(None, "model"), ("data", "model"), ("R", "S1")),
    (P(("pod", "data"), "model"), ("pod", "data", "model"),
     ("S0", "S0", "S1")),
    (P(("data", "model"), None), ("pod", "data", "model"),
     ("R", "S0", "S0")),
    (P(), ("data", "model"), ("R", "R")),
    (P(None, None), ("pod", "data", "model"), ("R", "R", "R")),
    (torch.device("meta"), ("data", "model"), ("R", "R")),
])
def test_spec_to_placements(spec, names, want):
    """A ``P`` entry naming an axis, or a tuple of axes, splits that
    dimension over those mesh axes in the mesh's order; ``None`` and a
    device replicate."""
    got = dryrun.placements_for(spec, names)
    assert tuple("R" if p.is_replicate() else f"S{p.dim}"
                 for p in got) == want
    if isinstance(spec, tuple):
        sh = NamedSharding(_mesh(**dict.fromkeys(names, 2)), spec)
        assert dryrun.placements_for(sh, names) == got


def _mlp_bundle():
    """x (B, d) over data, W1 (d, f) split by columns and W2 (f, d) by
    rows over model, the output constrained to rows over data."""
    b, d, f = MLP["b"], MLP["d"], MLP["f"]
    mesh = _mesh(**dict(MLP["mesh"]))

    def step(x, w1, w2):
        y = torch.relu(x @ w1) @ w2
        return shd.with_sharding_constraint(y, NamedSharding(mesh,
                                                             P("data")))

    return _bundle(step, (_meta(b, d), _meta(d, f), _meta(f, d)),
                   (P("data", None), P(None, "model"), P("model", None)),
                   mesh)


def _constraint_bundle():
    """x (B, d) over data, doubled, then constrained whole."""
    mesh = _mesh(**dict(CON["mesh"]))

    def step(x):
        return shd.with_sharding_constraint(x * 2, NamedSharding(mesh, P()))

    return _bundle(step, (_meta(CON["b"], CON["d"]),), (P("data"),), mesh)


def _train_bundle(mesh, batch):
    return steps.build_step(
        "sasrec-recjpq", "train_seq", mesh, "baseline",
        arch_override=_shaped("sasrec-recjpq", "train_seq",
                              global_batch=batch))


def test_column_then_row_parallel_mlp():
    """Every device does 1/8 of the MLP's products, and the partial sums
    meet in exactly one all-reduce over model of the device's (B/2, d)
    float32 block, where the constraint asks for them whole."""
    b, d, f = MLP["b"], MLP["d"], MLP["f"]
    m = dryrun._measure(_mlp_bundle())
    dev = m["device"]
    assert m["flops"] == 2 * (2 * b * d * f)
    assert dev["flops"] * 8 == m["flops"]
    assert dev["collectives"] == {
        "all-reduce": {"count": 1, "bytes": b // 2 * d * 4}}
    assert dev["collectives_by_axis"] == {"model": dev["collectives"]}
    assert [e[3] for e in dev["events"]] == ["constraint"]
    assert dev["unruled_ops"] == {}
    # Nothing global was started: the mesh needs no process group.
    assert not torch.distributed.is_initialized()


def test_constraint_gathers_a_split_tensor():
    """A constraint point that asks for a data-split tensor whole is an
    all-gather over data of its (B, d) float32 value."""
    b, d = CON["b"], CON["d"]
    dev = dryrun._measure(_constraint_bundle())["device"]
    assert dev["collectives"] == {"all-gather": {"count": 1,
                                                 "bytes": b * d * 4}}
    assert dev["events"][0][1:] == ("data", b * d * 4, "constraint")
    assert dev["output_bytes"] == b * d * 4


def test_op_without_a_rule_is_gathered_and_listed():
    """``searchsorted`` has no sharding rule: its split input is gathered
    whole, its output replicated, and the op listed."""
    mesh = _mesh(data=4, model=2)

    def step(edges, x):
        return torch.searchsorted(edges, x)

    dev = dryrun._measure(_bundle(
        step, (_meta(64), _meta(8, 64)), (P(), P("data")), mesh))["device"]
    assert dev["unruled_ops"] == {"aten.searchsorted.Tensor": 1}
    assert dev["collectives"] == {"all-gather": {"count": 1,
                                                 "bytes": 8 * 64 * 4}}
    assert dev["output_bytes"] == 8 * 64 * 8


@pytest.mark.parametrize("shape_name,variant", [
    ("train_seq", "baseline"), ("serve_users", "fused_head")])
def test_data_axis_share_equals_the_one_device_count(shape_name, variant):
    """The data-axis oracle: a step over (data=4, model=1) at batch 4B
    does per device the flops and launches of the one-device step at B.
    A training step moves nothing but its gradients, in all-reduces over
    data of exactly the float parameters' bytes, and two float32 scalars
    (the loss's count of targets, and the loss it returns).  A serve step
    moves only the fused kernel's (4B, m, b) float32 query table, which a
    launch outside a manual region gathers as a custom call's input."""
    b = TRAIN_B
    mesh = _mesh(data=TRAIN_SPLIT, model=1)
    part = dryrun._measure(steps.build_step(
        "sasrec-recjpq", shape_name, mesh, variant,
        arch_override=_shaped("sasrec-recjpq", shape_name,
                              global_batch=TRAIN_SPLIT * b)))
    one = dryrun._measure(steps.build_step(
        "sasrec-recjpq", shape_name, "meta", variant,
        arch_override=_shaped("sasrec-recjpq", shape_name, global_batch=b)))
    dev = part["device"]
    assert dev["flops_by_dtype"] == one["flops_by_dtype"]
    assert dev["flops"] * 4 == part["flops"]
    assert dev["launches"] == one["launches"]
    assert sum(dev["launches"].values()) == (variant == "fused_head")
    if shape_name == "train_seq":
        params = steps.build_step(
            "sasrec-recjpq", shape_name, "meta", variant,
            arch_override=_shaped("sasrec-recjpq", shape_name)).args[0]
        floats = [t for t in tree_lib.leaves(params) if t.is_floating_point()]
        float_bytes = sum(t.numel() * t.element_size() for t in floats)
        assert dev["gradient_collectives"] == {"all-reduce": {
            "count": len(floats), "bytes": float_bytes}}
        assert dev["collectives"] == {"all-reduce": {
            "count": len(floats) + 2, "bytes": float_bytes + 2 * 4}}
        assert all(e[1] == "data" for e in dev["events"])
        assert sorted(e[3] for e in dev["events"]
                      if e[3] != "gradients") == ["aten.clamp.default",
                                                  "output"]
    else:
        pq = get_reduced("sasrec-recjpq").model.pq
        assert dev["events"] == [("all-gather", "data",
                                  TRAIN_SPLIT * b * pq.m * pq.b * 4,
                                  "pq_topk_fused")]
    assert dev["unruled_ops"] == dev["replicated_retries"] == {}


def test_sharded_fused_merge_gathers_scores_and_ids():
    """The item-sharded fused serve over 8 model positions: each position
    launches the fused kernel on its own rows (one launch per device),
    and the merge is one all-gather over model of the (B, 8 k) float32
    scores and one of the (B, 8 k) int32 ids."""
    b, k, s = 4, 10, 8
    mesh = make_mesh(s, ["meta"] * s)
    bundle = steps.build_step(
        "sasrec-recjpq", "serve_users", mesh, "sharded_fused",
        arch_override=_shaped("sasrec-recjpq", "serve_users",
                              global_batch=b))
    m = dryrun._measure(bundle)
    dev = m["device"]
    assert m["launches"]["pq_topk_fused"] == s
    assert dev["launches"]["pq_topk_fused"] == 1
    merge = [e for e in dev["events"] if e[3] == "all_gather"]
    assert merge == [("all-gather", "model", b * s * k * 4, "all_gather")] * 2
    assert dev["kernel_work"]["pq_topk_fused"]["bytes"] * s == \
        m["kernel_bytes"]


def test_mesh_corrected_block_from_direct_counts():
    """On a mesh the LM correction extrapolates one device's counts: its
    per-layer collective bytes are the difference of the direct counts
    at 2 and 1 layers, and at 2 layers it gives the 2-layer count."""
    mesh = _mesh(data=2, model=2)
    arch = _shaped("qwen2.5-14b", "train_4k", global_batch=4)
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, n_layers=2))
    got = dryrun.extrapolate_lm("qwen2.5-14b", "train_4k", mesh,
                                arch_override=arch)
    direct = {}
    for n in (1, 2):
        sub = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, n_layers=n, scan_layers=False))
        direct[n] = dryrun._measure(steps.build_step(
            "qwen2.5-14b", "train_4k", mesh, arch_override=sub))["device"]
    c1, c2 = (direct[n]["collective_bytes"] for n in (1, 2))
    assert got["per_layer"]["collective_bytes"] == c2 - c1 > 0
    assert got["outside"]["collective_bytes"] == c1 - (c2 - c1)
    assert got["collective_bytes_per_device"] == c2
    assert got["flops_per_device"] == direct[2]["flops"]


def test_link_rate_by_node():
    """Eight consecutive positions share a node: an axis whose groups
    stay inside one runs at NVLink's rate, any other at the network's."""
    small = _mesh(data=2, model=4)
    assert dryrun.link_bytes_per_s(small, "model") == \
        dryrun.NVLINK_BYTES_PER_S
    assert dryrun.link_bytes_per_s(small, "data") == \
        dryrun.NVLINK_BYTES_PER_S
    prod = _mesh(data=16, model=16)
    assert dryrun.link_bytes_per_s(prod, "model") == \
        dryrun.NETWORK_BYTES_PER_S
    assert dryrun.parse_collectives(
        [("all-gather", "data", 8, "x"), ("all-gather", "model", 4, "y"),
         ("all-reduce", "data", 2, "z")]) == {
            "all-gather": {"count": 2, "bytes": 12},
            "all-reduce": {"count": 1, "bytes": 2}}


@pytest.mark.parametrize("variant", ["sharded_fused", "sharded_pruned"])
def test_sharded_serve_device_work_is_position_zeros(variant):
    """Run for real on the CPU over 4 model positions, the partitioned
    count's per-device kernel launches and work equal the launches that
    model position 0 recorded (``Recorder.by_position``), as the smoke
    holds them on the card; each position launched alike."""
    from repro_torch.kernels import cost
    mesh = make_mesh(4, ["cpu"] * 4)
    b = steps.build_step("sasrec-recjpq", "serve_users", mesh, variant,
                         arch_override=_shaped("sasrec-recjpq",
                                               "serve_users",
                                               global_batch=4))
    with torch.inference_mode(), shd.activation_plan(b.plan), \
            cost.recording() as rec:
        part = dryrun.PartitionCounter(rec, mesh)
        for _, t, sh in dryrun._argument_leaves(b):
            part.seed(t, sh)
        with part:
            b.step_fn(*b.args)
    pos0 = rec.by_position[("model", 0)]
    dev = {f: {"launches": part.dev_launches[f], **w}
           for f, w in part.totals()["kernel_work"].items()}
    assert dev == pos0 and dev
    assert None not in rec.by_position
    assert all(rec.by_position[("model", i)].keys() == pos0.keys()
               for i in range(4))


# ---------------------------------------------------------------------------
# XLA as the oracle: the reference, in the child process
# ---------------------------------------------------------------------------


def _xla_main(path):
    """Compile the reference's twins of the MLP, the constraint and the
    reduced sasrec-recjpq train step on the same meshes of CPU devices
    and save, per case, ``parse_collectives`` of the partitioned HLO,
    each all-reduce's result bytes element by element (XLA combines
    all-reduces into one of a tuple) and ``output_size_in_bytes``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import NamedSharding as JNS
    from jax.sharding import PartitionSpec as JP
    from repro.configs.base import get_reduced as jget_reduced
    from repro.distributed import sharding as jshd
    from repro.launch import dryrun as jdry
    from repro.launch import steps as jsteps
    devs = np.array(jax.devices()[:8])

    def mesh_of(axes):
        names, sizes = zip(*axes)
        return Mesh(devs[:math.prod(sizes)].reshape(sizes), names)

    def record(fn, args, shardings, plan=None):
        with jshd.activation_plan(plan):
            c = jax.jit(fn, in_shardings=shardings).lower(*args).compile()
        hlo = c.as_text()
        parts = []
        for m in jdry._LINE_RE.finditer(hlo):
            if m.group(2) == "all-reduce" and m.group(3) != "-done":
                parts += [jdry._shape_bytes(f"{t}[{dims}]") for t, dims in
                          jdry._SHAPE_RE.findall(m.group(1))]
        return {"collectives": jdry.parse_collectives(hlo),
                "all_reduce_parts": parts,
                "output": c.memory_analysis().output_size_in_bytes}

    f32 = jnp.float32
    out = {}
    mesh = mesh_of(MLP["mesh"])
    b, d, f = MLP["b"], MLP["d"], MLP["f"]

    def mlp(x, w1, w2):
        y = jax.nn.relu(x @ w1) @ w2
        return jax.lax.with_sharding_constraint(y, JNS(mesh, JP("data")))

    out["mlp"] = record(
        mlp, [jax.ShapeDtypeStruct(s, f32) for s in ((b, d), (d, f), (f, d))],
        [JNS(mesh, JP(*s)) for s in (("data", None), (None, "model"),
                                     ("model", None))])
    mesh_c = mesh_of(CON["mesh"])
    out["constraint"] = record(
        lambda x: jax.lax.with_sharding_constraint(x * 2, JNS(mesh_c, JP())),
        [jax.ShapeDtypeStruct((CON["b"], CON["d"]), f32)],
        [JNS(mesh_c, JP("data"))])
    arch = jget_reduced("sasrec-recjpq")
    arch = dataclasses.replace(arch, shapes=tuple(
        dataclasses.replace(sh, dims={**sh.dims, "seq_len": 16,
                                      "global_batch": TRAIN_SPLIT * TRAIN_B})
        if sh.name == "train_seq" else sh for sh in arch.shapes))
    bundle = jsteps.build_step(
        "sasrec-recjpq", "train_seq",
        mesh_of((("data", TRAIN_SPLIT), ("model", 1))), "baseline",
        arch_override=arch)
    out["train_seq"] = record(bundle.step_fn, bundle.args,
                              bundle.in_shardings, bundle.plan)
    np.savez(path, json=np.array(json.dumps(out)))


@pytest.fixture(scope="module")
def xla(tmp_path_factory):
    from test_torch_mesh_training import run_oracle
    return json.loads(str(run_oracle(tmp_path_factory, __file__)["json"]))


@pytest.mark.parametrize("case", ["mlp", "constraint"])
def test_hand_reckoned_collectives_equal_xla(xla, case):
    """Where GSPMD has one answer, the partitioned count gives XLA's: the
    MLP's one all-reduce over model of the (B/2, d) block, the
    constraint's one all-gather over data of the (B, d) value, each with
    XLA's per-device result bytes, and XLA's output bytes."""
    bundle = {"mlp": _mlp_bundle, "constraint": _constraint_bundle}[case]()
    dev = dryrun._measure(bundle)["device"]
    assert dev["collectives"] == xla[case]["collectives"]
    assert dev["output_bytes"] == xla[case]["output"]


def test_data_parallel_train_step_against_xla(xla):
    """The reduced sasrec-recjpq train step on (data=4, model=1), held to
    XLA's collectives result by result.  Both move only all-reduces: one
    per float parameter's gradient and two float32 scalars (the loss's
    count of targets, the loss).  XLA combines them into two all-reduces
    (one of a tuple) and reduces one gradient otherwise, by choice: the
    sub-item centroids' (m, b, d/m) gradient is the sum of three
    scatter-adds (the input sequence's, the targets' and the negatives'
    lookups) per split, and XLA reduces each of those 3 m (b, d/m)
    pieces before it adds them, where the port reduces their sum once."""
    dev = dryrun._measure(_train_bundle(
        _mesh(data=TRAIN_SPLIT, model=1), TRAIN_SPLIT * TRAIN_B))["device"]
    ref = xla["train_seq"]
    assert set(dev["collectives"]) == set(ref["collectives"]) == {
        "all-reduce"}
    assert ref["collectives"]["all-reduce"]["count"] == 2
    pq = get_reduced("sasrec-recjpq").model
    piece = pq.pq.b * (pq.d_model // pq.pq.m) * 4
    port = collections.Counter(e[2] for e in dev["events"])
    xla_parts = collections.Counter(ref["all_reduce_parts"])
    assert xla_parts - port == {piece: 3 * pq.pq.m}
    assert port - xla_parts == {pq.pq.m * piece: 1}
    assert sum(ref["all_reduce_parts"]) == \
        ref["collectives"]["all-reduce"]["bytes"]


#: The reduced 2-layer qwen2.5 train step on (data=2, model=2) at batch 4,
#: counted on this CPU's torch: a change of the propagator's rules (or of
#: this count's) that moves one device's share shows here.
PINNED_LM = {
    "flops": 12_582_912,
    "collectives": {
        "all-gather": {"count": 81, "bytes": 766_464},
        "all-reduce": {"count": 25, "bytes": 8_216},
        "all-to-all": {"count": 34, "bytes": 190_592},
        "reduce-scatter": {"count": 49, "bytes": 300_672}},
    "collectives_by_axis": {
        "data": {"all-gather": {"count": 30, "bytes": 466_944},
                 "all-reduce": {"count": 9, "bytes": 1_804},
                 "all-to-all": {"count": 1, "bytes": 8_192},
                 "reduce-scatter": {"count": 9, "bytes": 139_264}},
        "model": {"all-gather": {"count": 51, "bytes": 299_520},
                  "all-reduce": {"count": 16, "bytes": 6_412},
                  "all-to-all": {"count": 33, "bytes": 182_400},
                  "reduce-scatter": {"count": 40, "bytes": 161_408}}},
    "peak_bytes": 943_012,
    "output_bytes": 447_816,
    "unruled_ops": {},
    "replicated_retries": {},
}


def test_pinned_lm_record():
    """One small LM record, pinned whole: per-device flops, collectives by
    kind and axis, peak and outputs, and the ops without a rule or
    answered only with one more axis replicated."""
    mesh = _mesh(data=2, model=2)
    arch = _shaped("qwen2.5-14b", "train_4k", global_batch=4)
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, n_layers=2))
    dev = dryrun._measure(steps.build_step(
        "qwen2.5-14b", "train_4k", mesh, arch_override=arch))["device"]
    got = {k: dev[k] for k in ("flops", "collectives", "collectives_by_axis",
                               "peak_bytes", "output_bytes", "unruled_ops",
                               "replicated_retries")}
    assert got == PINNED_LM


if __name__ == "__main__":
    _xla_main(sys.argv[1])
