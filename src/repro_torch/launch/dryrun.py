"""Dry run: run every (arch x shape) cell's step once on meta tensors (no
storage), count what it does, and write one JSON artifact per cell -- the
reference's ``launch/dryrun.py``, on one card (``--mesh card``) or over
the production meshes (``single``: (data=16, model=16); ``multi``:
(pod=2, data=16, model=16)) with every position on ``"meta"``.

Where the reference lowers and compiles with XLA and reads its cost and
memory analyses, this runs the eager step under :class:`StepCounter`, a
dispatch mode that counts every aten op:

* flops: ``torch.utils.flop_counter``'s formulas (the products), by the
  product's dtype;
* bytes: each op's tensor inputs and outputs (a view adds nothing; an
  in-place op's aliased output adds nothing);
* kernel launches and their work, from the kernel wrappers' record
  (:mod:`repro_torch.kernels.cost`): their bytes join ``bytes_per_device``
  and their adds and lookups stand under a key of their own;
* memory: the arguments, outputs and donated arguments, and the peak of
  the bytes the step allocates and still holds (each storage once,
  whatever its views; a tensor autograd saved for backward stays live);
* which arguments the step reads: an argument is read when an op that
  is not a view and not a shape-only factory (``zeros_like`` and kin), or
  a kernel launch, takes it or a view of it.  An argument consulted only
  for its shape or dtype is unread, as XLA drops it (``jit``'s
  ``keep_unused=False``).

Every record's ``memory`` has ``argument_size_in_bytes``, the bytes of
the arguments the step reads (XLA's convention), and
``state_size_in_bytes``, those of every argument; over a mesh both are
per device, each argument's shard under its ``in_shardings``.  A card
record's counts are the device's.  A mesh record holds the whole step's
counts under ``step_total`` (the single controller runs the step on whole
tensors); the partitioned step's per-device flops, bytes and peak and its
collectives wait for ROADMAP A 6c-2 (:data:`PER_DEVICE_NOTE`), so those
keys are ``null``.

The roofline divides by the H100 SXM's data-sheet peaks (989 TFLOP/s
bf16 dense, 67 TFLOP/s float32 outside the tensor cores -- the port runs
float32 with TF32 off -- and 3.35 TB/s of HBM, at 700 W).  It has two
memory terms: ``memory_s``, the eager step's traffic (every op's inputs
and outputs, so every copy the port's op sequence makes, needed or not),
and ``min_memory_s``, the step's arguments read once and its fresh
outputs written once, which no op sequence changes.  ``bound_s`` takes
the first and ``min_bound_s`` the second; one card has no collectives
(``collective_s`` 0).  A host read of a meta tensor (the pruned cascade's
survivor counts, ROADMAP D1) takes the largest value the shapes allow,
and the artifact says ``"rung": "max"``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # 40 cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch sasrec-recjpq \\
      --shape serve_users --variant fused_head
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both \\
      --workers 6                                  # 80 mesh records
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
import traceback
import weakref
from collections import defaultdict
from dataclasses import replace
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import get_config, list_archs
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import cost
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.training import tree as tree_lib

#: H100 SXM peaks, NVIDIA data sheet (dense, 700 W).
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = cost.HBM_BYTES_PER_S
CARD_HBM_BYTES = 80e9               # the data sheet's 80 GB
DEFAULT_OUT = "artifacts/dryrun_torch"
MESHES = ("card", "single", "multi")
PER_DEVICE_NOTE = ("the partitioned step's per-device flops, bytes, peak "
                   "and collectives wait for ROADMAP A 6c-2; step_total "
                   "holds the whole step's counts")
#: Ops that take a tensor for its shape, dtype and device only.
_SHAPE_ONLY = frozenset(
    getattr(torch.ops.aten, n) for n in (
        "empty_like", "zeros_like", "ones_like", "full_like", "rand_like",
        "randn_like", "randint_like", "new_empty", "new_empty_strided",
        "new_zeros", "new_ones", "new_full"))


def _flat_tensors(seq) -> list:
    """The tensors of an op's arguments or outputs (lists one deep, as
    aten passes them)."""
    out = []
    for a in seq:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (tuple, list)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage while it lives (its address; a
    storage's Python object may be made anew at each call, so its ``id``
    may be reused)."""
    return t.untyped_storage()._cdata


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree`` (a tree of the port's
    nodes, :class:`PrunedHeadState` included)."""
    seen = {}
    for t in tree_lib.leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


class StepCounter(TorchDispatchMode):
    """Counts flops (by dtype), bytes and peak live bytes of the aten ops
    run under it, and the kernel launches of ``recorder`` (whose wrappers'
    own ops it leaves out)."""

    def __init__(self, recorder: cost.Recorder):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.rec = recorder
        recorder.on_launch = self._on_launch
        self.flops: Dict[str, int] = defaultdict(int)
        self.bytes = 0
        self.kernel_bytes = 0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._live: Dict[int, int] = {}
        self._refs: Dict[int, Any] = {}
        self.read: set = set()          # storages ops read (storage_key)

    def _free(self, key, _ref):
        self.live -= self._live.pop(key, 0)
        self._refs.pop(key, None)

    def _track(self, tensors):
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self._refs[key] = weakref.ref(st, functools.partial(self._free,
                                                                key))
            self.live += n
        self.peak = max(self.peak, self.live)

    def _on_launch(self, name, work, outputs, reads=()):
        self.kernel_bytes += work.bytes
        self.read.update(storage_key(t) for t in reads)
        self._track(_flat_tensors(
            outputs if isinstance(outputs, tuple) else (outputs,)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _flat_tensors(args)
        if kwargs:
            ins += _flat_tensors(kwargs.values())
        if not func.is_view and func.overloadpacket not in _SHAPE_ONLY:
            self.read.update(storage_key(t) for t in ins)
        if self.rec.hidden:
            return out
        self.n_ops += 1
        outs = ([out] if isinstance(out, torch.Tensor)
                else _flat_tensors(out) if isinstance(out, (tuple, list))
                else [])
        in_st = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs if id(t.untyped_storage()) not in in_st]
        if func._schema.is_mutable or fresh:
            self.bytes += sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t in fresh)
        formula = self._flop_registry.get(func.overloadpacket)
        if formula is not None and ins:
            self.flops[str(ins[0].dtype).replace("torch.", "")] += int(
                formula(*args, **kwargs, out_val=out))
        self._track(fresh)
        return out


def _measure(bundle) -> Dict[str, Any]:
    """Run ``bundle.step_fn(*bundle.args)`` once, under its activation
    plan, inside a :class:`StepCounter` -> its counts, the step's outputs'
    bytes, the storages of the arguments it read and the run's
    seconds."""
    with cost.recording() as rec:
        counter = StepCounter(rec)
        t0 = time.perf_counter()
        with shd.activation_plan(bundle.plan), counter:
            out = bundle.step_fn(*bundle.args)
        secs = time.perf_counter() - t0
    kern = rec.totals()
    outs = list(out) if isinstance(out, tuple) else out
    return {
        "flops_by_dtype": dict(counter.flops),
        "flops": sum(counter.flops.values()),
        "bytes": counter.bytes + counter.kernel_bytes,
        "aten_bytes": counter.bytes,
        "kernel_bytes": counter.kernel_bytes,
        "kernel_ops": {"adds": kern["adds"], "lookups": kern["lookups"]},
        "launches": dict(rec.launches),
        "stand_ins": sorted(set(rec.stand_ins)),
        "peak_bytes": counter.peak,
        "aten_ops": counter.n_ops,
        "output_bytes": storage_bytes(outs),
        "min_bytes": storage_bytes([list(bundle.args), outs]),   # each once
        "read_storages": counter.read,
        "seconds": secs,
    }


def shard_bytes(t: torch.Tensor, sharding) -> int:
    """Bytes of ``t``'s block on one device under ``sharding``: a
    :class:`~repro_torch.distributed.sharding.NamedSharding` divides each
    dimension by the sizes of the mesh axes its spec names (the builders'
    specs divide their dimensions); a device holds all of its storage."""
    if not isinstance(sharding, shd.NamedSharding):
        return t.untyped_storage().nbytes()
    n = _nbytes(t)
    for entry in sharding.spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                n //= sharding.mesh.shape[ax]
    return n


def argument_bytes(bundle, read_storages) -> Dict[str, int]:
    """Per device: ``argument_size_in_bytes``, the shards of the arguments
    the step read (XLA's convention: an unread argument is dropped);
    ``state_size_in_bytes``, those of every argument; and
    ``alias_size_in_bytes``, those of the donated arguments.  An argument
    counts once however many of its leaves share its storage."""
    out = {"argument_size_in_bytes": 0, "state_size_in_bytes": 0,
           "alias_size_in_bytes": 0}
    seen = set()
    for i, (arg, shards) in enumerate(zip(bundle.args,
                                          bundle.in_shardings)):
        leaves = tree_lib.leaves(arg)
        shard_leaves = ([shards] * len(leaves)
                        if isinstance(shards, torch.device)
                        else tree_lib.leaves(shards))
        if len(shard_leaves) != len(leaves):
            raise ValueError(f"argument {i} of {bundle.name}: "
                             f"{len(leaves)} leaves, {len(shard_leaves)} "
                             "shardings")
        for t, sh in zip(leaves, shard_leaves):
            key = storage_key(t)
            if key in seen:
                continue
            seen.add(key)
            n = shard_bytes(t, sh)
            out["state_size_in_bytes"] += n
            out["argument_size_in_bytes"] += n if key in read_storages \
                else 0
            out["alias_size_in_bytes"] += n if i in bundle.donate else 0
    return out


def roofline(flops_by_dtype: Dict[str, int], nbytes: float,
             kernel_ops: Dict[str, int], min_bytes: float,
             n_sms: int = cost.H100_SMS) -> Dict[str, Any]:
    """Seconds at the H100's peaks: products by dtype, the kernels' adds
    and S lookups (the slower of the two), and HBM bytes twice -- the eager
    step's traffic ``nbytes`` and ``min_bytes``, the arguments read once
    and the fresh outputs written once.  ``bound_s`` takes the first and
    ``min_bound_s`` the second, which does not grow with the copies the
    op sequence makes."""
    compute = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
                  for dt, f in flops_by_dtype.items())
    _, _, terms = cost.bound_ms(0, kernel_ops["adds"], kernel_ops["lookups"],
                                n_sms)
    out = {"compute_s": compute, "memory_s": nbytes / HBM_BW,
           "min_memory_s": min_bytes / HBM_BW,
           "kernel_ops_s": max(terms["adds"], terms["lookups"]) / 1e3,
           "collective_s": 0.0}
    for pre, mem in (("", "memory_s"), ("min_", "min_memory_s")):
        cand = {k: out[k] for k in ("compute_s", mem, "kernel_ops_s")}
        out[pre + "bound_by"] = max(cand, key=cand.get).removesuffix(
            "_s").removeprefix("min_")
        out[pre + "bound_s"] = max(cand.values())
    return out


def extrapolate_lm(arch_id: str, shape_name: str, device="meta",
                   variant: str = "baseline", arch_override=None):
    """The reference's scan correction: count the cell at n_layers=1 and
    2 (``scan_layers=False``), then

       per_layer = f(2) - f(1);  outside = f(1) - per_layer
       total     = outside + per_layer * L

    The eager count has no scan to undercount, so the direct count is
    exact at any depth; this is kept beside it to compare with the
    reference's artifacts.  It equals the direct count where every layer
    does the same work, and misses gemma3's global layers (its L=1 and
    L=2 are both local; ROADMAP C13)."""
    arch = arch_override if arch_override is not None else get_config(
        arch_id)
    cfg = arch.model
    per = {}
    for n_layers in (1, 2):
        sub = replace(arch, model=replace(cfg, n_layers=n_layers,
                                          scan_layers=False))
        bundle = steps.build_step(arch_id, shape_name, device, variant,
                                  arch_override=sub)
        m = _measure(bundle)
        per[n_layers] = (m["flops"], m["bytes"])
    (f1, b1), (f2, b2) = per[1], per[2]
    L = cfg.n_layers
    return {
        "flops_per_device": (f1 - (f2 - f1)) + (f2 - f1) * L,
        "bytes_per_device": (b1 - (b2 - b1)) + (b2 - b1) * L,
        "collective_bytes_per_device": 0,
        "per_layer": {"flops": f2 - f1, "bytes": b2 - b1,
                      "collective_bytes": 0},
        "outside": {"flops": f1 - (f2 - f1), "bytes": b1 - (b2 - b1),
                    "collective_bytes": 0},
    }


def mesh_for(mesh_kind: str):
    """``"card"`` -> the one-device bundle's device (meta); ``"single"`` /
    ``"multi"`` -> the production mesh with every position on meta."""
    if mesh_kind not in MESHES:
        raise ValueError(f"mesh {mesh_kind!r}: one of {MESHES}")
    if mesh_kind == "card":
        return "meta"
    multi = mesh_kind == "multi"
    return make_production_mesh(multi_pod=multi,
                                devices=["meta"] * (512 if multi else 256))


def run_cell(arch_id: str, shape_name: str, mesh_kind: str = "card",
             variant: str = "baseline", out_dir: str = DEFAULT_OUT, *,
             verbose: bool = True, arch_override=None) -> Dict[str, Any]:
    """Build the cell's bundle on meta (one card, or the ``single`` or
    ``multi`` production mesh), count one run of its step, write
    ``<arch>__<shape>__<mesh>__<variant>.json`` to ``out_dir`` and return
    it.  A failure is recorded in the artifact (``error``, ``traceback``),
    not raised."""
    result: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
        "variant": variant, "devices": 1, "ok": False,
    }
    t0 = time.perf_counter()
    try:
        where = mesh_for(mesh_kind)
        if mesh_kind != "card":
            result["devices"] = where.size
            result["mesh_shape"] = dict(where.shape)
        bundle = steps.build_step(arch_id, shape_name, where, variant,
                                  arch_override=arch_override)
        t_lower = time.perf_counter() - t0
        m = _measure(bundle)
        args = argument_bytes(bundle, m["read_storages"])
        result.update({"ok": True, "lower_s": round(t_lower, 2),
                       "compile_s": round(m["seconds"], 2)})
        if mesh_kind == "card":
            state = args["state_size_in_bytes"]
            result.update({
                "memory": {**args,
                           "output_size_in_bytes": m["output_bytes"],
                           "temp_size_in_bytes": m["peak_bytes"],
                           "generated_code_size_in_bytes": None},
                "fits_one_card": state + m["peak_bytes"] <= CARD_HBM_BYTES,
                "flops_per_device": m["flops"],
                "flops_by_dtype": m["flops_by_dtype"],
                "bytes_per_device": m["bytes"],
                "aten_bytes_per_device": m["aten_bytes"],
                "kernel_bytes_per_device": m["kernel_bytes"],
                "kernel_ops_per_device": m["kernel_ops"],
                "kernel_launches": m["launches"],
                "aten_ops": m["aten_ops"],
                "collectives": {},
                "collective_bytes_per_device": 0,
            })
        else:
            result.update({
                "memory": {**args, "output_size_in_bytes": None,
                           "temp_size_in_bytes": None,
                           "generated_code_size_in_bytes": None},
                "state_fits_card": args["state_size_in_bytes"]
                <= CARD_HBM_BYTES,
                "step_total": {
                    "flops": m["flops"],
                    "flops_by_dtype": m["flops_by_dtype"],
                    "bytes": m["bytes"], "aten_bytes": m["aten_bytes"],
                    "kernel_bytes": m["kernel_bytes"],
                    "kernel_ops": m["kernel_ops"],
                    "peak_bytes": m["peak_bytes"],
                    "output_bytes": m["output_bytes"],
                    "aten_ops": m["aten_ops"]},
                "kernel_launches": m["launches"],
                "flops_per_device": None, "bytes_per_device": None,
                "collectives": None, "collective_bytes_per_device": None,
                "roofline": None, "per_device_note": PER_DEVICE_NOTE,
            })
        result["meta"] = bundle.meta
        if m["stand_ins"]:
            result["rung"] = "max"
            result["stand_ins"] = m["stand_ins"]
        if mesh_kind == "card":
            if bundle.meta.get("family") == "lm":
                result["corrected"] = extrapolate_lm(
                    arch_id, shape_name, "meta", variant,
                    arch_override=arch_override)
            result["roofline"] = roofline(m["flops_by_dtype"], m["bytes"],
                                          m["kernel_ops"], m["min_bytes"])
        if verbose:
            print(f"--- {arch_id} / {shape_name} / {mesh_kind} / {variant}")
            print({k: result.get(k) for k in (
                "memory", "flops_by_dtype", "bytes_per_device",
                "step_total", "kernel_launches") if k in result})
    except Exception as e:  # noqa: BLE001 -- record the failure
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = (traceback.format_exc()[-4000:]
                               .replace(repo_root + os.sep, ""))
        if verbose:
            print(f"FAILED {arch_id}/{shape_name}/{mesh_kind}: "
                  f"{result['error']}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{arch_id}__{shape_name}__{mesh_kind}__{variant}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def iter_cells(archs=None, shapes=None, meshes=("card",)):
    for mesh_kind in meshes:
        if mesh_kind not in MESHES:
            raise ValueError(f"mesh {mesh_kind!r}: one of {MESHES}")
    for arch_id in (archs or list_archs()):
        cfg = get_config(arch_id)
        for sh in cfg.active_shapes():
            if shapes and sh.name not in shapes:
                continue
            for mesh_kind in meshes:
                yield arch_id, sh.name, mesh_kind


def _cost_rank(cell) -> int:
    """Cells that take longest on meta first: LM train and prefill, and a
    grouped cascade (its queries grouped in a Python loop, ROADMAP D2)."""
    arch_id, shape_name = cell[0], cell[1]
    if "perquery" in cell[-1]:
        return 0
    kind = get_config(arch_id).shape(shape_name).kind
    return {"train": 0, "prefill": 1}.get(kind, 2) \
        if get_config(arch_id).family == "lm" else 3


def run_matrix(cells, out_dir: str = DEFAULT_OUT, variant: str = "baseline",
               workers: int = 1):
    """:func:`run_cell` for each ``(arch, shape, mesh)`` of ``cells`` (or
    ``(arch, shape, mesh, variant)``, which overrides ``variant``), in
    ``workers`` processes (spawned: each imports torch afresh and touches
    no card), longest first -> the artifacts in ``cells``' order."""
    cells = [tuple(c) + (variant,) * (4 - len(c)) for c in cells]
    if workers <= 1:
        return [run_cell(*c, out_dir, verbose=False) for c in cells]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    order = sorted(range(len(cells)), key=lambda i: _cost_rank(cells[i]))
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=sys.path.insert, initargs=(0, src)) as pool:
        futs = {i: pool.submit(run_cell, *cells[i], out_dir, verbose=False)
                for i in order}
        return [futs[i].result() for i in range(len(cells))]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=MESHES + ("both",), default="card",
                    help="one card (the default), the (data=16, model=16) "
                         "mesh 'single', the (pod=2, data=16, model=16) "
                         "mesh 'multi', or 'both' meshes")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: an eager step has no HLO")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes that run cells at once (meta only)")
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo has no counterpart: the port runs eagerly and "
                 "lowers nothing")
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)

    todo, n_skip = [], 0
    for cell in iter_cells(args.arch, args.shape, meshes):
        path = os.path.join(args.out, "__".join(cell + (args.variant,))
                            + ".json")
        if not args.force and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("ok"):
                    n_skip += 1
                    continue
        todo.append(cell)
    n_ok = n_fail = 0
    for (arch_id, shape_name, mesh_kind), res in zip(
            todo, run_matrix(todo, args.out, args.variant, args.workers)):
        n_ok += int(res["ok"])
        n_fail += int(not res["ok"])
        status = "OK" if res["ok"] else "FAIL"
        print(f"[{status}] {arch_id:20s} {shape_name:14s} {mesh_kind:6s} "
              f"compile={res.get('compile_s', '-')}s")
    print(f"done: {n_ok} ok, {n_fail} failed, {n_skip} cached")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
