"""The port's item-sharded routes (``repro_torch.core.retrieval_head``'s
``top_items_sharded`` and ``top_items_pruned_sharded``, the engine and the
fabric with ``sharded_mesh``) against the JAX reference on a 4-device CPU
mesh, bit for bit (atol=0).

The reference's sharded routes need a mesh of several devices, which JAX
makes on the CPU only when ``XLA_FLAGS`` asks for them before it starts.
So one module-scoped fixture runs this file as a script, once, in a child
process whose environment alone carries the flag; the child runs every
case through the reference (each jitted, as it serves) and writes all
outputs to one ``.npz``.  The inputs are numpy from a seed on both sides.
Scores are dyadic (multiples of 1/4 with few bits), so the sub-id score
einsum is exact in any order and the reference's S equals the port's bit
for bit.  The port runs each case on ``["cpu"] * S``.

The cases: N = 5,003 (divides by neither 2 nor 4) and 5,000; S in {1, 2,
4}, S = 2 being the first two of the four devices; every
``top_items_sharded`` method and the dense head; the pruned cascade
batch-any, grouped at B=32 (4 query groups), hierarchical (tile 256,
super factor 2) and tombstone-masked, each on both bound backends, plus
the adaptive seed and the dividing N; every stats entry.  Then the shard
layout itself, interop, the engine's calibrated ladder (computed by the
reference engine in the same child), sharded engines against the port's
flat engines, and a chaos fabric of sharded replicas.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.sharded

N_ODD, N_EVEN = 5003, 5000
M, B_SUB, DSUB, K, TILE, FACTOR = 4, 16, 8, 7, 256, 2
SHARDS = (1, 2, 4)
BACKENDS = ("bitmask", "range")
METHODS = ("pqtopk", "pqtopk_onehot", "pqtopk_kernel", "recjpq",
           "pqtopk_fused")
LADDER = (2, 4)
# top_items_sharded cases: (N, method).
PLAIN_CASES = ([(N_ODD, meth) for meth in METHODS]
               + [(N_EVEN, "pqtopk"), (N_EVEN, "pqtopk_fused"),
                  (N_EVEN, "dense")])
# Pruned cases: id -> (N, batch, scores, backend, grouped, super factor,
# tombstones, seed policy).
PRUNED_CASES = {
    **{f"flat-{be}": (N_ODD, 8, "hot", be, False, 0, False, "greedy")
       for be in BACKENDS},
    **{f"grouped-{be}": (N_ODD, 32, "mixed", be, True, 0, False, "greedy")
       for be in BACKENDS},
    **{f"hier-{be}": (N_ODD, 8, "hot", be, False, FACTOR, False, "greedy")
       for be in BACKENDS},
    **{f"live-{be}": (N_ODD, 8, "hot", be, False, 0, True, "greedy")
       for be in BACKENDS},
    "adaptive-bitmask": (N_ODD, 8, "mixed", "bitmask", False, 0, False,
                         "adaptive"),
    "even-bitmask": (N_EVEN, 8, "hot", "bitmask", False, 0, False, "greedy"),
}
# The engines' model: the reduced SASRec at 20,000 items, so that at the
# engines' max_k (2,048) a shard-aligned tile (2,048 + pad) still leaves
# several tiles a shard.
ENGINE_ITEMS, ENGINE_K, ENGINE_BATCH = 20_000, 5, 8
ENGINE_VARIANTS = {"batch-any": (False, 0), "grouped": (True, 0),
                   "super": (False, 2)}
LADDER_CASES = [(2, "batch-any"), (4, "batch-any"), (2, "grouped"),
                (4, "grouped"), (4, "super")]


def _dyadic(x):
    return (np.round(np.asarray(x) * 4) / 4).astype(np.float32)


def _inputs(n, bq, kind, seed=0):
    """Clustered codes (N, M) int32 (item i's codes near i*B_SUB/N),
    sub-embeddings (M, B_SUB, DSUB) and phi (bq, M*DSUB), both dyadic: sub-id
    j points along axis j // 2, and query q along axis 0 (``hot``: every
    query wants the lowest codes, the first items) or 2 * (q % 4)
    (``mixed``: four disjoint bands of items, a quarter of the batch
    each).  A dense table (N, M*DSUB), dyadic; ``live``: ~10%
    tombstones."""
    rng = np.random.default_rng(seed)
    centers = (np.arange(n) / n * B_SUB).astype(np.int64)
    codes = np.clip(centers[:, None] + rng.integers(-1, 2, (n, M)), 0,
                    B_SUB - 1).astype(np.int32)
    sub = 0.5 * rng.standard_normal((M, B_SUB, DSUB))
    sub[:, np.arange(B_SUB), np.arange(B_SUB) // 2] += 4.0
    win = (np.zeros(bq, np.int64) if kind == "hot"
           else np.arange(bq) % 4 * 2)
    phi = 0.5 * rng.standard_normal((bq, M, DSUB))
    phi[np.arange(bq)[:, None], np.arange(M)[None, :], win[:, None]] += 4.0
    table = _dyadic(rng.standard_normal((n, M * DSUB)))
    live = rng.random(n) > 0.1
    return (codes, _dyadic(sub), _dyadic(phi.reshape(bq, M * DSUB)), table,
            live)


def _jax_model(grouped=False, super_factor=0):
    """The engines' model in the reference's tree: its own init at
    ENGINE_ITEMS, clustered uint8 codes and sharpened sub-embeddings.
    -> (config, params)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import base as jcfg
    from repro.core import pruning as jpruning
    from repro.models import seqrec as jseqrec
    base = jcfg.get_reduced("sasrec-recjpq").model
    pq = dataclasses.replace(base.pq, query_grouping=grouped, n_groups=8,
                             super_factor=super_factor)
    cfg = dataclasses.replace(base, n_items=ENGINE_ITEMS, pq=pq)
    params = jseqrec.init_seqrec(jax.random.PRNGKey(1),
                                 dataclasses.replace(cfg, pq=base.pq))
    rng = np.random.default_rng(1)
    n = ENGINE_ITEMS + 1
    centers = (np.arange(n) / n * pq.b).astype(np.int64)
    codes = np.clip(centers[:, None] + rng.integers(-1, 2, (n, pq.m)), 0,
                    pq.b - 1).astype(pq.code_dtype)
    item = {**params["item_emb"], "codes": jnp.asarray(codes),
            "sub_emb": params["item_emb"]["sub_emb"] * 25.0}
    item["pruned"] = jpruning.with_super(jpruning.build_pruned_state(
        item["codes"], pq.b, 2048), super_factor)
    return cfg, {**params, "item_emb": item}


# ---------------------------------------------------------------------------
# the reference, in the child process
# ---------------------------------------------------------------------------


def _oracle_main(path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.base import PQConfig as JPQConfig
    from repro.core import retrieval_head as jrh
    from repro.distributed import sharding as jshd
    from repro.serving import engine as jengine
    assert len(jax.devices()) >= 4, jax.devices()
    meshes = {s: Mesh(np.array(jax.devices()[:s]), ("model",))
              for s in SHARDS}
    out = {}
    for n, method in PLAIN_CASES:
        codes, sub, phi, table, _ = _inputs(n, 8, "hot")
        params = ({"table": jnp.asarray(table)} if method == "dense" else
                  {"codes": jnp.asarray(codes), "sub_emb": jnp.asarray(sub)})
        for s, mesh in meshes.items():
            fn = jax.jit(lambda p, x, mesh=mesh, method=method:
                         jrh.top_items_sharded(p, x, K, mesh, method=method))
            v, i = fn(params, jnp.asarray(phi))
            out[f"plain/{n}/{method}/{s}/v"] = np.asarray(v)
            out[f"plain/{n}/{method}/{s}/i"] = np.asarray(i)
    for cid, (n, bq, kind, be, grouped, sf, dead, policy) in \
            PRUNED_CASES.items():
        codes, sub, phi, _, live = _inputs(n, bq, kind)
        params = {"codes": jnp.asarray(codes), "sub_emb": jnp.asarray(sub)}
        if dead:
            params["live"] = jnp.asarray(live)
        cfg = JPQConfig(m=M, b=B_SUB, bound_backend=be, query_grouping=grouped,
                        n_groups=8, seed_policy=policy, seed_max_tiles=8)
        for s, mesh in meshes.items():
            p = jrh.ensure_sharded_pruned_state(params, mesh, k_hint=K,
                                                tile=TILE, backend=be,
                                                super_factor=sf)

            def run(p, x, mesh=mesh, cfg=cfg):
                v, i, st = jrh.top_items_pruned_sharded(
                    p, x, K, mesh, pq_cfg=cfg, ladder=LADDER,
                    return_stats=True)
                return v, i, {key: val for key, val in st.items()
                              if key != "bound_backend"}

            v, i, st = jax.jit(run)(p, jnp.asarray(phi))
            out[f"pruned/{cid}/{s}/v"] = np.asarray(v)
            out[f"pruned/{cid}/{s}/i"] = np.asarray(i)
            out[f"pruned/{cid}/{s}/stats"] = np.array(json.dumps(
                {key: np.asarray(val).item() for key, val in st.items()}))
    ladders = {}
    for s, variant in LADDER_CASES:
        cfg, params = _jax_model(*ENGINE_VARIANTS[variant])
        eng = jengine.RetrievalEngine.for_seqrec(
            params, cfg, k=ENGINE_K, max_batch=ENGINE_BATCH,
            method="pqtopk_pruned", sharded_mesh=meshes[s])
        ladders[f"{s}/{variant}"] = list(eng.ladder)
    out["ladders"] = np.array(json.dumps(ladders))
    _, params = _jax_model()
    specs = jshd.param_shardings(meshes[4], params,
                                 jshd.seqrec_param_rules())
    out["specs"] = np.array(json.dumps({
        jshd.path_str(path): [list(e) if isinstance(e, tuple) else e
                              for e in sh.spec]
        for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]}))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded") / "oracle.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": (os.environ.get("XLA_FLAGS", "") +
                         " --xla_force_host_platform_device_count=4").strip(),
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(root, "src")]
               + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                  if p])}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(path)], env=env, cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def _mesh(s):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(s, ["cpu"] * s)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _host(v):
    return v if isinstance(v, (str, bool)) else np.asarray(v).item()


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("n,method", PLAIN_CASES)
def test_top_items_sharded_matches_reference(oracle, n, method, s):
    """Every method at S shards, values and ids bit for bit; and equal to
    the port's own flat route."""
    from repro_torch.core import retrieval_head as trh
    codes, sub, phi, table, _ = _inputs(n, 8, "hot")
    params = ({"table": _t(table)} if method == "dense" else
              {"codes": _t(codes), "sub_emb": _t(sub)})
    v, i = trh.top_items_sharded(params, _t(phi), K, _mesh(s), method=method)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(v.numpy(), oracle[f"plain/{n}/{method}/{s}/v"])
    np.testing.assert_array_equal(i.numpy(), oracle[f"plain/{n}/{method}/{s}/i"])
    fv, fi = trh.top_items(params, _t(phi), K, method=method)
    assert torch.equal(v, fv) and torch.equal(i, fi)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("cid", list(PRUNED_CASES))
def test_pruned_sharded_matches_reference(oracle, cid, s):
    """The sharded cascade: values, ids and every stats entry bit for bit;
    the values and ids also equal the port's flat exhaustive (masked)
    route, and no dead id is served."""
    from repro_torch.configs.base import PQConfig as TPQConfig
    from repro_torch.core import pruning as tp
    from repro_torch.core import retrieval_head as trh
    n, bq, kind, be, grouped, sf, dead, policy = PRUNED_CASES[cid]
    codes, sub, phi, _, live = _inputs(n, bq, kind)
    params = {"codes": _t(codes), "sub_emb": _t(sub)}
    if dead:
        params["live"] = _t(live)
    mesh = _mesh(s)
    p = trh.ensure_sharded_pruned_state(params, mesh, k_hint=K, tile=TILE,
                                        backend=be, super_factor=sf)
    cfg = TPQConfig(m=M, b=B_SUB, bound_backend=be, query_grouping=grouped,
                    n_groups=8, seed_policy=policy, seed_max_tiles=8)
    v, i, st = trh.top_items_pruned_sharded(p, _t(phi), K, mesh, pq_cfg=cfg,
                                            ladder=LADDER, return_stats=True)
    np.testing.assert_array_equal(v.numpy(), oracle[f"pruned/{cid}/{s}/v"])
    np.testing.assert_array_equal(i.numpy(), oracle[f"pruned/{cid}/{s}/i"])
    want = json.loads(str(oracle[f"pruned/{cid}/{s}/stats"]))
    assert set(st) == tp.STATS_KEYS
    assert st["bound_backend"] == be
    for key, val in want.items():
        assert _host(st[key]) == val, key
    if dead:
        fv, fi = tp.cascade_topk_ingraph(
            params["codes"], trh._subid_scores(params, _t(phi)), K,
            live=params["live"])
        assert bool(params["live"][i[torch.isfinite(v)].long()].all())
    else:
        fv, fi = trh.top_items(params, _t(phi), K, method="pqtopk_fused")
    assert torch.equal(v, fv) and torch.equal(i, fi)


def test_pruned_sharded_cases_reach_every_branch(oracle):
    """The inputs exercise what they are for: the ladder escalates on some
    shard and stops below the exhaustive rung on another, grouping builds
    several groups, and at S=4 the hierarchical route skips whole
    shards."""
    stats = {key: json.loads(str(oracle[key])) for key in oracle
             if key.startswith("pruned/") and key.endswith("/stats")}
    assert any(st["rung_hit"] < st["n_rungs"] - 1 for st in stats.values())
    assert any(st["slot_overflow"] for st in stats.values())
    assert all(stats[f"pruned/grouped-{be}/{s}/stats"]["n_groups"] == 4
               for be in BACKENDS for s in SHARDS)
    for be in BACKENDS:
        hier = stats[f"pruned/hier-{be}/4/stats"]
        # Fewer surviving supers than shards: some shard has none and is
        # skipped.
        assert hier["n_super_survived"] < 4, hier
        assert hier["bounds_computed"] < hier["n_tiles"] + hier["n_super"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [N_ODD, N_EVEN, 3])
def test_shard_aligned_state_matches_reference(backend, n):
    """``build_pruned_state(shards=S)`` (supers grouped per shard included)
    and ``ensure_sharded_pruned_state``'s rebuild equal the reference's
    array for array; the ensure is a no-op on a fitting state; a reference
    shard-aligned state crosses ``interop`` whole."""
    import jax
    import jax.numpy as jnp
    from repro.core import pruning as jp
    from repro.core import retrieval_head as jrh
    from repro_torch.core import pruning as tp
    from repro_torch.core import retrieval_head as trh
    from repro_torch.interop import pruned_state_from_jax
    codes, sub, *_ = _inputs(n, 1, "hot")
    for s in SHARDS:
        fake = types.SimpleNamespace(shape={"model": s})
        jparams = {"codes": jnp.asarray(codes), "sub_emb": jnp.asarray(sub)}
        tparams = {"codes": _t(codes), "sub_emb": _t(sub)}
        jst = jrh.ensure_sharded_pruned_state(
            jparams, fake, k_hint=K, tile=TILE, backend=backend,
            super_factor=FACTOR)["pruned"]
        tparams = trh.ensure_sharded_pruned_state(
            tparams, _mesh(s), k_hint=K, tile=TILE, backend=backend,
            super_factor=FACTOR)
        tst = tparams["pruned"]
        conv = pruned_state_from_jax(jax.tree_util.tree_map(np.asarray, jst))
        for f in dataclasses.fields(jst):
            want = getattr(jst, f.name)
            for got in (getattr(tst, f.name), getattr(conv, f.name)):
                if want is None or isinstance(want, (int, str)):
                    assert got == want, f.name
                else:
                    w = np.asarray(want)
                    w = w.view(np.int32) if w.dtype == np.uint32 else w
                    np.testing.assert_array_equal(got.numpy(), w,
                                                  err_msg=f.name)
        for attr in ("tiles_per_shard", "supers_per_shard", "n_tiles"):
            assert getattr(tst, attr) == getattr(jst, attr), attr
        again = trh.ensure_sharded_pruned_state(tparams, _mesh(s), k_hint=K,
                                                tile=TILE)
        assert again is tparams
        flat = tp.build_pruned_state(_t(codes), B_SUB, TILE, shards=s,
                                     backend=backend)
        np.testing.assert_array_equal(
            flat.meta_arrays()[0].numpy(),
            np.asarray(jp.build_pruned_state(
                jnp.asarray(codes), B_SUB, TILE, shards=s,
                backend=backend).meta_arrays()[0]).view(
                    np.int32 if backend == "bitmask" else np.int16))


def test_param_shardings_match_reference(oracle):
    """The serve-path rules on the engines' model: the same spec per
    parameter path, a non-dividing axis dropped."""
    import jax
    from repro_torch.distributed import sharding as tshd
    from repro_torch.interop import params_from_jax
    _, jparams = _jax_model()
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    specs = tshd.param_shardings(_mesh(4), tparams, tshd.seqrec_param_rules())
    got = {}

    def walk(path, tree):
        if isinstance(tree, dict):
            for key, val in tree.items():
                walk(path + [key], val)
        elif isinstance(tree, list):
            for j, val in enumerate(tree):
                walk(path + [j], val)
        elif isinstance(tree, tshd.NamedSharding):
            got[tshd.path_str(path)] = [list(e) if isinstance(e, tuple)
                                        else e for e in tree.spec]
        elif dataclasses.is_dataclass(tree):
            for f in dataclasses.fields(tree):
                if isinstance(getattr(tree, f.name), tshd.NamedSharding):
                    walk(path + [f.name], getattr(tree, f.name))

    walk([], specs)
    want = json.loads(str(oracle["specs"]))
    assert got == want
    # 20,001 code rows do not divide by 4: the items axis is dropped.
    assert got["item_emb/codes"] == [None, None]
    assert tshd.param_shardings(_mesh(2), tparams, tshd.seqrec_param_rules()
                                )["item_emb"]["codes"].spec == tshd.P(None,
                                                                      None)


def test_collectives_and_row_blocks():
    """all_gather in shard order, pmax/psum, one host read for all shards;
    row blocks are views where they can be, padded copies elsewhere, and a
    copy follows an in-place write of its source."""
    from repro_torch.distributed import sharding as tshd
    mesh = _mesh(4)
    parts = [torch.full((2, 3), float(i)) for i in range(4)]
    assert tshd.all_gather(parts, mesh).tolist()[0] == \
        [0.0] * 3 + [1.0] * 3 + [2.0] * 3 + [3.0] * 3
    assert tshd.pmax(parts, mesh).tolist() == [[3.0] * 3] * 2
    assert tshd.psum(parts, mesh).tolist() == [[6.0] * 3] * 2
    assert tshd.host_values([torch.tensor(i) for i in range(4)], mesh,
                            "counts", 3) == [0, 1, 2, 3]
    x = torch.arange(10 * 2).reshape(10, 2)
    blocks = tshd.shard_rows(x, mesh)
    assert [b.shape[0] for b in blocks] == [3] * 4
    assert all(b.is_contiguous() for b in blocks)
    assert blocks[0].data_ptr() == x.data_ptr()          # a view
    assert blocks[3].tolist() == [[18, 19], [0, 0], [0, 0]]
    assert tshd.shard_rows(x, mesh)[3] is blocks[3]      # cached
    x[9] = -1
    assert tshd.shard_rows(x, mesh)[3].tolist() == [[-1, -1], [0, 0], [0, 0]]


@pytest.mark.parametrize("axes,shape", [
    (("data", "model"), (2, 4)),
    (("pod", "data", "model"), (2, 2, 4))])
def test_multi_axis_mesh_shards_over_model(axes, shape):
    """On a mesh with ``data`` (and ``pod``) beside ``model``, the row
    blocks and the sharded routes take one block per ``model`` position:
    ``shard_rows`` gives the one-axis 4-shard mesh's blocks, and the
    pruned route gives its values, ids and kernel launches (the other
    axes add none)."""
    from repro_torch.configs.base import PQConfig as TPQConfig
    from repro_torch.core import retrieval_head as trh
    from repro_torch.distributed import sharding as tshd
    from repro_torch.kernels import cost
    from repro_torch.launch.mesh import ShardMesh
    mesh = ShardMesh(["cpu"] * int(np.prod(shape)), axes, shape)
    flat = _mesh(4)
    codes, sub, phi, _, _ = _inputs(N_ODD, 8, "hot")
    blocks = tshd.shard_rows(_t(codes), mesh)
    want = tshd.shard_rows(_t(codes), flat)
    assert len(blocks) == 4
    assert all(torch.equal(b, w) for b, w in zip(blocks, want))
    params = {"codes": _t(codes), "sub_emb": _t(sub)}
    cfg = TPQConfig(m=M, b=B_SUB)
    out = {}
    for name, m in (("multi", mesh), ("flat", flat)):
        with cost.recording() as rec:
            v, i = trh.top_items_sharded(params, _t(phi), K, m,
                                         method="pqtopk_pruned",
                                         pq_cfg=cfg, ladder=LADDER)
        out[name] = (v, i, dict(rec.launches))
    assert torch.equal(out["multi"][0], out["flat"][0])
    assert torch.equal(out["multi"][1], out["flat"][1])
    assert out["multi"][2] == out["flat"][2]
    assert out["multi"][2]["pq_topk_fused"] == 4


def test_refusals_and_mesh():
    """What the reference refuses, the port refuses: a tombstone mask on a
    route that ignores it, a dense table that does not divide, grouping
    with super-tiles; ``make_mesh`` without enough GPUs raises rather than
    falling back."""
    from repro_torch.configs.base import PQConfig as TPQConfig
    from repro_torch.core import pruning as tp
    from repro_torch.core import retrieval_head as trh
    from repro_torch.launch.mesh import make_mesh
    codes, sub, phi, table, live = _inputs(N_ODD, 8, "hot")
    mesh = _mesh(2)
    params = {"codes": _t(codes), "sub_emb": _t(sub), "live": _t(live)}
    with pytest.raises(ValueError, match="live"):
        trh.top_items_sharded(params, _t(phi), K, mesh, method="pqtopk_fused")
    with pytest.raises(ValueError, match="divide"):
        trh.top_items_sharded({"table": _t(table)}, _t(phi), K, mesh)
    p = trh.ensure_sharded_pruned_state(
        {"codes": _t(codes), "sub_emb": _t(sub)}, mesh, k_hint=K, tile=TILE,
        super_factor=FACTOR)
    with pytest.raises(ValueError, match="mutually exclusive"):
        trh.top_items_pruned_sharded(
            p, _t(phi), K, mesh, pq_cfg=TPQConfig(m=M, b=B_SUB,
                                                  query_grouping=True))
    with pytest.raises(ValueError, match="shards=1"):
        tp.cascade_topk_ingraph(p["codes"], trh._subid_scores(p, _t(phi)),
                                K, p["pruned"])
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="GPU"):
            make_mesh(2)
    with pytest.raises(ValueError):
        make_mesh(2, ["cpu"] * 3)
    assert make_mesh(3, ["cpu"] * 3).shape["model"] == 3


def test_split_tiles_score_like_one_tile():
    """A pruning tile longer than the fused kernel's largest (2,050 rows,
    a sharded state's at k + pad) is scored as two 1,025-row slots: the
    same winners as the whole tile, ties, padding and sentinels included."""
    from repro_torch.kernels.pqtopk import ops as tops, ref as tref
    rng = np.random.default_rng(3)
    n, tile = 9000, 2050
    codes = _t(rng.integers(0, B_SUB, (n, M)).astype(np.int32))
    codes[[5, 4100, 8999]] = codes[7].clone()
    s = _t(rng.integers(-8, 8, (3, M, B_SUB)).astype(np.float32))
    assert tops.split_factor(tile) == 2 and tops.split_factor(2048) == 1
    live = _t(rng.random(n) > 0.2)
    for idx in ([0, 1, 2, 3, 4], [4, 1, -1, -1], [-1, -1]):
        idx = torch.tensor(sorted(x for x in idx if x >= 0)
                           + [x for x in idx if x < 0], dtype=torch.int32)
        for kk, lv in ((7, None), (1500, None), (7, live)):
            got = tops.pq_topk_tiles(codes, s, kk, idx, tile=tile, live=lv)
            tv, ti = tref.pq_topk_slots(codes, s, kk, idx, n_items=n,
                                        tile=tile, live=lv)
            want = tops._merge_slot_winners(tv, ti, kk)
            if lv is not None:
                want = tops._remap_dead(*want, n)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])


# ---------------------------------------------------------------------------
# engines and the fabric
# ---------------------------------------------------------------------------


def _model(variant):
    import jax
    from repro_torch.configs.base import PQConfig as TPQConfig
    from repro_torch.configs.base import get_reduced
    from repro_torch.interop import params_from_jax
    jc, jparams = _jax_model(*ENGINE_VARIANTS[variant])
    base = get_reduced("sasrec-recjpq").model
    tc = dataclasses.replace(base, n_items=ENGINE_ITEMS,
                             pq=TPQConfig(**vars(jc.pq)))
    return tc, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _histories(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, ENGINE_ITEMS + 1, int(rng.integers(2, 20)))
            for _ in range(n)]


def _serve(eng, hists):
    from repro_torch.serving.engine import Request
    for j, h in enumerate(hists):
        eng.submit(Request(j, h, k=ENGINE_K))
    return {r.request_id: r for r in eng.drain()}


@pytest.mark.parametrize("s,variant", LADDER_CASES)
def test_sharded_engine_ladder_and_results(oracle, s, variant):
    """``for_seqrec(sharded_mesh=...)``: the calibrated ladder equals the
    reference engine's on the same model; no pinned route; every result
    bit-identical to the port's flat engine on the same aligned batches."""
    from repro_torch.serving.engine import RetrievalEngine
    cfg, params = _model(variant)
    eng = RetrievalEngine.for_seqrec(params, cfg, k=ENGINE_K,
                                     max_batch=ENGINE_BATCH,
                                     method="pqtopk_pruned",
                                     sharded_mesh=_mesh(s), device="cpu")
    assert list(eng.ladder) == json.loads(str(oracle["ladders"]))[
        f"{s}/{variant}"]
    assert not eng.has_pinned
    st = params["item_emb"]["pruned"]
    assert st.shards == 1                  # the caller's params untouched
    flat = RetrievalEngine.for_seqrec(params, cfg, k=ENGINE_K,
                                      max_batch=ENGINE_BATCH,
                                      method="pqtopk_fused", device="cpu")
    hists = _histories(3 * ENGINE_BATCH, seed=s)
    got, want = _serve(eng, hists), _serve(flat, hists)
    assert sum(eng.rung_counts.values()) == 3
    for rid, w in want.items():
        assert np.array_equal(got[rid].items, w.items)
        assert np.array_equal(got[rid].scores, w.scores)
        assert got[rid].degraded == "" and not got[rid].shed


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("method", ["pqtopk_fused", "pqtopk_kernel",
                                    "pqtopk"])
def test_sharded_engine_matches_flat_engine(s, method):
    """The exhaustive routes through sharded engines: bit-identical to the
    same method's flat engine, batch for batch; ``pin_rung`` and a
    non-pruned ``return_rung`` are refused on the sharded path."""
    from repro_torch.models import seqrec
    from repro_torch.serving.engine import RetrievalEngine
    cfg, params = _model("batch-any")
    mesh = _mesh(s)
    eng = RetrievalEngine.for_seqrec(params, cfg, k=ENGINE_K,
                                     max_batch=ENGINE_BATCH, method=method,
                                     sharded_mesh=mesh, device="cpu")
    flat = RetrievalEngine.for_seqrec(params, cfg, k=ENGINE_K,
                                      max_batch=ENGINE_BATCH, method=method,
                                      device="cpu")
    hists = _histories(2 * ENGINE_BATCH, seed=10 + s)
    got, want = _serve(eng, hists), _serve(flat, hists)
    for rid, w in want.items():
        assert np.array_equal(got[rid].items, w.items)
        assert np.array_equal(got[rid].scores, w.scores)
    seqs = torch.ones((2, cfg.max_seq_len), dtype=torch.int32)
    with pytest.raises(ValueError, match="pin_rung"):
        seqrec.serve_topk(params, seqs, cfg, method="pqtopk_pruned",
                          sharded_mesh=mesh, pin_rung=True)
    with pytest.raises(ValueError, match="return_rung"):
        seqrec.serve_topk(params, seqs, cfg, method=method,
                          sharded_mesh=mesh, return_rung=True)


def test_chaos_sharded_fabric():
    """The fabric over sharded replicas (as ``tests/test_router_chaos.py``'s
    sharded case): one result per request through a crashing replica,
    none shed, no pinned route on any replica."""
    from repro_torch.serving.engine import Request
    from repro_torch.serving.router import ReplicaRouter
    from repro_torch.training.fault_tolerance import ReplicaFaultPlan
    cfg, params = _model("batch-any")
    plans = {1: ReplicaFaultPlan(crash_windows=((0, 2),))}
    with ReplicaRouter.for_seqrec(
            params, cfg, n_replicas=3, k=ENGINE_K, max_batch=ENGINE_BATCH,
            method="pqtopk_pruned", ladder=(1,), calibrate=False,
            sharded_mesh=_mesh(2), device="cpu", fault_plans=plans,
            eject_after=1, cooldown_ms=10.0, hedge=False) as router:
        assert not any(e.has_pinned for e in router.engines)
        router.warmup()
        hists = _histories(64, seed=7)
        for j, h in enumerate(hists):
            router.submit(Request(j, h, k=ENGINE_K))
            if j % 16 == 15:
                router.pump()
        results = router.drain(timeout_s=120.0)
        assert router.stats()["replicas"][1]["failures"] >= 1
    assert sorted(r.request_id for r in results) == list(range(64))
    assert all(not r.shed and r.degraded == "" for r in results)
    assert all(r.items.shape == (ENGINE_K,) and np.isfinite(r.scores).all()
               for r in results)


if __name__ == "__main__":
    _oracle_main(sys.argv[1])
