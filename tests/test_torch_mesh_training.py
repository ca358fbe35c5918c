"""Training over a multi-axis mesh against the JAX reference on the CPU:
the train step over the ``pod`` axis with PowerSGD's per-pod error
feedback (``grad_accum`` and ``grad_shardings`` included), and the
elastic restore of a PowerSGD state onto another mesh.  The LM case and
the exchange alone are in ``test_torch_mesh_lm.py``, which shares this
file's helpers.

The module fixture runs this file as a script in a child process with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the child's
environment only): the reference trains each case jitted on a (pod=2,
data=2) mesh of 4 CPU devices or a (pod=2, data=2, model=2) mesh of 8
(``jax.sharding.Mesh``: Auto axes), and saves into one ``.npz`` its
batches, the Q it draws for each compressed leaf (``fold_in`` of a
salted ``hash``, so drawn in that process and injected into the port),
and per step the loss, the exchanged gradients (``adamw_update``'s first
argument), each pod's error feedback (assembled from the shards on its
devices) and the parameters.  The port runs the same inputs on its
single-controller meshes of CPU positions.  Both packages start from the
same parameters, drawn with numpy per leaf path.

Tolerances: loss and uncompressed leaves rtol=atol=1e-5 (float32; the
frameworks sum in different orders).  A compressed leaf's exchanged
gradient depends on the span of P = M Q (M the pods' mean G + E), not on
the signs QR picks; to first order a relative input change eps moves it
by eps x :func:`amplification` (over ||g_hat||, Frobenius), which grows
with P's conditioning and so with the drawn Q.  Its g_hat and each pod's
residual are held to 10 x ``EPS_IN`` x that, ``EPS_IN`` = 1e-6 a bound
on the two frameworks' gradient agreement (5 draws of Q on this CPU gave
at most 6.2e-7).  Parameters rtol=atol=1e-5, except entries whose
exchanged gradient lies within 2 lr / atol (200) times the observed
deviation of zero, where AdamW's normalised step moves by more than the
atol (by about lr |dg| / |g|): those are held to 3 lr a step.  Integer
leaves bit for bit."""
import dataclasses
import os
import subprocess
import sys
import tempfile
import zlib

import numpy as np
import pytest
import torch

SEQ_ARCH, LM_ARCH = "sasrec-recjpq", "qwen2.5-14b"
AXES3 = ("pod", "data", "model")
STEPS = 2
B_SEQ, B_LM, LM_LEN = 8, 4, 16
LR = dict(lr=1e-3, warmup_steps=2, total_steps=100)
MIN_SIZE, RANK = 65536, 4
TOL = dict(rtol=1e-5, atol=1e-5)
REL = 1e-4                      # the negative control's miss, of max|g_hat|
EPS_IN = 1e-6
# case -> (model, devices, grad_accum, grad_shardings, activation plan).
# The reference's grad_shardings fail under grad_accum > 1 on an integer
# leaf, whose accumulated gradient is a float32 0-d zero (ROADMAP C17).
CASES = {"seq4": ("seq", 4, 2, False, False),
         "seq8": ("seq", 8, 1, True, False),
         "lm8": ("lm", 8, 2, False, True)}


def _seq_cfg(cfgmod):
    """Reduced SASRec-RecJPQ, one block, widened so the MLP leaves reach
    PowerSGD's 65,536-element floor (1,024 x 64)."""
    c = cfgmod.get_reduced(SEQ_ARCH).model
    return dataclasses.replace(c, d_model=64, d_ff=1024, n_blocks=1)


def _lm_cfg(cfgmod):
    """Reduced qwen2.5 with a 2,048-token vocabulary (embed and head
    compressed) and d_ff 512 (the stacked (2, 64, 512) MLP leaves
    compressed as one matrix each)."""
    return dataclasses.replace(cfgmod.get_reduced(LM_ARCH).model,
                               vocab=2048, d_ff=512)


def _value(path, shape, dtype, b):
    """A parameter leaf's value, from numpy seeded by its path: codes below
    ``b``, other integers zero, scales near 1, the rest N(0, 0.1)."""
    rng = np.random.default_rng(zlib.crc32(path.encode()))
    if np.issubdtype(dtype, np.integer):
        if path.endswith("codes"):
            return rng.integers(0, b, shape).astype(dtype)
        return np.zeros(shape, dtype)
    x = 0.1 * rng.standard_normal(shape)
    return (x + 1.0 if path.endswith("scale") else x).astype(dtype)


def _batches(kind, n):
    if kind == "seq":
        import repro.configs as jconfigs
        from repro.data.sequences import SeqRecDataset
        c = _seq_cfg(jconfigs)
        it = SeqRecDataset.synthetic(64, c.n_items, 10, c.max_seq_len,
                                     seed=0).batches(
            B_SEQ, c.n_negatives, backbone=c.backbone, seed=1)
        return [next(it) for _ in range(n)]
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        tok = rng.integers(0, 2048, (B_LM, LM_LEN + 1))
        out.append({"tokens": tok[:, :-1].astype(np.int32),
                    "targets": tok[:, 1:].astype(np.int32)})
    return out


# ---------------------------------------------------------------------------
# the reference, in the child process
# ---------------------------------------------------------------------------


def _oracle_main(path, cases, extras=False):
    """Run ``cases`` (and, with both seq cases, the restore; with
    ``extras`` the exchange alone and the compression ratios) on the
    reference and save the record at ``path``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import repro.configs as jconfigs
    from repro.distributed import sharding as jshd
    from repro.models import seqrec as JS, transformer as JT
    from repro.training import checkpoint as jckpt, compression as jcomp
    from repro.training import optimizer as jopt, train_loop as jtl
    assert len(jax.devices()) >= 8, jax.devices()
    devs = np.array(jax.devices()[:8])
    meshes = {4: Mesh(devs[:4].reshape(2, 2), ("pod", "data")),
              8: Mesh(devs.reshape(2, 2, 2), AXES3)}
    out = {}

    # The exchanged gradients are adamw_update's first argument: return
    # them with the metrics.
    adamw = jopt.adamw_update

    def spying_adamw(grads, state, params, cfg, *, frozen=None):
        p, s, om = adamw(grads, state, params, cfg, frozen=frozen)
        g = jax.tree.map(lambda x: jnp.zeros((), jnp.float32)
                         if x.dtype == jax.dtypes.float0 else x, grads)
        return p, s, dict(om, _grads=g)

    jopt.adamw_update = spying_adamw

    def flat(tree):
        return {jshd.path_str(p): x for p, x in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    def ref_q(params, tag, min_size=MIN_SIZE):
        key = jax.random.PRNGKey(0)
        for p, x in jax.tree_util.tree_flatten_with_path(params)[0]:
            if not jnp.issubdtype(x.dtype, jnp.floating) or \
                    x.size < min_size or x.ndim < 2:
                continue
            m, n = int(np.prod(x.shape[:-1])), x.shape[-1]
            kleaf = jax.random.fold_in(key, hash(str(p)) % (2 ** 31))
            out[f"{tag}/q/{jshd.path_str(p)}"] = np.asarray(
                jax.random.normal(kleaf, (n, min(RANK, m, n)), jnp.float32))

    def per_pod(arr, mesh):
        """Each pod's value, assembled from the shards on its devices (the
        automatic axes may shard it); a block held twice in a pod must
        agree."""
        pod_of = {d: idx[0] for idx, d in np.ndenumerate(mesh.devices)}
        pods = [np.full(arr.shape, np.nan, arr.dtype) for _ in range(2)]
        for sh in arr.addressable_shards:
            dst = pods[pod_of[sh.device]]
            got = np.asarray(sh.data)
            seen = dst[sh.index]
            assert np.isnan(seen).all() or np.array_equal(seen, got)
            dst[sh.index] = got
        assert not any(np.isnan(p).any() for p in pods)
        return pods

    def record(tag, mesh, params, st, m):
        out[f"{tag}/loss"] = np.asarray(m["loss"])
        for k, v in flat(m["_grads"]).items():
            out[f"{tag}/ghat/{k}"] = np.asarray(v)
        for k, v in flat(params).items():
            out[f"{tag}/params/{k}"] = np.asarray(v)
        for k, v in flat(st["ef"]).items():
            for i, x in enumerate(per_pod(v, mesh)):
                out[f"{tag}/ef{i}/{k}"] = x

    ocfg = jopt.AdamWConfig(**LR)
    steps, states = {}, {}
    for case in cases:
        kind, n_dev, accum, gs, plan = CASES[case]
        mesh = meshes[n_dev]
        rep = NamedSharding(mesh, P())
        if kind == "seq":
            cfg = _seq_cfg(jconfigs)
            abstract = JS.abstract_seqrec(cfg)
            loss_fn = (lambda c: lambda p, b: JS.seqrec_loss(p, b, c))(cfg)
            rules, b = jshd.seqrec_param_rules(), cfg.pq.b
        else:
            cfg = _lm_cfg(jconfigs)
            abstract = JT.abstract_lm(cfg)
            loss_fn = (lambda c: lambda p, b: JT.lm_loss(p, b, c))(cfg)
            rules, b = jshd.lm_param_rules(cfg.scan_layers), cfg.pq_head.b
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.asarray(_value(jshd.path_str(p), x.shape,
                                            np.dtype(x.dtype), b)),
            abstract)
        ref_q(params, case)
        step = jax.jit(jtl.make_train_step(
            loss_fn, ocfg, grad_accum=accum, powersgd_axis="pod", mesh=mesh,
            grad_shardings=jshd.param_shardings(mesh, params, rules)
            if gs else None))
        steps[case] = step
        act = jshd.strip_axis(jshd.lm_activation_plan(mesh), "pod") \
            if plan else None
        st = jtl.init_opt_state(params, ocfg, powersgd=True)
        params, st = jax.device_put((params, st), rep)
        for i, batch in enumerate(_batches(kind, STEPS)):
            for k, v in batch.items():
                out[f"{case}/batch{i}/{k}"] = v
            with jshd.activation_plan(act):
                params, st, m = step(params, st, jax.device_put(
                    {k: jnp.asarray(v) for k, v in batch.items()}, rep))
            record(f"{case}/{i}", mesh, params, st, m)
        states[case] = (params, st)

    if "seq4" in states and "seq8" in states:
        # seq4's PowerSGD state, saved; the file read back; restored onto
        # the 8-device mesh (every pod takes the file's residual) and
        # stepped there with seq8's step.
        params, st = states["seq4"]
        mesh = meshes[8]
        with tempfile.TemporaryDirectory() as d:
            mgr = jckpt.CheckpointManager(d, async_save=False)
            mgr.save(STEPS, {"params": params, "opt_state": st})
            with np.load(os.path.join(d, f"step_{STEPS:010d}",
                                      "opt_state.npz")) as z:
                for k in z.files:
                    if k.startswith("ef|"):
                        out[f"restore/file/{k[3:].replace('|', '/')}"] = z[k]
            got = mgr.restore(STEPS, {"params": params, "opt_state": st},
                              {"params": jshd.replicated(mesh, params),
                               "opt_state": jshd.replicated(mesh, st)})
        batch = _batches("seq", STEPS + 1)[-1]
        for k, v in batch.items():
            out[f"restore/batch/{k}"] = v
        p3, s3, m3 = steps["seq8"](
            got["params"], got["opt_state"],
            jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                           NamedSharding(mesh, P())))
        record("restore/step", mesh, p3, s3, m3)

    if extras:
        # compressed_psum_sharded on two pods (a one-axis mesh: called
        # outside jit, the reference's region refuses auto axes).
        g = {"w": np.random.default_rng(5).standard_normal((96, 80)).astype(
            np.float32), "b": np.arange(6, dtype=np.float32)}
        ref_q(g, "psum", min_size=1024)
        jg, je = jcomp.compressed_psum_sharded(
            jax.tree.map(jnp.asarray, g), jcomp.init_error_feedback(g),
            Mesh(devs[:2], ("pod",)), "pod", rank=RANK, min_size=1024)
        for k, v in g.items():
            out[f"psum/in/{k}"] = v
            out[f"psum/g/{k}"] = np.asarray(jg[k])
            out[f"psum/e/{k}"] = np.asarray(je[k])
        for kind, tree in (("seq", JS.abstract_seqrec(_seq_cfg(jconfigs))),
                           ("lm", JT.abstract_lm(_lm_cfg(jconfigs)))):
            out[f"ratio/{kind}"] = np.array(jcomp.compression_ratio(
                tree, rank=RANK, min_size=MIN_SIZE))
    np.savez(path, **out)


def run_oracle(tmp_path_factory, script):
    """Run ``script`` as the reference's child (8 CPU devices) -> its
    record."""
    path = tmp_path_factory.mktemp("mesh_oracle") / "oracle.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": (os.environ.get("XLA_FLAGS", "") +
                         " --xla_force_host_platform_device_count=8").strip(),
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(root, "src")]
               + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                  if p])}
    proc = subprocess.run([sys.executable, os.path.abspath(script),
                           str(path)], env=env, cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(tmp_path_factory, __file__)


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


def mesh_of(n_dev):
    from repro_torch.launch.mesh import ShardMesh, make_test_mesh
    if n_dev == 4:
        return ShardMesh(["cpu"] * 4, ("pod", "data"), (2, 2))
    return make_test_mesh(multi_pod=True, devices=["cpu"] * 8)


def model(kind):
    """(loss fn, params, rules) of the port, the parameters the
    reference's (:func:`_value` per path)."""
    from repro_torch.configs import base as tcfg
    from repro_torch.distributed import sharding as tshd
    from repro_torch.models import seqrec as TS, transformer as TT
    from repro_torch.training import tree as tree_lib
    gen = torch.Generator().manual_seed(0)
    if kind == "seq":
        c = _seq_cfg(tcfg)
        shell, loss = TS.init_seqrec(gen, c), TS.seqrec_loss
        rules, b = tshd.seqrec_param_rules(), c.pq.b
    else:
        c = _lm_cfg(tcfg)
        shell, loss = TT.init_lm(gen, c), TT.lm_loss
        rules, b = tshd.lm_param_rules(c.scan_layers), c.pq_head.b
    params = tree_lib.map_with_path(
        lambda p, x: torch.from_numpy(_value(
            tree_lib.path_str(p), tuple(x.shape),
            np.dtype(str(x.dtype).replace("torch.", "")), b)), shell)
    return (lambda p, bt: loss(p, bt, c)), params, rules


def q_of(oracle, tag):
    pre = f"{tag}/q/"
    return {k[len(pre):]: torch.from_numpy(v) for k, v in oracle.items()
            if k.startswith(pre)}


def batch_of(oracle, tag):
    pre = f"{tag}/"
    return {k[len(pre):]: torch.from_numpy(v) for k, v in oracle.items()
            if k.startswith(pre) and "/" not in k[len(pre):]}


class Spy:
    """Keeps the gradients ``adamw_update`` receives (the exchanged
    ones), as the child's spy does for the reference."""

    def __init__(self, monkeypatch):
        from repro_torch.training import optimizer as topt
        self.grads, adamw = [], topt.adamw_update

        def spy(grads, state, params, cfg, *, frozen=None):
            self.grads.append(grads)
            return adamw(grads, state, params, cfg, frozen=frozen)

        monkeypatch.setattr(topt, "adamw_update", spy)


def leaves(tree):
    from repro_torch.training import tree as tree_lib
    return {tree_lib.path_str(p): x for p, x in
            tree_lib.leaves_with_path(tree)}


def amplification(g, e, g_hat, q):
    """The exchange's first-order sensitivity for one leaf: a relative
    change eps of the pods' inputs (``g``, ``e``: lists of (m, n)) moves
    span(P), P = M Q, by eps ||Q|| sigma_1(M) / sigma_r(P), and g_hat by
    that times ||g_hat|| + ||M - g_hat||; returned over ||g_hat||."""
    m = torch.stack([x.double() + y.double() for x, y in zip(g, e)]).mean(0)
    q, g_hat = q.double(), g_hat.double()
    span = float(torch.linalg.matrix_norm(q, 2) * torch.linalg.matrix_norm(
        m, 2) / torch.linalg.svdvals(m @ q)[-1])
    return span * float((g_hat.norm() + (m - g_hat).norm()) / g_hat.norm())


def probe_into(seen):
    """An exchange probe keeping each compressed leaf's pod inputs."""
    def probe(key, g, e, g_hat, new_e):
        seen[key] = ([x.float().clone() for x in g],
                     [y.float().clone() for y in e], g_hat.clone())
    return probe


def check_step(oracle, tag, params, state, loss, grads, seen, q, loose,
               n_steps):
    """The port's step ``tag`` against the reference's record.  ``seen``
    holds the compressed leaves' pod inputs (:func:`probe_into`) and ``q``
    their factors; ``loose`` (leaf -> mask) gathers the entries whose
    exchanged gradient has been within 2 lr / atol times the observed
    deviation of zero, held to 3 lr a step over ``n_steps``."""
    from repro_torch.distributed.sharding import Varying
    from repro_torch.training import compression
    np.testing.assert_allclose(float(loss), float(oracle[f"{tag}/loss"]),
                               **TOL)
    ef = leaves(state["ef"])
    n_comp = 0
    for key, g in leaves(grads).items():
        want = oracle[f"{tag}/ghat/{key}"]
        # AdamW moves an entry by about lr * 2|dg| / sqrt(v): past the
        # parameters' atol where |g| < (2 lr / atol) |dg|.
        small = np.abs(want) <= 2 * LR["lr"] / TOL["atol"] * np.abs(
            g.numpy() - want).max()
        loose[key] = loose[key] | small if key in loose else small
        if not compression.compressed(g.shape, MIN_SIZE):
            np.testing.assert_allclose(g.numpy(), want, err_msg=key, **TOL)
            continue
        n_comp += 1
        assert isinstance(ef[key], Varying) and len(ef[key].parts) == 2
        pg, pe, p_hat = seen[key]
        moved = [np.linalg.norm(g.numpy() - want)] + [
            np.linalg.norm(part.numpy() - oracle[f"{tag}/ef{i}/{key}"])
            for i, part in enumerate(ef[key].parts)]
        bound = 10 * EPS_IN * amplification(pg, pe, p_hat, q[key])
        assert max(moved) / np.linalg.norm(want) <= bound, (key, moved,
                                                             bound)
    assert n_comp >= 2
    for key, p in leaves(params).items():
        want = oracle[f"{tag}/params/{key}"]
        if not p.is_floating_point():
            np.testing.assert_array_equal(p.numpy().view(want.dtype), want)
            continue
        off = ~np.isclose(p.numpy(), want, **TOL)
        mask = loose.get(key, np.zeros(want.shape, bool))
        assert not (off & ~mask).any(), key
        assert (np.abs(p.numpy() - want)[off] <= 3 * LR["lr"] * n_steps
                ).all(), key


def run_case(oracle, case, monkeypatch):
    """The port's steps of ``case``, each checked -> (params, state, the
    loose entries)."""
    from repro_torch.distributed import sharding as tshd
    from repro_torch.training import optimizer as topt, train_loop as ttl
    kind, n_dev, accum, gs, plan = CASES[case]
    loss_fn, params, rules = model(kind)
    mesh = mesh_of(n_dev)
    ocfg = topt.AdamWConfig(**LR)
    spy, q = Spy(monkeypatch), q_of(oracle, case)
    step = ttl.make_train_step(
        loss_fn, ocfg, grad_accum=accum, powersgd_axis="pod", mesh=mesh,
        grad_shardings=tshd.param_shardings(mesh, params, rules)
        if gs else None, powersgd_q=q)
    act = tshd.strip_axis(tshd.lm_activation_plan(mesh), "pod") \
        if plan else None
    state, loose = ttl.init_opt_state(params, ocfg, powersgd=True), {}
    for i in range(STEPS):
        seen = {}
        with tshd.activation_plan(act):
            params, state, m = step(params, state,
                                    batch_of(oracle, f"{case}/batch{i}"),
                                    trace={"leaf": probe_into(seen)})
        check_step(oracle, f"{case}/{i}", params, state, m["loss"],
                   spy.grads[-1], seen, q, loose, i + 1)
    return params, state, loose


def assert_pods_differ(oracle, case, state, key):
    """Each pod keeps its own residual, in both packages."""
    ef = leaves(state["ef"])[key]
    assert not np.allclose(ef.parts[0].numpy(), ef.parts[1].numpy())
    assert not np.allclose(oracle[f"{case}/{STEPS - 1}/ef0/{key}"],
                           oracle[f"{case}/{STEPS - 1}/ef1/{key}"])


@pytest.mark.parametrize("case", ["seq4", "seq8"])
def test_powersgd_steps_match_reference(oracle, case, monkeypatch):
    """Two PowerSGD steps of a reduced SASRec-RecJPQ: on (pod=2, data=2)
    with grad_accum=2, and on (pod=2, data=2, model=2) with grad_shardings
    (seqrec rules).  The second step matches only because each pod keeps
    its own residual."""
    _, state, _ = run_case(oracle, case, monkeypatch)
    assert_pods_differ(oracle, case, state, "blocks/0/mlp/up/w")


def test_a_shared_residual_misses_the_second_step(oracle):
    """The negative control: seq4's second step from the first step's
    state with every pod given pod 0's residual (one shared error
    feedback) misses the reference's exchanged gradient."""
    from repro_torch.distributed.sharding import Varying
    from repro_torch.training import optimizer as topt, train_loop as ttl
    from repro_torch.training import tree as tree_lib
    loss_fn, params, _ = model("seq")
    ocfg = topt.AdamWConfig(**LR)
    step = ttl.make_train_step(loss_fn, ocfg, grad_accum=2,
                               powersgd_axis="pod", mesh=mesh_of(4),
                               powersgd_q=q_of(oracle, "seq4"))
    params, state, _ = step(params, ttl.init_opt_state(
        params, ocfg, powersgd=True), batch_of(oracle, "seq4/batch0"))
    state["ef"] = tree_lib.tree_map(
        lambda e: e.host() if isinstance(e, Varying) else e, state["ef"])
    seen = {}
    step(params, state, batch_of(oracle, "seq4/batch1"),
         trace={"leaf": lambda key, g, e, g_hat, new_e:
                seen.setdefault(key, g_hat)})
    key = "blocks/0/mlp/up/w"
    want = oracle[f"seq4/1/ghat/{key}"]
    assert np.abs(seen[key].numpy() - want).max() > \
        100 * REL * float(np.abs(want).max())


def test_old_residual_is_released_before_adamw(oracle):
    """A caller that keeps no reference to its state gets the old
    residual back before AdamW (what lets the full-width LM step fit one
    card): when the exchange ends, nothing holds it."""
    import weakref
    from repro_torch.training import optimizer as topt, train_loop as ttl
    loss_fn, params, _ = model("seq")
    ocfg = topt.AdamWConfig(**LR)
    step = ttl.make_train_step(loss_fn, ocfg, powersgd_axis="pod",
                               mesh=mesh_of(4), powersgd_q=q_of(oracle,
                                                                "seq4"))
    state = ttl.init_opt_state(params, ocfg, powersgd=True)
    old = weakref.ref(state["ef"]["blocks"][0]["mlp"]["up"]["w"])
    args = [params, state, batch_of(oracle, "seq4/batch0")]
    del params, state
    seen = {}

    def call(a):
        return step(a.pop(0), a.pop(0), a.pop(0), trace={
            "mark": lambda name: seen.setdefault(name, old() is None)})

    _, new, _ = call(args)
    assert seen == {"pods": False, "exchange": True, "update": True}
    assert old() is None and new["ef"]["blocks"][0]["mlp"]["up"]["w"]


def test_grad_shardings_leave_values_unchanged(oracle):
    """seq8's first step with and without grad_shardings: equal bits, and
    each gradient constraint recorded with its parameter's spec."""
    from repro_torch.distributed import sharding as tshd
    from repro_torch.training import optimizer as topt, train_loop as ttl
    loss_fn, params, rules = model("seq")
    mesh = mesh_of(8)
    ocfg = topt.AdamWConfig(**LR)
    specs = tshd.param_shardings(mesh, params, rules)
    outs = []
    for gs in (None, specs):
        step = ttl.make_train_step(loss_fn, ocfg, powersgd_axis="pod",
                                   mesh=mesh, grad_shardings=gs,
                                   powersgd_q=q_of(oracle, "seq8"))
        with tshd.record_constraints() as rec:
            p, _, m = step(params, ttl.init_opt_state(params, ocfg,
                                                      powersgd=True),
                           batch_of(oracle, "seq8/batch0"))
        outs.append((p, m, rec))
    (p0, m0, rec0), (p1, m1, rec1) = outs
    assert not rec0 and float(m0["loss"]) == float(m1["loss"])
    for (k, a), (_, b) in zip(leaves(p0).items(), leaves(p1).items()):
        assert torch.equal(a, b), k
    want = {f"grads/{k}": s.spec for k, s in leaves(specs).items()
            if leaves(params)[k].is_floating_point()}
    assert {name: spec for name, spec, _ in rec1} == want
    assert any(spec != tshd.P() for spec in want.values())


def test_powersgd_checkpoint_restores_onto_another_mesh(oracle, tmp_path,
                                                        monkeypatch):
    """seq4's state after two steps, saved: the file holds pod 0's
    residual, as the reference's file does; restored onto the 8-position
    mesh with replicated shardings, every pod takes it, and the next step
    (seq8's, with grad_shardings) matches the reference's."""
    from repro_torch.distributed import sharding as tshd
    from repro_torch.distributed.sharding import Varying
    from repro_torch.training import checkpoint as tckpt
    from repro_torch.training import optimizer as topt, train_loop as ttl
    params, state, loose = run_case(oracle, "seq4", monkeypatch)
    mgr = tckpt.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(STEPS, {"params": params, "opt_state": state})
    # Each package's file holds its pod 0's residual (the two pods' values
    # were held to each other by run_case).
    last = f"seq4/{STEPS - 1}"
    n_pod = 0
    with np.load(tmp_path / f"step_{STEPS:010d}" / "opt_state.npz") as z:
        for key, e in leaves(state["ef"]).items():
            stored, want = z["ef|" + key.replace("/", "|")], \
                oracle[f"restore/file/{key}"]
            if isinstance(e, Varying):
                n_pod += 1
                np.testing.assert_array_equal(stored, e.parts[0].numpy())
                np.testing.assert_array_equal(want, oracle[f"{last}/ef0/{key}"])
            else:
                np.testing.assert_array_equal(stored, want)
    assert n_pod >= 2
    mesh = mesh_of(8)
    got = mgr.restore(STEPS, {"params": params, "opt_state": state},
                      {"params": tshd.replicated(mesh, params),
                       "opt_state": tshd.replicated(mesh, state)})
    for key, e in leaves(got["opt_state"]["ef"]).items():
        assert isinstance(e, torch.Tensor) and e.sharding.spec == tshd.P()
        assert e.sharding.mesh is mesh
    loss_fn, _, rules = model("seq")
    spy, q, seen = Spy(monkeypatch), q_of(oracle, "seq8"), {}
    step = ttl.make_train_step(
        loss_fn, topt.AdamWConfig(**LR), powersgd_axis="pod", mesh=mesh,
        grad_shardings=tshd.param_shardings(mesh, got["params"], rules),
        powersgd_q=q)
    p3, s3, m3 = step(got["params"], got["opt_state"],
                      batch_of(oracle, "restore/batch"),
                      trace={"leaf": probe_into(seen)})
    check_step(oracle, "restore/step", p3, s3, m3["loss"], spy.grads[-1],
               seen, q, loose, STEPS + 1)


# ---- twins of the reference's tests/test_training.py ---------------------------

def test_powersgd_compression_properties():
    """Error feedback: compressed + residual == original (per matrix), and
    the compressed gradient of rank <= 4, on a one-pod mesh; Q drawn by
    path, the same in every run."""
    from repro_torch.launch.mesh import ShardMesh
    from repro_torch.training import compression
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 32)).astype(np.float32))}
    e = compression.init_error_feedback(g)
    out_g, out_e = compression.compressed_psum_sharded(
        g, e, ShardMesh(["cpu"], "pod"), "pod", rank=4, min_size=1)
    np.testing.assert_allclose((out_g["w"] + out_e["w"]).numpy(),
                               g["w"].numpy(), rtol=1e-4, atol=1e-5)
    sv = np.linalg.svd(out_g["w"].numpy(), compute_uv=False)
    assert (sv[4:] < 1e-4).all()
    a = compression.draw_q("blocks/0/mlp/up/w", 32, 4)
    assert torch.equal(a, compression.draw_q("blocks/0/mlp/up/w", 32, 4))
    assert not torch.equal(a, compression.draw_q("blocks/1/mlp/up/w", 32, 4))


def test_powersgd_compression_ratio():
    from repro_torch.training import compression
    params = {"big": torch.zeros((512, 512)), "small": torch.zeros((8,))}
    r = compression.compression_ratio(params, rank=4, min_size=1024)
    expected = (4 * (512 + 512) + 8) / (512 * 512 + 8)
    assert abs(r - expected) < 1e-6
    assert compression.exchanged_elements(params, 4, 1024) == (
        512 * 512 + 8, 4 * 1024 + 8)


def test_elastic_restore_reshards(tmp_path):
    """Restore onto a (trivially different) mesh sharding: the elastic
    path, whole arrays placed by explicit NamedShardings; the file's dtype
    kept (the template's is not); ``restore_latest`` takes them too."""
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import checkpoint as tckpt
    mgr = tckpt.CheckpointManager(str(tmp_path), async_save=False)
    params = {"w": torch.arange(16.0).reshape(4, 4)}
    mgr.save(5, {"params": params})
    mesh = make_mesh(1, ["cpu"])
    shardings = {"params": {"w": NamedSharding(mesh, P("model", None))}}
    out = mgr.restore(5, {"params": params}, shardings)
    assert torch.equal(out["params"]["w"], params["w"])
    assert out["params"]["w"].sharding.spec == P("model", None)
    bf = {"w": params["w"].to(torch.bfloat16)}
    out = mgr.restore(5, {"params": bf}, shardings)
    assert out["params"]["w"].dtype == torch.float32
    step, out = mgr.restore_latest({"params": bf}, shardings)
    assert step == 5 and out["params"]["w"].sharding.mesh is mesh
    assert mgr.restore(5, {"params": bf})["params"]["w"].dtype == \
        torch.bfloat16
    assert not hasattr(params["w"], "sharding")


if __name__ == "__main__":
    _oracle_main(sys.argv[1], ("seq4", "seq8"))
