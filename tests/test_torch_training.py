"""The port's optimizers, losses and train step
(``repro_torch.training``) against the JAX reference.

Inputs are numpy from a seed; the reference runs jitted, the port eagerly
on the CPU.  Tolerances: learning rates at rtol=1e-6, atol=1e-9 (float32
``cos``/``rsqrt`` of the two libraries may differ in the last bit);
optimizer updates, losses, gradients and the global norm at
rtol=atol=1e-6 (float32; XLA may reassociate a sum).  Integer leaves and frozen paths must come back unchanged, bit
for bit, and the reference's ``float0`` gradients are the port's
``None``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import losses as jlosses, optimizer as jopt
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.training import losses as tlosses, optimizer as topt
from repro_torch.training import train_loop as ttl, tree

TOL = dict(rtol=1e-6, atol=1e-6)
SCHEDULES = ("cosine", "rsqrt", "constant")


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float64), np.asarray(
        want, np.float64), **(tol or TOL))


def _assert_tree(got, want, **tol):
    """Port tree ``got`` against reference tree ``want`` leaf for leaf,
    in the reference's order: integer leaves bit for bit."""
    g = list(tree.leaves_with_path(got))
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(g) == len(w)
    for (gp, gl), (_, wl) in zip(g, w):
        wl = np.asarray(wl)
        if wl.dtype.name == "bfloat16":
            wl = wl.astype(np.float32)
        if not np.issubdtype(wl.dtype, np.floating):
            np.testing.assert_array_equal(gl.numpy(), wl, err_msg=str(gp))
        else:
            _close(gl, wl, **tol)


def _mixed_tree(seed=0):
    """A float matrix and bias, a float leaf on a ``codes`` path (frozen
    by ``default_frozen``), an integer leaf, and a list."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(0, 1, (4, 3)).astype(np.float32),
        "b": rng.normal(0, 1, (3,)).astype(np.float32),
        "emb": {"codes": rng.normal(0, 1, (5, 2)).astype(np.float32)},
        "ids": rng.integers(0, 9, (5, 2)).astype(np.int32),
        "blocks": [rng.normal(0, 1, (2, 6)).astype(np.float32),
                   rng.normal(0, 1, (6,)).astype(np.float32)],
    }


def _grads(params, seed, scale=5.0):
    """(reference grads with float0 at integer leaves, port grads with
    None there)."""
    rng = np.random.default_rng(seed)
    g = jax.tree_util.tree_map(
        lambda p: (rng.normal(0, scale, p.shape).astype(np.float32)
                   if np.issubdtype(p.dtype, np.floating)
                   else np.zeros(p.shape, jax.dtypes.float0)), params)
    t = jax.tree_util.tree_map(
        lambda x: None if x.dtype == jax.dtypes.float0
        else torch.from_numpy(x), g)
    return g, t


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_lr_matches_reference(schedule):
    j = jopt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100,
                         schedule=schedule)
    t = topt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100,
                         schedule=schedule)
    want = jax.jit(jax.vmap(lambda s: jopt.schedule_lr(j, s)))(
        jnp.arange(121, dtype=jnp.int32))
    got = torch.stack([topt.schedule_lr(t, torch.tensor(s, dtype=torch.int32))
                       for s in range(121)])
    assert got.dtype == torch.float32
    # Near the end of the cosine the rates approach 0, where the two
    # libraries' float32 cos differ by up to 1.75e-10 absolute (measured).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype):
    """Three steps on a mixed tree with clipping active: parameters,
    moments (in ``moment_dtype``), step, grad norm and lr.  The integer
    leaf and the frozen ``emb/codes`` path keep their values, and their
    moments stay zero."""
    params = _mixed_tree()
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            moment_dtype=moment_dtype)
    tcfg = topt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            moment_dtype=moment_dtype)
    jp, js = params, jopt.adamw_init(params, jcfg)
    tp = params_from_jax(params)
    ts = opt_state_from_jax(_np(js))
    jupd = jax.jit(lambda g, s, p: jopt.adamw_update(
        g, s, p, jcfg, frozen=jopt.default_frozen))
    for step in range(3):
        jg, tg = _grads(params, seed=step + 1)
        jp, js, jm = jupd(jg, js, jp)
        tp, ts, tm = topt.adamw_update(tg, ts, tp, tcfg,
                                       frozen=topt.default_frozen)
        _close(tm["grad_norm"], jm["grad_norm"])
        _close(tm["lr"], jm["lr"])
        assert float(jm["grad_norm"]) > tcfg.clip_norm   # clipping is on
        _assert_tree(tp, jp)
        _assert_tree(ts["m"], js["m"])
        _assert_tree(ts["v"], js["v"])
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
    assert ts["m"]["w"].dtype == getattr(torch, moment_dtype)
    np.testing.assert_array_equal(tp["ids"].numpy(), params["ids"])
    np.testing.assert_array_equal(tp["emb"]["codes"].numpy(),
                                  params["emb"]["codes"])
    assert not ts["m"]["emb"]["codes"].any()


def test_clip_by_global_norm_matches_reference():
    params = _mixed_tree(1)
    jg, tg = _grads(params, seed=7)
    for max_norm in (0.5, 1e6):
        jc, jn = jopt.clip_by_global_norm(jg, max_norm)
        tc, tn = topt.clip_by_global_norm(tg, max_norm)
        _close(tn, jn)
        assert tc["ids"] is None
        _assert_tree({k: v for k, v in tc.items() if k != "ids"},
                     {k: v for k, v in jc.items() if k != "ids"})
        _close(topt.global_norm(tg), jopt.global_norm(jg))


def test_adafactor_matches_reference():
    """Factored (2-D and 3-D) and unfactored leaves (a vector, a (1, n)
    matrix), an integer leaf, weight decay on: three steps of parameters
    and state, and the state's byte count."""
    rng = np.random.default_rng(3)
    params = {"m2": rng.normal(0, 1, (4, 6)).astype(np.float32),
              "m3": rng.normal(0, 1, (2, 3, 5)).astype(np.float32),
              "vec": rng.normal(0, 1, (7,)).astype(np.float32),
              "row": rng.normal(0, 1, (1, 5)).astype(np.float32),
              "ids": rng.integers(0, 4, (3,)).astype(np.int32)}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.01)
    jcfg, tcfg = jopt.AdafactorConfig(**kw), topt.AdafactorConfig(**kw)
    jp, js = params, jopt.adafactor_init(params, jcfg)
    tp, ts = params_from_jax(params), opt_state_from_jax(_np(js))
    assert set(ts["v"]["m3"]) == {"vr", "vc"} and set(ts["v"]["vec"]) == {"v"}
    assert set(ts["v"]["ids"]) == {"_"}
    jupd = jax.jit(lambda g, s, p: jopt.adafactor_update(g, s, p, jcfg))
    for step in range(3):
        jg, tg = _grads(params, seed=10 + step, scale=1.0)
        jp, js, jm = jupd(jg, js, jp)
        tp, ts, tm = topt.adafactor_update(tg, ts, tp, tcfg)
        _close(tm["grad_norm"], jm["grad_norm"])
        _close(tm["lr"], jm["lr"])
        _assert_tree(tp, jp)
        _assert_tree(ts["v"], js["v"])
        assert int(ts["step"]) == int(js["step"])
    fresh = topt.adafactor_init(params_from_jax(params), tcfg)
    _assert_tree(fresh["v"], jopt.adafactor_init(params, jcfg)["v"], rtol=0,
                 atol=0)
    assert topt.adafactor_state_bytes(params_from_jax(params)) == \
        jopt.adafactor_state_bytes(params)


def _loss_cases(rng):
    pos = rng.normal(0, 2, (6,)).astype(np.float32)
    neg = rng.normal(0, 2, (6, 9)).astype(np.float32)
    logq = rng.normal(-3, 1, (9,)).astype(np.float32)
    plogq = rng.normal(-3, 1, (6,)).astype(np.float32)
    logits = rng.normal(0, 3, (5, 4, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (5, 4)).astype(np.int32)
    blog = rng.normal(0, 3, (32,)).astype(np.float32)
    blab = rng.integers(0, 2, (32,)).astype(np.float32)
    return {
        "sampled_softmax_logq": ((pos, neg, logq), {}),
        "sampled_softmax_logq_pos": ((pos, neg, logq), {"pos_logq": plogq}),
        "bce_with_logits": ((blog, blab), {}),
        "softmax_xent": ((logits, labels), {}),
    }


@pytest.mark.parametrize("case", ["sampled_softmax_logq",
                                  "sampled_softmax_logq_pos",
                                  "bce_with_logits", "softmax_xent"])
def test_losses_match_reference(case):
    """Values and the gradient of the first (score) argument."""
    args, kw = _loss_cases(np.random.default_rng(0))[case]
    name = case.replace("_pos", "")
    jf, tf = getattr(jlosses, name), getattr(tlosses, name)
    jv, jgrad = jax.value_and_grad(
        lambda x: jf(x, *[jnp.asarray(a) for a in args[1:]],
                     **{k: jnp.asarray(v) for k, v in kw.items()}))(
        jnp.asarray(args[0]))
    x = torch.from_numpy(args[0]).requires_grad_(True)
    tv = tf(x, *[torch.from_numpy(a) for a in args[1:]],
            **{k: torch.from_numpy(v) for k, v in kw.items()})
    tv.backward()
    _close(tv.detach(), jv)
    _close(x.grad, jgrad)


# ---- twins of the reference's tests/test_training.py --------------------

def test_adamw_converges_quadratic():
    target = torch.tensor([[1.0, -2.0], [0.5, 3.0]])
    params = {"w": torch.zeros((2, 2))}

    def loss_fn(p, batch):
        loss = torch.mean((p["w"] - target) ** 2)
        return loss, {"l": loss}

    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                           total_steps=500, schedule="constant")
    state = ttl.init_opt_state(params, cfg)
    step = ttl.make_train_step(loss_fn, cfg)
    for _ in range(300):
        params, state, m = step(params, state, {})
    assert float(m["loss"]) < 1e-3
    assert set(m) == {"l", "loss", "grad_norm", "lr"}


def test_grad_accum_matches_full_batch():
    """grad_accum=4 must equal one full-batch step (linear model => exact
    up to float32 rounding of the mean)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (16, 4)).astype(np.float32))
    y = torch.from_numpy(rng.normal(0, 1, (16,)).astype(np.float32))
    params = {"w": torch.zeros((4,))}

    def loss_fn(p, batch):
        pred = batch["x"] @ p["w"]
        return torch.mean((pred - batch["y"]) ** 2), {}

    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=0.0,
                           warmup_steps=1, schedule="constant")
    p1, _, _ = ttl.make_train_step(loss_fn, cfg)(
        params, ttl.init_opt_state(params, cfg), {"x": x, "y": y})
    p2, _, _ = ttl.make_train_step(loss_fn, cfg, grad_accum=4)(
        params, ttl.init_opt_state(params, cfg), {"x": x, "y": y})
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_frozen_paths_not_updated():
    params = {"codes": torch.ones((3, 2), dtype=torch.int32),
              "w": torch.ones((2,))}

    def loss_fn(p, batch):
        return torch.sum(p["w"] ** 2), {}

    cfg = topt.AdamWConfig(lr=0.1)
    state = ttl.init_opt_state(params, cfg)
    p2, _, _ = ttl.make_train_step(loss_fn, cfg)(params, state, {})
    assert torch.equal(p2["codes"], params["codes"])
    assert float((p2["w"] - params["w"]).abs().max()) > 0


def test_unused_float_leaf_gets_zero_gradient():
    """``jax.value_and_grad(allow_int=True)`` gives an unused float leaf
    zeros (so weight decay and the norm still see it) and an integer leaf
    ``float0``; the port gives zeros and ``None``."""
    params = {"used": torch.ones((3,)), "unused": torch.full((2,), 2.0),
              "ids": torch.arange(4, dtype=torch.int32)}
    loss, _, grads = ttl.value_and_grad(
        lambda p, b: ((p["used"] * 3).sum(), {}), params, {})
    assert float(loss) == 9.0 and grads["ids"] is None
    assert torch.equal(grads["unused"], torch.zeros(2))
    assert torch.equal(grads["used"], torch.full((3,), 3.0))
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=1,
                           schedule="constant")
    p2, _, _ = ttl.make_train_step(
        lambda p, b: ((p["used"] * 3).sum(), {}), cfg)(
        params, ttl.init_opt_state(params, cfg), {})
    np.testing.assert_allclose(p2["unused"].numpy(), [1.9, 1.9], rtol=1e-6)


def test_mesh_options_name_the_roadmap_item():
    """The mesh options are ported (ROADMAP A 6b): PowerSGD still needs
    its mesh, and ``init_opt_state(powersgd=True)`` adds the error
    feedback (float32 zeros; a 0-d zero for an integer leaf)."""
    cfg = topt.AdamWConfig()
    with pytest.raises(ValueError, match="mesh"):
        ttl.make_train_step(lambda p, b: (0, {}), cfg, powersgd_axis="pod")
    st = ttl.init_opt_state({"w": torch.zeros(2, dtype=torch.bfloat16),
                             "ids": torch.arange(3)}, cfg, powersgd=True)
    assert torch.equal(st["ef"]["w"], torch.zeros(2))
    assert st["ef"]["ids"].shape == () and st["ef"]["w"].dtype == \
        torch.float32


def test_tree_leaf_order_is_the_references():
    """Dict keys sorted, lists in order, the pruning state's array fields
    in registration order: the same paths as ``tree_flatten_with_path``."""
    from repro.configs import base as jcfg
    from repro.distributed.sharding import path_str
    from repro.models import seqrec as jseqrec
    cfg = jcfg.get_reduced("gbert4rec-recjpq").model
    jp = jseqrec.init_seqrec(jax.random.PRNGKey(0), cfg)
    want = [path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(
        jp)[0]]
    got = [tree.path_str(p) for p, _ in tree.leaves_with_path(
        params_from_jax(_np(jp)))]
    assert got == want and "item_emb/pruned/packed" in got
