"""The port's training slice as a whole against the JAX reference:
``seqrec_loss`` (SASRec and gBERT4Rec) and ``ctr_loss`` (DCN-v2, BST,
DIEN, FM) with every leaf's gradient, and five steps of
``make_train_step`` at ``grad_accum`` 1 and 4, compared step by step.

Each reduced model starts from the reference's own ``init_*(PRNGKey(0))``
carried over by ``interop.params_from_jax`` (the optimizer state by
``opt_state_from_jax``); batches are the reference's data streams.
Tolerance rtol=atol=1e-5 (the backbone's contract: float32, and the two
frameworks' matmuls and scatter-adds sum in different orders); integer
leaves bit for bit, and the reference's ``float0`` gradients are the
port's ``None``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.data import recsys_data as jrdata
from repro.data.sequences import SeqRecDataset
from repro.distributed.sharding import path_str
from repro.models import recsys as jrecsys, seqrec as jseqrec
from repro.training import optimizer as jopt, train_loop as jtl
from repro_torch.configs import base as tcfg
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.models import recsys as trecsys, seqrec as tseqrec
from repro_torch.training import optimizer as topt, train_loop as ttl, tree

TOL = dict(rtol=1e-5, atol=1e-5)
SEQREC = ("sasrec-recjpq", "gbert4rec-recjpq")
RECSYS = ("dcn-v2", "bst", "dien", "fm")
STEPS = 5


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _fns(arch):
    """(reference cfg, port cfg, reference loss, port loss, reference
    params)."""
    jc, tc = jcfg.get_reduced(arch).model, tcfg.get_reduced(arch).model
    if arch in SEQREC:
        return (jc, tc, lambda p, b: jseqrec.seqrec_loss(p, b, jc),
                lambda p, b: tseqrec.seqrec_loss(p, b, tc),
                jseqrec.init_seqrec(jax.random.PRNGKey(0), jc))
    return (jc, tc, lambda p, b: jrecsys.ctr_loss(p, b, jc),
            lambda p, b: trecsys.ctr_loss(p, b, tc),
            jrecsys.init_recsys(jax.random.PRNGKey(0), jc))


def _batches(arch, jc, n, batch=8):
    if arch in SEQREC:
        ds = SeqRecDataset.synthetic(64, jc.n_items, 10, jc.max_seq_len,
                                     seed=0)
        it = ds.batches(batch, jc.n_negatives, backbone=jc.backbone, seed=1)
    else:
        it = jrdata.ctr_batches(jc, batch, seed=1)
    return [next(it) for _ in range(n)]


def _assert_grads(tg, jg):
    """Every leaf in the reference's order: float leaves within TOL,
    integer leaves ``None`` against ``float0``."""
    got = list(tree.leaves_with_path(tg))
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [tree.path_str(p) for p, _ in got if _ is not None] == \
        [path_str(p) for p, w in want if w.dtype != jax.dtypes.float0]
    for path, w in want:
        if w.dtype == jax.dtypes.float0:
            continue
        g = dict((tree.path_str(p), x) for p, x in got)[path_str(path)]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=path_str(
            path), **TOL)


def _assert_params(tp, jp, scaled=False):
    """Every leaf, paired by path (the same paths in the same order):
    float leaves within TOL, or (``scaled``, for the second moments, whose
    entries are 1e-7 to 1e-4) within rtol=1e-5 and an atol of 1e-5 times
    the leaf's largest magnitude; integer leaves bit for bit."""
    got = list(tree.leaves_with_path(tp))
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [tree.path_str(p) for p, _ in got] == \
        [path_str(p) for p, _ in want]
    for (p, t), (_, j) in zip(got, want, strict=True):
        j = np.asarray(j)
        if np.issubdtype(j.dtype, np.floating):
            tol = TOL if not scaled else dict(
                rtol=TOL["rtol"], atol=TOL["atol"] * float(np.abs(j).max()))
            np.testing.assert_allclose(t.numpy(), j, err_msg=str(p), **tol)
        else:
            np.testing.assert_array_equal(t.numpy().view(j.dtype), j)


@pytest.mark.parametrize("arch", SEQREC + RECSYS)
def test_loss_and_gradients_match_reference(arch):
    """The loss value, its metrics, and every leaf's gradient."""
    jc, tc, jloss, tloss, jp = _fns(arch)
    batch = _batches(arch, jc, 1)[0]
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True,
                                              allow_int=True))(jp, _jb(batch))
    tl, tm, tg = ttl.value_and_grad(tloss, params_from_jax(_np(jp)),
                                    _tb(batch))
    assert set(tm) == set(jm) == {"nll" if arch in SEQREC else "bce"}
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    _assert_grads(tg, jg)
    if arch == "gbert4rec-recjpq":
        # The masked inputs are id 0 (padding), so the loss never reads
        # mask_emb: a zero gradient in both packages, not a missing one.
        assert not np.asarray(jg["mask_emb"]).any()
        assert torch.equal(tg["mask_emb"], torch.zeros_like(tg["mask_emb"]))


@pytest.fixture(scope="module")
def reference_steps():
    """The reference's jitted train steps, one compile per (arch,
    grad_accum), and its trajectory over five batches."""
    out = {}
    for arch, ga in (("sasrec-recjpq", 1), ("sasrec-recjpq", 4),
                     ("gbert4rec-recjpq", 1), ("gbert4rec-recjpq", 4),
                     ("dien", 4)):
        jc, tc, jloss, tloss, jp = _fns(arch)
        cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
        step = jax.jit(jtl.make_train_step(jloss, cfg, grad_accum=ga))
        state = jtl.init_opt_state(jp, cfg)
        batches = _batches(arch, jc, STEPS)
        start = (_np(jp), _np(state))
        traj = []
        for b in batches:
            jp, state, m = step(jp, state, _jb(b))
            traj.append((_np(jp), _np(state), {k: float(v)
                                               for k, v in m.items()}))
        out[(arch, ga)] = (tloss, start, batches, traj)
    return out


@pytest.mark.parametrize("arch,ga", [("sasrec-recjpq", 1),
                                     ("sasrec-recjpq", 4),
                                     ("gbert4rec-recjpq", 1),
                                     ("gbert4rec-recjpq", 4), ("dien", 4)])
def test_train_steps_match_reference(reference_steps, arch, ga):
    """Five steps from the same weights, state and batches: loss, the loss
    function's metric, grad_norm and lr every step, and every parameter
    and moment.  gBERT4Rec's ``mask_emb`` moves by weight decay alone."""
    tloss, (jp0, js0), batches, traj = reference_steps[(arch, ga)]
    cfg = topt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    step = ttl.make_train_step(tloss, cfg, grad_accum=ga)
    tp, ts = params_from_jax(jp0), opt_state_from_jax(js0)
    for b, (jp, js, jm) in zip(batches, traj):
        tp, ts, tm = step(tp, ts, _tb(b))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), jm[k], err_msg=k, **TOL)
        _assert_params(tp, jp)
        _assert_params(ts["m"], js["m"])
        _assert_params(ts["v"], js["v"], scaled=True)
        assert int(ts["step"]) == int(js["step"])
    if arch == "gbert4rec-recjpq":
        np.testing.assert_array_equal(ts["m"]["mask_emb"].numpy(), 0)
        lrs = [topt.schedule_lr(cfg, torch.tensor(s, dtype=torch.int32))
               for s in range(1, STEPS + 1)]
        want = torch.from_numpy(np.array(jp0["mask_emb"]))
        for lr in lrs:
            want = want - lr * (cfg.weight_decay * want)
        torch.testing.assert_close(tp["mask_emb"], want, rtol=1e-6,
                                   atol=1e-7)
