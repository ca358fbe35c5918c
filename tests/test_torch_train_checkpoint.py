"""Training checkpoints, restarts, the launcher and the end-to-end example
of the port against the JAX reference.

Checkpoints of named trees round-trip, save asynchronously, keep the
newest k and fall back past a truncated step; they cross between the two
packages in both directions, key for key (``m|item_emb|codes``,
``m|item_emb|pruned|packed``) and bit for bit, and a run restored from the
reference's checkpoint continues like the reference (rtol=atol=1e-5, the
backbone's contract).  ``run_with_restarts``, the train launcher with an
injected failure (``--reduced --device cpu``), the example at a small
size, and the twin of ``tests/test_system.py`` (150 steps: the loss falls
below 0.7 of the first, NDCG@10 beats random, the scoring methods agree).
"""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import codebook as jcb
from repro.data.sequences import SeqRecDataset
from repro.launch import train as jtrain
from repro.models import seqrec as jseqrec
from repro.training import checkpoint as jckpt, optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch.configs import base as tcfg
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.launch import train as ttrain
from repro_torch.models import seqrec as tseqrec
from repro_torch.training import checkpoint as tckpt, fault_tolerance as ft
from repro_torch.training import optimizer as topt, train_loop as ttl, tree

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "sasrec-recjpq"


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _same_tree(got, want):
    """Port tree against a reference tree, bit for bit (uint32 presence
    words against the port's int32)."""
    g = list(tree.leaves_with_path(got))
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(g) == len(w)
    for (p, t), (_, j) in zip(g, w):
        j = np.asarray(j)
        np.testing.assert_array_equal(t.numpy().view(j.dtype), j,
                                      err_msg=str(p))


def _close_tree(got, want):
    for (p, t), (_, j) in zip(tree.leaves_with_path(got),
                              jax.tree_util.tree_flatten_with_path(want)[0]):
        j = np.asarray(j)
        if np.issubdtype(j.dtype, np.floating):
            np.testing.assert_allclose(t.numpy(), j, err_msg=str(p), **TOL)
        else:
            np.testing.assert_array_equal(t.numpy().view(j.dtype), j)


# ---- the port's manager alone ---------------------------------------------

def _params():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4), "d": [torch.zeros(2, dtype=torch.int32),
                                            torch.full((3,), 2.5,
                                                       dtype=torch.bfloat16)]}}


def test_tree_round_trip_and_keep_k(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2, async_save=False)
    params = _params()
    for s in (10, 20, 30):
        mgr.save(s, {"params": params})
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    out = mgr.restore(30, {"params": params})["params"]
    for (p, a), (_, b) in zip(tree.leaves_with_path(params),
                              tree.leaves_with_path(out)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    with open(tmp_path / "step_0000000030" / "manifest.json") as f:
        groups = json.load(f)["groups"]["params"]
    assert list(groups) == ["a", "b|c", "b|d|0", "b|d|1"]
    assert groups["b|d|1"]["dtype"] == "bfloat16"


def test_async_save(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=3, async_save=True)
    params = {"a": torch.ones((128, 128))}
    mgr.save(1, {"params": params})
    params["a"].add_(1.0)        # the host copy was taken before the thread
    mgr.wait()
    assert mgr.all_steps() == [1]
    out = mgr.restore(1, {"params": params})["params"]["a"]
    assert torch.equal(out, torch.ones((128, 128)))


def test_restore_skips_truncated(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=5, async_save=False)
    params = {"a": torch.arange(64.0).reshape(8, 8)}
    mgr.save(10, {"params": params})
    mgr.save(20, {"params": params})
    victim = tmp_path / "step_0000000020" / "params.npz"
    with open(victim, "r+b") as f:          # torn write: drop the tail
        f.truncate(os.path.getsize(victim) // 2)
    assert not mgr.validate_step(20) and mgr.valid_steps() == [10]
    with pytest.raises(tckpt.CorruptCheckpointError, match="checksum"):
        mgr.restore(20, {"params": params})
    step, out = mgr.restore_latest({"params": params})
    assert step == 10 and torch.equal(out["params"]["a"], params["a"])
    with open(tmp_path / "step_0000000010" / "params.npz", "r+b") as f:
        f.truncate(8)
    with pytest.raises(tckpt.CorruptCheckpointError, match="no valid"):
        mgr.restore_latest({"params": params})
    # A tree without shardings restores as its template says.
    mgr.save(30, {"params": params})
    out = mgr.restore(30, {"params": params}, shardings={"params": None})
    assert torch.equal(out["params"]["a"], params["a"])


# ---- across the two packages --------------------------------------------

@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference trains 2 steps, checkpoints, and continues 3 more:
    its configs, loss, batches, checkpoint directory and trajectory."""
    jc = jcfg.get_reduced(ARCH).model
    tc = tcfg.get_reduced(ARCH).model
    cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    step = jax.jit(jtl.make_train_step(
        lambda p, b: jseqrec.seqrec_loss(p, b, jc), cfg))
    p = jseqrec.init_seqrec(jax.random.PRNGKey(0), jc)
    s = jtl.init_opt_state(p, cfg)
    ds = SeqRecDataset.synthetic(64, jc.n_items, 10, jc.max_seq_len, seed=0)
    it = ds.batches(8, jc.n_negatives, backbone="sasrec", seed=1)
    batches = [next(it) for _ in range(5)]
    for b in batches[:2]:
        p, s, _ = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    jckpt.CheckpointManager(d, async_save=False).save(2, {"params": p,
                                                          "opt_state": s})
    at2 = (_np(p), _np(s))
    traj = []
    for b in batches[2:]:
        p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
        traj.append((_np(p), _np(s), {k: float(v) for k, v in m.items()}))
    return jc, tc, d, at2, batches, traj


def test_reference_checkpoint_restores_and_continues(reference_run):
    """The port restores the reference's step-2 checkpoint into its own
    templates (its own random weights), bit for bit, and its next three
    steps follow the reference's."""
    jc, tc, d, (jp2, js2), batches, traj = reference_run
    cfg = topt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    tp = tseqrec.init_seqrec(torch.Generator().manual_seed(0), tc)
    ts = ttl.init_opt_state(tp, cfg)
    mgr = tckpt.CheckpointManager(d)
    assert mgr.latest_step() == 2
    out = mgr.restore(2, {"params": tp, "opt_state": ts})
    tp, ts = out["params"], out["opt_state"]
    assert tp["item_emb"]["pruned"].packed.dtype == torch.int32
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 2
    _same_tree(tp, jp2)
    _same_tree(ts, js2)
    step = ttl.make_train_step(lambda p, b: tseqrec.seqrec_loss(p, b, tc), cfg)
    for b, (jp, js, jm) in zip(batches[2:], traj):
        tp, ts, tm = step(tp, ts, _tb(b))
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), jm[k], **TOL)
        _close_tree(tp, jp)
        _close_tree(ts, js)


def test_port_checkpoint_restores_in_reference(reference_run, tmp_path):
    """The port's checkpoint of the same state restores in the reference's
    ``CheckpointManager.restore`` bit for bit, with the reference's keys,
    dtypes and manifest."""
    jc, tc, ref_dir, (jp2, js2), _, _ = reference_run
    tp, ts = params_from_jax(jp2), opt_state_from_jax(js2)
    tckpt.CheckpointManager(str(tmp_path)).save(2, {"params": tp,
                                                    "opt_state": ts},
                                                block=True)
    for name in ("params", "opt_state"):
        with np.load(tmp_path / "step_0000000002" / f"{name}.npz") as a, \
                np.load(os.path.join(ref_dir, "step_0000000002",
                                     f"{name}.npz")) as b:
            assert a.files == b.files
            assert "m|item_emb|codes" in a.files or name == "params"
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(tmp_path / "step_0000000002" / "manifest.json") as f:
        mine = json.load(f)["groups"]
    with open(os.path.join(ref_dir, "step_0000000002", "manifest.json")) as f:
        assert mine == json.load(f)["groups"]
    assert "m|item_emb|pruned|packed" in mine["opt_state"]
    cfg = jopt.AdamWConfig()
    templ_p = jseqrec.init_seqrec(jax.random.PRNGKey(1), jc)
    out = jckpt.CheckpointManager(str(tmp_path)).restore(
        2, {"params": templ_p, "opt_state": jtl.init_opt_state(templ_p, cfg)})
    _same_tree(tp, out["params"])
    _same_tree(ts, out["opt_state"])


def test_bfloat16_moments_cross(tmp_path):
    """bfloat16 moments: the port writes the reference's bytes and dtype
    names, and restores the reference's file bit for bit (the reference's
    own restore of such a file fails in numpy's cast, ROADMAP C8)."""
    params = {"w": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)}
    cfg = jopt.AdamWConfig(moment_dtype="bfloat16")
    js = jopt.adamw_init(params, cfg)
    js = jax.tree_util.tree_map(lambda x: x + 0.375 if x.ndim else x, js)
    jd, td = tmp_path / "ref", tmp_path / "port"
    jckpt.CheckpointManager(str(jd), async_save=False).save(1, {"s": js})
    ts = opt_state_from_jax(_np(js))
    assert ts["m"]["w"].dtype == torch.bfloat16
    tckpt.CheckpointManager(str(td)).save(1, {"s": ts}, block=True)
    with np.load(jd / "step_0000000001" / "s.npz") as a, \
            np.load(td / "step_0000000001" / "s.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
    out = tckpt.CheckpointManager(str(jd)).restore(
        1, {"s": topt.adamw_init(params_from_jax(params),
                                 topt.AdamWConfig(moment_dtype="bfloat16"))})
    assert torch.equal(out["s"]["m"]["w"], ts["m"]["w"])
    assert torch.equal(out["s"]["v"]["w"], ts["v"]["w"])


# ---- restarts and the launcher ------------------------------------------

def test_run_with_restarts():
    calls = []

    def train(state, restarts):
        calls.append((state, restarts))
        if restarts < 2:
            raise ft.SimulatedFailure(f"boom {restarts}")
        return "done"

    assert ft.run_with_restarts(lambda: len(calls), train) == "done"
    assert calls == [(0, 0), (1, 1), (2, 2)]
    with pytest.raises(ft.SimulatedFailure):
        ft.run_with_restarts(lambda: 0, lambda s, r: (_ for _ in ()).throw(
            ft.SimulatedFailure("always")), max_restarts=1)


_LINE = re.compile(r"step +(\d+) loss [-\d.]+ gnorm [\d.]+$"
                   r"|resumed from step (\d+)$"
                   r"|finished (\d+) steps \((\d+) straggler steps flagged\)$")


def _shape(out: str):
    """The launcher's printed lines as (kind, numbers): step lines by
    step, resume and finish lines with their counts (straggler counts are
    host timing, so not compared)."""
    lines = []
    for ln in out.strip().splitlines():
        m = _LINE.match(ln)
        assert m, ln
        if m.group(1) is not None:
            lines.append(("step", int(m.group(1))))
        elif m.group(2) is not None:
            lines.append(("resumed", int(m.group(2))))
        else:
            lines.append(("finished", int(m.group(3))))
    return lines


def test_launcher_resumes_like_reference(tmp_path, capsys):
    argv = ["--arch", ARCH, "--reduced", "--steps", "30", "--batch", "8",
            "--ckpt-every", "5", "--fail-at", "12", "--log-every", "5"]
    jtrain.main(argv + ["--ckpt", str(tmp_path / "ref")])
    want = capsys.readouterr().out
    out = ttrain.main(argv + ["--ckpt", str(tmp_path / "port"), "--device",
                              "cpu"])
    got = capsys.readouterr().out
    assert _shape(got) == _shape(want)
    assert ("resumed", 10) in _shape(got) and _shape(got)[-1] == (
        "finished", 30)
    assert len(out["losses"]) == 30 and np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
    mgr = tckpt.CheckpointManager(str(tmp_path / "port"))
    assert mgr.latest_step() == 30
    for name in ("params", "opt_state"):
        with np.load(tmp_path / "port" / "step_0000000030" / f"{name}.npz") \
                as a, np.load(tmp_path / "ref" / "step_0000000030" /
                              f"{name}.npz") as b:
            assert a.files == b.files
            assert all(a[k].dtype == b[k].dtype for k in a.files)
    final = mgr.restore(30, {"params": out["params"],
                             "opt_state": out["opt_state"]})
    for a, b in zip(tree.leaves(final), tree.leaves(
            {"params": out["params"], "opt_state": out["opt_state"]})):
        assert torch.equal(a, b)


def test_launcher_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--arch", ARCH, "--reduced", "--steps", "1"])


def test_launcher_trains_recsys_on_cpu(capsys):
    out = ttrain.main(["--arch", "fm", "--reduced", "--steps", "4",
                       "--batch", "64", "--device", "cpu"])
    assert "finished 4 steps" in capsys.readouterr().out
    assert np.isfinite(out["losses"]).all()


# ---- the example, and the twin of tests/test_system.py ------------------

def test_example_small(tmp_path, capsys):
    from repro_torch.examples import train_sasrec_recjpq as ex
    out = ex.main(["--items", "2000", "--users", "300", "--steps", "30",
                   "--d-model", "32", "--seq-len", "20", "--m", "4", "--b",
                   "32", "--ckpt", str(tmp_path), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "NDCG@10  model=" in text and "checkpoint saved to" in text
    ds = SeqRecDataset.synthetic(300, 2000, 12, 21, seed=0)
    u, i = ds.interactions()
    from repro.configs.base import PQConfig
    codes, _ = jcb.build_codebook(PQConfig(m=4, b=32, assign="svd"), 2001,
                                  d_model=32, interactions=(u, i + 1, 300))
    np.testing.assert_array_equal(out["codes"], codes)
    losses = out["losses"]
    assert np.isfinite(losses).all() and losses[-1] < 0.7 * losses[0]
    assert 0.0 <= out["ndcg"] <= 1.0 and out["pop_ndcg"] > 0
    assert tckpt.CheckpointManager(str(tmp_path)).latest_step() == 30


def _ndcg_at_k(ranks, k=10):
    hit = (ranks >= 0) & (ranks < k)
    gains = np.zeros(ranks.shape, np.float64)
    gains[hit] = 1.0 / np.log2(ranks[hit] + 2)
    return float(gains.mean())


@pytest.fixture(scope="module")
def trained_model():
    """The reference test's recipe on the port: reduced SASRec-RecJPQ,
    SVD codebook, 150 steps of batch 32."""
    cfg = tcfg.get_reduced(ARCH).model
    ds = SeqRecDataset.synthetic(400, cfg.n_items, 12, cfg.max_seq_len + 1,
                                 seed=0)
    users, items = ds.interactions()
    from repro_torch.core import codebook
    codes, _ = codebook.build_codebook(
        cfg.pq, cfg.n_items + 1, d_model=cfg.d_model,
        interactions=(users, items + 1, len(ds.sequences)))
    params = tseqrec.init_seqrec(torch.Generator().manual_seed(0), cfg,
                                 codes=codes)
    ocfg = topt.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=400)
    opt_state = ttl.init_opt_state(params, ocfg)
    step = ttl.make_train_step(lambda p, b: tseqrec.seqrec_loss(p, b, cfg),
                               ocfg)
    it = ds.batches(32, cfg.n_negatives, backbone="sasrec", seed=1)
    losses = []
    for _ in range(150):
        params, opt_state, m = step(params, opt_state, _tb(next(it)))
        losses.append(float(m["loss"]))
    return cfg, ds, params, losses[0], losses[-1]


def test_training_reduces_loss(trained_model):
    _, _, _, first, last = trained_model
    assert last < first * 0.7, (first, last)


def test_serving_beats_random_ndcg(trained_model):
    cfg, ds, params, _, _ = trained_model
    seqs = ds.sequences
    valid = seqs[:, -1] != 0
    prefix, held = torch.from_numpy(seqs[valid][:, :-1]), seqs[valid][:, -1]
    with torch.inference_mode():
        ids, _ = tseqrec.serve_topk(params, prefix, cfg, k=50,
                                    method="pqtopk")
    ids = ids.numpy()
    ranks = np.full(len(held), -1)
    for u in range(len(held)):
        where = np.nonzero(ids[u] == held[u])[0]
        if len(where):
            ranks[u] = where[0]
    assert _ndcg_at_k(ranks, 10) > 5 * (10 / cfg.n_items)


def test_scoring_method_ndcg_invariance(trained_model):
    """Paper Table 3: the trained model ranks alike under every method
    (the reference test's tolerance, rtol=1e-3, atol=1e-4)."""
    cfg, ds, params, _, _ = trained_model
    prefix = torch.from_numpy(ds.sequences[:64, :-1])
    results = {}
    with torch.inference_mode():
        for meth in ("dense", "recjpq", "pqtopk", "pqtopk_onehot",
                     "pqtopk_kernel", "pqtopk_fused"):
            results[meth] = tseqrec.serve_topk(params, prefix, cfg, k=10,
                                               method=meth)
    for meth in ("recjpq", "pqtopk", "pqtopk_onehot"):
        np.testing.assert_allclose(results[meth][1].numpy(),
                                   results["dense"][1].numpy(), rtol=1e-3,
                                   atol=1e-4)
    for meth in ("pqtopk_kernel", "pqtopk_fused"):
        assert torch.equal(results[meth][0], results["pqtopk"][0])
        assert torch.equal(results[meth][1], results["pqtopk"][1])


def test_pq_memory_compression_vs_dense(trained_model):
    cfg, _, params, _, _ = trained_model
    dense_bytes = (cfg.n_items + 1) * cfg.d_model * 4
    pq_bytes = (params["item_emb"]["codes"].numel() * 4
                + params["item_emb"]["sub_emb"].numel() * 4)
    assert pq_bytes < dense_bytes
