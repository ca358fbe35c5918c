"""The port's training data and codebooks against the JAX reference, bit
for bit (atol=0): ``data/sequences.py`` (Zipf sampler, interactions, user
sequences, ``SeqRecDataset`` batches for both backbones) and
``core/codebook.py`` (``random``, ``kmeans`` and ``svd``, codes and
centroids)."""
import dataclasses

import numpy as np
import pytest

from repro.configs.base import PQConfig as JPQ
from repro.core import codebook as jcb
from repro.data import sequences as jseq
from repro_torch.configs.base import PQConfig as TPQ
from repro_torch.core import codebook as tcb
from repro_torch.data import sequences as tseq


def _eq(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_generators_identical():
    _eq(tseq.zipf_item_sampler(500, seed=3), jseq.zipf_item_sampler(500,
                                                                   seed=3))
    tu, ti = tseq.gen_interactions(40, 300, 6.0, seed=2)
    ju, ji = jseq.gen_interactions(40, 300, 6.0, seed=2)
    _eq(tu, ju)
    _eq(ti, ji)
    _eq(tseq.to_user_sequences(tu, ti, 40, 9),
        jseq.to_user_sequences(ju, ji, 40, 9))


@pytest.mark.parametrize("backbone", ["sasrec", "bert4rec"])
def test_dataset_batches_identical(backbone):
    t = tseq.SeqRecDataset.synthetic(120, 700, 10, 17, seed=4)
    j = jseq.SeqRecDataset.synthetic(120, 700, 10, 17, seed=4)
    _eq(t.sequences, j.sequences)
    for a, b in zip(t.interactions(), j.interactions()):
        _eq(a, b)
    ti = t.batches(16, 12, backbone=backbone, seed=5)
    ji = j.batches(16, 12, backbone=backbone, seed=5)
    for _ in range(4):
        tb, jb = next(ti), next(ji)
        assert list(tb) == list(jb) == ["input_seq", "targets", "negatives"]
        for k in tb:
            _eq(tb[k], jb[k])


@pytest.mark.parametrize("assign", ["random", "kmeans", "svd"])
def test_build_codebook_identical(assign):
    kw = dict(m=4, b=16, assign=assign, code_dtype="uint8")
    tpq, jpq = TPQ(**kw), JPQ(**kw)
    assert dataclasses.asdict(tpq) == dataclasses.asdict(jpq)
    n_items, d = 600, 32
    args = {}
    if assign == "kmeans":
        args["embeddings"] = np.random.default_rng(1).normal(
            0, 1, (n_items, d)).astype(np.float32)
    if assign == "svd":
        ds = jseq.SeqRecDataset.synthetic(150, n_items - 1, 12, 20, seed=0)
        u, i = ds.interactions()
        args["interactions"] = (u, i + 1, 150)
        args["d_model"] = d
    tc, tcent = tcb.build_codebook(tpq, n_items, seed=7, **args)
    jc, jcent = jcb.build_codebook(jpq, n_items, seed=7, **args)
    _eq(tc, jc)
    if jcent is None:
        assert tcent is None
    else:
        _eq(tcent, jcent)
    assert tc.min() >= 0 and tc.max() < tpq.b


def test_codebook_errors_match_reference():
    for kw, args in ((dict(assign="kmeans"), {}),
                     (dict(assign="svd"), {}),
                     (dict(assign="svd"), {"interactions": (
                         np.zeros(1, np.int64), np.zeros(1, np.int64), 1)})):
        with pytest.raises(ValueError) as want:
            jcb.build_codebook(JPQ(**kw), 10, **args)
        with pytest.raises(ValueError) as got:
            tcb.build_codebook(TPQ(**kw), 10, **args)
        assert str(got.value) == str(want.value)


def test_kmeans_dead_centroids_identical():
    """Duplicate points (items no user touched have zero SVD factors)
    leave clusters empty, which are re-seeded on the farthest point: the
    port finds that point once an iteration, the reference once a dead
    centroid; the centroids and assignments are the same."""
    rng = np.random.default_rng(2)
    x = np.zeros((400, 4), np.float32)
    x[:60] = rng.normal(0, 1, (60, 4))
    tc, ta = tcb._kmeans(x, 32, seed=3)
    jc, ja = jcb._kmeans(x, 32, seed=3)
    _eq(tc, jc)
    _eq(ta, ja)
