"""The plain reference agrees with the port on a reduced configuration on
the CPU: phi, the sub-id scores, every item's score and the top-k.  (The
test imports both; the reference itself imports nothing of the port.)"""
import numpy as np
import pytest
import torch

from portbench import check, traffic, weights
from portbench.harness import program_config
from portbench.reference import sasrec as ref
from portbench.tests import tiny

from repro_torch.core import retrieval_head, scoring
from repro_torch.models import seqrec


@pytest.fixture(params=[("uint8", 16), ("uint16", 512)],
                ids=["uint8", "uint16"])
def model(request):
    code_dtype, b = request.param
    cfg = {**tiny.CONFIG, "pq": {"m": 4, "b": b, "code_dtype": code_dtype}}
    return cfg, weights.make(cfg, ref.layout(cfg), 77, "cpu")


def _seqs(cfg, n=12):
    hist = traffic.Histories(tiny.MIXES["tiny-closed"], cfg["n_items"], 5,
                             "cpu")
    hist.ensure(n)
    return [hist.get(i) for i in range(n)]


def test_reference_matches_the_port(model):
    cfg, params = model
    histories = _seqs(cfg)
    seqs = ref.pad_left(histories, cfg["max_seq_len"], torch.device("cpu"))
    scfg = program_config(cfg)
    with torch.no_grad():
        phi_port = seqrec.sequence_embedding(params, seqs.to(torch.int32),
                                             scfg)
        phi_ref = ref.phi(params, seqs, cfg["n_heads"])
        torch.testing.assert_close(phi_ref, phi_port, rtol=0, atol=2e-6)
        s_port = scoring.subid_scores(params["item_emb"]["sub_emb"], phi_ref)
        s_ref = ref.subid_scores(params["item_emb"]["sub_emb"], phi_ref)
        torch.testing.assert_close(s_ref, s_port, rtol=0, atol=1e-7)
        # Same S in: Algorithm 1 in tree_sum order is bit-identical.
        r_port = scoring.score_pqtopk(params["item_emb"]["codes"], s_ref)
        r_ref = ref.item_scores(params["item_emb"]["codes"], s_ref)
        assert torch.equal(r_ref, r_port)
        v_port, i_port = retrieval_head.top_items(
            params["item_emb"], phi_ref, 5, method="pqtopk_fused")
        v_ref, i_ref = ref.top_k(r_ref, 5)
        assert torch.equal(i_ref, i_port.long())
        assert torch.equal(v_ref, v_port)


def test_top_k_breaks_ties_to_the_lowest_id():
    scores = torch.tensor([[1.0, 3.0, 3.0, -0.0, 0.0, 3.0]])
    v, i = ref.top_k(scores, 6)
    assert i.tolist() == [[1, 2, 5, 0, 4, 3]]
    assert v.tolist() == [[3.0, 3.0, 3.0, 1.0, 0.0, -0.0]]
    assert not torch.signbit(v[0, 4]) and torch.signbit(v[0, 5])


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -12)])
    got = ref._round_tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                            -(1.0 + 2 ** -10)]


def test_judge_reads_zero_for_the_references_own_answers(model):
    cfg, params = model
    histories = _seqs(cfg, 6)
    scores = ref.all_scores(params, cfg, histories, "cpu")
    v, i = ref.top_k(scores, 5)
    got = check.judge(ref, params, cfg, histories, i.numpy(), v.numpy(),
                      "cpu")
    assert got == {"score_err": 0.0, "topk_gap": 0.0}
    # One answer moved to another item shows in both numbers.
    ids = i.numpy().copy()
    ids[2, 0] = (ids[2, 0] + 1) % (cfg["n_items"] + 1)
    bad = check.judge(ref, params, cfg, histories, ids, v.numpy(), "cpu")
    assert bad["score_err"] > 1e-4 and bad["topk_gap"] > 1e-4
    assert np.isfinite(list(bad.values())).all()
