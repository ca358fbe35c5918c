"""The check fails what it has to fail, at a size the CPU holds: the
control (the reference in TF32 put in the program's place) on three
seeds, and a run whose timed path is broken underneath; the port itself
passes on the same seeds.  On the card the same cells run whole."""
import pytest
import torch

from portbench import check, harness
from portbench.tests import tiny
from repro_torch.kernels.pqtopk import ops as kernel_ops
from repro_torch.models import seqrec

SEEDS = (2 ** 31 + 101, 7, 90_210)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("portbench"))


def _run(root, seed, cell="tiny.closed", **kw):
    return harness.run(root, cell, seed, 0.3, False, device="cpu",
                       log=lambda s: None, **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_and_the_port_passes(root, seed):
    got = _run(root, seed, control=True)
    limits = tiny.CONFIG["check"]["limits"]
    assert got["correct"], got["checks"]
    assert not check.verdict(got["control"], limits), got["control"]


def _altered_answer(monkeypatch):
    """Each query's best answer moved to the next item."""
    real = kernel_ops.pq_topk

    def fake(codes, s, k, **kw):
        v, i = real(codes, s, k, **kw)
        i = i.clone()
        i[:, 0] = (i[:, 0] + 1) % codes.shape[0]
        return v, i
    monkeypatch.setattr(kernel_ops, "pq_topk", fake)


def _stale_answer(monkeypatch):
    """A batch answered with the answers of the batch before it (the
    state left as it was)."""
    real = kernel_ops.pq_topk
    last = {}

    def fake(codes, s, k, **kw):
        out = real(codes, s, k, **kw)
        prev = last.get(s.shape[0], out)
        last[s.shape[0]] = out
        return prev
    monkeypatch.setattr(kernel_ops, "pq_topk", fake)


def _half_batch(monkeypatch):
    """The backbone run over the first half of the batch, its rows given
    to the second half too."""
    real = seqrec.sequence_embedding

    def fake(params, item_seq, cfg):
        half = max(1, item_seq.shape[0] // 2)
        phi = real(params, item_seq[:half], cfg)
        return phi.repeat(2, 1)[:item_seq.shape[0]]
    monkeypatch.setattr(seqrec, "sequence_embedding", fake)


@pytest.mark.parametrize("fault", [_altered_answer, _stale_answer,
                                   _half_batch],
                         ids=["altered_answer", "stale_answer",
                              "half_batch"])
@pytest.mark.parametrize("cell", ["tiny.closed", "tiny.open"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault, cell):
    fault(monkeypatch)
    got = _run(root, SEEDS[0], cell)
    assert not got["correct"], got["checks"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.closed", "tiny.open"])
def test_tiny_cells_on_the_card(root, cuda_device, cell):
    got = harness.run(root, cell, SEEDS[1], 1.0, True, device=cuda_device,
                      log=lambda s: None)
    assert got["correct"], got["checks"]
    assert got["device"]["busy_s"] > 0
    assert got["breakdown"]["device_ops"]
