"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no JAX, so it runs on a GPU host without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Every test here needs a CUDA device and skips on a host without one."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.pqtopk import kernel as tkernel, ops as tops
from repro_torch.kernels.pqtopk import ref as tref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(n, m, b, bq, code_dtype, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b, (n, m)).astype(code_dtype)
    codes[[n // 2, n - 1]] = codes[3]                    # tied rows
    s = rng.standard_normal((bq, m, b)).astype(np.float32)
    s[0, np.arange(m), codes[3].astype(np.int64)] = 50.0
    return torch.from_numpy(codes), torch.from_numpy(s)


@pytest.mark.parametrize("code_dtype,n,m,b", [
    ("int8", 777, 8, 128), ("uint8", 4097, 3, 100), ("uint16", 5001, 8, 512),
    ("int32", 513, 5, 100)])
def test_kernels_match_plain_versions(cuda_device, code_dtype, n, m, b):
    codes, s = _inputs(n, m, b, 11, code_dtype, seed=5)
    gc, gs = codes.to(cuda_device), s.to(cuda_device)
    before = tkernel.pq_scores_cuda.launches
    torch.testing.assert_close(tops.pq_scores(gc, gs).cpu(),
                               tref.pq_scores(codes, s), rtol=0, atol=0)
    assert tkernel.pq_scores_cuda.launches == before + 1
    tile = min(2048, -(-n // 128) * 128)
    idx = torch.tensor(list(range(tops.n_tiles(n, tile))) + [-1],
                       dtype=torch.int32)
    got = tops.pq_topk_slots(gc, gs, 16, idx.to(cuda_device), n_items=n,
                             tile=tile)
    want = tref.pq_topk_slots(codes, s, 16, idx, n_items=n, tile=tile)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    v, i = tops.pq_topk(gc, gs, 10)
    assert i[0, :3].tolist() == [3, n // 2, n - 1]
