"""The port's embedding-bag kernel wrapper and embedding substrate against
the JAX reference.

The same numpy inputs from a seed go through the reference's
``ops.embedding_bag`` (the Pallas kernel in interpret mode on the CPU, as
``tests/test_kernels.py`` runs it) and its ``ref.embedding_bag``, and
through the port's ``ops.embedding_bag`` (its plain version on the CPU)
and ``ref.embedding_bag``, at rtol=1e-5, atol=1e-6 (the reference reduces
a bag in one vectorised sum, the port slot by slot, as its CUDA kernel
does).  The substrate (``lookup_fields``, ``lookup_bag`` with and without
the kernel, ``segment_embedding_bag``) is held against
``repro.models.embedding`` the same way."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as jops, ref as jref
from repro.models import embedding as jemb
from repro_torch.kernels.embedding_bag import kernel as tkernel
from repro_torch.kernels.embedding_bag import ops as tops, ref as tref
from repro_torch.models import embedding as temb

TOL = dict(rtol=1e-5, atol=1e-6)

def _inputs(v, d, n_bags, bag, weighted, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(-1, v, (n_bags, bag)).astype(np.int32)
    w = (rng.uniform(0, 1, (n_bags, bag)).astype(np.float32)
         if weighted else None)
    return table, idx, w


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("v,d,n_bags,bag,mode,weighted", tref.GRID)
def test_embedding_bag_matches_reference(v, d, n_bags, bag, mode, weighted):
    table, idx, w = _inputs(v, d, n_bags, bag, weighted)
    want_kernel = np.asarray(jops.embedding_bag(_j(table), _j(idx), _j(w),
                                                mode=mode))
    want_ref = np.asarray(jref.embedding_bag(_j(table), _j(idx), _j(w),
                                             mode))
    got = tops.embedding_bag(_t(table), _t(idx), _t(w), mode=mode)
    assert got.dtype == torch.float32 and got.shape == (n_bags, d)
    np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    np.testing.assert_allclose(
        tref.embedding_bag(_t(table), _t(idx), _t(w), mode).numpy(),
        want_ref, **TOL)
    assert tkernel.embedding_bag_cuda.launches == 0


@pytest.mark.parametrize("mode,weighted", [("mean", False), ("sum", False),
                                           ("mean", True)])
def test_all_padding_bags(mode, weighted):
    """All-padding bags give 0 in both modes (the mean divides by
    max(weight sum, 1)), beside ordinary bags in the same batch."""
    table, idx, w = _inputs(32, 8, 6, 3, weighted, seed=1)
    idx[[0, 4]] = -1
    got = tops.embedding_bag(_t(table), _t(idx), _t(w), mode=mode).numpy()
    want = np.asarray(jops.embedding_bag(_j(table), _j(idx), _j(w),
                                         mode=mode))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[[0, 4]], 0.0, atol=1e-7)
    assert np.abs(got[[1, 2, 3, 5]]).min() > 0


def test_padding_reads_row_zero_times_zero():
    """A padded slot reads row 0 and multiplies it by 0, so a NaN in row 0
    reaches every bag with padding, as in the reference."""
    table, idx, _ = _inputs(16, 4, 3, 2, False, seed=2)
    table[0] = np.nan
    idx[:] = [[1, 2], [3, -1], [-1, -1]]
    got = tops.embedding_bag(_t(table), _t(idx), mode="sum").numpy()
    want = np.asarray(jref.embedding_bag(_j(table), _j(idx), None, "sum"))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isfinite(got[0]).all() and np.isnan(got[1:]).all()


@pytest.mark.parametrize("v,d,n_bags,bag,mode,weighted", tref.ROW0_GRID)
def test_nan_inf_row0_matches_reference(v, d, n_bags, bag, mode, weighted):
    """Row 0 holds NaN, +inf and -inf: every bag with a padded slot gets
    NaN in every column (0 * inf is NaN), as in the reference."""
    table, idx, w = _inputs(v, d, n_bags, bag, weighted, seed=6)
    tref.plant_row0(table)
    idx[0, :2] = -1
    want = np.asarray(jref.embedding_bag(_j(table), _j(idx), _j(w), mode))
    got = tops.embedding_bag(_t(table), _t(idx), _t(w), mode=mode).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0]).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_slotwise_mask_equals_folding_first(weighted):
    """The plain version (the kernel's steps: the mask applied per slot,
    no weights read when unweighted) gives the bits of folding the mask
    into the weights first, the earlier interface's input."""
    table, idx, w = _inputs(300, 18, 23, 9, weighted, seed=7)
    tref.plant_row0(table)
    for mode in tref.MODES:
        got = tref.bag_reduce(_t(table), _t(idx), _t(w), mode)
        folded = tref.bag_reduce(_t(table), _t(idx), tref.fold_weights(
            _t(idx), _t(w)), mode)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      folded.numpy().view(np.uint32))


def test_modes_other_than_sum_and_mean_raise():
    table, idx, _ = _inputs(16, 4, 3, 2, False)
    with pytest.raises(ValueError, match="mode"):
        tops.embedding_bag(_t(table), _t(idx), mode="max")
    with pytest.raises(ValueError, match="mode"):
        tref.bag_reduce(_t(table), _t(idx), torch.ones(3, 2), "max")


def test_cuda_wrapper_refuses_cpu_tensors():
    table, idx, _ = _inputs(16, 4, 3, 2, False)
    with pytest.raises(ValueError, match="CUDA device"):
        tkernel.embedding_bag_cuda(_t(table), _t(idx), torch.ones(3, 2))
    assert tkernel.embedding_bag_cuda.launches == 0


def test_build_line_targets_hopper_without_fast_math(tmp_path):
    cmd = tkernel.nvcc_command(tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-O3" in cmd and "-shared" in cmd
    assert not any("fast" in a or "ftz" in a for a in cmd)
    assert tkernel.SOURCE.exists()
    assert str(tkernel.SOURCE) == cmd[-1]


def test_lookup_fields_matches_reference():
    rng = np.random.default_rng(3)
    rows = (7, 30, 5, 64)
    tables = [rng.standard_normal((r, 6)).astype(np.float32) for r in rows]
    ids = np.stack([rng.integers(0, r, 9) for r in rows], 1).astype(np.int32)
    got = temb.lookup_fields({"tables": [_t(t) for t in tables]}, _t(ids))
    want = jemb.lookup_fields({"tables": [_j(t) for t in tables]}, _j(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", True),
                                           ("mean", False)])
def test_lookup_bag_matches_reference(use_kernel, mode, weighted):
    table, idx, w = _inputs(200, 12, 19, 5, weighted, seed=4)
    idx[3] = -1
    got = temb.lookup_bag(_t(table), _t(idx), _t(w), mode=mode,
                          use_kernel=use_kernel)
    want = jemb.lookup_bag(_j(table), _j(idx), _j(w), mode=mode,
                           use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("sum", True),
                                           ("mean", False)])
def test_segment_embedding_bag_matches_reference(mode, weighted):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    lengths = [3, 0, 1, 5, 2]                  # bag 1 is empty
    seg = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    flat = rng.integers(0, 50, seg.size).astype(np.int32)
    w = (rng.uniform(0, 2, seg.size).astype(np.float32) if weighted
         else None)
    got = temb.segment_embedding_bag(_t(table), _t(flat), _t(seg),
                                     len(lengths), _t(w), mode=mode)
    want = jemb.segment_embedding_bag(_j(table), _j(flat), _j(seg),
                                      len(lengths), _j(w), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # The ragged form agrees with the padded one.
    padded = np.full((len(lengths), max(lengths)), -1, np.int32)
    for b, (s, n) in enumerate(zip(np.cumsum([0] + lengths), lengths)):
        padded[b, :n] = flat[s:s + n]
    if not weighted:
        np.testing.assert_allclose(
            got.numpy(), temb.lookup_bag(_t(table), _t(padded),
                                         mode=mode).numpy(), **TOL)
