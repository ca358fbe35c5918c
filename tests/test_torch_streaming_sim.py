"""The port's RQ2 simulator (``repro_torch.examples.billion_item_sim``) and
quickstart against the reference's ``examples/``, bit for bit (atol=0).

Mirrors ``tests/test_streaming_sim.py``: the stream against the
reference's ``streaming_pqtopk`` (ragged last chunk, k > chunk, ids past
2^31, uint8 codes on the device) and ``run_hier_compare`` with the
reference's bound counts.  The reference's examples are loaded by file
path, as its own tests load them."""
import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.examples import billion_item_sim as tsim
from repro_torch.examples import quickstart as tquick
from repro_torch.kernels.pqtopk import ops as tops

spec = importlib.util.spec_from_file_location(
    "billion_item_sim", "examples/billion_item_sim.py")
jsim = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jsim)


def _case(n, m=4, b=16, bq=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, b, (n, m), dtype=np.uint8),
            rng.standard_normal((bq, m, b)).astype(np.float32))


def _both(codes, s, k, chunk, id_base=0):
    """(port values, ids), (reference values, ids) of the stream."""
    tv, ti, n_chunks = tsim.streaming_pqtopk(codes, torch.from_numpy(s), k,
                                             chunk, id_base=id_base)
    assert n_chunks == -(-codes.shape[0] // min(chunk, codes.shape[0]))
    jv, ji, _ = jsim.streaming_pqtopk(codes, jnp.asarray(s), k, chunk,
                                      id_base=id_base)
    return (tv, ti), (jv, ji)


@pytest.mark.parametrize("n,chunk", [
    (256, 64),     # even split
    (300, 64),     # ragged last chunk (300 = 4*64 + 44)
    (100, 256),    # one chunk larger than n
    (65, 64),      # a last chunk of one row
])
def test_stream_matches_reference(n, chunk):
    codes, s = _case(n)
    (tv, ti), (jv, ji) = _both(codes, s, 10, chunk)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    assert ti.dtype == np.int64
    ov, oi = tops.pq_topk(torch.from_numpy(codes), torch.from_numpy(s), 10)
    np.testing.assert_array_equal(tv, ov.numpy())
    np.testing.assert_array_equal(ti, oi.numpy())


def test_k_larger_than_chunk_carries_survivors_across_chunks():
    codes, s = _case(200)
    (tv, ti), (jv, ji) = _both(codes, s, 48, 32)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)


def test_int64_id_offset_past_2_31():
    codes, s = _case(128)
    base = 3 * (2 ** 31)
    (tv, ti), (jv, ji) = _both(codes, s, 10, 32, id_base=base)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    assert ti.dtype == np.int64 and int(ti.min()) >= base


def test_chunks_reach_the_device_as_uint8(monkeypatch):
    """Every chunk reaches the kernel wrapper as uint8 (the kernel reads
    uint8 natively), at its own length: no padding rows."""
    codes, s = _case(96)
    seen = []
    orig = tops.pq_topk

    def spy(c, s_, k, **kw):
        seen.append((c.dtype, c.shape[0]))
        return orig(c, s_, k, **kw)

    monkeypatch.setattr(tsim.ops, "pq_topk", spy)
    tsim.streaming_pqtopk(codes, torch.from_numpy(s), 5, 40)
    assert seen == [(torch.uint8, 40), (torch.uint8, 40), (torch.uint8, 16)]


def test_merge_matches_reference_through_ties():
    rng = np.random.default_rng(3)
    best_v = np.sort(rng.integers(0, 4, (2, 6)).astype(np.float32))[:, ::-1]
    best_i = rng.integers(0, 1000, (2, 6)).astype(np.int64)
    v = rng.integers(0, 4, (2, 6)).astype(np.float32)
    i = rng.integers(0, 50, (2, 6)).astype(np.int32)
    for got, want in zip(
            tsim.merge_topk_host(best_v, best_i, v, i, 2 ** 33, 6),
            jsim.merge_topk_host(best_v, best_i, v, i, 2 ** 33, 6)):
        np.testing.assert_array_equal(got, want)


def test_clustered_codes_match_reference():
    for n, m, b, grain in ((5000, 4, 64, 512), (4097, 8, 256, 1000)):
        np.testing.assert_array_equal(
            tsim.make_clustered_codes(n, m, b, grain, seed=2),
            jsim.make_clustered_codes(n, m, b, grain, seed=2))


@pytest.mark.parametrize("backend", ["bitmask", "range"])
def test_hier_compare_matches_reference(backend):
    """``run_hier_compare`` at 2^15 items on the reference's S: zero
    mismatches, and the reference's tile, super and bound counts."""
    kw = dict(m=4, b=64, tile=128, factor=8, bq=2, repeats=1,
              backend=backend)
    want = jsim.run_hier_compare(1 << 15, **kw)
    s = np.asarray(jsim.make_popularity_scores(2, 4, 64, seed=0))
    got = tsim.run_hier_compare(1 << 15, device="cpu", s=s, **kw)
    assert set(want) <= set(got) and got["device"] == "cpu"
    for key in ("n_items", "m", "b", "tile", "super_factor", "backend", "k",
                "bq", "n_tiles", "n_super", "flat_bounds", "hier_bounds",
                "bound_reduction", "n_super_survived", "mismatches"):
        assert got[key] == want[key], key
    assert got["mismatches"] == 0 and got["hier_bounds"] < got["flat_bounds"]
    own = tsim.run_hier_compare(1 << 15, device="cpu", **kw)
    assert own["mismatches"] == 0


def test_reference_s_file_is_the_reference_draw():
    """``src/repro_torch/examples/rq2_reference_s.npy`` (read by
    ``chip_smoke.py``, whose machine has no JAX) is the reference's
    ``--mode hier`` S: B=2, m=8, b=256, seed 0."""
    got = np.load(tsim.REFERENCE_S)
    np.testing.assert_array_equal(
        got, np.asarray(jsim.make_popularity_scores(2, 8, 256, seed=0)))
    assert got.dtype == np.float32


def test_popularity_scores_are_seeded():
    a = tsim.make_popularity_scores(2, 4, 64, seed=1)
    assert torch.equal(a, tsim.make_popularity_scores(2, 4, 64, seed=1))
    assert a.shape == (2, 4, 64) and a.dtype == torch.float32
    assert not torch.equal(a, tsim.make_popularity_scores(2, 4, 64, seed=2))


def test_mains_run_on_the_cpu_and_refuse_without_a_card(capsys):
    tsim.main(["--device", "cpu", "--items", "5000", "--chunk", "2000",
               "--repeats", "1"])
    tsim.main(["--device", "cpu", "--mode", "hier", "--items", "8192",
               "--tile", "128", "--factor", "8", "--repeats", "1"])
    tquick.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "3 chunks" in out and out.count("mismatches=0") == 2
    assert "fused pqtopk kernel matches: OK" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tsim.main(["--items", "100"])
