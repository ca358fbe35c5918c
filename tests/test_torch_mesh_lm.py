"""PowerSGD over a multi-axis mesh for a reduced LM, and the exchange
alone, against the JAX reference on the CPU.  The helpers, the child
process and the tolerances are ``test_torch_mesh_training.py``'s: this
file's child runs the LM case (8 CPU devices, (pod=2, data=2, model=2),
grad_accum=2, under the LM activation plan with ``pod`` stripped), the
reference's ``compressed_psum_sharded`` on two pods and its
``compression_ratio`` of both reduced models."""
import sys

import numpy as np
import pytest
import torch

from test_torch_mesh_training import (
    EPS_IN, MIN_SIZE, RANK, TOL, _oracle_main, amplification,
    assert_pods_differ, model, q_of, run_case, run_oracle,
)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(tmp_path_factory, __file__)


def test_powersgd_lm_steps_match_reference(oracle, monkeypatch):
    """Two PowerSGD steps of a reduced qwen2.5 (stacked layers: each
    (2, d, f) leaf compressed as one matrix) with grad_accum=2, under the
    stripped LM plan; each pod keeps its own residual."""
    _, state, _ = run_case(oracle, "lm8", monkeypatch)
    assert_pods_differ(oracle, "lm8", state, "embed/table")
    assert_pods_differ(oracle, "lm8", state, "layers/mlp/up/w")


def test_compressed_psum_sharded_matches_reference(oracle):
    """Two replicated pods, Q injected: the exchanged gradient and the
    residual of the compressed leaf within the first-order bound, the mean
    of the small one (its residual untouched)."""
    from repro_torch.launch.mesh import ShardMesh
    from repro_torch.training import compression
    g = {k[len("psum/in/"):]: torch.from_numpy(v) for k, v in oracle.items()
         if k.startswith("psum/in/")}
    out_g, out_e = compression.compressed_psum_sharded(
        g, compression.init_error_feedback(g), ShardMesh(["cpu"] * 2, "pod"),
        "pod", rank=RANK, min_size=1024, q=q_of(oracle, "psum"))
    want = oracle["psum/g/w"]
    bound = 10 * EPS_IN * amplification([g["w"]] * 2, [torch.zeros_like(
        g["w"])] * 2, torch.from_numpy(want), q_of(oracle, "psum")["w"])
    for got, ref in ((out_g["w"], want), (out_e["w"], oracle["psum/e/w"])):
        assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(want) \
            <= bound
    np.testing.assert_allclose(out_g["b"].numpy(), oracle["psum/g/b"], **TOL)
    np.testing.assert_array_equal(out_e["b"].numpy(), oracle["psum/e/b"])


@pytest.mark.parametrize("kind", ["seq", "lm"])
def test_compression_ratio_matches_reference(oracle, kind):
    from repro_torch.training import compression
    _, params, _ = model(kind)
    assert compression.compression_ratio(
        params, rank=RANK, min_size=MIN_SIZE) == pytest.approx(
            float(oracle[f"ratio/{kind}"]), rel=1e-12)


if __name__ == "__main__":
    _oracle_main(sys.argv[1], ("lm8",), extras=True)
