"""The mesh variants that change the computation, through their step
bundles, against the JAX reference's bundles on an 8-device CPU mesh.

Each case builds the port's bundle on a ``ShardMesh`` of 8 CPU positions
and the reference's on a ``jax.sharding.Mesh`` of the same shape (Auto
axes), both at the reduced config cut as ``test_torch_steps.py`` cuts it
(the LM to one layer), and runs one step under the bundle's plan: the item-sharded serve
variants (``sharded_*``, ``*_bm``) on (data=2, model=4), PowerSGD on
(pod=2, data=2, model=2) and the ``*gradrs`` train steps.  The module
fixture runs this file as a script in a child process whose environment
alone carries ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(``test_torch_mesh_training.run_oracle``).  The child builds the port's
bundle too and feeds its values (drawn by ``steps.materialize`` from a
seed) to the reference's jitted step, so both packages start from the
same arguments.

The reduced qwen2.5's leaves are all below PowerSGD's 65,536-element
floor, so its exchange is the pods' plain mean and Q is not drawn.
Tolerances are ``test_torch_steps.py``'s: floats rtol=atol=1e-5, top-k
ids equal where the values are not tied within it (the backbone is held
to a tolerance, the item scoring is exact)."""
import dataclasses
import sys

import numpy as np
import pytest

from test_torch_mesh_training import run_oracle
from test_torch_steps import TOL, assert_topk_close, cut

#: case -> (arch, shape, variant, mesh axes, mesh shape)
CASES = {
    **{v: ("sasrec-recjpq", "serve_users", v, ("data", "model"), (2, 4))
       for v in ("sharded_head", "sharded_head_bm", "sharded_onehot",
                 "sharded_fused", "sharded_perquery", "sharded_pruned",
                 "sharded_pruned_range", "sharded_hier")},
    "powersgd": ("qwen2.5-14b", "train_4k", "powersgd",
                 ("pod", "data", "model"), (2, 2, 2)),
    "gradrs": ("qwen2.5-14b", "train_4k", "gradrs", ("data", "model"),
               (2, 4)),
}
SEED = 3


def reduced(arch):
    """``cut``'s config, an LM with one layer (its step compiles in half
    the time; the variants change nothing inside a layer)."""
    arch = cut(arch)
    if arch.family != "lm":
        return arch
    return dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, n_layers=1))


def port_bundle(case):
    from repro_torch.configs.base import get_reduced
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import ShardMesh
    arch_id, shape_name, variant, axes, shape = CASES[case]
    mesh = ShardMesh(["cpu"] * int(np.prod(shape)), axes, shape)
    return steps.build_step(arch_id, shape_name, mesh, variant,
                            arch_override=reduced(get_reduced(arch_id)),
                            seed=SEED)


def _float_leaves(tree, is_port):
    """A train step's float leaves in the reference's order."""
    if is_port:
        from repro_torch.training import tree as tree_lib
        return [t.detach().float().numpy() for t in tree_lib.leaves(tree)
                if t.is_floating_point()]
    import jax
    import jax.numpy as jnp
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)
            if jnp.issubdtype(x.dtype, jnp.floating)]


# ---------------------------------------------------------------------------
# the reference, in the child process
# ---------------------------------------------------------------------------


def _oracle_main(path):
    import jax
    from jax.sharding import Mesh
    from repro.configs.base import get_reduced as jget_reduced
    from repro.distributed import sharding as jshd
    from repro.launch import steps as jsteps
    from test_torch_steps import reference_args
    assert len(jax.devices()) >= 8, jax.devices()
    devs = np.array(jax.devices()[:8])
    out = {}
    for case, (arch_id, shape_name, variant, axes, shape) in CASES.items():
        mesh = Mesh(devs.reshape(shape), axes)
        ref = jsteps.build_step(arch_id, shape_name, mesh, variant,
                                arch_override=reduced(jget_reduced(arch_id)))
        args = jax.device_put(reference_args(port_bundle(case).args,
                                             ref.args), ref.in_shardings)
        with jshd.activation_plan(ref.plan):
            got = jax.jit(ref.step_fn, in_shardings=ref.in_shardings)(*args)
        if ref.meta["kind"] == "train":
            params, opt, mets = got
            out[f"{case}/loss"] = np.asarray(mets["loss"])
            for i, x in enumerate(_float_leaves([params, opt], False)):
                out[f"{case}/leaf{i}"] = x
        else:
            out[f"{case}/ids"], out[f"{case}/vals"] = map(np.asarray, got)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(tmp_path_factory, __file__)


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_variant_step_matches_reference(oracle, case):
    """One step of the port's mesh bundle against the reference's: the
    top-k within the tolerances, or the loss and every float leaf of the
    updated parameters and optimizer state (PowerSGD's error feedback
    included) within them.  The sharded serves launch their kernels once
    per ``model`` position."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import cost
    bundle = port_bundle(case)
    with shd.activation_plan(bundle.plan), cost.recording() as rec:
        got = bundle.step_fn(*bundle.args)
    if bundle.meta["kind"] == "train":
        params, opt, mets = got
        np.testing.assert_allclose(float(mets["loss"]),
                                   oracle[f"{case}/loss"], **TOL)
        leaves = _float_leaves([params, opt], True)
        assert len(leaves) == sum(k.startswith(f"{case}/leaf")
                                  for k in oracle)
        for i, x in enumerate(leaves):
            np.testing.assert_allclose(x, oracle[f"{case}/leaf{i}"], **TOL)
        assert ("ef" in opt) == (case == "powersgd")
    else:
        ids, vals = got
        assert_topk_close(ids, vals, oracle[f"{case}/ids"],
                          oracle[f"{case}/vals"])
        kernels = {k: v for k, v in rec.launches.items() if v}
        assert all(v == 4 for v in kernels.values()), kernels
        assert bool(kernels) == (case in ("sharded_fused", "sharded_hier",
                                          "sharded_perquery",
                                          "sharded_pruned",
                                          "sharded_pruned_range"))


if __name__ == "__main__":
    _oracle_main(sys.argv[1])
