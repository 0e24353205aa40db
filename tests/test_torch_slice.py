"""The port's main path as a whole: parallel.batch.batched_solve at the
bench operating point, against the JAX package in float64 and against
the committed float64 reference solution in float32."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.parallel.batch import batched_solve as jbatched
from centroidal_mpc_tpu.parallel.batch import tile_ocp_config as jtile
from centroidal_mpc_tpu.solver import scp as jscp
from centroidal_mpc_tpu_torch import convert
from centroidal_mpc_tpu_torch.config import gaits
from centroidal_mpc_tpu_torch.config import presets as tpresets
from centroidal_mpc_tpu_torch.config.robots import SOLO12
from centroidal_mpc_tpu_torch.contact.plan import build_contact_plan
from centroidal_mpc_tpu_torch.models.centroidal import CentroidalModel
from centroidal_mpc_tpu_torch.ops import block_tridiag as bt
from centroidal_mpc_tpu_torch.ops import blockqp as tbq
from centroidal_mpc_tpu_torch.ops import lqr_kernel
from centroidal_mpc_tpu_torch.parallel.batch import batched_solve
from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config
from centroidal_mpc_tpu_torch.solver import ocp as tocp
from centroidal_mpc_tpu_torch.solver import scp as tscp

from torch_parity_util import (BENCH_QP, perturbed_batch, port_problem,
                               qp_settings_pair)

REF_CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "ref_cache",
    "solo12_trot_n50_1dbb8aa1aab5.npz")


def test_batched_solve_matches_jax_f64():
    """(h) solo12_trot_mini, B=4, float64, bench operating point: equal
    success, QP and SCP iteration counts, X/U within 1e-8, and K at the
    Newton-Schulz tolerance of test_torch_model (1e-9 relative)."""
    jqp, _ = qp_settings_pair(**BENCH_QP)
    jprob = jpresets.build_problem(jpresets.SOLO12_TROT_MINI,
                                   dtype=jnp.float64, qp=jqp)
    jscp = dataclasses.replace(jprob.scp, qp_backend="block",
                               norm_method="power")
    Xb, Ub = perturbed_batch(jprob.X0, jprob.U0, 4, seed=0)
    jsol = jax.jit(lambda c, x, u: jbatched(
        jprob.model, jprob.plan.schedule, c, x, u, jscp))(
            jtile(jprob.ocp, Xb[:, 0], Xb[:, -1], Xb), Xb, Ub)

    model, schedule, ocp, scp, _, _ = port_problem(jprob)
    scp = dataclasses.replace(scp, qp_backend="block", norm_method="power")
    X, U = torch.as_tensor(Xb), torch.as_tensor(Ub)
    sol = batched_solve(model, schedule,
                        tile_ocp_config(ocp, X[:, 0], X[:, -1], X), X, U,
                        scp)

    assert sol.success.all()
    for k in ("success", "iterations", "qp_iterations", "accepted",
              "qp_status", "qp_converged"):
        np.testing.assert_array_equal(getattr(sol, k).numpy(),
                                      np.asarray(getattr(jsol, k)),
                                      err_msg=k)
    for k in ("X", "U"):
        np.testing.assert_allclose(getattr(sol, k).numpy(),
                                   np.asarray(getattr(jsol, k)), rtol=1e-8,
                                   atol=1e-8, err_msg=k)
    K_ref = np.asarray(jsol.K)
    assert np.abs(sol.K.numpy() - K_ref).max() < 1e-9 * np.abs(K_ref).max()
    np.testing.assert_allclose(sol.radius.numpy(), np.asarray(jsol.radius))
    np.testing.assert_allclose(sol.weight.numpy(), np.asarray(jsol.weight))


def test_f32_cpu_meets_reference_parity_bar():
    """(i) The port in float32 on the CPU (plain versions of the kernels),
    solo12_trot_n50, B=2: both lanes succeed and scenario 0 is within the
    1e-4 parity bar (BASELINE.md) of the float64 reference solution."""
    _, qp = qp_settings_pair(**BENCH_QP)
    prob = tpresets.build_problem(tpresets.SOLO12_TROT_N50,
                                  dtype=torch.float32, qp=qp, device="cpu")
    scp = dataclasses.replace(prob.scp, qp_backend="block",
                              norm_method="power")
    Xb, Ub = perturbed_batch(prob.X0.numpy(), prob.U0.numpy(), 2, seed=0)
    X = torch.as_tensor(Xb, dtype=torch.float32)
    U = torch.as_tensor(Ub, dtype=torch.float32)
    before = {**bt.launches, **lqr_kernel.launches}
    sol = batched_solve(prob.model, prob.plan.schedule,
                        tile_ocp_config(prob.ocp, X[:, 0], X[:, -1], X),
                        X, U, scp)
    assert {**bt.launches, **lqr_kernel.launches} == before
    assert sol.X.dtype == torch.float32 and sol.success.all()
    assert torch.isfinite(sol.K).all()
    ref = np.load(REF_CACHE)
    x_err = np.abs(sol.X[0].double().numpy() - ref["X"]).max()
    u_err = np.abs(sol.U[0].double().numpy() - ref["U"]).max()
    assert x_err <= 1e-4 and u_err <= 1e-4, (x_err, u_err)


@pytest.mark.parametrize("method", ["power", "svd"])
def test_matrix_norm2_matches_jax(method):
    """The trust-region norm of solve_scp, batch-first, against the JAX
    package's per-matrix _matrix_norm2 (same start vector and 10 power
    steps, or the exact SVD): f64 round-off, rtol 1e-12."""
    M = np.random.default_rng(6).standard_normal((3, 51, 9))
    ref = np.array([float(jscp._matrix_norm2(m, method)) for m in M])
    got = tscp._matrix_norm2(torch.as_tensor(M), method)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


def test_unported_scp_paths_raise():
    """qp_backend='dense' (the preset default), re-linearization and
    stochastic problems are later slices: they raise, not run."""
    prob = tpresets.build_problem(tpresets.SOLO12_TROT_MINI,
                                  dtype=torch.float64, device="cpu")
    X, U = prob.X0[None], prob.U0[None]
    cfg = tile_ocp_config(prob.ocp, X[:, 0], X[:, -1], X)
    for scp in (prob.scp,
                dataclasses.replace(prob.scp, qp_backend="block",
                                    update_linearization=True)):
        with pytest.raises(NotImplementedError):
            batched_solve(prob.model, prob.plan.schedule, cfg, X, U, scp)
    with pytest.raises(NotImplementedError):
        tpresets.build_problem(tpresets.SOLO12_TROT_MINI, stochastic=True,
                               device="cpu")


def test_build_problem_defaults_to_the_card():
    """build_problem with no device targets the card: it builds there when
    there is one, and raises, never building on the CPU, when there is
    none."""
    if torch.cuda.is_available():
        prob = tpresets.build_problem(tpresets.SOLO12_TROT_MINI)
        assert prob.X0.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpresets.build_problem(tpresets.SOLO12_TROT_MINI)


@pytest.mark.parametrize("build", [
    pytest.param(lambda: convert.to_tensor(np.zeros(3)), id="to_tensor"),
    pytest.param(lambda: convert.from_numpy(tocp.OcpConfig, {}),
                 id="from_numpy"),
    pytest.param(lambda: build_contact_plan(SOLO12, gaits.SOLO12_TROT_MINI,
                                            0.01), id="build_contact_plan"),
    pytest.param(lambda: CentroidalModel.from_spec(
        SOLO12, 0.01, np.eye(9), np.eye(12), np.eye(12), np.eye(9)),
        id="CentroidalModel.from_spec"),
    pytest.param(lambda: tocp.friction_pyramid_matrix(0.5),
                 id="friction_pyramid_matrix"),
    pytest.param(lambda: tocp.sign_enumeration_matrix(3),
                 id="sign_enumeration_matrix"),
    pytest.param(lambda: tbq.zero_zgroups(1, 2, 4, torch.float32),
                 id="zero_zgroups"),
])
def test_builders_take_no_default_device(build):
    """The port's lower-level builders have no default device: a caller
    names one, so nothing lands on the CPU unasked."""
    with pytest.raises(TypeError, match="device"):
        build()
