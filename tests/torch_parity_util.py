"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Problems are built by the JAX package, turned into numpy leaves and
settings dicts, and handed to the port through
`centroidal_mpc_tpu_torch.convert`, so both packages solve the very same
problem.  Random inputs come from numpy generators with fixed seeds.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.models.centroidal import compute_trajectory_data
from centroidal_mpc_tpu.ops.admm import QPSettings as JaxQPSettings
from centroidal_mpc_tpu.ops import blockqp as jbq

from centroidal_mpc_tpu_torch import convert
from centroidal_mpc_tpu_torch.contact.plan import ContactSchedule
from centroidal_mpc_tpu_torch.models.centroidal import (CentroidalModel,
                                                        TrajectoryData)
from centroidal_mpc_tpu_torch.ops import blockqp as tbq
from centroidal_mpc_tpu_torch.ops.admm import QPSettings
from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config
from centroidal_mpc_tpu_torch.solver.ocp import OcpConfig
from centroidal_mpc_tpu_torch.solver.scp import ScpSettings

# the JAX package's float64 motion pipeline on solo12_trot_n50 and its
# 1-step trot whole-body DDP (scripts/jax_pipeline_reference.py)
PIPELINE_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "jax_pipeline_solo12_trot_n50.npz")

# One intra-op thread for the port's CPU computations: their tensors are
# tiny (B <= 4 scenarios of 22 x 22 blocks), so threads buy nothing alone,
# and under pytest-xdist each worker's pool of one thread a core
# oversubscribes the CPUs -- the f32 parity solve of test_torch_slice.py
# took 199 s in a six-worker run against 1 s alone.
torch.set_num_threads(1)

# the bench headline operating point (bench.py defaults), as a dict so
# both packages' QPSettings can be built from it
BENCH_QP = dict(eps_abs=5e-4, eps_rel=5e-4, polish=True, polish_iters=12,
                polish_rounds=2, polish_cg_iters=8, polish_cg_restarts=1,
                check_interval=10, alpha=1.7, adaptive_rho=False,
                max_iter=4000, stall_segments=30, factor_method="pallas")


def np_fields(obj) -> dict:
    """Fields of a JAX-package dataclass/pytree node as numpy arrays
    (array leaves) or plain values (static fields)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = np.asarray(v) if isinstance(
            v, (np.ndarray, np.generic, jax.Array)) else v
    return out


def to_np(x):
    """Tensor, JAX array or container thereof -> numpy (same structure)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (jax.Array, np.ndarray, np.generic)):
        return np.asarray(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: to_np(v) for k, v in zip(x._fields, x)}
    if dataclasses.is_dataclass(x):
        return {f.name: to_np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return [to_np(v) for v in x]
    return x


def assert_tree_close(a, b, rtol, atol, path=""):
    """Leaf-by-leaf comparison of two numpy structures from `to_np`."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_tree_close(a[k], b[k], rtol, atol, f"{path}.{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_close(x, y, rtol, atol, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(np.broadcast_to(a, np.shape(b)), b,
                                   rtol=rtol, atol=atol, err_msg=path)


def port_problem(jprob, dtype=torch.float64):
    """The port's (model, schedule, ocp, scp settings, X0, U0) converted
    from a JAX-package Problem, on the CPU."""
    def conv(cls, obj):
        return convert.from_numpy(cls, np_fields(obj), "cpu", dtype)

    scp = convert.settings_from_dict(ScpSettings,
                                     dataclasses.asdict(jprob.scp))
    return (conv(CentroidalModel, jprob.model),
            conv(ContactSchedule, jprob.plan.schedule),
            conv(OcpConfig, jprob.ocp), scp,
            convert.to_tensor(jprob.X0, "cpu", dtype),
            convert.to_tensor(jprob.U0, "cpu", dtype))


def perturbed_batch(X0: np.ndarray, U0: np.ndarray, batch: int, seed=0,
                    scale=0.005):
    """Scenario 0 unperturbed; the others shift CoM x, y over the whole
    trajectory by scale * N(0, 1) (the bench's scenario batch)."""
    rng = np.random.default_rng(seed)
    dx = np.zeros((batch, X0.shape[-1]))
    dx[1:, :2] = scale * rng.standard_normal((batch - 1, 2))
    Xb = np.asarray(X0)[None] + dx[:, None, :]
    Ub = np.ascontiguousarray(np.broadcast_to(np.asarray(U0),
                                              (batch,) + np.shape(U0)))
    return Xb, Ub


def qp_settings_pair(**fields):
    """(JAX QPSettings, port QPSettings) from one dict of fields."""
    return JaxQPSettings(**fields), convert.settings_from_dict(QPSettings,
                                                               fields)


def reduced_trot():
    """The reduced gait of tests/test_pallas_blockqp.py (N=18, trot with
    step length 0.12)."""
    preset = dataclasses.replace(
        jpresets.SOLO12_TROT_N50,
        gait=dataclasses.replace(jpresets.SOLO12_TROT_N50.gait,
                                 step_knots=6, support_knots=2, nb_steps=1))
    return jpresets.build_problem(preset, dtype=jnp.float64)


def talos_short():
    """talos_pace with its gait cut to one short pace cycle (N=30):
    wrench6 contacts and the preset's re-linearization stay on."""
    return dataclasses.replace(
        jpresets.TALOS_PACE, gait=dataclasses.replace(
            jpresets.TALOS_PACE.gait, step_knots=6, support_knots=2,
            nb_steps=1))


# the JAX package's linearization and block-QP build of a scenario batch,
# jitted once (eager vmapped dispatch of the f64 DARE chain costs ~6 s a
# call on the CPU; a jitted call of an already compiled shape ~0.01 s)
jax_trajectory_data = jax.jit(
    jax.vmap(compute_trajectory_data, in_axes=(None, None, 0, 0, None, None)),
    static_argnums=(4, 5))
_jax_block_qp = jax.jit(jax.vmap(
    lambda m, sched, c, x, u, d: jbq.build_block_qp(
        m, sched, c, x, u, d, jnp.asarray(100.0), jnp.asarray(50.0)),
    in_axes=(None, None, 0, 0, 0, 0)))


def qp_pair(jprob, batch, lqr_iters=2, model=None):
    """Matching JAX (vmapped leaves) and port BlockQPs for a perturbed
    scenario batch, linearized at the warm start; a stochastic problem
    gets its covariance and chance back-offs.  Both packages build from
    the same linearization (the JAX one, converted).  model: a JAX-package
    CentroidalModel to use instead of the problem's own."""
    jmodel = jprob.model if model is None else model
    Xb, Ub = perturbed_batch(jprob.X0, jprob.U0, batch, seed=3, scale=1e-3)
    cfg = jax.vmap(lambda x: jprob.ocp.replace(
        x_init=x[0], x_final=x[-1], X_track=x))(Xb)
    jdata = jax_trajectory_data(jmodel, jprob.plan.schedule, Xb, Ub,
                                lqr_iters, jprob.ocp.stochastic)
    jqp = _jax_block_qp(jmodel, jprob.plan.schedule, cfg, Xb, Ub, jdata)
    _, schedule, ocp, *_ = port_problem(jprob)
    tmodel = convert.from_numpy(CentroidalModel, np_fields(jmodel), "cpu")
    X, U = torch.as_tensor(Xb), torch.as_tensor(Ub)
    tcfg = tile_ocp_config(ocp, X[:, 0], X[:, -1], X)
    tdata = convert.from_numpy(TrajectoryData, np_fields(jdata), "cpu")
    tqp = tbq.build_block_qp(tmodel, schedule, tcfg, X, U, tdata, 100.0,
                             50.0)
    return jqp, tqp, Xb, Ub


def infeasible_stochastic_qp_pair(batch=2):
    """The stochastic block QP of solo12_trot_n50 with cov_w scaled by
    3e3 in both packages: the back-offs lower the friction upper bounds
    to about -6.4 N, more than a planted foot's share of the weight can
    buy, so the QP is primal infeasible.  It has the shapes of the
    nominal N=50 trot QP, so a jitted JAX solve compiles once for both."""
    jprob = jpresets.build_problem(jpresets.SOLO12_TROT_N50,
                                   stochastic=True, dtype=jnp.float64)
    jmodel = jprob.model.replace(cov_w=jprob.model.cov_w * 3e3)
    jqp, tqp, _, _ = qp_pair(jprob, batch, model=jmodel)
    return jqp, tqp
