"""The 'cond' adaptive-rho ADMM of the PyTorch port against the JAX
package (float64, at matched iteration counts): each lane carries its rho
and factorization across residual segments and is refactored only when
its primal/dual ratio leaves the deadband."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.ops import blockqp as jbq
from centroidal_mpc_tpu_torch.ops import blockqp as tbq
from centroidal_mpc_tpu_torch.ops.admm import (STATUS_PRIMAL_INFEASIBLE,
                                               STATUS_SOLVED)

from torch_parity_util import (infeasible_stochastic_qp_pair, qp_pair,
                               qp_settings_pair)


def _trot_n50_qp_pair():
    jprob = jpresets.build_problem(jpresets.SOLO12_TROT_N50,
                                   dtype=jnp.float64)
    return qp_pair(jprob, 2)[:2]


JSET, TSET = qp_settings_pair(
    eps_abs=1e-5, eps_rel=1e-5, max_iter=4000, adaptive_rho=True,
    adaptive_rho_mode="cond", factor_method="pallas", polish=False,
    check_interval=10, stall_segments=30)
# one jitted program for both cases (same shapes): one compile
_jax_solve = jax.jit(jax.vmap(lambda q: jbq.solve_block_qp(q, JSET)))


@pytest.mark.parametrize("qps,status", [
    # the N=50 trot QP of tests/test_blockqp.py: converges
    (_trot_n50_qp_pair, STATUS_SOLVED),
    # back-offs that empty a friction cone: the re-adaptation restarts
    # the certificate ray, so the certifying iteration is compared too
    (infeasible_stochastic_qp_pair, STATUS_PRIMAL_INFEASIBLE)],
    ids=["trot_n50", "infeasible_stochastic_n50"])
def test_cond_rho_solve_matches_jax(qps, status):
    """'cond' adaptive rho, B=2, f64, against the JAX package's vmapped
    solve_block_qp: equal iterations (so the same certifying iteration
    where a lane certifies) and statuses, X/U within 1e-9.  The port
    carries each lane's rho and factor and refactors only the lanes that
    trigger.  The JAX package returns no rho; a rho that differed from
    its at any refactor would change the factor of every later segment
    and move the iterates far beyond 1e-9, so the equal iteration counts
    and X/U stand in for equal rho.  The port's final rho is checked to
    have moved from its start, with at least one refactor a lane."""
    jqp, tqp = qps()
    jsol = _jax_solve(jqp)
    tsol = tbq.solve_block_qp(tqp, TSET)
    assert (tsol.status == status).all()
    for k in ("iterations", "status"):
        np.testing.assert_array_equal(getattr(tsol, k).numpy(),
                                      np.asarray(getattr(jsol, k)),
                                      err_msg=k)
    for k in ("X", "U", "t"):
        np.testing.assert_allclose(getattr(tsol, k).numpy(),
                                   np.asarray(getattr(jsol, k)), rtol=1e-9,
                                   atol=1e-9, err_msg=k)
    assert (tsol.refactors >= 1).all()
    assert (tsol.rho != TSET.rho).all()
