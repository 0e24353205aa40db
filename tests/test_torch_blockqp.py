"""Block QP path of the PyTorch port against the JAX package, float64:
the block-tridiagonal factor/solve against the Pallas kernels (interpret
mode), the QP data path, and solve_block_qp at matched iteration counts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroidal_mpc_tpu.config import presets as jpresets
from centroidal_mpc_tpu.ops import blockqp as jbq
from centroidal_mpc_tpu.ops import pallas_blockqp as pbq
from centroidal_mpc_tpu_torch.ops import block_tridiag as bt
from centroidal_mpc_tpu_torch.ops import blockqp as tbq

from torch_parity_util import (assert_tree_close, qp_pair, qp_settings_pair,
                               reduced_trot, to_np)


def _spd_system(b, n, v, seed):
    """Random SPD block-tridiagonal system, diagonally dominant over the
    couplings (the construction of tests/test_pallas_blockqp.py)."""
    rng = np.random.default_rng(seed)
    off = 0.3 * rng.standard_normal((b, n, v, v))
    r = rng.standard_normal((b, n + 1, v, v))
    diag = r @ np.swapaxes(r, -1, -2) / v + 2.0 * np.eye(v)
    diag = diag + 2.0 * np.eye(v) * np.abs(off).sum(axis=(2, 3)).max()
    rhs = rng.standard_normal((b, n + 1, v))
    return diag, off, rhs


@pytest.mark.parametrize("b,n,v", [(4, 7, 22), (3, 5, 13)])
def test_tridiag_plain_matches_pallas(b, n, v):
    """(e) Plain factor + sweeps against pallas factor_batched /
    solve_batched (interpret mode) at rtol 1e-9 (two f64 Cholesky
    variants), and M w = b at 1e-9."""
    diag, off, rhs = _spd_system(b, n, v, seed=b)
    ref = np.asarray(pbq.solve_batched(
        pbq.factor_batched(diag, off, interpret=True), rhs, interpret=True))
    d, o, r = (torch.as_tensor(a) for a in (diag, off, rhs))
    fac = bt.factor_batched(d, o)
    w = bt.solve_batched(fac, r)
    np.testing.assert_allclose(w.numpy(), ref, rtol=1e-9, atol=1e-9)
    # the factor itself: Cinv equals the kernel's C^{-1} blocks
    kfac = pbq.factor_batched(diag, off, interpret=True)
    cinv_ref = np.transpose(np.asarray(kfac.Cinv), (3, 0, 1, 2))[:b, :, :v, :v]
    np.testing.assert_allclose(fac.Cinv.numpy(), cinv_ref, rtol=1e-9,
                               atol=1e-9)
    mw = (d @ w[..., None])[..., 0]
    mw[:, 1:] += (o @ w[:, :-1, :, None])[..., 0]
    mw[:, :-1] += (o.mT @ w[:, 1:, :, None])[..., 0]
    np.testing.assert_allclose(mw.numpy(), rhs, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("v", [22, 16])
def test_factor_halves_match_pallas(v):
    """Each half of the factor against pallas factor_batched (interpret
    mode) at B=3, N=8, f64, rtol = atol = 1e-9: two f64 Cholesky variants
    that take their sums in another order.  The chain's Cinv is the
    kernel's C^{-1} and its W is O_{k-1} C_{k-1}^{-T}; the couplings from
    (Cinv, W) are the kernel's Pfwd / Pbwd, whose slot k (slot 0 zero)
    holds the knot that the port's slot k-1 holds."""
    b, n = 3, 8
    diag, off, _ = _spd_system(b, n, v, seed=v)
    kfac = pbq.factor_batched(diag, off, interpret=True)

    def batch_major(a):   # (N+1, V8, V8, Bp) -> (B, N+1, V, V)
        return np.transpose(np.asarray(a), (3, 0, 1, 2))[:b, :, :v, :v]

    tol = dict(rtol=1e-9, atol=1e-9)
    cinv, w = bt.factor_chain_plain(torch.as_tensor(diag),
                                    torch.as_tensor(off))
    cinv_ref = batch_major(kfac.Cinv)
    np.testing.assert_allclose(cinv.numpy(), cinv_ref, **tol)
    np.testing.assert_allclose(
        w.numpy(), off @ np.swapaxes(cinv_ref[:, :-1], -1, -2), **tol)
    pfwd, pbwd = bt.factor_couple_plain(cinv, w)
    np.testing.assert_allclose(pfwd.numpy(), batch_major(kfac.Pfwd)[:, 1:],
                               **tol)
    np.testing.assert_allclose(pbwd.numpy(), batch_major(kfac.Pbwd)[:, 1:],
                               **tol)


def test_block_qp_data_path_matches_jax():
    """(f) build_block_qp, _ruiz, _assemble_blocks, _apply_A/_apply_AT,
    _residuals and _certificates equal the JAX package's vmapped
    functions (rtol 1e-11: same f64 arithmetic, einsum orders differ)."""
    jprob = reduced_trot()
    jqp, tqp, _, _ = qp_pair(jprob, 2)
    tol = dict(rtol=1e-11, atol=1e-11)
    assert_tree_close(to_np(tqp), to_np(jqp), **tol)

    js, ts = jax.vmap(lambda q: jbq._ruiz(q, 10))(jqp), tbq._ruiz(tqp, 10)
    assert_tree_close(to_np(ts), to_np(js), **tol)

    jset, tset = qp_settings_pair(rho=0.1)
    rho = np.array([0.1, 0.3])
    jr = jax.vmap(lambda s_, r_: jbq._rho_groups(jset, r_, s_))(js, rho)
    tr = tbq._rho_groups(tset, torch.as_tensor(rho), ts)
    jdiag, joff = jax.vmap(lambda s_, r_: jbq._assemble_blocks(
        s_, r_, 1e-6))(js, jr)
    tdiag, toff = tbq._assemble_blocks(ts, tr, 1e-6)
    np.testing.assert_allclose(tdiag.numpy(), np.asarray(jdiag), **tol)
    np.testing.assert_allclose(toff.numpy(), np.asarray(joff), **tol)

    rng = np.random.default_rng(5)
    rand = lambda like: rng.standard_normal(np.shape(like))
    w = jbq.WVars(*(rand(a) for a in js.D))
    z = jbq.ZGroups(*(rand(a) for a in js.l))
    y = jbq.ZGroups(*(rand(a) for a in js.l))
    ylo = jbq.ZGroups(*(1e-8 * rand(a) for a in js.l))
    tw = tbq.WVars(*(torch.as_tensor(a) for a in w))
    tz, ty, tylo = (tbq.ZGroups(*(torch.as_tensor(a) for a in g))
                    for g in (z, y, ylo))
    assert_tree_close(to_np(tbq._apply_A(ts, tw)),
                      to_np(jax.vmap(jbq._apply_A)(js, w)), **tol)
    assert_tree_close(to_np(tbq._apply_AT(ts, ty)),
                      to_np(jax.vmap(jbq._apply_AT)(js, y)), **tol)
    jres = jax.vmap(lambda s_, w_, z_, y_, l_: jbq._residuals(
        s_, jset, w_, z_, y_, l_))(js, w, z, y, ylo)
    tres = tbq._residuals(ts, tset, tw, tz, ty, tylo)
    assert_tree_close(to_np(list(tres)), to_np(list(jres)), **tol)

    # certificates: random deltas (no certificate), a zero delta, and the
    # sign-consistent ray dy = -|y| on the equality rows only
    for scale in (1.0, 0.0):
        jcert = jax.vmap(lambda s_, dw, dy: jbq._certificates(
            s_, jset, dw, dy))(js, jbq.WVars(*(scale * a for a in w)),
                               jbq.ZGroups(*(scale * a for a in y)))
        tcert = tbq._certificates(ts, tset,
                                  tbq.WVars(*(scale * a for a in tw)),
                                  tbq.ZGroups(*(scale * a for a in ty)))
        for j, t in zip(jcert, tcert):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_build_block_qp_wrench6_matches_jax():
    """(f) The wrench6 branch of build_block_qp (talos: CoP rows, forces at
    columns 2:5) equals the JAX package's, rtol 1e-11."""
    jprob = jpresets.build_problem(jpresets.TALOS_PACE, dtype=jnp.float64)
    jqp, tqp, _, _ = qp_pair(jprob, 2)
    assert tqp.G.shape[-1] == 6 and tqp.cop_act.abs().sum() > 0
    assert_tree_close(to_np(tqp), to_np(jqp), rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("fields", [
    dict(factor_method="lu"), dict(sweep_method="parallel"),
    dict(adaptive_rho_mode="sometimes")])
def test_unknown_block_mode_names_raise(fields):
    """'thomas' and 'assoc' run (tests/test_torch_sweeps.py); a factor,
    sweep or adaptive-rho mode name the JAX package does not have raises
    ValueError before any work."""
    from centroidal_mpc_tpu_torch.config import presets as tpresets
    from centroidal_mpc_tpu_torch.models.centroidal import (
        compute_trajectory_data as tdata)
    from centroidal_mpc_tpu_torch.parallel.batch import tile_ocp_config
    p = tpresets.build_problem(tpresets.SOLO12_TROT_MINI,
                               dtype=torch.float64, device="cpu")
    X, U = p.X0[None], p.U0[None]
    cfg = tile_ocp_config(p.ocp, X[:, 0], X[:, -1], X)
    data = tdata(p.model, p.plan.schedule, X, U, with_covariance=False)
    qp = tbq.build_block_qp(p.model, p.plan.schedule, cfg, X, U, data,
                            100.0, 100.0)
    with pytest.raises(ValueError, match="unknown"):
        tbq.solve_block_qp(qp, qp_settings_pair(adaptive_rho=False,
                                                **fields)[1])
