"""Polynomial trajectory primitives (vectorized, numpy).

Copy of `centroidal_mpc_tpu/utils/polynomials.py` (reference
src/utils.py:54-92, compute_3rd_order_poly_traj and
compute_5th_order_poly_traj, scalar loops there): the sample axis is
vectorized.  Numpy in, numpy out.
"""
from __future__ import annotations

import numpy as np


def poly3_traj(x0, x1, T: float, dt: float):
    """Cubic rest-to-rest trajectory: x(0)=x0, x(T)=x1, dx(0)=dx(T)=0.

    Returns (x, dx, ddx) with shape (n, N), N = round(T/dt), sampled at
    t=i*dt (reference src/utils.py:54-69).
    """
    x0 = np.atleast_1d(np.asarray(x0, dtype=np.float64))
    x1 = np.atleast_1d(np.asarray(x1, dtype=np.float64))
    c = 3.0 * (x1 - x0) / T**2
    d = 2.0 * (x0 - x1) / T**3
    # round, not int(): int(0.08 / 0.001) is 79 and leaves a hole at the
    # last sample
    n_samples = int(round(T / dt))
    t = (np.arange(n_samples) * dt)[None, :]
    x = x0[:, None] + c[:, None] * t**2 + d[:, None] * t**3
    dx = 2.0 * c[:, None] * t + 3.0 * d[:, None] * t**2
    ddx = 2.0 * c[:, None] + 6.0 * d[:, None] * t
    return x, dx, ddx


def poly5_traj(x0, x1, T: float, dt: float):
    """Quintic trajectory with the reference's coefficient choice
    (src/utils.py:71-92): a=x0, b=c=f=0, d=2(x1-x0)/T^3, e=(x0-x1)/T^4.

    This lands at x0 + d T^3 + e T^4 = x1 with dx(T) = 2(x1-x0)/T: the
    endpoint velocity is NOT zero, as in the reference.
    """
    x0 = np.atleast_1d(np.asarray(x0, dtype=np.float64))
    x1 = np.atleast_1d(np.asarray(x1, dtype=np.float64))
    d = 2.0 * (x1 - x0) / T**3
    e = (x0 - x1) / T**4
    n_samples = int(round(T / dt))
    t = (np.arange(n_samples) * dt)[None, :]
    x = x0[:, None] + d[:, None] * t**3 + e[:, None] * t**4
    dx = 3.0 * d[:, None] * t**2 + 4.0 * e[:, None] * t**3
    ddx = 6.0 * d[:, None] * t + 12.0 * e[:, None] * t**2
    return x, dx, ddx
