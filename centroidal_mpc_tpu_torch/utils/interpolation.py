"""Solution interpolation to the control rate (numpy).

Copy of `centroidal_mpc_tpu/utils/interpolation.py`: the reference's
interpolate_SCP_solution (src/scp_solver.py:95-111, linear 10x) and
interpolate_centroidal_traj (src/utils.py:26-41, zero-order hold).
Array layout (N, dim), knot-major.  Tensors are read to numpy first.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def interpolate_linear(traj, n_inner: int = 10) -> np.ndarray:
    """Piecewise-linear upsampling: (N, d) -> ((N-1)*n_inner, d) with
    samples x_k + j/n_inner (x_{k+1} - x_k), j = 0..n_inner-1
    (reference src/scp_solver.py:101-110)."""
    traj = _np(traj)
    d = traj[1:] - traj[:-1]                    # (N-1, d)
    frac = (np.arange(n_inner) / n_inner)[None, :, None]
    out = traj[:-1, None, :] + frac * d[:, None, :]
    return out.reshape(-1, traj.shape[-1])


def interpolate_scp_solution(X, U, n_inner: int = 10) -> Dict[str, np.ndarray]:
    """Linear 10x interpolation of an SCP solution, both trajectories
    upsampled independently (reference src/scp_solver.py:95-111)."""
    return {"X": interpolate_linear(X, n_inner),
            "U": interpolate_linear(U, n_inner)}


def interpolate_zero_order(traj, n_inner: int) -> np.ndarray:
    """Zero-order hold: each knot repeated n_inner times
    (reference src/utils.py:26-41)."""
    return np.repeat(_np(traj), n_inner, axis=0)
