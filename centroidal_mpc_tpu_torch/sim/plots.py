"""Analysis plots: the reference's evaluation figures, headless.

Copy of `centroidal_mpc_tpu/sim/plots.py` (reference src/utils.py:116-385:
contact forces / tangential-vs-vertical ratios vs mu, cumulative
centroidal tracking cost mean+-std, foot-slippage statistics; and
src/contact_plan.py:266-303, swing-foot trajectories).  Every figure
function takes numpy arrays or tensors (read to the host first), returns
the matplotlib Figure, and can save it to a directory (Agg backend; no
display needed).  Importing this module imports matplotlib.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np


def _np(a) -> Optional[np.ndarray]:
    """A tensor or array-like as a numpy array (None stays None)."""
    if a is None:
        return None
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _save(fig, save_dir, name):
    if save_dir is not None:
        path = Path(save_dir)
        path.mkdir(parents=True, exist_ok=True)
        fig.savefig(path / f"{name}.png", dpi=120, bbox_inches="tight")
    return fig


def plot_contact_forces(foot_names, U_nom: np.ndarray,
                        U_stoch: Optional[np.ndarray], dt: float, mu: float,
                        save_dir=None):
    """Per-foot force components and tangential/vertical ratios vs mu
    (reference src/utils.py:116-243)."""
    U_nom, U_stoch = _np(U_nom), _np(U_stoch)
    n, nu = U_nom.shape
    n_c = len(foot_names)
    t = np.arange(n) * dt
    F_nom = U_nom.reshape(n, n_c, -1)
    F_sto = U_stoch.reshape(n, n_c, -1) if U_stoch is not None else None

    fig, axes = plt.subplots(n_c, 1, sharex=True, figsize=(8, 2 * n_c))
    axes = np.atleast_1d(axes)
    for c, (ax, name) in enumerate(zip(axes, foot_names)):
        ax.plot(t, np.full(n, mu), "k--", label=r"$\mu$" if c == 0 else None)
        with np.errstate(divide="ignore", invalid="ignore"):
            r_nom = (np.linalg.norm(F_nom[:, c, :2], axis=-1)
                     / np.maximum(F_nom[:, c, 2], 1e-9))
            r_nom = np.where(F_nom[:, c, 2] > 1e-6, r_nom, 0.0)
        ax.step(t, r_nom, label="nominal" if c == 0 else None)
        if F_sto is not None:
            r_sto = (np.linalg.norm(F_sto[:, c, :2], axis=-1)
                     / np.maximum(F_sto[:, c, 2], 1e-9))
            r_sto = np.where(F_sto[:, c, 2] > 1e-6, r_sto, 0.0)
            ax.step(t, r_sto, label="stochastic" if c == 0 else None)
        ax.set_title(name, fontsize=10)
        ax.set_ylabel(r"$\|f_t\| / f_z$")
    axes[-1].set_xlabel("time [s]")
    fig.legend(loc="upper right", fontsize="small")
    return _save(fig, save_dir, "force_ratios")


def plot_tracking_cost(stats: Dict[str, np.ndarray], dt: float,
                       save_dir=None):
    """Cumulative tracking cost mean +- std across Monte-Carlo sims
    (reference src/utils.py:245-302)."""
    fig, ax = plt.subplots(figsize=(8, 4))
    for label in ("nominal", "stochastic"):
        mean = _np(stats.get(f"{label}_cum_cost"))
        std = _np(stats.get(f"{label}_cum_cost_std"))
        if mean is None:
            continue
        t = np.arange(len(mean)) * dt
        ax.plot(t, mean, label=label)
        if std is not None:
            ax.fill_between(t, mean - std, mean + std, alpha=0.2)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("cumulative centroidal tracking cost")
    ax.legend()
    return _save(fig, save_dir, "tracking_cost")


def plot_centroidal_trajectory(X: np.ndarray, X_ref: Optional[np.ndarray],
                               dt: float, save_dir=None):
    """CoM / momentum trajectories vs reference."""
    labels = ["com x", "com y", "com z", "lin mom x", "lin mom y",
              "lin mom z", "ang mom x", "ang mom y", "ang mom z"]
    X, X_ref = _np(X), _np(X_ref)
    t = np.arange(X.shape[0]) * dt
    fig, axes = plt.subplots(3, 3, sharex=True, figsize=(12, 7))
    for i, ax in enumerate(axes.flat):
        ax.plot(t, X[:, i], label="solution")
        if X_ref is not None:
            ax.plot(t, X_ref[:, i], "--", label="reference")
        ax.set_title(labels[i], fontsize=9)
    axes[0, 0].legend(fontsize="small")
    axes[-1, 1].set_xlabel("time [s]")
    return _save(fig, save_dir, "centroidal_trajectory")


def plot_foot_slippage(slippage_series: Dict[str, np.ndarray],
                       dt_ctrl: float, save_dir=None):
    """Cumulative foot-slippage mean +- std across Monte-Carlo episodes
    (reference src/utils.py:304-385, plot_contact_slippage): one curve per
    controller variant (nominal / stochastic), shaded std band.

    slippage_series: {label: (S, T) cumulative slip per episode} -- from
    sim/physics.foot_slippage_series.
    """
    fig, ax = plt.subplots(figsize=(8, 4))
    for label, series in slippage_series.items():
        series = _np(series)
        t = np.arange(series.shape[1]) * dt_ctrl
        mean = series.mean(axis=0)
        std = series.std(axis=0)
        ax.plot(t, mean, label=label)
        ax.fill_between(t, mean - std, mean + std, alpha=0.2)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("cumulative norm of contact slippage [m]")
    ax.legend()
    return _save(fig, save_dir, "foot_slippage")


def plot_whole_body_solution(q: np.ndarray, qdot: np.ndarray,
                             tau: np.ndarray, dt_ctrl: float,
                             foot_names=("FR", "FL", "HR", "HL"),
                             joint_names=("HAA", "HFE", "KFE"),
                             base_pos: Optional[np.ndarray] = None,
                             save_dir=None):
    """Whole-body solution panels (reference src/whole_body_control.py:
    490-657, plotSolution): per-leg joint positions, velocities, and
    torques over time, plus the base/CoM path when given.

    q/qdot/tau: (T, n_legs*3) leg-major joint trajectories.
    """
    q, qdot, tau = _np(q), _np(qdot), _np(tau)
    t = np.arange(q.shape[0]) * dt_ctrl
    n_legs = q.shape[1] // len(joint_names)
    fig, axes = plt.subplots(3, n_legs, sharex=True,
                             figsize=(3.2 * n_legs, 8))
    axes = np.atleast_2d(axes)
    for c in range(n_legs):
        for row, (arr, ylab) in enumerate(
                [(q, "q [rad]"), (qdot, "qdot [rad/s]"),
                 (tau, "tau [N m]")]):
            ax = axes[row, c]
            for j, jn in enumerate(joint_names):
                ax.plot(t, arr[:, 3 * c + j], lw=0.8,
                        label=jn if (c == 0 and row == 0) else None)
            if row == 0:
                name = foot_names[c] if c < len(foot_names) else f"leg{c}"
                ax.set_title(name, fontsize=9)
            if c == 0:
                ax.set_ylabel(ylab)
            if row == 2:
                ax.set_xlabel("time [s]")
    fig.legend(loc="upper right", fontsize="small")
    _save(fig, save_dir, "whole_body_solution")

    if base_pos is not None:
        fig2, ax2 = plt.subplots(figsize=(6, 4))
        base_pos = _np(base_pos)
        ax2.plot(base_pos[:, 0], base_pos[:, 2])
        ax2.set_xlabel("x [m]")
        ax2.set_ylabel("z [m]")
        ax2.set_title("base path (sagittal)")
        _save(fig2, save_dir, "whole_body_base_path")
    return fig


def plot_swing_trajectories(swing, foot_names, dt_ctrl: float,
                            save_dir=None):
    """Swing-foot position/velocity/acceleration references
    (reference src/contact_plan.py:266-303)."""
    n_c = len(foot_names)
    t = np.arange(swing.pos.shape[-1]) * dt_ctrl
    fig, axes = plt.subplots(3, n_c, sharex=True, figsize=(3 * n_c, 7))
    for c in range(n_c):
        for row, (arr, name) in enumerate(
                [(_np(swing.pos), "pos"), (_np(swing.vel), "vel"),
                 (_np(swing.acc), "acc")]):
            ax = axes[row, c] if n_c > 1 else axes[row]
            for dim, style in zip(range(3), ["-", "--", ":"]):
                ax.plot(t, arr[c, dim], style, lw=0.8)
            if row == 0:
                ax.set_title(foot_names[c], fontsize=9)
            if c == 0:
                ax.set_ylabel(name)
    return _save(fig, save_dir, "swing_trajectories")
