"""Artifact store: the npz stage-handoff protocol.

Copy of `centroidal_mpc_tpu/utils/artifacts.py`.  The reference pipeline
hands data between stages through npz files with fixed names (SURVEY.md
section 5 "checkpoint/resume"):
  wholeBody_to_centroidal_traj.npz   (X)      DDP warm start -> SCP
  centroidal_to_wholeBody_traj.npz   (X, U)   SCP -> DDP tracking
  scp_sol_interpol_{nom,stoch}.npz   (X, U)   interpolated SCP solution
  wholeBody_interpolated_traj.npz    (X, U, q, qdot, gains)
Here the same names and keys live in a directory-scoped store, so a
store written by the port reads like one written by the JAX package.
Tensors are saved as numpy arrays.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# Canonical stage-handoff artifact names (reference file names, minus .npz).
WHOLEBODY_TO_CENTROIDAL = "wholeBody_to_centroidal_traj"
CENTROIDAL_TO_WHOLEBODY = "centroidal_to_wholeBody_traj"
SCP_INTERPOLATED_NOMINAL = "scp_sol_interpol_nom"
SCP_INTERPOLATED_STOCHASTIC = "scp_sol_interpol_stoch"
WHOLEBODY_INTERPOLATED = "wholeBody_interpolated_traj"


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class ArtifactStore:
    """Directory-backed npz artifact store."""

    def __init__(self, root: os.PathLike | str):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, name: str) -> Path:
        return self.root / f"{name}.npz"

    def save(self, name: str, **arrays) -> Path:
        path = self._path(name)
        np.savez(path, **{k: _np(v) for k, v in arrays.items()})
        return path

    def load(self, name: str) -> Dict[str, np.ndarray]:
        with np.load(self._path(name)) as data:
            return {k: data[k] for k in data.files}

    def exists(self, name: str) -> bool:
        return self._path(name).exists()

    def maybe_load(self, name: str) -> Optional[Dict[str, np.ndarray]]:
        return self.load(name) if self.exists(name) else None

    def manifest(self) -> Dict[str, dict]:
        """Every file under the store's root: npz keys and shapes, .dat
        rows and columns, other files (figures, the HTML preview) by
        name; what a run is compared by with the JAX package's run."""
        out = {}
        for path in sorted(self.root.iterdir()):
            if path.suffix == ".npz":
                with np.load(path) as f:
                    out[path.name] = {k: list(f[k].shape) for k in f.files}
            elif path.suffix == ".dat":
                out[path.name] = {"rows_cols":
                                  list(np.loadtxt(path).shape)}
            else:
                out[path.name] = {}
        return out
