"""ctypes bindings for the native runtime library (runtime/ at the repo
root).

A copy of `centroidal_mpc_tpu/runtime/native.py` kept in the port, so
that it imports nothing of the JAX package.  The C++ side provides the
host realtime path around the GPU solve: the trajectory bus (seqlock
plan handoff and control-rate interpolation), contact-plan expansion and
a deadline-driven ticker (runtime/include/cmpc_runtime.h has the API
contract).  The library is built at first use from the repo's
runtime/src/*.cc with g++ and the flags of runtime/Makefile, into
build/torch_runtime/<hash of the sources and flags>/ (git-ignored); it
shares no file with the JAX package's build in runtime/.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
_RUNTIME_DIR = _ROOT / "runtime"
_SOURCES = ("src/trajectory_bus.cc", "src/contact_plan.cc", "src/ticker.cc")
# runtime/Makefile's CXXFLAGS and LDFLAGS
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
          "-pthread")
_lib: Optional[ctypes.CDLL] = None

GAIT_CODES = {"TROT": 0, "PACE": 1, "BOUND": 2}

_D = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    """Where the library of the current sources and flags is built."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for rel in _SOURCES + ("include/cmpc_runtime.h",):
        h.update((_RUNTIME_DIR / rel).read_bytes())
    return (_ROOT / "build" / "torch_runtime" / h.hexdigest()[:16]
            / "libcmpc_runtime.so")


def build_library(force: bool = False) -> Path:
    """Compile the native library with g++ (idempotent).  The library is
    written under a temporary name and renamed into place, so processes
    that build at once never load a half-written file."""
    path = library_path()
    if force or not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", *_FLAGS, "-I", str(_RUNTIME_DIR / "include"),
                 *(str(_RUNTIME_DIR / s) for s in _SOURCES), "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return path


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    lib.cmpc_bus_create.restype = ctypes.c_void_p
    lib.cmpc_bus_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_double]
    lib.cmpc_bus_destroy.argtypes = [ctypes.c_void_p]
    lib.cmpc_bus_publish.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                     _D, _D, _D]
    lib.cmpc_bus_sample.restype = ctypes.c_int64
    lib.cmpc_bus_sample.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                    _D, _D, _D]
    lib.cmpc_expand_contact_plan.restype = ctypes.c_int
    lib.cmpc_expand_contact_plan.argtypes = [
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _D, _D, _D, _D]
    lib.cmpc_plan_horizon.restype = ctypes.c_int
    lib.cmpc_plan_horizon.argtypes = [ctypes.c_int] * 4
    lib.cmpc_ticker_create.restype = ctypes.c_void_p
    lib.cmpc_ticker_create.argtypes = [ctypes.c_int64]
    lib.cmpc_ticker_destroy.argtypes = [ctypes.c_void_p]
    lib.cmpc_ticker_wait.restype = ctypes.c_int64
    lib.cmpc_ticker_wait.argtypes = [ctypes.c_void_p]
    lib.cmpc_ticker_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


class TrajectoryBus:
    """Seqlock plan handoff: solver publishes, control thread samples."""

    def __init__(self, horizon: int, nx: int, nu: int, dt: float):
        self._lib = load()
        self._h = self._lib.cmpc_bus_create(horizon, nx, nu, dt)
        if not self._h:
            raise ValueError("invalid bus dimensions")
        self.horizon, self.nx, self.nu, self.dt = horizon, nx, nu, dt

    def publish(self, t0: float, X, U, K=None):
        X = np.ascontiguousarray(X, np.float64)
        U = np.ascontiguousarray(U, np.float64)
        assert X.shape == (self.horizon + 1, self.nx), X.shape
        assert U.shape == (self.horizon, self.nu), U.shape
        k_ptr = None
        if K is not None:
            K = np.ascontiguousarray(K, np.float64)
            assert K.shape == (self.horizon, self.nu, self.nx)
            k_ptr = _ptr(K)
        self._lib.cmpc_bus_publish(self._h, t0, _ptr(X), _ptr(U), k_ptr)

    def sample(self, t: float) -> Tuple[int, np.ndarray, np.ndarray,
                                        np.ndarray]:
        """(version, x_ref, u_ff, K_fb) at absolute time t; version is -1
        when nothing was published yet."""
        x = np.empty(self.nx, np.float64)
        u = np.empty(self.nu, np.float64)
        k = np.empty((self.nu, self.nx), np.float64)
        version = self._lib.cmpc_bus_sample(self._h, t, _ptr(x), _ptr(u),
                                            _ptr(k))
        return int(version), x, u, k

    def close(self):
        if self._h:
            self._lib.cmpc_bus_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def expand_contact_plan(gait_type: str, step_length: float, step_knots: int,
                        support_knots: int, nb_steps: int,
                        feet0: np.ndarray):
    """Native gait expansion; returns (logic (N,C), pos (N,C,3),
    rot (N,C,3,3)) matching contact.plan.build_contact_plan."""
    lib = load()
    code = GAIT_CODES[gait_type]
    n = lib.cmpc_plan_horizon(code, step_knots, support_knots, nb_steps)
    if n <= 0:
        raise ValueError("invalid gait parameters")
    feet0 = np.ascontiguousarray(feet0, np.float64)
    c = feet0.shape[0]
    logic = np.zeros((n, c), np.float64)
    pos = np.zeros((n, c, 3), np.float64)
    rot = np.zeros((n, c, 3, 3), np.float64)
    written = lib.cmpc_expand_contact_plan(
        code, step_length, step_knots, support_knots, nb_steps, c,
        _ptr(feet0), _ptr(logic), _ptr(pos), _ptr(rot))
    if written != n:
        raise RuntimeError(f"expansion wrote {written}, expected {n}")
    return logic, pos, rot


class Ticker:
    """Deadline-driven periodic ticks (1 kHz control-loop pacing)."""

    def __init__(self, period_s: float):
        self._lib = load()
        self._h = self._lib.cmpc_ticker_create(int(period_s * 1e9))
        if not self._h:
            raise ValueError("invalid period")

    def wait(self) -> int:
        """Sleep to next deadline; returns wakeup lateness in ns."""
        return int(self._lib.cmpc_ticker_wait(self._h))

    def stats(self):
        count = ctypes.c_int64()
        max_late = ctypes.c_int64()
        mean_late = ctypes.c_double()
        self._lib.cmpc_ticker_stats(self._h, ctypes.byref(count),
                                    ctypes.byref(max_late),
                                    ctypes.byref(mean_late))
        return {"ticks": count.value, "max_late_ns": max_late.value,
                "mean_late_ns": mean_late.value}

    def close(self):
        if self._h:
            self._lib.cmpc_ticker_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
