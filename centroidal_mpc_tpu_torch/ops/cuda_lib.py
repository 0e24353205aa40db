"""Build and load the port's hand-written CUDA kernels.

The sources in `centroidal_mpc_tpu_torch/csrc/*.cu` are compiled by `nvcc`
for Hopper (`sm_90a`), one `nvcc` per source, all started together, and
linked into one shared library with a plain C interface, loaded with
`ctypes`.  The library is built at first use into
`build/torch_kernels/<source hash>/` at the repository root (listed in
`.gitignore`), so a fresh checkout builds it from its own sources and a
changed source gets a new build.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import NamedTuple

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[2] / "build"
              / "torch_kernels")
LIB_NAME = "libcmpc_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points (each exists as _f32 and _f64); every one returns the
# cudaError_t of its launch.
_SIGNATURES = {
    "cmpc_tridiag_factor": [_P] * 5 + [_I] * 3 + [_P],
    "cmpc_tridiag_factor_chain": [_P] * 4 + [_I] * 3 + [_P],
    "cmpc_tridiag_factor_couple": [_P] * 3 + [_I] * 3 + [_P],
    "cmpc_tridiag_fwd": [_P] * 4 + [_I] * 3 + [_P],
    "cmpc_tridiag_bwd": [_P] * 4 + [_I] * 3 + [_P],
    "cmpc_dare_lqr": [_P] * 5 + [_I] * 4 + [_P],
    "cmpc_constraint_apply": [_P] * 14 + [_I] * 14 + [_P],
    "cmpc_constraint_apply_T": [_P] * 14 + [_I] * 14 + [_P],
}


class Cost(NamedTuple):
    """Work of one kernel launch, from which its bound is computed.
    bytes: what the function must move, each input read once and each
    output written once, with a triangular or symmetric block counted as
    its lower triangle; flops: its operations, two a multiply-add, with
    the same structure used; layout_bytes: the same tensors whole, as
    they lie in device memory."""
    bytes: int
    flops: int
    layout_bytes: int


def tri(n: int) -> int:
    """Entries of the lower triangle of an n x n block."""
    return n * (n + 1) // 2


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin)")
    return path


def library_path() -> pathlib.Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; the log of each (its command line and its
    output), or raise with the first failure's errors."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [" ".join(c) + "\n" + p.communicate()[0]
            for c, p in zip(cmds, procs)]
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{log[-4000:]}")
    return logs


def build() -> tuple[pathlib.Path, float]:
    """Compile the library if it is not built yet.  Returns its path and
    the seconds spent compiling (0.0 when it was already built).  The
    compiler's output (ptxas register, spill and shared-memory report) is
    kept in `build.log` beside the library."""
    path = library_path()
    if path.exists():
        return path, 0.0
    path.parent.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    tmp = path.with_name(f"{LIB_NAME}.{pid}.tmp")
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [str(path.with_name(f"{src.stem}.{pid}.o")) for src in srcs]
    t0 = time.perf_counter()
    try:
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                         for src, obj in zip(srcs, objs)])
        logs += _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp), *objs]])
    finally:
        for obj in objs:
            pathlib.Path(obj).unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    (path.parent / "build.log").write_text("".join(logs))
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or none
    return path, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.cmpc_error_string.argtypes = [ctypes.c_int]
    lib.cmpc_error_string.restype = ctypes.c_char_p
    return lib


def check_args(name: str, *args) -> str:
    """Validate (tensor, expected shape) pairs for a kernel launch: one
    CUDA device, one dtype (float32 or float64), the expected shapes, and
    contiguity.  Returns the dtype suffix of the C entry point."""
    t0 = args[0][0]
    if t0.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {t0.device}")
    suffix = {"torch.float32": "_f32", "torch.float64": "_f64"}.get(
        str(t0.dtype))
    if suffix is None:
        raise TypeError(f"{name}: dtype {t0.dtype} not supported "
                        "(float32 or float64)")
    for t, shape in args:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{name}: all tensors must share device and "
                             f"dtype ({t0.device}, {t0.dtype})")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return suffix


def launch(name: str, dtype_suffix: str, device, *args) -> None:
    """Call one C entry point on `device`'s current stream and raise if
    its launch failed.  Tensor arguments are passed as pointers."""
    import torch
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args]
        status = getattr(lib, name + dtype_suffix)(*cargs, stream)
    if status != 0:
        msg = lib.cmpc_error_string(status).decode()
        raise RuntimeError(f"{name}{dtype_suffix}: CUDA error {status} "
                           f"({msg})")
