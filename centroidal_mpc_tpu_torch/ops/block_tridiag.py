"""Block-tridiagonal Cholesky factor and solve of the ADMM normal matrix.

Counterpart of `centroidal_mpc_tpu/ops/pallas_blockqp.py`.  Three CUDA
kernels (`csrc/block_tridiag.cu`) replace its three `pl.pallas_call`s:

  * `factor_batched` (kernel `tridiag_factor`) replaces `factor_batched`
    (pallas_blockqp.py:203): per scenario, the blocked Cholesky of
    M = P + sigma I + A' diag(rho) A over the N+1 knots, stored
    pre-inverted.  Each call is two device launches: the knot chain
    (`tridiag_factor_chain_kernel`: Cinv and W) and the couplings
    (`tridiag_factor_couple_kernel`: Pfwd over W, and Pbwd).
    `factor_chain` and `factor_couple` launch each alone, so that each
    can be checked and timed; the main path calls neither, and
    `launches["tridiag_factor"]` counts calls of `factor_batched`;
  * `forward_sweep` (kernel `tridiag_fwd`) and `backward_sweep` (kernel
    `tridiag_bwd`) replace the two sweeps of `solve_batched`
    (pallas_blockqp.py:280, :299); `solve_batched` runs both.

Layout (batch-major, shared by the kernels and their plain versions):
Cinv (B, N+1, V, V) = C_k^{-1}; Pfwd (B, N, V, V), slot k-1 = C_k^{-1} W_k;
Pbwd (B, N, V, V), slot k-1 = C_{k-1}^{-T} W_k', with W_k =
O_{k-1} C_{k-1}^{-T}.  C_k^{-T} is not stored: the backward sweep applies
Cinv transposed.  The batch is not padded and V is used as is (<= 32).

What bounds the kernels on an H100 and how they are laid out is written
at the top of the CUDA source.  On a CPU tensor each wrapper runs its
plain PyTorch version (a port of the JAX package's XLA twins
`_block_tridiag_cholesky` / `_block_tridiag_solve`); on a CUDA tensor it
launches its kernel or raises.  `launches` counts the wrappers' calls on
the card (one per launch, the factor's pair once).  When
V*V*itemsize is a multiple of 16 bytes (V even) the sweeps copy the
blocks with TMA, so their wrappers then require Cinv and the coupling
blocks to start on a 16-byte boundary.  `sweep_cost`, `factor_cost`
(the whole factor) and `factor_chain_cost` / `factor_couple_cost` (its
two launches) give the work from which a bound is computed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from centroidal_mpc_tpu_torch.ops import cuda_lib

launches = {"tridiag_factor": 0, "tridiag_fwd": 0, "tridiag_bwd": 0}


class TridiagFactor(NamedTuple):
    Cinv: torch.Tensor   # (B, N+1, V, V)  C_k^{-1}
    Pfwd: torch.Tensor   # (B, N, V, V)    C_k^{-1} W_k        (slot k-1)
    Pbwd: torch.Tensor   # (B, N, V, V)    C_{k-1}^{-T} W_k'   (slot k-1)


def _matvec(m, v):
    return (m @ v.unsqueeze(-1)).squeeze(-1)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def factor_chain_plain(diag: torch.Tensor,
                       off: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The knot chain of the blocked Cholesky M = L L', sequential over
    knots.  diag (B, N+1, V, V), off (B, N, V, V) (off[:, k] couples knot
    k+1's rows to knot k's columns).  Returns Cinv (B, N+1, V, V) and W
    (B, N, V, V), slot k-1 = W_k = O_{k-1} C_{k-1}^{-T}."""
    n1, V = diag.shape[1], diag.shape[-1]
    c = torch.linalg.cholesky(diag[:, 0])
    chol, ws = [c], []
    for k in range(1, n1):
        # W = O C^{-T}
        w = torch.linalg.solve_triangular(c, off[:, k - 1].mT,
                                          upper=False).mT
        c = torch.linalg.cholesky(diag[:, k] - w @ w.mT)
        chol.append(c)
        ws.append(w)
    chol = torch.stack(chol, dim=1)
    eye = torch.eye(V, dtype=diag.dtype, device=diag.device).expand_as(chol)
    cinv = torch.linalg.solve_triangular(chol, eye, upper=False)
    W = torch.stack(ws, dim=1) if ws else off.new_zeros(off.shape)
    return cinv, W


def factor_couple_plain(cinv: torch.Tensor,
                        w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The couplings from the chain's output: Pfwd[k-1] = C_k^{-1} W_k and
    Pbwd[k-1] = C_{k-1}^{-T} W_k'."""
    return cinv[:, 1:] @ w, cinv[:, :-1].mT @ w.mT


def factor_plain(diag: torch.Tensor, off: torch.Tensor) -> TridiagFactor:
    """Blocked Cholesky M = L L', pre-inverted: the chain, then the
    couplings."""
    cinv, w = factor_chain_plain(diag, off)
    return TridiagFactor(cinv, *factor_couple_plain(cinv, w))


def forward_sweep_plain(fac: TridiagFactor, b: torch.Tensor) -> torch.Tensor:
    """v_0 = Cinv_0 b_0, v_k = Cinv_k b_k - Pfwd[k-1] v_{k-1}."""
    c = _matvec(fac.Cinv, b)
    vs = [c[:, 0]]
    for k in range(1, b.shape[1]):
        vs.append(c[:, k] - _matvec(fac.Pfwd[:, k - 1], vs[-1]))
    return torch.stack(vs, dim=1)


def backward_sweep_plain(fac: TridiagFactor,
                         v: torch.Tensor) -> torch.Tensor:
    """w_N = Cinv_N' v_N, w_k = Cinv_k' v_k - Pbwd[k] w_{k+1}."""
    d = _matvec(fac.Cinv.mT, v)
    n = v.shape[1] - 1
    ws = [d[:, n]]
    for k in range(n - 1, -1, -1):
        ws.append(d[:, k] - _matvec(fac.Pbwd[:, k], ws[-1]))
    return torch.stack(ws[::-1], dim=1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _factor_args(name: str, diag: torch.Tensor, off: torch.Tensor):
    B, n1, V = diag.shape[0], diag.shape[1], diag.shape[-1]
    sfx = cuda_lib.check_args(name, (diag, (B, n1, V, V)),
                              (off, (B, n1 - 1, V, V)))
    if V > 32:
        raise ValueError(f"{name}: V={V} > 32")
    return sfx, (B, n1, V)


def factor_batched(diag: torch.Tensor, off: torch.Tensor) -> TridiagFactor:
    """Pre-inverted blocked Cholesky factor of every scenario's M: one
    call, two launches (the chain, then the couplings)."""
    if diag.device.type == "cpu":
        return factor_plain(diag, off)
    sfx, dims = _factor_args("tridiag_factor", diag, off)
    cinv = torch.empty_like(diag)
    pfwd = torch.empty_like(off)
    pbwd = torch.empty_like(off)
    cuda_lib.launch("cmpc_tridiag_factor", sfx, diag.device, diag, off,
                    cinv, pfwd, pbwd, *dims)
    launches["tridiag_factor"] += 1
    return TridiagFactor(Cinv=cinv, Pfwd=pfwd, Pbwd=pbwd)


def factor_chain(diag: torch.Tensor,
                 off: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The factor's first launch alone: (Cinv, W) as `factor_chain_plain`
    gives them."""
    if diag.device.type == "cpu":
        return factor_chain_plain(diag, off)
    sfx, dims = _factor_args("tridiag_factor_chain", diag, off)
    cinv = torch.empty_like(diag)
    w = torch.empty_like(off)
    cuda_lib.launch("cmpc_tridiag_factor_chain", sfx, diag.device, diag, off,
                    cinv, w, *dims)
    return cinv, w


def factor_couple(cinv: torch.Tensor,
                  w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The factor's second launch alone: (Pfwd, Pbwd) from the chain's
    output.  On the card Pfwd is written in place over `w` (the tensor
    returned is `w`); the plain version on a CPU tensor leaves `w` as it
    is."""
    if cinv.device.type == "cpu":
        return factor_couple_plain(cinv, w)
    sfx, dims = _factor_args("tridiag_factor_couple", cinv, w)
    pbwd = torch.empty_like(w)
    cuda_lib.launch("cmpc_tridiag_factor_couple", sfx, cinv.device, cinv, w,
                    pbwd, *dims)
    return w, pbwd


def _sweep(kernel: str, mats: tuple, rhs: torch.Tensor) -> torch.Tensor:
    cinv, coup = mats
    B, n1, V = rhs.shape
    sfx = cuda_lib.check_args(kernel, (rhs, (B, n1, V)),
                              (cinv, (B, n1, V, V)),
                              (coup, (B, n1 - 1, V, V)))
    if V > 32:
        raise ValueError(f"{kernel}: V={V} > 32")
    if (V * V * rhs.element_size()) % 16 == 0 and any(
            t.numel() and t.data_ptr() % 16 for t in (cinv, coup)):
        raise ValueError(f"{kernel}: the blocks must start on a 16-byte "
                         "boundary (the kernel copies them with TMA)")
    out = torch.empty_like(rhs)
    cuda_lib.launch("cmpc_" + kernel, sfx, rhs.device, cinv, coup, rhs,
                    out, B, n1, V)
    launches[kernel] += 1
    return out


def forward_sweep(fac: TridiagFactor, b: torch.Tensor) -> torch.Tensor:
    """Forward sweep of M w = b; b (B, N+1, V)."""
    if b.device.type == "cpu":
        return forward_sweep_plain(fac, b)
    return _sweep("tridiag_fwd", (fac.Cinv, fac.Pfwd), b)


def backward_sweep(fac: TridiagFactor, v: torch.Tensor) -> torch.Tensor:
    """Backward sweep of M w = b from the forward sweep's output v."""
    if v.device.type == "cpu":
        return backward_sweep_plain(fac, v)
    return _sweep("tridiag_bwd", (fac.Cinv, fac.Pbwd), v)


def solve_batched(fac: TridiagFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve M w = b for every scenario; b, w (B, N+1, V)."""
    return backward_sweep(fac, forward_sweep(fac, b))


def affine_sweep_assoc(P: torch.Tensor, c: torch.Tensor,
                       reverse: bool) -> torch.Tensor:
    """All-prefix solution of v_k = c_k - P_k v_{k-1} (or, reversed,
    v_k = c_k - P_k v_{k+1}) by Hillis-Steele doubling over the knot
    axis: element k is the affine map (A_k, b_k) = (-P_k, c_k), the
    boundary element carries A = 0, and step d composes each element
    with the one d knots before it (after, when reversed), in
    ceil(log2(N+1)) batched steps of (B, N+1, V, V) products.  The
    counterpart of the JAX package's `_affine_sweep_assoc` (an XLA
    associative scan): more operations than the sequential sweep, far
    fewer dependent steps.  P (B, N, V, V), c (B, N+1, V) -> (B, N+1, V)."""
    zero = torch.zeros_like(P[:, :1])
    A = torch.cat([-P, zero], 1) if reverse else torch.cat([zero, -P], 1)
    b = c
    n1, d = c.shape[1], 1
    while d < n1:
        if reverse:     # element k takes element k + d as its input
            a_in, b_in = A[:, d:], b[:, d:]
            A_new = torch.cat([A[:, :-d] @ a_in, A[:, -d:]], 1)
            b_new = torch.cat([_matvec(A[:, :-d], b_in) + b[:, :-d],
                               b[:, -d:]], 1)
        else:           # element k takes element k - d as its input
            a_in, b_in = A[:, :-d], b[:, :-d]
            A_new = torch.cat([A[:, :d], A[:, d:] @ a_in], 1)
            b_new = torch.cat([b[:, :d], _matvec(A[:, d:], b_in)
                               + b[:, d:]], 1)
        A, b, d = A_new, b_new, 2 * d
    return b


def solve_assoc(fac: TridiagFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve M w = b with both sweeps as log-depth doubling scans (plain
    PyTorch on every device, as the JAX package's 'assoc' sweep is XLA):
    the same factor, no sweep kernel launched."""
    v = affine_sweep_assoc(fac.Pfwd, _matvec(fac.Cinv, b), reverse=False)
    return affine_sweep_assoc(fac.Pbwd, _matvec(fac.Cinv.mT, v),
                              reverse=True)


# ---------------------------------------------------------------------------
# work per launch (for bounds): each input read once, each output written
# once, and the floating-point operations of the kernel's arithmetic
# ---------------------------------------------------------------------------


def sweep_cost(B: int, n1: int, V: int, itemsize: int = 4) -> cuda_lib.Cost:
    """Work of one forward or backward sweep: the Cinv blocks (lower
    triangular), the coupling blocks and the rhs in, the solution out; a
    triangular matvec per knot, a dense one per coupling and V
    subtractions per coupled knot."""
    n, tri = n1 - 1, cuda_lib.tri(V)
    vecs = 2 * n1 * V
    return cuda_lib.Cost(
        bytes=B * (n1 * tri + n * V * V + vecs) * itemsize,
        flops=B * (n1 * 2 * tri + n * (2 * V * V + V)),
        layout_bytes=B * ((n1 + n) * V * V + vecs) * itemsize)


def factor_cost(B: int, n1: int, V: int, itemsize: int = 4) -> cuda_lib.Cost:
    """Work of one factor: the diagonal blocks (symmetric) and the coupling
    blocks in; Cinv (lower triangular), Pfwd and Pbwd out.  Per knot a
    Cholesky and a triangular inverse (V^3/3 each); per coupled knot four
    products of V^2 (V+1) each (W = O C^-T, the lower triangle of W W',
    Pfwd and Pbwd: each has a triangular factor or a symmetric result)
    and D - W W' on a triangle."""
    n, tri = n1 - 1, cuda_lib.tri(V)
    return cuda_lib.Cost(
        bytes=B * (2 * n1 * tri + 3 * n * V * V) * itemsize,
        flops=B * (n1 * 2 * V ** 3 // 3 + n * (4 * V * V * (V + 1) + tri)),
        layout_bytes=B * (2 * n1 + 3 * n) * V * V * itemsize)


def factor_chain_cost(B: int, n1: int, V: int,
                      itemsize: int = 4) -> cuda_lib.Cost:
    """Work of the factor's first launch: the diagonal blocks (symmetric)
    and the coupling blocks in; Cinv (lower triangular) and W out.  Per
    knot the Cholesky and triangular inverse, per coupled knot W = O C^-T
    and the lower triangle of D - W W' (factor_cost's terms)."""
    n, tri = n1 - 1, cuda_lib.tri(V)
    return cuda_lib.Cost(
        bytes=B * (2 * n1 * tri + 2 * n * V * V) * itemsize,
        flops=B * (n1 * 2 * V ** 3 // 3 + n * (2 * V * V * (V + 1) + tri)),
        layout_bytes=B * 2 * (n1 + n) * V * V * itemsize)


def factor_couple_cost(B: int, n1: int, V: int,
                       itemsize: int = 4) -> cuda_lib.Cost:
    """Work of the factor's second launch: Cinv (lower triangular) and W
    in; Pfwd and Pbwd out; per coupled knot two products with a
    triangular factor."""
    n, tri = n1 - 1, cuda_lib.tri(V)
    return cuda_lib.Cost(
        bytes=B * (n1 * tri + 3 * n * V * V) * itemsize,
        flops=B * n * 2 * V * V * (V + 1),
        layout_bytes=B * (n1 + 3 * n) * V * V * itemsize)
