"""The block ADMM's constraint operator A and its transpose A' as two CUDA
kernels (`csrc/constraint_apply.cu`), one launch a product.

They replace no TPU kernel: the JAX package's `_apply_A` / `_apply_AT`
are einsums that XLA fuses.  On the card the port's einsums were cuBLAS
batched gemv over tiny blocks and a tail of elementwise launches, so each
whole product is one kernel here.  `ops.blockqp._apply_A` and
`_apply_AT` call `apply_A` and `apply_AT` for CUDA tensors and their
plain versions (`_apply_A_plain`, `_apply_AT_plain`, the einsums) for CPU
tensors; on a CUDA tensor there is no fallback.

The coefficient blocks are passed in the order of `COEFFICIENTS` (fields
of `ops.blockqp._Scaled`) and must be contiguous.  The vectors are the
solve's own tensors: w = (x, u, t) any strided views (of the packed
(B, N+1, V) W, say), z one lane-major (B, m) buffer whose lanes may lie
any stride apart, each lane's row holding the groups of
`ops.blockqp.ZGroups` in field order.  A w is returned as such a buffer,
A' z as a packed W.  The kernels are built for nx = 9 and the contact
layouts (C, nuc) of `CONTACT_LAYOUTS`.  `launches` counts the wrappers'
calls on the card; `constraint_apply_cost` gives the work of one product,
from which its bound is computed.
"""
from __future__ import annotations

import torch

from centroidal_mpc_tpu_torch.ops import cuda_lib

launches = {"constraint_apply": 0, "constraint_apply_T": 0}

COEFFICIENTS = ("d0", "Ah", "Bh", "Ih", "dN", "Gh", "coph", "Th", "wh", "sh")
NX = 9
# (contacts, entries a contact): solo12, bolt, the talos wrench6 feet
CONTACT_LAYOUTS = ((4, 3), (2, 3), (2, 6))


def _check_coefficients(name: str, coef):
    """Validate the coefficient blocks; (dtype suffix, (B, N, nx, C, nuc))."""
    d0, Ah, Bh, Ih, dN, Gh, coph, Th, wh, sh = coef
    if Ah.dim() != 4 or Gh.dim() != 5:
        raise ValueError(f"{name}: Ah (B, N, nx, nx) and Gh (B, N, C, 5, "
                         f"nuc) expected, got {tuple(Ah.shape)}, "
                         f"{tuple(Gh.shape)}")
    B, N, nx = Ah.shape[:3]
    nu = Bh.shape[-1]
    C, nuc = Gh.shape[2], Gh.shape[4]
    sfx = cuda_lib.check_args(
        name, (Ah, (B, N, nx, nx)), (d0, (B, nx)), (Bh, (B, N, nx, C * nuc)),
        (Ih, (B, N, nx)), (dN, (B, nx)), (Gh, (B, N, C, 5, nuc)),
        (coph, (B, N, C, 2)), (Th, (B, N + 1, 8, 3)), (wh, (B, N + 1, 8)),
        (sh, (B, N + 1)))
    if nx != NX or (C, nuc) not in CONTACT_LAYOUTS or nu != C * nuc:
        raise ValueError(f"{name}: no kernel for nx={nx}, (C, nuc)=({C}, "
                         f"{nuc}); built for nx={NX}, (C, nuc) in "
                         f"{CONTACT_LAYOUTS}")
    return sfx, (B, N, nx, C, nuc)


def _check_like(name: str, ref: torch.Tensor, pairs) -> None:
    for t, shape in pairs:
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{name}: all tensors must share device and "
                             f"dtype ({ref.device}, {ref.dtype})")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")


def _zwidth(N: int, C: int) -> int:
    """m: init, dyn, final, cop, fric, trust, slack rows of a lane."""
    return NX + N * NX + NX + N * C * 2 + N * C * 5 + (N + 1) * 8 + (N + 1)


def apply_A(coef, x: torch.Tensor, u: torch.Tensor, t: torch.Tensor):
    """z = A w on the card, a (B, m) buffer, from x (B, N+1, nx),
    u (B, N, nu), t (B, N+1)."""
    sfx, (B, N, nx, C, nuc) = _check_coefficients("constraint_apply", coef)
    ref = coef[1]
    _check_like("constraint_apply", ref, ((x, (B, N + 1, nx)),
                                          (u, (B, N, C * nuc)),
                                          (t, (B, N + 1))))
    z = ref.new_empty((B, _zwidth(N, C)))
    cuda_lib.launch("cmpc_constraint_apply", sfx, ref.device, *coef, x, u, t,
                    z, B, N, nx, C, nuc, *x.stride(), *u.stride(),
                    *t.stride(), z.stride(0))
    launches["constraint_apply"] += 1
    return z


def apply_AT(coef, z: torch.Tensor) -> torch.Tensor:
    """w = A' z on the card from a (B, m) z: the packed (B, N+1, V) W,
    its dummy control slot of knot N zero."""
    sfx, (B, N, nx, C, nuc) = _check_coefficients("constraint_apply_T",
                                                  coef)
    ref = coef[1]
    _check_like("constraint_apply_T", ref, ((z, (B, _zwidth(N, C))),))
    if z.stride(1) != 1:
        raise ValueError("constraint_apply_T: a lane's rows of z must be "
                         "contiguous")
    W = ref.new_empty((B, N + 1, nx + C * nuc + 1))
    x, u, t = W[..., :nx], W[..., nx:-1], W[..., -1]
    cuda_lib.launch("cmpc_constraint_apply_T", sfx, ref.device, *coef, z,
                    x, u, t, B, N, nx, C, nuc, z.stride(0), *x.stride(),
                    *u.stride(), *t.stride())
    launches["constraint_apply_T"] += 1
    return W


def constraint_apply_cost(B: int, N: int, nx: int, nu: int, C: int,
                          nuc: int, itemsize: int = 4) -> cuda_lib.Cost:
    """Work of one product, A w or A' z (the same for both): every
    coefficient read once (d0, dN a scenario; Ah, Bh, Ih, Gh, coph a knot
    k < N; Th, wh, sh a knot k <= N), w = (x, u, t) and z read or written
    once; two flops a coefficient (each multiplies one entry and adds it
    in).  Every tensor is dense, so layout_bytes equals bytes."""
    coef = (2 * nx + N * (nx * nx + nx * nu + nx + C * 5 * nuc + C * 2)
            + (N + 1) * (8 * 3 + 8 + 1))
    w = (N + 1) * nx + N * nu + (N + 1)
    z = 2 * nx + N * (nx + C * 2 + C * 5) + (N + 1) * (8 + 1)
    nbytes = B * (coef + w + z) * itemsize
    return cuda_lib.Cost(bytes=nbytes, flops=2 * B * coef,
                         layout_bytes=nbytes)
