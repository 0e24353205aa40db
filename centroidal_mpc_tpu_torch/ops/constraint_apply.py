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
of `ops.blockqp._Scaled`) and must be contiguous; the vectors w = (x, u,
t) may be any strided views (the solve's packed output, say), the
constraint groups z any layout (copied to contiguous where they are not).
The kernels are built for nx = 9 and the contact layouts (C, nuc) of
`CONTACT_LAYOUTS`.  `launches` counts the wrappers' calls on the card;
`constraint_apply_cost` gives the work of one product, from which its
bound is computed.
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


def apply_A(coef, x: torch.Tensor, u: torch.Tensor, t: torch.Tensor):
    """z = A w on the card: (init, dyn, final, cop, fric, trust, slack) of
    `ops.blockqp.ZGroups` from x (B, N+1, nx), u (B, N, nu), t (B, N+1)."""
    sfx, (B, N, nx, C, nuc) = _check_coefficients("constraint_apply", coef)
    ref = coef[1]
    _check_like("constraint_apply", ref, ((x, (B, N + 1, nx)),
                                          (u, (B, N, C * nuc)),
                                          (t, (B, N + 1))))
    out = tuple(ref.new_empty(shape) for shape in (
        (B, nx), (B, N, nx), (B, nx), (B, N, C, 2), (B, N, C, 5),
        (B, N + 1, 8), (B, N + 1)))
    cuda_lib.launch("cmpc_constraint_apply", sfx, ref.device, *coef, x, u, t,
                    *out, B, N, nx, C, nuc, *x.stride(), *u.stride(),
                    *t.stride())
    launches["constraint_apply"] += 1
    return out


def apply_AT(coef, z):
    """w = A' z on the card: (x, u, t) from the groups of z (init, dyn,
    final, cop, fric, trust, slack)."""
    sfx, (B, N, nx, C, nuc) = _check_coefficients("constraint_apply_T",
                                                  coef)
    ref = coef[1]
    z = tuple(g.contiguous() for g in z)
    _check_like("constraint_apply_T", ref, zip(z, (
        (B, nx), (B, N, nx), (B, nx), (B, N, C, 2), (B, N, C, 5),
        (B, N + 1, 8), (B, N + 1))))
    x = ref.new_empty((B, N + 1, nx))
    u = ref.new_empty((B, N, C * nuc))
    t = ref.new_empty((B, N + 1))
    cuda_lib.launch("cmpc_constraint_apply_T", sfx, ref.device, *coef, *z,
                    x, u, t, B, N, nx, C, nuc)
    launches["constraint_apply_T"] += 1
    return x, u, t


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
