"""Share of their roofline that the block-tridiagonal KKT solves reach in
the traced stretch, in %.

Bound: the frozen cost functions (scpbench/costs.py) at the cell's
(B, N+1, V), times the factorizations and block sweeps the solve asked
for, counted by the program's solve-API counters (`block_tridiag.
launches`), not by device launches, so the work is the same whatever
kernel implements it.  Each call's bound is the larger of its bytes over
the HBM rate and its flops over the float32 rate (published H100 SXM
peaks at 700 W).  Time: the device time of the ops named in KERNELS.
"""
from scpbench import costs

UNIT = "%"
LAYER = "kernels (ops.block_tridiag, csrc/block_tridiag.cu)"
MOVES = "solves_per_s"
# the device kernels that implement the factor and the two sweeps
KERNELS = ("tridiag_factor_chain_kernel", "tridiag_factor_couple_kernel",
           "tridiag_fwd_kernel", "tridiag_bwd_kernel")


def bound_s(rec):
    B, n1, V = rec["batch"], rec["n1"], rec["V"]
    c = rec["counts"]
    sweeps = c.get("tridiag_fwd", 0) + c.get("tridiag_bwd", 0)
    return (c.get("tridiag_factor", 0) * costs.bound_s(
        costs.factor_cost(B, n1, V))[0]
        + sweeps * costs.bound_s(costs.sweep_cost(B, n1, V))[0])


def read(rec):
    if rec["mode"] != "batch" or not rec.get("device_ops"):
        return None
    ns = sum(d for name, _, d in rec["device_ops"]
             if any(k in name for k in KERNELS))
    bound = bound_s(rec)
    if ns <= 0 or bound <= 0:
        return None
    return 100.0 * bound / (ns / 1e9)
