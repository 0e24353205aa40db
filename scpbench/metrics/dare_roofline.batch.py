"""Share of its roofline that the truncated-DARE gain kernel reaches in
the traced stretch, in %.

Bound: the frozen cost function (scpbench/costs.py `lqr_cost`) at
S = B N problems of the cell's (nx, nu) and its `lqr_iters` steps, times
the kernel's launches (`lqr_kernel.launches["dare_lqr"]`).  The bound is
the larger of the bytes over the HBM rate and the flops over the float32
rate (published H100 SXM peaks at 700 W).  Time: the device time of the
ops named in KERNELS."""
from scpbench import costs

UNIT = "%"
LAYER = "kernels (ops.lqr_kernel, csrc/dare_lqr.cu)"
MOVES = "solves_per_s"
KERNELS = ("dare_lqr_kernel",)


def bound_s(rec):
    nu = rec["nu"]
    S = rec["batch"] * (rec["n1"] - 1)
    cost = costs.lqr_cost(S, rec["V"] - nu - 1, nu, rec["lqr_iters"])
    return rec["counts"].get("dare_lqr", 0) * costs.bound_s(cost)[0]


def read(rec):
    if rec["mode"] != "batch" or not rec.get("device_ops"):
        return None
    ns = sum(d for name, _, d in rec["device_ops"]
             if any(k in name for k in KERNELS))
    bound = bound_s(rec)
    if ns <= 0 or bound <= 0:
        return None
    return 100.0 * bound / (ns / 1e9)
