"""Mean QP (ADMM) iterations a scenario over every lane of the window,
from the program's own count `ScpSolution.qp_iterations`."""
UNIT = "iter"
LAYER = "solver loop (solver.scp, ops.blockqp._admm_loop_batched)"
MOVES = "solves_per_s"


def read(rec):
    if rec["mode"] != "batch" or len(rec["qp"]) == 0:
        return None
    return float(rec["qp"].mean())
