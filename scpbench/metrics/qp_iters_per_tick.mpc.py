"""Mean QP (ADMM) iterations a tick over every tick of the window, from
the program's own count `ScpSolution.qp_iterations`."""
UNIT = "iter"
LAYER = "solver loop (solver.scp, ops.blockqp._admm_loop_batched)"
MOVES = "tick_ms_p50"


def read(rec):
    if rec["mode"] != "mpc" or len(rec["qp"]) == 0:
        return None
    return float(rec["qp"].mean())
