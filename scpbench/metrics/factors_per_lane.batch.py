"""Factorizations of the ADMM matrix a lane in the traced stretch: the
growth of the solve API's counter `block_tridiag.launches
["tridiag_factor_lanes"]` (the lanes each factor call factored) over the
traced batches, over (batches x B).  Each QP's first factor and the
polish's rounds factor every lane; an adaptive-rho refactor only the
lanes that triggered.  A program without the counter, or a run off the
card, has nothing to read."""
UNIT = "factorizations"
LAYER = "solver loop (solver.scp, ops.blockqp._admm_loop_batched)"
MOVES = "solves_per_s"


def read(rec):
    lanes = rec["counts"].get("tridiag_factor_lanes", 0)
    if rec["mode"] != "batch" or not rec["units"] or lanes <= 0:
        return None
    return lanes / (rec["units"] * rec["batch"])
