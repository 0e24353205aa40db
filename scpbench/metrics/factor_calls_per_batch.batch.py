"""Factorizations of the ADMM matrix a batch in the traced stretch: the
growth of the solve API's counter `block_tridiag.launches
["tridiag_factor"]` over the traced batches, the first factor, every
adaptive-rho refactor (of the lanes that triggered, gathered) and the
polish's rounds.  Counted on the card only; elsewhere nothing to read."""
UNIT = "calls"
LAYER = "solver loop (solver.scp, ops.blockqp._admm_loop_batched)"
MOVES = "solves_per_s"


def read(rec):
    calls = rec["counts"].get("tridiag_factor", 0)
    if rec["mode"] != "batch" or not rec["units"] or calls <= 0:
        return None
    return calls / rec["units"]
