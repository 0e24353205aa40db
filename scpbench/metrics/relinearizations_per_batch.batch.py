"""Linearizations of the SCP loop a batch in the traced stretch: the
growth of `lqr_kernel.launches["dare_lqr"]` over the traced batches,
over their number.  Each linearization runs one DARE launch, so a
frozen linearization reads 1 and a re-linearizing loop one a pass.
Counted on the card only; elsewhere nothing to read."""
UNIT = "calls"
LAYER = "solver loop (solver.scp re-linearization)"
MOVES = "solves_per_s"


def read(rec):
    calls = rec["counts"].get("dare_lqr", 0)
    if rec["mode"] != "batch" or not rec["units"] or calls <= 0:
        return None
    return calls / rec["units"]
