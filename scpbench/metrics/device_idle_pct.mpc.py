"""Share of the traced stretch's wall time in which no device operation
ran (the union of the device ops' intervals left uncovered), in %."""
from scpbench import arith

UNIT = "%"
LAYER = "device"
MOVES = "tick_ms_p50"


def read(rec):
    if rec["mode"] != "mpc" or not rec.get("device_ops"):
        return None
    ivs = [(s, s + d) for _, s, d in rec["device_ops"]]
    return arith.idle_pct(ivs, rec["lo_ns"], rec["hi_ns"])
