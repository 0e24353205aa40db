"""Device operations (kernels, copies, fills) a tick in the traced
stretch: the work the host's Python glue dispatches, one launch each."""
UNIT = "ops"
LAYER = "host dispatch (the Python glue of ops.blockqp)"
MOVES = "tick_ms_p50"


def read(rec):
    if rec["mode"] != "mpc" or not rec.get("device_ops") or not rec["units"]:
        return None
    return len(rec["device_ops"]) / rec["units"]
