"""Device operations (kernels, copies, fills) a batch in the traced
stretch: the work the host's Python glue dispatches, one launch each."""
UNIT = "ops"
LAYER = "host dispatch (the Python glue of ops.blockqp)"
MOVES = "solves_per_s"


def read(rec):
    if rec["mode"] != "batch" or not rec.get("device_ops") or not rec["units"]:
        return None
    return len(rec["device_ops"]) / rec["units"]
