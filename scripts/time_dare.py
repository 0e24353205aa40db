"""CUDA-event times of one checkout's dare_lqr kernel on the card.

    python3 scripts/time_dare.py [ROOT]

Times `ops/lqr_kernel.lqr_gain_batched` of the checkout at ROOT (default:
this one), through its own wrapper and its own kernel build, on the real
solo12_trot_n50 linearization of chip_smoke.py (128 scenarios, S = 6,400
(A, B) pairs, float32), at the main path's 2 steps and the stochastic
stage's 30: warm and with L2 flushed, with this checkout's chip_smoke.py
helpers.  Prints one JSON line.  To compare two trees, run it once for
each ROOT, in turns (parent, change, change, parent), in one call on one
card.
"""
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def main(root: pathlib.Path):
    sys.path.insert(0, str(root))   # the package under test comes first
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    card = smoke.phase_environment()
    lqr = smoke.lqr_kernel
    Q, R, A, B = smoke.dare_inputs(smoke.presets.SOLO12_TROT_N50)
    times = {}
    for n_iter in smoke.DARE_ITERS:
        def fn():
            return lqr.lqr_gain_batched(Q, R, A, B, n_iter)
        times[n_iter] = dict(ms=smoke.cuda_ms(fn), cold_ms=smoke.cold_ms(fn))
    print(json.dumps({"root": str(root), "package": lqr.__file__,
                      "card": card, "S": A.shape[0], "dare_lqr": times}))


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else HERE).resolve())
