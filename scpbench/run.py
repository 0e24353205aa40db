"""Run one cell of the benchmark once on this machine's card.

    python3 scpbench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

Prints one JSON line last on standard output (the result), and the
numbers the check compared, each beside its limit, last on standard
error.  Exits non-zero, printing no result, without a card (or with
fewer than the cell asks for), without the program beside it, or when a
JAX module was loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from scpbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
