"""SASS instruction counts of the port's compiled kernels.

    python3 scripts/sass_stats.py [substring ...]

Builds the kernel library if needed (nvcc, on a machine with the CUDA
toolkit), disassembles it with cuobjdump and prints, for each kernel whose
name contains one of the substrings (default: every kernel), its count of
SASS instructions and its most frequent opcodes.  A kernel whose time is
one warp's latency is read against this count.
"""
import collections
import os
import pathlib
import re
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from centroidal_mpc_tpu_torch.ops import cuda_lib  # noqa: E402

INSTR = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def main(patterns):
    path, _ = cuda_lib.build()
    cuobjdump = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.splitlines()[0].strip()
        if patterns and not any(p in name for p in patterns):
            continue
        ops = [op.split(".")[0] for op in INSTR.findall(block)]
        top = ", ".join(f"{op} {n}" for op, n in
                        collections.Counter(ops).most_common(12))
        print(f"{name}\n  {len(ops)} instructions: {top}")


if __name__ == "__main__":
    main(sys.argv[1:])
