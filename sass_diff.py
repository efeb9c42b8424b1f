#!/usr/bin/env python3
"""Which kernels two checkouts compile differently: `cuobjdump -sass` of
each checkout's kernel library, compared function by function.

    python3 sass_diff.py OTHER_CHECKOUT [CHECKOUT]   # CHECKOUT: "."

Builds each checkout's library as the package builds it
(omega_tpu_torch/ops/_build.py, one nvcc per source, reused when the
sources have not changed), splits the disassembly at its `Function :`
headers and prints one JSON line: the functions whose SASS is the same in
both, those whose SASS differs, and those only one side has (mangled
names). Needs nvcc and cuobjdump (the CUDA toolkit); imports nothing of
JAX and runs no kernel.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path


def library(tree: Path) -> Path:
    out = subprocess.run(
        [sys.executable, "-c",
         "from omega_tpu_torch.ops import _build; print(_build.build())"],
        cwd=tree, capture_output=True, text=True, timeout=1200, check=True)
    return Path(out.stdout.strip().splitlines()[-1])


def functions(lib: Path) -> dict:
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = body.strip()
    return out


def main(argv):
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [Path(a).resolve() for a in (argv + ["."])[:2]]
    a, b = (functions(library(t)) for t in trees)
    print(json.dumps({
        "checkouts": [os.fspath(t) for t in trees],
        "same": sorted(n for n in a if n in b and a[n] == b[n]),
        "differ": sorted(n for n in a if n in b and a[n] != b[n]),
        "only_first": sorted(set(a) - set(b)),
        "only_second": sorted(set(b) - set(a))}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
