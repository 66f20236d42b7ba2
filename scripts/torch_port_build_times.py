"""Time the nvcc build of the port's kernel libraries, this checkout's and
optionally another's, on the machine with the CUDA toolkit.

    python3 scripts/torch_port_build_times.py [--other <checkout>]

For each tree: every source of ``ops/cuda_build.SOURCES`` compiled with
``cuda_build.NVCC_FLAGS`` into a scratch directory, first all at once (as
the port builds them at first use; the wall time is what ``chip_smoke.py``
phase 1 waits for), then one at a time. Prints one JSON line of seconds per
library.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from geoldm_tpu_torch.ops import cuda_build  # noqa: E402


def _compile(csrc: str, name: str, out_dir: str) -> float:
    t0 = time.perf_counter()
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", csrc, "-o",
                           os.path.join(out_dir, f"{name}.so"), os.path.join(csrc, f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc}/{name}.cu:\n{proc.stderr[-4000:]}")
    return time.perf_counter() - t0


def _times(root: str) -> dict:
    csrc = os.path.join(root, "geoldm_tpu_torch", "csrc")
    names = list(cuda_build.SOURCES)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(names)) as pool:
            together = dict(zip(names, pool.map(lambda n: _compile(csrc, n, out), names)))
        wall = time.perf_counter() - t0
        alone = {n: _compile(csrc, n, out) for n in names}
    return {"parallel_wall_s": wall, "parallel_s": together, "alone_s": alone}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", help="root of another checkout to time the same way")
    args = p.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {"this": _times(here)}
    if args.other:
        out["other"] = _times(os.path.abspath(args.other))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
