"""Run one cell of the benchmark once and print its result as the last line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads and warms up the cell (set-up), measures for ``--seconds`` (the
end-to-end metrics; with ``--trace 1`` the per-layer metrics from a traced
stretch of the window instead), then checks what the timed path produced
against the plain reference in ``benchmark/reference/`` and prints each
compared number beside its limit. Needs as many CUDA cards as the cell asks
for; exits with another code than 0, and prints no result, without them or
when a JAX module is loaded.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
# The program's CUDA libraries are built once into its own directory inside
# the checkout; keep any other compiler cache there too, at a fixed path.
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".cache", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, ".cache", "torch_extensions"))

from harness import core  # noqa: E402
from harness.spec import RunSpec  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def make_spec(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
              start_wall: float = None, workload=None, config=None,
              fault: str = "") -> RunSpec:
    wl = workload or core.workload(cell)
    cfg = config or core.config(wl["config"])
    return RunSpec(cell=cell, workload=wl, config=cfg, seed=seed, seconds=seconds,
                   trace=trace, device=device,
                   start_wall=start_wall if start_wall is not None else time.time(),
                   limits=dict(wl["check"]), fault=fault)


def execute(spec: RunSpec, metrics) -> dict:
    """Run the cell's driver -> the result object."""
    out = core.driver(spec.workload["driver"]).run(spec)
    print(f"end-to-end readings: {json.dumps(out.e2e)}", file=sys.stderr)
    core.print_checks(out.checks)
    return core.result_line(out, metrics, spec.trace)


def main(argv=None) -> int:
    args = parse_args(argv)
    start = core.process_start_wall()
    bad = core.forbidden_modules()
    if bad:
        print(f"refusing to run: JAX modules loaded: {bad}", file=sys.stderr)
        return 3
    spec_json = core.benchmark_spec()
    cells = {w["name"]: w for w in spec_json["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    wl = core.workload(args.workload)
    import torch

    need = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    spec = make_spec(args.workload, args.seed, args.seconds, bool(args.trace),
                     start_wall=start, workload=wl)
    line = execute(spec, core.cell_metrics(spec_json, args.workload))
    bad = core.forbidden_modules()
    if bad:
        print(f"JAX modules were loaded during the run: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
