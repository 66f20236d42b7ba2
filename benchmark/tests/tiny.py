"""Tiny runs of the benchmark's cells on the CPU: the cells' own workload
files and limits, at a width and a length a test can hold (the program's
plain PyTorch versions stand in for its kernels there)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402
from harness import core  # noqa: E402

SEED = 2**31 + 11  # past 32 signed bits


def spec(cell: str, seconds: float = 2.0, fault: str = "", trace: bool = False, seed=SEED):
    wl = core.workload(cell)
    cfg = dict(core.config(wl["config"]), nf=16, n_layers=2)
    wl = dict(wl, split_size=400, batch_size=8, molecules_per_call=24, n_steps=10,
              warmup_steps=2, check_molecules=4)
    return run.make_spec(cell, seed, seconds, trace, device="cpu", workload=wl, config=cfg,
                         fault=fault)


def result(cell: str, **kw) -> dict:
    s = spec(cell, **kw)
    return run.execute(s, core.cell_metrics(core.benchmark_spec(), cell))
