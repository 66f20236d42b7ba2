"""The readings the check's limits are set from: the compared numbers of a
cell's sound runs over many seeds, of its control (the reference, in the
next precision below the cell's, in the program's place) and of planted
faults, each at the cell's own size, the set-up and the check as a run
makes them (a short window). One process (one set of ranks) per call:

    python benchmark/tools/readings.py --workload qm9_train --seeds 1 2 3 \\
        --fault control --seconds 1

Prints one JSON line per run: the fault, the seed and every number read.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import run  # noqa: E402
from harness import core  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--detail", default="", help="a directory for each run's check terms")
    p.add_argument("--nf", type=int, default=0, help="a narrower width, for a rehearsal on the CPU")
    a = p.parse_args()
    wl = core.workload(a.workload)
    cfg = core.config(wl["config"])
    if a.nf:
        cfg = dict(cfg, nf=a.nf, n_layers=2)
        wl = dict(wl, split_size=400, batch_size=wl["batch_size"] // 4,
                  molecules_per_call=24, n_steps=10, warmup_steps=2, check_molecules=4)
    spec = run.make_spec(a.workload, a.seeds[0], a.seconds, False, device=a.device,
                         workload=wl, config=cfg, fault=a.fault)
    drv = core.driver(wl["driver"])
    if wl["driver"] == "train_loop":
        spec.extra = {"seeds": a.seeds}
        outs = drv.run(spec)
    else:
        outs = []
        for seed in a.seeds:
            spec.seed = seed
            outs.append(drv.run(spec))
    for seed, out in zip(a.seeds, outs):
        if a.detail and out.detail is not None:
            import torch

            os.makedirs(a.detail, exist_ok=True)
            torch.save(out.detail, os.path.join(
                a.detail, f"{a.workload}_{a.fault or 'sound'}_{seed}.pt"))
        print(json.dumps({"workload": a.workload, "fault": a.fault or "sound", "seed": seed,
                          "numbers": out.numbers, "e2e": out.e2e}), flush=True)


if __name__ == "__main__":
    main()
