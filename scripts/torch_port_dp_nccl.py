"""Data parallelism of the PyTorch/CUDA port over NCCL, one card per rank:
the CPU tests of tests/test_torch_port_dp_cli.py, run on a host with at
least 4 cards, where the placement rule gives every rank a card of its own
and the backend is NCCL (on one card the ranks share it over gloo instead).

- ``cli.main_qm9 --dp 0`` (every card: 4 ranks) against ``--dp 1``: the
  same losses and valid NLL (1e-5 relative), the same stability samples,
  the replicas bit-identical; then ``--resume`` under ``--dp 0``, the
  replicas bit-identical again.
- ``cli.main_geom_drugs --dp 2 --sp 2``: four ranks on four cards (data
  index r // 2, seq index r % 2), the replicas bit-identical.
- ``cli.eval_analyze --dp 2`` and ``--dp 4`` against ``--dp 1`` on the QM9
  run's checkpoint: the same molecules, bit for bit, and the NLLs within
  1e-5 relative (the packed NLL's totals are a host tensor summed over the
  ranks).

Small widths (nf=64, 2 layers, T=50): this checks the NCCL branch of the
ranks, not speed. Prints the card's name and power limit, then one JSON
line; exits 1 if a check fails.

    python3 scripts/torch_port_dp_nccl.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from geoldm_tpu_torch.cli import eval_analyze, main_geom_drugs, main_qm9  # noqa: E402
from geoldm_tpu_torch.data.datasets_config import get_dataset_info  # noqa: E402
from geoldm_tpu_torch.data.synthetic import (  # noqa: E402
    write_geom_conformers,
    write_qm9_splits,
)
from geoldm_tpu_torch.parallel import sharding  # noqa: E402

RTOL = 1e-5
CARDS = 4


def _check(ok, what, failures):
    if not ok:
        failures.append(what)
        print(f"FAIL: {what}", flush=True)


def _replicas(summary, n, what, failures, key="digest"):
    replicas = summary["replicas"]
    _check([r["rank"] for r in replicas] == list(range(n)), f"{what}: replica ranks", failures)
    _check(len({r[key] for r in replicas}) == 1, f"{what}: the replicas differ ({key})", failures)


def _qm9_argv(datadir, outdir, name):
    return ["--datadir", datadir, "--outdir", outdir, "--exp_name", name, "--train_diffusion",
            "--trainable_ae", "--nf", "64", "--n_layers", "2", "--diffusion_steps", "50",
            "--batch_size", "8", "--test_epochs", "1", "--n_stability_samples", "8",
            "--eval_n_steps", "10", "--ema_decay", "0.99", "--seed", "0", "--no_wandb"]


def main(argv=None) -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        print(f"torch_port_dp_nccl: needs {CARDS} NVIDIA cards", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()
    print(card[0], flush=True)
    rules = {n: sharding.placement(n, "cuda") for n in (2, CARDS)}
    failures, out, seconds = [], {}, {}
    for n, (_, backend, rule) in rules.items():
        _check(backend == "nccl", f"{n} ranks: {rule}", failures)
    with tempfile.TemporaryDirectory() as tmp:
        qm9_dir, runs = os.path.join(tmp, "qm9"), os.path.join(tmp, "runs")
        write_qm9_splits(qm9_dir, get_dataset_info("qm9"), {"train": 24, "valid": 16,
                                                             "test": 7}, seed=2)

        def timed(name, fn, *a):
            t0 = time.time()
            got = fn(*a)
            seconds[name] = round(time.time() - t0, 1)
            return got

        one = timed("main_qm9 --dp 1", main_qm9.main,
                    _qm9_argv(qm9_dir, runs, "one") + ["--n_epochs", "1", "--dp", "1"])
        dp = timed("main_qm9 --dp 0", main_qm9.main,
                   _qm9_argv(qm9_dir, runs, "dp") + ["--n_epochs", "1", "--dp", "0"])
        rel = float(np.max(np.abs(np.subtract(dp["losses"][0], one["losses"][0]))
                           / np.abs(one["losses"][0])))
        _check(rel <= RTOL, f"main_qm9: losses {dp['losses'][0]} vs {one['losses'][0]}",
               failures)
        nll_rel = abs(dp["nll_val"][0] - one["nll_val"][0]) / abs(one["nll_val"][0])
        _check(nll_rel <= RTOL, f"main_qm9: valid NLL {dp['nll_val']} vs {one['nll_val']}",
               failures)
        _check(dp["stability"] == one["stability"], "main_qm9: stability samples", failures)
        _replicas(dp, CARDS, "main_qm9 --dp 0", failures)
        resumed = timed("main_qm9 --dp 0 --resume", main_qm9.main, _qm9_argv(
            qm9_dir, runs, "dp") + ["--n_epochs", "2", "--start_epoch", "1", "--dp", "0",
                                    "--resume", os.path.join(runs, "dp")])
        _replicas(resumed, CARDS, "main_qm9 --resume", failures, "resumed_digest")
        _replicas(resumed, CARDS, "main_qm9 --resume", failures)
        out["main_qm9"] = {"losses_dp1": one["losses"][0], "losses_dp4": dp["losses"][0],
                           "loss_worst_rel": rel, "nll_val_rel": nll_rel,
                           "digest": dp["replicas"][0]["digest"][:16],
                           "resumed_losses": resumed["losses"][0]}

        geom_dir = os.path.join(tmp, "geom")
        write_geom_conformers(geom_dir, get_dataset_info("geom"), 20, seed=4,
                              sizes=[20, 25, 30, 28, 33, 22, 27])
        grid = timed("main_geom_drugs --dp 2 --sp 2", main_geom_drugs.main, [
            "--datadir", geom_dir, "--outdir", runs, "--exp_name", "grid", "--dp", "2",
            "--sp", "2", "--train_diffusion", "--trainable_ae", "--n_epochs", "1",
            "--test_epochs", "1", "--batch_size", "4", "--nf", "64", "--n_layers", "2",
            "--diffusion_steps", "50", "--n_stability_samples", "3", "--eval_n_steps", "10",
            "--ema_decay", "0.99", "--no_wandb"])
        _check(bool(np.all(np.isfinite(grid["losses"][0]))) and len(grid["losses"][0]) > 0,
               f"main_geom_drugs: losses {grid['losses'][0]}", failures)
        _replicas(grid, CARDS, "main_geom_drugs --dp 2 --sp 2", failures)
        out["main_geom_drugs"] = {"losses": grid["losses"][0], "nll_val": grid["nll_val"][0],
                                  "digest": grid["replicas"][0]["digest"][:16]}

        argv = ["--model_path", os.path.join(runs, "one"), "--datadir", qm9_dir, "--n_samples",
                "9", "--batch_size_gen", "2", "--n_steps", "10", "--batch_size_nll", "4",
                "--n_test_passes", "2"]
        ref = timed("eval_analyze --dp 1", eval_analyze.main, argv + ["--dp", "1"])
        out["eval_analyze"] = {}
        for d in (2, CARDS):
            got = timed(f"eval_analyze --dp {d}", eval_analyze.main, argv + ["--dp", str(d)])
            for k in ("one_hot", "x", "node_mask", "n_atoms"):
                _check(np.array_equal(got["molecules"][k], ref["molecules"][k]),
                       f"eval_analyze --dp {d}: molecules differ ({k})", failures)
            nlls = list(zip([got["nll_val"], *got["nll_tests"]],
                            [ref["nll_val"], *ref["nll_tests"]]))
            worst = max(abs(a - b) / abs(b) for a, b in nlls)
            _check(worst <= RTOL, f"eval_analyze --dp {d}: NLLs {nlls}", failures)
            out["eval_analyze"][f"dp{d}"] = {"nll_worst_rel": worst, "nlls": [a for a, _ in nlls]}
    print(json.dumps({"card": card[0], "cards": torch.cuda.device_count(),
                      "rules": {n: r[2] for n, r in rules.items()}, "seconds": seconds,
                      **out, "failures": failures, "ok": not failures}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
