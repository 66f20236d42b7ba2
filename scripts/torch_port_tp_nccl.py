"""Tensor parallelism of the PyTorch/CUDA port over NCCL, one card per rank:
the CPU tests of tests/test_torch_port_tp_cli.py, run on a host with at
least 4 cards, where the placement rule gives every rank a card of its own
and the backend is NCCL (on one card the ranks share it over gloo instead).

- ``cli.main_qm9 --tp 2`` and ``--dp 2 --tp 2`` against ``--tp 1`` (and
  ``--dp 2``): the same losses and valid NLL (1e-5 relative), the same
  stability samples, the gathered states bit-identical on every rank, the
  shards equal on the ranks of one model index;
- the ``--tp 2`` checkpoint resumed under ``--tp 1`` and the ``--tp 1`` one
  under ``--dp 2 --tp 2``, each loaded state equal to its ``latest/`` files
  tensor for tensor;
- ``cli.main_geom_drugs --dp 2 --tp 2``: four ranks on four cards, the
  replicas bit-identical.

Small widths (nf=64, 2 layers, T=50): this checks the NCCL branch of the
model ranks (the shards' all_gather into a card's buffer, the norm's
all-reduce), not speed. Prints the card's name and power limit, then one
JSON line; exits 1 if a check fails.

    python3 scripts/torch_port_tp_nccl.py
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

from geoldm_tpu_torch.cli import main_geom_drugs, main_qm9  # noqa: E402
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


def _replicas(summary, n, tp, what, failures):
    replicas = summary["replicas"]
    _check([r["rank"] for r in replicas] == list(range(n)), f"{what}: replica ranks", failures)
    _check(len({r["digest"] for r in replicas}) == 1, f"{what}: the gathered states differ",
           failures)
    shard = [r["shard_digest"] for r in replicas]
    _check(all(shard[i] == shard[i % tp] for i in range(n)) and len(set(shard[:tp])) == tp,
           f"{what}: shard digests {[s[:8] for s in shard]}", failures)


def _equal_files(snapshot, path):
    """The state a run resumed equals the files it resumed from."""
    load = lambda name: torch.load(os.path.join(path, name), map_location="cpu",  # noqa: E731
                                   weights_only=True)
    ok = True
    for key, name in (("model", "generative_model.npy"), ("ema", "generative_model_ema.npy")):
        want = load(name)
        ok &= set(snapshot[key]) == set(want) and all(torch.equal(snapshot[key][k], want[k])
                                                      for k in want)
    want = load("optim.npy")["state"]
    got = snapshot["optim"]["state"]
    ok &= got.keys() == want.keys() and all(
        torch.equal(torch.as_tensor(got[i][k]).cpu(), torch.as_tensor(v))
        for i, e in want.items() for k, v in e.items())
    return bool(ok)


def _qm9_argv(datadir, outdir, name):
    return ["--datadir", datadir, "--outdir", outdir, "--exp_name", name, "--train_diffusion",
            "--trainable_ae", "--nf", "64", "--n_layers", "2", "--diffusion_steps", "50",
            "--batch_size", "8", "--test_epochs", "1", "--n_stability_samples", "8",
            "--eval_n_steps", "10", "--ema_decay", "0.99", "--seed", "0", "--no_wandb"]


def main(argv=None) -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        print(f"torch_port_tp_nccl: needs {CARDS} NVIDIA cards", file=sys.stderr)
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

        def same(got, ref, what):
            rel = float(np.max(np.abs(np.subtract(got["losses"][0], ref["losses"][0]))
                               / np.abs(ref["losses"][0])))
            _check(rel <= RTOL, f"{what}: losses {got['losses'][0]} vs {ref['losses'][0]}",
                   failures)
            nll = abs(got["nll_val"][0] - ref["nll_val"][0]) / abs(ref["nll_val"][0])
            _check(nll <= RTOL, f"{what}: valid NLL {got['nll_val']} vs {ref['nll_val']}",
                   failures)
            _check(got["stability"] == ref["stability"], f"{what}: stability samples", failures)
            return {"loss_worst_rel": rel, "nll_val_rel": nll,
                    "digest": got["replicas"][0]["digest"][:16]}

        one_epoch = ["--n_epochs", "1"]
        one = timed("main_qm9 --dp 1 --tp 1", main_qm9.main,
                    _qm9_argv(qm9_dir, runs, "one") + one_epoch + ["--dp", "1"])
        dp = timed("main_qm9 --dp 2", main_qm9.main,
                   _qm9_argv(qm9_dir, runs, "dp") + one_epoch + ["--dp", "2"])
        tp = timed("main_qm9 --dp 1 --tp 2", main_qm9.main,
                   _qm9_argv(qm9_dir, runs, "tp") + one_epoch + ["--dp", "1", "--tp", "2"])
        grid = timed("main_qm9 --dp 2 --tp 2", main_qm9.main,
                     _qm9_argv(qm9_dir, runs, "grid") + one_epoch + ["--dp", "2", "--tp", "2"])
        _replicas(tp, 2, 2, "main_qm9 --tp 2", failures)
        _replicas(grid, CARDS, 2, "main_qm9 --dp 2 --tp 2", failures)
        out["main_qm9"] = {"tp2_vs_tp1": same(tp, one, "main_qm9 --tp 2"),
                           "dp2_tp2_vs_dp2": same(grid, dp, "main_qm9 --dp 2 --tp 2"),
                           "state_elements": [r["state_elements"] for r in tp["replicas"]]}
        resumed = {}
        for src, flags in (("tp", ["--dp", "1", "--tp", "1"]), ("one", ["--dp", "2", "--tp",
                                                                         "2"])):
            got = timed(f"main_qm9 --resume {src} {' '.join(flags)}", main_qm9.main,
                        _qm9_argv(qm9_dir, runs, f"{src}_resumed") + [
                            "--n_epochs", "2", "--start_epoch", "1", "--resume",
                            os.path.join(runs, src), *flags])
            ok = _equal_files(got["resumed"], os.path.join(runs, src, "latest"))
            _check(ok, f"--resume of {src} under {flags}: loaded state differs", failures)
            if "replicas" in got:
                _replicas(got, CARDS, 2, f"--resume of {src}", failures)
            resumed[src] = {"flags": flags, "loaded_equal": ok, "losses": got["losses"][0]}
        out["resume"] = resumed

        geom_dir = os.path.join(tmp, "geom")
        write_geom_conformers(geom_dir, get_dataset_info("geom"), 20, seed=4,
                              sizes=[20, 25, 30, 28, 33, 22, 27])
        geom = timed("main_geom_drugs --dp 2 --tp 2", main_geom_drugs.main, [
            "--datadir", geom_dir, "--outdir", runs, "--exp_name", "geom", "--dp", "2",
            "--tp", "2", "--train_diffusion", "--trainable_ae", "--n_epochs", "1",
            "--test_epochs", "1", "--batch_size", "4", "--nf", "64", "--n_layers", "2",
            "--diffusion_steps", "50", "--n_stability_samples", "3", "--eval_n_steps", "10",
            "--ema_decay", "0.99", "--no_wandb"])
        _check(bool(np.all(np.isfinite(geom["losses"][0]))) and len(geom["losses"][0]) > 0,
               f"main_geom_drugs: losses {geom['losses'][0]}", failures)
        _replicas(geom, CARDS, 2, "main_geom_drugs --dp 2 --tp 2", failures)
        out["main_geom_drugs"] = {"losses": geom["losses"][0], "nll_val": geom["nll_val"][0],
                                  "digest": geom["replicas"][0]["digest"][:16]}
    print(json.dumps({"card": card[0], "cards": torch.cuda.device_count(),
                      "rules": {n: r[2] for n, r in rules.items()}, "seconds": seconds,
                      **out, "failures": failures, "ok": not failures}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
