"""Sampling throughput of the port's HTTP server at real request sizes.

Starts ``geoldm_tpu_torch.cli.serve`` in this process, twice per recipe: with
its default ``--compute_dtype bfloat16_mixed`` and with ``float32``, both at
the default ``--batch_max`` (250 molecules a dispatch). The recipes: QM9
(nf=256, 9 layers, latent_nf=1) and GEOM-Drugs (nf=256, 4 layers,
latent_nf=2, no charges), T=1000, random weights from a seeded
``torch.Generator``. Each request asks for the same molecule sizes on both
servers, drawn from the dataset's size histogram with a fixed seed:
DDIM with K=50 jumps (eta 0), DPM-Solver++(2M) with K=20, and the dense
T-step sampler. The few-step requests run in turns (bf16-mixed, f32, f32,
bf16-mixed), the dense ones once each, after one small warm-up request per
server. Times are the client's wall clock around each request.

Prints the card's name and power limit, one JSON line per request
(seconds, mol/s, the chunks' pads, kernel launches by name) and a last JSON
line with the best mol/s of each (dataset, sampler, precision); ``--out``
also writes every line to a file.

    python3 scripts/torch_port_serve_throughput.py [--out serve_throughput.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from geoldm_tpu_torch.cli import serve  # noqa: E402
from geoldm_tpu_torch.data.datasets_config import get_dataset_info  # noqa: E402
from geoldm_tpu_torch.models import factory  # noqa: E402
from geoldm_tpu_torch.models.distributions import DistributionNodes  # noqa: E402
from geoldm_tpu_torch.ops import kernel_launches, reset_kernel_launches  # noqa: E402
from geoldm_tpu_torch.train.sampling import chunk_pads  # noqa: E402
from geoldm_tpu_torch.utils.convert import save_reference_checkpoint  # noqa: E402

RECIPES = {
    "qm9": dict(nf=256, n_layers=9, latent_nf=1),
    "geom": dict(nf=256, n_layers=4, latent_nf=2, include_charges=False,
                 normalization_factor=1.0),
}
DTYPES = ("bfloat16_mixed", "float32")
MOLECULES = {"qm9": 500, "geom": 128}
FEW_STEP = (("ddim50", {"n_steps": 50, "eta": 0.0}),
            ("dpm2m20", {"n_steps": 20, "sampler": "dpm2m"}))


def _post(base, body):
    req = urllib.request.Request(base + "/sample", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=3600) as resp:
        return json.loads(resp.read())


def _start(model_dir, dataset, dtype):
    server, service = serve.main(["--model_path", model_dir, "--dataset", dataset, "--port", "0",
                                  "--compute_dtype", dtype], serve_forever=False)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, service, f"http://127.0.0.1:{server.server_address[1]}"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    lines, best = [], {}
    for dataset, n_mol in MOLECULES.items():
        info = get_dataset_info(dataset)
        cfg = factory.make_latent_diffusion_config(info, diffusion_steps=1000, **RECIPES[dataset])
        tmp = tempfile.TemporaryDirectory()
        model = factory.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
        save_reference_checkpoint(model, tmp.name, dataset=dataset)
        del model
        servers = {dt: _start(tmp.name, dataset, dt) for dt in DTYPES}
        sizes = DistributionNodes(info.n_nodes).sample(n_mol, np.random.default_rng(7))
        service = servers[DTYPES[0]][1]
        pads = chunk_pads(sizes, service.args.batch_max, service.buckets)
        try:
            for dt in DTYPES:
                _post(servers[dt][2], {"sizes": [int(s) for s in sizes[:2]], "seed": 1,
                                       "n_steps": 2})
            order = [(name, body, dt) for name, body in FEW_STEP
                     for dt in (DTYPES[0], DTYPES[1], DTYPES[1], DTYPES[0])]
            order += [("dense", {}, dt) for dt in DTYPES]
            for name, settings, dt in order:
                body = {"sizes": [int(s) for s in sizes], "seed": 3, **settings}
                reset_kernel_launches()
                t0 = time.perf_counter()
                resp = _post(servers[dt][2], body)
                sec = time.perf_counter() - t0
                if resp.get("n") != n_mol:
                    raise RuntimeError(f"{dataset} {name} {dt}: {resp.get('error', resp.keys())}")
                row = {"dataset": dataset, "sampler": name, "compute_dtype": dt,
                       "molecules": n_mol, "seconds": sec, "mol_per_s": n_mol / sec,
                       "server_seconds": resp["seconds"], "chunk_pads": pads,
                       "launches": {k: v for k, v in kernel_launches().items() if v},
                       "ran": resp["sampler"], "card": card}
                lines.append(row)
                key = f"{dataset} {name} {dt}"
                best[key] = max(best.get(key, 0.0), row["mol_per_s"])
                print(json.dumps(row), flush=True)
        finally:
            for server, _, _ in servers.values():
                server.shutdown()
                server.server_close()
            tmp.cleanup()
    summary = {"best_mol_per_s": best, "card": card}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for row in lines + [summary]:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
