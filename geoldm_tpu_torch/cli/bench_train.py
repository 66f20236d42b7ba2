"""Train-step throughput of the QM9 latent-diffusion recipe (port of
``geoldm_tpu/cli/bench_train.py``).

Times the whole train step (loss, backward through the block kernels,
adaptive clip, AMSGrad, EMA) on one synthetic QM9-shaped batch, reading the
loss back after each step as JAX's does, so every step is synchronised.
Prints one JSON line with JAX's keys:

  {"metric": "qm9_train_steps_per_sec", "value": ..., "unit": "steps/s",
   "molecules_per_sec": ...}

  python -m geoldm_tpu_torch.cli.bench_train --batch_size 64 --reps 20 \\
      [--compute_dtype bfloat16] [--device cpu]

``--compute_dtype`` takes the training CLIs' names (float32 / pallas: the
f32 kernels, bfloat16 / bfloat16_pallas: their bf16 variants). ``--remat``
is accepted and has no effect, as in the training CLIs: the port's backward
always recomputes each block.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> dict:
    """Run; returns the printed line's keys plus ``seconds`` (the timed
    reps), ``reps``, ``first_step_s``, ``device`` (the card's name or
    "cpu") and ``model_cfg``."""
    p = argparse.ArgumentParser(description="geoldm-tpu-torch train-step benchmark")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--pad_nodes", type=int, default=32)
    p.add_argument("--nf", type=int, default=256)
    p.add_argument("--n_layers", type=int, default=9)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16", "pallas", "bfloat16_pallas"])
    p.add_argument("--remat", type=eval, default=False,
                   help="JAX-side option; no effect in the port")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu, which runs the plain PyTorch path")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import synthetic_batch
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step
    from geoldm_tpu_torch.train.trainer import prepare_batch

    info = get_dataset_info("qm9")
    cfg = factory.make_latent_diffusion_config(info, nf=args.nf, n_layers=args.n_layers,
                                               latent_nf=1, diffusion_steps=1000,
                                               trainable_ae=True)
    model = factory.build_model(cfg, args.device, torch.Generator().manual_seed(0))
    device = next(model.parameters()).device
    ema_decay = 0.9999
    state = create_train_state(model, cfg, lr=1e-4, ema_decay=ema_decay)
    step = make_train_step(cfg, ema_decay, args.compute_dtype)
    raw = synthetic_batch(info, args.batch_size, pad_nodes=args.pad_nodes,
                          rng=np.random.default_rng(0))
    batch = prepare_batch(raw, DistributionNodes(info.n_nodes), device)
    noise = torch.Generator(device=device).manual_seed(1)

    t0 = time.perf_counter()
    float(step(state, batch, noise)["loss"])
    first = time.perf_counter() - t0
    print(f"# build + first step: {first:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    for _ in range(args.reps):
        float(step(state, batch, noise)["loss"])
    elapsed = time.perf_counter() - t0

    steps_per_sec = args.reps / elapsed
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"# {args.reps} steps in {elapsed:.2f}s on {name} (batch {args.batch_size}, pad "
          f"{args.pad_nodes}, dtype {args.compute_dtype}, remat {args.remat})",
          file=sys.stderr)
    line = {"metric": "qm9_train_steps_per_sec", "value": round(steps_per_sec, 3),
            "unit": "steps/s", "molecules_per_sec": round(steps_per_sec * args.batch_size, 1)}
    print(json.dumps(line), flush=True)
    return {**line, "seconds": elapsed, "reps": args.reps, "first_step_s": first,
            "device": name, "model_cfg": cfg}


if __name__ == "__main__":
    main()
