"""Time the whole-molecule EquivariantBlock kernels (#1 forward, #2 backward)
of this checkout against another checkout's, on one NVIDIA card.

    python3 scripts/torch_port_block_ab.py --other <checkout>

Each tree runs in its own interpreter, with its own package and kernel
build, in turns: other, this, this, other. A run times, with CUDA events
over 20 calls after 3 warm-ups on 4 cycled seeded inputs, at H=256 with
attention (the recipes' blocks): the forward kernel and the backward kernel
(``block_backward_cuda``, which recomputes the forward) at B=64, N=16, 24,
29, 32 (QM9's pads), B=32, N=48, 64 (GEOM's), one 'mean' (N=32) and one
sin-embedding (N=24) case; a block's training route (``block_forward``
under grad, then its backward) at the same shapes; and, on the host clock
around synchronised steps, one recipe train step at QM9 pad 29 (B=64, 9
layers) and GEOM pad 48 (B=32, 4 layers), with the peak device memory of
those steps. Prints one JSON line with both trees' numbers per turn, the
card's name and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# (case, N, B, config overrides)
SHAPES = [("sum", 16, 64, {}), ("sum", 24, 64, {}), ("sum", 29, 64, {}), ("sum", 32, 64, {}),
          ("sum", 48, 32, {}), ("sum", 64, 32, {}), ("mean", 32, 64, {"aggregation_method": "mean"}),
          ("sin", 24, 64, {"sin_embedding": True})]


def _time_ms(fn, inputs, warmup=3, reps=20):
    import torch

    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _train_step_ms(dataset, steps=5, warmup=3):
    """(host-clock ms per recipe train step on one synthetic batch, peak
    device MiB over those steps with the model and its train state
    resident)."""
    import numpy as np
    import torch

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import synthetic_batch
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step
    from geoldm_tpu_torch.train.trainer import prepare_batch

    info = get_dataset_info(dataset)
    rng = np.random.default_rng(0)
    if dataset == "qm9":
        cfg = factory.make_latent_diffusion_config(info, nf=256, n_layers=9, latent_nf=1,
                                                   diffusion_steps=1000, trainable_ae=True)
        raw = synthetic_batch(info, 64, 29, rng)
    else:
        cfg = factory.make_latent_diffusion_config(info, nf=256, n_layers=4, latent_nf=2,
                                                   include_charges=False, diffusion_steps=1000,
                                                   trainable_ae=True)
        hist = sorted(dict(info.n_nodes_histogram))
        sizes = rng.choice([k for k in hist if 33 <= k <= 48], size=32)
        raw = synthetic_batch(info, 32, 48, rng, include_charges=False, n_atoms=sizes)
    model = factory.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, 1e-4, ema_decay=0.9999)
    step = make_train_step(cfg, 0.9999)
    batch = prepare_batch(raw, DistributionNodes(info.n_nodes), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(warmup):
        step(state, batch, gen)
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, torch.cuda.max_memory_allocated() / 2**20


def _dump(root: str) -> dict:
    """Times of ``root``'s kernels and train steps."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from geoldm_tpu_torch.config import EGNNConfig
    from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters
    from geoldm_tpu_torch.ops import egnn_block

    assert egnn_block.__file__.startswith(os.path.abspath(root)), egnn_block.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"shapes": []}
    for case, n, b, extra in SHAPES:
        cfg = EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=256, n_layers=9, attention=True,
                         normalization_factor=1.0, **extra)
        block = EquivariantBlock(cfg)
        init_parameters(block, torch.Generator().manual_seed(n))
        block = block.to(dev)
        inputs = []
        for rep in range(4):
            rng = np.random.default_rng(1000 * n + rep)
            n_real = rng.integers(max(1, n - 8), n + 1, size=b)
            mask = (np.arange(n)[None, :] < n_real[:, None]).astype(np.float32)[..., None]
            arrs = [rng.standard_normal((b, n, 256)).astype(np.float32) * mask,
                    rng.standard_normal((b, n, 3)).astype(np.float32) * mask,
                    rng.standard_normal((b, n, 3)).astype(np.float32) * mask, mask,
                    rng.standard_normal((b, n, 256)).astype(np.float32),
                    rng.standard_normal((b, n, 3)).astype(np.float32)]
            inputs.append([torch.from_numpy(a).to(dev) for a in arrs])

        def fwd(h, x, x0, m, gh, gx):
            with torch.no_grad():
                egnn_block.block_forward_cuda(block, h, x, x0, m)

        def bwd(h, x, x0, m, gh, gx):
            egnn_block.block_backward_cuda(block, h, x, x0, m, gh, gx)

        def train(h, x, x0, m, gh, gx):
            h = h.detach().requires_grad_()
            h_out, x_out = egnn_block.block_forward(block, h, x, x0, m)
            torch.autograd.backward((h_out, x_out), (gh, gx))

        out["shapes"].append({"case": case, "N": n, "B": b, "fwd_ms": _time_ms(fwd, inputs),
                              "bwd_ms": _time_ms(bwd, inputs),
                              "train_fwd_bwd_ms": _time_ms(train, inputs)})
        del block, inputs
    torch.cuda.empty_cache()
    out["qm9_step_ms"], out["qm9_peak_mib"] = _train_step_ms("qm9")
    out["geom48_step_ms"], out["geom48_peak_mib"] = _train_step_ms("geom")
    out["card"] = torch.cuda.get_device_name(0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", required=True, help="root of the other checkout")
    p.add_argument("--dump", help=argparse.SUPPRESS)  # internal: one tree's times
    args = p.parse_args(argv)
    if args.dump:
        print(json.dumps(_dump(args.dump)))
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(args.other)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    runs = {"this": [], "other": []}
    for label, root in (("other", other), ("this", here), ("this", here), ("other", other)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--other", "-",
                               "--dump", root], stdout=subprocess.PIPE, text=True)
        if proc.returncode != 0:
            print(f"block_ab: the run of {root} failed", file=sys.stderr)
            return 1
        runs[label].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"nvidia_smi": card, "this": here, "other": other, "turns":
                      "other, this, this, other", "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
