"""Where a train step of the PyTorch/CUDA port spends its time.

Builds the QM9 latent-diffusion model at the reference recipe (nf=256,
9 layers, latent_nf=1, T=1000, trainable_ae, EMA 0.9999) with random
weights (seeded torch.Generator) on one card and a batch of 64 synthetic
QM9-sized molecules padded to 29 atoms, times train steps on the host clock
around synchronised work, then traces a window of steps with torch.profiler
and gives device time per step by CUDA kernel name (the block kernels'
grids by name, everything else as "other"). A second trace does the same
for the block backward kernel alone at B=64, N=29, H=256. Prints one JSON
line.

    python3 scripts/torch_port_train_profile.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from geoldm_tpu_torch.config import EGNNConfig  # noqa: E402
from geoldm_tpu_torch.data.datasets_config import get_dataset_info  # noqa: E402
from geoldm_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from geoldm_tpu_torch.models import factory  # noqa: E402
from geoldm_tpu_torch.models.distributions import DistributionNodes  # noqa: E402
from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters  # noqa: E402
from geoldm_tpu_torch.ops import egnn_block  # noqa: E402
from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step  # noqa: E402
from geoldm_tpu_torch.train.trainer import prepare_batch  # noqa: E402

# Grids of the block kernels (csrc/*.cu), by kernel-name substring.
KERNELS = ("edge_bwd_kernel", "edge_kernel", "gemm_nt_kernel", "gemm_kernel",
           "splitk_reduce_kernel", "reduce_rows_kernel", "column_sum_kernel",
           "coord_grad_kernel", "rows_mask_kernel", "silu_kernel", "dsilu_mul_kernel")
STEPS, WARMUP, TRACED = 10, 3, 3


def _device_split(prof, n):
    """Device ms per repetition by kernel name over a traced window."""
    split = {k: 0.0 for k in KERNELS + ("other",)}
    for ev in prof.events():
        # Device-side events only; record_function ranges (Optimizer.step)
        # also appear on the device track, spanning their kernels: skip them.
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        key = next((k for k in KERNELS if k in ev.name), "other")
        split[key] += ev.time_range.elapsed_us() / 1e3 / n
    return {k: v for k, v in split.items() if v}


def _trace(fn, n):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    split = _device_split(prof, n)
    return wall, split


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    info = get_dataset_info("qm9")
    cfg = factory.make_latent_diffusion_config(info, nf=256, n_layers=9, latent_nf=1,
                                               diffusion_steps=1000, trainable_ae=True)
    model = factory.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, 1e-4, ema_decay=0.9999)
    step = make_train_step(cfg, 0.9999)
    raw = synthetic_batch(info, 64, 29, np.random.default_rng(0))
    batch = prepare_batch(raw, DistributionNodes(info.n_nodes), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(WARMUP):
        step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    traced_ms, split = _trace(lambda: step(state, batch, gen), TRACED)
    device_ms = sum(split.values())
    train = {"B": 64, "N": 29, "step_ms": step_ms, "traced_step_ms": traced_ms,
             "device_ms_per_step": device_ms, "split_ms_per_step": split,
             "device_busy_share": device_ms / traced_ms}
    print(f"train step B=64 N=29: {step_ms:.2f} ms, device {device_ms:.2f} ms/step "
          f"{json.dumps(split)} on {card}", flush=True)

    bcfg = EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=256, n_layers=9)
    block = EquivariantBlock(bcfg)
    init_parameters(block, torch.Generator().manual_seed(1))
    block = block.cuda()
    rng = np.random.default_rng(2)
    n_real = rng.integers(21, 30, size=64)
    mask = (np.arange(29)[None, :] < n_real[:, None]).astype(np.float32)[..., None]
    args = [torch.from_numpy(a).cuda() for a in (
        rng.standard_normal((64, 29, 256)).astype(np.float32) * mask,
        rng.standard_normal((64, 29, 3)).astype(np.float32) * mask,
        rng.standard_normal((64, 29, 3)).astype(np.float32) * mask, mask,
        rng.standard_normal((64, 29, 256)).astype(np.float32),
        rng.standard_normal((64, 29, 3)).astype(np.float32))]
    for _ in range(3):
        egnn_block.block_backward_cuda(block, *args)
    bwd_ms, bwd_split = _trace(lambda: egnn_block.block_backward_cuda(block, *args), 10)
    bwd = {"B": 64, "N": 29, "H": 256, "traced_ms": bwd_ms, "split_ms": bwd_split,
           "device_ms": sum(bwd_split.values())}
    print(f"block backward B=64 N=29 H=256: device {bwd['device_ms']:.3f} ms "
          f"{json.dumps(bwd_split)} on {card}", flush=True)
    print(json.dumps({"card": card, "train": train, "block_backward": bwd}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
