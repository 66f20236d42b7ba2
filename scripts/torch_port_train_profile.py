"""Where a train step of the PyTorch/CUDA port spends its time.

QM9 (default): builds the QM9 latent-diffusion model at the reference recipe
(nf=256, 9 layers, latent_nf=1, T=1000, trainable_ae, EMA 0.9999) with
random weights (seeded torch.Generator) on one card and a batch of 64
synthetic QM9-sized molecules padded to 29 atoms, times train steps on the
host clock around synchronised work, then traces a window of steps with
torch.profiler and gives device time per step by CUDA kernel name (the
block kernels' grids by name, everything else as "other"). A second trace
does the same for the block backward kernel alone at B=64, N=29, H=256.

GEOM (``--dataset geom``): the same for the GEOM recipe (nf=256, 4 layers,
latent_nf=2, no charges, T=1000, trainable_ae, EMA 0.9999) on B=32
synthetic molecules at the training pads 184 (129-181 atoms) and 104 (81-104
atoms), both on the row-tiled kernels #3-#5, and 48 (33-48 atoms, kernels
#1-#2), then the row-tiled stage backwards (#5) alone at B=32, N=184,
H=256: the GCL stage as a direct call and from the node chain its forward
kept (the training route), and the coordinate stage.

``--compute_dtype`` (the training CLIs' choices) runs the train steps and the
backward kernels in it: ``bfloat16`` / ``bfloat16_pallas`` on the bf16
kernels (#1/#2, #3-#5 bf16).

Prints one JSON line.

    python3 scripts/torch_port_train_profile.py [--dataset geom] [--compute_dtype bfloat16]
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
from geoldm_tpu_torch.nn.core import resolve_compute  # noqa: E402
from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters  # noqa: E402
from geoldm_tpu_torch.ops import egnn_block, egnn_tiled  # noqa: E402
from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step  # noqa: E402
from geoldm_tpu_torch.train.trainer import prepare_batch  # noqa: E402

# Grids of the block kernels (csrc/*.cu), by kernel-name substring.
KERNELS = ("gcl_rows_bwd_tile", "coord_rows_bwd_tile", "edge_tile_bwd_kernel", "gcl_rows_tile",
           "coord_rows_tile", "edge_tile_kernel", "node_gemm_tc_kernel", "wgrad_tc_kernel",
           "splitk_reduce_kernel", "reduce_rows_kernel", "column_sum_kernel", "coord_grad_kernel",
           "rows_mask_kernel", "silu_kernel", "dsilu_mul_kernel")
STEPS, WARMUP, TRACED = 10, 3, 3


def _row_grid_name(name: str) -> str:
    """The forward row grid of #3 (GCL) and #4 (coordinate update) is one
    template, rows_tile_kernel<HP, COORD> (csrc/egnn_rows.cuh), and so is
    the backward row grid of #5/#7, rows_bwd_tile_kernel<HP, COORD>
    (csrc/egnn_rows_bwd.cuh), each with a BF16 flag: name each by its
    stage, demangled or mangled."""
    for grid, short in (("rows_bwd_tile_kernel", "rows_bwd_tile"),
                        ("rows_tile_kernel", "rows_tile")):
        if re.search(grid + r"(<\d+, false[,>]|ILi\d+ELb0E)", name):
            return "gcl_" + short
        if re.search(grid + r"(<\d+, true[,>]|ILi\d+ELb1E)", name):
            return "coord_" + short
    return name


def _device_split(prof, n):
    """Device ms per repetition by kernel name over a traced window."""
    split = {k: 0.0 for k in KERNELS + ("other",)}
    for ev in prof.events():
        # Device-side events only; record_function ranges (Optimizer.step)
        # also appear on the device track, spanning their kernels: skip them.
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        key = next((k for k in KERNELS if k in _row_grid_name(ev.name)), "other")
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


def _time_train(cfg, raw, info, card, label, compute_dtype):
    """Host-clock ms per step and a traced window's device split for train
    steps on one batch."""
    model = factory.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, 1e-4, ema_decay=0.9999)
    step = make_train_step(cfg, 0.9999, compute_dtype)
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
    b, n = raw["x"].shape[:2]
    out = {"B": int(b), "N": int(n), "step_ms": step_ms, "traced_step_ms": traced_ms,
           "device_ms_per_step": device_ms, "split_ms_per_step": split,
           "device_busy_share": device_ms / traced_ms}
    print(f"{label} {compute_dtype} train step B={b} N={n}: {step_ms:.2f} ms, device "
          f"{device_ms:.2f} ms/step {json.dumps(split)} on {card}", flush=True)
    del model, state
    torch.cuda.empty_cache()
    return out


def _block_inputs(rng, b, n, hidden, n_min):
    n_real = rng.integers(n_min, n + 1, size=b)
    mask = (np.arange(n)[None, :] < n_real[:, None]).astype(np.float32)[..., None]
    return [torch.from_numpy(a).cuda() for a in (
        rng.standard_normal((b, n, hidden)).astype(np.float32) * mask,
        rng.standard_normal((b, n, 3)).astype(np.float32) * mask,
        rng.standard_normal((b, n, 3)).astype(np.float32) * mask, mask,
        rng.standard_normal((b, n, hidden)).astype(np.float32),
        rng.standard_normal((b, n, 3)).astype(np.float32))]


def _qm9(card, compute_dtype):
    info = get_dataset_info("qm9")
    cfg = factory.make_latent_diffusion_config(info, nf=256, n_layers=9, latent_nf=1,
                                               diffusion_steps=1000, trainable_ae=True)
    train = _time_train(cfg, synthetic_batch(info, 64, 29, np.random.default_rng(0)), info, card,
                        "QM9", compute_dtype)
    dt = resolve_compute(compute_dtype).dtype
    bcfg = EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=256, n_layers=9)
    block = EquivariantBlock(bcfg)
    init_parameters(block, torch.Generator().manual_seed(1))
    block = block.cuda()
    args = _block_inputs(np.random.default_rng(2), 64, 29, 256, 21)
    for _ in range(3):
        egnn_block.block_backward_cuda(block, *args, compute_dtype=dt)
    bwd_ms, bwd_split = _trace(lambda: egnn_block.block_backward_cuda(block, *args,
                                                                      compute_dtype=dt), 10)
    bwd = {"B": 64, "N": 29, "H": 256, "traced_ms": bwd_ms, "split_ms": bwd_split,
           "device_ms": sum(bwd_split.values())}
    print(f"block backward B=64 N=29 H=256: device {bwd['device_ms']:.3f} ms "
          f"{json.dumps(bwd_split)} on {card}", flush=True)
    return {"card": card, "compute_dtype": compute_dtype, "train": train, "block_backward": bwd}


def _geom(card, compute_dtype):
    info = get_dataset_info("geom")
    cfg = factory.make_latent_diffusion_config(info, nf=256, n_layers=4, latent_nf=2,
                                               include_charges=False, diffusion_steps=1000,
                                               trainable_ae=True)
    hist = sorted(dict(info.n_nodes_histogram))
    rng = np.random.default_rng(0)
    train = {}
    for pad, lo in ((184, 129), (104, 81), (48, 33)):
        sizes = rng.choice([k for k in hist if lo <= k <= pad], size=32)
        raw = synthetic_batch(info, 32, pad, rng, include_charges=False, n_atoms=sizes)
        train[str(pad)] = _time_train(cfg, raw, info, card, "GEOM", compute_dtype)
    dt = resolve_compute(compute_dtype).dtype
    block = EquivariantBlock(cfg.dynamics.egnn)
    init_parameters(block, torch.Generator().manual_seed(1))
    block = block.cuda()
    h, x, x0, mask, gh, gx = _block_inputs(np.random.default_rng(2), 32, 184, 256, 168)
    stages = {}
    chain = egnn_tiled.gcl_rows_cuda(block.gcl_0, h, x, x0, mask, keep_chain=True,
                                     compute_dtype=dt)[1]
    for name, fn in (("gcl_rows", lambda: egnn_tiled.gcl_rows_backward_cuda(
                         block.gcl_0, h, x, x0, mask, gh, compute_dtype=dt)),
                     ("gcl_rows_from_chain", lambda: egnn_tiled.gcl_rows_backward_cuda(
                         block.gcl_0, h, x, x0, mask, gh, chain=chain, compute_dtype=dt)),
                     ("coord_rows", lambda: egnn_tiled.coord_rows_backward_cuda(
                         block.gcl_equiv, h, x, x0, mask, gx, compute_dtype=dt))):
        for _ in range(2):
            fn()
        ms, split = _trace(fn, 5)
        stages[name] = {"B": 32, "N": 184, "H": 256, "traced_ms": ms, "split_ms": split,
                        "device_ms": sum(split.values())}
        print(f"{name} backward (#5) B=32 N=184 H=256: device "
              f"{stages[name]['device_ms']:.3f} ms {json.dumps(split)} on {card}", flush=True)
    return {"card": card, "compute_dtype": compute_dtype, "train": train,
            "stage_backward": stages}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", choices=["qm9", "geom"], default="qm9")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16", "pallas", "bfloat16_pallas"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    run = _qm9 if args.dataset == "qm9" else _geom
    print(json.dumps(run(card, args.compute_dtype)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
