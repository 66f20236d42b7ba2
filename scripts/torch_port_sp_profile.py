"""Where a sequence-parallel (SP) train step of the PyTorch/CUDA port spends
its time, beside the same step on one rank without SP, on one card.

Builds the GEOM latent-diffusion model at the recipe (nf=256, 4 layers,
latent_nf=2, no charges, T=1000, trainable_ae, EMA 0.9999) with random
weights (seeded torch.Generator) and B=32 synthetic molecules at the
training pads 184 (129-181 atoms) and 48 (33-48 atoms). For each pad it
times train steps on one rank without SP (this process), then spawns the SP
ranks (``parallel.sharding.spawn``; with one card they share it over gloo)
and on every rank times the same steps on the host clock around
synchronised work, and the time spent inside the collectives (host clock,
synchronised before and after each one, so a rank's wait for the other
counts there), their number and bytes. Rank 0 also traces steps with
torch.profiler: its own device time per step by kernel name.
``--compute_dtype`` (the training CLIs' choices) runs every step in it:
``bfloat16`` on the bf16 kernels (#6/#7 on the ranks, #1-#5 on one rank).

Prints one JSON line.

    python3 scripts/torch_port_sp_profile.py [--ranks 2] [--compute_dtype bfloat16]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from geoldm_tpu_torch.data.datasets_config import get_dataset_info  # noqa: E402
from geoldm_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from geoldm_tpu_torch.models import factory  # noqa: E402
from geoldm_tpu_torch.models.distributions import DistributionNodes  # noqa: E402
from geoldm_tpu_torch.parallel import sharding, sp  # noqa: E402
from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step  # noqa: E402
from geoldm_tpu_torch.train.trainer import prepare_batch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_train_profile import _row_grid_name  # noqa: E402

# Grids of the kernels (csrc/*.cu), by kernel-name substring, the SP
# coordinate passes before the names they contain; the row grids named by
# stage (torch_port_train_profile._row_grid_name).
KERNELS = ("slab_coord_rows_kernel", "slab_coord_cols_kernel", "gcl_rows_bwd_tile",
           "coord_rows_bwd_tile", "edge_tile_bwd_kernel", "gcl_rows_tile", "coord_rows_tile",
           "edge_tile_kernel", "node_gemm_tc_kernel", "wgrad_tc_kernel", "splitk_reduce_kernel",
           "reduce_rows_kernel", "column_sum_kernel", "coord_grad_kernel", "rows_mask_kernel",
           "silu_kernel", "dsilu_mul_kernel")
STEPS, WARMUP, TRACED = 5, 2, 2
PADS = ((184, 129), (48, 33))  # (pad, smallest size drawn)


def _batches():
    info = get_dataset_info("geom")
    hist = sorted(dict(info.n_nodes_histogram))
    rng = np.random.default_rng(41)
    return {pad: synthetic_batch(info, 32, pad, rng, include_charges=False, n_atoms=rng.choice(
        [k for k in hist if lo <= k <= pad], size=32)) for pad, lo in PADS}


def _setup(device, compute_dtype, sp_group=None):
    info = get_dataset_info("geom")
    cfg = factory.make_latent_diffusion_config(info, nf=256, n_layers=4, latent_nf=2,
                                               include_charges=False, diffusion_steps=1000,
                                               trainable_ae=True)
    model = factory.build_model(cfg, device, torch.Generator().manual_seed(0), sp_group=sp_group)
    state = create_train_state(model, cfg, 5e-5, ema_decay=0.9999)
    step = make_train_step(cfg, 0.9999, compute_dtype)
    gen = torch.Generator(device=device).manual_seed(1)
    return state, (lambda batch: step(state, batch, gen)), DistributionNodes(info.n_nodes)


def _time(fn, n):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _device_split(prof, n):
    split = {k: 0.0 for k in KERNELS + ("other",)}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        key = next((k for k in KERNELS if k in _row_grid_name(ev.name)), "other")
        split[key] += ev.time_range.elapsed_us() / 1e3 / n
    return {k: v for k, v in split.items() if v}


def _rank(batches, compute_dtype, grid):
    """One SP rank: per pad, timed steps, collective time, and (rank 0) the
    device split."""
    grp = grid.seq
    state, run, nodes = _setup(grp.device, compute_dtype, grp)
    stats = {}

    def timed(name, fn):
        def wrapper(t, g):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(t, g)
            torch.cuda.synchronize()
            s = stats.setdefault(name, {"n": 0, "ms": 0.0, "bytes": 0})
            s["n"] += 1
            s["ms"] += (time.perf_counter() - t0) * 1e3
            s["bytes"] += t.numel() * t.element_size()
            return out
        return wrapper

    out = {}
    gather, reduce = sp.all_gather_rows, sharding.all_reduce
    for pad, raw in batches.items():
        batch = prepare_batch(raw, nodes, grp.device)
        _time(lambda: run(batch), WARMUP)
        step_ms = _time(lambda: run(batch), STEPS)
        stats.clear()
        # The slab boundaries call sp's names, the gradient sum sharding's.
        sp.all_gather_rows = timed("all_gather", gather)
        sp.all_reduce = sharding.all_reduce = timed("all_reduce", reduce)
        try:
            with_timers_ms = _time(lambda: run(batch), STEPS)
        finally:
            sp.all_gather_rows, sp.all_reduce, sharding.all_reduce = gather, reduce, reduce
        coll = {k: {"per_step": v["n"] / STEPS, "ms_per_step": v["ms"] / STEPS,
                    "mb_per_step": v["bytes"] / STEPS / 1e6} for k, v in stats.items()}
        rec = {"step_ms": step_ms, "step_ms_with_timers": with_timers_ms, "collectives": coll}
        # Every rank runs the traced steps (the collectives must match); rank 0
        # traces them.
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) if grp.rank == 0 else \
                contextlib.nullcontext() as prof:
            _time(lambda: run(batch), TRACED)
        if grp.rank == 0:
            rec["device_ms_per_step"] = _device_split(prof, TRACED)
        out[pad] = rec
    ranks = [None] * grp.size
    torch.distributed.all_gather_object(ranks, out)
    return ranks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16", "pallas", "bfloat16_pallas"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_port_sp_profile: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    batches = _batches()
    state, run, nodes = _setup("cuda", args.compute_dtype)
    one_rank = {}
    for pad, raw in batches.items():
        batch = prepare_batch(raw, nodes, "cuda")
        _time(lambda: run(batch), WARMUP)
        one_rank[pad] = _time(lambda: run(batch), STEPS)
    del state, run
    torch.cuda.empty_cache()
    ranks = sharding.spawn(1, args.ranks, _rank, (batches, args.compute_dtype), device="cuda")
    print(json.dumps({"card": card, "rule": sharding.placement(args.ranks, "cuda")[2],
                      "compute_dtype": args.compute_dtype, "one_rank_step_ms": one_rank,
                      "sp_ranks": ranks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
