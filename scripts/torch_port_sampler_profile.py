"""Where a dense sampler step of the PyTorch/CUDA port spends its time.

Builds two latent-diffusion models at their recipes with random weights
(seeded torch.Generator) on one card: QM9 (nf=256, 9 layers, latent_nf=1)
and GEOM-Drugs (nf=256, 4 layers, latent_nf=2, no charges), both T=1000.
For a few (batch, pad) shapes of each it times ancestral steps
(sample_p_zs_given_zt) on the host clock around synchronised work, then
traces a window of steps with torch.profiler and splits device time by grid:
the block kernel's edge and node-GEMM grids (#1, pads <= 64), the row-tiled
GCL kernel's (#3) and coordinate kernel's (#4) edge and node-GEMM grids
(pads > 64), and everything else. Prints one JSON line. ``--compute_dtype``
runs the steps in another compute dtype (``bfloat16``: the bf16 variants of
#1, #3 and #4, whose grids fall in the same groups).

    python3 scripts/torch_port_sampler_profile.py [--compute_dtype bfloat16]
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from geoldm_tpu_torch.data.datasets_config import get_dataset_info  # noqa: E402
from geoldm_tpu_torch.diffusion import vdm  # noqa: E402
from geoldm_tpu_torch.models import factory  # noqa: E402
from geoldm_tpu_torch.nn.core import resolve_compute  # noqa: E402
from geoldm_tpu_torch.ops.com import remove_mean_with_mask  # noqa: E402

# (dataset, recipe, (B, N) shapes, ragged spread n-spread..n atoms)
MODELS = (
    ("qm9", dict(nf=256, n_layers=9, latent_nf=1), ((4, 16), (64, 16), (64, 24), (64, 32)), 7),
    ("geom", dict(nf=256, n_layers=4, latent_nf=2, include_charges=False),
     ((16, 64), (16, 96), (16, 136), (16, 184)), 16),
)
STEPS, WARMUP, TRACED = 50, 10, 10
# Device-time groups by kernel-name pattern (demangled, or mangled as a
# fallback); the whole-block kernel #1 has its own edge tile
# (csrc/egnn_block_tile.cuh), the row-tiled kernels' edge grid is one
# template by <HP, COORD> (csrc/egnn_rows.cuh), and all of them run their
# node-side products on the one node GEMM (csrc/egnn_tc_gemm.cuh).
GROUPS = (
    ("k1_edge", r"edge_tile_kernel"),
    ("k3_edge", r"rows_tile_kernel(<\d+, false[,>]|ILi\d+ELb0E)"),
    ("k4_edge", r"rows_tile_kernel(<\d+, true[,>]|ILi\d+ELb1E)"),
    ("node_gemm", r"node_gemm_tc_kernel"),
)


def _steps(model, gamma_fn, gen, z, mask, s_from, n, compute_dtype):
    cfg = model.cfg.diffusion
    b = z.shape[0]
    for k in range(n):
        s = s_from - k
        s_arr = torch.full((b, 1), s / cfg.timesteps, device=z.device)
        t_arr = torch.full((b, 1), (s + 1) / cfg.timesteps, device=z.device)
        z = vdm.sample_p_zs_given_zt(model.dynamics, cfg, gamma_fn, gen, s_arr, t_arr, z, mask,
                                     compute_dtype=resolve_compute(compute_dtype).dtype)
    return z


def _device_split(prof):
    """Device microseconds by group over a traced window."""
    split = {name: 0.0 for name, _ in GROUPS}
    split["other"] = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us:
            continue
        key = next((name for name, pat in GROUPS if re.search(pat, ev.key)), "other")
        split[key] += us
    return split


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--compute_dtype", default="float32")
    compute_dtype = p.parse_args().compute_dtype
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    rows = []
    for dataset, recipe, shapes, spread in MODELS:
        cfg = factory.make_latent_diffusion_config(get_dataset_info(dataset), **recipe,
                                                   diffusion_steps=1000)
        model = factory.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
        gamma_fn = vdm.make_gamma_fn(cfg.diffusion, "cuda")
        feat = 3 + recipe["latent_nf"]
        for b, n in shapes:
            rng = np.random.default_rng(n)
            n_real = rng.integers(max(1, n - spread), n + 1, size=b)
            mask = torch.from_numpy(
                (np.arange(n)[None, :] < n_real[:, None]).astype(np.float32)[..., None]).cuda()
            z = torch.from_numpy(rng.standard_normal((b, n, feat)).astype(np.float32)).cuda() * mask
            z[:, :, :3] = remove_mean_with_mask(z[:, :, :3], mask)
            gen = torch.Generator(device="cuda").manual_seed(0)
            with torch.no_grad():
                z = _steps(model, gamma_fn, gen, z, mask, 999, WARMUP, compute_dtype)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                z = _steps(model, gamma_fn, gen, z, mask, 999 - WARMUP, STEPS, compute_dtype)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    t1 = time.perf_counter()
                    _steps(model, gamma_fn, gen, z, mask, 999 - WARMUP - STEPS, TRACED,
                           compute_dtype)
                    torch.cuda.synchronize()
                    traced_ms = (time.perf_counter() - t1) * 1e3 / TRACED
            split = {k: v / 1e3 / TRACED for k, v in _device_split(prof).items()}
            device_ms = sum(split.values())
            row = {"dataset": dataset, "compute_dtype": compute_dtype,
                   "layers": recipe["n_layers"], "B": b, "N": n,
                   "step_ms": wall_ms, "traced_step_ms": traced_ms,
                   "device_ms_per_step": device_ms or None,
                   "split_ms_per_step": split if device_ms else None,
                   "device_busy_share": device_ms / traced_ms if device_ms else None,
                   "device_share_of_untraced_step": device_ms / wall_ms if device_ms else None,
                   "mol_per_s_at_T1000": b / (wall_ms * 1e-3 * 1001)}
            rows.append(row)
            print(f"{dataset} {compute_dtype} B={b} N={n}: {wall_ms:.3f} ms/step, "
                  f"device {device_ms:.3f} ms/step "
                  f"{json.dumps({k: round(v, 4) for k, v in split.items()})} on {card}",
                  flush=True)
        del model
    print(json.dumps({"card": card, "steps": STEPS, "traced_steps": TRACED, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
