"""Time the EquivariantBlock kernels of this checkout against another
checkout's, on one NVIDIA card.

    python3 scripts/torch_port_block_ab.py --other <checkout> [--suite block|rows|bwd]

Each tree runs in its own interpreter, with its own package and kernel
build, in turns: other, this, this, other. Kernels are timed with CUDA
events over 20 calls after 3 warm-ups on 4 cycled seeded inputs at H=256
with attention (the recipes' blocks); steps on the host clock around
synchronised work.

``--suite block`` (the default), the whole-molecule kernels #1/#2: the
forward kernel and the backward kernel (``block_backward_cuda``, which
recomputes the forward) at B=64, N=16, 24, 29, 32 (QM9's pads), B=32, N=48,
64 (GEOM's), one 'mean' (N=32) and one sin-embedding (N=24) case; a block's
training route (``block_forward`` under grad, then its backward) at the
same shapes; one recipe train step at QM9 pad 29 (B=64, 9 layers) and GEOM
pad 48 (B=32, 4 layers), with the peak device memory of those steps.

``--suite rows``, the row-tiled forward grid: #3 (GCL) and #4 (coordinate
update) at B=16, N=96, 136, 184 (GEOM's serving pads past 64, n-16..n
atoms); #6 on both slabs of N=184 over 2 ranks (S=92, B=16); a GEOM
sampler step (T=1000 recipe, B=16, N=184); and a GEOM recipe train step at
pad 184 (B=32, 129-181 atoms), with its peak device memory.

``--suite bwd``, the row-tiled stage backward: #5 (GCL and coordinate stage,
the direct call, which runs the GCL's node chain itself) at B=32, N=104, 184
(GEOM's training pads past 64, n-16..n atoms), and from the node chain its
forward kept where the tree takes one (the training route); #7 on both
slabs of N=184 over 2 ranks (S=92, B=32); and a GEOM recipe train step at
pad 184 (B=32, 129-181 atoms), with its peak device memory. Kernels are
timed over 10 calls after 2 warm-ups.

Prints one JSON line with both trees' numbers per turn, the card's name and
its power limit.
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


def _geom_step_ms(pad, steps=5, warmup=3):
    """(host-clock ms per GEOM recipe train step on B=32 synthetic molecules
    of 129-181 atoms padded to ``pad``, peak device MiB)."""
    import numpy as np
    import torch

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import synthetic_batch
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step
    from geoldm_tpu_torch.train.trainer import prepare_batch

    info = get_dataset_info("geom")
    cfg = factory.make_latent_diffusion_config(info, nf=256, n_layers=4, latent_nf=2,
                                               include_charges=False, diffusion_steps=1000,
                                               trainable_ae=True)
    rng = np.random.default_rng(41)
    sizes = rng.choice([k for k in sorted(dict(info.n_nodes_histogram)) if 129 <= k <= pad],
                       size=32)
    raw = synthetic_batch(info, 32, pad, rng, include_charges=False, n_atoms=sizes)
    model = factory.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, 5e-5, ema_decay=0.9999)
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


def _sampler_step_ms(b=16, n=184, steps=20, warmup=5):
    """Host-clock ms per ancestral step of the GEOM recipe (T=1000, random
    weights) on B molecules of n-16..n atoms padded to n."""
    import numpy as np
    import torch

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.diffusion import vdm
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.ops.com import remove_mean_with_mask

    cfg = factory.make_latent_diffusion_config(get_dataset_info("geom"), nf=256, n_layers=4,
                                               latent_nf=2, include_charges=False,
                                               diffusion_steps=1000)
    model = factory.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    gamma_fn = vdm.make_gamma_fn(cfg.diffusion, "cuda")
    rng = np.random.default_rng(n)
    n_real = rng.integers(n - 16, n + 1, size=b)
    mask = torch.from_numpy(
        (np.arange(n)[None, :] < n_real[:, None]).astype(np.float32)[..., None]).cuda()
    z = torch.from_numpy(rng.standard_normal((b, n, 5)).astype(np.float32)).cuda() * mask
    z[:, :, :3] = remove_mean_with_mask(z[:, :, :3], mask)
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = []
    with torch.no_grad():
        for k in range(warmup + steps):
            s_arr = torch.full((b, 1), (999 - k) / 1000, device="cuda")
            t_arr = torch.full((b, 1), (1000 - k) / 1000, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z = vdm.sample_p_zs_given_zt(model.dynamics, cfg.diffusion, gamma_fn, gen, s_arr,
                                         t_arr, z, mask)
            torch.cuda.synchronize()
            if k >= warmup:
                times.append((time.perf_counter() - t0) * 1e3)
    return times


def _dump_rows() -> dict:
    """Times of the row-tiled forward kernels (#3, #4, #6), a GEOM sampler
    step and a GEOM train step at pad 184."""
    import numpy as np
    import torch

    from geoldm_tpu_torch.config import EGNNConfig
    from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters
    from geoldm_tpu_torch.ops import egnn_sp, egnn_tiled

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"stages": [], "slabs": []}

    def geom_block(n):
        cfg = EGNNConfig(in_node_nf=3, out_node_nf=3, hidden_nf=256, n_layers=4, attention=True,
                         normalization_factor=1.0)
        block = EquivariantBlock(cfg)
        init_parameters(block, torch.Generator().manual_seed(n))
        return block.to(dev).eval()

    def ragged(n, b, seed):
        rng = np.random.default_rng(seed)
        n_real = rng.integers(n - 16, n + 1, size=b)
        mask = (np.arange(n)[None, :] < n_real[:, None]).astype(np.float32)[..., None]
        arrs = [rng.standard_normal((b, n, f)).astype(np.float32) * mask for f in (256, 3, 3)]
        return [torch.from_numpy(a).to(dev) for a in (*arrs, mask)]

    with torch.no_grad():
        for n in (96, 136, 184):
            block = geom_block(n)
            inputs = [ragged(n, 16, 1000 * n + rep) for rep in range(4)]
            row = {"N": n, "B": 16}
            for stage, mod, fn in (("gcl_rows", block.gcl_0, egnn_tiled.gcl_rows_cuda),
                                   ("coord_rows", block.gcl_equiv, egnn_tiled.coord_rows_cuda)):
                row[f"{stage}_ms"] = _time_ms(lambda *a, m=mod, f=fn: f(m, *a), inputs)
            out["stages"].append(row)
        n, s = 184, 92
        block = geom_block(n)
        inputs = [ragged(n, 16, 7000 + rep) for rep in range(4)]
        for row0 in (0, s):
            row = {"N": n, "S": s, "row0": row0, "B": 16}
            args = [(full, [t[:, row0:row0 + s].contiguous() for t in full], row0, n)
                    for full in inputs]
            for stage, mod in (("gcl_rows", block.gcl_0), ("coord_rows", block.gcl_equiv)):
                fwd, _ = egnn_sp.stage_fns(mod, True)
                row[f"{stage}_ms"] = _time_ms(lambda *a, m=mod, f=fwd: f(m, *a), args)
            out["slabs"].append(row)
        del block, inputs, args
    torch.cuda.empty_cache()
    out["geom_sampler_step_ms_B16_N184"] = _sampler_step_ms()
    torch.cuda.empty_cache()
    out["geom184_step_ms"], out["geom184_peak_mib"] = _geom_step_ms(184)
    out["card"] = torch.cuda.get_device_name(0)
    return out


def _dump_bwd() -> dict:
    """Times of the row-tiled stage backward (#5, #7) and a GEOM train step
    at pad 184."""
    import inspect

    import numpy as np
    import torch

    from geoldm_tpu_torch.config import EGNNConfig
    from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters
    from geoldm_tpu_torch.ops import egnn_sp, egnn_tiled

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"stages": [], "slabs": []}
    takes_chain = "chain" in inspect.signature(egnn_tiled.gcl_rows_backward_cuda).parameters
    cfg = EGNNConfig(in_node_nf=3, out_node_nf=3, hidden_nf=256, n_layers=4, attention=True,
                     normalization_factor=1.0)
    block = EquivariantBlock(cfg)
    init_parameters(block, torch.Generator().manual_seed(5))
    block = block.to(dev)

    def ragged(n, seed):
        rng = np.random.default_rng(seed)
        n_real = rng.integers(n - 16, n + 1, size=32)
        mask = (np.arange(n)[None, :] < n_real[:, None]).astype(np.float32)[..., None]
        arrs = [rng.standard_normal((32, n, f)).astype(np.float32) * mask for f in (256, 3, 3)]
        cots = [rng.standard_normal((32, n, f)).astype(np.float32) for f in (256, 3)]
        return [torch.from_numpy(a).to(dev) for a in (*arrs, mask, *cots)]

    for n in (104, 184):
        inputs = [ragged(n, 100 * n + rep) for rep in range(2)]
        row = {"N": n, "B": 32}
        row["gcl_rows_ms"] = _time_ms(lambda h, x, x0, m, gh, gx: egnn_tiled.gcl_rows_backward_cuda(
            block.gcl_0, h, x, x0, m, gh), inputs, warmup=2, reps=10)
        row["coord_rows_ms"] = _time_ms(
            lambda h, x, x0, m, gh, gx: egnn_tiled.coord_rows_backward_cuda(
                block.gcl_equiv, h, x, x0, m, gx), inputs, warmup=2, reps=10)
        if takes_chain:
            chained = [(*a, egnn_tiled.gcl_rows_cuda(block.gcl_0, *a[:4], keep_chain=True)[1])
                       for a in inputs]
            row["gcl_rows_chain_ms"] = _time_ms(
                lambda h, x, x0, m, gh, gx, c: egnn_tiled.gcl_rows_backward_cuda(
                    block.gcl_0, h, x, x0, m, gh, chain=c), chained, warmup=2, reps=10)
            del chained
        out["stages"].append(row)
        del inputs
        torch.cuda.empty_cache()
    n, s = 184, 92
    inputs = [ragged(n, 9000 + rep) for rep in range(2)]
    for row0 in (0, s):
        row = {"N": n, "S": s, "row0": row0, "B": 32}
        for stage, mod, k in (("gcl_rows", block.gcl_0, 4), ("coord_rows", block.gcl_equiv, 5)):
            _, bwd = egnn_sp.stage_fns(mod, True)
            args = [(a[:4], [t[:, row0:row0 + s].contiguous() for t in a[:4]], row0, n,
                     a[k][:, row0:row0 + s].contiguous()) for a in inputs]
            row[f"{stage}_ms"] = _time_ms(lambda *a, m=mod, f=bwd: f(m, *a), args, warmup=2,
                                          reps=10)
        out["slabs"].append(row)
    del block, inputs, args
    torch.cuda.empty_cache()
    out["geom184_step_ms"], out["geom184_peak_mib"] = _geom_step_ms(184)
    out["card"] = torch.cuda.get_device_name(0)
    return out


def _dump(root: str, suite: str) -> dict:
    """Times of ``root``'s kernels and steps of ``suite``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from geoldm_tpu_torch.ops import egnn_block

    assert egnn_block.__file__.startswith(os.path.abspath(root)), egnn_block.__file__
    if suite == "rows":
        return _dump_rows()
    if suite == "bwd":
        return _dump_bwd()

    from geoldm_tpu_torch.config import EGNNConfig
    from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters

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
    p.add_argument("--suite", choices=("block", "rows", "bwd"), default="block",
                   help="the whole-molecule kernels #1/#2, the row-tiled forward grid or the "
                        "row-tiled stage backward")
    p.add_argument("--dump", help=argparse.SUPPRESS)  # internal: one tree's times
    args = p.parse_args(argv)
    if args.dump:
        print(json.dumps(_dump(args.dump, args.suite)))
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(args.other)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    runs = {"this": [], "other": []}
    for label, root in (("other", other), ("this", here), ("this", here), ("other", other)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--other", "-",
                               "--suite", args.suite, "--dump", root], stdout=subprocess.PIPE,
                              text=True)
        if proc.returncode != 0:
            print(f"block_ab: the run of {root} failed", file=sys.stderr)
            return 1
        runs[label].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"nvidia_smi": card, "suite": args.suite, "this": here, "other": other,
                      "turns": "other, this, this, other", "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
