"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py            # all phases, one card

Phases (each prints a line; any failure exits non-zero before the result):
  1. the card's name and power limit (nvidia-smi), and the kernel build
     (one nvcc per source in geoldm_tpu_torch/csrc, for sm_90a, in parallel);
  2. the EquivariantBlock kernel against its plain PyTorch version on the
     card at H=256, B=64, N in {16, 24, 32} with ragged masks, plus one
     'mean'-aggregation and one sin-embedding case, with times and bounds;
  3. a QM9 latent-diffusion model at nf=256, 9 layers, latent_nf=1, T=1000
     with random weights from a seeded torch.Generator, written in the
     upstream checkpoint layout (args.pickle + generative_model_ema.npy);
  4. the port's HTTP sampling server on 127.0.0.1: /health, three /sample
     requests (seeded, n_samples, seeded replay), one invalid request,
     /metrics; the kernel's launch count must equal
     ((T + 1) * 9 denoiser blocks + 9 decoder blocks) * chunks dispatched
     (T ancestral steps plus the denoiser call of the final z0 -> x step);
  5. one full-width denoiser evaluation through the kernel against the same
     evaluation through the plain path on the CPU;
  6. the EquivariantBlock backward kernel against its plain version
     (autograd of the recomputed block) at H=256, B=64, N in {16, 24, 29, 32}
     with ragged masks, plus one 'mean' and one sin-embedding case: dh, dx,
     dx0 and every weight gradient, with times and bounds;
  7. the training entry point (cli.main_qm9) at the reference recipe (nf=256,
     9 layers, latent_nf=1, T=1000, B=64, trainable_ae, EMA 0.9999) on
     fabricated QM9-format splits: 5 train steps, stability sampling, valid
     and test NLL and the checkpoints; the kernels' launch counts must equal
     what the code implies, and the checkpoint must load back;
  8. one full-width train-step gradient (B=8, N=29) through the kernels on the
     card against the plain path on the CPU, same weights, batch and noise;
  9. the row-tiled GCL (#3) and coordinate (#4) kernels against their plain
     versions on the card at H=256, B=16, N in {96, 136, 184} with ragged
     masks (n-16..n atoms), plus one 'mean' case at N=181 and one
     sin-embedding case at N=96, with times and per-stage bounds; and the
     block kernel against its plain version and the tiled path at N=48, 64;
 10. a GEOM-Drugs latent-diffusion model at the recipe (nf=256, 4 layers,
     latent_nf=2, no charges, T=1000, random weights from seed 0) written
     with dataset "geom" and served with --dataset geom --batch_max 16: a
     seeded request with one molecule in each bucket, its replay, 24 sizes
     drawn from the GEOM histogram and an invalid request; per chunk the
     launch counts must be 4008 = (T+1)*4 + 4 of the block kernel (pad <= 64)
     or of each of #3 and #4 (pad > 64);
 11. one GEOM denoiser evaluation (4 blocks, B=2, N=184) through the tiled
     kernels against the plain path on the CPU, and the refusal of a block
     past 64 nodes under grad (its backward, TPU kernel #5, is not ported).

The line before the last is one JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Needs torch with CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# Data-sheet peaks of the H100 SXM (nvidia-smi names it "NVIDIA H100 80GB
# HBM3"): dense non-tensor-core float32 FLOP/s and HBM bytes/s.
_H100_SXM = "H100 80GB HBM3"
_FLOP_PEAK, _BW_PEAK = 67.0e12, 3.35e12

# Kernel vs plain: both sum in float32 but in different orders. Holds for
# the backward's weight gradients too, which add up B*N*N edge terms.
_KERNEL_RTOL = 1e-4
# Nine (QM9) or four (GEOM) blocks chained on the card vs the CPU: order
# differences compound.
_DENOISER_RTOL = 2e-4
# A whole train step's gradient, card vs CPU: the loss and, per parameter
# tensor, max|d| <= _GRAD_RTOL * max|ref| (f32 sum orders through 19 blocks
# forward and 18 backward; no floor of 1, so small gradients are held too).
_LOSS_RTOL, _GRAD_RTOL = 1e-5, 1e-3


class SmokeFailure(Exception):
    pass


def _check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    _check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def _time_ms(fn, inputs, warmup=3, reps=20):
    """Mean ms per call with CUDA events, cycling through distinct inputs."""
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


def _block_work(cfg, n_real, n_pad, n_weights):
    """(FLOP, bytes) one block forward needs for molecules of n_real atoms
    padded to n_pad: the edge MLPs over real ordered pairs, the node-side
    products over real nodes, each input read and each output written once."""
    H, E = cfg.hidden_nf, cfg.edge_feat_nf
    pairs = float(np.sum(n_real * (n_real - 1)))
    nodes = float(np.sum(n_real))
    edge_stage = pairs * (2 * E * H + 2 * H * H + 2 * H)  # first-layer edge term, W2, wa/w3
    gcl = edge_stage + nodes * (2 * 2 * H * H + 2 * 2 * H * H + 2 * H * H)  # src/dst, node MLP
    coord = edge_stage + nodes * (2 * 2 * H * H)
    flops = cfg.inv_sublayers * gcl + coord
    b = len(n_real)
    nbytes = 4 * (b * n_pad * (2 * H + 3 * 3 + 1) + n_weights)
    return flops, nbytes


def _bwd_work(cfg, n_real, n_pad, n_weights):
    """(FLOP, bytes) one block backward needs: the forward it recomputes, then
    per edge stage the W2 input gradient and weight gradient (2 * 2H^2 per
    real pair) plus the edge-feature, gate and scale terms, and per real node
    the src/dst and node-MLP input and weight gradients; each input (h, x,
    x0, mask, the cotangents, the weights) read once and each output (dh, dx,
    dx0, the weight gradients) written once."""
    H, E = cfg.hidden_nf, cfg.edge_feat_nf
    fwd_flops, _ = _block_work(cfg, n_real, n_pad, n_weights)
    pairs = float(np.sum(n_real * (n_real - 1)))
    nodes = float(np.sum(n_real))
    edge_stage = pairs * (4 * H * H + 4 * E * H + 4 * H)
    gcl = edge_stage + nodes * (8 * H * H + 12 * H * H)  # src/dst, node MLP
    coord = edge_stage + nodes * 8 * H * H
    flops = fwd_flops + cfg.inv_sublayers * gcl + coord
    b = len(n_real)
    nbytes = 4 * (b * n_pad * (3 * H + 5 * 3 + 1) + 2 * n_weights)
    return flops, nbytes


def _stage_work(cfg, n_real, n_pad, n_weights, coord):
    """(FLOP, bytes) one row-tiled stage needs: the edge MLP over real ordered
    pairs and the node-side products over real nodes (the two halves of
    ``_block_work``'s per-stage terms); h, x, x0 and the mask read once, the
    stage's output (h, or x for the coordinate stage) and its weights once."""
    H, E = cfg.hidden_nf, cfg.edge_feat_nf
    pairs = float(np.sum(n_real * (n_real - 1)))
    nodes = float(np.sum(n_real))
    flops = pairs * (2 * E * H + 2 * H * H + 2 * H)
    flops += nodes * (2 * 2 * H * H) if coord else nodes * (2 * 2 * H * H + 2 * 2 * H * H + 2 * H * H)
    b = len(n_real)
    nbytes = 4 * (b * n_pad * (H + 3 + 3 + 1 + (3 if coord else H)) + n_weights)
    return flops, nbytes


def _ragged_inputs(seed, B, n, H, dev, spread=8):
    """h, x, x0, node_mask on ``dev``: B molecules of n-spread..n atoms
    padded to n."""
    import torch

    rng = np.random.default_rng(seed)
    n_real = rng.integers(max(1, n - spread), n + 1, size=B)
    mask = (np.arange(n)[None, :] < n_real[:, None]).astype(np.float32)[..., None]
    h = rng.standard_normal((B, n, H)).astype(np.float32) * mask
    x = rng.standard_normal((B, n, 3)).astype(np.float32) * mask
    x0 = rng.standard_normal((B, n, 3)).astype(np.float32) * mask
    return tuple(torch.from_numpy(a).to(dev) for a in (h, x, x0, mask))


def phase_kernel(card_name):
    import torch

    from geoldm_tpu_torch.config import EGNNConfig
    from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters
    from geoldm_tpu_torch.ops import egnn_block

    # The plain side runs in full float32, as the kernel does.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    B, H = 64, 256
    cases = [
        ("sum", 16, {}), ("sum", 24, {}), ("sum", 32, {}),
        ("mean", 32, {"aggregation_method": "mean"}), ("sin", 24, {"sin_embedding": True}),
    ]
    rows = []
    for case, n, extra in cases:
        cfg = EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=H, n_layers=9,
                         attention=True, normalization_factor=1.0, **extra)
        gen = torch.Generator().manual_seed(n)
        block = EquivariantBlock(cfg)
        init_parameters(block, gen)
        block = block.to(dev).eval()
        n_weights = sum(p.numel() for p in block.parameters())
        inputs = [_ragged_inputs(1000 * n + rep, B, n, H, dev) for rep in range(4)]
        with torch.no_grad():
            h_k, x_k = egnn_block.block_forward_cuda(block, *inputs[0])
            h_p, x_p = egnn_block.block_forward_plain(block, *inputs[0])
            torch.cuda.synchronize()
            err = max(float((h_k - h_p).abs().max()), float((x_k - x_p).abs().max()))
            scale = max(1.0, float(h_p.abs().max()), float(x_p.abs().max()))
            _check(bool(torch.isfinite(h_k).all() and torch.isfinite(x_k).all()),
                   f"kernel output not finite at N={n} {extra}")
            _check(err <= _KERNEL_RTOL * scale,
                   f"kernel disagrees with plain at N={n} {extra}: max|d|={err:.3e} "
                   f"> {_KERNEL_RTOL}*{scale:.3g}")
            ms = _time_ms(lambda *a: egnn_block.block_forward_cuda(block, *a), inputs)
            plain_ms = _time_ms(lambda *a: egnn_block.block_forward_plain(block, *a), inputs)
        n_real0 = inputs[0][3][:, :, 0].sum(dim=1).cpu().numpy()
        flops, nbytes = _block_work(cfg, n_real0, n, n_weights)
        t_ops, t_bytes = flops / _FLOP_PEAK * 1e3, nbytes / _BW_PEAK * 1e3
        row = {"case": case, "N": n, "B": B, "H": H, "max_abs_err": err,
               "tol": _KERNEL_RTOL * scale,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "gflop": flops / 1e9, "tflops_achieved": flops / (ms * 1e-3) / 1e12}
        rows.append(row)
        print(f"phase 2: egnn_block {case} N={n} B={B} H={H} "
              f"max|d|={err:.3e} (tol {row['tol']:.2e}) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms (TF32 off) bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}) {row['tflops_achieved']:.2f} TFLOP/s, "
              f"{cfg.n_layers} launches per sampler step, on {card_name}", flush=True)
    return rows


def phase_backward(card_name):
    import torch

    from geoldm_tpu_torch.config import EGNNConfig
    from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters
    from geoldm_tpu_torch.ops import egnn_block

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    B, H = 64, 256
    cases = [
        ("sum", 16, {}), ("sum", 24, {}), ("sum", 29, {}), ("sum", 32, {}),
        ("mean", 32, {"aggregation_method": "mean"}), ("sin", 24, {"sin_embedding": True}),
    ]
    rows = []
    for case, n, extra in cases:
        cfg = EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=H, n_layers=9,
                         attention=True, normalization_factor=1.0, **extra)
        block = EquivariantBlock(cfg)
        init_parameters(block, torch.Generator().manual_seed(100 + n))
        block = block.to(dev).eval()
        n_weights = sum(p.numel() for p in block.parameters())
        inputs = []
        for rep in range(4):
            rng = np.random.default_rng(2000 * n + rep)
            cots = tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
                         for shape in ((B, n, H), (B, n, 3)))
            inputs.append(_ragged_inputs(3000 * n + rep, B, n, H, dev) + cots)
        got = egnn_block.block_backward_cuda(block, *inputs[0])
        want = egnn_block.block_backward_plain(block, *inputs[0])
        torch.cuda.synchronize()
        names = ["dh", "dx", "dx0"] + egnn_block.block_param_names(block)
        err, worst = 0.0, ""
        for name, g, w in zip(names, [*got[:3], *got[3]], [*want[:3], *want[3]]):
            _check(bool(torch.isfinite(g).all()), f"backward {name} not finite at N={n} {extra}")
            scale = max(1.0, float(w.abs().max()))
            d = float((g - w).abs().max())
            _check(d <= _KERNEL_RTOL * scale,
                   f"backward kernel disagrees with plain on {name} at N={n} {extra}: "
                   f"max|d|={d:.3e} > {_KERNEL_RTOL}*{scale:.3g}")
            if d > err:
                err, worst = d, name
        ms = _time_ms(lambda *a: egnn_block.block_backward_cuda(block, *a), inputs)
        plain_ms = _time_ms(lambda *a: egnn_block.block_backward_plain(block, *a), inputs)
        n_real0 = inputs[0][3][:, :, 0].sum(dim=1).cpu().numpy()
        flops, nbytes = _bwd_work(cfg, n_real0, n, n_weights)
        t_ops, t_bytes = flops / _FLOP_PEAK * 1e3, nbytes / _BW_PEAK * 1e3
        row = {"case": case, "N": n, "B": B, "H": H, "max_abs_err": err, "worst": worst,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "gflop": flops / 1e9, "tflops_achieved": flops / (ms * 1e-3) / 1e12}
        rows.append(row)
        print(f"phase 6: egnn_block_bwd {case} N={n} B={B} H={H} max|d|={err:.3e} ({worst}; "
              f"{len(names)} tensors each within {_KERNEL_RTOL}*max(1,max|ref|)) kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms (TF32 off) bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}) {row['tflops_achieved']:.2f} TFLOP/s on {card_name}",
              flush=True)
    return rows


def phase_train(card_name, tmpdir):
    import os

    import torch

    from geoldm_tpu_torch.cli import main_qm9
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import write_qm9_splits
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.ops import egnn_block
    from geoldm_tpu_torch.train.sampling import DEFAULT_SAMPLE_BUCKETS, n_chunks
    from geoldm_tpu_torch.train.train_step import make_train_step
    from geoldm_tpu_torch.train.trainer import prepare_batch
    from geoldm_tpu_torch.utils.buckets import covering_buckets
    from geoldm_tpu_torch.utils.convert import load_reference_checkpoint

    info = get_dataset_info("qm9")
    B, steps, T, decay, seed = 64, 5, 1000, 0.9999, 0
    write_qm9_splits(tmpdir, info, {"train": B * steps, "valid": B, "test": B}, seed=1)
    argv = ["--datadir", tmpdir, "--outdir", os.path.join(tmpdir, "out"), "--exp_name", "smoke",
            "--train_diffusion", "--trainable_ae", "--nf", "256", "--n_layers", "9",
            "--latent_nf", "1", "--diffusion_steps", str(T),
            "--diffusion_noise_schedule", "polynomial_2", "--batch_size", str(B),
            "--ema_decay", str(decay), "--n_epochs", "1", "--test_epochs", "1",
            "--n_stability_samples", "8", "--seed", str(seed)]
    print(f"phase 7: python -m geoldm_tpu_torch.cli.main_qm9 {' '.join(argv)}", flush=True)
    egnn_block.launches = egnn_block.bwd_launches = 0
    t0 = time.time()
    summary = main_qm9.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    fwd, bwd = egnn_block.launches, egnn_block.bwd_launches

    losses = summary["losses"][0]
    _check(len(losses) == steps, f"{len(losses)} train steps, expected {steps}")
    _check(bool(np.all(np.isfinite(losses))), f"non-finite train loss: {losses}")
    _check(len(summary["nll_val"]) == 1 and np.isfinite(summary["nll_val"][0]),
           f"valid NLL {summary['nll_val']}")
    _check(len(summary["nll_test"]) == 1 and np.isfinite(summary["nll_test"][0]),
           f"test NLL {summary['nll_test']}")
    # Launches: a train step runs the encoder forward only (its latent is
    # detached) and the 9 decoder + 9 denoiser blocks forward and backward;
    # an eval batch runs encoder + decoder + 2 denoiser passes (t0_always);
    # each sampled chunk runs (T+1) denoiser calls and one decode.
    layers = 9
    buckets = covering_buckets(DEFAULT_SAMPLE_BUCKETS, info["max_n_nodes"])
    chunks = n_chunks(summary["sample_sizes"][0], 8, buckets)
    per_step, per_eval = 1 + 2 * layers, 1 + 3 * layers
    expected_fwd = steps * per_step + 2 * per_eval + ((T + 1) * layers + layers) * chunks
    expected_bwd = steps * 2 * layers
    _check(fwd == expected_fwd,
           f"forward launches {fwd} != {steps}*{per_step} + 2*{per_eval} + "
           f"(({T}+1)*{layers}+{layers})*{chunks} = {expected_fwd}")
    _check(bwd == expected_bwd, f"backward launches {bwd} != {steps}*{2 * layers}")
    print(f"phase 7: {steps} steps, losses {[round(v, 4) for v in losses]}, valid NLL "
          f"{summary['nll_val'][0]:.4f}, test NLL {summary['nll_test'][0]:.4f}, stability "
          f"{summary['stability'][0]}; launches fwd {fwd} = {steps}*{per_step} + 2*{per_eval} + "
          f"(({T}+1)*{layers}+{layers})*{chunks} chunks, bwd {bwd} = {steps}*{2 * layers}; "
          f"main() {wall:.1f} s", flush=True)

    state = summary["state"]
    init = factory.build_model(state.model.cfg, "cpu", torch.Generator().manual_seed(seed))
    init_sd = init.state_dict()
    trained = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    ema = {k: v.detach().cpu() for k, v in state.ema_model.state_dict().items()}
    moved = {k: float((trained[k] - init_sd[k]).abs().max()) for k in init_sd}
    for prefix in ("dynamics.", "vae.decoder."):
        _check(min(v for k, v in moved.items() if k.startswith(prefix)
                   and not k.endswith("buffer")) > 0, f"some {prefix} weights did not move")
    _check(max(v for k, v in moved.items() if k.startswith("vae.encoder.")) == 0,
           "the encoder moved: its latent is detached and it must get no gradient")
    step_w = max(moved.values())
    step_e = max(float((ema[k] - init_sd[k]).abs().max()) for k in init_sd)
    _check(0 < step_e <= steps * (1 - decay) * step_w * 1.5,
           f"EMA moved {step_e:.3e}, weights {step_w:.3e}: not a (1-{decay})-scale step")
    for name in ("latest", "best"):
        path = os.path.join(tmpdir, "out", "smoke", name)
        for use_ema, want in ((False, trained), (True, ema)):
            model, cfg, _ = load_reference_checkpoint(path, "cuda", use_ema)
            got = model.state_dict()
            _check(set(got) == set(want) and all(torch.equal(got[k].cpu(), want[k]) for k in want),
                   f"checkpoint {name} (ema={use_ema}) does not hold the trained tensors")
    print(f"phase 7: weights moved up to {step_w:.3e} (encoder unchanged), EMA {step_e:.3e} "
          f"(a (1-{decay})-scale step); latest/ and best/ load back through "
          f"load_reference_checkpoint with equal tensors", flush=True)

    # ms per train step: three more steps on a train batch, synchronised.
    from geoldm_tpu_torch.data.qm9 import QM9Loader, load_qm9
    from geoldm_tpu_torch.models.distributions import DistributionNodes

    splits, _ = load_qm9(tmpdir)
    raw = next(iter(QM9Loader(splits["train"], B, info["max_n_nodes"])))
    batch = prepare_batch(raw, DistributionNodes(info.n_nodes), "cuda")
    step = make_train_step(state.model.cfg, decay)
    gen = torch.Generator(device="cuda").manual_seed(7)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    print(f"phase 7: train step B={B} N={info['max_n_nodes']} nf=256 9+9 blocks: "
          f"{', '.join(f'{v:.1f}' for v in times)} ms (host clock around synchronised steps) "
          f"on {card_name}", flush=True)
    return {"fwd_launches": fwd, "bwd_launches": bwd, "chunks": chunks, "losses": losses,
            "nll_val": summary["nll_val"][0], "nll_test": summary["nll_test"][0],
            "stability": summary["stability"][0], "main_seconds": wall,
            "epoch_seconds": summary["epoch_seconds"][0], "step_ms": times}


class _Replay:
    """A noise source replaying one numpy stream: the card and the CPU run
    draw the same numbers in the same order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, shape):
        return self.rng.standard_normal(shape).astype(np.float32)

    def randint(self, low, high, shape):
        return self.rng.integers(low, high, shape)


def phase_grad(card_name):
    import torch

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import synthetic_batch
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.ops import egnn_block
    from geoldm_tpu_torch.train.trainer import prepare_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = get_dataset_info("qm9")
    cfg = factory.make_latent_diffusion_config(info, nf=256, n_layers=9, latent_nf=1,
                                               diffusion_steps=1000, trainable_ae=True)
    nll_fn = factory.model_nll_fn(cfg, training=True)
    raw = synthetic_batch(info, 8, 29, np.random.default_rng(11))
    nodes = DistributionNodes(info.n_nodes)
    grads, losses = {}, {}
    for device in ("cuda", "cpu"):
        model = factory.build_model(cfg, device, torch.Generator().manual_seed(5))
        batch = prepare_batch(raw, nodes, device)
        bwd = egnn_block.bwd_launches
        nll = nll_fn(model, _Replay(12), batch["x"], batch["h_cat"], batch["h_int"],
                     batch["node_mask"])
        loss = (nll - batch["log_pN"]).mean()
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            _check(egnn_block.bwd_launches == bwd + 18, "the card's backward skipped the kernel")
        losses[device] = float(loss.detach())
        grads[device] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                         if p.grad is not None}
    _check(set(grads["cuda"]) == set(grads["cpu"]) and len(grads["cpu"]) > 0,
           "card and CPU gave gradients to different parameters")
    _check(abs(losses["cuda"] - losses["cpu"]) <= _LOSS_RTOL * abs(losses["cpu"]),
           f"loss card {losses['cuda']} vs CPU {losses['cpu']}")
    worst, worst_name = 0.0, ""
    for k, ref in grads["cpu"].items():
        g = grads["cuda"][k]
        _check(bool(torch.isfinite(g).all()), f"gradient of {k} not finite on the card")
        d = float((g - ref).abs().max())
        scale = float(ref.abs().max())
        _check(d <= _GRAD_RTOL * scale, f"gradient of {k}: card vs CPU max|d|={d:.3e} > "
                                        f"{_GRAD_RTOL}*{scale:.3e}")
        rel = d / scale if scale else 0.0
        if rel >= worst:
            worst, worst_name = rel, k
    print(f"phase 8: train-step gradient nf=256 9+9 blocks B=8 N=29: loss card "
          f"{losses['cuda']:.6f} CPU {losses['cpu']:.6f}; {len(grads['cpu'])} parameter "
          f"tensors, worst max|d|/max|ref| {worst:.2e} ({worst_name}; tol {_GRAD_RTOL}) "
          f"on {card_name} vs the plain path on the CPU", flush=True)
    return {"loss_cuda": losses["cuda"], "loss_cpu": losses["cpu"], "worst_rel": worst,
            "worst": worst_name}


def _request(base, path, body=None, timeout=1200):
    if body is None:
        req = urllib.request.Request(base + path)
    else:
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _check_molecules(body, sizes, decoder):
    _check(body["n"] == len(sizes), f"expected {len(sizes)} molecules, got {body['n']}")
    _check([len(m) for m in body["molecules"]] == list(sizes),
           "molecule sizes differ from the request")
    for mol in body["molecules"]:
        for el, *xyz in mol:
            _check(el in decoder, f"unknown element {el!r}")
            _check(bool(np.all(np.isfinite(xyz))), "non-finite coordinate")
    _check(len(body["stable"]) == len(sizes), "missing stability verdicts")


def phase_serve(card_name, tmpdir):
    import torch

    from geoldm_tpu_torch.cli import serve
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.ops import egnn_block
    from geoldm_tpu_torch.train.sampling import DEFAULT_SAMPLE_BUCKETS, n_chunks
    from geoldm_tpu_torch.utils.convert import save_reference_checkpoint

    info = get_dataset_info("qm9")
    cfg = factory.make_latent_diffusion_config(info, nf=256, n_layers=9, latent_nf=1,
                                               diffusion_steps=1000)
    t0 = time.time()
    model = factory.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    save_reference_checkpoint(model, tmpdir)
    del model
    print(f"phase 3: QM9 LDM nf=256 layers=9 latent_nf=1 T=1000, random weights "
          f"(seed 0) written in upstream layout in {time.time() - t0:.1f} s", flush=True)

    batch_max = 64
    server, service = serve.main(["--model_path", tmpdir, "--port", "0",
                                  "--batch_max", str(batch_max)], serve_forever=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    T, layers = cfg.diffusion.timesteps, cfg.dynamics.egnn.n_layers
    dec_layers = cfg.vae.decoder_egnn.n_layers
    decoder = info["atom_decoder"]
    buckets = service.buckets
    try:
        code, health = _request(base, "/health")
        _check(code == 200 and health["status"] == "ok", f"/health -> {code} {health}")
        print(f"phase 4: /health ok, device {health['device']}, buckets {health['buckets']}",
              flush=True)

        # An n_samples request whose sizes span at most two buckets.
        nodes = DistributionNodes(info.n_nodes)
        n_seed = next(s for s in range(100) if len({
            min(b for b in buckets if b >= k)
            for k in nodes.sample(48, np.random.default_rng(s))}) <= 2)
        requests = [("seeded", {"sizes": [12, 14, 16], "seed": 7}),
                    ("n_samples", {"n_samples": 48, "seed": n_seed}),
                    ("replay", {"sizes": [12, 14, 16], "seed": 7})]
        egnn_block.launches = 0
        chunks, stats, bodies = 0, [], {}
        for name, req in requests:
            t1 = time.time()
            code, body = _request(base, "/sample", req)
            dt = time.time() - t1
            _check(code == 200, f"/sample {name} -> {code} {body}")
            sizes = req.get("sizes") or [len(m) for m in body["molecules"]]
            _check_molecules(body, sizes, decoder)
            chunks += n_chunks(sizes, batch_max, DEFAULT_SAMPLE_BUCKETS)
            bodies[name] = body
            stats.append({"request": name, "molecules": body["n"], "seconds": dt,
                          "mol_per_s": body["n"] / dt,
                          "stable": sum(body["stable"])})
            print(f"phase 4: /sample {name}: {body['n']} molecules in {dt:.2f} s "
                  f"({body['n'] / dt:.3f} mol/s, {sum(body['stable'])} stable) "
                  f"on {card_name}", flush=True)
        launches = egnn_block.launches
        _check(bodies["replay"]["molecules"] == bodies["seeded"]["molecules"],
               "seeded replay returned different molecules")
        expected = ((T + 1) * layers + dec_layers) * chunks
        _check(launches == expected,
               f"kernel launches {launches} != (({T}+1)*{layers} + {dec_layers}) * {chunks}"
               f" chunks = {expected}")
        print(f"phase 4: seeded replay identical; kernel launches {launches} = "
              f"(({T}+1)*{layers} + {dec_layers}) * {chunks} chunks", flush=True)

        for bad in ({"sizes": [0]}, {"sizes": [12], "n_steps": 50}):
            code, body = _request(base, "/sample", bad)
            _check(code == 400, f"invalid request {bad} -> {code}, expected 400")
            print(f"phase 4: invalid request {bad} -> 400 ({body['error']})", flush=True)
        code, metrics = _request(base, "/metrics")
        _check(code == 200 and metrics["requests"] == 3 and metrics["errors"] == 2,
               f"/metrics -> {code} {metrics}")
        print(f"phase 4: /metrics {json.dumps(metrics)}", flush=True)
        return launches, chunks, stats, service.model
    finally:
        server.shutdown()
        server.server_close()


def phase_denoiser(model, card_name, B=16, N=32, n_min=20, phase=5):
    import torch

    from geoldm_tpu_torch.ops.com import remove_mean_with_mask

    rng = np.random.default_rng(5)
    n_real = rng.integers(n_min, N + 1, size=B)
    mask = (np.arange(N)[None, :] < n_real[:, None]).astype(np.float32)[..., None]
    feat = 3 + model.cfg.dynamics.in_node_nf
    z = rng.standard_normal((B, N, feat)).astype(np.float32) * mask
    t = rng.uniform(0, 1, size=(B, 1)).astype(np.float32)
    mask_t, z_t = torch.from_numpy(mask), torch.from_numpy(z)
    z_t[:, :, :3] = remove_mean_with_mask(z_t[:, :, :3], mask_t)
    with torch.no_grad():
        out_k = model.dynamics(torch.from_numpy(t).cuda(), z_t.cuda(), mask_t.cuda())
        torch.cuda.synchronize()
        out_k = out_k.cpu()
        out_p = copy.deepcopy(model.dynamics).cpu()(torch.from_numpy(t), z_t, mask_t)
    err = float((out_k - out_p).abs().max())
    scale = max(1.0, float(out_p.abs().max()))
    _check(bool(torch.isfinite(out_k).all()), "denoiser output not finite")
    _check(err <= _DENOISER_RTOL * scale,
           f"denoiser kernel vs plain max|d|={err:.3e} > {_DENOISER_RTOL}*{scale:.3g}")
    layers = model.cfg.dynamics.egnn.n_layers
    print(f"phase {phase}: denoiser nf=256 x{layers} blocks B={B} N={N}: kernels on "
          f"{card_name} vs plain on CPU max|d|={err:.3e} (tol {_DENOISER_RTOL * scale:.2e})",
          flush=True)
    return err


def _geom_block(extra, seed):
    import torch

    from geoldm_tpu_torch.config import EGNNConfig
    from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters

    # The GEOM recipe's block: nf=256, attention, tanh, 'sum' over factor 1.
    cfg = EGNNConfig(in_node_nf=3, out_node_nf=3, hidden_nf=256, n_layers=4, attention=True,
                     normalization_factor=1.0, **extra)
    block = EquivariantBlock(cfg)
    init_parameters(block, torch.Generator().manual_seed(seed))
    return block.to("cuda").eval()


def phase_tiled(card_name):
    import torch

    from geoldm_tpu_torch.ops import egnn_block, egnn_tiled

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    B, H = 16, 256
    cases = [("sum", 96, {}), ("sum", 136, {}), ("sum", 184, {}),
             ("mean", 181, {"aggregation_method": "mean"}), ("sin", 96, {"sin_embedding": True})]
    rows = []
    for case, n, extra in cases:
        block = _geom_block(extra, 200 + n)
        inputs = [_ragged_inputs(4000 * n + rep, B, n, H, dev, spread=16) for rep in range(4)]
        n_real0 = inputs[0][3][:, :, 0].sum(dim=1).cpu().numpy()
        with torch.no_grad():
            # The coordinate stage reads the GCL's output, as in the block.
            stage_inputs = [(egnn_tiled.gcl_rows_plain(block.gcl_0, *a), *a[1:]) for a in inputs]
        stages = [("gcl_rows", block.gcl_0, egnn_tiled.gcl_rows_cuda, egnn_tiled.gcl_rows_plain,
                   inputs),
                  ("coord_rows", block.gcl_equiv, egnn_tiled.coord_rows_cuda,
                   egnn_tiled.coord_rows_plain, stage_inputs)]
        for stage, mod, cuda_fn, plain_fn, ins in stages:
            with torch.no_grad():
                got = cuda_fn(mod, *ins[0])
                want = plain_fn(mod, *ins[0])
                torch.cuda.synchronize()
                _check(bool(torch.isfinite(got).all()), f"{stage} not finite at N={n} {extra}")
                err = float((got - want).abs().max())
                scale = max(1.0, float(want.abs().max()))
                _check(err <= _KERNEL_RTOL * scale,
                       f"{stage} kernel disagrees with plain at N={n} {extra}: max|d|={err:.3e} "
                       f"> {_KERNEL_RTOL}*{scale:.3g}")
                ms = _time_ms(lambda *a, m=mod, f=cuda_fn: f(m, *a), ins)
                plain_ms = _time_ms(lambda *a, m=mod, f=plain_fn: f(m, *a), ins)
            n_weights = sum(p.numel() for p in mod.parameters())
            flops, nbytes = _stage_work(block.cfg, n_real0, n, n_weights, stage == "coord_rows")
            t_ops, t_bytes = flops / _FLOP_PEAK * 1e3, nbytes / _BW_PEAK * 1e3
            row = {"stage": stage, "case": case, "N": n, "B": B, "H": H, "max_abs_err": err,
                   "tol": _KERNEL_RTOL * scale, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "gflop": flops / 1e9, "tflops_achieved": flops / (ms * 1e-3) / 1e12}
            rows.append(row)
            print(f"phase 9: {stage} {case} N={n} B={B} H={H} max|d|={err:.3e} "
                  f"(tol {row['tol']:.2e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms (TF32 off) "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) "
                  f"{row['tflops_achieved']:.2f} TFLOP/s on {card_name}", flush=True)

    # GEOM's buckets 48 and 64 stay on the block kernel: it against its plain
    # version and against the tiled path.
    for n in (48, 64):
        block = _geom_block({}, 300 + n)
        args = _ragged_inputs(5000 + n, B, n, H, dev, spread=16)
        with torch.no_grad():
            h_k, x_k = egnn_block.block_forward_cuda(block, *args)
            h_p, x_p = egnn_block.block_forward_plain(block, *args)
            h_t, x_t = egnn_tiled.tiled_block_forward(block, *args)
        torch.cuda.synchronize()
        scale = max(1.0, float(h_p.abs().max()), float(x_p.abs().max()))
        for what, (h_o, x_o) in (("plain", (h_p, x_p)), ("tiled path", (h_t, x_t))):
            err = max(float((h_k - h_o).abs().max()), float((x_k - x_o).abs().max()))
            _check(err <= _KERNEL_RTOL * scale,
                   f"block kernel vs {what} at N={n}: max|d|={err:.3e} > {_KERNEL_RTOL}*{scale:.3g}")
            print(f"phase 9: egnn_block N={n} B={B} H={H} vs {what} max|d|={err:.3e} "
                  f"(tol {_KERNEL_RTOL * scale:.2e})", flush=True)
    return rows


def phase_geom_serve(card_name, tmpdir):
    import torch

    from geoldm_tpu_torch.cli import serve
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.ops import egnn_block, egnn_tiled
    from geoldm_tpu_torch.train.sampling import chunk_pads
    from geoldm_tpu_torch.utils.convert import save_reference_checkpoint

    info = get_dataset_info("geom")
    cfg = factory.make_latent_diffusion_config(info, nf=256, n_layers=4, latent_nf=2,
                                               include_charges=False, diffusion_steps=1000,
                                               normalization_factor=1.0)
    t0 = time.time()
    model = factory.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    save_reference_checkpoint(model, tmpdir, dataset="geom")
    del model
    print(f"phase 10: GEOM LDM nf=256 layers=4 latent_nf=2 no charges T=1000, random weights "
          f"(seed 0) written in upstream layout (dataset geom) in {time.time() - t0:.1f} s",
          flush=True)

    batch_max = 16
    server, service = serve.main(["--model_path", tmpdir, "--dataset", "geom", "--port", "0",
                                  "--batch_max", str(batch_max)], serve_forever=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    T, layers = cfg.diffusion.timesteps, cfg.dynamics.egnn.n_layers
    per_chunk = (T + 1) * layers + cfg.vae.decoder_egnn.n_layers
    inv = cfg.dynamics.egnn.inv_sublayers
    try:
        code, health = _request(base, "/health")
        _check(code == 200 and health["buckets"] == [32, 48, 64, 96, 136, 184],
               f"/health -> {code} {health}")
        print(f"phase 10: /health ok, dataset {health['dataset']}, device {health['device']}, "
              f"buckets {health['buckets']}", flush=True)
        sizes = [25, 40, 60, 90, 130, 181]
        requests = [("seeded", {"sizes": sizes, "seed": 7}),
                    ("replay", {"sizes": sizes, "seed": 7}),
                    ("n_samples", {"n_samples": 24, "seed": 3})]
        egnn_block.launches = egnn_tiled.gcl_rows_launches = egnn_tiled.coord_rows_launches = 0
        pads, stats, bodies = [], [], {}
        for name, req in requests:
            t1 = time.time()
            code, body = _request(base, "/sample", req)
            dt = time.time() - t1
            _check(code == 200, f"/sample {name} -> {code} {body}")
            got_sizes = req.get("sizes") or [len(m) for m in body["molecules"]]
            _check_molecules(body, got_sizes, info["atom_decoder"])
            req_pads = chunk_pads(got_sizes, batch_max, service.buckets)
            pads += req_pads
            bodies[name] = body
            stats.append({"request": name, "molecules": body["n"], "seconds": dt,
                          "mol_per_s": body["n"] / dt, "chunk_pads": req_pads,
                          "stable": sum(body["stable"])})
            print(f"phase 10: /sample {name}: {body['n']} molecules (sizes {sorted(got_sizes)}) "
                  f"in {dt:.2f} s ({body['n'] / dt:.3f} mol/s, {sum(body['stable'])} stable; "
                  f"chunk pads {req_pads}) on {card_name}", flush=True)
        launches = {"egnn_block": egnn_block.launches, "gcl_rows": egnn_tiled.gcl_rows_launches,
                    "coord_rows": egnn_tiled.coord_rows_launches}
        _check(bodies["replay"]["molecules"] == bodies["seeded"]["molecules"]
               and bodies["replay"]["stable"] == bodies["seeded"]["stable"],
               "seeded replay returned different molecules")
        small = sum(1 for p in pads if p <= egnn_block.MAX_NODES)
        large = len(pads) - small
        expected = {"egnn_block": per_chunk * small, "gcl_rows": per_chunk * inv * large,
                    "coord_rows": per_chunk * large}
        _check(launches == expected and large > 0 and small > 0,
               f"launches {launches} != {expected} ({per_chunk} per chunk; {small} chunks "
               f"padded to <= 64, {large} past 64)")
        print(f"phase 10: seeded replay identical; launches {json.dumps(launches)} = {per_chunk} "
              f"per chunk x ({small} chunks padded to <= 64 | {large} past 64)", flush=True)
        code, body = _request(base, "/sample", {"sizes": [40, 182]})
        _check(code == 400, f"size 182 -> {code}, expected 400")
        print(f"phase 10: invalid request sizes [40, 182] -> 400 ({body['error']})", flush=True)
        return launches, stats, service.model
    finally:
        server.shutdown()
        server.server_close()


def phase_geom_denoiser(model, card_name):
    import torch

    err = phase_denoiser(model, card_name, B=2, N=184, n_min=150, phase=11)
    n = 184
    mask = torch.ones((1, n, 1), device="cuda")
    z = torch.randn((1, n, 5), device="cuda") * mask
    t = torch.full((1, 1), 0.5, device="cuda")
    with torch.enable_grad():
        try:
            model.dynamics(t, z, mask)
        except NotImplementedError as e:
            print(f"phase 11: a GEOM block past 64 nodes under grad on the card raises "
                  f"NotImplementedError ({str(e)[:80]}...)", flush=True)
        else:
            raise SmokeFailure("a block past 64 nodes ran under grad on the card without "
                               "the tiled backward")
    return err


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from geoldm_tpu_torch.ops import cuda_build

    t_start = time.time()
    card = _card_line()
    card_name = torch.cuda.get_device_name(0)
    _check(_H100_SXM in card, f"bound_ms uses the H100 SXM's data-sheet peaks; "
                              f"nvidia-smi names another card: {card}")
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} on {card}",
          flush=True)
    cuda_build.library("egnn_block")
    info = cuda_build.build_info
    for name, lib in info["libs"].items():
        regs = [ln.strip() for ln in lib["log"].splitlines() if "registers" in ln or "spill" in ln]
        print(f"phase 1: {name}: {lib['path']}; ptxas: {' | '.join(regs)}", flush=True)
    print(f"phase 1: built {len(info['libs'])} kernel libraries with nvcc (sm_90a, in parallel) "
          f"in {info['seconds']:.1f} s{' (cached)' if info.get('cached') else ''}", flush=True)

    rows = phase_kernel(card_name)
    with tempfile.TemporaryDirectory() as tmpdir:
        launches, chunks, serve_stats, model = phase_serve(card_name, tmpdir)
    phase_denoiser(model, card_name)
    del model
    bwd_rows = phase_backward(card_name)
    with tempfile.TemporaryDirectory() as tmpdir:
        train = phase_train(card_name, tmpdir)
    grad = phase_grad(card_name)
    tiled_rows = phase_tiled(card_name)
    with tempfile.TemporaryDirectory() as tmpdir:
        geom_launches, geom_stats, model = phase_geom_serve(card_name, tmpdir)
    geom_err = phase_geom_denoiser(model, card_name)
    del model

    main_row = next(r for r in rows if r["case"] == "sum" and r["N"] == 32)
    bwd_row = next(r for r in bwd_rows if r["case"] == "sum" and r["N"] == 29)
    print("details: " + json.dumps({
        "shapes": rows, "serving": serve_stats, "chunks": chunks, "backward": bwd_rows,
        "training": train, "grad": grad, "tiled": tiled_rows, "geom_serving": geom_stats,
        "geom_denoiser_max_abs_err": geom_err,
        "fwd_launches": {"serving": launches, "training": train["fwd_launches"],
                         "geom_serving": geom_launches},
        "seconds": time.time() - t_start}), flush=True)

    def tiled_entry(stage, name, line):
        main = next(r for r in tiled_rows
                    if r["stage"] == stage and r["case"] == "sum" and r["N"] == 184)
        return {"name": name, "route": "cuda", "source": "geoldm_tpu_torch/csrc/egnn_tiled.cu",
                "replaces": f"geoldm_tpu/ops/pallas_egnn_tiled.py:{line}",
                "launches": geom_launches[stage],
                "max_abs_err": max(r["max_abs_err"] for r in tiled_rows if r["stage"] == stage),
                "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None}

    report = {"kernels": [{
        "name": "egnn_block_fwd", "route": "cuda",
        "source": "geoldm_tpu_torch/csrc/egnn_block.cu",
        "replaces": "geoldm_tpu/ops/pallas_egnn.py:232",
        "launches": launches + train["fwd_launches"] + geom_launches["egnn_block"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,
    }, {
        "name": "egnn_block_bwd", "route": "cuda",
        "source": "geoldm_tpu_torch/csrc/egnn_block_bwd.cu",
        "replaces": "geoldm_tpu/ops/pallas_egnn.py:255",
        "launches": train["bwd_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        "ms": bwd_row["ms"], "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"], "bound_by": bwd_row["bound_by"],
        "library_ms": None,
    }, tiled_entry("gcl_rows", "egnn_gcl_rows", 152),
        tiled_entry("coord_rows", "egnn_coord_rows", 166)]}
    print(json.dumps(report), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
