"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py            # all phases, one card

Phases (each prints a line; any failure exits non-zero before the result):
  1. the card's name and power limit (nvidia-smi), and the kernel build
     (one nvcc per source in geoldm_tpu_torch/csrc, for sm_90a, in parallel),
     with ptxas' registers and spills of the grids on the tensor-core tile
     and of the tensor-core GEMMs: the whole-block kernels' own, the
     row-tiled forward grid in each of the three libraries that build it and
     the row-tiled backward grid in the two that build it, and each
     library's node GEMM variants and split-K sum (none may spill);
  2. the EquivariantBlock kernel against its plain PyTorch version on the
     card at H=256, B=64, N in {16, 24, 29, 32} with ragged masks, plus one
     'mean'-aggregation and one sin-embedding case, and at GEOM's pads B=32,
     N in {48, 64}, with times and bounds (f32, and with the matrix products
     at the split-TF32 rate of the tensor cores);
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
     (autograd of the recomputed block) at H=256, B=64, N in {16, 17, 24,
     29, 32, 33} with ragged masks, plus one 'mean' and one sin-embedding
     case, and at GEOM's training pads B=32, N in {48, 64}: dh, dx, dx0 and
     every weight gradient, with times and bounds; the backward from the
     forward's saved activations (the training route) and a second run must
     equal it bit for bit;
  7. the training entry point (cli.main_qm9) at the reference recipe (nf=256,
     9 layers, latent_nf=1, T=1000, B=64, trainable_ae, EMA 0.9999) on
     fabricated QM9-format splits: 5 train steps, stability sampling, valid
     and test NLL and the checkpoints; the kernels' launch counts must equal
     what the code implies, and the checkpoint must load back; peak device
     memory is printed;
  8. one full-width train-step gradient (B=8, N=29) through the kernels on the
     card against the plain path on the CPU, same weights, batch and noise;
  9. the row-tiled GCL (#3) and coordinate (#4) kernels against their plain
     versions on the card at H=256, B=16, N in {96, 136, 184} with ragged
     masks (n-16..n atoms), plus one 'mean' case at N=181 and one
     sin-embedding case at N=96, with times and per-stage bounds (f32, and
     with the edge W2 product at the split-TF32 rate of the tensor cores);
     and the block kernel against its plain version and the tiled path at
     N=48, 64;
 10. a GEOM-Drugs latent-diffusion model at the recipe (nf=256, 4 layers,
     latent_nf=2, no charges, T=1000, random weights from seed 0) written
     with dataset "geom" and served with --dataset geom --batch_max 16: a
     seeded request with one molecule in each bucket, its replay, 24 sizes
     drawn from the GEOM histogram and an invalid request; per chunk the
     launch counts must be 4008 = (T+1)*4 + 4 of the block kernel (pad <= 64)
     or of each of #3 and #4 (pad > 64);
 11. one GEOM denoiser evaluation (4 blocks, B=2, N=184) through the tiled
     kernels against the plain path on the CPU, and the same denoiser under
     grad on the card: every weight gets a gradient through kernel #5;
 12. the row-tiled stage backward (#5) against its plain version (autograd of
     the plain stage) in float64, and in f32 where that is itself within a
     tenth of the gate of float64, for the GCL and the coordinate stage at H=256,
     B=32, N in {80, 104, 128, 184} (GEOM's training buckets past 64) with ragged
     masks (n-16..n atoms), plus one 'mean' case at N=181 and one
     sin-embedding case at N=80: dh, dx, dx0 and every weight gradient, with
     times and per-stage bounds (f32, and with the edge and node products at
     the split-TF32 rate); the GCL stage's backward from the node chain its
     forward kept (the training route) must equal its own recompute bit for
     bit, and is timed too;
 13. the GEOM training entry point (cli.main_geom_drugs) at the recipe
     (nf=256, 4 layers, latent_nf=2, no charges, T=1000, B=32, trainable_ae,
     EMA 0.9999, lr 5e-5) on a fabricated conformer file whose train split
     holds one full batch at pads 184, 104 and 48: one epoch, stability
     sampling, valid and test NLL and the checkpoints; the launch counts of
     kernels #1-#5 must equal what the code implies, and train steps are
     timed at pads 184 and 48; peak device memory is printed;
 14. one full-width GEOM train-step gradient (4+4 blocks, B=2, pad 184,
     molecules of 181 and 151 atoms) through the kernels on the card against
     the plain path on the CPU, same weights, batch and noise;
 15. the sequence-parallel (SP) slab kernels, forward (#6, B=16) and backward
     (#7, B=32), against their plain versions on the card at H=256 with
     attention: N=184 split over 2 ranks (slabs at rows 0 and 92), a padded
     split (181 atoms padded to 184 over 4 ranks, 'mean' over 181), one
     sin-embedding case, and the SP epoch's pads 48 and 64 over 2 ranks at
     B=32 in both directions; every output within 1e-4*max(1, max|ref|),
     weight gradients included, with times and per-slab bounds (also with
     the products the kernels run on the tensor cores at the split-TF32
     rate); #7 from the node chain #6 kept must equal its own recompute bit
     for bit;
 16. the GEOM training entry point with --sp 2 at the recipe (as phase 13)
     on a fabricated conformer file with one full batch at pads 184 and 48:
     two ranks share the card over gloo (the placement rule is printed); one
     epoch, valid/test NLL through SP, 4 stability samples on the single-
     device route; each rank's launch counts of #1-#7 must equal what the
     code implies, and the ranks' train states must be bit-identical;
 17. one SP-2 train step on the card (4+4 blocks, B=2, pad 184, 181 and 151
     atoms) against the same step on one rank without SP: loss within 1e-5
     relative, every gradient within 1e-3*max|ref|; the same ranks then time
     SP train steps at the recipe's B=32, pads 184 and 48;
 18. resume and first stage: phase 7's run resumed at epoch 1 through
     cli.main_qm9 --resume --data_augmentation True --prefetch 2 (the state
     it loaded must equal latest/ tensor for tensor: model, EMA, AdamW, the
     clip's ring buffer and the step; exact #1/#2 launches; metrics.jsonl
     holds epoch 1's keys); a full-width first-stage VAE trained for 5 steps,
     then a latent diffusion started from it with --ae_path and the first
     stage frozen, whose vae must equal the VAE's EMA weights bit for bit;
     and phase 13's GEOM run resumed for one augmented batch at pad 184
     (exact #3-#5 launches);
 19. cli.eval_analyze on phase 18's QM9 checkpoint and phase 7's splits: 36
     molecules at T=1000, stability on the native C++ batch (its counts equal
     the Python path's), the validity/uniqueness/novelty triple in [0, 1],
     the packed NLL on valid and 5 test passes (exact #1 launches),
     eval_log.txt; and the packed NLL of 8 test molecules on the card against
     the CPU with the same draws, within 2e-4 * max(1, |ref|);
 20. cli.eval_analyze --dataset geom on phase 13's checkpoint with a
     conformer file whose valid and test molecules reach 181 atoms: the
     packed NLL at pad 184 (exact #3/#4 launches), 2 generated molecules (at
     most two buckets);
 21. the bf16 variants of #1 (QM9's pads 16/24/32 at B=64, GEOM's 48/64 at
     B=32) and of #3/#4 (N=96/136/184, B=16) against their plain bf16
     versions on the card at H=256, within 5e-3 * max(1, max|ref|) and on
     the mean at least 10x closer to them than to the plain f32 versions,
     with times,
     bounds (every product on bf16 operands at the dense bf16 rate) and the
     f32 kernel's time at the same shape;
 22. cli.serve at the QM9 recipe with its default compute dtype
     (bfloat16_mixed): a DDIM request (50 steps, eta 0), a DPM-Solver++(2M)
     request (20 steps), a clip_z request and a dense request, each with
     its mol/s and its launches of the bf16 and the f32 kernel, which must
     equal K - round(0.1 K) steps (plus the decoder) in bf16 and the rest
     plus the final step in f32, block for block; the GEOM recipe served at
     pad 96 in bf16 (#3/#4's variants); cli.eval_analyze --n_steps 50 on
     phase 18's checkpoint (exact launches). Phases 4 and 10 serve in
     float32: the dense f32 path;
 23. the bf16 backward kernels against their plain bf16 backwards (autograd
     of the plain bf16 forward) on the card at H=256: #2 at QM9's pads
     16/24/29/32 (B=64) and GEOM's 48/64 (B=32), #5's GCL and coordinate
     stages at N=96/136/184 (B=32), #6 (B=16) and #7 (B=32) on both slabs of
     N=184 over 2 ranks and of N=48/64; every output within 5e-3 *
     max(1, max|ref|) (a weight gradient's one-step bf16 rounding flips
     counted apart), on the mean 10x closer to the plain bf16 version than to
     the plain f32 one and to one that rounds each product's cotangent; the
     training routes and a replay bit-identical; with times, the f32
     kernel's and plain times and bounds (every product at the bf16 rate);
 24. bf16 training through the CLIs at the recipes: 5 QM9 steps
     (cli.main_qm9 --compute_dtype bfloat16_pallas) and one GEOM step at pad
     184 (cli.main_geom_drugs --compute_dtype bfloat16), each with its test
     epoch in bf16; launches exact, every one a bf16 kernel; finite; the EMA
     moved; then the bf16 train-step gradient on the card against the plain
     bf16 step on the CPU (QM9 and GEOM, as phases 8 and 14);
 25. bf16 training under --sp 2 on one card: cli.main_geom_drugs --sp 2
     --compute_dtype bfloat16 at phase 16's recipe (two ranks sharing the
     card over gloo; launches exact per rank, every one a bf16 kernel), then
     an SP-2 bf16 train step (#6/#7 bf16 on both slabs) against the one-rank
     bf16 step;
 26. conditional QM9 at the README's conditional recipe (nf=192, 9 layers,
     latent_nf=1, normalize_factors [1, 8, 1], T=1000, alpha, --context_dropout
     0.1, qm9_second_half) on fabricated splits: (a) #1 and #2, f32 and bf16,
     at H=192 (64 masked channels in the tile) against their plain versions,
     B=64, N in {16, 29}, with times and bounds; (b) 5 steps through
     cli.main_qm9 --conditioning alpha with 50-jump stability samples, valid
     and test NLL and the checkpoints (launches exact; args.pickle holds
     conditioning ['alpha'] and context_indicator True; the checkpoints load
     back); (c) the conditional train-step gradient (B=8, N=29, a fixed keep
     mask) card vs CPU within 1e-3*max|ref|; (d) the property classifier
     (nf=128, 7 layers) for one epoch through cli.main_qm9_prop; (e)
     cli.eval_conditional_qm9 --task edm --cfg_scale 2 --clip_z 15 on (b)'s
     and (d)'s checkpoints, (T+1)*2*9 + 9 launches of #1; (f) cli.serve on
     (b)'s checkpoint with --datadir and --conditioning alpha: a seeded
     properties request and its replay, a cfg_scale 2 request, a dense
     request without properties and a misnamed property (400), launches
     exact per request;
 27. data parallelism: cli.main_qm9 --dp 2 at the QM9 recipe (nf=256, 9
     layers, T=1000, B=64 global, 32 a rank), 3 steps, two ranks sharing
     the card over gloo: the replicas' train states bit-identical, each
     rank's #1/#2 launches exact (one rank's per step; chunk i of the
     stability samples on rank i % 2); then phase 8's gradient over DP-2
     against one rank on the card within 1e-3*max|ref|, and timed DP-2
     recipe steps and the data ranks' gradient mean alone;
 28. DP x SP: cli.main_geom_drugs --dp 2 --sp 2 at the GEOM recipe, four
     ranks on the card (data index r // 2, seq index r % 2), one step of 32
     molecules at pad 184: replicas bit-identical, #6/#7 launches per rank
     phase 16's per step; phase 17's gradient over the 2x2 grid against one
     rank within 1e-3*max|ref|; timed steps, the SP sum and the DP mean;
 29. conditioning under SP: (a) #6/#7 at the conditional recipe's H=192,
     N=29 padded to 30 over S=2, B=64, against their plain versions within
     1e-4*max(1, max|ref|), weight gradients included, with times and
     bounds; (b) cli.main_qm9 at the conditional recipe with --sp 2, 2 steps
     (launches exact, replicas bit-identical); (c) phase 26's conditional
     gradient over SP-2 against one rank within 1e-3*max|ref|;
 30. cli.eval_analyze --dp 2 on phase 18's checkpoint against --dp 1: 12
     molecules with 20 DDIM jumps bit-identical, the packed NLLs (valid and 2
     test passes) within 1e-5 relative, each rank's #1 launches exact;
 31. the plain E(n) diffusion model (kind 'diffusion', EDM) at
     make_diffusion_model_config's defaults, EDM's QM9 command (nf 256, 9
     layers, T 1000, polynomial_2, l2, normalize [1, 4, 10]), random
     weights: (a) 3 train steps (AMSGrad, clip, EMA) at B=64, N=29 with 9 #1
     and 9 #2 launches a step, and the train-step gradient card vs CPU
     within 1e-3*max|ref|; (b) the t0_always NLL card vs CPU; (c) one dense
     T=1000 chunk of 16 molecules, one-hot types, integer charges, exactly
     (T+1)*9 #1 launches; (d) a seeded cli.serve request on the saved
     checkpoint and its replay, bit for bit, launches exact;
 32. the learned noise schedule: cli.main_qm9 --train_diffusion
     --trainable_ae --diffusion_noise_schedule learned --diffusion_loss_type
     vlb at the reference width (3 steps, a test epoch, 50-jump stability
     samples; launches exact); the saved model's gamma(0) = gamma_0, gamma(1)
     = gamma_1, gamma increasing; --resume for one more epoch; cli.serve
     answering a K=50 DDIM and a dense request (launches exact); the
     train-step gradient card vs CPU (gamma_0 and gamma_1 within the gate,
     the gamma network's f32-noise-dominated layers finite);
 33. --model gnn_dynamics through cli.main_qm9 at the reference width (3
     steps, a test epoch): #1/#2 launched by the VAE alone, exactly; the
     train-step gradient card vs CPU; one dense T=1000 chunk whose 9 #1
     launches are the decoder's;
 34. cli.serve at the QM9 recipe with its default bfloat16_mixed and its
     warm-up (one 6-step dispatch of --batch_max molecules per bucket, its
     last step and final step f32: #1 at pads 16/24/32 in bf16 and f32,
     launches exact, no counter moved; its seconds printed); a first and a second request of 4 molecules at K=50
     DDIM; 8 unseeded requests of 4 served one after another and at once
     (mol/s of each), and with the first dispatch held until the rest queue:
     2 dispatches, 7 responses "coalesced" with no seed, each its own
     molecules; launches exact per dispatch; then a GEOM recipe server whose
     warm-up runs #1 at pads up to 64 and #3/#4 past them;
 35. cli.bench_train at its defaults in float32 and bfloat16: its JSON line,
     #1/#2 (or their bf16 variants) launched exactly 19/18 times a step, and
     MFU from utils.flops against the card's name;
 36. rendering: whether matplotlib and imageio import is printed first.
     With them cli.main_qm9 --visualize True, cli.eval_sample --render True
     and cli.eval_conditional_qm9 --task qualitative; without them each
     exits naming the missing packages (checked) and the same xyz files are
     written on the card through the functions the flags call
     (common.visualize_epoch(render=False), eval_sample without --render,
     eval_conditional_qm9.write_sweep): a QM9-recipe chain and 9 molecules,
     eval_sample and the property sweep at nf=192 (#1 at H=192), launches
     exact;
 37. GEOM data: a crude msgpack dump written by the port's own encoder,
     extracted by cli.build_geom_dataset with the native C++ extractor
     (asserted; the Python extractor's rows equal where msgpack imports),
     loaded by data.geom, and one GEOM recipe train step (B=32, pad 64) on it
     with exact launches;
 38. the low-precision edge chain (GEOLDM_PALLAS_EDGE_LOWP=1 under
     bfloat16_pallas): (a) the low-precision #1/#2 against their plain
     versions at QM9's pads 16/24/29/32 (B=64, H=256) and H=192 N=29, the
     saving forward and #2 from its saved chain, its recompute and a replay
     bit-identical; (b) their CUDA-event times and the bf16 #1/#2's in turns;
     (c) cli.main_qm9 at the QM9 recipe under bfloat16_pallas with the
     variable: only the low-precision kernels, 19 and 18 a step, and the
     step time with and without the variable in turns; (d) the same run
     under bfloat16 with the variable: only the bf16 kernels;
 39. QM9 preparation on the card: raw GDB9 files fabricated (nothing
     fetched), cli.main_qm9 --force_download --trace DIR
     --visualize_every_batch 100 for one epoch: the splits rebuilt, and the
     epoch's torch.profiler trace holding #1/#2's edge tile as GPU kernel
     events;
 40. tensor parallelism, two model ranks sharing the card over gloo: (a)
     cli.main_qm9 --tp 2 at the QM9 recipe (nf=256, 9 layers, T=1000, B=64,
     EMA 0.9999) resumed from phase 7's --tp 1 checkpoint (the loaded state
     equal to its files tensor for tensor), 3 steps and one eval with
     50-jump stability samples: launches per rank one rank's run (every
     model rank runs every step, eval batch and chunk), the gathered train
     states bit-identical, each rank's AMSGrad and EMA elements the
     replicated count plus the sharded count over 2, latest/ one rank's five
     files; (b) the QM9 recipe's train
     step (B=8, N=29) over TP-2 and DP-2 x TP-2 against one rank on the
     card, f32 (1e-3*max|ref|) and bf16 (1e-2*max|ref|): loss, gradient norm
     (no factor of T), every gradient and the weights' moves, and timed TP
     steps, the shards' gather alone and the one-rank step; (c) (a)'s
     checkpoint resumed under --tp 1, the loaded state equal to its files;
     (d)
     cli.main_geom_drugs --tp 2 at the GEOM recipe, one step at pad 184
     (#3/#4/#5 on each rank), launches exact.
 41. The fused optimizer step (ops.fused_optim: the clip's norm and
     threshold, AMSGrad and the EMA in three launches) against its plain
     version at the QM9 recipe's 301 parameters (the encoder's 23 without a
     gradient), timed in turns with CUDA events, its kernels' device time
     against the bytes they move; every tensor within 1e-6 of the plain
     version's; each step's norm, a step that trips the clip, the ring
     buffer and its counters within 1e-6 of the clip's arithmetic in
     float64.
     The training paths of phases 7, 13, 16, 24, 25, 27-29, 32, 33, 35, 38
     and 40 each check one launch of each of its kernels a train step (on
     each rank); the kernels line counts them.
 42. The node GEMM alone (csrc/egnn_tc_gemm.cuh, through the library's
     egnn_node_gemm) at the main path's shapes: the QM9 recipe's f32
     products (M = 1856, N = 256: the projection pair, [h, agg] Wn1 and Wn2
     with their epilogues, an input gradient through W1's unaligned rows;
     the weight gradients 256 x 256 over K = 1856, alone and as a pair), the
     GEOM bf16 forward (M = 100 N at N 32 / 48 / 64) and #5's pad-184 weight
     gradients (K = 32 * 184); each against a float64 product and timed
     with CUDA events beside its bound, max(3 FLOP / 495 TFLOP/s, bytes /
     3.35 TB/s), bf16 FLOP at 989.

A stall is not silent: past _STALL_SECONDS every thread's stack is written
to standard error (the run goes on).

The line before the last is one JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Needs torch with CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import faulthandler
import json
import math
import os
import re
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
# Dense TF32 on the tensor cores, where the whole-block kernels (#1, #2) and
# the row-tiled grids (#3, #4, #6 forward, #5, #7 backward) run their
# products in split TF32: three TF32 products for each f32 product.
_TF32_PEAK, _TF32_SPLITS = 495.0e12, 3

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
    """(FLOP, bytes, matrix-product FLOP) one block forward needs for
    molecules of n_real atoms padded to n_pad: the edge MLPs over real
    ordered pairs, the node-side products over real nodes, each input read
    and each output written once. The last is the share of FLOP in matrix
    products (W2 per pair, the src/dst projections and the node MLP per
    node), which kernel #1 runs on the tensor cores."""
    H, E = cfg.hidden_nf, cfg.edge_feat_nf
    pairs = float(np.sum(n_real * (n_real - 1)))
    nodes = float(np.sum(n_real))
    edge_stage = pairs * (2 * E * H + 2 * H * H + 2 * H)  # first-layer edge term, W2, wa/w3
    gcl = edge_stage + nodes * (2 * 2 * H * H + 2 * 2 * H * H + 2 * H * H)  # src/dst, node MLP
    coord = edge_stage + nodes * (2 * 2 * H * H)
    flops = cfg.inv_sublayers * gcl + coord
    tc = (cfg.inv_sublayers + 1) * pairs * 2 * H * H + nodes * (
        cfg.inv_sublayers * 10 * H * H + 4 * H * H)
    b = len(n_real)
    nbytes = 4 * (b * n_pad * (2 * H + 3 * 3 + 1) + n_weights)
    return flops, nbytes, tc


def _bwd_work(cfg, n_real, n_pad, n_weights):
    """(FLOP, bytes) one block backward needs: the forward it recomputes, then
    per edge stage the W2 input gradient and weight gradient (2 * 2H^2 per
    real pair) plus the edge-feature, gate and scale terms, and per real node
    the src/dst and node-MLP input and weight gradients; each input (h, x,
    x0, mask, the cotangents, the weights) read once and each output (dh, dx,
    dx0, the weight gradients) written once."""
    H, E = cfg.hidden_nf, cfg.edge_feat_nf
    fwd_flops, _, fwd_tc = _block_work(cfg, n_real, n_pad, n_weights)
    pairs = float(np.sum(n_real * (n_real - 1)))
    nodes = float(np.sum(n_real))
    edge_stage = pairs * (4 * H * H + 4 * E * H + 4 * H)
    gcl = edge_stage + nodes * (8 * H * H + 12 * H * H)  # src/dst, node MLP
    coord = edge_stage + nodes * 8 * H * H
    flops = fwd_flops + cfg.inv_sublayers * gcl + coord
    tc = fwd_tc + (cfg.inv_sublayers + 1) * pairs * 4 * H * H + nodes * (
        cfg.inv_sublayers * 20 * H * H + 8 * H * H)
    b = len(n_real)
    nbytes = 4 * (b * n_pad * (3 * H + 5 * 3 + 1) + 2 * n_weights)
    return flops, nbytes, tc


def _bounds(flops, nbytes, tc):
    """(bound ms, what bounds it, bound ms as the tile kernels run it): the
    f32 bound is the larger of all FLOP at the f32 rate and the bytes at the
    memory rate; the second puts the ``tc`` FLOP of the matrix products the
    kernel runs on the tensor cores there, _TF32_SPLITS TF32 products each,
    and the rest at f32."""
    t_ops, t_bytes = flops / _FLOP_PEAK * 1e3, nbytes / _BW_PEAK * 1e3
    t_tc = (_TF32_SPLITS * tc / _TF32_PEAK + (flops - tc) / _FLOP_PEAK) * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", max(t_tc, t_bytes)


def _stage_work(cfg, n_real, n_pad, n_weights, coord):
    """(FLOP, bytes, W2 FLOP) one row-tiled stage needs: the edge MLP over
    real ordered pairs and the node-side products over real nodes (the two
    halves of ``_block_work``'s per-stage terms); h, x, x0 and the mask read
    once, the stage's output (h, or x for the coordinate stage) and its
    weights once. The last is the share #3/#4 run on the tensor cores: the
    edge W2 product and the node products (projections, node MLP)."""
    H, E = cfg.hidden_nf, cfg.edge_feat_nf
    pairs = float(np.sum(n_real * (n_real - 1)))
    nodes = float(np.sum(n_real))
    node = nodes * (2 * 2 * H * H) if coord else nodes * (2 * 2 * H * H + 2 * 2 * H * H + 2 * H * H)
    flops = pairs * (2 * E * H + 2 * H * H + 2 * H) + node
    b = len(n_real)
    nbytes = 4 * (b * n_pad * (H + 3 + 3 + 1 + (3 if coord else H)) + n_weights)
    return flops, nbytes, pairs * 2 * H * H + node


def _stage_bwd_work(cfg, n_real, n_pad, n_weights, coord):
    """(FLOP, bytes, tensor-core FLOP) one row-tiled stage backward (#5)
    needs: the stage's forward it recomputes (``_stage_work``), then per real
    ordered pair the W2 input and weight gradients (2 * 2H^2) plus the
    edge-feature, gate and scale terms, and per real node the src/dst (and
    for a GCL the node-MLP) input and weight gradients (``_bwd_work``'s
    per-stage terms); h, x, x0, the mask, the cotangent and the weights read
    once, dh, dx, dx0 and the weight gradients written once. The last is the
    share #5 runs on the tensor cores: the three edge products per real pair
    (the second layer rebuilt, d(mm) W2, the W2 gradient: 3 * 2H^2), the
    backward's node products (8H^2 or 20H^2 per real node) and the
    recomputed forward's (``_stage_work``'s)."""
    H, E = cfg.hidden_nf, cfg.edge_feat_nf
    fwd_flops, _, fwd_tc = _stage_work(cfg, n_real, n_pad, n_weights, coord)
    pairs = float(np.sum(n_real * (n_real - 1)))
    nodes = float(np.sum(n_real))
    node_bwd = nodes * (8 * H * H if coord else 20 * H * H)
    flops = fwd_flops + pairs * (4 * H * H + 4 * E * H + 4 * H) + node_bwd
    b = len(n_real)
    nbytes = 4 * (b * n_pad * (H + 3 + 3 + 1 + (3 if coord else H) + H + 3 + 3) + 2 * n_weights)
    return flops, nbytes, fwd_tc + pairs * 4 * H * H + node_bwd


# The grids on egnn_tile.cuh's tensor-core tile and the tensor-core GEMMs,
# by mangled-name substring (templates <HP, COORD>): the whole-block kernels'
# (csrc/egnn_block_tile.cuh, egnn_block_bwd.cu), the row-tiled forward grid
# (egnn_rows.cuh), which the libraries of #3/#4, #5 and #6/#7 each build, the
# row-tiled backward grid (egnn_rows_bwd.cuh) in those of #5 and #7, and the
# GEMMs of egnn_tc_gemm.cuh.
_TILE_KERNELS = ("edge_tile_bwd_kernel", "edge_tile_kernel", "node_gemm_tc_kernel",
                 "splitk_reduce_kernel", "wgrad_tc_kernel", "column_sum_kernel",
                 "rows_tile_kernel", "rows_bwd_tile_kernel")
# Library -> the instantiations (HP x COORD x BF16: every library builds the
# bf16 variants of its grids) of the forward and the backward row grid it
# must hold.
_ROW_GRIDS = {"egnn_tiled": (16, 0), "egnn_tiled_bwd": (8, 16), "egnn_sp": (16, 16)}
# Library -> the node GEMM's instantiations (BF16, GRAD16) it must hold: the
# f32 forward (and the recomputes of #2/#5/#7) and backward <0, 0>, the bf16
# forward (and its recomputes) <1, 0>, the bf16 backward's products <0, 1>.
_NODE_GEMMS = {"egnn_block": {(0, 0), (1, 0)}, "egnn_block_bwd": {(0, 0), (1, 0), (0, 1)},
               "egnn_block_lowp": {(1, 0)}, "egnn_block_bwd_lowp": {(1, 0), (0, 1)},
               "egnn_tiled": {(0, 0), (1, 0)}, "egnn_tiled_bwd": {(0, 0), (1, 0), (0, 1)},
               "egnn_sp": {(0, 0), (1, 0), (0, 1)}}


def _ptxas_kernels(log):
    """Per compiled entry of an nvcc -Xptxas -v log: its name (for the
    grids of ``_TILE_KERNELS``, else None), registers and spill bytes."""
    import re

    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            mangled = m.group(1)
            name = next((k for k in _TILE_KERNELS if k in mangled), None)
            t = re.search(r"ILi(\d+)ELb([01])E(?:Lb([01])E)?(?:Lb([01])E)?", mangled)
            gemm = re.search(r"node_gemm_tc_kernelILb([01])ELb([01])E", mangled)
            if name and t:
                name += (f"<HP={t.group(1)}, COORD={t.group(2)}, BF16={t.group(3) or 0}"
                         f"{', LOWP=1' if t.group(4) == '1' else ''}>")
            elif gemm:
                name += f"<BF16={gemm.group(1)}, GRAD16={gemm.group(2)}>"
            out.append({"name": name})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[-1]["spill_stores"], out[-1]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[-1]["registers"] = int(m.group(1))
    return out


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
    H = 256
    # (case, N, B, ragged spread): QM9's pads at B=64, GEOM's 48 and 64 at B=32.
    cases = [
        ("sum", 16, 64, 8, {}), ("sum", 24, 64, 8, {}), ("sum", 29, 64, 8, {}),
        ("sum", 32, 64, 8, {}), ("mean", 32, 64, 8, {"aggregation_method": "mean"}),
        ("sin", 24, 64, 8, {"sin_embedding": True}), ("sum", 48, 32, 16, {}),
        ("sum", 64, 32, 16, {}),
    ]
    rows = []
    for case, n, B, spread, extra in cases:
        cfg = EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=H, n_layers=9,
                         attention=True, normalization_factor=1.0, **extra)
        gen = torch.Generator().manual_seed(n)
        block = EquivariantBlock(cfg)
        init_parameters(block, gen)
        block = block.to(dev).eval()
        n_weights = sum(p.numel() for p in block.parameters())
        inputs = [_ragged_inputs(1000 * n + rep, B, n, H, dev, spread) for rep in range(4)]
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
        flops, nbytes, tc = _block_work(cfg, n_real0, n, n_weights)
        bound, bound_by, bound_tc = _bounds(flops, nbytes, tc)
        row = {"case": case, "N": n, "B": B, "H": H, "max_abs_err": err,
               "tol": _KERNEL_RTOL * scale, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": bound_by, "bound_tc_ms": bound_tc,
               "gflop": flops / 1e9, "tflops_achieved": flops / (ms * 1e-3) / 1e12}
        rows.append(row)
        print(f"phase 2: egnn_block {case} N={n} B={B} H={H} "
              f"max|d|={err:.3e} (tol {row['tol']:.2e}) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms (TF32 off) bound {bound:.4f} ms ({bound_by}, f32) "
              f"{bound_tc:.4f} ms (split-TF32 products) {row['tflops_achieved']:.2f} TFLOP/s, "
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
    H = 256
    # (case, N, B, ragged spread): QM9's pads at B=64 and two ragged tile
    # edges (N=17: tiles of 3 rows, the last of 2; N=33: one row a tile, 33
    # of 64 edge rows), GEOM's 48 and 64 at B=32.
    cases = [
        ("sum", 16, 64, 8, {}), ("sum", 17, 64, 8, {}), ("sum", 24, 64, 8, {}),
        ("sum", 29, 64, 8, {}), ("sum", 32, 64, 8, {}),
        ("mean", 32, 64, 8, {"aggregation_method": "mean"}),
        ("sin", 24, 64, 8, {"sin_embedding": True}), ("sum", 33, 64, 8, {}),
        ("sum", 48, 32, 16, {}), ("sum", 64, 32, 16, {}),
    ]
    rows = []
    for case, n, B, spread, extra in cases:
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
            inputs.append(_ragged_inputs(3000 * n + rep, B, n, H, dev, spread) + cots)
        got = egnn_block.block_backward_cuda(block, *inputs[0])
        want = egnn_block.block_backward_plain(block, *inputs[0])
        # The training route: the forward saves its activations, the
        # backward reads them instead of recomputing; the same bits. And a
        # second run replays the first bit for bit (no atomics).
        _, _, saved = egnn_block._forward_launch(block, *inputs[0][:4], save=True)
        via_saved = egnn_block._backward_launch(block, *inputs[0], saved)
        again = egnn_block.block_backward_cuda(block, *inputs[0])
        torch.cuda.synchronize()
        names = ["dh", "dx", "dx0"] + egnn_block.block_param_names(block)
        flat = lambda r: [*r[:3], *r[3]]  # noqa: E731
        for name, a, b_, c_ in zip(names, flat(got), flat(via_saved), flat(again)):
            _check(torch.equal(a, b_), f"backward from the saved activations differs from the "
                                       f"recompute on {name} at N={n} {extra}")
            _check(torch.equal(a, c_), f"backward does not replay bit for bit on {name} at "
                                       f"N={n} {extra}")
        err, worst = 0.0, ""
        for name, g, w in zip(names, flat(got), flat(want)):
            _check(bool(torch.isfinite(g).all()), f"backward {name} not finite at N={n} {extra}")
            scale = max(1.0, float(w.abs().max()))
            d = float((g - w).abs().max())
            _check(d <= _KERNEL_RTOL * scale,
                   f"backward kernel disagrees with plain on {name} at N={n} {extra}: "
                   f"max|d|={d:.3e} > {_KERNEL_RTOL}*{scale:.3g}")
            if d > err:
                err, worst = d, name
        ms = _time_ms(lambda *a: egnn_block.block_backward_cuda(block, *a), inputs)
        saved_ms = _time_ms(lambda *a: egnn_block._backward_launch(block, *a, saved), inputs[:1])
        plain_ms = _time_ms(lambda *a: egnn_block.block_backward_plain(block, *a), inputs)
        n_real0 = inputs[0][3][:, :, 0].sum(dim=1).cpu().numpy()
        flops, nbytes, tc = _bwd_work(cfg, n_real0, n, n_weights)
        bound, bound_by, bound_tc = _bounds(flops, nbytes, tc)
        row = {"case": case, "N": n, "B": B, "H": H, "max_abs_err": err, "worst": worst,
               "ms": ms, "saved_ms": saved_ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": bound_by, "bound_tc_ms": bound_tc,
               "gflop": flops / 1e9, "tflops_achieved": flops / (ms * 1e-3) / 1e12}
        rows.append(row)
        print(f"phase 6: egnn_block_bwd {case} N={n} B={B} H={H} max|d|={err:.3e} ({worst}; "
              f"{len(names)} tensors each within {_KERNEL_RTOL}*max(1,max|ref|); the saved "
              f"route and a replay bit-identical) kernel {ms:.4f} ms (from saved activations "
              f"{saved_ms:.4f} ms) plain {plain_ms:.4f} ms (TF32 off) bound {bound:.4f} ms "
              f"({bound_by}, f32) {bound_tc:.4f} ms (split-TF32 products) "
              f"{row['tflops_achieved']:.2f} TFLOP/s on {card_name}", flush=True)
    return rows


_SP_COUNTERS = ("sp_gcl_rows", "sp_coord_rows", "sp_gcl_rows_bwd", "sp_coord_rows_bwd")


def _launch_counts() -> dict:
    from geoldm_tpu_torch.ops import kernel_launches

    return kernel_launches()


def _zero_launch_counts() -> None:
    from geoldm_tpu_torch.ops import fused_optim, reset_kernel_launches

    reset_kernel_launches()
    fused_optim.reset_launches()


# (training path, the fused optimizer step's (norm, threshold, update)
# launches counted on it, summed over its ranks), for the kernels line.
_FUSED_PATHS: list = []


def _check_fused(path, steps, ranks=None):
    """The fused optimizer step on a training path: one launch of each of
    its three kernels a train step, counted since ``_zero_launch_counts``
    in this process, or on each of ``ranks`` (a CLI's replicas)."""
    from geoldm_tpu_torch.ops import fused_optim

    per_rank = ([list(fused_optim.launches())] if ranks is None
                else [list(r["fused_launches"]) for r in ranks])
    _check(all(c == [steps] * 3 for c in per_rank),
           f"{path}: the fused optimizer step launched {per_rank} (norm, threshold, update; "
           f"per rank) in {steps} train steps")
    _FUSED_PATHS.append((path, [sum(c[i] for c in per_rank) for i in range(3)]))


def _no_launches() -> dict:
    from geoldm_tpu_torch.ops import LAUNCH_COUNTERS

    return dict.fromkeys(LAUNCH_COUNTERS, 0)


def _check_trained(state, seed, decay, steps, outdir, phase):
    """After a run of ``steps`` train steps from the seed's weights: the
    denoiser and decoder weights moved, the encoder did not (its latent is
    detached), the EMA moved by a (1-decay)-scale step, and ``latest/`` and
    ``best/`` under ``outdir`` load back with equal tensors."""
    import torch

    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.utils.convert import load_reference_checkpoint

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
    # Each EMA step e*decay + w*(1-decay) moves e by at most (1-decay) times
    # the weights' move, plus two f32 roundings of at most 2^-24 |e| each.
    w_max = max(float(p.detach().abs().max()) for p in init.parameters())
    bound = steps * ((1 - decay) * step_w + 2.0 ** -23 * w_max)
    _check(0 < step_e <= 1.5 * bound,
           f"EMA moved {step_e:.3e}, weights {step_w:.3e}: not a (1-{decay})-scale step "
           f"(bound {1.5 * bound:.3e} with f32 rounding)")
    for name in ("latest", "best"):
        for use_ema, want in ((False, trained), (True, ema)):
            model, _, _ = load_reference_checkpoint(os.path.join(outdir, name), "cuda", use_ema)
            got = model.state_dict()
            _check(set(got) == set(want) and all(torch.equal(got[k].cpu(), want[k]) for k in want),
                   f"checkpoint {name} (ema={use_ema}) does not hold the trained tensors")
    print(f"phase {phase}: weights moved up to {step_w:.3e} (encoder unchanged), EMA "
          f"{step_e:.3e} (a (1-{decay})-scale step); latest/ and best/ load back through "
          f"load_reference_checkpoint with equal tensors", flush=True)


def _time_steps(state, decay, batch, n=3):
    """Host-clock ms of ``n`` more synchronised train steps on one batch."""
    import torch

    from geoldm_tpu_torch.train.train_step import make_train_step

    step = make_train_step(state.model.cfg, decay)
    gen = torch.Generator(device="cuda").manual_seed(7)
    return _host_ms(lambda: step(state, batch, gen), n)


def _host_ms(fn, n=3):
    """Host-clock ms of ``n`` synchronised calls."""
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t1) * 1e3)
    return out


def phase_train(card_name, tmpdir):
    import torch

    from geoldm_tpu_torch.cli import main_qm9
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import write_qm9_splits
    from geoldm_tpu_torch.ops import egnn_block
    from geoldm_tpu_torch.train.sampling import DEFAULT_SAMPLE_BUCKETS, n_chunks
    from geoldm_tpu_torch.train.trainer import prepare_batch
    from geoldm_tpu_torch.utils.buckets import covering_buckets

    info = get_dataset_info("qm9")
    B, steps, T, decay, seed = 64, 5, 1000, 0.9999, 0
    write_qm9_splits(tmpdir, info, {"train": B * steps, "valid": B, "test": B}, seed=1)
    argv = ["--datadir", tmpdir, "--outdir", os.path.join(tmpdir, "out"), "--exp_name", "smoke",
            "--train_diffusion", "--trainable_ae", "--nf", "256", "--n_layers", "9",
            "--latent_nf", "1", "--diffusion_steps", str(T),
            "--diffusion_noise_schedule", "polynomial_2", "--batch_size", str(B),
            "--ema_decay", str(decay), "--n_epochs", "1", "--test_epochs", "1",
            "--n_stability_samples", "8", "--seed", str(seed), "--no_wandb"]
    print(f"phase 7: python -m geoldm_tpu_torch.cli.main_qm9 {' '.join(argv)}", flush=True)
    _zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    summary = main_qm9.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    fwd, bwd = egnn_block.launches, egnn_block.bwd_launches
    _check_fused("phase 7: cli.main_qm9 at the recipe", steps)

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
          f"main() {wall:.1f} s, peak device memory {peak_mb:.1f} MiB "
          f"(torch.cuda.max_memory_allocated)", flush=True)

    state = summary["state"]
    _check_trained(state, seed, decay, steps, os.path.join(tmpdir, "out", "smoke"), 7)

    # ms per train step: three more steps on a train batch, synchronised.
    from geoldm_tpu_torch.data.qm9 import QM9Loader, load_qm9
    from geoldm_tpu_torch.models.distributions import DistributionNodes

    splits, _ = load_qm9(tmpdir)
    raw = next(iter(QM9Loader(splits["train"], B, info["max_n_nodes"])))
    times = _time_steps(state, decay, prepare_batch(raw, DistributionNodes(info.n_nodes), "cuda"))
    print(f"phase 7: train step B={B} N={info['max_n_nodes']} nf=256 9+9 blocks: "
          f"{', '.join(f'{v:.1f}' for v in times)} ms (host clock around synchronised steps) "
          f"on {card_name}", flush=True)
    return {"fwd_launches": fwd, "bwd_launches": bwd, "chunks": chunks, "losses": losses,
            "nll_val": summary["nll_val"][0], "nll_test": summary["nll_test"][0],
            "stability": summary["stability"][0], "main_seconds": wall,
            "epoch_seconds": summary["epoch_seconds"][0], "step_ms": times, "peak_mib": peak_mb}


class _Replay:
    """A noise source replaying one numpy stream: the card and the CPU run
    draw the same numbers in the same order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, shape):
        return self.rng.standard_normal(shape).astype(np.float32)

    def randint(self, low, high, shape):
        return self.rng.integers(low, high, shape)


def phase_grad(card_name, geom=False, compute_dtype=None, phase_id=None, cond=False):
    """Phase 8 (QM9: 9+9 blocks, B=8, N=29, kernel #2) or phase 14 (GEOM:
    4+4 blocks, B=2, pad 184, kernel #5): one train-step gradient on the card
    against the plain path on the CPU, same weights, batch and noise. With
    ``cond`` (phase 26) the QM9 step of the conditional recipe (nf=192,
    normalize_factors [1, 8, 1], alpha and the guidance indicator as
    context, a fixed keep mask nulling two molecules' context). With a
    ``compute_dtype`` name (phase 24: "bfloat16_pallas"), the step in it on
    both sides, the card's on the bf16 kernels, held to the bf16 gate
    (_bf16_grads_check: within _BF16_RTOL, on the mean _BF16_SEPARATION
    times closer to the CPU's bf16 step than to its f32 one)."""
    import torch

    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.ops import egnn_block, egnn_tiled
    from geoldm_tpu_torch.train.trainer import prepare_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = "geom" if geom else "cond" if cond else "qm9"
    cfg, info, context = _recipe(kind)
    if geom:
        phase = 14
        raw = _phase17_batches()[0]
        label = "GEOM nf=256 4+4 blocks B=2 pad 184 (181 and 151 atoms)"

        def bwd_launches():
            if compute_dtype:
                return (egnn_tiled.gcl_rows_bwd_bf16_launches
                        + egnn_tiled.coord_rows_bwd_bf16_launches)
            return egnn_tiled.gcl_rows_bwd_launches + egnn_tiled.coord_rows_bwd_launches
        expected = 8 * (cfg.dynamics.egnn.inv_sublayers + 1)
    else:
        phase = 26 if cond else 8
        raw = _qm9_grad_batch(cond)
        label = (f"conditional nf=192 9+9 blocks B=8 N=29 (alpha + indicator, keep mask "
                 f"{_COND_KEEP.ravel().astype(int).tolist()})" if cond
                 else "nf=256 9+9 blocks B=8 N=29")

        def bwd_launches():
            return egnn_block.bwd_bf16_launches if compute_dtype else egnn_block.bwd_launches
        expected = 18
    phase = phase_id or phase
    nll_fn = factory.model_nll_fn(cfg, training=True, compute_dtype=compute_dtype)
    nodes = DistributionNodes(info.n_nodes)
    grads, losses, seconds = {}, {}, {}
    runs = ("cuda", "cpu", "cpu_f32") if compute_dtype else ("cuda", "cpu")
    for device in runs:
        if device == "cpu_f32":
            nll_fn = factory.model_nll_fn(cfg, training=True)
        t0 = time.time()
        dev = device.split("_")[0]  # cpu_f32: the CPU's f32 step
        model = factory.build_model(cfg, dev, torch.Generator().manual_seed(5))
        batch = prepare_batch(raw, nodes, dev)
        bwd = bwd_launches()
        nll = nll_fn(model, _Replay(12), batch["x"], batch["h_cat"], batch["h_int"],
                     batch["node_mask"],
                     None if context is None else torch.from_numpy(context).to(dev))
        loss = (nll - batch["log_pN"]).mean()
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            _check(bwd_launches() == bwd + expected,
                   f"the card's backward launched {bwd_launches() - bwd} kernels, not {expected}")
        seconds[device] = time.time() - t0
        losses[device] = float(loss.detach())
        grads[device] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                         if p.grad is not None}
    _check(set(grads["cuda"]) == set(grads["cpu"]) and len(grads["cpu"]) > 0,
           "card and CPU gave gradients to different parameters")
    if compute_dtype:
        # bf16: the two clauses of _BF16_LOSS_RTOL's comment.
        loss_tol = max(_BF16_LOSS_RTOL * abs(losses["cpu"]),
                       abs(losses["cpu"] - losses["cpu_f32"]) / _BF16_STEP_SEPARATION)
    else:
        loss_tol = _LOSS_RTOL * abs(losses["cpu"])
    _check(abs(losses["cuda"] - losses["cpu"]) <= loss_tol,
           f"loss card {losses['cuda']} vs CPU {losses['cpu']}"
           + (f" (CPU f32 {losses['cpu_f32']})" if compute_dtype else ""))
    if compute_dtype:
        names = sorted(grads["cpu"])
        rep = _bf16_grads_check(f"phase {phase}", names, [grads["cuda"][k] for k in names],
                                [grads["cpu"][k] for k in names],
                                [grads["cpu_f32"][k] for k in names], None, step=True)
        err, worst_name, e, f, flips = (rep[k] for k in ("max_rel", "worst", "mean_err",
                                                          "mean_to_f32", "flips"))
        print(f"phase {phase}: {compute_dtype} train-step gradient {label}: loss card "
              f"{losses['cuda']:.6f} CPU {losses['cpu']:.6f} (CPU f32 {losses['cpu_f32']:.6f}); "
              f"{len(names)} parameter tensors, worst max|d|/max(1,|ref|) {err:.2e} "
              f"({worst_name}; tol {_BF16_RTOL}; {flips} weight-gradient elements one bf16 "
              f"step off, at most {rep['max_flip_share']:.2%} of a tensor ({rep['worst_flip']})); "
              f"mean |d|/max(1,|ref|) {e:.3e} to the CPU's bf16 step, {f:.3e} to its "
              f"f32 step; {expected} bf16 backward launches on {card_name} ("
              f"{seconds['cuda']:.1f} s card, {seconds['cpu']:.1f} s CPU)", flush=True)
        return {"loss_cuda": losses["cuda"], "loss_cpu": losses["cpu"],
                "loss_cpu_f32": losses["cpu_f32"], "worst_rel": err, "worst": worst_name,
                "mean_err": e, "mean_to_f32": f, "flips": flips,
                "max_flip_share": rep["max_flip_share"], "worst_flip": rep["worst_flip"],
                "cpu_seconds": seconds["cpu"]}
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
    print(f"phase {phase}: train-step gradient {label}: loss card "
          f"{losses['cuda']:.6f} CPU {losses['cpu']:.6f}; {len(grads['cpu'])} parameter "
          f"tensors, worst max|d|/max|ref| {worst:.2e} ({worst_name}; tol {_GRAD_RTOL}) "
          f"on {card_name} vs the plain path on the CPU ({seconds['cuda']:.1f} s card, "
          f"{seconds['cpu']:.1f} s CPU)", flush=True)
    return {"loss_cuda": losses["cuda"], "loss_cpu": losses["cpu"], "worst_rel": worst,
            "worst": worst_name, "cpu_seconds": seconds["cpu"]}


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
    # The dense f32 path (the server's default is bfloat16_mixed: phase 22).
    server, service = serve.main(["--model_path", tmpdir, "--port", "0", "--compute_dtype",
                                  "float32", "--batch_max", str(batch_max), "--no_warmup"],
                                 serve_forever=False)
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
        _zero_launch_counts()
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

        for bad in ({"sizes": [0]}, {"sizes": [12], "n_steps": 5000}):
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
            flops, nbytes, tc = _stage_work(block.cfg, n_real0, n, n_weights,
                                            stage == "coord_rows")
            bound, bound_by, bound_tc = _bounds(flops, nbytes, tc)
            row = {"stage": stage, "case": case, "N": n, "B": B, "H": H, "max_abs_err": err,
                   "tol": _KERNEL_RTOL * scale, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": bound_by, "bound_tc_ms": bound_tc,
                   "gflop": flops / 1e9, "tflops_achieved": flops / (ms * 1e-3) / 1e12}
            rows.append(row)
            print(f"phase 9: {stage} {case} N={n} B={B} H={H} max|d|={err:.3e} "
                  f"(tol {row['tol']:.2e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms (TF32 off) "
                  f"bound {bound:.4f} ms ({bound_by}, f32) {bound_tc:.4f} ms (split-TF32 products) "
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
                                  "--compute_dtype", "float32", "--batch_max", str(batch_max),
                                  "--no_warmup"], serve_forever=False)
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
        _zero_launch_counts()
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

    from geoldm_tpu_torch.ops import egnn_tiled

    err = phase_denoiser(model, card_name, B=2, N=184, n_min=150, phase=11)
    # The same denoiser under grad: every weight gets a gradient through #5.
    n, dyn = 184, model.dynamics
    mask = torch.ones((1, n, 1), device="cuda")
    z = torch.randn((1, n, 5), device="cuda", generator=torch.Generator("cuda").manual_seed(3))
    t = torch.full((1, 1), 0.5, device="cuda")
    dyn.zero_grad(set_to_none=True)
    before = egnn_tiled.gcl_rows_bwd_launches + egnn_tiled.coord_rows_bwd_launches
    with torch.enable_grad():
        dyn(t, z * mask, mask).square().sum().backward()
    torch.cuda.synchronize()
    launched = egnn_tiled.gcl_rows_bwd_launches + egnn_tiled.coord_rows_bwd_launches - before
    egnn = dyn.cfg.egnn
    expected = egnn.n_layers * (egnn.inv_sublayers + 1)
    bad = [k for k, p in dyn.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or float(p.grad.abs().max()) == 0]
    _check(not bad, f"the GEOM denoiser under grad left {len(bad)} weights without a "
                    f"gradient on the card, e.g. {bad[:3]}")
    _check(launched == expected, f"{launched} stage backwards (#5), expected {expected}")
    print(f"phase 11: the GEOM denoiser (N=184) under grad on {card_name}: all "
          f"{len(list(dyn.parameters()))} weight tensors get a finite, non-zero gradient "
          f"through {launched} stage backwards (#5)", flush=True)
    dyn.zero_grad(set_to_none=True)
    return err


def phase_tiled_backward(card_name):
    import torch

    from geoldm_tpu_torch.ops import cuda_build, egnn_tiled

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    B, H = 32, 256
    cases = [("sum", 80, {}), ("sum", 104, {}), ("sum", 128, {}), ("sum", 184, {}),
             ("mean", 181, {"aggregation_method": "mean"}), ("sin", 80, {"sin_embedding": True})]
    rows = []
    for case, n, extra in cases:
        block = _geom_block(extra, 400 + n)
        inputs, cots = [], []
        for rep in range(3):
            inputs.append(_ragged_inputs(6000 * n + rep, B, n, H, dev, spread=16))
            rng = np.random.default_rng(7000 * n + rep)
            cots.append([torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
                         for shape in ((B, n, H), (B, n, 3))])
        n_real0 = inputs[0][3][:, :, 0].sum(dim=1).cpu().numpy()
        for stage, mod, k in (("gcl_rows", block.gcl_0, 0), ("coord_rows", block.gcl_equiv, 1)):
            cuda_fn = getattr(egnn_tiled, f"{stage}_backward_cuda")
            plain_fn = getattr(egnn_tiled, f"{stage}_backward_plain")
            args = [(*a, c[k]) for a, c in zip(inputs, cots)]
            got = cuda_fn(mod, *args[0])
            want = plain_fn(mod, *args[0])
            truth = plain_fn(copy.deepcopy(mod).double(), *[t.double() for t in args[0]])
            torch.cuda.synchronize()
            names = ["dh", "dx", "dx0"] + egnn_tiled.stage_weight_names(mod)
            got, want = [*got[:3], *got[3]], [*want[:3], *want[3]]
            truth = [*truth[:3], *truth[3]]
            err, worst, off_f32 = 0.0, "", []
            for name, g, w, t in zip(names, got, want, truth):
                _check(bool(torch.isfinite(g).all()), f"{stage} backward {name} not finite at "
                                                      f"N={n} {extra}")
                scale = max(1.0, float(w.abs().max()))
                tol = _KERNEL_RTOL * scale
                d64 = float((g.double() - t).abs().max())
                _check(d64 <= tol, f"{stage} backward kernel disagrees with plain float64 on "
                                   f"{name} at N={n} {extra}: max|d|={d64:.3e} > "
                                   f"{_KERNEL_RTOL}*{scale:.3g}")
                # The plain f32 version is a yardstick only where it is
                # itself within a tenth of the gate of float64: a gradient
                # that sums every edge and cancels (the gate bias's at N=184:
                # 6.94 out of terms of up to ~250 a molecule) leaves any f32
                # computation's own error near the gate.
                d = float((g - w).abs().max())
                if float((w.double() - t).abs().max()) <= 0.1 * tol:
                    _check(d <= tol,
                           f"{stage} backward kernel disagrees with plain on {name} at N={n} "
                           f"{extra}: max|d|={d:.3e} > {_KERNEL_RTOL}*{scale:.3g}")
                else:
                    off_f32.append(f"{name} (kernel {d64 / scale:.2e}, plain f32 "
                                   f"{float((w.double() - t).abs().max()) / scale:.2e} of "
                                   f"{scale:.3g} off float64)")
                if d > err:
                    err, worst = d, name
            chain_ms, chain_txt = None, ""
            if stage == "gcl_rows":
                # The training route: the GCL's node chain kept by its
                # forward (#3) and handed over, equal to #5's own bit for bit.
                chains = [egnn_tiled.gcl_rows_cuda(mod, *a[:4], keep_chain=True)[1] for a in args]
                again = cuda_fn(mod, *args[0], chain=chains[0])
                again = [*again[:3], *again[3]]
                _check(all(torch.equal(a, g) for a, g in zip(again, got)),
                       f"gcl_rows backward with the forward's node chain differs from its own "
                       f"recompute at N={n} {extra}")
                chain_ms = _time_ms(lambda *a, m=mod, f=cuda_fn: f(m, *a[:-1], chain=a[-1]),
                                    [(*a, c) for a, c in zip(args, chains)], warmup=2, reps=10)
                chain_txt = f", with the node chain handed over {chain_ms:.4f} ms (bit-identical)"
                del again, chains
            del got, want, truth
            ms = _time_ms(lambda *a, m=mod, f=cuda_fn: f(m, *a), args, warmup=2, reps=10)
            plain_ms = _time_ms(lambda *a, m=mod, f=plain_fn: f(m, *a), args, warmup=1, reps=3)
            n_weights = sum(p.numel() for p in mod.parameters())
            flops, nbytes, tc = _stage_bwd_work(block.cfg, n_real0, n, n_weights,
                                                stage == "coord_rows")
            bound, bound_by, bound_tc = _bounds(flops, nbytes, tc)
            group, scratch = egnn_tiled._stage_scratch(cuda_build.library("egnn_tiled_bwd"), B,
                                                        n, H, block.cfg.edge_feat_nf, dev)
            row = {"stage": stage, "case": case, "N": n, "B": B, "H": H, "max_abs_err": err,
                   "worst": worst, "off_f32": off_f32, "ms": ms, "chain_ms": chain_ms,
                   "plain_ms": plain_ms,
                   "group": group, "scratch_bytes": 4 * scratch.numel(), "bound_ms": bound,
                   "bound_by": bound_by, "bound_tc_ms": bound_tc,
                   "gflop": flops / 1e9, "tflops_achieved": flops / (ms * 1e-3) / 1e12}
            rows.append(row)
            held = "; held to float64 alone: " + ", ".join(off_f32) if off_f32 else ""
            print(f"phase 12: {stage} backward {case} N={n} B={B} H={H} max|d|={err:.3e} "
                  f"({worst}; {len(names)} tensors each within {_KERNEL_RTOL}*max(1,max|ref|) of "
                  f"plain float64 and of plain f32{held}) "
                  f"kernel {ms:.4f} ms{chain_txt} plain {plain_ms:.4f} ms (TF32 off) bound "
                  f"{bound:.4f} ms ({bound_by}, f32) {bound_tc:.4f} ms (split-TF32 edge and node "
                  f"products) {row['tflops_achieved']:.2f} TFLOP/s, scratch "
                  f"{row['scratch_bytes']} bytes in groups of {group} on {card_name}", flush=True)
            del scratch
        torch.cuda.empty_cache()
    return rows


def _geom_expected(pads, L, inv, per_chunk):
    """Launches of a GEOM run on one rank with train batches, eval batches
    and sampled chunks at ``pads`` (phase 13's rule): pads up to 64 run #1
    and #2, past it inv x #3 and one #4 per block forward, the GCLs again
    (#3) and #5 per stage backward."""
    from geoldm_tpu_torch.ops.egnn_block import MAX_NODES

    per = {"train": 1 + 2 * L, "eval": 1 + 3 * L, "chunks": per_chunk}
    small = {k: sum(1 for p in v if p <= MAX_NODES) for k, v in pads.items()}
    large = {k: len(v) - small[k] for k, v in pads.items()}
    return {**_no_launches(),
            "egnn_block": sum(per[k] * small[k] for k in per),
            "egnn_block_bwd": 2 * L * small["train"],
            "gcl_rows": inv * (sum(per[k] * large[k] for k in per) + 2 * L * large["train"]),
            "coord_rows": sum(per[k] * large[k] for k in per),
            "gcl_rows_bwd": 2 * L * inv * large["train"],
            "coord_rows_bwd": 2 * L * large["train"]}


def phase_geom_train(card_name, tmpdir):
    import torch

    from geoldm_tpu_torch.cli import main_geom_drugs
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.geom import GeomLoader, load_split_data
    from geoldm_tpu_torch.data.synthetic import write_geom_conformers
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train.sampling import chunk_pads, default_buckets
    from geoldm_tpu_torch.train.trainer import prepare_batch
    from geoldm_tpu_torch.utils.buckets import covering_buckets

    info = get_dataset_info("geom")
    B, T, decay, seed, n_stab, L, inv = 32, 1000, 0.9999, 0, 4, 4, 1
    # The train split holds one full batch in each of the buckets 184, 104
    # and 48 (sizes from the histogram's support); 12 + 12 histogram
    # molecules make the validation and test splits.
    hist = sorted(dict(info.n_nodes_histogram))
    rng = np.random.default_rng(21)
    sizes = [int(v) for lo, hi in ((129, 181), (81, 104), (33, 48))
             for v in rng.choice([k for k in hist if lo <= k <= hi], size=B)]
    path = write_geom_conformers(tmpdir, info, len(sizes) * 5 // 4, seed=1, sizes=sizes)
    argv = ["--datadir", tmpdir, "--outdir", os.path.join(tmpdir, "out"), "--exp_name", "smoke",
            "--train_diffusion", "--trainable_ae", "--nf", "256", "--n_layers", str(L),
            "--latent_nf", "2", "--include_charges", "False", "--diffusion_steps", str(T),
            "--batch_size", str(B), "--lr", "5e-5", "--ema_decay", str(decay),
            "--n_epochs", "1", "--test_epochs", "1", "--n_stability_samples", str(n_stab),
            "--seed", str(seed), "--no_wandb"]
    print(f"phase 13: python -m geoldm_tpu_torch.cli.main_geom_drugs {' '.join(argv)}",
          flush=True)
    _zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    summary = main_geom_drugs.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    launches = _launch_counts()
    _check_fused("phase 13: cli.main_geom_drugs at the recipe", 3)

    losses = summary["losses"][0]
    _check(len(losses) == 3, f"{len(losses)} train steps, expected 3")
    _check(bool(np.all(np.isfinite(losses))), f"non-finite train loss: {losses}")
    _check(len(summary["nll_val"]) == 1 and np.isfinite(summary["nll_val"][0]),
           f"valid NLL {summary['nll_val']}")
    _check(len(summary["nll_test"]) == 1 and np.isfinite(summary["nll_test"][0]),
           f"test NLL {summary['nll_test']}")
    # What the code implies, per batch or chunk pad: a train step runs the
    # encoder forward (no grad) and the decoder and denoiser blocks forward
    # and backward; an eval batch the encoder, the decoder and two denoiser
    # passes; a sampled chunk (T+1) denoiser calls and one decode. Pads up to
    # 64 run #1 (forward) and #2 (backward); past 64 each block runs
    # inv_sublayers x #3 and one #4 forward, and its backward re-runs the
    # GCLs (#3, keeping each GCL's node chain) and runs #5 once per stage,
    # which then runs no GCL edge grid of its own (uncounted either way).
    train, val, test = load_split_data(path)

    def batch_pads(splits, shuffle):
        return [int(b["node_mask"].shape[1]) for data in splits
                for b in GeomLoader(data, info, B, shuffle=shuffle, include_charges=False)]

    pads = {"train": batch_pads([train], True), "eval": batch_pads([val, test], False)}
    _check(sorted(pads["train"]) == [48, 104, 184], f"train batch pads {pads['train']}")
    buckets = covering_buckets(default_buckets(info), info["max_n_nodes"])
    pads["chunks"] = chunk_pads(summary["sample_sizes"][0], min(100, n_stab), buckets)
    per = {"train": 1 + 2 * L, "eval": 1 + 3 * L, "chunks": (T + 1) * L + L}
    expected = _geom_expected(pads, L, inv, per["chunks"])
    _check(launches == expected,
           f"launches {launches} != {expected} (pads {pads}; per train step / eval batch / "
           f"sampled chunk {per})")
    print(f"phase 13: 3 steps (pads {pads['train']}), losses {[round(v, 4) for v in losses]}, "
          f"valid NLL {summary['nll_val'][0]:.4f}, test NLL {summary['nll_test'][0]:.4f}, "
          f"stability {summary['stability'][0]}; launches {json.dumps(launches)} = what the "
          f"code implies for train pads {pads['train']}, eval pads {pads['eval']}, sampled "
          f"chunk pads {pads['chunks']}; main() {wall:.1f} s, peak device memory "
          f"{peak_mb:.1f} MiB (torch.cuda.max_memory_allocated)", flush=True)
    state = summary["state"]
    _check_trained(state, seed, decay, 3, os.path.join(tmpdir, "out", "smoke"), 13)

    nodes = DistributionNodes(info.n_nodes)
    batches = {int(b["node_mask"].shape[1]): b
               for b in GeomLoader(train, info, B, shuffle=False, include_charges=False)}
    step_ms = {pad: _time_steps(state, decay, prepare_batch(batches[pad], nodes, "cuda"))
               for pad in (184, 48)}
    for pad, times in step_ms.items():
        print(f"phase 13: GEOM train step B={B} pad {pad} nf=256 4+4 blocks: "
              f"{', '.join(f'{v:.1f}' for v in times)} ms (host clock around synchronised "
              f"steps) on {card_name}", flush=True)
    return {"launches": launches, "pads": pads, "losses": losses,
            "nll_val": summary["nll_val"][0], "nll_test": summary["nll_test"][0],
            "stability": summary["stability"][0], "main_seconds": wall,
            "epoch_seconds": summary["epoch_seconds"][0], "step_ms": step_ms, "peak_mib": peak_mb}


def _sp_stage_work(cfg, n_real, n_pad, row0, s, n_weights, coord, backward):
    """(FLOP, bytes, forward W2 FLOP) one SP slab stage needs, forward (#6)
    or backward (#7), for molecules of n_real atoms padded to n_pad and the
    slab of s rows at row0: the edge MLP over the slab's real ordered pairs (its real rows
    against every other real atom), the src projection (and a GCL's node MLP)
    over the slab's real rows, the dst projection over every real atom
    (``_stage_work``'s terms split by view; the backward adds
    ``_stage_bwd_work``'s); the full view (h, x, x0, mask), the slab's view
    and its output read or written once, and for the backward the cotangent,
    both views' dh, dx, dx0 and the weight gradients. The last is the share
    the kernel runs on the tensor cores: the forward's edge W2 product over
    the slab's real pairs and its node products (#6), and for the backward
    (#7, as ``_stage_bwd_work``) also its two more edge products per real
    pair and its node products."""
    H, E = cfg.hidden_nf, cfg.edge_feat_nf
    rows = np.clip(n_real - row0, 0, s)
    pairs = float(np.sum(rows * (n_real - 1)))
    slab, nodes = float(np.sum(rows)), float(np.sum(n_real))
    node = (slab + nodes) * 2 * H * H + (0 if coord else slab * (2 * 2 * H * H + 2 * H * H))
    flops = pairs * (2 * E * H + 2 * H * H + 2 * H) + node
    out = 3 if coord else H
    b = len(n_real)
    nbytes = 4 * (b * (n_pad + s) * (H + 3 + 3 + 1) + b * s * out + n_weights)
    if not backward:
        return flops, nbytes, pairs * 2 * H * H + node
    node_bwd = (slab + nodes) * 4 * H * H + (0 if coord else slab * 12 * H * H)
    flops += pairs * (4 * H * H + 4 * E * H + 4 * H) + node_bwd
    nbytes += 4 * (b * s * out + b * (n_pad + s) * (H + 3 + 3) + n_weights)
    return flops, nbytes, pairs * 6 * H * H + node + node_bwd


def phase_sp_kernels(card_name, H=256, cases=None, b_bwd=32, spread=16, phase=15):
    """Phase 15: #6 and #7 against their plain versions on SP slabs of GEOM
    recipe blocks. Phase 29 (a) passes the conditional QM9 recipe's H=192
    and its cases: a QM9 denoiser block then."""
    import torch
    import torch.nn.functional as F

    from geoldm_tpu_torch.ops import egnn_sp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # (case, EGNN N = 'mean' divisor, ranks, slabs checked, forward B); N is
    # padded to a multiple of the ranks as egnn_forward_sp pads it. The
    # backward runs at B=b_bwd. Pads 48 and 64 at B=32 are the SP epoch's
    # pad-48 train and pad-48/64 eval batches, most of a GEOM epoch.
    cases = cases or [("sum", 184, 2, None, 16), ("mean", 181, 4, None, 16),
                      ("sin", 184, 2, [1], 16), ("sum", 48, 2, None, 32),
                      ("sum", 64, 2, None, 32)]
    rows = []
    for case, n_egnn, ranks, slabs, b_fwd in cases:
        extra = {"mean": {"aggregation_method": "mean"}, "sin": {"sin_embedding": True}}
        block = (_geom_block(extra.get(case, {}), 900 + n_egnn + ranks) if H == 256
                 else _qm9_block(H, 2900 + n_egnn + ranks))
        n = -(-n_egnn // ranks) * ranks
        s = n // ranks
        for direction, B in (("fwd", b_fwd), ("bwd", b_bwd)):
            inputs = [[F.pad(t, (0, 0, 0, n - n_egnn)) for t in
                       _ragged_inputs(10000 * ranks + 100 * rep + B, B, n_egnn, H, dev,
                                      spread=spread)] for rep in range(3)]
            n_real0 = inputs[0][3][:, :, 0].sum(dim=1).cpu().numpy()
            for slab in (slabs or range(ranks)):
                row0 = slab * s
                for stage, mod in (("gcl_rows", block.gcl_0), ("coord_rows", block.gcl_equiv)):
                    (fwd, bwd), (fwd_p, bwd_p) = (egnn_sp.stage_fns(mod, True),
                                                  egnn_sp.stage_fns(mod, False))
                    out = 3 if stage == "coord_rows" else H
                    args = []
                    for rep, full in enumerate(inputs):
                        slab_view = [t[:, row0:row0 + s].contiguous() for t in full]
                        a = [full, slab_view, row0, n_egnn]
                        if direction == "bwd":
                            rng = np.random.default_rng(rep + 31 * row0)
                            a.append(torch.from_numpy(rng.standard_normal(
                                (B, s, out)).astype(np.float32)).to(dev))
                        args.append(a)
                    kernel, plain = (fwd, fwd_p) if direction == "fwd" else (bwd, bwd_p)
                    with torch.no_grad():
                        got = kernel(mod, *args[0])
                        want = plain(mod, *args[0])
                    torch.cuda.synchronize()
                    if direction == "fwd":
                        names, got, want = ["out"], [got], [want]
                    else:
                        names = (["dh", "dx", "dx0", "dh_rows", "dx_rows", "dx0_rows"]
                                 + egnn_sp.stage_weight_names(mod))
                        got, want = [*got[:6], *got[6]], [*want[:6], *want[6]]
                    err, worst = 0.0, ""
                    for name, g, w in zip(names, got, want):
                        _check(bool(torch.isfinite(g).all()),
                               f"SP {stage} {direction} {name} not finite ({case}, row0 {row0})")
                        scale = max(1.0, float(w.abs().max()))
                        d = float((g - w).abs().max())
                        _check(d <= _KERNEL_RTOL * scale,
                               f"SP {stage} {direction} kernel disagrees with plain on {name} "
                               f"({case}, N={n}, S={s}, row0 {row0}): max|d|={d:.3e} > "
                               f"{_KERNEL_RTOL}*{scale:.3g}")
                        if d >= err:
                            err, worst = d, name
                    if direction == "bwd" and stage == "gcl_rows":
                        # The SP training route: the slab's node chain kept
                        # by #6 and handed over, equal to #7's own bit for bit.
                        with torch.no_grad():
                            chain = fwd(mod, *args[0][:4], keep_chain=True)[1]
                            again = kernel(mod, *args[0], chain=chain)
                        _check(all(torch.equal(a, g) for a, g in
                                   zip([*again[:6], *again[6]], got)),
                               f"SP gcl_rows backward with #6's node chain differs from its own "
                               f"recompute ({case}, N={n}, S={s}, row0 {row0})")
                        del chain, again
                    del got, want
                    with torch.no_grad():
                        ms = _time_ms(lambda *a, m=mod, f=kernel: f(m, *a), args)
                        plain_ms = _time_ms(lambda *a, m=mod, f=plain: f(m, *a), args,
                                            warmup=1, reps=3)
                    n_weights = sum(p.numel() for p in mod.parameters())
                    flops, nbytes, tc = _sp_stage_work(block.cfg, n_real0, n, row0, s,
                                                       n_weights, stage == "coord_rows",
                                                       direction == "bwd")
                    bound, bound_by, bound_tc = _bounds(flops, nbytes, tc)
                    row = {"stage": stage, "dir": direction, "case": case, "N": n,
                           "N_egnn": n_egnn, "S": s, "row0": row0, "B": B, "H": H,
                           "max_abs_err": err, "worst": worst, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound, "bound_by": bound_by, "bound_tc_ms": bound_tc,
                           "gflop": flops / 1e9, "tflops_achieved": flops / (ms * 1e-3) / 1e12}
                    tc_txt = f" {bound_tc:.4f} ms (split-TF32 edge and node products)"
                    rows.append(row)
                    print(f"phase {phase}: SP {stage} {direction} {case} N={n} S={s} row0={row0} "
                          f"B={B} H={H} max|d|={err:.3e} ({worst}; {len(names)} tensors each "
                          f"within {_KERNEL_RTOL}*max(1,max|ref|)) kernel {ms:.4f} ms plain "
                          f"{plain_ms:.4f} ms bound {bound:.4f} ms ({bound_by}, f32){tc_txt} "
                          f"{row['tflops_achieved']:.2f} TFLOP/s on {card_name}", flush=True)
            del inputs
            torch.cuda.empty_cache()
    return rows


def _geom_recipe_cfg():
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models import factory

    return factory.make_latent_diffusion_config(get_dataset_info("geom"), nf=256, n_layers=4,
                                                latent_nf=2, include_charges=False,
                                                diffusion_steps=1000, trainable_ae=True)


def phase_sp_train(card_name, tmpdir, compute_dtype=None, phase=16):
    """Phase 16: ``cli.main_geom_drugs --sp 2`` at the recipe. Phase 25 runs
    it with ``--compute_dtype bfloat16``: every launch in the ranks is then
    a bf16 kernel (the counts with ``_bf16``, no f32 kernel)."""
    import torch

    from geoldm_tpu_torch.cli import main_geom_drugs
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.geom import GeomLoader, load_split_data
    from geoldm_tpu_torch.data.synthetic import write_geom_conformers
    from geoldm_tpu_torch.ops.egnn_block import MAX_NODES
    from geoldm_tpu_torch.parallel import sharding
    from geoldm_tpu_torch.train.sampling import chunk_pads, default_buckets
    from geoldm_tpu_torch.utils.buckets import covering_buckets
    from geoldm_tpu_torch.utils.convert import load_reference_checkpoint

    info = get_dataset_info("geom")
    B, T, decay, seed, n_stab, L, inv, ranks = 32, 1000, 0.9999, 0, 4, 4, 1, 2
    hist = sorted(dict(info.n_nodes_histogram))
    rng = np.random.default_rng(23)
    sizes = [int(v) for lo, hi in ((129, 181), (33, 48))
             for v in rng.choice([k for k in hist if lo <= k <= hi], size=B)]
    path = write_geom_conformers(tmpdir, info, len(sizes) * 5 // 4, seed=3, sizes=sizes)
    outdir = os.path.join(tmpdir, "out")
    argv = ["--datadir", tmpdir, "--outdir", outdir, "--exp_name", "sp", "--sp", str(ranks),
            "--train_diffusion", "--trainable_ae", "--nf", "256", "--n_layers", str(L),
            "--latent_nf", "2", "--include_charges", "False", "--diffusion_steps", str(T),
            "--batch_size", str(B), "--lr", "5e-5", "--ema_decay", str(decay),
            "--n_epochs", "1", "--test_epochs", "1", "--n_stability_samples", str(n_stab),
            "--seed", str(seed), "--no_wandb"]
    argv += ["--compute_dtype", compute_dtype] if compute_dtype else []
    suffix = "_bf16" if compute_dtype else ""
    rule = sharding.placement(ranks, "cuda")[2]
    print(f"phase {phase}: python -m geoldm_tpu_torch.cli.main_geom_drugs {' '.join(argv)}",
          flush=True)
    # Each rank is a process of its own and counts its launches from 0; the
    # counts of this process are zeroed too, and stay so.
    _zero_launch_counts()
    t0 = time.time()
    summary = main_geom_drugs.main(argv)
    wall = time.time() - t0
    _check(not any(_launch_counts().values()), f"the launching process ran kernels: "
                                               f"{_launch_counts()}")

    losses = summary["losses"][0]
    _check(len(losses) == 2, f"{len(losses)} train steps, expected 2")
    _check(bool(np.all(np.isfinite(losses))), f"non-finite train loss: {losses}")
    _check(len(summary["nll_val"]) == 1 and np.isfinite(summary["nll_val"][0]),
           f"valid NLL {summary['nll_val']}")
    _check(len(summary["nll_test"]) == 1 and np.isfinite(summary["nll_test"][0]),
           f"test NLL {summary['nll_test']}")
    replicas = summary["replicas"]
    _check([r["rank"] for r in replicas] == list(range(ranks)), f"replicas {replicas}")
    _check_fused(f"phase {phase}: cli.main_geom_drugs --sp {ranks}", 2, replicas)
    _check(len({r["digest"] for r in replicas}) == 1,
           f"the ranks' train states differ: {[r['digest'][:12] for r in replicas]}")
    _check(all(r["stability"] == replicas[0]["stability"] and
               r["sample_sizes"] == replicas[0]["sample_sizes"] for r in replicas),
           "the ranks sampled different molecules for the stability check")
    # What the code implies, per rank: every EGNN call runs over the slabs
    # (pads 48 and 184 alike). A train step runs the encoder forward and the
    # decoder and denoiser blocks forward and backward; the backward re-runs
    # each block's GCLs (#6) and runs #7 once per stage. An eval batch runs the
    # encoder, the decoder and two denoiser passes. The stability samples run
    # on the single-device route, (T+1)*L + L blocks per chunk: #1 up to pad
    # 64, #3/#4 past it.
    train, val, test = load_split_data(path)

    def batch_pads(splits, shuffle):
        return [int(b["node_mask"].shape[1]) for data in splits
                for b in GeomLoader(data, info, B, shuffle=shuffle, include_charges=False)]

    pads = {"train": batch_pads([train], True), "eval": batch_pads([val, test], False)}
    _check(sorted(pads["train"]) == [48, 184], f"train batch pads {pads['train']}")
    buckets = covering_buckets(default_buckets(info), info["max_n_nodes"])
    pads["chunks"] = chunk_pads(replicas[0]["sample_sizes"][0], min(100, n_stab), buckets)
    n_train, n_eval = len(pads["train"]), len(pads["eval"])
    per_chunk = (T + 1) * L + L
    small = sum(1 for p in pads["chunks"] if p <= MAX_NODES)
    large = len(pads["chunks"]) - small
    expected = _no_launches()
    expected.update({k + suffix: v for k, v in {
        "egnn_block": per_chunk * small, "gcl_rows": inv * per_chunk * large,
        "coord_rows": per_chunk * large,
        "sp_gcl_rows": inv * (n_train * (1 + 4 * L) + n_eval * (1 + 3 * L)),
        "sp_coord_rows": n_train * (1 + 2 * L) + n_eval * (1 + 3 * L),
        "sp_gcl_rows_bwd": inv * 2 * L * n_train, "sp_coord_rows_bwd": 2 * L * n_train}.items()})
    for r in replicas:
        _check(r["launches"] == expected,
               f"rank {r['rank']} launches {r['launches']} != {expected} (pads {pads})")
    for name in ("latest", "best"):
        model, _, _ = load_reference_checkpoint(os.path.join(outdir, "sp", name), "cuda", True)
        _check(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
               f"checkpoint {name} not finite")
    print(f"phase {phase}: {rule}; {n_train} steps (pads {pads['train']}), losses "
          f"{[round(v, 4) for v in losses]}, valid NLL {summary['nll_val'][0]:.4f}, test NLL "
          f"{summary['nll_test'][0]:.4f}, stability {summary['stability'][0]} on every rank; "
          f"launches per rank {json.dumps(replicas[0]['launches'])} = what the code implies "
          f"for train pads {pads['train']}, eval pads {pads['eval']}, sampled chunk pads "
          f"{pads['chunks']}; train states bit-identical on {ranks} ranks (sha256 "
          f"{replicas[0]['digest'][:16]}); checkpoints written by rank 0 load back; main() "
          f"{wall:.1f} s, epoch {summary['epoch_seconds'][0]:.1f} s on {card_name}",
          flush=True)
    return {"launches": {k: sum(r["launches"][k] for r in replicas) for k in expected},
            "launches_per_rank": [r["launches"] for r in replicas], "rule": rule,
            "pads": pads, "losses": losses, "nll_val": summary["nll_val"][0],
            "nll_test": summary["nll_test"][0], "stability": summary["stability"][0],
            "digest": replicas[0]["digest"], "main_seconds": wall,
            "epoch_seconds": summary["epoch_seconds"][0]}


def _phase17_batches():
    """The gradient batch (B=2, pad 184, 181 and 151 atoms; 150 is not in
    the size histogram) and the recipe batches timed (B=32, pads 184, 48)."""
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import synthetic_batch

    info = get_dataset_info("geom")
    hist = sorted(dict(info.n_nodes_histogram))
    rng = np.random.default_rng(29)
    timed = {pad: synthetic_batch(info, 32, pad, rng, include_charges=False, n_atoms=rng.choice(
        [k for k in hist if lo <= k <= pad], size=32)) for pad, lo in ((184, 129), (48, 33))}
    raw = synthetic_batch(info, 2, 184, np.random.default_rng(13), include_charges=False,
                          n_atoms=[181, 151])
    return raw, timed


def _train_step_grads(device, raw, sp_group=None, compute_dtype=None, kind="geom", data=None):
    """One recipe train step's loss and gradients from seed-5 weights and the
    replayed noise stream 12 on the global batch ``raw``, in
    ``compute_dtype``: ``kind`` 'geom' (phase 14's recipe), 'qm9' (phase 8's)
    or 'cond' (phase 26's conditional recipe with its context and keep
    mask). The blocks' gradients are summed over the SP group; with ``data``
    (a data group) the rank takes its rows of the batch and of the draws and
    the gradients and loss are averaged over the data ranks, as the train
    step does. Returns (model, loss, {name: gradient on the host},
    launches)."""
    import torch

    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.parallel import sharding, sp
    from geoldm_tpu_torch.train.trainer import prepare_host, to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, info, context = _recipe(kind)
    model = factory.build_model(cfg, device, torch.Generator().manual_seed(5), sp_group=sp_group)
    host = prepare_host(raw, DistributionNodes(info.n_nodes))
    if context is not None:
        host["context"] = context
    batch = to_device(sharding.shard_rows(host, data), device)
    before = _launch_counts()
    nll = factory.model_nll_fn(cfg, training=True, compute_dtype=compute_dtype)(
        model, sharding.wrap_noise(_Replay(12), data), batch["x"], batch["h_cat"],
        batch["h_int"], batch["node_mask"], batch.get("context"))
    loss = (nll - batch["log_pN"]).mean()
    loss.backward()
    if sp_group is not None:
        sharding.reduce_grads(sp.block_parameters(model), sp_group)
    if data is not None:
        (loss,) = sharding.reduce_grads(list(model.parameters()), data, loss, mean=True)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _launch_counts().items()}
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters() if p.grad is not None}
    return model, float(loss.detach()), grads, launches


def _recipe(kind):
    """(model config, dataset info, context or None) of a gradient check:
    'geom', 'qm9' or 'cond' (``_train_step_grads``)."""
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models import factory

    if kind == "geom":
        return _geom_recipe_cfg(), get_dataset_info("geom"), None
    info = get_dataset_info("qm9_second_half" if kind == "cond" else "qm9")
    extra = dict(nf=192, context_node_nf=1, context_indicator=True,
                 normalize_factors=(1.0, 8.0, 1.0)) if kind == "cond" else dict(nf=256)
    cfg = factory.make_latent_diffusion_config(info, n_layers=9, latent_nf=1,
                                               diffusion_steps=1000, trainable_ae=True, **extra)
    return cfg, info, _cond_context() if kind == "cond" else None


_COND_KEEP = np.array([1, 0, 1, 1, 1, 0, 1, 1], np.float32)[:, None, None]  # the CFG null


def _cond_context():
    """Phase 26's conditional gradient batch's context: alpha (B=8, N=29, the
    batch of ``_qm9_grad_batch``) and the indicator, times the keep mask."""
    from geoldm_tpu_torch.train.conditioning import prepare_context

    raw = _qm9_grad_batch(cond=True)
    raw["alpha"] = np.random.default_rng(12).normal(75.0, 8.0, size=8).astype(np.float32)
    return prepare_context(["alpha"], raw, {"alpha": {"mean": 75.0, "mad": 6.5}},
                           indicator=True) * _COND_KEEP


def _qm9_grad_batch(cond=False):
    """Phase 8's (26's with ``cond``) gradient batch: B=8, N=29."""
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import synthetic_batch

    info = get_dataset_info("qm9_second_half" if cond else "qm9")
    return synthetic_batch(info, 8, 29, np.random.default_rng(11))


def _sp_step_rank(raw, timed, grid):
    """One rank of phase 17: the gradient step, then the timed recipe steps."""
    import hashlib

    import torch.distributed as dist

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train.train_step import create_train_state
    from geoldm_tpu_torch.train.trainer import prepare_batch

    grp = grid.seq
    model, loss, grads, launches = _train_step_grads(grp.device, raw, grp)
    h = hashlib.sha256()
    for g in grads.values():
        h.update(g.numpy().tobytes())
    state = create_train_state(model, model.cfg, 5e-5, ema_decay=0.9999)
    nodes = DistributionNodes(get_dataset_info("geom").n_nodes)
    step_ms = {pad: _time_steps(state, 0.9999, prepare_batch(b, nodes, grp.device))
               for pad, b in timed.items()}
    mine = {"rank": grp.rank, "grads_sha256": h.hexdigest(), "launches": launches,
            "step_ms": step_ms}
    ranks = [None] * grp.size
    dist.all_gather_object(ranks, mine)
    return {"loss": loss, "grads": {k: g.numpy() for k, g in grads.items()}, "ranks": ranks}


def phase_sp_grad(card_name):
    """Phase 17: an SP-2 train step against the same step on one rank."""
    import torch

    from geoldm_tpu_torch.parallel import sharding

    raw, timed = _phase17_batches()
    t0 = time.time()
    _, loss_ref, grads_ref, launches_ref = _train_step_grads("cuda", raw)
    _check(not any(launches_ref[k] for k in _SP_COUNTERS), "the one-rank step ran SP kernels")
    got = sharding.spawn(1, 2, _sp_step_rank, (raw, timed), device="cuda")
    wall = time.time() - t0
    L, inv = 4, 1
    per_rank = _no_launches()
    per_rank.update({"sp_gcl_rows": inv * (1 + 4 * L), "sp_coord_rows": 1 + 2 * L,
                     "sp_gcl_rows_bwd": inv * 2 * L, "sp_coord_rows_bwd": 2 * L})
    for r in got["ranks"]:
        _check(r["launches"] == per_rank, f"rank {r['rank']} launches {r['launches']} != "
                                          f"{per_rank}")
    _check(len({r["grads_sha256"] for r in got["ranks"]}) == 1,
           "the ranks' gradients differ after the all-reduce")
    _check(abs(got["loss"] - loss_ref) <= _LOSS_RTOL * abs(loss_ref),
           f"loss SP {got['loss']} vs one rank {loss_ref}")
    _check(set(got["grads"]) == set(grads_ref) and len(grads_ref) > 0,
           "SP and one rank gave gradients to different parameters")
    worst, worst_name = 0.0, ""
    for k, ref in grads_ref.items():
        g = torch.from_numpy(got["grads"][k])
        _check(bool(torch.isfinite(g).all()), f"SP gradient of {k} not finite")
        d = float((g - ref).abs().max())
        scale = float(ref.abs().max())
        _check(d <= _GRAD_RTOL * scale, f"gradient of {k}: SP vs one rank max|d|={d:.3e} > "
                                        f"{_GRAD_RTOL}*{scale:.3e}")
        rel = d / scale if scale else 0.0
        if rel >= worst:
            worst, worst_name = rel, k
    print(f"phase 17: SP-2 train-step gradient GEOM nf=256 4+4 blocks B=2 pad 184 (181 and "
          f"151 atoms): loss SP {got['loss']:.6f} one rank {loss_ref:.6f}; {len(grads_ref)} "
          f"parameter tensors, worst max|d|/max|ref| {worst:.2e} ({worst_name}; tol "
          f"{_GRAD_RTOL}); launches per rank {json.dumps(got['ranks'][0]['launches'])}; "
          f"both ranks' gradients bit-identical; {wall:.1f} s", flush=True)
    for pad in timed:
        for r in got["ranks"]:
            print(f"phase 17: SP-2 train step B=32 pad {pad} nf=256 4+4 blocks, rank "
                  f"{r['rank']}: {', '.join(f'{v:.1f}' for v in r['step_ms'][pad])} ms (host "
                  f"clock around synchronised steps; 2 ranks sharing one card over gloo: "
                  f"correctness and overhead, not scaling) on {card_name}", flush=True)
    return {"loss_sp": got["loss"], "loss_one_rank": loss_ref, "worst_rel": worst,
            "worst": worst_name, "launches_per_rank": [r["launches"] for r in got["ranks"]],
            "step_ms": {pad: [r["step_ms"][pad] for r in got["ranks"]] for pad in timed},
            "seconds": wall}


def _equal_files(snapshot, path, phase):
    """The train state a resumed run loaded (its CPU copy) against the files
    of the checkpoint directory it resumed from, tensor for tensor."""
    import torch

    load = lambda name: torch.load(os.path.join(path, name), weights_only=True)  # noqa: E731
    n = 0
    for key, name in (("model", "generative_model.npy"), ("ema", "generative_model_ema.npy")):
        want = load(name)
        _check(set(snapshot[key]) == set(want) and
               all(torch.equal(snapshot[key][k], want[k]) for k in want),
               f"phase {phase}: the resumed {key} differs from {name}")
        n += len(want)
    want = load("optim.npy")
    got = snapshot["optim"]["state"]
    _check(got.keys() == want["state"].keys() and all(
        torch.equal(torch.as_tensor(got[i][k]).cpu(), torch.as_tensor(v).cpu())
        for i, entry in want["state"].items() for k, v in entry.items()),
        f"phase {phase}: the resumed AdamW state differs from optim.npy")
    n += sum(len(entry) for entry in want["state"].values())
    extra = load("train_state.npy")
    _check(snapshot["step"] == extra["step"] and
           torch.equal(snapshot["clip"]["norms"], extra["clip"]["norms"]) and
           (snapshot["clip"]["count"], snapshot["clip"]["head"]) ==
           (extra["clip"]["count"], extra["clip"]["head"]),
           f"phase {phase}: the resumed clip ring buffer or step differs from train_state.npy")
    return n + 2


def phase_resume(card_name, qm9_dir, geom_dir):
    """Phase 18: resume phase 7's QM9 run (augmented, with prefetch), train a
    first-stage VAE and start a latent diffusion from it (--ae_path), and
    resume phase 13's GEOM run for one batch at pad 184."""
    import torch

    from geoldm_tpu_torch.cli import main_geom_drugs, main_qm9
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import write_geom_conformers
    from geoldm_tpu_torch.train.sampling import DEFAULT_SAMPLE_BUCKETS, n_chunks
    from geoldm_tpu_torch.utils.buckets import covering_buckets

    info = get_dataset_info("qm9")
    B, steps, T, L, decay = 64, 5, 1000, 9, 0.9999
    width = ["--nf", "256", "--n_layers", str(L), "--latent_nf", "1", "--batch_size", str(B),
             "--ema_decay", str(decay), "--seed", "0", "--no_wandb"]
    out = os.path.join(qm9_dir, "out")
    run_dir = os.path.join(out, "smoke")
    stats = {}

    # 18a: phase 7's run resumed at epoch 1 into a run directory of its own.
    argv = ["--datadir", qm9_dir, "--outdir", out, "--exp_name", "resumed", "--resume", run_dir,
            "--start_epoch", "1", "--n_epochs", "2", "--test_epochs", "1",
            "--data_augmentation", "True", "--prefetch", "2", "--train_diffusion",
            "--trainable_ae", "--diffusion_steps", str(T), "--n_stability_samples", "4", *width]
    print(f"phase 18: python -m geoldm_tpu_torch.cli.main_qm9 {' '.join(argv)}", flush=True)
    _zero_launch_counts()
    t0 = time.time()
    summary = main_qm9.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launch_counts()
    n_equal = _equal_files(summary["resumed"], os.path.join(run_dir, "latest"), 18)
    _check(summary["resumed"]["step"] == steps and summary["state"].step == 2 * steps,
           f"resumed at step {summary['resumed']['step']}, ended at {summary['state'].step}")
    losses = summary["losses"][0]
    _check(len(losses) == steps and bool(np.all(np.isfinite(losses))), f"losses {losses}")
    buckets = covering_buckets(DEFAULT_SAMPLE_BUCKETS, info["max_n_nodes"])
    chunks = n_chunks(summary["sample_sizes"][0], 4, buckets)
    per_step, per_eval = 1 + 2 * L, 1 + 3 * L
    expected = {**_no_launches(),
                "egnn_block": steps * per_step + 2 * per_eval + ((T + 1) * L + L) * chunks,
                "egnn_block_bwd": steps * 2 * L}
    _check(launches == expected, f"resumed QM9 launches {launches} != {expected}")
    records = [json.loads(ln) for ln in open(os.path.join(out, "resumed", "metrics.jsonl"))]
    keys = [sorted(set(r) - {"_time", "_step"}) for r in records if r.get("_step") == 1]
    want_keys = [["train_loss_epoch"], ["atm_stable", "mol_stable"], ["nll_val"],
                 ["best_nll_val", "nll_test"]]
    _check(keys == want_keys, f"metrics.jsonl epoch 1 keys {keys} != {want_keys}")
    _check(any(set(r) == {"_time", "batch_loss", "grad_norm"} for r in records),
           "metrics.jsonl holds no batch_loss/grad_norm record")
    print(f"phase 18: resumed QM9 at step {summary['resumed']['step']}: {n_equal} tensors and "
          f"counters equal latest/ (model, EMA, AdamW, clip ring buffer, step); {steps} "
          f"augmented steps, losses {[round(v, 4) for v in losses]}, stability "
          f"{summary['stability'][0]}, triple {summary['rdkit'][0]}; launches fwd "
          f"{launches['egnn_block']} = {steps}*{per_step} + 2*{per_eval} + "
          f"(({T}+1)*{L}+{L})*{chunks} chunks, bwd {launches['egnn_block_bwd']}; metrics.jsonl "
          f"epoch 1 keys {keys}; main() {wall:.1f} s on {card_name}", flush=True)
    stats["qm9_resume"] = {"launches": launches, "chunks": chunks, "tensors_equal": n_equal,
                           "main_seconds": wall, "losses": losses}
    del summary

    # 18b: a full-width first-stage VAE, then a latent diffusion on it.
    argv = ["--datadir", qm9_dir, "--outdir", out, "--exp_name", "vae", "--n_epochs", "1",
            "--test_epochs", "1", *width]
    print(f"phase 18: python -m geoldm_tpu_torch.cli.main_qm9 {' '.join(argv)}", flush=True)
    _zero_launch_counts()
    t0 = time.time()
    vae = main_qm9.main(argv)
    torch.cuda.synchronize()
    vae_wall = time.time() - t0
    vae_launches = _launch_counts()
    # A VAE step runs the encoder (1 block) and the decoder (L) forward and
    # backward; a valid or test batch runs them forward.
    expected = {**_no_launches(), "egnn_block": steps * (1 + L) + 2 * (1 + L),
                "egnn_block_bwd": steps * (1 + L)}
    _check(len(vae["losses"][0]) == steps and bool(np.all(np.isfinite(vae["losses"][0]))),
           f"VAE losses {vae['losses']}")
    _check(vae_launches == expected, f"VAE launches {vae_launches} != {expected}")
    del vae
    argv = ["--datadir", qm9_dir, "--outdir", out, "--exp_name", "ldm_on_vae",
            "--train_diffusion", "--ae_path", os.path.join(out, "vae"),
            "--diffusion_steps", str(T), "--break_train_epoch", "True", "--start_epoch", "1",
            "--n_epochs", "2", "--test_epochs", "2", *width]
    print(f"phase 18: python -m geoldm_tpu_torch.cli.main_qm9 {' '.join(argv)}", flush=True)
    _zero_launch_counts()
    t0 = time.time()
    ldm = main_qm9.main(argv)
    torch.cuda.synchronize()
    ldm_wall = time.time() - t0
    ldm_launches = _launch_counts()
    want = torch.load(os.path.join(out, "vae", "best", "generative_model_ema.npy"),
                      weights_only=True)
    got = {k: v.cpu() for k, v in ldm["state"].model.vae.state_dict().items()}
    _check(got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want),
           "the latent diffusion's vae is not the first stage's EMA weights")
    # One step with the first stage frozen: the encoder forward, and the
    # denoiser forward and backward (a frozen first stage adds no
    # reconstruction term, so the decoder does not run).
    expected = {**_no_launches(), "egnn_block": 1 + L, "egnn_block_bwd": L}
    _check(ldm_launches == expected, f"--ae_path step launches {ldm_launches} != {expected}")
    print(f"phase 18: VAE nf=256 {L} layers, {steps} steps, launches {vae_launches['egnn_block']}"
          f"/{vae_launches['egnn_block_bwd']} ({vae_wall:.1f} s); LDM on --ae_path: its vae "
          f"equals the first stage's EMA weights ({len(want)} tensors, bit for bit) after "
          f"{len(ldm['losses'][0])} step with it frozen, launches {ldm_launches['egnn_block']}/"
          f"{ldm_launches['egnn_block_bwd']} ({ldm_wall:.1f} s)", flush=True)
    stats["ae_path"] = {"vae_launches": vae_launches, "ldm_launches": ldm_launches,
                        "vae_seconds": vae_wall, "ldm_seconds": ldm_wall}
    del ldm

    # 18c: phase 13's GEOM run resumed for one train batch at pad 184 (the
    # molecules of a new conformer file, 129..181 atoms; its 4 + 4 valid and
    # test molecules are not evaluated: epoch 1 is no test epoch).
    ginfo = get_dataset_info("geom")
    hist = sorted(dict(ginfo.n_nodes_histogram))
    sizes = [int(v) for v in np.random.default_rng(22).choice(
        [k for k in hist if 129 <= k <= 181], size=32)]
    data = os.path.join(geom_dir, "resume_data")
    write_geom_conformers(data, ginfo, 40, seed=5, sizes=sizes)
    gout = os.path.join(geom_dir, "out")
    argv = ["--datadir", data, "--outdir", gout, "--exp_name", "resumed", "--resume",
            os.path.join(gout, "smoke"), "--start_epoch", "1", "--n_epochs", "2",
            "--test_epochs", "2", "--data_augmentation", "True", "--train_diffusion",
            "--trainable_ae", "--nf", "256", "--n_layers", "4", "--latent_nf", "2",
            "--include_charges", "False", "--batch_size", "32", "--lr", "5e-5",
            "--ema_decay", str(decay), "--no_wandb"]
    print(f"phase 18: python -m geoldm_tpu_torch.cli.main_geom_drugs {' '.join(argv)}",
          flush=True)
    _zero_launch_counts()
    t0 = time.time()
    geom = main_geom_drugs.main(argv)
    torch.cuda.synchronize()
    geom_wall = time.time() - t0
    geom_launches = _launch_counts()
    n_geom = _equal_files(geom["resumed"], os.path.join(gout, "smoke", "latest"), 18)
    gl = 4
    expected = {**_no_launches(), "gcl_rows": (1 + 2 * gl) + 2 * gl, "coord_rows": 1 + 2 * gl,
                "gcl_rows_bwd": 2 * gl, "coord_rows_bwd": 2 * gl}
    _check(len(geom["losses"][0]) == 1 and np.isfinite(geom["losses"][0][0]),
           f"GEOM resumed losses {geom['losses']}")
    _check(geom_launches == expected, f"GEOM resumed launches {geom_launches} != {expected}")
    print(f"phase 18: resumed GEOM at step {geom['resumed']['step']}: {n_geom} tensors and "
          f"counters equal latest/; one augmented step at pad 184, loss "
          f"{geom['losses'][0][0]:.4f}; launches {json.dumps(geom_launches)}; main() "
          f"{geom_wall:.1f} s on {card_name}", flush=True)
    stats["geom_resume"] = {"launches": geom_launches, "tensors_equal": n_geom,
                            "main_seconds": geom_wall}
    return stats


def phase_eval(card_name, qm9_dir):
    """Phase 19: cli.eval_analyze on phase 18's resumed QM9 checkpoint."""
    import torch

    from geoldm_tpu_torch.cli import eval_analyze
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.qm9 import load_qm9
    from geoldm_tpu_torch.evalsuite.analyze import stability_counts
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train.sampling import DEFAULT_SAMPLE_BUCKETS, n_chunks
    from geoldm_tpu_torch.train.trainer import evaluate_nll_packed
    from geoldm_tpu_torch.utils.buckets import covering_buckets
    from geoldm_tpu_torch.utils.convert import load_reference_checkpoint

    info = get_dataset_info("qm9")
    T, L, n_samples, passes = 1000, 9, 36, 5
    model_path = os.path.join(qm9_dir, "out", "resumed")
    argv = ["--model_path", model_path, "--datadir", qm9_dir, "--n_samples", str(n_samples),
            "--n_test_passes", str(passes)]
    print(f"phase 19: python -m geoldm_tpu_torch.cli.eval_analyze {' '.join(argv)}", flush=True)
    _zero_launch_counts()
    t0 = time.time()
    summary = eval_analyze.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launch_counts()
    report = summary["report"]
    _check(report["stability_path"] == "native",
           f"stability ran on the {report['stability_path']} path, not the native batch")
    _check(all(0.0 <= v <= 1.0 for v in summary["rdkit"]), f"triple {summary['rdkit']}")
    mols = summary["molecules"]
    args = (mols["x"], mols["one_hot"], mols["node_mask"], info)
    t1 = time.perf_counter()
    native = stability_counts(*args, use_native=True)
    native_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    python = stability_counts(*args, use_native=False)
    python_s = time.perf_counter() - t1
    _check(native[:3] == python[:3], f"native stability counts {native} != the Python path's "
                                     f"{python}")
    _check(summary["stability"]["mol_stable"] == native[0] / n_samples,
           f"eval_analyze's stability {summary['stability']} is not the native counts {native}")
    _check(np.isfinite(summary["nll_val"]) and len(summary["nll_tests"]) == passes and
           bool(np.all(np.isfinite(summary["nll_tests"]))),
           f"NLL valid {summary['nll_val']}, test passes {summary['nll_tests']}")
    splits, _ = load_qm9(qm9_dir)
    batches = -(-len(splits["valid"]["num_atoms"]) // 64) + passes * -(-len(
        splits["test"]["num_atoms"]) // 64)
    chunks = n_chunks(mols["n_atoms"], min(100, n_samples),
                      covering_buckets(DEFAULT_SAMPLE_BUCKETS, 29))
    expected = {**_no_launches(), "egnn_block": ((T + 1) * L + L) * chunks + (1 + 3 * L) * batches}
    _check(launches == expected, f"eval_analyze launches {launches} != {expected}")
    log = open(os.path.join(model_path, "eval_log.txt")).read().split()
    _check(log[0::2][:4] == ["n_samples", "secs/sample", "mol_stable", "atm_stable"] and
           "nll_test" in log, f"eval_log.txt: {log}")

    # The packed NLL on the card against the CPU: one batch of 8 test
    # molecules, the same weights and the same draws.
    split = {k: v[:8] for k, v in splits["test"].items()}
    nll = {}
    for dev in ("cuda", "cpu"):
        model, cfg, _ = load_reference_checkpoint(os.path.join(model_path, "best"), dev)
        nll[dev] = evaluate_nll_packed(model, cfg, split, DistributionNodes(info.n_nodes),
                                       [_Replay(19)], batch_size=8, pad_nodes=29,
                                       partition="card-vs-cpu")[0]
    err = abs(nll["cuda"] - nll["cpu"])
    _check(err <= _DENOISER_RTOL * max(1.0, abs(nll["cpu"])),
           f"packed NLL card {nll['cuda']} vs CPU {nll['cpu']}: |d| {err:.3e}")
    mol_s = n_samples / report["generation_seconds"]
    print(f"phase 19: generated {n_samples} molecules at T={T} in "
          f"{report['generation_seconds']:.2f} s ({mol_s:.2f} mol/s), stability "
          f"{summary['stability']} on the native path ({native_s * 1e3:.2f} ms; Python path "
          f"{python_s * 1e3:.2f} ms, equal counts {native[:3]}), triple {summary['rdkit']} "
          f"({report['triple_seconds']:.2f} s, {report['triple_backend']}); packed NLL valid "
          f"{summary['nll_val']:.4f} and {passes} test passes {summary['nll_tests']} in "
          f"{summary['nll_seconds']:.2f} s; launches {launches['egnn_block']} = "
          f"(({T}+1)*{L}+{L})*{chunks} chunks + {1 + 3 * L}*{batches} batch-passes; card vs "
          f"CPU packed NLL {nll['cuda']:.6f} / {nll['cpu']:.6f} (|d| {err:.2e}); eval_log.txt "
          f"written; main() {wall:.1f} s on {card_name}", flush=True)
    return {"launches": launches, "chunks": chunks, "batch_passes": batches,
            "generation_seconds": report["generation_seconds"], "mol_per_s": mol_s,
            "stability": summary["stability"], "triple": summary["rdkit"],
            "triple_seconds": report["triple_seconds"], "native_ms": native_s * 1e3,
            "python_ms": python_s * 1e3, "nll_val": summary["nll_val"],
            "nll_tests": summary["nll_tests"], "nll_seconds": summary["nll_seconds"],
            "card_vs_cpu_nll": [nll["cuda"], nll["cpu"]], "main_seconds": wall}


def phase_geom_eval(card_name, geom_dir):
    """Phase 20: cli.eval_analyze --dataset geom on phase 13's checkpoint,
    the packed NLL at pad 184 on a conformer file whose valid and test
    molecules reach 181 atoms."""
    import torch

    from geoldm_tpu_torch.cli import eval_analyze
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import write_geom_conformers
    from geoldm_tpu_torch.ops.egnn_block import MAX_NODES
    from geoldm_tpu_torch.train.sampling import chunk_pads, default_buckets
    from geoldm_tpu_torch.utils.buckets import covering_buckets

    info = get_dataset_info("geom")
    T, L, passes = 1000, 4, 5
    data = os.path.join(geom_dir, "eval_data")
    # 20 molecules; the permutation reversed puts the 4 given sizes (from
    # the size histogram) first: valid [181, ~168], test [~120, ~150], and
    # 16 train molecules (unused).
    hist = dict(info.n_nodes_histogram)
    sizes = [max(k for k in hist if k <= n) for n in (150, 120, 168, 181)]
    _check(sizes[-1] == 181, f"181 atoms is not in the GEOM size histogram ({sizes})")
    write_geom_conformers(data, info, 20, seed=6, sizes=sizes)
    np.save(os.path.join(data, "geom_permutation.npy"), np.arange(20)[::-1].copy())
    model_path = os.path.join(geom_dir, "out", "smoke")
    argv = ["--model_path", model_path, "--dataset", "geom", "--datadir", data,
            "--conformation_file", "geom_drugs_30.npy", "--n_samples", "2",
            "--batch_size_nll", "8", "--n_test_passes", str(passes)]
    print(f"phase 20: python -m geoldm_tpu_torch.cli.eval_analyze {' '.join(argv)}", flush=True)
    _zero_launch_counts()
    t0 = time.time()
    summary = eval_analyze.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launch_counts()
    _check(summary["report"]["stability_path"] == "native",
           f"stability ran on the {summary['report']['stability_path']} path")
    _check(np.isfinite(summary["nll_val"]) and bool(np.all(np.isfinite(summary["nll_tests"]))),
           f"GEOM NLL valid {summary['nll_val']}, test {summary['nll_tests']}")
    buckets = covering_buckets(default_buckets(info), info["max_n_nodes"])
    pads = chunk_pads(summary["molecules"]["n_atoms"], 2, buckets)
    _check(len(pads) <= 2, f"generation ran {len(pads)} chunks")
    per_chunk, per_eval, batches = (T + 1) * L + L, 1 + 3 * L, 1 + passes
    small = sum(1 for p in pads if p <= MAX_NODES)
    large = len(pads) - small
    expected = {**_no_launches(), "egnn_block": per_chunk * small,
                "gcl_rows": per_chunk * large + per_eval * batches,
                "coord_rows": per_chunk * large + per_eval * batches}
    _check(launches == expected, f"GEOM eval launches {launches} != {expected} (chunk pads "
                                 f"{pads})")
    print(f"phase 20: valid sizes {sizes[:1:-1]}, test {sizes[1::-1]}; GEOM generation of 2 "
          f"molecules (chunk pads {pads}) in "
          f"{summary['generation_seconds']:.2f} s, stability {summary['stability']} (native), "
          f"triple {summary['rdkit']}; packed NLL at pad 184 valid {summary['nll_val']:.4f}, "
          f"{passes} test passes {summary['nll_tests']} in {summary['nll_seconds']:.2f} s; "
          f"launches {json.dumps(launches)} = #1 {per_chunk}*{small} chunks, #3/#4 "
          f"{per_chunk}*{large} chunks + {per_eval}*{batches} batch-passes; main() {wall:.1f} s "
          f"on {card_name}", flush=True)
    return {"launches": launches, "chunk_pads": pads, "nll_val": summary["nll_val"],
            "nll_tests": summary["nll_tests"], "nll_seconds": summary["nll_seconds"],
            "generation_seconds": summary["generation_seconds"], "main_seconds": wall}


# bf16 variants (#1, #3, #4 with bf16 operands and f32 accumulation) vs their
# plain versions (operands rounded to bf16, f32 products): an operand at a
# rounding tie flips by one bf16 ulp (2^-8) under another summation order, so
# the gate is wider than the f32 kernels' 1e-4. The gate is loose against
# the rounding itself, so each case must also tell the precisions apart: the
# kernel's mean distance to the plain f32 version at least _BF16_SEPARATION
# times its mean error against the plain bf16 one (the mean, since the
# largest error is that of one such flip).
_BF16_RTOL = 5e-3
_BF16_SEPARATION = 10.0
# A whole bf16 train step, card vs CPU (phase 24): 19 forward and 18 backward
# bf16 kernels in a row, each rounding ties the other way than the plain
# version at ~1/20 of bf16's own effect (phase 23), and those flips
# compound through the chain (9.1x on the mean at QM9 on an H100 80GB HBM3
# at 700 W, PERF.md; up to 52% of a weight gradient's elements one bf16 step
# apart, tests/torch_port_bf16_sites.py:STEP_FLIP_SHARE).
_BF16_STEP_SEPARATION = 5.0
# A bf16 train step's loss, card vs CPU: a mean over the batch of sums whose
# bf16 operands may round the other way at a tie under another sum order.
# Within _BF16_LOSS_RTOL of it, or _BF16_STEP_SEPARATION times closer to the
# CPU's bf16 loss than that is to its f32 loss (the GEOM pad-184 step: 1.1e-4
# of the loss apart, 7x closer, PERF.md §2).
_BF16_LOSS_RTOL = 1e-4
# A whole run takes ~370 s on an H100 (PERF.md); past this, every thread's
# stack goes to standard error, once.
_STALL_SECONDS = 900
# Dense bf16 on the H100's tensor cores (data sheet).
_BF16_PEAK = 989.0e12


def _bf16_bounds(flops, nbytes):
    """(bound ms, what bounds it) of a bf16 variant. Every FLOP that
    ``_block_work`` and ``_stage_work`` count is a matrix product, and under
    a bf16 compute dtype each takes bf16 operands (JAX's ``_matmul``): the
    first layer's edge-feature term, W2, the gate or coordinate scale and
    the node-side products. So all of them go at the dense bf16 rate,
    against the bytes at the memory rate. The elementwise work (silu,
    sigmoid, tanh, the sums) is in no bound of this script, f32 or bf16."""
    t_ops = flops / _BF16_PEAK * 1e3
    t_bytes = nbytes / _BW_PEAK * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_bf16_kernels(card):
    """Phase 21: the bf16 variants of #1 (QM9 pads 16/24/32 at B=64, GEOM
    48/64 at B=32) and #3/#4 (N=96/136/184, B=16) against their plain bf16
    versions on the card, with card ms, bound, plain ms and the f32
    kernel's ms at the same shape."""
    import torch

    from geoldm_tpu_torch.ops import egnn_block, egnn_tiled

    bf16 = torch.bfloat16
    dev = torch.device("cuda")
    H, rows = 256, []

    def record(kernel, case, n, B, got, want, want_f32, ms, plain_ms, f32_ms, work):
        _check(all(bool(torch.isfinite(g).all()) for g in got), f"{kernel} bf16 N={n} not finite")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        to_f32 = max(float((g - w).abs().max()) for g, w in zip(got, want_f32))
        mean_err = sum(float((g - w).abs().double().mean()) for g, w in zip(got, want))
        mean_f32 = sum(float((g - w).abs().double().mean()) for g, w in zip(got, want_f32))
        scale = max([1.0] + [float(w.abs().max()) for w in want])
        _check(err <= _BF16_RTOL * scale, f"{kernel} bf16 disagrees with plain at N={n}: "
                                          f"max|d|={err:.3e} > {_BF16_RTOL}*{scale:.3g}")
        _check(_BF16_SEPARATION * mean_err <= mean_f32,
               f"{kernel} bf16 N={n}: its mean distance to the plain f32 version {mean_f32:.3e} "
               f"is not {_BF16_SEPARATION:g}x its mean error {mean_err:.3e} against the plain "
               "bf16 one")
        bound, bound_by = _bf16_bounds(*work)
        rows.append({"kernel": kernel, "case": case, "N": n, "B": B, "H": H, "max_abs_err": err,
                     "max_to_f32_plain": to_f32, "mean_abs_err": mean_err,
                     "mean_to_f32_plain": mean_f32, "tol": _BF16_RTOL * scale, "ms": ms,
                     "plain_ms": plain_ms, "f32_ms": f32_ms, "bound_ms": bound,
                     "bound_by": bound_by})
        print(f"phase 21: {kernel} bf16 N={n} B={B} H={H} to plain bf16 max|d| {err:.3e} (tol "
              f"{_BF16_RTOL * scale:.2e}), mean {mean_err:.3e}; to plain f32 max {to_f32:.3e}, "
              f"mean {mean_f32:.3e}; kernel {ms:.4f} ms, f32 kernel {f32_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}; every product at 989 "
              f"TFLOP/s) on {card}", flush=True)

    for n, B, spread in ((16, 64, 8), (24, 64, 8), (32, 64, 8), (48, 32, 16), (64, 32, 16)):
        block = _geom_block({}, 600 + n)
        n_weights = sum(p.numel() for p in block.parameters())
        inputs = [_ragged_inputs(6000 * n + rep, B, n, H, dev, spread) for rep in range(4)]
        with torch.no_grad():
            got = egnn_block.block_forward_cuda(block, *inputs[0], compute_dtype=bf16)
            want = egnn_block.block_forward_plain(block, *inputs[0], compute_dtype=bf16)
            want_f32 = egnn_block.block_forward_plain(block, *inputs[0])
            torch.cuda.synchronize()
            ms = _time_ms(lambda *a: egnn_block.block_forward_cuda(block, *a, compute_dtype=bf16),
                          inputs)
            plain_ms = _time_ms(lambda *a: egnn_block.block_forward_plain(
                block, *a, compute_dtype=bf16), inputs)
            f32_ms = _time_ms(lambda *a: egnn_block.block_forward_cuda(block, *a), inputs)
        n_real = inputs[0][3][:, :, 0].sum(dim=1).cpu().numpy()
        record("egnn_block", "sum", n, B, got, want, want_f32, ms, plain_ms, f32_ms,
               _block_work(block.cfg, n_real, n, n_weights)[:2])

    B = 16
    for n in (96, 136, 184):
        block = _geom_block({}, 700 + n)
        inputs = [_ragged_inputs(7000 * n + rep, B, n, H, dev, 16) for rep in range(4)]
        n_real = inputs[0][3][:, :, 0].sum(dim=1).cpu().numpy()
        with torch.no_grad():
            stage_inputs = [(egnn_tiled.gcl_rows_plain(block.gcl_0, *a, compute_dtype=bf16),
                             *a[1:]) for a in inputs]
        for stage, mod, cuda_fn, plain_fn, ins in (
                ("gcl_rows", block.gcl_0, egnn_tiled.gcl_rows_cuda, egnn_tiled.gcl_rows_plain,
                 inputs),
                ("coord_rows", block.gcl_equiv, egnn_tiled.coord_rows_cuda,
                 egnn_tiled.coord_rows_plain, stage_inputs)):
            with torch.no_grad():
                got = cuda_fn(mod, *ins[0], compute_dtype=bf16)
                want = plain_fn(mod, *ins[0], compute_dtype=bf16)
                want_f32 = plain_fn(mod, *ins[0])
                torch.cuda.synchronize()
                ms = _time_ms(lambda *a, m=mod, f=cuda_fn: f(m, *a, compute_dtype=bf16), ins)
                plain_ms = _time_ms(lambda *a, m=mod, f=plain_fn: f(m, *a, compute_dtype=bf16),
                                    ins)
                f32_ms = _time_ms(lambda *a, m=mod, f=cuda_fn: f(m, *a), ins)
            n_weights = sum(p.numel() for p in mod.parameters())
            record(stage, "sum", n, B, [got], [want], [want_f32], ms, plain_ms, f32_ms,
                   _stage_work(block.cfg, n_real, n, n_weights, stage == "coord_rows")[:2])
    return rows


def phase_bf16_serve(card, qm9_dir):
    """Phase 22: cli.serve at the QM9 recipe with its default compute dtype,
    bfloat16_mixed: DDIM (50 steps, eta 0), DPM-Solver++(2M) (20 steps),
    a clip_z request and a dense request, with per-request mol/s and the
    launches of the bf16 and the f32 kernel counted exactly (the last
    round(0.1 K) steps and the final step in f32, the decoder in bf16); GEOM
    serving at pad 96 in bf16; cli.eval_analyze --n_steps 50 on phase 18's
    QM9 checkpoint (f32)."""
    import torch

    from geoldm_tpu_torch.cli import eval_analyze, serve
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.diffusion.vdm import mixed_tail_steps
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.train.sampling import DEFAULT_SAMPLE_BUCKETS, chunk_pads, n_chunks
    from geoldm_tpu_torch.utils.buckets import covering_buckets
    from geoldm_tpu_torch.utils.convert import save_reference_checkpoint

    out = {}
    launches_all = _no_launches()
    T, batch_max = 1000, 64
    for dataset, kw in (("qm9", dict(nf=256, n_layers=9, latent_nf=1)),
                        ("geom", dict(nf=256, n_layers=4, latent_nf=2, include_charges=False,
                                      normalization_factor=1.0))):
        info = get_dataset_info(dataset)
        cfg = factory.make_latent_diffusion_config(info, diffusion_steps=T, **kw)
        L, dec, inv = cfg.dynamics.egnn.n_layers, cfg.vae.decoder_egnn.n_layers, \
            cfg.dynamics.egnn.inv_sublayers
        tmp = tempfile.TemporaryDirectory()
        model = factory.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
        save_reference_checkpoint(model, tmp.name, dataset=dataset)
        del model
        server, service = serve.main(["--model_path", tmp.name, "--dataset", dataset, "--port",
                                      "0", "--batch_max", str(batch_max), "--no_warmup"],
                                     serve_forever=False)
        _check(service.args.compute_dtype == "bfloat16_mixed",
               f"the server's default compute dtype is {service.args.compute_dtype}")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        if dataset == "qm9":
            few = [19, 23, 27, 29, 14, 17]  # pads 16, 24, 32: three chunks
            requests = [("ddim50", {"n_steps": 50, "eta": 0.0}, 50, few),
                        ("dpm2m20", {"n_steps": 20, "sampler": "dpm2m"}, 20, few),
                        ("clip_z", {"n_steps": 50, "clip_z": 2.0}, 50, few),
                        ("dense", {}, T, [19, 23, 21, 24])]  # one chunk of 1001 steps
        else:
            requests = [("ddim20_pad96", {"n_steps": 20, "eta": 0.0}, 20, [90, 75])]
        try:
            for name, settings, K, sizes in requests:
                body = {"sizes": sizes, "seed": 21, **settings}
                _zero_launch_counts()
                t0 = time.time()
                code, resp = _request(base, "/sample", body)
                dt = time.time() - t0
                launches = _launch_counts()
                _check(code == 200, f"phase 22 {dataset} {name} -> {code} {resp}")
                _check_molecules(resp, sizes, info["atom_decoder"])
                ran = resp["sampler"]
                _check(ran["compute_dtype"] == "bfloat16_mixed" and
                       ran["n_steps"] == settings.get("n_steps") and
                       ran["method"] == settings.get("sampler", "ddim") and
                       ran["clip_z"] == settings.get("clip_z", 0.0),
                       f"{name}: the server reports {ran}")
                tail = mixed_tail_steps("bfloat16_mixed", K)
                pads = chunk_pads(sizes, batch_max, service.buckets)
                small = sum(1 for p in pads if p <= 64)
                large = len(pads) - small
                head = (K - tail) * L + dec   # bf16: the head's steps and the decoder
                f32 = (tail + 1) * L          # f32: the tail and the final step
                expected = {**_no_launches(),
                            "egnn_block_bf16": head * small, "egnn_block": f32 * small,
                            "gcl_rows_bf16": head * inv * large, "coord_rows_bf16": head * large,
                            "gcl_rows": f32 * inv * large, "coord_rows": f32 * large}
                _check(launches == expected,
                       f"{dataset} {name}: launches {launches} != {expected} (K={K}, tail "
                       f"{tail}, chunk pads {pads})")
                for k, v in launches.items():
                    launches_all[k] += v
                row = {"request": name, "dataset": dataset, "K": K, "tail": tail,
                       "chunk_pads": pads, "molecules": len(sizes), "seconds": dt,
                       "mol_per_s": len(sizes) / dt, "stable": sum(resp["stable"]),
                       "launches": {k: v for k, v in launches.items() if v}}
                out[f"{dataset}_{name}"] = row
                print(f"phase 22: {dataset} /sample {name} ({json.dumps(ran)}): {len(sizes)} "
                      f"molecules in {dt:.2f} s ({row['mol_per_s']:.3f} mol/s, {row['stable']} "
                      f"stable); launches {json.dumps(row['launches'])} = per chunk bf16 "
                      f"({K}-{tail})*{L}+{dec}, f32 ({tail}+1)*{L}, chunk pads {pads} on {card}",
                      flush=True)
        finally:
            server.shutdown()
            server.server_close()
            tmp.cleanup()

    info = get_dataset_info("qm9")
    n_samples, K, L = 36, 50, 9
    argv = ["--model_path", os.path.join(qm9_dir, "out", "resumed"), "--datadir", qm9_dir,
            "--n_samples", str(n_samples), "--n_steps", str(K), "--skip_nll"]
    print(f"phase 22: python -m geoldm_tpu_torch.cli.eval_analyze {' '.join(argv)}", flush=True)
    _zero_launch_counts()
    summary = eval_analyze.main(argv)
    torch.cuda.synchronize()
    launches = _launch_counts()
    chunks = n_chunks(summary["molecules"]["n_atoms"], min(100, n_samples),
                      covering_buckets(DEFAULT_SAMPLE_BUCKETS, 29))
    expected = {**_no_launches(), "egnn_block": ((K + 1) * L + L) * chunks}
    _check(launches == expected, f"eval_analyze --n_steps {K}: launches {launches} != {expected}")
    for k, v in launches.items():
        launches_all[k] += v
    _check(all(0.0 <= v <= 1.0 for v in summary["rdkit"]), f"triple {summary['rdkit']}")
    gen = summary["report"]["generation_seconds"]
    out["eval_analyze_n_steps_50"] = {"molecules": n_samples, "chunks": chunks,
                                      "generation_seconds": gen, "mol_per_s": n_samples / gen,
                                      "stability": summary["stability"]}
    print(f"phase 22: eval_analyze --n_steps {K}: {n_samples} molecules in {gen:.2f} s "
          f"({n_samples / gen:.2f} mol/s), stability {summary['stability']}; launches "
          f"{launches['egnn_block']} = (({K}+1)*{L}+{L})*{chunks} chunks on {card}", flush=True)
    return out, launches_all


def _bf16_sites():
    """tests/torch_port_bf16_sites.py, from the checkout: ``unrounded`` (the
    plain bf16 versions with one site rounded otherwise) and the bf16
    gradient report."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    import torch_port_bf16_sites

    return torch_port_bf16_sites


def _bf16_grads_check(what, names, got, want, want_f32, want_cot, step=False, separation=None,
                      lowp=False):
    """tests/torch_port_bf16_sites.py's bf16_grads_report at _BF16_RTOL
    (every tensor within the gate, weight gradients but for their one-step
    rounding flips, at most FLIP_SHARE of a tensor; on the mean over every
    element, each in units of its tensor's max(1, max|ref|), _BF16_SEPARATION
    times closer to the plain bf16 version than to the plain f32 one and to
    want_cot; ``step``: a whole train step, STEP_FLIP_SHARE and
    _BF16_STEP_SEPARATION; ``separation`` another factor at FLIP_SHARE;
    ``lowp``: the low-precision chain's rounded biases, LOWP_ROUNDED, counted
    with the weights) or SmokeFailure -> the report (max_rel, worst, the
    three means, flips, max_flip_share, worst_flip, max_abs)."""
    sites = _bf16_sites()
    _check(sites.SEPARATION == _BF16_SEPARATION, "the separation of the sites helper changed")
    r = sites.bf16_grads_report(names, got, want, want_f32, want_cot, _BF16_RTOL,
                                *((sites.STEP_FLIP_SHARE, _BF16_STEP_SEPARATION) if step
                                  else (sites.FLIP_SHARE, separation) if separation
                                  else ()),
                                **({"rounded": sites.LOWP_ROUNDED} if lowp else {}))
    _check(not r["problems"], f"{what}: {'; '.join(r['problems'])}")
    return r


def _bf16_fields(rep):
    """A phase-23 row's fields from _bf16_grads_check's report."""
    return {"max_rel_err": rep["max_rel"], "worst": rep["worst"], "mean_err": rep["mean_err"],
            "mean_to_f32": rep["mean_to_f32"], "mean_to_cotangent": rep["mean_to_cotangent"],
            "flips": rep["flips"], "max_flip_share": rep["max_flip_share"],
            "worst_flip": rep["worst_flip"], "max_abs_err": rep["max_abs"]}


def phase_bf16_backward(card):
    """Phase 23: the bf16 backward kernels against their plain bf16
    backwards (autograd of the plain bf16 forward) on the card: #2 at QM9's
    pads 16/24/29/32 (B=64) and GEOM's 48/64 (B=32); #5's GCL and
    coordinate stages at N=96/136/184 (B=32); #6 (forward, B=16 at N=184)
    and #7 (B=32) on both slabs of N=184 over 2 ranks and of N=48/64. Every
    output within _BF16_RTOL * max(1, max|ref|), weight gradients included;
    on the mean _BF16_SEPARATION times closer to the plain bf16 version than
    to the plain f32 one and to one that rounds each product's cotangent
    (``cotangent``, tests/torch_port_bf16_sites.py); the training routes
    (the forward's saved chain for #2, the kept node chain for #5/#7) and a
    replay bit-identical to the recompute. With card ms, the f32 kernel's ms,
    plain ms and the bf16 bound (every product at the dense bf16 rate)."""
    import torch
    import torch.nn.functional as F

    from geoldm_tpu_torch.ops import egnn_block, egnn_sp, egnn_tiled

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    unrounded = _bf16_sites().unrounded
    bf16, dev, H, rows = torch.bfloat16, torch.device("cuda"), 256, []

    def cots(seed, shapes):
        rng = np.random.default_rng(seed)
        return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                for s in shapes]

    def flat(r, k=3):
        return [*r[:k], *r[k]]

    def record(row, what):
        rows.append(row)
        print(f"phase 23: {what} max|d|/max(1,|ref|) {row['max_rel_err']:.2e} ({row['worst']}; "
              f"tol {_BF16_RTOL}; {row['flips']} weight-gradient elements one bf16 step off, at "
              f"most {row['max_flip_share']:.2%} of a tensor ({row['worst_flip']})); "
              f"mean |d|/max(1,|ref|) over every element {row['mean_err']:.3e} to plain "
              f"bf16, {row['mean_to_f32']:.3e} to plain f32, {row['mean_to_cotangent']:.3e} to "
              f"rounded cotangents; kernel {row['ms']:.4f} ms, f32 kernel {row['f32_ms']:.4f} "
              f"ms, plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; every product at 989 TFLOP/s) on {card}", flush=True)

    # #2 at QM9's and GEOM's small pads.
    for n, B, spread in ((16, 64, 8), (24, 64, 8), (29, 64, 8), (32, 64, 8), (48, 32, 16),
                         (64, 32, 16)):
        block = _geom_block({}, 2300 + n)
        E, n_weights = block.cfg.edge_feat_nf, sum(p.numel() for p in block.parameters())
        inputs = [_ragged_inputs(23000 * n + rep, B, n, H, dev, spread)
                  + tuple(cots(23100 * n + rep, ((B, n, H), (B, n, 3)))) for rep in range(3)]
        got = egnn_block.block_backward_cuda(block, *inputs[0], compute_dtype=bf16)
        with torch.no_grad():
            h_s, x_s, saved = egnn_block._forward_launch(block, *inputs[0][:4], save=True,
                                                         bf16=True)
            h_n, x_n = egnn_block.block_forward_cuda(block, *inputs[0][:4], compute_dtype=bf16)
        via_saved = egnn_block._backward_launch(block, *inputs[0], saved, True)
        again = egnn_block.block_backward_cuda(block, *inputs[0], compute_dtype=bf16)
        torch.cuda.synchronize()
        names = ["dh", "dx", "dx0"] + egnn_block.block_param_names(block)
        _check(torch.equal(h_s, h_n) and torch.equal(x_s, x_n),
               f"#1 bf16 with its chain saved differs from without at N={n}")
        for name, a, b_, c_ in zip(names, flat(got), flat(via_saved), flat(again)):
            _check(torch.equal(a, b_), f"#2 bf16 from the saved chain differs from the "
                                       f"recompute on {name} at N={n}")
            _check(torch.equal(a, c_), f"#2 bf16 does not replay on {name} at N={n}")
        del via_saved, again, saved
        want = flat(egnn_block.block_backward_plain(block, *inputs[0], compute_dtype=bf16))
        want_f32 = flat(egnn_block.block_backward_plain(block, *inputs[0]))
        with unrounded("cotangent", E):
            want_cot = flat(egnn_block.block_backward_plain(block, *inputs[0], compute_dtype=bf16))
        rep = _bf16_grads_check(f"#2 bf16 N={n}", names, flat(got), want, want_f32, want_cot)
        del got, want, want_f32, want_cot
        ms = _time_ms(lambda *a: egnn_block.block_backward_cuda(block, *a, compute_dtype=bf16),
                      inputs)
        f32_ms = _time_ms(lambda *a: egnn_block.block_backward_cuda(block, *a), inputs)
        plain_ms = _time_ms(lambda *a: egnn_block.block_backward_plain(
            block, *a, compute_dtype=bf16), inputs, warmup=1, reps=3)
        n_real = inputs[0][3][:, :, 0].sum(dim=1).cpu().numpy()
        bound, bound_by = _bf16_bounds(*_bwd_work(block.cfg, n_real, n, n_weights)[:2])
        record({"kernel": "egnn_block_bwd", "N": n, "B": B, "H": H, **_bf16_fields(rep),
                "ms": ms, "f32_ms": f32_ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by}, f"egnn_block_bwd bf16 N={n} B={B} H={H}: {len(names)} "
                                       f"tensors; the saved route and a replay bit-identical;")
        del inputs
        torch.cuda.empty_cache()

    # #5 at GEOM's pads past 64.
    B = 32
    for n in (96, 136, 184):
        block = _geom_block({}, 2400 + n)
        E = block.cfg.edge_feat_nf
        inputs = [_ragged_inputs(24000 * n + rep, B, n, H, dev, 16) for rep in range(3)]
        n_real = inputs[0][3][:, :, 0].sum(dim=1).cpu().numpy()
        for stage, mod, shape in (("gcl_rows", block.gcl_0, (B, n, H)),
                                  ("coord_rows", block.gcl_equiv, (B, n, 3))):
            cuda_fn = getattr(egnn_tiled, f"{stage}_backward_cuda")
            plain_fn = getattr(egnn_tiled, f"{stage}_backward_plain")
            args = [(*a, *cots(24100 * n + rep, (shape,))) for rep, a in enumerate(inputs)]
            got = flat(cuda_fn(mod, *args[0], compute_dtype=bf16))
            again = flat(cuda_fn(mod, *args[0], compute_dtype=bf16))
            _check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
                   f"#5 bf16 {stage} does not replay at N={n}")
            chain_txt = ""
            if stage == "gcl_rows":
                with torch.no_grad():
                    chain = egnn_tiled.gcl_rows_cuda(mod, *args[0][:4], keep_chain=True,
                                                     compute_dtype=bf16)[1]
                handed = flat(cuda_fn(mod, *args[0], chain=chain, compute_dtype=bf16))
                _check(all(torch.equal(a, b_) for a, b_ in zip(got, handed)),
                       f"#5 bf16 GCL backward from #3 bf16's node chain differs from its own "
                       f"recompute at N={n}")
                chain_txt = " from #3 bf16's kept node chain bit-identical;"
                del chain, handed
            del again
            names = ["dh", "dx", "dx0"] + egnn_tiled.stage_weight_names(mod)
            want = flat(plain_fn(mod, *args[0], compute_dtype=bf16))
            want_f32 = flat(plain_fn(mod, *args[0]))
            with unrounded("cotangent", E):
                want_cot = flat(plain_fn(mod, *args[0], compute_dtype=bf16))
            rep = _bf16_grads_check(f"#5 bf16 {stage} N={n}", names, got, want, want_f32,
                                    want_cot)
            del got, want, want_f32, want_cot
            ms = _time_ms(lambda *a, m=mod, fn=cuda_fn: fn(m, *a, compute_dtype=bf16), args,
                          warmup=2, reps=10)
            f32_ms = _time_ms(lambda *a, m=mod, fn=cuda_fn: fn(m, *a), args, warmup=2, reps=10)
            plain_ms = _time_ms(lambda *a, m=mod, fn=plain_fn: fn(m, *a, compute_dtype=bf16),
                                args, warmup=1, reps=3)
            n_weights = sum(p.numel() for p in mod.parameters())
            bound, bound_by = _bf16_bounds(*_stage_bwd_work(block.cfg, n_real, n, n_weights,
                                                            stage == "coord_rows")[:2])
            record({"kernel": f"{stage}_bwd", "N": n, "B": B, "H": H, **_bf16_fields(rep),
                    "ms": ms, "f32_ms": f32_ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": bound_by},
                   f"{stage} backward (#5) bf16 N={n} B={B} H={H}: a replay{chain_txt}")
        del inputs
        torch.cuda.empty_cache()

    # #6 and #7 on the slabs of N=184 (2 ranks) and of GEOM's pads 48 and 64.
    for n, ranks, b_fwd in ((184, 2, 16), (48, 2, 32), (64, 2, 32)):
        block = _geom_block({}, 2500 + n)
        E = block.cfg.edge_feat_nf
        s = n // ranks
        for direction, B in (("fwd", b_fwd), ("bwd", 32)):
            inputs = [[t_.contiguous() for t_ in _ragged_inputs(25000 * n + 100 * rep + B, B, n,
                                                                H, dev, 16)] for rep in range(3)]
            n_real = inputs[0][3][:, :, 0].sum(dim=1).cpu().numpy()
            for slab in range(ranks):
                row0 = slab * s
                for stage, mod in (("gcl_rows", block.gcl_0), ("coord_rows", block.gcl_equiv)):
                    (fwd, bwd), (fwd_p, bwd_p) = (egnn_sp.stage_fns(mod, True),
                                                  egnn_sp.stage_fns(mod, False))
                    out = 3 if stage == "coord_rows" else H
                    args = []
                    for rep, full in enumerate(inputs):
                        a = [full, [t_[:, row0:row0 + s].contiguous() for t_ in full], row0, n]
                        if direction == "bwd":
                            a += cots(25100 * n + rep + 31 * row0, ((B, s, out),))
                        args.append(a)
                    kernel, plain = (fwd, fwd_p) if direction == "fwd" else (bwd, bwd_p)
                    with torch.no_grad():
                        got = kernel(mod, *args[0], compute_dtype=bf16)
                        again = kernel(mod, *args[0], compute_dtype=bf16)
                    if direction == "fwd":
                        names, got, again = ["out"], [got], [again]
                    else:
                        names = (["dh", "dx", "dx0", "dh_rows", "dx_rows", "dx0_rows"]
                                 + egnn_sp.stage_weight_names(mod))
                        got, again = flat(got, 6), flat(again, 6)
                    _check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
                           f"SP {stage} {direction} bf16 does not replay (N={n}, row0 {row0})")
                    if direction == "bwd" and stage == "gcl_rows":
                        with torch.no_grad():
                            chain = fwd(mod, *args[0][:4], keep_chain=True,
                                        compute_dtype=bf16)[1]
                        handed = flat(kernel(mod, *args[0], chain=chain, compute_dtype=bf16), 6)
                        _check(all(torch.equal(a, b_) for a, b_ in zip(got, handed)),
                               f"#7 bf16 from #6 bf16's node chain differs from its own "
                               f"recompute (N={n}, row0 {row0})")
                        del chain, handed
                    with torch.no_grad():
                        want = plain(mod, *args[0], compute_dtype=bf16)
                        want_f32 = plain(mod, *args[0])
                    want_cot = None
                    if direction == "fwd":
                        want, want_f32 = [want], [want_f32]
                    else:
                        want, want_f32 = flat(want, 6), flat(want_f32, 6)
                        with unrounded("cotangent", E):
                            want_cot = flat(plain(mod, *args[0], compute_dtype=bf16), 6)
                    kname = "egnn_sp_fwd" if direction == "fwd" else "egnn_sp_bwd"
                    rep = _bf16_grads_check(f"{kname} bf16 {stage} N={n} row0 {row0}", names,
                                            got, want, want_f32, want_cot)
                    del got, again, want, want_f32, want_cot
                    with torch.no_grad():
                        ms = _time_ms(lambda *a, m=mod, fn=kernel: fn(m, *a, compute_dtype=bf16),
                                      args)
                        f32_ms = _time_ms(lambda *a, m=mod, fn=kernel: fn(m, *a), args)
                        plain_ms = _time_ms(lambda *a, m=mod, fn=plain: fn(
                            m, *a, compute_dtype=bf16), args, warmup=1, reps=3)
                    n_weights = sum(p.numel() for p in mod.parameters())
                    bound, bound_by = _bf16_bounds(*_sp_stage_work(
                        block.cfg, n_real, n, row0, s, n_weights, stage == "coord_rows",
                        direction == "bwd")[:2])
                    record({"kernel": kname, "stage": stage, "N": n, "S": s, "row0": row0,
                            "B": B, "H": H, **_bf16_fields(rep), "ms": ms,
                            "f32_ms": f32_ms, "plain_ms": plain_ms, "bound_ms": bound,
                            "bound_by": bound_by},
                           f"{kname} bf16 {stage} N={n} S={s} row0={row0} B={B} H={H}: a "
                           f"replay{' and the kept node chain' if direction == 'bwd' else ''} "
                           f"bit-identical;")
            del inputs
            torch.cuda.empty_cache()
    return rows


def phase_bf16_train(card, tmpdir):
    """Phase 24: bf16 training through the CLIs at the recipes on fabricated
    data: 5 QM9 steps (cli.main_qm9 --compute_dtype bfloat16_pallas), then
    one GEOM step at pad 184 (cli.main_geom_drugs --compute_dtype bfloat16),
    each with its test epoch (valid and test NLL, stability samples) in
    bf16: finite, the EMA moved, and the launches exact, every one a bf16
    kernel. Then the bf16 train-step gradient on the card against the plain
    bf16 step on the CPU (phase_grad), QM9 and GEOM."""
    import torch

    from geoldm_tpu_torch.cli import main_geom_drugs, main_qm9
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.geom import GeomLoader, load_split_data
    from geoldm_tpu_torch.data.synthetic import write_geom_conformers, write_qm9_splits
    from geoldm_tpu_torch.ops.egnn_block import MAX_NODES
    from geoldm_tpu_torch.train.sampling import (DEFAULT_SAMPLE_BUCKETS, chunk_pads,
                                                 default_buckets, n_chunks)
    from geoldm_tpu_torch.utils.buckets import covering_buckets

    out, T, decay, seed = {}, 1000, 0.9999, 0
    # QM9: per train step the encoder forward (no grad) and the 9 decoder and
    # 9 denoiser blocks forward (#1 bf16, saving the chain) and backward (#2
    # bf16); per eval batch encoder + decoder + 2 denoiser passes; per sampled
    # chunk (T+1) denoiser calls and a decode, all in bf16.
    info = get_dataset_info("qm9")
    B, steps, L, n_stab = 64, 5, 9, 8
    qm9_dir = os.path.join(tmpdir, "qm9")
    write_qm9_splits(qm9_dir, info, {"train": B * steps, "valid": B, "test": B}, seed=1)
    argv = ["--datadir", qm9_dir, "--outdir", os.path.join(qm9_dir, "out"), "--exp_name", "bf16",
            "--train_diffusion", "--trainable_ae", "--nf", "256", "--n_layers", str(L),
            "--latent_nf", "1", "--diffusion_steps", str(T), "--batch_size", str(B),
            "--ema_decay", str(decay), "--n_epochs", "1", "--test_epochs", "1",
            "--n_stability_samples", str(n_stab), "--seed", str(seed), "--no_wandb",
            "--compute_dtype", "bfloat16_pallas"]
    print(f"phase 24: python -m geoldm_tpu_torch.cli.main_qm9 {' '.join(argv)}", flush=True)
    _zero_launch_counts()
    t0 = time.time()
    summary = main_qm9.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launch_counts()
    _check_fused("phase 24: cli.main_qm9 --compute_dtype bfloat16_pallas", steps)
    losses = summary["losses"][0]
    _check(len(losses) == steps and bool(np.all(np.isfinite(losses))), f"QM9 bf16 losses {losses}")
    _check(np.isfinite(summary["nll_val"][0]) and np.isfinite(summary["nll_test"][0]),
           f"QM9 bf16 NLLs {summary['nll_val']} {summary['nll_test']}")
    chunks = n_chunks(summary["sample_sizes"][0], n_stab,
                      covering_buckets(DEFAULT_SAMPLE_BUCKETS, info["max_n_nodes"]))
    expected = {**_no_launches(),
                "egnn_block_bf16": steps * (1 + 2 * L) + 2 * (1 + 3 * L)
                + ((T + 1) * L + L) * chunks,
                "egnn_block_bwd_bf16": steps * 2 * L}
    _check(launches == expected, f"QM9 bf16 launches {launches} != {expected} ({chunks} chunks)")
    _check_trained(summary["state"], seed, decay, steps, os.path.join(qm9_dir, "out", "bf16"), 24)
    shown = {k: v for k, v in launches.items() if v}
    print(f"phase 24: QM9 bf16 {steps} steps, losses {[round(v, 4) for v in losses]}, valid NLL "
          f"{summary['nll_val'][0]:.4f}, test NLL {summary['nll_test'][0]:.4f}, stability "
          f"{summary['stability'][0]}; launches {json.dumps(shown)} = what the code implies "
          f"({chunks} sampled chunks; no f32 kernel); main() {wall:.1f} s on {card}", flush=True)
    out["qm9"] = {"launches": launches, "losses": losses, "main_seconds": wall,
                  "nll_val": summary["nll_val"][0], "nll_test": summary["nll_test"][0]}
    del summary

    # GEOM: one train batch at pad 184, a few eval molecules; past pad 64 a
    # block runs #3 bf16 and #4 bf16 forward, its backward re-runs the GCL (#3
    # bf16, keeping the chain) and runs #5 bf16 per stage.
    info = get_dataset_info("geom")
    B, L, inv, n_stab = 32, 4, 1, 2
    hist = sorted(dict(info.n_nodes_histogram))
    rng = np.random.default_rng(24)
    sizes = [int(v) for v in rng.choice([k for k in hist if 129 <= k <= 181], size=B)]
    geom_dir = os.path.join(tmpdir, "geom")
    path = write_geom_conformers(geom_dir, info, 40, seed=2, sizes=sizes)
    argv = ["--datadir", geom_dir, "--outdir", os.path.join(geom_dir, "out"), "--exp_name",
            "bf16", "--train_diffusion", "--trainable_ae", "--diffusion_steps", str(T),
            "--batch_size", str(B), "--ema_decay", str(decay), "--n_epochs", "1",
            "--test_epochs", "1", "--n_stability_samples", str(n_stab), "--seed", str(seed),
            "--no_wandb", "--compute_dtype", "bfloat16"]
    print(f"phase 24: python -m geoldm_tpu_torch.cli.main_geom_drugs {' '.join(argv)}",
          flush=True)
    _zero_launch_counts()
    t0 = time.time()
    summary = main_geom_drugs.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launch_counts()
    _check_fused("phase 24: cli.main_geom_drugs --compute_dtype bfloat16", 1)
    train, val, test = load_split_data(path)

    def batch_pads(splits, shuffle):
        return [int(b["node_mask"].shape[1]) for data in splits
                for b in GeomLoader(data, info, B, shuffle=shuffle, include_charges=False)]

    pads = {"train": batch_pads([train], True), "eval": batch_pads([val, test], False)}
    _check(pads["train"] == [184], f"GEOM bf16 train batch pads {pads['train']}")
    pads["chunks"] = chunk_pads(summary["sample_sizes"][0], n_stab,
                                covering_buckets(default_buckets(info), info["max_n_nodes"]))
    per = {"train": 1 + 2 * L, "eval": 1 + 3 * L, "chunks": (T + 1) * L + L}
    small = {k: sum(1 for p in v if p <= MAX_NODES) for k, v in pads.items()}
    large = {k: len(v) - small[k] for k, v in pads.items()}
    expected = {**_no_launches(),
                "egnn_block_bf16": sum(per[k] * small[k] for k in per),
                "egnn_block_bwd_bf16": 2 * L * small["train"],
                "gcl_rows_bf16": inv * (sum(per[k] * large[k] for k in per)
                                        + 2 * L * large["train"]),
                "coord_rows_bf16": sum(per[k] * large[k] for k in per),
                "gcl_rows_bwd_bf16": 2 * L * inv * large["train"],
                "coord_rows_bwd_bf16": 2 * L * large["train"]}
    losses = summary["losses"][0]
    _check(len(losses) == 1 and bool(np.all(np.isfinite(losses))), f"GEOM bf16 losses {losses}")
    _check(np.isfinite(summary["nll_val"][0]) and np.isfinite(summary["nll_test"][0]),
           f"GEOM bf16 NLLs {summary['nll_val']} {summary['nll_test']}")
    _check(launches == expected, f"GEOM bf16 launches {launches} != {expected} (pads {pads})")
    _check_trained(summary["state"], seed, decay, 1, os.path.join(geom_dir, "out", "bf16"), 24)
    shown = {k: v for k, v in launches.items() if v}
    print(f"phase 24: GEOM bf16 1 step at pad 184, loss {losses[0]:.4f}, valid NLL "
          f"{summary['nll_val'][0]:.4f}, test NLL {summary['nll_test'][0]:.4f}; launches "
          f"{json.dumps(shown)} = what the code implies for eval pads {pads['eval']}, sampled "
          f"chunk pads {pads['chunks']} (no f32 kernel); main() {wall:.1f} s on {card}",
          flush=True)
    out["geom"] = {"launches": launches, "pads": pads, "losses": losses, "main_seconds": wall,
                   "nll_val": summary["nll_val"][0], "nll_test": summary["nll_test"][0]}
    del summary
    out["grad_qm9"] = phase_grad(card, False, "bfloat16_pallas", phase_id=24)
    out["grad_geom"] = phase_grad(card, True, "bfloat16_pallas", phase_id=24)
    return out


def _sp_step_rank_bf16(raw, grid):
    """One rank of phase 25: the bf16 gradient step (phase 17's)."""
    import hashlib

    import torch.distributed as dist

    grp = grid.seq
    _, loss, grads, launches = _train_step_grads(grp.device, raw, grp, "bfloat16")
    h = hashlib.sha256()
    for g in grads.values():
        h.update(g.numpy().tobytes())
    ranks = [None] * grp.size
    dist.all_gather_object(ranks, {"rank": grp.rank, "grads_sha256": h.hexdigest(),
                                   "launches": launches})
    return {"loss": loss, "grads": {k: g.numpy() for k, g in grads.items()}, "ranks": ranks}


def phase_bf16_sp(card, tmpdir):
    """Phase 25: bf16 training under ``--sp 2`` on one card. First
    ``cli.main_geom_drugs --sp 2 --compute_dtype bfloat16`` at phase 16's
    recipe (two ranks sharing the card over gloo): exact per-rank launches,
    every one a bf16 kernel (#6/#7 bf16 over the slabs, the stability
    samples on #1/#3/#4 bf16). Then an SP-2 bf16 train step against the same
    step on one rank in bf16 and in f32 (phase 17's batch: GEOM recipe, B=2,
    pad 184), held to tests/torch_port_bf16_sites.py's sp_grads_report."""
    from geoldm_tpu_torch.parallel import sharding

    cli = phase_sp_train(card, tmpdir, "bfloat16", 25)
    sites = _bf16_sites()
    raw, _ = _phase17_batches()
    t0 = time.time()
    _, loss_ref, grads_ref, launches_ref = _train_step_grads("cuda", raw, None, "bfloat16")
    _check(not any(v for k, v in launches_ref.items() if k.startswith("sp_")),
           "the one-rank bf16 step ran SP kernels")
    _, loss_f32, grads_f32, _ = _train_step_grads("cuda", raw)
    got = sharding.spawn(1, 2, _sp_step_rank_bf16, (raw,), device="cuda")
    wall = time.time() - t0
    L, inv = 4, 1
    per_rank = {**_no_launches(), "sp_gcl_rows_bf16": inv * (1 + 4 * L),
                "sp_coord_rows_bf16": 1 + 2 * L, "sp_gcl_rows_bwd_bf16": inv * 2 * L,
                "sp_coord_rows_bwd_bf16": 2 * L}
    for r in got["ranks"]:
        _check(r["launches"] == per_rank, f"rank {r['rank']} bf16 launches {r['launches']} != "
                                          f"{per_rank}")
    _check(len({r["grads_sha256"] for r in got["ranks"]}) == 1,
           "the ranks' bf16 gradients differ after the all-reduce")
    _check(abs(got["loss"] - loss_ref) <= _LOSS_RTOL * abs(loss_ref),
           f"bf16 loss SP {got['loss']} vs one rank {loss_ref}")
    rep = sites.sp_grads_report(got["grads"], {k: g.numpy() for k, g in grads_ref.items()},
                                {k: g.numpy() for k, g in grads_f32.items()})
    _check(not rep["problems"], f"SP bf16 step vs one rank: {'; '.join(rep['problems'])}")
    err, dist = rep["mean_err"], rep["mean_to_f32"]
    shown = {k: v for k, v in got["ranks"][0]["launches"].items() if v}
    print(f"phase 25: SP-2 bf16 train-step gradient GEOM nf=256 4+4 blocks B=2 pad 184: loss SP "
          f"{got['loss']:.6f} one rank {loss_ref:.6f} (f32 {loss_f32:.6f}); {len(grads_ref)} "
          f"parameter tensors, worst max|d|/max|ref| {rep['worst_rel']:.2e} ({rep['worst']}; "
          f"tol {sites.SP_RTOL}), one-element tensors {rep['one_element']:.2e} (tol the larger "
          f"of that and 1/{sites.SP_SEPARATION:g} of their bf16-vs-f32 distance); mean {err:.3e} to the one-rank bf16 step, "
          f"{dist:.3e} to its f32 step ({dist / max(err, 1e-30):.1f}x, at least "
          f"{sites.SP_SEPARATION:g}x); launches per rank {json.dumps(shown)}; both ranks' "
          f"gradients bit-identical; {wall:.1f} s on {card}", flush=True)
    return {"cli": cli, "loss_sp": got["loss"], "loss_one_rank": loss_ref,
            "worst_rel": rep["worst_rel"], "worst": rep["worst"],
            "one_element": rep["one_element"], "mean_err": err, "mean_to_f32": dist,
            "launches_per_rank": [r["launches"] for r in got["ranks"]], "seconds": wall}


def _qm9_block(hidden, seed):
    import torch

    from geoldm_tpu_torch.config import EGNNConfig
    from geoldm_tpu_torch.nn.egnn import EquivariantBlock, init_parameters

    # A QM9 recipe's denoiser block: attention, tanh, 'sum' over factor 1.
    cfg = EGNNConfig(in_node_nf=2, out_node_nf=2, hidden_nf=hidden, n_layers=9, attention=True,
                     normalization_factor=1.0)
    block = EquivariantBlock(cfg)
    init_parameters(block, torch.Generator().manual_seed(seed))
    return block.to("cuda").eval()


def phase_cond_kernels(card):
    """Phase 26 (a): #1 and #2, f32 and bf16, at the conditional recipe's
    width H=192 (padded to 256 in the tile, 64 channels masked) against
    their plain versions: B=64, N in {16, 29}, n-8..n atoms. f32 within
    _KERNEL_RTOL * max(1, max|ref|) per output, weight gradients included,
    the backward from the forward's saved activations bit-identical to the
    recompute; bf16 under phase 21's and 23's gates. With card ms, plain
    ms and bounds."""
    import torch

    from geoldm_tpu_torch.ops import egnn_block

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    unrounded = _bf16_sites().unrounded
    bf16, dev, H, B, rows = torch.bfloat16, torch.device("cuda"), 192, 64, []

    def flat(r):
        return [*r[:3], *r[3]]

    def record(row, what):
        rows.append(row)
        tc = (f", {row['bound_tc_ms']:.4f} ms with the products at the split-TF32 rate"
              if "bound_tc_ms" in row else "")
        print(f"phase 26: {row['kernel']} N={row['N']} B={B} H={H}: {what}; kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}{tc}) on {card}", flush=True)

    for n in (16, 29):
        block = _qm9_block(H, 2600 + n)
        E, n_weights = block.cfg.edge_feat_nf, sum(p.numel() for p in block.parameters())
        inputs = [_ragged_inputs(26000 * n + rep, B, n, H, dev, 8) for rep in range(4)]
        n_real = inputs[0][3][:, :, 0].sum(dim=1).cpu().numpy()
        fwd_work, bwd_work = (_block_work(block.cfg, n_real, n, n_weights),
                              _bwd_work(block.cfg, n_real, n, n_weights))
        with torch.no_grad():
            for dt in (None, bf16):
                got = egnn_block.block_forward_cuda(block, *inputs[0], compute_dtype=dt)
                want = egnn_block.block_forward_plain(block, *inputs[0], compute_dtype=dt)
                want_f32 = egnn_block.block_forward_plain(block, *inputs[0])
                torch.cuda.synchronize()
                _check(all(bool(torch.isfinite(g).all()) for g in got),
                       f"#1 H=192 N={n} {dt} not finite")
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                scale = max([1.0] + [float(w.abs().max()) for w in want])
                tol = (_BF16_RTOL if dt else _KERNEL_RTOL) * scale
                _check(err <= tol, f"#1 H=192 N={n} {dt}: max|d|={err:.3e} > {tol:.3e}")
                extra = {}
                if dt:
                    mean_err = sum(float((g - w).abs().double().mean())
                                   for g, w in zip(got, want))
                    mean_f32 = sum(float((g - w).abs().double().mean())
                                   for g, w in zip(got, want_f32))
                    _check(_BF16_SEPARATION * mean_err <= mean_f32,
                           f"#1 bf16 H=192 N={n}: mean distance to plain f32 {mean_f32:.3e} "
                           f"is not {_BF16_SEPARATION:g}x the error {mean_err:.3e}")
                    extra = {"mean_abs_err": mean_err, "mean_to_f32_plain": mean_f32}
                ms = _time_ms(lambda *a: egnn_block.block_forward_cuda(block, *a,
                                                                       compute_dtype=dt), inputs)
                plain_ms = _time_ms(lambda *a: egnn_block.block_forward_plain(
                    block, *a, compute_dtype=dt), inputs)
                bound, bound_by = (_bf16_bounds(*fwd_work[:2]) if dt
                                   else _bounds(*fwd_work)[:2])
                if not dt:  # the f32 kernel's products run in split TF32
                    extra = {**extra, "bound_tc_ms": _bounds(*fwd_work)[2]}
                record({"kernel": "egnn_block_bf16" if dt else "egnn_block", "N": n, "B": B,
                        "H": H, "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by, **extra},
                       f"max|d| {err:.3e} (tol {tol:.2e})")
        cots = []
        for rep in range(3):
            rng = np.random.default_rng(26100 * n + rep)
            cots.append(tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                              .to(dev) for shape in ((B, n, H), (B, n, 3))))
        args = [inputs[rep] + cots[rep] for rep in range(3)]
        names = ["dh", "dx", "dx0"] + egnn_block.block_param_names(block)
        for dt in (None, bf16):
            got = flat(egnn_block.block_backward_cuda(block, *args[0], compute_dtype=dt))
            with torch.no_grad():
                _, _, saved = egnn_block._forward_launch(block, *inputs[0], save=True,
                                                         bf16=dt is not None)
            via_saved = flat(egnn_block._backward_launch(block, *args[0], saved,
                                                         dt is not None))
            torch.cuda.synchronize()
            for name, a, b_ in zip(names, got, via_saved):
                _check(torch.equal(a, b_), f"#2 H=192 N={n} {dt}: the saved route differs on "
                                           f"{name}")
            del saved, via_saved
            want = flat(egnn_block.block_backward_plain(block, *args[0], compute_dtype=dt))
            if dt:
                want_f32 = flat(egnn_block.block_backward_plain(block, *args[0]))
                with unrounded("cotangent", E):
                    want_cot = flat(egnn_block.block_backward_plain(block, *args[0],
                                                                    compute_dtype=dt))
                rep = _bf16_grads_check(f"#2 bf16 H=192 N={n}", names, got, want, want_f32,
                                        want_cot)
                fields, what = _bf16_fields(rep), (
                    f"max|d|/max(1,|ref|) {rep['max_rel']:.2e} ({rep['worst']}; tol "
                    f"{_BF16_RTOL}; {rep['flips']} one-step flips), mean to plain bf16 "
                    f"{rep['mean_err']:.3e}, to f32 {rep['mean_to_f32']:.3e}")
            else:
                err, worst = 0.0, ""
                for name, g, w in zip(names, got, want):
                    _check(bool(torch.isfinite(g).all()), f"#2 H=192 {name} not finite")
                    scale = max(1.0, float(w.abs().max()))
                    d = float((g - w).abs().max())
                    _check(d <= _KERNEL_RTOL * scale,
                           f"#2 H=192 N={n} disagrees with plain on {name}: max|d|={d:.3e} > "
                           f"{_KERNEL_RTOL}*{scale:.3g}")
                    if d > err:
                        err, worst = d, name
                fields, what = {"max_abs_err": err, "worst": worst}, (
                    f"max|d| {err:.3e} ({worst}; {len(names)} tensors each within "
                    f"{_KERNEL_RTOL}*max(1,max|ref|))")
            del got, want
            ms = _time_ms(lambda *a: egnn_block.block_backward_cuda(block, *a, compute_dtype=dt),
                          args)
            plain_ms = _time_ms(lambda *a: egnn_block.block_backward_plain(
                block, *a, compute_dtype=dt), args, warmup=1, reps=3)
            bound, bound_by = (_bf16_bounds(*bwd_work[:2]) if dt else _bounds(*bwd_work)[:2])
            if not dt:
                fields = {**fields, "bound_tc_ms": _bounds(*bwd_work)[2]}
            record({"kernel": "egnn_block_bwd_bf16" if dt else "egnn_block_bwd", "N": n, "B": B,
                    "H": H, **fields, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": bound_by}, what + "; the saved route bit-identical")
        del inputs, args
        torch.cuda.empty_cache()
    return rows


def phase_conditional(card, tmpdir):
    """Phase 26 (b, d-f): conditional QM9 at the README's conditional recipe
    (nf=192, 9 layers, latent_nf=1, normalize_factors [1, 8, 1], T=1000,
    conditioned on alpha, --context_dropout 0.1) on fabricated QM9-format
    splits of qm9_second_half. (b) 5 train steps through cli.main_qm9 with
    stability samples (50 DDIM jumps), valid and test NLL and the
    checkpoints: launches exact, args.pickle holds conditioning ['alpha'] and
    context_indicator True, the checkpoints load back. (d) the property
    classifier (nf=128, 7 layers) for one epoch through cli.main_qm9_prop.
    (e) cli.eval_conditional_qm9 --task edm --cfg_scale 2 --clip_z 15 on (b)'s
    and (d)'s checkpoints: 16 molecules at T=1000, (T+1)*2*9 + 9 launches of
    #1. (f) cli.serve on (b)'s checkpoint with --datadir and --conditioning:
    a seeded properties request and its replay, a cfg_scale 2 request, one
    without properties (dense), one with a misnamed property (refused);
    launches exact per request. Everything in f32."""
    import pickle

    import torch

    from geoldm_tpu_torch.cli import eval_conditional_qm9, main_qm9, main_qm9_prop, serve
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import write_qm9_splits
    from geoldm_tpu_torch.train.sampling import DEFAULT_SAMPLE_BUCKETS, n_chunks
    from geoldm_tpu_torch.utils.buckets import covering_buckets
    from geoldm_tpu_torch.utils.convert import load_reference_checkpoint

    info = get_dataset_info("qm9_second_half")
    B, steps, T, K, L, decay, seed, n_stab = 64, 5, 1000, 50, 9, 0.9999, 0, 8
    out = {}
    # qm9_second_half trains on half of the train split: 5 batches.
    write_qm9_splits(tmpdir, get_dataset_info("qm9"), {"train": 2 * B * steps, "valid": B,
                                                       "test": B}, seed=26)
    outdir = os.path.join(tmpdir, "out")
    argv = ["--datadir", tmpdir, "--outdir", outdir, "--exp_name", "cond", "--dataset",
            "qm9_second_half", "--train_diffusion", "--trainable_ae", "--conditioning", "alpha",
            "--nf", "192", "--n_layers", str(L), "--latent_nf", "1", "--normalize_factors",
            "[1,8,1]", "--context_dropout", "0.1", "--batch_size", str(B), "--diffusion_steps",
            str(T), "--ema_decay", str(decay), "--n_epochs", "1", "--test_epochs", "1",
            "--n_stability_samples", str(n_stab), "--eval_n_steps", str(K), "--seed", str(seed),
            "--no_wandb"]
    print(f"phase 26: python -m geoldm_tpu_torch.cli.main_qm9 {' '.join(argv)}", flush=True)
    _zero_launch_counts()
    t0 = time.time()
    summary = main_qm9.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launch_counts()
    losses = summary["losses"][0]
    _check(len(losses) == steps and bool(np.all(np.isfinite(losses))),
           f"conditional losses {losses}")
    _check(np.isfinite(summary["nll_val"][0]) and np.isfinite(summary["nll_test"][0]),
           f"conditional NLLs {summary['nll_val']} {summary['nll_test']}")
    # Per train step the encoder forward and the 9 decoder and 9 denoiser
    # blocks forward and backward; per eval batch encoder + decoder + 2
    # denoiser passes; per sampled chunk K+1 denoiser calls (unguided) and a
    # decode.
    chunks = n_chunks(summary["sample_sizes"][0], n_stab,
                      covering_buckets(DEFAULT_SAMPLE_BUCKETS, info["max_n_nodes"]))
    expected = {**_no_launches(),
                "egnn_block": steps * (1 + 2 * L) + 2 * (1 + 3 * L) + ((K + 1) * L + L) * chunks,
                "egnn_block_bwd": steps * 2 * L}
    _check(launches == expected, f"conditional training launches {launches} != {expected} "
                                 f"({chunks} chunks)")
    run = os.path.join(outdir, "cond")
    with open(os.path.join(run, "latest", "args.pickle"), "rb") as f:
        saved = pickle.load(f)
    _check(saved.conditioning == ["alpha"] and saved.context_indicator is True
           and saved.context_node_nf == 1,
           f"args.pickle: conditioning {saved.conditioning}, context_indicator "
           f"{getattr(saved, 'context_indicator', None)}, context_node_nf {saved.context_node_nf}")
    cfg = summary["state"].model.cfg
    _check(load_reference_checkpoint(os.path.join(run, "best"), "cpu")[1] == cfg
           and cfg.dynamics.context_node_nf == 2, "the checkpoint's config is not the run's")
    _check_trained(summary["state"], seed, decay, steps, run, 26)
    print(f"phase 26: conditional training {steps} steps, losses "
          f"{[round(v, 4) for v in losses]}, valid NLL {summary['nll_val'][0]:.4f}, test NLL "
          f"{summary['nll_test'][0]:.4f}, stability {summary['stability'][0]}; launches "
          f"fwd {launches['egnn_block']} bwd {launches['egnn_block_bwd']} = what the code "
          f"implies ({chunks} chunks of {K}-jump samples); args.pickle conditioning "
          f"{saved.conditioning}, context_indicator {saved.context_indicator}; main() "
          f"{wall:.1f} s on {card}", flush=True)
    out["train"] = {"launches": launches, "losses": losses, "main_seconds": wall,
                    "nll_val": summary["nll_val"][0], "nll_test": summary["nll_test"][0]}
    del summary

    cls_argv = ["--datadir", tmpdir, "--outf", outdir, "--exp_name", "cls_alpha", "--property",
                "alpha", "--epochs", "1", "--nf", "128", "--n_layers", "7"]
    t0 = time.time()
    res = main_qm9_prop.main(cls_argv)
    torch.cuda.synchronize()
    cls_dir = os.path.join(outdir, "cls_alpha")
    _check(np.isfinite(res["best_val"]) and np.isfinite(res["best_test"])
           and os.path.exists(os.path.join(cls_dir, "best", "classifier.npy"))
           and os.path.exists(os.path.join(cls_dir, "losess.json")),
           f"classifier run: {res['best_val']} {res['best_test']}")
    out["classifier"] = {"best_val": res["best_val"], "best_test": res["best_test"],
                         "seconds": time.time() - t0}
    print(f"phase 26: python -m geoldm_tpu_torch.cli.main_qm9_prop {' '.join(cls_argv)}: valid "
          f"MAE {res['best_val']:.4f}, test MAE {res['best_test']:.4f} in "
          f"{out['classifier']['seconds']:.1f} s on {card}", flush=True)

    n_eval = 16
    ev_argv = ["--generators_path", run, "--classifiers_path", cls_dir, "--datadir", tmpdir,
               "--property", "alpha", "--iterations", "1", "--batch_size", str(n_eval),
               "--cfg_scale", "2", "--clip_z", "15"]
    _zero_launch_counts()
    t0 = time.time()
    mae = eval_conditional_qm9.main(ev_argv + ["--task", "edm"])
    torch.cuda.synchronize()
    ev_seconds = time.time() - t0
    ev_launches = _launch_counts()
    want = {**_no_launches(), "egnn_block": (T + 1) * 2 * L + L}
    _check(ev_launches == want, f"guided eval launches {ev_launches} != (T+1)*2*9 + 9")
    _check(np.isfinite(mae), f"edm MAE {mae}")
    mae_qm9 = eval_conditional_qm9.main(ev_argv + ["--task", "qm9"])
    print(f"phase 26: eval_conditional_qm9 --task edm --cfg_scale 2 --clip_z 15: {n_eval} "
          f"molecules at T={T}, MAE {mae:.4f} (the classifier on real molecules: {mae_qm9:.4f}); "
          f"#1 launches {ev_launches['egnn_block']} = ({T}+1)*2*{L} + {L}; {ev_seconds:.1f} s "
          f"on {card}", flush=True)
    out["eval"] = {"launches": ev_launches, "mae": mae, "mae_qm9": mae_qm9,
                   "seconds": ev_seconds}

    batch_max = 64
    server, service = serve.main(["--model_path", os.path.join(run, "best"), "--port", "0",
                                  "--compute_dtype", "float32", "--batch_max", str(batch_max),
                                  "--datadir", tmpdir, "--conditioning", "alpha",
                                  "--no_warmup"],
                                 serve_forever=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    serve_launches, stats, bodies = _no_launches(), [], {}
    try:
        requests = [
            ("properties", {"sizes": [12, 14, 16], "seed": 7, "properties": {"alpha": 80.0},
                            "n_steps": K}, K, 1),
            ("replay", {"sizes": [12, 14, 16], "seed": 7, "properties": {"alpha": 80.0},
                        "n_steps": K}, K, 1),
            ("cfg_scale 2", {"sizes": [10, 12, 15], "seed": 8, "properties": {"alpha": 70.0},
                             "cfg_scale": 2.0, "n_steps": K}, K, 2),
            ("no properties, dense", {"n_samples": 4, "seed": 9}, T, 1),
        ]
        for name, req, k_steps, calls in requests:
            _zero_launch_counts()
            t1 = time.time()
            code, body = _request(base, "/sample", req)
            dt = time.time() - t1
            _check(code == 200, f"/sample {name} -> {code} {body}")
            sizes = req.get("sizes") or [len(m) for m in body["molecules"]]
            _check_molecules(body, sizes, info["atom_decoder"])
            chunks = n_chunks(sizes, batch_max, service.buckets)
            got = _launch_counts()
            want = {**_no_launches(), "egnn_block": ((k_steps + 1) * calls * L + L) * chunks}
            _check(got == want, f"/sample {name}: launches {got} != (({k_steps}+1)*{calls}*{L} "
                                f"+ {L})*{chunks}")
            for k, v in got.items():
                serve_launches[k] += v
            bodies[name] = body
            stats.append({"request": name, "molecules": body["n"], "seconds": dt,
                          "properties": body["properties"], "cfg_scale": body["cfg_scale"],
                          "launches": got["egnn_block"]})
            print(f"phase 26: /sample {name}: {body['n']} molecules in {dt:.2f} s, properties "
                  f"{body['properties']}, cfg_scale {body['cfg_scale']}, #1 launches "
                  f"{got['egnn_block']} = (({k_steps}+1)*{calls}*{L} + {L})*{chunks} on {card}",
                  flush=True)
        _check(bodies["replay"]["molecules"] == bodies["properties"]["molecules"],
               "the seeded properties request did not replay")
        _check(bodies["no properties, dense"]["properties"] == "sampled-from-data-distribution",
               "a request without properties did not draw them")
        code, body = _request(base, "/sample", {"sizes": [5], "properties": {"alpah": 80.0}})
        _check(code == 400 and "properties is missing 'alpha'" in body.get("error", ""),
               f"a misnamed property -> {code} {body}")
        print(f"phase 26: seeded replay identical; misnamed property -> 400 ({body['error']})",
              flush=True)
    finally:
        server.shutdown()
        server.server_close()
    out["serve"] = {"launches": serve_launches, "requests": stats}
    return out


# ---------------------------------------------------------------------------
# Phases 27-30: data parallelism, DP x SP, conditioning under SP, eval --dp
# ---------------------------------------------------------------------------


def _grad_gate(phase, what, got, want, loss, loss_ref):
    """Loss within _LOSS_RTOL relative and every gradient within _GRAD_RTOL *
    max|ref| of the one-rank step's -> (worst ratio, its tensor)."""
    import torch

    _check(abs(loss - loss_ref) <= _LOSS_RTOL * abs(loss_ref),
           f"phase {phase}: loss {what} {loss} vs one rank {loss_ref}")
    _check(set(got) == set(want) and len(want) > 0,
           f"phase {phase}: {what} and one rank gave gradients to different parameters")
    worst, worst_name = 0.0, ""
    for k, ref in want.items():
        g = torch.as_tensor(got[k])
        _check(bool(torch.isfinite(g).all()), f"phase {phase}: {what} gradient of {k} not finite")
        d = float((g - ref).abs().max())
        scale = float(ref.abs().max())
        _check(d <= _GRAD_RTOL * scale, f"phase {phase}: gradient of {k}: {what} vs one rank "
                                        f"max|d|={d:.3e} > {_GRAD_RTOL}*{scale:.3e}")
        if scale and d / scale >= worst:
            worst, worst_name = d / scale, k
    return worst, worst_name


def _grid_rank(kind, raw, timed, grid):
    """One rank of phases 27-29: the recipe's gradient step on the global
    batch ``raw`` over the grid (``_train_step_grads``), then, with a global
    ``timed`` batch, 3 synchronised recipe train steps on this rank's rows and
    the step's collectives alone (the SP sum of the block weights' gradients
    and the data ranks' mean of every gradient) -> rank 0: the loss, the
    gradients and every rank's gradient digest, launches and times."""
    import hashlib

    import torch
    import torch.distributed as dist

    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.parallel import sharding
    from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step
    from geoldm_tpu_torch.train.trainer import prepare_host, to_device

    model, loss, grads, launches = _train_step_grads(grid.device, raw, grid.seq, kind=kind,
                                                     data=grid.data)
    h = hashlib.sha256()
    for g in grads.values():
        h.update(g.numpy().tobytes())
    mine = {"rank": grid.rank, "grads_sha256": h.hexdigest(), "launches": launches}
    if timed is not None:
        cfg, info, _ = _recipe(kind)
        state = create_train_state(model, cfg, 1e-4, ema_decay=0.9999, dp_group=grid.data)
        step = make_train_step(cfg, 0.9999)
        batch = to_device(sharding.shard_rows(prepare_host(timed, DistributionNodes(
            info.n_nodes)), grid.data), grid.device)
        noise = sharding.wrap_noise(torch.Generator(device=grid.device).manual_seed(7),
                                    grid.data)

        mine["step_ms"] = _host_ms(lambda: step(state, batch, noise))
        if grid.seq is not None:
            mine["sp_sum_ms"] = _host_ms(lambda: sharding.reduce_grads(state.sp_params, grid.seq))
        if grid.data is not None:
            mine["dp_mean_ms"] = _host_ms(lambda: sharding.reduce_grads(state.params, grid.data,
                                                                        mean=True))
        mine["local_batch"] = int(batch["x"].shape[0])
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    return {"loss": loss, "grads": {k: g.numpy() for k, g in grads.items()}, "ranks": ranks}


def _grid_grad(card, phase, kind, raw, timed, dp, sp_size, per_rank):
    """The recipe step over a dp x sp grid of ranks sharing the card against
    one rank's step on the card: the gate of ``_grad_gate``, the ranks'
    gradients bit-identical, each rank's launches ``per_rank``; prints the
    timed steps and collectives."""
    from geoldm_tpu_torch.parallel import sharding

    t0 = time.time()
    _, loss_ref, grads_ref, _ = _train_step_grads("cuda", raw, kind=kind)
    got = sharding.spawn(dp, sp_size, _grid_rank, (kind, raw, timed), device="cuda")
    wall = time.time() - t0
    what = f"DP-{dp}" + (f" x SP-{sp_size}" if sp_size > 1 else "") if dp > 1 else f"SP-{sp_size}"
    worst, worst_name = _grad_gate(phase, what, got["grads"], grads_ref, got["loss"], loss_ref)
    _check(len({r["grads_sha256"] for r in got["ranks"]}) == 1,
           f"phase {phase}: the ranks' gradients differ after the collectives")
    for r in got["ranks"]:
        _check(r["launches"] == per_rank, f"phase {phase}: rank {r['rank']} launches "
                                          f"{r['launches']} != {per_rank}")
    print(f"phase {phase}: {what} train-step gradient ({kind} recipe, B={len(raw['x'])} "
          f"global): loss {got['loss']:.6f} one rank {loss_ref:.6f}; {len(grads_ref)} "
          f"parameter tensors, worst max|d|/max|ref| {worst:.2e} ({worst_name}; tol "
          f"{_GRAD_RTOL}); every rank's gradient bit-identical; launches per rank "
          f"{json.dumps({k: v for k, v in per_rank.items() if v})}; {wall:.1f} s", flush=True)
    out = {"loss": got["loss"], "loss_one_rank": loss_ref, "worst_rel": worst,
           "worst": worst_name, "seconds": wall}
    if timed is not None:
        for key in ("step_ms", "sp_sum_ms", "dp_mean_ms"):
            if key in got["ranks"][0]:
                out[key] = [r[key] for r in got["ranks"]]
        for r in got["ranks"]:
            coll = "; ".join(f"{name} {', '.join(f'{v:.2f}' for v in r[key])} ms"
                             for key, name in (("sp_sum_ms", "SP sum"),
                                               ("dp_mean_ms", "DP mean")) if key in r)
            print(f"phase {phase}: {what} train step, {len(timed['x'])} molecules global, "
                  f"{r['local_batch']} on rank {r['rank']}: "
                  f"{', '.join(f'{v:.1f}' for v in r['step_ms'])} ms; collectives alone: "
                  f"{coll} (host clock around synchronised calls; {dp * sp_size} ranks sharing "
                  f"one card over gloo: correctness and overhead, not scaling) on {card}",
                  flush=True)
    return out


def _rank_expected(per_step, per_eval, n_train, n_eval, chunk_pads, K, L, inv, sp_route):
    """Launches per rank of a training CLI run: ``n_train`` steps and
    ``n_eval`` eval batches (over the SP kernels with ``sp_route``, else the
    whole-block ones; ``per_step`` / ``per_eval`` forward blocks each),
    plus this rank's stability chunks at ``chunk_pads`` on the single-device
    route, (K+1)*L + L blocks each: #1 up to pad 64, #3/#4 past it."""
    from geoldm_tpu_torch.ops.egnn_block import MAX_NODES

    per_chunk = (K + 1) * L + L
    small = sum(1 for p in chunk_pads if p <= MAX_NODES)
    large = len(chunk_pads) - small
    e = _no_launches()
    e["egnn_block"] = per_chunk * small
    e["gcl_rows"], e["coord_rows"] = inv * per_chunk * large, per_chunk * large
    if sp_route:
        e["sp_gcl_rows"] = inv * (n_train * (1 + 4 * L) + n_eval * (1 + 3 * L))
        e["sp_coord_rows"] = n_train * (1 + 2 * L) + n_eval * (1 + 3 * L)
        e["sp_gcl_rows_bwd"], e["sp_coord_rows_bwd"] = inv * 2 * L * n_train, 2 * L * n_train
    else:
        e["egnn_block"] += n_train * per_step + n_eval * per_eval
        e["egnn_block_bwd"] = n_train * 2 * L
    return e


def _check_replicas(phase, summary, n_ranks):
    replicas = summary["replicas"]
    _check([r["rank"] for r in replicas] == list(range(n_ranks)),
           f"phase {phase}: replicas {[r['rank'] for r in replicas]}")
    _check(len({r["digest"] for r in replicas}) == 1,
           f"phase {phase}: the ranks' train states differ: "
           f"{[r['digest'][:12] for r in replicas]}")
    _check(all(r["stability"] == summary["stability"] for r in replicas),
           f"phase {phase}: the ranks scored different stability samples")
    _check_fused(f"phase {phase}: {n_ranks} ranks", sum(map(len, summary["losses"])), replicas)
    return replicas


def phase_dp_train(card, tmpdir):
    """Phase 27: ``cli.main_qm9 --dp 2`` at the QM9 recipe (nf=256, 9
    layers, latent_nf=1, T=1000, B=64 global: 32 molecules per rank), 3
    steps, two ranks sharing the card over gloo; then the DP-2 gradient
    against one rank and timed DP-2 steps."""
    import torch

    from geoldm_tpu_torch.cli import main_qm9
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.qm9 import QM9Loader, load_qm9
    from geoldm_tpu_torch.data.synthetic import write_qm9_splits
    from geoldm_tpu_torch.parallel import sharding
    from geoldm_tpu_torch.train.sampling import DEFAULT_SAMPLE_BUCKETS, chunk_pads
    from geoldm_tpu_torch.utils.buckets import covering_buckets

    info = get_dataset_info("qm9")
    B, steps, T, K, L, n_stab, dp = 64, 3, 1000, 50, 9, 4, 2
    write_qm9_splits(tmpdir, info, {"train": B * steps, "valid": B, "test": B}, seed=27)
    argv = ["--datadir", tmpdir, "--outdir", os.path.join(tmpdir, "out"), "--exp_name", "dp",
            "--dp", str(dp), "--train_diffusion", "--trainable_ae", "--nf", "256",
            "--n_layers", str(L), "--latent_nf", "1", "--diffusion_steps", str(T),
            "--batch_size", str(B), "--ema_decay", "0.9999", "--n_epochs", "1",
            "--test_epochs", "1", "--n_stability_samples", str(n_stab), "--eval_n_steps",
            str(K), "--seed", "0", "--no_wandb"]
    rule = sharding.placement(dp, "cuda")[2]
    print(f"phase 27: python -m geoldm_tpu_torch.cli.main_qm9 {' '.join(argv)}", flush=True)
    _zero_launch_counts()
    t0 = time.time()
    summary = main_qm9.main(argv)
    wall = time.time() - t0
    _check(not any(_launch_counts().values()), f"phase 27: the launching process ran kernels: "
                                               f"{_launch_counts()}")
    losses = summary["losses"][0]
    _check(len(losses) == steps and bool(np.all(np.isfinite(losses))), f"losses {losses}")
    _check(np.isfinite(summary["nll_val"][0]) and np.isfinite(summary["nll_test"][0]),
           f"phase 27: NLLs {summary['nll_val']} {summary['nll_test']}")
    replicas = _check_replicas(27, summary, dp)
    # Per rank: each step runs one rank's blocks on 32 molecules (encoder,
    # 9 decoder and 9 denoiser blocks forward, 18 backward), each eval batch
    # 1 + 3*9 on its half, and chunk i of the stability samples runs on rank
    # i % 2.
    pads = chunk_pads(summary["sample_sizes"][0], n_stab,
                      covering_buckets(DEFAULT_SAMPLE_BUCKETS, info["max_n_nodes"]))
    for r in replicas:
        mine = [p for i, p in enumerate(pads) if i % dp == r["rank"]]
        want = _rank_expected(1 + 2 * L, 1 + 3 * L, steps, 2, mine, K, L, 1, False)
        _check(r["launches"] == want, f"phase 27: rank {r['rank']} launches {r['launches']} "
                                      f"!= {want} (chunk pads {pads})")
    print(f"phase 27: {rule}; {steps} steps of {B} molecules ({B // dp} per rank), losses "
          f"{[round(v, 4) for v in losses]}, valid NLL {summary['nll_val'][0]:.4f}, test NLL "
          f"{summary['nll_test'][0]:.4f}, stability {summary['stability'][0]} on every rank "
          f"(chunk pads {pads}, chunk i on rank i % {dp}); launches per rank "
          f"{[{k: v for k, v in r['launches'].items() if v} for r in replicas]} = what the "
          f"code implies; train states bit-identical (sha256 {replicas[0]['digest'][:16]}); "
          f"main() {wall:.1f} s, epoch {summary['epoch_seconds'][0]:.1f} s on {card}",
          flush=True)
    splits, _ = load_qm9(tmpdir)
    timed = next(iter(QM9Loader(splits["train"], B, info["max_n_nodes"])))
    per_rank = {**_no_launches(), "egnn_block": 1 + 2 * L, "egnn_block_bwd": 2 * L}
    grad = _grid_grad(card, 27, "qm9", _qm9_grad_batch(), timed, dp, 1, per_rank)
    torch.cuda.empty_cache()
    return {"launches": {k: sum(r["launches"][k] for r in replicas) for k in _no_launches()},
            "launches_per_rank": [r["launches"] for r in replicas], "rule": rule,
            "losses": losses, "nll_val": summary["nll_val"][0],
            "nll_test": summary["nll_test"][0], "stability": summary["stability"][0],
            "main_seconds": wall, "epoch_seconds": summary["epoch_seconds"][0], "grad": grad}


def phase_grid_train(card, tmpdir):
    """Phase 28: ``cli.main_geom_drugs --dp 2 --sp 2`` at the GEOM recipe:
    four ranks share the card (data index r // 2, seq index r % 2), one
    step of 32 molecules at pad 184 (16 per data row, their atom rows split
    over its two ranks); then the DP-2 x SP-2 gradient against one rank and
    timed steps."""
    import torch

    from geoldm_tpu_torch.cli import main_geom_drugs
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.geom import GeomLoader, load_split_data
    from geoldm_tpu_torch.data.synthetic import write_geom_conformers
    from geoldm_tpu_torch.parallel import sharding
    from geoldm_tpu_torch.train.sampling import chunk_pads, default_buckets
    from geoldm_tpu_torch.utils.buckets import covering_buckets

    info = get_dataset_info("geom")
    B, T, K, L, inv, n_stab, dp, sp_size = 32, 1000, 50, 4, 1, 2, 2, 2
    hist = sorted(dict(info.n_nodes_histogram))
    rng = np.random.default_rng(28)
    sizes = [int(v) for v in rng.choice([k for k in hist if 129 <= k <= 181], size=B)]
    path = write_geom_conformers(tmpdir, info, len(sizes) * 5 // 4, seed=28, sizes=sizes)
    argv = ["--datadir", tmpdir, "--outdir", os.path.join(tmpdir, "out"), "--exp_name", "grid",
            "--dp", str(dp), "--sp", str(sp_size), "--train_diffusion", "--trainable_ae",
            "--nf", "256", "--n_layers", str(L), "--latent_nf", "2", "--include_charges",
            "False", "--diffusion_steps", str(T), "--batch_size", str(B), "--lr", "5e-5",
            "--ema_decay", "0.9999", "--n_epochs", "1", "--test_epochs", "1",
            "--n_stability_samples", str(n_stab), "--eval_n_steps", str(K), "--seed", "0",
            "--no_wandb"]
    rule = sharding.placement(dp * sp_size, "cuda")[2]
    print(f"phase 28: python -m geoldm_tpu_torch.cli.main_geom_drugs {' '.join(argv)}",
          flush=True)
    _zero_launch_counts()
    t0 = time.time()
    summary = main_geom_drugs.main(argv)
    wall = time.time() - t0
    _check(not any(_launch_counts().values()), "phase 28: the launching process ran kernels")
    losses = summary["losses"][0]
    _check(len(losses) == 1 and bool(np.all(np.isfinite(losses))), f"losses {losses}")
    _check(np.isfinite(summary["nll_val"][0]) and np.isfinite(summary["nll_test"][0]),
           f"phase 28: NLLs {summary['nll_val']} {summary['nll_test']}")
    replicas = _check_replicas(28, summary, dp * sp_size)
    train, val, test = load_split_data(path)
    train_pads = [int(b["node_mask"].shape[1]) for b in GeomLoader(train, info, B)]
    _check(train_pads == [184], f"phase 28: train batch pads {train_pads}")
    n_eval = sum(1 for data in (val, test) for _ in GeomLoader(data, info, B, shuffle=False,
                                                               include_charges=False))
    pads = chunk_pads(summary["sample_sizes"][0], n_stab,
                      covering_buckets(default_buckets(info), info["max_n_nodes"]))
    # Per rank, phase 16's counts for one step (each SP slab stage once per
    # call, whatever the rows) and n_eval eval batches; chunk i of the
    # stability samples runs on data row i % 2 (both of its ranks).
    for r in replicas:
        mine = [p for i, p in enumerate(pads) if i % dp == r["rank"] // sp_size]
        want = _rank_expected(0, 0, 1, n_eval, mine, K, L, inv, True)
        _check(r["launches"] == want, f"phase 28: rank {r['rank']} launches {r['launches']} "
                                      f"!= {want} (chunk pads {pads}, {n_eval} eval batches)")
    print(f"phase 28: {rule}, data index r // {sp_size}, seq index r % {sp_size}; 1 step of "
          f"{B} molecules at pad 184 ({B // dp} per data row), loss {losses[0]:.4f}, valid NLL "
          f"{summary['nll_val'][0]:.4f}, test NLL {summary['nll_test'][0]:.4f} ({n_eval} eval "
          f"batches), stability {summary['stability'][0]} (chunk pads {pads}); launches per "
          f"rank {[{k: v for k, v in r['launches'].items() if v} for r in replicas]} = what "
          f"the code implies; the 4 train states bit-identical (sha256 "
          f"{replicas[0]['digest'][:16]}); main() {wall:.1f} s, epoch "
          f"{summary['epoch_seconds'][0]:.1f} s on {card}", flush=True)
    raw, timed = _phase17_batches()
    per_rank = {**_no_launches(), "sp_gcl_rows": inv * (1 + 4 * L), "sp_coord_rows": 1 + 2 * L,
                "sp_gcl_rows_bwd": inv * 2 * L, "sp_coord_rows_bwd": 2 * L}
    grad = _grid_grad(card, 28, "geom", raw, timed[184], dp, sp_size, per_rank)
    torch.cuda.empty_cache()
    return {"launches": {k: sum(r["launches"][k] for r in replicas) for k in _no_launches()},
            "launches_per_rank": [r["launches"] for r in replicas], "rule": rule,
            "losses": losses, "nll_val": summary["nll_val"][0],
            "nll_test": summary["nll_test"][0], "stability": summary["stability"][0],
            "main_seconds": wall, "epoch_seconds": summary["epoch_seconds"][0], "grad": grad}


def phase_cond_sp(card, tmpdir):
    """Phase 29: conditioning under SP. (a) #6/#7 at the conditional
    recipe's H=192 on QM9's N=29 padded to 30 over S=2 (both slabs, B=64)
    against their plain versions, weight gradients included; (b)
    ``cli.main_qm9`` at the conditional recipe with ``--sp 2``, 2 steps; (c)
    the SP-2 conditional gradient (phase 26's batch and keep mask) against
    one rank."""
    import torch

    from geoldm_tpu_torch.cli import main_qm9
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import write_qm9_splits
    from geoldm_tpu_torch.parallel import sharding
    from geoldm_tpu_torch.train.sampling import DEFAULT_SAMPLE_BUCKETS, chunk_pads
    from geoldm_tpu_torch.utils.buckets import covering_buckets

    rows = phase_sp_kernels(card, H=192, cases=[("sum", 29, 2, None, 64)], b_bwd=64,
                            spread=8, phase=29)
    info = get_dataset_info("qm9_second_half")
    B, steps, T, K, L, n_stab, sp_size = 64, 2, 1000, 50, 9, 4, 2
    write_qm9_splits(tmpdir, get_dataset_info("qm9"), {"train": 2 * B * steps, "valid": B,
                                                       "test": B}, seed=29)
    argv = ["--datadir", tmpdir, "--outdir", os.path.join(tmpdir, "out"), "--exp_name",
            "cond_sp", "--sp", str(sp_size), "--dataset", "qm9_second_half",
            "--train_diffusion", "--trainable_ae", "--conditioning", "alpha", "--nf", "192",
            "--n_layers", str(L), "--latent_nf", "1", "--normalize_factors", "[1,8,1]",
            "--context_dropout", "0.1", "--batch_size", str(B), "--diffusion_steps", str(T),
            "--ema_decay", "0.9999", "--n_epochs", "1", "--test_epochs", "1",
            "--n_stability_samples", str(n_stab), "--eval_n_steps", str(K), "--seed", "0",
            "--no_wandb"]
    rule = sharding.placement(sp_size, "cuda")[2]
    print(f"phase 29: python -m geoldm_tpu_torch.cli.main_qm9 {' '.join(argv)}", flush=True)
    _zero_launch_counts()
    t0 = time.time()
    summary = main_qm9.main(argv)
    wall = time.time() - t0
    _check(not any(_launch_counts().values()), "phase 29: the launching process ran kernels")
    losses = summary["losses"][0]
    _check(len(losses) == steps and bool(np.all(np.isfinite(losses))), f"losses {losses}")
    _check(np.isfinite(summary["nll_val"][0]) and np.isfinite(summary["nll_test"][0]),
           f"phase 29: NLLs {summary['nll_val']} {summary['nll_test']}")
    replicas = _check_replicas(29, summary, sp_size)
    # Every EGNN call runs over the slabs (N=29 padded to 30, 15 rows a
    # rank); the stability samples run on the single-device route on both
    # ranks (#1 at pads <= 32).
    pads = chunk_pads(summary["sample_sizes"][0], n_stab,
                      covering_buckets(DEFAULT_SAMPLE_BUCKETS, info["max_n_nodes"]))
    want = _rank_expected(0, 0, steps, 2, pads, K, L, 1, True)
    for r in replicas:
        _check(r["launches"] == want, f"phase 29: rank {r['rank']} launches {r['launches']} != "
                                      f"{want} (chunk pads {pads})")
    print(f"phase 29: {rule}; conditional recipe (nf=192, alpha, --context_dropout 0.1) "
          f"{steps} steps, losses {[round(v, 4) for v in losses]}, valid NLL "
          f"{summary['nll_val'][0]:.4f}, test NLL {summary['nll_test'][0]:.4f}, stability "
          f"{summary['stability'][0]}; launches per rank "
          f"{json.dumps({k: v for k, v in want.items() if v})} = what the code implies; train "
          f"states bit-identical; main() {wall:.1f} s on {card}", flush=True)
    per_rank = {**_no_launches(), "sp_gcl_rows": 1 + 4 * L, "sp_coord_rows": 1 + 2 * L,
                "sp_gcl_rows_bwd": 2 * L, "sp_coord_rows_bwd": 2 * L}
    grad = _grid_grad(card, 29, "cond", _qm9_grad_batch(cond=True), None, 1, sp_size,
                      per_rank)
    torch.cuda.empty_cache()
    return {"kernel_rows": rows, "launches": {k: sum(r["launches"][k] for r in replicas)
                                              for k in _no_launches()},
            "rule": rule, "losses": losses, "nll_val": summary["nll_val"][0],
            "nll_test": summary["nll_test"][0], "main_seconds": wall, "grad": grad}


def phase_dp_eval(card, qm9_dir):
    """Phase 30: ``cli.eval_analyze --dp 2`` on phase 18's QM9 checkpoint
    against ``--dp 1``: 12 molecules with 20 DDIM jumps (chunks of 4, chunk
    i on rank i % 2) and the packed NLL (valid, 2 test passes, 32 of each
    batch's 64 rows a rank): the molecules bit-identical, the NLLs within
    1e-5 relative."""
    import torch

    from geoldm_tpu_torch.cli import eval_analyze
    from geoldm_tpu_torch.train.sampling import DEFAULT_SAMPLE_BUCKETS, chunk_pads
    from geoldm_tpu_torch.utils.buckets import covering_buckets

    n_samples, K, L, passes, dp = 12, 20, 9, 2, 2
    argv = ["--model_path", os.path.join(qm9_dir, "out", "resumed"), "--datadir", qm9_dir,
            "--n_samples", str(n_samples), "--batch_size_gen", "4", "--n_steps", str(K),
            "--batch_size_nll", "64", "--n_test_passes", str(passes)]
    print(f"phase 30: python -m geoldm_tpu_torch.cli.eval_analyze {' '.join(argv)} [--dp 2]",
          flush=True)
    t0 = time.time()
    one = eval_analyze.main(argv)
    torch.cuda.synchronize()
    t1 = time.time()
    _zero_launch_counts()
    two = eval_analyze.main(argv + ["--dp", str(dp)])
    t2 = time.time()
    _check(not any(_launch_counts().values()), "phase 30: the launching process ran kernels")
    for k in ("one_hot", "x", "node_mask", "n_atoms"):
        _check(np.array_equal(two["molecules"][k], one["molecules"][k]),
               f"phase 30: --dp 2 generated other molecules than --dp 1 ({k})")
    _check(two["stability"] == one["stability"] and two["rdkit"] == one["rdkit"],
           f"phase 30: scores {two['stability']} {two['rdkit']} vs {one['stability']} "
           f"{one['rdkit']}")
    nlls = list(zip([two["nll_val"], *two["nll_tests"]], [one["nll_val"], *one["nll_tests"]]))
    worst = max(abs(a - b) / abs(b) for a, b in nlls)
    _check(worst <= 1e-5, f"phase 30: NLLs --dp 2 vs --dp 1 {nlls}")
    pads = chunk_pads(one["molecules"]["n_atoms"], 4, covering_buckets(DEFAULT_SAMPLE_BUCKETS,
                                                                        29))
    for r, counts in enumerate(two["launches_per_rank"]):
        chunks = sum(1 for i in range(len(pads)) if i % dp == r)
        want = {**_no_launches(), "egnn_block": ((K + 1) * L + L) * chunks
                + (1 + 3 * L) * (1 + passes)}
        _check(counts == want, f"phase 30: rank {r} launches {counts} != {want}")
    print(f"phase 30: eval_analyze --dp {dp}: {n_samples} molecules ({len(pads)} chunks, chunk i "
          f"on rank i % {dp}) bit-identical to --dp 1, stability {two['stability']}; NLLs "
          f"{[round(a, 6) for a, _ in nlls]}, worst relative difference {worst:.2e} (tol 1e-5); "
          f"launches per rank {[c['egnn_block'] for c in two['launches_per_rank']]} of #1 = "
          f"what the code implies; --dp 1 {t1 - t0:.1f} s, --dp 2 {t2 - t1:.1f} s (main()) on "
          f"{card}", flush=True)
    return {"launches": {k: sum(c[k] for c in two["launches_per_rank"])
                         for k in _no_launches()},
            "nll_worst_rel": worst, "seconds_dp1": t1 - t0, "seconds_dp2": t2 - t1,
            "stability": two["stability"]}



# ---------------------------------------------------------------------------
# Phases 31-33: the model variants (the plain E(n) diffusion model, the
# learned noise schedule, the GNN ablation) at full width.
# ---------------------------------------------------------------------------


def _variant_grad(card, phase, cfg, fwd, bwd, eval_fwd):
    """One train-step gradient of ``cfg`` (phase 8's batch: B=8, N=29; seed-5
    weights, noise stream 12) on the card against the plain path on the CPU,
    with #1/#2 launched exactly ``fwd``/``bwd`` times, and the same batch's
    t0_always NLL (``eval_fwd`` #1 launches) card vs CPU within
    _DENOISER_RTOL * max(1, |ref|) per molecule. Every gradient within
    _GRAD_RTOL * max|ref|, but the learned gamma network's layers': its
    normalisation makes gamma nearly invariant to them, so their gradient
    sums the vlb loss's ~1e3-sized dL/dgamma terms against small, cancelling
    sensitivities, and f32 leaves it rounding (at this width it comes out in
    steps of 2^-12 .. 2^-2, l1.weight's exactly 0, on the CPU;
    tests/test_torch_port_variants.py:_gamma_layer_ok); they must be finite,
    while gamma_0's and gamma_1's gradients, which carry every vlb weight of
    the loss, are held to the gate."""
    import torch

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train.trainer import prepare_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = get_dataset_info("qm9")
    raw = _qm9_grad_batch()
    grads, losses, nll, seconds = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.time()
        model = factory.build_model(cfg, dev, torch.Generator().manual_seed(5))
        batch = prepare_batch(raw, DistributionNodes(info.n_nodes), dev)
        args = (batch["x"], batch["h_cat"], batch["h_int"], batch["node_mask"])
        _zero_launch_counts()
        loss = (factory.model_nll_fn(cfg, training=True)(model, _Replay(12), *args)
                - batch["log_pN"]).mean()
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = _launch_counts()
            want = {**_no_launches(), "egnn_block": fwd, "egnn_block_bwd": bwd}
            _check(launches == want, f"phase {phase}: train-step launches {launches} != {want}")
        with torch.no_grad():
            _zero_launch_counts()
            nll[dev] = factory.model_nll_fn(cfg, training=False)(model, _Replay(13), *args
                                                                 ).cpu().numpy()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = _launch_counts()
            want = {**_no_launches(), "egnn_block": eval_fwd}
            _check(launches == want, f"phase {phase}: t0_always NLL launches {launches} != {want}")
        seconds[dev] = time.time() - t0
        losses[dev] = float(loss.detach())
        grads[dev] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                      if p.grad is not None}
    # An l2 loss is a mean of squared errors over all channels, held to
    # _LOSS_RTOL; a vlb loss weights each molecule's error by (T + 1)(SNR
    # ratio - 1) (up to ~1e3 here) and is held to the denoiser's own gate,
    # _DENOISER_RTOL, which the error it squares carries.
    loss_rtol = _LOSS_RTOL if cfg.diffusion.loss_type == "l2" else _DENOISER_RTOL
    _check(abs(losses["cuda"] - losses["cpu"]) <= loss_rtol * abs(losses["cpu"]),
           f"phase {phase}: loss card {losses['cuda']} vs CPU {losses['cpu']} (tol {loss_rtol})")
    _check(set(grads["cuda"]) == set(grads["cpu"]) and grads["cpu"],
           f"phase {phase}: card and CPU gave gradients to different parameters")
    _check(bool(np.all(np.isfinite(nll["cuda"]))), f"phase {phase}: NLL not finite")
    nll_err = float(np.max(np.abs(nll["cuda"] - nll["cpu"]) / np.maximum(1.0, np.abs(nll["cpu"]))))
    _check(nll_err <= _DENOISER_RTOL, f"phase {phase}: t0_always NLL card {nll['cuda']} vs CPU "
                                      f"{nll['cpu']}")
    worst, worst_name, layers = 0.0, "", []
    for k, ref in grads["cpu"].items():
        g = grads["cuda"][k]
        _check(bool(torch.isfinite(g).all()), f"phase {phase}: gradient of {k} not finite")
        d, scale = float((g - ref).abs().max()), float(ref.abs().max())
        if k.startswith("gamma.l"):  # finite (checked above); its size is rounding
            layers.append(f"{k} {d:.2e} of {scale:.2e}")
            continue
        _check(d <= _GRAD_RTOL * scale, f"phase {phase}: gradient of {k}: card vs CPU "
                                        f"max|d|={d:.3e} > {_GRAD_RTOL}*{scale:.3e}")
        if scale and d / scale >= worst:
            worst, worst_name = d / scale, k
    print(f"phase {phase}: train-step gradient (B=8, N=29): loss card {losses['cuda']:.6f} CPU "
          f"{losses['cpu']:.6f}; {len(grads['cpu'])} tensors, worst max|d|/max|ref| "
          f"{worst:.2e} ({worst_name}; tol {_GRAD_RTOL})"
          + (f"; gamma layers (finite; card-CPU max|d| of max|ref|): {', '.join(layers)}"
             if layers else "")
          + f"; launches #1 {fwd} #2 {bwd}; t0_always NLL max|d|/max(1,|ref|) {nll_err:.2e} "
          f"({eval_fwd} #1 launches) on {card} ({seconds['cuda']:.1f} s card, "
          f"{seconds['cpu']:.1f} s CPU)", flush=True)
    return {"loss_cuda": losses["cuda"], "loss_cpu": losses["cpu"], "worst_rel": worst,
            "worst": worst_name, "gamma_layers": layers, "nll_rel": nll_err}


def _serve_requests(card, phase, path, requests, L, dec):
    """cli.serve (its default compute dtype, bfloat16_mixed) on the
    checkpoint at ``path``: each (name, body, K) request's molecules and
    launches of the bf16 and the f32 kernel, exactly (K - round(0.1 K)) * L +
    dec (``dec`` decoder blocks) in bf16 and (round(0.1 K) + 1) * L in f32 per
    chunk. -> ({name: (body, seconds)}, summed launches)."""
    from geoldm_tpu_torch.cli import serve
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.diffusion.vdm import mixed_tail_steps
    from geoldm_tpu_torch.train.sampling import chunk_pads

    server, service = serve.main(["--model_path", path, "--port", "0", "--batch_max", "64",
                                  "--no_warmup"], serve_forever=False)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out, total = {}, _no_launches()
    try:
        for name, body, K in requests:
            _zero_launch_counts()
            t0 = time.time()
            code, resp = _request(base, "/sample", body)
            dt = time.time() - t0
            launches = _launch_counts()
            _check(code == 200, f"phase {phase} {name} -> {code} {resp}")
            _check_molecules(resp, body["sizes"], get_dataset_info("qm9")["atom_decoder"])
            tail = mixed_tail_steps("bfloat16_mixed", K)
            chunks = len(chunk_pads(body["sizes"], 64, service.buckets))
            want = {**_no_launches(), "egnn_block_bf16": ((K - tail) * L + dec) * chunks,
                    "egnn_block": (tail + 1) * L * chunks}
            _check(launches == want, f"phase {phase} {name}: launches {launches} != {want}")
            for k, v in launches.items():
                total[k] += v
            out[name] = (resp, dt)
            print(f"phase {phase}: cli.serve {name} ({json.dumps(resp['sampler'])}): "
                  f"{resp['n']} molecules in {dt:.2f} s, {sum(resp['stable'])} stable; launches "
                  f"bf16 ({K}-{tail})*{L}+{dec}, f32 ({tail}+1)*{L} per chunk x {chunks} on "
                  f"{card}", flush=True)
    finally:
        server.shutdown()
        server.server_close()
    return out, total


def phase_edm(card, tmpdir):
    """Phase 31: the plain E(n) diffusion model (kind 'diffusion', EDM) at
    the defaults of factory.make_diffusion_model_config, EDM's QM9 command
    (nf 256, 9 layers, T 1000, polynomial_2, precision 1e-5, l2, normalize
    [1, 4, 10]), random weights: (a) three train steps (AMSGrad, clip, EMA)
    at B=64, N=29, 9 #1 and 9 #2 launches a step, and the gradient card vs
    CPU; (b) the t0_always NLL card vs CPU; (c) one dense T=1000 chunk of 16
    molecules, one-hot types and integer charges, (T+1)*9 #1 launches; (d) a
    seeded cli.serve request on the saved checkpoint and its replay, bit for
    bit."""
    import torch

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import synthetic_batch
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train import sampling
    from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step
    from geoldm_tpu_torch.train.trainer import prepare_batch
    from geoldm_tpu_torch.utils.convert import save_reference_checkpoint

    info = get_dataset_info("qm9")
    cfg = factory.make_diffusion_model_config(info)
    e, d = cfg.dynamics.egnn, cfg.diffusion
    _check((e.hidden_nf, e.n_layers, d.timesteps, d.noise_schedule, d.noise_precision,
            d.loss_type, d.norm_values) == (256, 9, 1000, "polynomial_2", 1e-5, "l2",
                                            (1.0, 4.0, 10.0)), f"EDM defaults {cfg}")
    L, T, B, decay = e.n_layers, d.timesteps, 64, 0.9999
    model = factory.build_model(cfg, "cuda", torch.Generator().manual_seed(31))
    state = create_train_state(model, cfg, 1e-4, ema_decay=decay)
    step = make_train_step(cfg, decay)
    nodes = DistributionNodes(info.n_nodes)
    batch = prepare_batch(synthetic_batch(info, B, 29, np.random.default_rng(31)), nodes, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(31)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    losses, times = [], []
    _zero_launch_counts()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(state, batch, gen)["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    train_launches = _launch_counts()
    want = {**_no_launches(), "egnn_block": 3 * L, "egnn_block_bwd": 3 * L}
    _check(train_launches == want, f"phase 31 (a): launches {train_launches} != {want}")
    _check(bool(np.all(np.isfinite(losses))), f"phase 31 (a): losses {losses}")
    moved = max(float((v - start[k]).abs().max()) for k, v in model.state_dict().items())
    ema_moved = max(float((v - start[k]).abs().max())
                    for k, v in state.ema_model.state_dict().items())
    _check(moved > 0 and 0 < ema_moved < moved, f"phase 31 (a): weights moved {moved}, EMA "
                                                f"{ema_moved}")
    print(f"phase 31 (a): EDM nf=256 9 layers T=1000 (make_diffusion_model_config defaults), "
          f"3 train steps B={B} N=29: losses {[round(v, 4) for v in losses]}, "
          f"{', '.join(f'{v:.1f}' for v in times)} ms (host clock around synchronised steps); "
          f"launches #1 {3 * L} #2 {3 * L}; weights moved {moved:.2e}, EMA {ema_moved:.2e} "
          f"on {card}", flush=True)
    grad = _variant_grad(card, "31 (a, b)", cfg, L, L, 2 * L)

    sizes = nodes.sample(16, np.random.default_rng(31))
    _zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    one_hot, charges, x, mask = sampling.sample(state.ema_model, torch.Generator(
        device="cuda").manual_seed(32), info, sizes, pad_nodes=32)
    one_hot, charges, x = (a.cpu().numpy() for a in (one_hot, charges, x))
    chunk_s = time.time() - t0
    chunk_launches = _launch_counts()
    want = {**_no_launches(), "egnn_block": (T + 1) * L}
    _check(chunk_launches == want, f"phase 31 (c): launches {chunk_launches} != {want}")
    _check(np.all(one_hot.sum(-1) == mask[..., 0]) and set(np.unique(one_hot)) <= {0.0, 1.0},
           "phase 31 (c): the types are not one-hot on the real atoms")
    _check(np.all(charges == np.round(charges)) and np.all(np.isfinite(x)),
           "phase 31 (c): charges not integers or coordinates not finite")
    print(f"phase 31 (c): one dense T={T} chunk of 16 molecules (pad 32): {chunk_s:.2f} s, "
          f"one-hot types, integer charges; launches #1 {(T + 1) * L} = ({T}+1)*{L} on {card}",
          flush=True)

    path = os.path.join(tmpdir, "edm")
    save_reference_checkpoint(state.ema_model, path)
    body = {"sizes": [19, 23, 27, 29, 14, 17], "seed": 31, "n_steps": 50, "eta": 0.0}
    served, serve_launches = _serve_requests(card, 31, path, [("seeded", body, 50),
                                                                ("replay", body, 50)], L, 0)
    _check(served["seeded"][0]["molecules"] == served["replay"][0]["molecules"],
           "phase 31 (d): the seeded request did not replay")
    print(f"phase 31 (d): the seeded request replayed bit for bit on {card}", flush=True)
    launches = {k: train_launches[k] + chunk_launches[k] + serve_launches[k]
                for k in train_launches}
    return {"losses": losses, "step_ms": times, "grad": grad, "chunk_seconds": chunk_s,
            "serve_seconds": [v[1] for v in served.values()], "launches": launches}


def _timed_recipe_steps(card, phase, state):
    """Host-clock ms of 3 more synchronised train steps of a CLI run's state
    on one QM9 batch (B=64, N=29), as phase 7 times the recipe."""
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import synthetic_batch
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train.trainer import prepare_batch

    info = get_dataset_info("qm9")
    batch = prepare_batch(synthetic_batch(info, 64, 29, np.random.default_rng(phase)),
                          DistributionNodes(info.n_nodes), "cuda")
    times = _time_steps(state, 0.9999, batch)
    print(f"phase {phase}: train step B=64 N=29: {', '.join(f'{v:.1f}' for v in times)} ms "
          f"(host clock around synchronised steps) on {card}", flush=True)
    return times


def _train_cli(card, phase, tmpdir, extra, steps, per_step, per_eval, per_chunk, K, L):
    """cli.main_qm9 at the QM9 recipe (nf 256, 9 layers, latent_nf 1, T 1000,
    B 64, trainable_ae) with ``extra`` flags on fabricated splits: ``steps``
    steps, valid and test NLL and 8 stability samples as K-step DDIM jumps,
    launches exact: per step ``per_step`` #1 and 9 #2 per grad-carrying
    decoder/denoiser (``L`` a block list), ``per_eval`` #1 per eval batch,
    ``per_chunk`` per sampled chunk. -> (summary, launches, seconds)."""
    import torch

    from geoldm_tpu_torch.cli import main_qm9
    from geoldm_tpu_torch.train.sampling import DEFAULT_SAMPLE_BUCKETS, n_chunks
    from geoldm_tpu_torch.utils.buckets import covering_buckets

    argv = ["--datadir", tmpdir, "--outdir", os.path.join(tmpdir, "out"), "--train_diffusion",
            "--trainable_ae", "--nf", "256", "--n_layers", "9", "--latent_nf", "1",
            "--diffusion_steps", "1000", "--batch_size", "64", "--test_epochs", "1",
            "--n_stability_samples", "8", "--eval_n_steps", str(K), "--no_wandb", *extra]
    print(f"phase {phase}: python -m geoldm_tpu_torch.cli.main_qm9 {' '.join(argv)}",
          flush=True)
    _zero_launch_counts()
    t0 = time.time()
    summary = main_qm9.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launch_counts()
    _check_fused(f"phase {phase}: cli.main_qm9 {' '.join(extra)}",
                 sum(map(len, summary["losses"])))
    losses = summary["losses"][-1]
    _check(len(losses) == steps and bool(np.all(np.isfinite(losses))),
           f"phase {phase}: losses {losses}")
    _check(np.isfinite(summary["nll_val"][-1]) and np.isfinite(summary["nll_test"][-1]),
           f"phase {phase}: NLL {summary['nll_val']} {summary['nll_test']}")
    chunks = n_chunks(summary["sample_sizes"][-1], 8, covering_buckets(DEFAULT_SAMPLE_BUCKETS,
                                                                       29))
    want = {**_no_launches(), "egnn_block": steps * per_step[0] + 2 * per_eval
            + per_chunk * chunks, "egnn_block_bwd": steps * per_step[1]}
    _check(launches == want, f"phase {phase}: launches {launches} != {want} ({steps} steps, 2 "
                             f"eval batches, {chunks} chunks)")
    print(f"phase {phase}: {steps} steps, losses {[round(v, 4) for v in losses]}, valid NLL "
          f"{summary['nll_val'][-1]:.4f}, test NLL {summary['nll_test'][-1]:.4f}, stability "
          f"{summary['stability'][-1]}; launches #1 {want['egnn_block']} = {steps}*"
          f"{per_step[0]} + 2*{per_eval} + {per_chunk}*{chunks} chunks, #2 "
          f"{want['egnn_block_bwd']} = {steps}*{per_step[1]}; main() {wall:.1f} s on {card}",
          flush=True)
    return summary, launches, wall


def phase_learned(card, tmpdir):
    """Phase 32: the learned noise schedule at the reference width:
    cli.main_qm9 --train_diffusion --trainable_ae --diffusion_noise_schedule
    learned --diffusion_loss_type vlb (nf 256, 9 layers, latent_nf 1, T 1000,
    B 64) for 3 steps and one test epoch, launches exact; the saved model's
    gamma(0) and gamma(1) are gamma_0 and gamma_1 and gamma increases on a
    grid of t; --resume runs one more epoch; cli.serve answers a K=50 DDIM
    request and a dense one; the train-step gradient card vs CPU, gamma
    parameters included."""
    import torch

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import write_qm9_splits
    from geoldm_tpu_torch.diffusion.schedules import GammaNetwork
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.utils.convert import load_reference_checkpoint

    info = get_dataset_info("qm9")
    B, steps, K, L = 64, 3, 50, 9
    write_qm9_splits(tmpdir, info, {"train": B * steps, "valid": B, "test": B}, seed=32)
    learned = ["--diffusion_noise_schedule", "learned", "--diffusion_loss_type", "vlb",
               "--exp_name", "learned"]
    per_step, per_eval, per_chunk = (1 + 2 * L, 2 * L), 1 + 3 * L, (K + 1) * L + L
    first, launches, _ = _train_cli(card, 32, tmpdir, learned + ["--n_epochs", "1"], steps,
                                    per_step, per_eval, per_chunk, K, L)
    step_ms = _timed_recipe_steps(card, 32, first["state"])
    run = os.path.join(tmpdir, "out", "learned")
    model, cfg, _ = load_reference_checkpoint(os.path.join(run, "latest"), "cuda",
                                              use_ema=False)
    _check(isinstance(model.gamma, GammaNetwork) and cfg.diffusion.loss_type == "vlb",
           "phase 32: the checkpoint is not a learned-schedule model")
    with torch.no_grad():
        g = model.gamma(torch.linspace(0, 1, 101, device="cuda")[:, None])[:, 0].cpu()
        g0, g1 = float(model.gamma.gamma_0), float(model.gamma.gamma_1)
    _check(abs(float(g[0]) - g0) <= 1e-5 and abs(float(g[-1]) - g1) <= 1e-4 * abs(g1),
           f"phase 32: gamma(0) {float(g[0])} gamma(1) {float(g[-1])} vs {g0}, {g1}")
    _check(bool(torch.all(g[1:] > g[:-1])), "phase 32: gamma is not increasing")
    init = factory.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    moved = max(float((p.detach().cpu() - q.detach()).abs().max())
                for p, q in zip(model.gamma.parameters(), init.gamma.parameters()))
    _check(moved > 0, "phase 32: the gamma network did not train")
    print(f"phase 32: the saved model's gamma(0) {float(g[0]):.6f} = gamma_0 {g0:.6f}, "
          f"gamma(1) {float(g[-1]):.6f} = gamma_1 {g1:.6f}, increasing on 101 points of t; its "
          f"parameters moved up to {moved:.2e}", flush=True)
    del model
    resumed, resume_launches, _ = _train_cli(
        card, 32, tmpdir, learned + ["--n_epochs", "2", "--start_epoch", "1", "--resume", run],
        steps, per_step, per_eval, per_chunk, K, L)
    _check(resumed["resumed"]["step"] == steps, f"phase 32: resumed at step "
                                                f"{resumed['resumed']['step']}")
    served, serve_launches = _serve_requests(
        card, 32, os.path.join(run, "best"),
        [("ddim50", {"sizes": [19, 23, 27, 29, 14, 17], "seed": 32, "n_steps": 50,
                     "eta": 0.0}, 50),
         ("dense", {"sizes": [19, 23, 21, 24], "seed": 33}, 1000)], L, L)
    grad = _variant_grad(card, 32, factory.make_latent_diffusion_config(
        info, nf=256, n_layers=9, latent_nf=1, diffusion_steps=1000, trainable_ae=True,
        noise_schedule="learned", loss_type="vlb"), 1 + 2 * L, 2 * L, 1 + 3 * L)
    total = {k: launches[k] + resume_launches[k] + serve_launches[k] for k in launches}
    return {"losses": first["losses"][0] + resumed["losses"][0], "grad": grad, "step_ms": step_ms,
            "serve_seconds": {k: v[1] for k, v in served.items()}, "launches": total}


def phase_gnn(card, tmpdir):
    """Phase 33: --model gnn_dynamics at the reference width through
    cli.main_qm9 (3 steps, a test epoch): the GNN denoiser launches no
    kernel, so #1/#2 come from the VAE alone (encoder + decoder a step and an
    eval batch, the decoder a sampled chunk), exactly; the train-step
    gradient card vs CPU; one dense T=1000 chunk of 16 molecules, whose 9 #1
    launches are the decoder's."""
    import torch

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import write_qm9_splits
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train import sampling

    info = get_dataset_info("qm9")
    B, steps, K, L = 64, 3, 50, 9
    write_qm9_splits(tmpdir, info, {"train": B * steps, "valid": B, "test": B}, seed=33)
    summary, launches, _ = _train_cli(card, 33, tmpdir, ["--model", "gnn_dynamics",
                                                         "--exp_name", "gnn", "--n_epochs", "1"],
                                      steps, (1 + L, L), 1 + L, L, K, L)
    step_ms = _timed_recipe_steps(card, 33, summary["state"])
    model = summary["state"].ema_model
    sizes = DistributionNodes(info.n_nodes).sample(16, np.random.default_rng(33))
    _zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    one_hot, charges, x, mask = sampling.sample(model, torch.Generator(
        device="cuda").manual_seed(33), info, sizes, pad_nodes=32)
    x = x.cpu().numpy()
    chunk_s = time.time() - t0
    chunk_launches = _launch_counts()
    want = {**_no_launches(), "egnn_block": L}
    _check(chunk_launches == want, f"phase 33: chunk launches {chunk_launches} != {want}")
    _check(bool(np.all(np.isfinite(x))), "phase 33: non-finite coordinates")
    print(f"phase 33: one dense T=1000 chunk of 16 molecules (pad 32) with the GNN denoiser: "
          f"{chunk_s:.2f} s; #1 launches {L}, the decoder's alone, on {card}", flush=True)
    grad = _variant_grad(card, 33, factory.make_latent_diffusion_config(
        info, nf=256, n_layers=9, latent_nf=1, diffusion_steps=1000, trainable_ae=True,
        model="gnn_dynamics"), 1 + L, L, 1 + L)
    total = {k: launches[k] + chunk_launches[k] for k in launches}
    return {"losses": summary["losses"][0], "grad": grad, "chunk_seconds": chunk_s,
            "step_ms": step_ms, "launches": total}


def _mixed_launches(pads, K, L, dec, inv=1):
    """Launches of a bfloat16_mixed sampler run of K steps over chunks at
    ``pads``: per chunk (K - tail) * L + dec blocks in bf16 (the head's steps
    and the decoder) and (tail + 1) * L in f32 (the tail and the final
    step), on #1 at pads up to 64 and on #3/#4 past them."""
    from geoldm_tpu_torch.diffusion.vdm import mixed_tail_steps

    tail = mixed_tail_steps("bfloat16_mixed", K)
    small = sum(1 for p in pads if p <= 64)
    large = len(pads) - small
    head, f32 = (K - tail) * L + dec, (tail + 1) * L
    return {**_no_launches(), "egnn_block_bf16": head * small, "egnn_block": f32 * small,
            "gcl_rows_bf16": head * inv * large, "coord_rows_bf16": head * large,
            "gcl_rows": f32 * inv * large, "coord_rows": f32 * large}


def _add_launches(total, launches):
    for k, v in launches.items():
        total[k] += v


class _HeldDispatch:
    """Wraps a server's ``_generate``: records each dispatch's sizes and holds
    the first one until ``release`` (JAX's coalescing test's gate)."""

    def __init__(self, service):
        self.service, self.real = service, service._generate
        self.calls, self.gate = [], threading.Event()

    def __enter__(self):
        def held(sizes, *a, **kw):
            first = not self.calls
            self.calls.append(np.asarray(sizes).copy())
            if first:
                _check(self.gate.wait(timeout=300), "the held dispatch was never released")
            return self.real(sizes, *a, **kw)

        self.service._generate = held
        return self

    def __exit__(self, *exc):
        self.gate.set()
        self.service._generate = self.real


def _wait_until(pred, what, timeout=300.0):
    t_end = time.time() + timeout
    while not pred():
        _check(time.time() < t_end, f"timed out waiting for {what}")
        time.sleep(0.005)


def phase_serve_warmup(card, tmpdir):
    """Phase 34: cli.serve at the QM9 recipe (nf=256, 9 layers, T=1000,
    random weights) with its default bfloat16_mixed and its warm-up: the
    warm-up's seconds and launches (one 6-step dispatch of 64 molecules in
    each of the buckets 16, 24, 32, each on #1 in bf16 and in f32, exact); a
    first and a second request of 4 molecules at K=50 DDIM; 8 unseeded
    requests of 4 at K=50 served one after another and then concurrently
    (coalesced), with mol/s; 8 concurrent ones with the first dispatch held
    until the other 7 queue: 2 dispatches, the 7 merged responses carry
    "coalesced": 7 and no seed, every response its own molecules, launches
    exact per dispatch. Then a GEOM recipe server (--batch_max 4) whose
    warm-up launches #1 at pads 32-64 and #3/#4 at 96, 136, 184, exact."""
    import torch

    from geoldm_tpu_torch.cli import serve
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.ops import egnn_block
    from geoldm_tpu_torch.train.sampling import chunk_pads
    from geoldm_tpu_torch.utils.convert import save_reference_checkpoint

    out, total = {}, _no_launches()
    T, batch_max, K, n_req = 1000, 64, 50, 8
    info = get_dataset_info("qm9")
    cfg = factory.make_latent_diffusion_config(info, nf=256, n_layers=9, latent_nf=1,
                                               diffusion_steps=T)
    L, dec = cfg.dynamics.egnn.n_layers, cfg.vae.decoder_egnn.n_layers
    path = os.path.join(tmpdir, "qm9")
    save_reference_checkpoint(factory.build_model(cfg, "cuda", torch.Generator().manual_seed(0)),
                              path)
    seen = []
    real_launch = egnn_block._forward_launch

    def spy(block, h, x, x0, node_mask, save, bf16=False, lowp=False):
        seen.append((int(x.shape[1]), bool(bf16)))
        return real_launch(block, h, x, x0, node_mask, save, bf16=bf16, lowp=lowp)

    _zero_launch_counts()
    egnn_block._forward_launch = spy
    t0 = time.time()
    try:
        server, service = serve.main(["--model_path", path, "--port", "0", "--batch_max",
                                      str(batch_max)], serve_forever=False)
    finally:
        egnn_block._forward_launch = real_launch
    start_s = time.time() - t0
    warm = _launch_counts()
    _add_launches(total, warm)
    n_warm = service.warmup_steps()
    want = _mixed_launches(list(service.buckets), n_warm, L, dec)
    _check(n_warm == 6 and warm == want, f"phase 34: warm-up launches {warm} != {want} "
                                         f"({n_warm} steps)")
    covered = {(n, b) for n, b in seen}
    _check(covered == {(b, bf) for b in (16, 24, 32) for bf in (False, True)},
           f"phase 34: the warm-up's #1 launches covered (pad, bf16) {sorted(covered)}")
    metrics = service.metrics()
    _check(metrics == {"requests": 0, "molecules": 0, "errors": 0, "dispatches": 0}
           and service._auto_seed == 0, f"phase 34: the warm-up moved a counter: {metrics}")
    out["qm9_warmup"] = {"seconds": service.warmup_seconds, "start_seconds": start_s,
                         "launches": {k: v for k, v in warm.items() if v}}
    print(f"phase 34: cli.serve QM9 recipe warm-up {service.warmup_seconds:.2f} s (start "
          f"{start_s:.2f} s): one {n_warm}-step dispatch of {batch_max} molecules in each of "
          f"buckets {list(service.buckets)}; launches {json.dumps(out['qm9_warmup']['launches'])}, "
          f"#1 at (pad, bf16) {sorted(covered)} on {card}", flush=True)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    decoder = info["atom_decoder"]

    def post(body, replies, key):
        replies[key] = _request(base, "/sample", body)

    def check_reply(name, code, resp, n):
        _check(code == 200, f"phase 34 {name} -> {code} {resp}")
        _check(resp["n"] == n and len(resp["stable"]) == n, f"phase 34 {name}: {resp['n']}")
        for mol in resp["molecules"]:
            _check(0 < len(mol) <= 29, f"phase 34 {name}: a molecule of {len(mol)} atoms")
            for el, *xyz in mol:
                _check(el in decoder and bool(np.all(np.isfinite(xyz))),
                       f"phase 34 {name}: atom {el} {xyz}")

    try:
        body = {"n_samples": 4, "n_steps": K, "eta": 0.0}
        for name in ("first", "second"):
            _zero_launch_counts()
            t0 = time.time()
            code, resp = _request(base, "/sample", {**body, "seed": 34})
            dt = time.time() - t0
            check_reply(name, code, resp, 4)
            sizes = [len(m) for m in resp["molecules"]]
            got = _launch_counts()
            want = _mixed_launches(chunk_pads(sizes, batch_max, service.buckets), K, L, dec)
            _check(got == want, f"phase 34 {name}: launches {got} != {want}")
            _add_launches(total, got)
            out[f"{name}_request"] = {"seconds": dt, "sizes": sizes}
            print(f"phase 34: {name} request, 4 molecules (sizes {sizes}) at K={K} DDIM: "
                  f"{dt * 1e3:.1f} ms, launches exact on {card}", flush=True)

        # 8 unseeded requests of 4, one after another, then all at once; the
        # dispatches' sizes are recorded (nothing held) for their launches.
        for mode in ("serial", "concurrent"):
            replies, before = {}, service.metrics()
            _zero_launch_counts()
            with _HeldDispatch(service) as seen_calls:
                seen_calls.gate.set()
                t0 = time.time()
                if mode == "serial":
                    for i in range(n_req):
                        post(body, replies, i)
                else:
                    threads = [threading.Thread(target=post, args=(body, replies, i))
                               for i in range(n_req)]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(timeout=600)
                dt = time.time() - t0
            got = _launch_counts()
            want = _no_launches()
            for sizes in seen_calls.calls:
                _add_launches(want, _mixed_launches(chunk_pads(sizes, batch_max, service.buckets),
                                                    K, L, dec))
            _check(got == want, f"phase 34 {mode}: launches {got} != {want}")
            _add_launches(total, got)
            for i in range(n_req):
                check_reply(f"{mode} {i}", *replies[i], 4)
            after = service.metrics()
            dispatches = after["dispatches"] - before["dispatches"]
            merged = [r for _, r in replies.values() if "coalesced" in r]
            out[mode] = {"seconds": dt, "mol_per_s": 4 * n_req / dt, "dispatches": dispatches,
                         "merged": len(merged)}
            print(f"phase 34: {n_req} unseeded requests of 4 at K={K}, {mode}: "
                  f"{4 * n_req / dt:.2f} mol/s ({dt:.2f} s), {dispatches} dispatches, "
                  f"{len(merged)} responses coalesced, launches exact on {card}", flush=True)
        _check(out["serial"]["dispatches"] == n_req and out["serial"]["merged"] == 0,
               f"phase 34: serial requests {out['serial']}")
        _check(out["concurrent"]["dispatches"] < n_req,
               f"phase 34: concurrent requests were not coalesced: {out['concurrent']}")

        # JAX's test's scenario: hold the first dispatch until the rest queue.
        replies, before = {}, service.metrics()
        _zero_launch_counts()
        with _HeldDispatch(service) as held:
            threads = [threading.Thread(target=post, args=(body, replies, i))
                       for i in range(n_req)]
            threads[0].start()
            _wait_until(lambda: len(held.calls) == 1, "the first dispatch")
            for t in threads[1:]:
                t.start()
            _wait_until(lambda: len(service._coalescer._pending) == n_req - 1,
                        "the other requests to queue")
            held.gate.set()
            for t in threads:
                t.join(timeout=600)
        got = _launch_counts()
        _add_launches(total, got)
        want = _no_launches()
        for sizes in held.calls:
            _add_launches(want, _mixed_launches(chunk_pads(sizes, batch_max, service.buckets),
                                                K, L, dec))
        _check(got == want, f"phase 34 held: launches {got} != {want}")
        _check([len(c) for c in held.calls] == [4, 4 * (n_req - 1)],
               f"phase 34 held: dispatch sizes {[len(c) for c in held.calls]}")
        solo = replies[0][1]
        _check(isinstance(solo["seed"], int) and "coalesced" not in solo,
               f"phase 34 held: the first response {solo.get('seed')}")
        for i in range(1, n_req):
            code, resp = replies[i]
            check_reply(f"held {i}", code, resp, 4)
            _check(resp["seed"] is None and resp["coalesced"] == n_req - 1,
                   f"phase 34 held {i}: seed {resp['seed']}, coalesced {resp.get('coalesced')}")
        # The merged responses hold the merged dispatch's molecules between
        # them, each its own 4 (the queue's order is the threads').
        rows = [m for i in range(1, n_req) for m in replies[i][1]["molecules"]]
        _check(sorted(len(m) for m in rows) == sorted(held.calls[1].tolist()),
               "phase 34 held: the merged responses' sizes are not the dispatch's")
        after = service.metrics()
        _check(after["dispatches"] - before["dispatches"] == 2
               and after["requests"] - before["requests"] == n_req,
               f"phase 34 held: /metrics {before} -> {after}")
        out["held"] = {"dispatch_sizes": [len(c) for c in held.calls], "launches": got}
        print(f"phase 34: {n_req} requests with the first dispatch held: dispatches of "
              f"{[len(c) for c in held.calls]} molecules, {n_req - 1} responses coalesced "
              f"(seed null), launches exact on {card}", flush=True)
    finally:
        server.shutdown()
        server.server_close()

    geom = get_dataset_info("geom")
    gcfg = _geom_recipe_cfg()
    gpath = os.path.join(tmpdir, "geom")
    save_reference_checkpoint(factory.build_model(gcfg, "cuda", torch.Generator().manual_seed(0)),
                              gpath, dataset="geom")
    _zero_launch_counts()
    server, service = serve.main(["--model_path", gpath, "--dataset", "geom", "--port", "0",
                                  "--batch_max", "4"], serve_forever=False)
    server.server_close()
    got = _launch_counts()
    _add_launches(total, got)
    sizes = [min(b, geom["max_n_nodes"]) for b in service.buckets]
    want = _mixed_launches(chunk_pads(np.repeat(sizes, 4), 4, service.buckets),
                           service.warmup_steps(), gcfg.dynamics.egnn.n_layers,
                           gcfg.vae.decoder_egnn.n_layers, gcfg.dynamics.egnn.inv_sublayers)
    _check(got == want and got["gcl_rows_bf16"] > 0 and got["coord_rows"] > 0,
           f"phase 34 GEOM warm-up: launches {got} != {want}")
    out["geom_warmup"] = {"seconds": service.warmup_seconds,
                          "launches": {k: v for k, v in got.items() if v}}
    print(f"phase 34: cli.serve GEOM recipe (--batch_max 4) warm-up "
          f"{service.warmup_seconds:.2f} s over buckets {list(service.buckets)}: launches "
          f"{json.dumps(out['geom_warmup']['launches'])} on {card}", flush=True)
    out["launches"] = total
    return out


def phase_bench_train(card):
    """Phase 35: cli.bench_train at its defaults (the QM9 recipe, B=64, pad
    32, 20 timed steps after one) in float32 and in bfloat16: its JSON line,
    the launches of #1 and #2 (19 and 18 a step; in bfloat16 their bf16
    variants) exact, and MFU from utils.flops against the card's name."""
    import contextlib
    import io

    from geoldm_tpu_torch.cli import bench_train
    from geoldm_tpu_torch.utils import flops

    out, total = {}, _no_launches()
    for dtype in ("float32", "bfloat16"):
        _zero_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = bench_train.main(["--compute_dtype", dtype])
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        got = _launch_counts()
        _add_launches(total, got)
        cfg = res["model_cfg"]
        L, dec = cfg.dynamics.egnn.n_layers, cfg.vae.decoder_egnn.n_layers
        enc = cfg.vae.encoder_egnn.n_layers
        steps = res["reps"] + 1
        _check_fused(f"phase 35: cli.bench_train --compute_dtype {dtype}", steps)
        suffix = "_bf16" if dtype == "bfloat16" else ""
        want = {**_no_launches(), f"egnn_block{suffix}": (enc + dec + L) * steps,
                f"egnn_block_bwd{suffix}": (dec + L) * steps}
        _check(got == want, f"phase 35 {dtype}: launches {got} != {want}")
        _check(sorted(line) == ["metric", "molecules_per_sec", "unit", "value"]
               and line["value"] > 0, f"phase 35 {dtype}: {line}")
        step_flops = 64 * flops.train_step_flops(cfg, 32)
        mfu = flops.mfu(step_flops * res["reps"], res["seconds"], res["device"])
        _check(mfu is not None and 0 < mfu < 1, f"phase 35: MFU {mfu} on {res['device']}")
        out[dtype] = {"line": line, "mfu": mfu, "ms_per_step": res["seconds"] / res["reps"] * 1e3,
                      "model_tflop_per_step": step_flops / 1e12}
        print(f"phase 35: cli.bench_train --compute_dtype {dtype}: {json.dumps(line)}; "
              f"{out[dtype]['ms_per_step']:.2f} ms a step, {step_flops / 1e12:.3f} model "
              f"TFLOP a step (utils.flops), MFU {mfu:.4f} of the bf16 peak; launches exact "
              f"({enc}+{dec}+{L} forward, {dec}+{L} backward a step, {steps} steps) on {card}",
              flush=True)
    out["launches"] = total
    return out


def phase_render(card, tmpdir):
    """Phase 36: rendering. Whether matplotlib and imageio import is decided
    first and printed. With them: cli.main_qm9 --visualize True at the QM9
    recipe for one short epoch on fabricated splits (one step), then
    cli.eval_sample --render True and cli.eval_conditional_qm9 --task
    qualitative. Without them each of the three exits at argument checking
    naming the missing packages (checked), and the smoke writes the same xyz
    files on the card through the functions the flags call:
    common.visualize_epoch(render=False) on the trained run's EMA model,
    cli.eval_sample without --render, eval_conditional_qm9.write_sweep. The
    generative part runs on the card either way, with exact launches: the
    chain (dense T=1000, 100 frames decoded) and 9 molecules; eval_sample on
    an unconditional checkpoint and the property sweep on a conditional one,
    both at the conditional recipe's nf=192 (#1 at H=192)."""
    import contextlib
    import io

    import torch

    from geoldm_tpu_torch.cli import common, eval_conditional_qm9, eval_sample, main_qm9
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import write_qm9_splits
    from geoldm_tpu_torch.evalsuite import visualizer as viz
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train import classifier_train
    from geoldm_tpu_torch.train.conditioning import load_conditional_protocol
    from geoldm_tpu_torch.utils.convert import load_reference_checkpoint, save_reference_checkpoint

    missing = viz.missing_renderer_packages()
    render = not missing
    why = ("matplotlib and imageio import" if render else
           f"this Python lacks {' and '.join(missing)}; the flags must refuse, and the xyz "
           "files are written on the card all the same")
    print(f"phase 36: rendering {'on' if render else 'off'}: {why}", flush=True)
    out, total = {"render": render, "missing": missing}, _no_launches()
    info = get_dataset_info("qm9")
    T, L, B = 1000, 9, 64
    # Two train steps; the second half of the train split (the conditional
    # protocol's, for the sweep) then holds molecules of the sweep's 19 atoms.
    write_qm9_splits(tmpdir, info, {"train": 2 * B, "valid": 8, "test": 8}, seed=36)

    def refused(fn, argv, flag):
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                fn(argv)
            except SystemExit as e:
                msg = str(e.code)
                _check(msg.startswith(f"{flag} renders with matplotlib and imageio; this Python "
                                      f"lacks {' and '.join(missing)}"),
                       f"phase 36: {flag} exited with {msg!r}")
                print(f"phase 36: {flag} refused at argument checking: {msg}", flush=True)
                return
        raise SmokeFailure(f"phase 36: {flag} ran without {missing}")

    outdir = os.path.join(tmpdir, "out")
    argv = ["--datadir", tmpdir, "--outdir", outdir, "--exp_name", "vis", "--train_diffusion",
            "--trainable_ae", "--nf", "256", "--n_layers", str(L), "--latent_nf", "1",
            "--diffusion_steps", str(T), "--batch_size", str(B), "--n_epochs", "1",
            "--test_epochs", "1", "--n_stability_samples", "4", "--eval_n_steps", "50",
            "--save_model", "False", "--no_wandb"]
    if not render:
        refused(main_qm9.main, argv + ["--visualize", "True"], "--visualize")
    _zero_launch_counts()
    t0 = time.time()
    summary = main_qm9.main(argv + (["--visualize", "True"] if render else []))
    _add_launches(total, _launch_counts())
    epoch_dir = os.path.join(outdir, "vis", "epoch_0")
    nodes = DistributionNodes(info.n_nodes)
    _zero_launch_counts()
    if render:
        (vis,) = summary["visualized"]
    else:
        vis = common.visualize_epoch(summary["state"].ema_model, epoch_dir, 500, info, nodes,
                                     np.random.default_rng([0, 0]), render=False)
        torch.cuda.synchronize()
        got = _launch_counts()
        _add_launches(total, got)
        # The chain: the dense sampler at 19 atoms, (T+1) denoiser calls, then
        # each of the kept frames decoded; the 9 molecules: (T+1) denoiser
        # calls and a decode, one chunk at pad 29. All f32.
        frames = vis["chain_frames"] - 10
        want = {**_no_launches(), "egnn_block": 2 * (T + 1) * L + frames * L + L}
        _check(got == want, f"phase 36 visualize_epoch: launches {got} != {want}")
    seconds = time.time() - t0
    chain = sorted(f for f in os.listdir(os.path.join(epoch_dir, "chain")) if f.endswith(".txt"))
    _check(len(chain) == vis["chain_frames"] == 110 and len(vis["molecules"]) == 9,
           f"phase 36: {len(chain)} chain files, {len(vis['molecules'])} molecules")
    for f in [os.path.join(epoch_dir, "chain", chain[-1])] + vis["molecules"]:
        pos, one_hot = viz.load_molecule_xyz(f, info)
        _check(bool(np.isfinite(pos).all()) and bool((one_hot.sum(1) == 1).all()),
               f"phase 36: {f} holds a non-finite or untyped atom")
    _check((vis["gif"] is not None and len(vis["pngs"]) == 9) == render,
           f"phase 36: gif {vis['gif']}, {len(vis['pngs'])} pictures with render={render}")
    out["visualize"] = {"seconds": seconds, "chain_frames": vis["chain_frames"],
                        "molecules": len(vis["molecules"]), "gif": vis["gif"]}
    how = ("cli.main_qm9 --visualize True" if render
           else "cli.main_qm9 + common.visualize_epoch(render=False)")
    print(f"phase 36: {how} at the QM9 recipe: {vis['chain_frames']} chain frames and 9 molecules written "
          f"under {epoch_dir} ({'rendered' if render else 'not rendered'}) in {seconds:.1f} s"
          f"{'' if render else ', launches exact'} on {card}", flush=True)
    del summary

    # eval_sample on an unconditional checkpoint at nf=192 (it takes no
    # context, as JAX's), the sweep on a conditional one.
    K, keep = 50, 20
    plain_dir = os.path.join(tmpdir, "plain192")
    pcfg = factory.make_latent_diffusion_config(info, nf=192, n_layers=L, latent_nf=1,
                                                diffusion_steps=T)
    save_reference_checkpoint(factory.build_model(pcfg, "cuda", torch.Generator().manual_seed(2)),
                              os.path.join(plain_dir, "best"))
    es_argv = ["--model_path", plain_dir, "--outdir", os.path.join(tmpdir, "eval"),
               "--n_samples", "8", "--n_stable", "2", "--n_chains", "1", "--keep_frames",
               str(keep), "--n_tries", "1", "--n_steps", str(K)]
    if not render:
        refused(eval_sample.main, es_argv + ["--render", "True"], "--render")
    _zero_launch_counts()
    t0 = time.time()
    res = eval_sample.main(es_argv + ["--render", str(render)])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    got = _launch_counts()
    _add_launches(total, got)
    want = {**_no_launches(), "egnn_block": ((K + 1) * L + L) * res["sample_calls"]
            + (T + 1) * L + keep * L}
    _check(got == want, f"phase 36 eval_sample: launches {got} != {want}")
    _check(res["chains"] == [keep + 10] and (len(res["rendered"]["gifs"]) == 1) == render,
           f"phase 36 eval_sample: {res}")
    out["eval_sample"] = {"seconds": seconds, "sample_calls": res["sample_calls"],
                          "stable": res["stable"], "rendered": res["rendered"]}
    print(f"phase 36: cli.eval_sample {' '.join(es_argv)} --render {render}: 8 molecules "
          f"x {res['sample_calls']} calls at K={K}, a dense chain of {keep + 10} frames, "
          f"{res['stable']} stable, {res['rendered']['pngs']} pictures; #1 at H=192 "
          f"launches exact, {seconds:.1f} s on {card}", flush=True)

    cond_info = get_dataset_info("qm9_second_half")
    ccfg = factory.make_latent_diffusion_config(cond_info, nf=192, n_layers=L, latent_nf=1,
                                                diffusion_steps=T, context_node_nf=1,
                                                context_indicator=True,
                                                normalize_factors=(1.0, 8.0, 1.0))
    gen_dir = os.path.join(tmpdir, "cond192")
    save_reference_checkpoint(factory.build_model(ccfg, "cuda", torch.Generator().manual_seed(3)),
                              os.path.join(gen_dir, "best"), conditioning=["alpha"])
    cls_dir = os.path.join(tmpdir, "cls")
    from geoldm_tpu_torch.models import classifier as clf

    classifier_train.save_classifier(os.path.join(cls_dir, "best"), clf.build_classifier(
        "egnn", 5, 128, 7, True, False, "cpu").state_dict())
    q_argv = ["--task", "qualitative", "--property", "alpha", "--datadir", tmpdir,
              "--generators_path", gen_dir, "--classifiers_path", cls_dir]
    sweep_dir = os.path.join(gen_dir, "sweep_alpha")
    _zero_launch_counts()
    t0 = time.time()
    if render:
        gif = eval_conditional_qm9.main(q_argv)
    else:
        refused(eval_conditional_qm9.main, q_argv, "--task qualitative")
        model, _, _ = load_reference_checkpoint(os.path.join(gen_dir, "best"), "cuda")
        _, _, prop_dist, _, _ = load_conditional_protocol(tmpdir, ["alpha"])
        eval_conditional_qm9.write_sweep(model, 0, info, prop_dist, sweep_dir)
        gif = None
    torch.cuda.synchronize()
    seconds = time.time() - t0
    got = _launch_counts()
    _add_launches(total, got)
    want = {**_no_launches(), "egnn_block": (T + 1) * L + L}  # one chunk of 100 frames
    _check(got == want, f"phase 36 sweep: launches {got} != {want}")
    frames = sorted(f for f in os.listdir(sweep_dir) if f.endswith(".txt"))
    _check(len(frames) == 100 and (gif is not None) == render, f"phase 36 sweep: {len(frames)}")
    pos, one_hot = viz.load_molecule_xyz(os.path.join(sweep_dir, frames[-1]), info)
    _check(pos.shape == (19, 3) and bool(np.isfinite(pos).all()), "phase 36 sweep frame")
    out["sweep"] = {"seconds": seconds, "frames": len(frames), "gif": gif}
    print(f"phase 36: eval_conditional_qm9 --task qualitative "
          f"{'(rendered)' if render else '(write_sweep, not rendered)'}: 100 frames of 19 "
          f"atoms, alpha swept, (T+1)*{L}+{L} #1 launches at H=192, {seconds:.1f} s on {card}",
          flush=True)
    out["launches"] = total
    return out


def phase_geom_data(card, tmpdir):
    """Phase 37: GEOM data. A crude msgpack dump written with the port's own
    encoder (data.synthetic.packb: 20 molecules of 49-64 atoms from the GEOM
    size histogram, 4 conformers each), extracted by cli.build_geom_dataset
    with the native C++ extractor (asserted), K=2; the Python extractor's
    output equal where msgpack imports; data.geom loads the 40 conformers
    (train 32, valid 4, test 4) and one GEOM recipe train step (B=32, pad 64)
    runs on them on the card: 1 + 2*4 #1 and 2*4 #2 launches."""
    import contextlib
    import importlib.util
    import io
    import shutil

    import torch

    from geoldm_tpu_torch.cli import build_geom_dataset
    from geoldm_tpu_torch.data import native_geom
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.geom import GeomLoader, extract_conformers, load_split_data
    from geoldm_tpu_torch.data.synthetic import write_geom_msgpack
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step
    from geoldm_tpu_torch.train.trainer import prepare_batch

    info = get_dataset_info("geom")
    hist = [n for n, _ in info.n_nodes_histogram if 49 <= n <= 64]
    sizes = np.random.default_rng(37).choice(hist, size=20)
    t0 = time.time()
    write_geom_msgpack(tmpdir, info, 20, conformers=4, seed=37, sizes=sizes, chunk=8)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        path = build_geom_dataset.main(["--data_dir", tmpdir, "--conformations", "2"])
    text = buf.getvalue()
    _check("native extractor: 40 conformers" in text and native_geom.build_info.get("path"),
           f"phase 37: the native extractor did not run: {text!r}")
    rows = np.load(path)
    extract_s = time.time() - t0
    py_equal = None
    if importlib.util.find_spec("msgpack") is not None:
        os.makedirs(os.path.join(tmpdir, "py"))
        shutil.copy(os.path.join(tmpdir, "drugs_crude.msgpack"),
                    os.path.join(tmpdir, "py", "drugs_crude.msgpack"))
        py_equal = bool(np.array_equal(np.load(extract_conformers(
            os.path.join(tmpdir, "py"), conformations=2)), rows))
        _check(py_equal, "phase 37: the Python extractor's rows differ from the native one's")
    train, val, test = load_split_data(path)
    _check((len(train), len(val), len(test)) == (32, 4, 4),
           f"phase 37: splits {len(train)}/{len(val)}/{len(test)}")
    (raw,) = list(GeomLoader(train, info, 32, shuffle=True, include_charges=False))
    _check(raw["node_mask"].shape[1] == 64, f"phase 37: pad {raw['node_mask'].shape[1]}")
    cfg = _geom_recipe_cfg()
    model = factory.build_model(cfg, "cuda", torch.Generator().manual_seed(37))
    state = create_train_state(model, cfg, lr=5e-5, ema_decay=0.9999)
    step = make_train_step(cfg, 0.9999)
    batch = prepare_batch(raw, DistributionNodes(info.n_nodes), "cuda")
    _zero_launch_counts()
    t1 = time.time()
    loss = float(step(state, batch, torch.Generator(device="cuda").manual_seed(1))["loss"])
    step_s = time.time() - t1
    got = _launch_counts()
    L = cfg.dynamics.egnn.n_layers
    want = {**_no_launches(), "egnn_block": 1 + 2 * L, "egnn_block_bwd": 2 * L}
    _check(got == want and np.isfinite(loss), f"phase 37: loss {loss}, launches {got} != {want}")
    print(f"phase 37: cli.build_geom_dataset (native extractor, dump written by "
          f"data.synthetic.packb): {len(rows)} atom rows of 40 conformers in {extract_s:.2f} s; "
          f"Python extractor equal: {py_equal}; data.geom splits 32/4/4, one GEOM recipe train "
          f"step at B=32, pad 64: loss {loss:.4f}, {step_s * 1e3:.1f} ms (first step), launches "
          f"exact on {card}", flush=True)
    return {"rows": int(len(rows)), "python_equal": py_equal, "loss": loss,
            "extract_seconds": extract_s, "step_seconds": step_s, "launches": got}


# Phase 38: the low-precision edge chain (GEOLDM_PALLAS_EDGE_LOWP=1 under
# bfloat16_pallas). Its kernels are held to their plain versions at the bf16
# gates (_BF16_RTOL; weight gradients but for their one-step flips), and on
# the mean _BF16_SEPARATION (#1) or _LOWP_BWD_SEPARATION (#2) times closer to
# them than to the plain bf16 versions without the chain. The chain adds
# rounding sites but not distance: the bf16 backward's flips (one bf16 step
# of a weight gradient, 20-25 % of a tensor, and of the biases the chain
# rounds) count in the mean as before, while the plain versions with and
# without the chain lie about as far apart as bf16 from f32. Readings on an
# H100 at these shapes: #1 23-42x, #2 8.5-11x.
_LOWP_ENV = "GEOLDM_PALLAS_EDGE_LOWP"
_LOWP_BWD_SEPARATION = 5.0


@contextlib.contextmanager
def _lowp_env(on: bool):
    """The switch set (or cleared) within the block, as it was after it."""
    old = os.environ.get(_LOWP_ENV)
    if on:
        os.environ[_LOWP_ENV] = "1"
    else:
        os.environ.pop(_LOWP_ENV, None)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(_LOWP_ENV, None)
        else:
            os.environ[_LOWP_ENV] = old


def _in_turns(fns, inputs, **kw):
    """CUDA-event ms of each of two functions, timed in turns a, b, b, a
    (_time_ms each) -> (ms of a, ms of b), each the mean of its two turns."""
    a, b = fns
    ta = _time_ms(a, inputs, **kw)
    tb = _time_ms(b, inputs, **kw)
    tb2 = _time_ms(b, inputs, **kw)
    ta2 = _time_ms(a, inputs, **kw)
    return (ta + ta2) / 2, (tb + tb2) / 2


def phase_lowp_kernels(card):
    """Phase 38 (a), (b): the low-precision variants of #1 and #2 against
    their plain versions (the modules' forward with the chain in bf16, and
    autograd through it) at QM9's pads 16/24/29/32, B=64, H=256, and at H=192
    N=29: every output within _BF16_RTOL * max(1, max|ref|) (the backward's
    weight gradients but for their one-step flips), on the mean
    _BF16_SEPARATION times closer to the plain low-precision version than
    to the plain bf16 one; the forward saving its chain gives its outputs,
    and #2 from that saved chain, its recompute and a replay give the same
    bits. Then CUDA-event times of the low-precision and the bf16 #1/#2 in
    turns (20 launches after 3 warm-ups, inputs cycled), with the plain
    low-precision version's and the bf16 bound (the chain changes no FLOP or
    byte of the bound)."""
    import torch

    from geoldm_tpu_torch.nn.core import BF16_EDGE_LOWP as LOWP
    from geoldm_tpu_torch.ops import egnn_block

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, dev, B, rows = torch.bfloat16, torch.device("cuda"), 64, []

    def flat(r):
        return [*r[:3], *r[3]]

    for n, H in ((16, 256), (24, 256), (29, 256), (32, 256), (29, 192)):
        _check(egnn_block.whole_molecule(n, H), f"N={n} H={H} would not take the chain")
        block = _qm9_block(H, 3800 + n + H)
        n_weights = sum(p.numel() for p in block.parameters())
        rng = np.random.default_rng(38000 + n + H)
        inputs = [_ragged_inputs(38100 * n + H + rep, B, n, H, dev, 8)
                  + tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                          for s in ((B, n, H), (B, n, 3))) for rep in range(3)]
        fwd_in = [a[:4] for a in inputs]
        n_real = inputs[0][3][:, :, 0].sum(dim=1).cpu().numpy()
        # Forward.
        with torch.no_grad():
            got = egnn_block.block_forward_cuda(block, *fwd_in[0], compute_dtype=LOWP)
            h_s, x_s, saved = egnn_block._forward_launch(block, *fwd_in[0], save=True,
                                                         bf16=True, lowp=True)
            want = egnn_block.block_forward_plain(block, *fwd_in[0], compute_dtype=LOWP)
            want_bf16 = egnn_block.block_forward_plain(block, *fwd_in[0], compute_dtype=bf16)
        torch.cuda.synchronize()
        _check(all(bool(torch.isfinite(g).all()) for g in got), f"#1 lowp N={n} not finite")
        _check(torch.equal(h_s, got[0]) and torch.equal(x_s, got[1]),
               f"#1 lowp with its chain saved differs from without at N={n} H={H}")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max([1.0] + [float(w.abs().max()) for w in want])
        mean_err = sum(float((g - w).abs().double().mean()) for g, w in zip(got, want))
        mean_bf16 = sum(float((g - w).abs().double().mean()) for g, w in zip(got, want_bf16))
        _check(err <= _BF16_RTOL * scale, f"#1 lowp disagrees with plain at N={n} H={H}: "
                                          f"max|d|={err:.3e} > {_BF16_RTOL}*{scale:.3g}")
        _check(_BF16_SEPARATION * mean_err <= mean_bf16,
               f"#1 lowp N={n} H={H}: mean distance {mean_bf16:.3e} to the plain bf16 version is "
               f"not {_BF16_SEPARATION:g}x its mean error {mean_err:.3e}")
        # Backward: the recompute, the saved chain, a replay.
        got_b = egnn_block.block_backward_cuda(block, *inputs[0], compute_dtype=LOWP)
        via_saved = egnn_block._backward_launch(block, *inputs[0], saved, True, True)
        again = egnn_block.block_backward_cuda(block, *inputs[0], compute_dtype=LOWP)
        torch.cuda.synchronize()
        names = ["dh", "dx", "dx0"] + egnn_block.block_param_names(block)
        for name, a, b_, c_ in zip(names, flat(got_b), flat(via_saved), flat(again)):
            _check(torch.equal(a, b_), f"#2 lowp from the saved chain differs from the "
                                       f"recompute on {name} at N={n} H={H}")
            _check(torch.equal(a, c_), f"#2 lowp does not replay on {name} at N={n} H={H}")
        del via_saved, again, saved
        want_b = flat(egnn_block.block_backward_plain(block, *inputs[0], compute_dtype=LOWP))
        want_b16 = flat(egnn_block.block_backward_plain(block, *inputs[0], compute_dtype=bf16))
        rep = _bf16_grads_check(f"#2 lowp N={n} H={H}", names, flat(got_b), want_b, want_b16,
                                None, separation=_LOWP_BWD_SEPARATION, lowp=True)
        del got_b, want_b, want_b16
        # (b) Times in turns: bf16 then low-precision, the low-precision twice, bf16 again.
        with torch.no_grad():
            ms_bf16, ms = _in_turns(
                (lambda *a: egnn_block.block_forward_cuda(block, *a, compute_dtype=bf16),
                 lambda *a: egnn_block.block_forward_cuda(block, *a, compute_dtype=LOWP)),
                fwd_in)
            plain_ms = _time_ms(lambda *a: egnn_block.block_forward_plain(
                block, *a, compute_dtype=LOWP), fwd_in)
        bwd_bf16_ms, bwd_ms = _in_turns(
            (lambda *a: egnn_block.block_backward_cuda(block, *a, compute_dtype=bf16),
             lambda *a: egnn_block.block_backward_cuda(block, *a, compute_dtype=LOWP)), inputs)
        bwd_plain_ms = _time_ms(lambda *a: egnn_block.block_backward_plain(
            block, *a, compute_dtype=LOWP), inputs, warmup=1, reps=3)
        bound, bound_by = _bf16_bounds(*_block_work(block.cfg, n_real, n, n_weights)[:2])
        bwd_bound, bwd_bound_by = _bf16_bounds(*_bwd_work(block.cfg, n_real, n, n_weights)[:2])
        rows.append({"kernel": "egnn_block_lowp", "N": n, "B": B, "H": H, "max_abs_err": err,
                     "tol": _BF16_RTOL * scale, "mean_abs_err": mean_err,
                     "mean_to_bf16_plain": mean_bf16, "ms": ms, "bf16_ms": ms_bf16,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by})
        rows.append({"kernel": "egnn_block_bwd_lowp", "N": n, "B": B, "H": H,
                     **_bf16_fields(rep), "mean_to_bf16_plain": rep["mean_to_f32"],
                     "ms": bwd_ms, "bf16_ms": bwd_bf16_ms, "plain_ms": bwd_plain_ms,
                     "bound_ms": bwd_bound, "bound_by": bwd_bound_by})
        print(f"phase 38: #1 lowp N={n} B={B} H={H} to plain lowp max|d| {err:.3e} (tol "
              f"{_BF16_RTOL * scale:.2e}), mean {mean_err:.3e}, to plain bf16 mean "
              f"{mean_bf16:.3e}; the saving forward bit-identical; kernel {ms:.4f} ms, bf16 "
              f"kernel {ms_bf16:.4f} ms (in turns), plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({bound_by}) on {card}", flush=True)
        print(f"phase 38: #2 lowp N={n} B={B} H={H}: {len(names)} tensors max|d|/max(1,|ref|) "
              f"{rep['max_rel']:.2e} ({rep['worst']}; tol {_BF16_RTOL}; {rep['flips']} "
              f"weight-gradient elements one bf16 step off, at most {rep['max_flip_share']:.2%} "
              f"of a tensor); mean |d|/max(1,|ref|) {rep['mean_err']:.3e} to plain lowp, "
              f"{rep['mean_to_f32']:.3e} to plain bf16; the saved route and a replay "
              f"bit-identical; kernel {bwd_ms:.4f} ms, bf16 kernel {bwd_bf16_ms:.4f} ms (in "
              f"turns), plain {bwd_plain_ms:.4f} ms, bound {bwd_bound:.4f} ms ({bwd_bound_by}) "
              f"on {card}", flush=True)
        del inputs, fwd_in
        torch.cuda.empty_cache()
    return rows


def phase_lowp_train(card, tmpdir):
    """Phase 38 (c), (d): cli.main_qm9 at the QM9 recipe (nf 256, 9 layers,
    B=64, 3 steps, valid and test NLL, 8 stability samples as 10-step DDIM
    jumps) with GEOLDM_PALLAS_EDGE_LOWP=1, under --compute_dtype
    bfloat16_pallas and under bfloat16: the first launches only the
    low-precision #1/#2 (19 and 18 a step, 1 + 3*9 an eval batch, (10 + 1)*9
    + 9 a sampled chunk), the second only the bf16 ones, the same counts.
    Then the first run's state takes 3 more synchronised steps on one batch
    (B=64, N=29) with and without the variable, in turns (without, with,
    with, without), host clock."""
    import torch

    from geoldm_tpu_torch.cli import main_qm9
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import synthetic_batch, write_qm9_splits
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train.sampling import DEFAULT_SAMPLE_BUCKETS, n_chunks
    from geoldm_tpu_torch.train.train_step import make_train_step
    from geoldm_tpu_torch.train.trainer import prepare_batch
    from geoldm_tpu_torch.utils.buckets import covering_buckets

    info = get_dataset_info("qm9")
    B, steps, K, L, n_stab = 64, 3, 10, 9, 8
    write_qm9_splits(tmpdir, info, {"train": B * steps, "valid": B, "test": B}, seed=38)
    out = {}
    for dtype, suffix in (("bfloat16_pallas", "_lowp"), ("bfloat16", "_bf16")):
        argv = ["--datadir", tmpdir, "--outdir", os.path.join(tmpdir, "out"), "--exp_name",
                dtype, "--train_diffusion", "--trainable_ae", "--nf", "256", "--n_layers",
                str(L), "--latent_nf", "1", "--diffusion_steps", "1000", "--batch_size", str(B),
                "--n_epochs", "1", "--test_epochs", "1", "--n_stability_samples", str(n_stab),
                "--eval_n_steps", str(K), "--no_wandb", "--compute_dtype", dtype]
        print(f"phase 38: {_LOWP_ENV}=1 python -m geoldm_tpu_torch.cli.main_qm9 "
              f"{' '.join(argv)}", flush=True)
        with _lowp_env(True):
            _zero_launch_counts()
            t0 = time.time()
            summary = main_qm9.main(argv)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = _launch_counts()
        _check_fused(f"phase 38: cli.main_qm9 --compute_dtype {dtype}", steps)
        losses = summary["losses"][0]
        _check(len(losses) == steps and bool(np.all(np.isfinite(losses)))
               and np.isfinite(summary["nll_val"][0]) and np.isfinite(summary["nll_test"][0]),
               f"phase 38 {dtype}: losses {losses}, NLL {summary['nll_val']} "
               f"{summary['nll_test']}")
        chunks = n_chunks(summary["sample_sizes"][0], n_stab,
                          covering_buckets(DEFAULT_SAMPLE_BUCKETS, info["max_n_nodes"]))
        want = {**_no_launches(),
                f"egnn_block{suffix}": steps * (1 + 2 * L) + 2 * (1 + 3 * L)
                + chunks * ((K + 1) * L + L),
                f"egnn_block_bwd{suffix}": steps * 2 * L}
        _check(launches == want, f"phase 38 {dtype} with {_LOWP_ENV}=1: launches "
                                 f"{launches} != {want} ({chunks} chunks)")
        print(f"phase 38: {dtype} with {_LOWP_ENV}=1: {steps} steps, losses "
              f"{[round(v, 4) for v in losses]}, valid NLL {summary['nll_val'][0]:.4f}, test "
              f"NLL {summary['nll_test'][0]:.4f}, stability {summary['stability'][0]}; launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})} = 3*19 + 2*28 + "
              f"{chunks}*108 and 3*18; main() {wall:.1f} s on {card}", flush=True)
        out[dtype] = {"launches": launches, "losses": losses, "main_seconds": wall,
                      "nll_val": summary["nll_val"][0], "nll_test": summary["nll_test"][0]}
        if dtype == "bfloat16_pallas":
            state = summary["state"]
        del summary
    batch = prepare_batch(synthetic_batch(info, B, 29, np.random.default_rng(38)),
                          DistributionNodes(info.n_nodes), "cuda")
    step = make_train_step(state.model.cfg, 0.9999, "bfloat16_pallas")
    gen = torch.Generator(device="cuda").manual_seed(38)
    times = {False: [], True: []}
    for on in (False, True, True, False):
        with _lowp_env(on):
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                step(state, batch, gen)
                torch.cuda.synchronize()
                times[on].append((time.perf_counter() - t1) * 1e3)
    out["step_ms"] = {"bf16": times[False], "lowp": times[True]}
    print(f"phase 38: bfloat16_pallas train step B=64 N=29 in turns, with {_LOWP_ENV}=1 "
          f"{', '.join(f'{v:.1f}' for v in times[True])} ms, without "
          f"{', '.join(f'{v:.1f}' for v in times[False])} ms (host clock around synchronised "
          f"steps) on {card}", flush=True)
    return out


def phase_qm9_prepare(card, tmpdir):
    """Phase 39: QM9 preparation and the new flags on the card. Raw GDB9
    files fabricated in a temporary datadir (data.synthetic.write_gdb9_raw:
    64 molecules, the excluded list, atomref.txt; nothing fetched, the
    machine has no network), stale splits beside them; cli.main_qm9
    --force_download --trace DIR --visualize_every_batch 100 at the QM9
    recipe's width (B=16, 3 steps, a test epoch, 2 stability samples as
    10-step jumps): the splits rebuilt (50 / 7 / 5 molecules, thermo
    targets), one epoch, and the epoch's trace holding kernels #1/#2's edge
    tile (edge_tile_kernel) as GPU kernel events."""
    import torch

    from geoldm_tpu_torch.cli import main_qm9
    from geoldm_tpu_torch.data import qm9 as pqm9
    from geoldm_tpu_torch.data.synthetic import write_gdb9_raw

    def refuse(url, filename=None, *a, **k):
        raise OSError(f"phase 39 fetches nothing: {url}")

    write_gdb9_raw(tmpdir, 64, seed=39)
    for split in ("train", "valid", "test"):
        np.savez_compressed(os.path.join(tmpdir, "qm9", f"{split}.npz"), num_atoms=np.zeros(1))
    trace = os.path.join(tmpdir, "trace")
    argv = ["--datadir", tmpdir, "--outdir", os.path.join(tmpdir, "out"), "--exp_name", "prep",
            "--train_diffusion", "--trainable_ae", "--nf", "256", "--n_layers", "9",
            "--latent_nf", "1", "--diffusion_steps", "1000", "--batch_size", "16",
            "--n_epochs", "1", "--test_epochs", "1", "--n_stability_samples", "2",
            "--eval_n_steps", "10", "--no_wandb", "--force_download", "--trace", trace,
            "--visualize_every_batch", "100"]
    print(f"phase 39: python -m geoldm_tpu_torch.cli.main_qm9 {' '.join(argv)}", flush=True)
    fetch = pqm9.urllib.request.urlretrieve
    pqm9.urllib.request.urlretrieve = refuse
    try:
        _zero_launch_counts()
        t0 = time.time()
        summary = main_qm9.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _launch_counts()
    finally:
        pqm9.urllib.request.urlretrieve = fetch
    sizes = {}
    for split in ("train", "valid", "test"):
        with np.load(os.path.join(tmpdir, "qm9", f"{split}.npz")) as f:
            sizes[split] = len(f["num_atoms"])
            _check("U0_thermo" in f.files and f["positions"].ndim == 3,
                   f"phase 39: {split}.npz holds {f.files}")
    _check(sizes == {"train": 50, "valid": 7, "test": 5}, f"phase 39: split sizes {sizes}")
    losses = summary["losses"][0]
    _check(len(losses) == 3 and bool(np.all(np.isfinite(losses))), f"phase 39: losses {losses}")
    files = sorted(os.listdir(trace))
    _check(files == ["trace_epoch0_rank0.json"], f"phase 39: trace files {files}")
    with open(os.path.join(trace, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    tiles = [e for e in kernels if "edge_tile_kernel" in e.get("name", "")]
    _check(len(tiles) > 0, f"phase 39: the trace holds {len(kernels)} GPU kernel events, none "
                           f"of kernels #1/#2's edge tile")
    print(f"phase 39: --force_download rebuilt the splits from the fabricated raw files "
          f"({sizes}, nothing fetched); one epoch, losses {[round(v, 4) for v in losses]}; "
          f"--trace wrote {files[0]}: {len(events)} events, {len(kernels)} GPU kernel events, "
          f"{len(tiles)} of them edge_tile_kernel (#1/#2); --visualize_every_batch accepted; "
          f"launches {json.dumps({k: v for k, v in launches.items() if v})}; main() "
          f"{wall:.1f} s on {card}", flush=True)
    return {"splits": sizes, "losses": losses, "trace_events": len(events),
            "gpu_kernel_events": len(kernels), "edge_tile_events": len(tiles),
            "launches": launches, "main_seconds": wall}


_TP = 2  # model ranks of phase 40


def _tp_rule_elements(cfg, tp):
    """Elements of AMSGrad's moments and of the EMA one rank holds under
    ``tp`` model ranks by JAX's rule at the recipe's nf: every parameter
    whole, those of nf width 1/tp; the moments of the ones that get a
    gradient (not the encoder, whose latent is detached)."""
    import torch

    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.parallel import sharding

    nf = cfg.dynamics.egnn.hidden_nf
    model = factory.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    per = [(p.numel() // tp if sharding.tp_sharded(p, nf, tp) else p.numel(),
            not name.startswith("vae.encoder."))
           for name, p in model.named_parameters()]
    return {"optim": 3 * sum(n for n, g in per if g), "ema": sum(n for n, _ in per)}


def _tp_step(raw, compute_dtype, grid=None):
    """One QM9-recipe train step through the train state (AMSGrad, the
    clip, the EMA) from seed-5 weights and the replayed noise stream 12 on
    the global batch ``raw`` in ``compute_dtype``: on one rank on the card,
    or over ``grid``'s data and model ranks -> (loss, gradient norm, {name:
    the gradient AdamW applies, the shards gathered}, {name: the weights
    after the step}, launches, state)."""
    import torch

    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.parallel import sharding
    from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step
    from geoldm_tpu_torch.train.trainer import prepare_host, to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, info, _ = _recipe("qm9")
    device = "cuda" if grid is None else grid.device
    data, tp = (None, None) if grid is None else (grid.data, grid.model)
    model = factory.build_model(cfg, device, torch.Generator().manual_seed(5))
    state = create_train_state(model, cfg, 1e-4, ema_decay=0.9999, dp_group=data,
                               model_group=tp, hidden_nf=cfg.dynamics.egnn.hidden_nf)
    step = make_train_step(cfg, 0.9999, compute_dtype)
    batch = to_device(sharding.shard_rows(prepare_host(raw, DistributionNodes(info.n_nodes)),
                                          data), device)
    before = _launch_counts()
    out = step(state, batch, sharding.wrap_noise(_Replay(12), data))
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _launch_counts().items()}
    # The gradients AdamW applied stay after the step, clipped in place (the
    # fused step writes the clipped values back).
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    mine = [(p, s) for p, s in state.shards if s.grad is not None]
    full = sharding.gather_shards([s.grad for _, s in mine], tp) if mine else []
    grads.update({names[id(p)]: g.cpu() for (p, _), g in zip(mine, full)})
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    return float(out["loss"]), float(out["grad_norm"]), grads, params, launches, state


def _tp_rank(raw, timed, grid):
    """One rank of phase 40 (b): the recipe step in f32 and in bf16
    (``_tp_step``), every rank's digest of the gathered state after it; then
    3 synchronised recipe train steps on this rank's rows of the global
    ``timed`` batch and the gather of the updated shards alone -> rank 0's
    losses, norms, gradients and weights, every rank's digests, launches and
    times."""
    import torch
    import torch.distributed as dist

    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.parallel import sharding, sp
    from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step
    from geoldm_tpu_torch.train.trainer import prepare_host, to_device

    out, mine = {}, {"rank": grid.rank}
    for name, dt in (("float32", None), ("bfloat16", "bfloat16")):
        loss, norm, grads, params, launches, state = _tp_step(raw, dt, grid)
        out[name] = {"loss": loss, "grad_norm": norm, "grads": grads, "params": params}
        mine[name] = {"launches": launches, "digest": sp.state_digest(state),
                      "shard_digest": sp.shard_digest(state)}
        del state, grads, params
    cfg, info, _ = _recipe("qm9")
    model = factory.build_model(cfg, grid.device, torch.Generator().manual_seed(5))
    state = create_train_state(model, cfg, 1e-4, ema_decay=0.9999, dp_group=grid.data,
                               model_group=grid.model, hidden_nf=cfg.dynamics.egnn.hidden_nf)
    step = make_train_step(cfg, 0.9999)
    batch = to_device(sharding.shard_rows(prepare_host(timed, DistributionNodes(info.n_nodes)),
                                          grid.data), grid.device)
    noise = sharding.wrap_noise(torch.Generator(device=grid.device).manual_seed(7), grid.data)
    mine["step_ms"] = _host_ms(lambda: step(state, batch, noise))
    shards = [s.detach() for _, s in state.shards]
    fulls = [p.detach() for p, _ in state.shards]
    mine["gather_ms"] = _host_ms(lambda: sharding.gather_shards(shards, grid.model, out=fulls))
    mine["gather_mb"] = sum(s.numel() * s.element_size() for s in shards) / 1e6
    mine["local_batch"] = int(batch["x"].shape[0])
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    out["ranks"] = ranks
    return out


def _tp_gate(what, got, ref, start, rtol, lr=1e-4):
    """The loss within _LOSS_RTOL, the gradient norm within _LOSS_RTOL (f32)
    or ``rtol`` (bf16) of one rank's, every gradient within ``rtol`` *
    max|ref|, and every weight's move within 3e-2 * lr of one rank's where
    the gradient gate resolves the gradient (|g_ref| > rtol * max|g_ref|):
    AMSGrad's first step moves a weight by lr * g / (|g| + eps), so below
    that the gate fixes neither the move's sign nor, near eps, its size ->
    (worst gradient ratio, its tensor, elements left out of the move's
    check)."""
    import torch

    _check(abs(got["loss"] - ref["loss"]) <= _LOSS_RTOL * abs(ref["loss"]),
           f"phase 40: {what} loss {got['loss']} vs one rank {ref['loss']}")
    n_rtol = _LOSS_RTOL if rtol <= _GRAD_RTOL else rtol
    _check(abs(got["grad_norm"] - ref["grad_norm"]) <= n_rtol * ref["grad_norm"],
           f"phase 40: {what} gradient norm {got['grad_norm']} vs one rank "
           f"{ref['grad_norm']} (a factor of T would show here)")
    _check(set(got["grads"]) == set(ref["grads"]) and ref["grads"],
           f"phase 40: {what} and one rank gave gradients to different parameters")
    worst, worst_name, unresolved = 0.0, "", 0
    for k, g_ref in ref["grads"].items():
        g = got["grads"][k]
        _check(bool(torch.isfinite(g).all()), f"phase 40: {what} gradient of {k} not finite")
        d, scale = float((g - g_ref).abs().max()), float(g_ref.abs().max())
        _check(d <= rtol * scale, f"phase 40: {what} gradient of {k}: max|d|={d:.3e} > "
                                  f"{rtol}*{scale:.3e}")
        if scale and d / scale >= worst:
            worst, worst_name = d / scale, k
        resolved = g_ref.abs() > rtol * scale
        unresolved += int((~resolved).sum())
        moved = (got["params"][k] - start[k]) - (ref["params"][k] - start[k])
        dm = float(moved[resolved].abs().max()) if bool(resolved.any()) else 0.0
        _check(dm <= 3e-2 * lr, f"phase 40: {what} update of {k} differs by {dm:.3e} from one "
                                f"rank's (> 3e-2 * lr)")
    return worst, worst_name, unresolved


def phase_tp_grad(card):
    """Phase 40 (b): the QM9 recipe's train step (B=8, N=29) over TP-2 and
    over DP-2 x TP-2 ranks sharing the card, in f32 and bf16, against one
    rank's on the card: the gates of ``_tp_gate`` (f32 1e-3, bf16 1e-2 *
    max|ref|), the gathered states bit-identical on every rank, each rank's
    launches one rank's; then timed TP steps at B=64 (32 a data row on the
    2 x 2 grid), the shards' gather alone and the one-rank step."""
    import torch

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import synthetic_batch
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.parallel import sharding
    from geoldm_tpu_torch.train.train_step import create_train_state
    from geoldm_tpu_torch.train.trainer import prepare_batch

    t0 = time.time()
    raw, L = _qm9_grad_batch(), 9
    info = get_dataset_info("qm9")
    timed = synthetic_batch(info, 64, 29, np.random.default_rng(40))
    cfg, _, _ = _recipe("qm9")
    start = {n: p.detach() for n, p in factory.build_model(
        cfg, "cpu", torch.Generator().manual_seed(5)).named_parameters()}
    ref = {}
    for name, dt in (("float32", None), ("bfloat16", "bfloat16")):
        loss, norm, grads, params, _, _ = _tp_step(raw, dt)
        ref[name] = {"loss": loss, "grad_norm": norm, "grads": grads, "params": params}
    model = factory.build_model(cfg, "cuda", torch.Generator().manual_seed(5))
    one_ms = _time_steps(create_train_state(model, cfg, 1e-4, ema_decay=0.9999), 0.9999,
                         prepare_batch(timed, DistributionNodes(info.n_nodes), "cuda"))
    del model
    print(f"phase 40: one-rank QM9 recipe train step B=64 N=29: "
          f"{', '.join(f'{v:.1f}' for v in one_ms)} ms (host clock around synchronised steps) "
          f"on {card}", flush=True)
    out = {"one_rank_step_ms": one_ms}
    for dp in (1, 2):
        what = f"DP-{dp} x TP-{_TP}" if dp > 1 else f"TP-{_TP}"
        got = sharding.spawn(dp, 1, _tp_rank, (raw, timed), device="cuda", tp=_TP)
        rows = {}
        for name, rtol in (("float32", _GRAD_RTOL), ("bfloat16", 1e-2)):
            worst, worst_name, unresolved = _tp_gate(f"{what} {name}", got[name], ref[name],
                                                     start, rtol)
            sfx = "" if name == "float32" else "_bf16"
            per_rank = {**_no_launches(), f"egnn_block{sfx}": 1 + 2 * L,
                        f"egnn_block_bwd{sfx}": 2 * L}
            for r in got["ranks"]:
                _check(r[name]["launches"] == per_rank,
                       f"phase 40: {what} {name} rank {r['rank']} launches "
                       f"{r[name]['launches']} != {per_rank}")
            _check(len({r[name]["digest"] for r in got["ranks"]}) == 1,
                   f"phase 40: {what} {name}: the gathered train states differ")
            shard = [r[name]["shard_digest"] for r in got["ranks"]]
            _check(all(shard[i] == shard[i % _TP] for i in range(len(shard)))
                   and len(set(shard[:_TP])) == _TP,
                   f"phase 40: {what} {name}: shard digests {[s[:8] for s in shard]}")
            rows[name] = {"loss": got[name]["loss"], "loss_one_rank": ref[name]["loss"],
                          "grad_norm": got[name]["grad_norm"],
                          "grad_norm_one_rank": ref[name]["grad_norm"], "worst_rel": worst,
                          "worst": worst_name, "moves_unresolved": unresolved}
            print(f"phase 40: {what} {name} train-step gradient (QM9 recipe, B={len(raw['x'])} "
                  f"global): loss {got[name]['loss']:.6f} one rank {ref[name]['loss']:.6f}; "
                  f"grad norm {got[name]['grad_norm']:.6f} one rank "
                  f"{ref[name]['grad_norm']:.6f}; worst max|d|/max|ref| {worst:.2e} "
                  f"({worst_name}; tol {rtol}); weights' moves within 3e-2*lr where the "
                  f"gate resolves the gradient ({unresolved} elements below it); gathered "
                  f"states bit-identical on "
                  f"{len(got['ranks'])} ranks; launches per rank "
                  f"{json.dumps({k: v for k, v in per_rank.items() if v})} on {card}",
                  flush=True)
        for r in got["ranks"]:
            print(f"phase 40: {what} train step, 64 molecules global, {r['local_batch']} on "
                  f"rank {r['rank']}: {', '.join(f'{v:.1f}' for v in r['step_ms'])} ms; gather "
                  f"of the shards alone {', '.join(f'{v:.2f}' for v in r['gather_ms'])} ms, "
                  f"{r['gather_mb']:.1f} MB a rank a step (host clock around synchronised "
                  f"calls; {dp * _TP} ranks sharing one card over gloo: correctness and "
                  f"overhead, not scaling) on {card}", flush=True)
        rows.update({k: [r[k] for r in got["ranks"]] for k in ("step_ms", "gather_ms")})
        rows["gather_mb"] = got["ranks"][0]["gather_mb"]
        out["tp2" if dp == 1 else "dp2_tp2"] = rows
        del got
    out["seconds"] = time.time() - t0
    torch.cuda.empty_cache()
    return out


def phase_fused_optim(card, steps=20):
    """Phase 41: the fused optimizer step (ops.fused_optim, three launches)
    against its plain version (the train step's on the CPU: the clip,
    torch's foreach AdamW, the EMA's foreach ops) at the QM9 recipe's list:
    the model's 301 parameters, the encoder's 23 without a gradient, AdamW
    over the rest, the clip and the EMA at 0.9999. Timed in turns (plain,
    fused, fused, plain), ``steps`` steps a turn after a warm-up, with CUDA
    events around the whole step (the host's issue included); the fused
    kernels' device time from the profiler (a warm-up session, then the
    measured one: the mean over the launches it recorded); the bound: the
    bytes the three kernels must move over 3.35 TB/s. Both versions step
    the same gradients: every tensor (parameters, moments, EMA) within 1e-6
    of its largest element. Then one step's gradients are 1e4 times larger,
    so the clip trips, and two more steps follow. Each step's returned norm
    is held within 1e-6 of the float64 norm of the gradients it took, and
    the ring buffer, its counters and the spike's clipped gradients (the
    scale) within 1e-6 of the clip's arithmetic in float64 over those
    norms; after the spike the two versions' tensors are held within 1e-6
    plus the plain version's own error in the scale (its f32 norm and
    threshold)."""
    import torch

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.ops import fused_optim
    from geoldm_tpu_torch.train.optim import ema_update
    from geoldm_tpu_torch.train.train_step import create_train_state

    cfg = factory.make_latent_diffusion_config(get_dataset_info("qm9"), trainable_ae=True)
    sides = {}

    def sq64(name):  # the sum of the squares of a side's gradients, in float64
        return sum(float((p.grad.double() ** 2).sum()) for _, p in sides[name]["named"]
                   if p.grad is not None)

    for name in ("plain", "fused"):
        model = factory.build_model(cfg, "cuda", torch.Generator().manual_seed(7))
        state = create_train_state(model, cfg, 1e-4, ema_decay=0.9999)
        named = list(model.named_parameters())
        gen = torch.Generator(device="cuda").manual_seed(8)
        for n, p in named:  # the encoder's latent is detached: no gradient
            p.grad = None if n.startswith("vae.encoder.") else \
                torch.empty_like(p).normal_(generator=gen) * 1e-3
        ema, sources = list(state.ema_model.parameters()), list(model.parameters())
        if name == "fused":
            fused = fused_optim.FusedStep(state.optimizer, [False] * len(state.params), ema,
                                          sources, 0.9999, state.clip)

            def run(fused=fused):
                norm = fused.clip_norm()
                fused.update()
                return norm
        else:
            def run(state=state, ema=ema, sources=sources):
                norm = state.clip([p.grad for p in state.params if p.grad is not None])
                state.optimizer.step()
                ema_update(ema, sources, 0.9999)
                return norm
        sides[name] = {"run": run, "state": state, "named": named, "ms": [], "host_ms": []}
        ref0 = math.sqrt(sq64(name))
        # the first step allocates the moments and (fused) builds the tables
        sides[name]["norms"] = [run()]
    stepped = sum(p.numel() for _, p in sides["fused"]["named"] if p.grad is not None)
    ema_only = sum(p.numel() for n, p in sides["fused"]["named"] if p.grad is None)

    def steps_of(name, n):
        side = sides[name]
        for _ in range(n):
            side["norms"].append(side["run"]())

    torch.cuda.synchronize()
    for name in ("plain", "fused", "fused", "plain"):
        side = sides[name]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        steps_of(name, steps)
        host = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        side["ms"].append(start.elapsed_time(end) / steps)
        side["host_ms"].append(1e3 * host / steps)
    kernels = ("norm_kernel", "threshold_kernel", "update_kernel")
    sessions = []
    for _ in ("warm-up", "measured"):
        before = fused_optim.launches()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            steps_of("fused", steps)
            torch.cuda.synchronize()
        launched = [a - b for a, b in zip(fused_optim.launches(), before)]
        _check(launched == [steps] * 3, f"the fused step launched {launched} in {steps} steps")
        dev_ns, seen, other = dict.fromkeys(kernels, 0), dict.fromkeys(kernels, 0), []
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA or ev.is_user_annotation():
                continue
            k = next((k for k in kernels if k in ev.name()), None)
            if k is None:
                other.append(ev.name())
                continue
            dev_ns[k] += ev.duration_ns()
            seen[k] += 1
        sessions.append((dev_ns, seen, other))
    # The launches ran (the counters, and the state below); the profiler
    # recorded no other device op, and at least one of each kernel.
    dev_ns, seen, other = sessions[-1]
    _check(not other and all(seen.values()),
           f"the fused step's device ops: {seen}, others {sorted(set(other))[:3]}")
    steps_of("plain", 2 * steps)  # both sides have now taken 1 + 4 * steps
    spike = 1 + 4 * steps
    _check(math.sqrt(sq64("fused")) == math.sqrt(sq64("plain")) == ref0,
           "the gradients changed in steps that do not clip")

    def compare():
        """The worst distance of the two sides' tensors: (name, share of
        the tensor's largest element), and the largest absolute one."""
        worst, worst_abs = ("", 0.0), 0.0
        ema = {k: dict(v["state"].ema_model.named_parameters()) for k, v in sides.items()}
        for (n, p), (_, q) in zip(sides["plain"]["named"], sides["fused"]["named"]):
            pairs = [(p, q), (ema["plain"][n], ema["fused"][n])]
            if n in sides["plain"].get("clipped", {}):
                pairs.append((sides["plain"]["clipped"][n], sides["fused"]["clipped"][n]))
            st_p = sides["plain"]["state"].optimizer.state.get(p, {})
            st_f = sides["fused"]["state"].optimizer.state.get(q, {})
            _check(set(st_p) == set(st_f), f"{n}: AdamW state {sorted(st_f)} != {sorted(st_p)}")
            pairs += [(st_p[k], st_f[k]) for k in fused_optim.MOMENTS if k in st_p]
            for a, b in pairs:
                d = float((a.detach() - b.detach()).abs().max())
                worst_abs = max(worst_abs, d)
                worst = max(worst, (n, d / max(1e-30, float(a.detach().abs().max()))),
                            key=lambda w: w[1])
        return worst, worst_abs

    before_spike, _ = compare()
    _check(before_spike[1] <= 1e-6, f"fused step vs plain before the spike: {before_spike[0]} "
                                    f"off by {before_spike[1]:.3e} of its max")
    # One step whose gradients trip the clip, then two that do not.
    refs = {k: [ref0] * spike for k in sides}
    for name in ("plain", "fused"):
        side = sides[name]
        with torch.no_grad():
            for _, p in side["named"]:
                if p.grad is not None:
                    p.grad.mul_(1e4)
        side["spiked"] = {n: p.grad.detach().clone() for n, p in side["named"]
                          if p.grad is not None}
        for j in range(3):
            refs[name].append(math.sqrt(sq64(name)))
            steps_of(name, 1)
            if j == 0:
                side["clipped"] = {n: p.grad.detach().clone() for n, p in side["named"]
                                   if p.grad is not None}
    torch.cuda.synchronize()
    # Each step's norm against the float64 norm of the gradients it took;
    # the ring buffer, its counters and the clip's scale against the clip's
    # arithmetic in float64 over those norms.
    norms = {k: torch.stack(v["norms"]).double().cpu() for k, v in sides.items()}
    rel = {k: float(((norms[k] - torch.tensor(refs[k], dtype=torch.float64)).abs()
                     / torch.tensor(refs[k], dtype=torch.float64)).max()) for k in sides}
    _check(len(norms["fused"]) == len(refs["fused"]) == spike + 3 and rel["fused"] <= 1e-6,
           f"the fused step's norms are off by {rel['fused']:.3e} of the float64 norm")
    ring, count, head, thr = [3000.0] + [0.0] * 49, 1, 1, []
    for n in refs["fused"]:
        valid = ring[:count]
        mean = sum(valid) / count
        thr.append(1.5 * mean + 2 * math.sqrt(sum((v - mean) ** 2 for v in valid) / count))
        ring[head % 50] = min(n, thr[-1])
        count, head = min(count + 1, 50), head + 1
    clips = {k: v["state"].clip for k, v in sides.items()}
    ring_rel = max(abs(float(f) - r) / r for f, r in zip(clips["fused"].norms.cpu(), ring))
    _check(refs["fused"][spike] > 100 * thr[spike] and ring_rel <= 1e-6
           and (clips["fused"].count, clips["fused"].head) == (clips["plain"].count,
                                                               clips["plain"].head)
           == (count, head),
           f"the fused step's ring buffer off by {ring_rel:.3e} of float64's, counters "
           f"{(clips['fused'].count, clips['fused'].head)}, plain "
           f"{(clips['plain'].count, clips['plain'].head)}, float64 {(count, head)}; the "
           f"spike's norm {refs['fused'][spike]:.4e} against the threshold {thr[spike]:.4e}")
    scale = thr[spike] / (refs["fused"][spike] + 1e-12)
    scale_rel = {k: max(float((sides[k]["clipped"][n].double() - g.double() * scale).abs().max())
                        / float(g.double().abs().max() * scale)
                        for n, g in sides[k]["spiked"].items()) for k in sides}
    _check(scale_rel["fused"] <= 1e-6, f"the fused step's clipped gradients are off by "
                                       f"{scale_rel['fused']:.3e} of float64's scale {scale:.6e}")
    # After the spike the plain version's f32 norm and threshold move its
    # scale by their own error (``scale_rel["plain"]``) too.
    worst, worst_abs = compare()
    _check(worst[1] <= 1e-6 + scale_rel["plain"],
           f"fused step vs plain after the spike: {worst[0]} off by {worst[1]:.3e} of its max")
    dev_ms = {k: dev_ns[k] / 1e6 / seen[k] for k in kernels}
    bytes_ = {"norm_kernel": 4 * stepped, "threshold_kernel": 0,
              "update_kernel": 4 * (12 * stepped + 3 * ema_only)}
    bound = {k: b / _BW_PEAK * 1e3 for k, b in bytes_.items()}
    row = {"stepped": stepped, "ema_only": ema_only, "steps": steps,
           "plain_ms": sides["plain"]["ms"], "fused_ms": sides["fused"]["ms"],
           "plain_host_ms": sides["plain"]["host_ms"], "fused_host_ms": sides["fused"]["host_ms"],
           "kernel_ms": dev_ms, "kernel_events": seen,
           "warmup_kernel_events": sessions[0][1], "bound_ms": bound,
           "max_rel_err": max(worst[1], before_spike[1]), "max_abs_err": worst_abs,
           "norm_rel_err": rel["fused"], "plain_norm_rel_err": rel["plain"],
           "ring_rel_err": ring_rel, "scale_rel_err": scale_rel["fused"],
           "plain_scale_rel_err": scale_rel["plain"]}
    print(f"phase 41: fused optimizer step at the QM9 recipe ({stepped} stepped, {ema_only} "
          f"EMA-only elements): step {' / '.join(f'{m:.4f}' for m in row['fused_ms'])} ms "
          f"(host {' / '.join(f'{m:.4f}' for m in row['fused_host_ms'])}), plain "
          f"{' / '.join(f'{m:.4f}' for m in row['plain_ms'])} ms (host "
          f"{' / '.join(f'{m:.4f}' for m in row['plain_host_ms'])}); kernels "
          + ", ".join(f"{k} {dev_ms[k]:.4f} ms (bound {bound[k]:.4f})" for k in kernels)
          + f"; the profiler recorded {sessions[0][1]} of {steps} launches each in its warm-up "
          f"session and {seen} in the measured one, no other device op; {spike + 3} steps, the "
          f"clip tripped at step {spike} (norm {refs['fused'][spike]:.4e}, threshold "
          f"{thr[spike]:.4e}): against float64, the norms within {rel['fused']:.2e} (plain "
          f"{rel['plain']:.2e}), the ring buffer within {ring_rel:.2e} (counters equal), the "
          f"clipped gradients within {scale_rel['fused']:.2e} (plain "
          f"{scale_rel['plain']:.2e}); against the plain version, tensors "
          f"within {before_spike[1]:.2e} of their max before the spike and {worst[1]:.2e} "
          f"after it on {card}", flush=True)
    return row


def phase_tp(card, tmpdir, qm9_dir):
    """Phase 40: tensor parallelism. (a) ``cli.main_qm9 --tp 2`` at the QM9
    recipe (nf=256, 9 layers, latent_nf=1, T=1000, B=64, EMA 0.9999),
    resumed from phase 7's checkpoint (a ``--tp 1`` run's: the loaded state
    equal to its files tensor for tensor) for 3 steps and one eval with
    50-jump stability samples, two ranks sharing the card over gloo:
    launches exact per rank (one rank's run: each model rank runs every
    step, eval batch and chunk), the gathered states bit-identical, the
    shards not, each rank's optimizer and EMA elements the rule's; (b)
    ``phase_tp_grad``; (c) (a)'s checkpoint resumed under ``--tp 1`` for one
    step; (d) ``cli.main_geom_drugs --tp 2`` at the GEOM recipe, one step of
    32 molecules at pad 184 (#3/#4/#5 on every rank)."""
    import torch

    from geoldm_tpu_torch.cli import main_geom_drugs, main_qm9
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.geom import GeomLoader, load_split_data
    from geoldm_tpu_torch.data.synthetic import write_geom_conformers, write_qm9_splits
    from geoldm_tpu_torch.parallel import sharding
    from geoldm_tpu_torch.train.sampling import (
        DEFAULT_SAMPLE_BUCKETS,
        chunk_pads,
        default_buckets,
    )
    from geoldm_tpu_torch.utils.buckets import covering_buckets

    # (a)
    info = get_dataset_info("qm9")
    B, steps, T, K, L, n_stab = 64, 3, 1000, 50, 9, 4
    qm9_tp = os.path.join(tmpdir, "qm9")
    write_qm9_splits(qm9_tp, info, {"train": B * steps, "valid": B, "test": B}, seed=40)
    out = os.path.join(tmpdir, "out")
    width = ["--train_diffusion", "--trainable_ae", "--nf", "256", "--n_layers", str(L),
             "--latent_nf", "1", "--diffusion_steps", str(T), "--batch_size", str(B),
             "--ema_decay", "0.9999", "--seed", "0", "--no_wandb"]
    phase7 = os.path.join(qm9_dir, "out", "smoke")
    argv = ["--datadir", qm9_tp, "--outdir", out, "--exp_name", "tp", "--tp", str(_TP),
            "--resume", phase7, "--start_epoch", "1", "--n_epochs", "2", "--test_epochs", "1",
            "--n_stability_samples", str(n_stab), "--eval_n_steps", str(K), *width]
    rule = sharding.placement(_TP, "cuda")[2]
    print(f"phase 40: python -m geoldm_tpu_torch.cli.main_qm9 {' '.join(argv)}", flush=True)
    _zero_launch_counts()
    t0 = time.time()
    summary = main_qm9.main(argv)
    wall = time.time() - t0
    _check(not any(_launch_counts().values()), "phase 40: the launching process ran kernels")
    losses = summary["losses"][0]
    _check(len(losses) == steps and bool(np.all(np.isfinite(losses))), f"losses {losses}")
    _check(np.isfinite(summary["nll_val"][0]) and np.isfinite(summary["nll_test"][0]),
           f"phase 40: NLLs {summary['nll_val']} {summary['nll_test']}")
    replicas = _check_replicas(40, summary, _TP)
    _check(len({r["shard_digest"] for r in replicas}) == _TP,
           "phase 40: the model ranks hold the same shards")
    _check(len({r["resumed_digest"] for r in replicas}) == 1,
           "phase 40: the ranks resumed different states")
    n_equal = _equal_files(summary["resumed"], os.path.join(phase7, "latest"), 40)
    pads = chunk_pads(summary["sample_sizes"][0], n_stab,
                      covering_buckets(DEFAULT_SAMPLE_BUCKETS, info["max_n_nodes"]))
    want = _rank_expected(1 + 2 * L, 1 + 3 * L, steps, 2, pads, K, L, 1, False)
    for r in replicas:
        _check(r["launches"] == want, f"phase 40: rank {r['rank']} launches {r['launches']} "
                                      f"!= {want} (chunk pads {pads})")
    cfg, _, _ = _recipe("qm9")
    elements, one_rank = _tp_rule_elements(cfg, _TP), _tp_rule_elements(cfg, 1)
    for r in replicas:
        _check(r["state_elements"] == elements, f"phase 40: rank {r['rank']} holds "
                                                f"{r['state_elements']} != {elements}")
    ckpt = os.path.join(out, "tp", "latest")
    files = sorted(os.listdir(ckpt))
    _check(files == sorted(["args.pickle", "generative_model.npy", "generative_model_ema.npy",
                            "optim.npy", "train_state.npy"]), f"phase 40: {ckpt} holds {files}")
    optim = torch.load(os.path.join(ckpt, "optim.npy"), map_location="cpu", weights_only=True)
    model_sd = torch.load(os.path.join(ckpt, "generative_model.npy"), weights_only=True)
    shapes = [tuple(v.shape) for k, v in model_sd.items() if not k.endswith("buffer")
              and k != "gamma.gamma" and not k.startswith("vae.encoder.")]
    _check([tuple(e["exp_avg"].shape) for _, e in sorted(optim["state"].items())] == shapes,
           "phase 40: optim.npy's moments are not the full model's, in its order")
    mb = {k: 4 * v / 1e6 for k, v in elements.items()}
    print(f"phase 40: {rule}; resumed phase 7's --tp 1 checkpoint at step "
          f"{summary['resumed']['step']} ({n_equal} tensors and counters equal its files); "
          f"{steps} steps of {B} molecules (all {B} on each model rank), "
          f"losses {[round(v, 4) for v in losses]}, valid NLL {summary['nll_val'][0]:.4f}, "
          f"test NLL {summary['nll_test'][0]:.4f}, stability {summary['stability'][0]} (chunk "
          f"pads {pads}, every chunk on both ranks); launches per rank "
          f"{json.dumps({k: v for k, v in want.items() if v})} = one rank's run; gathered "
          f"states bit-identical (sha256 {replicas[0]['digest'][:16]}), shards differ; per "
          f"rank {elements['optim']} AMSGrad + {elements['ema']} EMA elements "
          f"({mb['optim'] + mb['ema']:.1f} MB f32; one rank {one_rank['optim']} + "
          f"{one_rank['ema']}, {4 * (one_rank['optim'] + one_rank['ema']) / 1e6:.1f} MB) = the "
          f"rule's; latest/ holds one rank's five files, optim.npy keyed by the full model; "
          f"main() {wall:.1f} s, epoch {summary['epoch_seconds'][0]:.1f} s on {card}",
          flush=True)
    res = {"launches": {k: sum(r["launches"][k] for r in replicas) for k in _no_launches()},
           "rule": rule, "losses": losses, "nll_val": summary["nll_val"][0],
           "nll_test": summary["nll_test"][0], "stability": summary["stability"][0],
           "state_elements": elements, "state_elements_one_rank": one_rank,
           "resumed_tensors_equal": n_equal, "main_seconds": wall,
           "epoch_seconds": summary["epoch_seconds"][0]}
    del summary

    # (b)
    res["grad"] = phase_tp_grad(card)

    # (c): (a)'s checkpoint under --tp 1, one step.
    argv = ["--datadir", qm9_tp, "--outdir", out, "--exp_name", "tp_to_1", "--resume",
            os.path.join(out, "tp"), "--break_train_epoch", "True", "--start_epoch", "1",
            "--n_epochs", "2", "--test_epochs", "2", *width]
    print(f"phase 40: python -m geoldm_tpu_torch.cli.main_qm9 {' '.join(argv)}", flush=True)
    _zero_launch_counts()
    t0 = time.time()
    summary = main_qm9.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launch_counts()
    n_equal = _equal_files(summary["resumed"], ckpt, 40)
    losses = summary["losses"][0]
    want = {**_no_launches(), "egnn_block": 1 + 2 * L, "egnn_block_bwd": 2 * L}
    _check(len(losses) == 1 and bool(np.all(np.isfinite(losses))) and launches == want,
           f"phase 40: --tp 1 resume: losses {losses}, launches {launches} != {want}")
    print(f"phase 40: --tp 1 resumed the --tp {_TP} checkpoint at step "
          f"{summary['resumed']['step']}: {n_equal} tensors and counters equal its files; one "
          f"step, loss {losses[0]:.4f}, launches {json.dumps({k: v for k, v in want.items() if v})}"
          f"; main() {wall:.1f} s on {card}", flush=True)
    res["resume_to_tp1"] = {"tensors_equal": n_equal, "launches": launches,
                            "main_seconds": wall}
    del summary

    # (d)
    geom = get_dataset_info("geom")
    B, L, inv, n_stab = 32, 4, 1, 2
    hist = sorted(dict(geom.n_nodes_histogram))
    rng = np.random.default_rng(40)
    sizes = [int(v) for v in rng.choice([k for k in hist if 129 <= k <= 181], size=B)]
    geom_dir = os.path.join(tmpdir, "geom")
    path = write_geom_conformers(geom_dir, geom, len(sizes) * 5 // 4, seed=40, sizes=sizes)
    argv = ["--datadir", geom_dir, "--outdir", out, "--exp_name", "geom_tp", "--tp", str(_TP),
            "--train_diffusion", "--trainable_ae", "--nf", "256", "--n_layers", str(L),
            "--latent_nf", "2", "--include_charges", "False", "--diffusion_steps", str(T),
            "--batch_size", str(B), "--lr", "5e-5", "--ema_decay", "0.9999", "--n_epochs",
            "1", "--test_epochs", "1", "--n_stability_samples", str(n_stab), "--eval_n_steps",
            str(K), "--seed", "0", "--no_wandb"]
    print(f"phase 40: python -m geoldm_tpu_torch.cli.main_geom_drugs {' '.join(argv)}",
          flush=True)
    _zero_launch_counts()
    t0 = time.time()
    summary = main_geom_drugs.main(argv)
    wall = time.time() - t0
    _check(not any(_launch_counts().values()), "phase 40: the launching process ran kernels")
    losses = summary["losses"][0]
    _check(len(losses) == 1 and bool(np.all(np.isfinite(losses))), f"losses {losses}")
    replicas = _check_replicas(40, summary, _TP)
    train, val, test = load_split_data(path)
    gpads = {"train": [int(b["node_mask"].shape[1]) for b in GeomLoader(train, geom, B)],
             "eval": [int(b["node_mask"].shape[1]) for data in (val, test)
                      for b in GeomLoader(data, geom, B, shuffle=False, include_charges=False)],
             "chunks": chunk_pads(summary["sample_sizes"][0], n_stab,
                                  covering_buckets(default_buckets(geom), geom["max_n_nodes"]))}
    _check(gpads["train"] == [184], f"phase 40: train batch pads {gpads['train']}")
    want = _geom_expected(gpads, L, inv, (K + 1) * L + L)
    for r in replicas:
        _check(r["launches"] == want, f"phase 40: GEOM rank {r['rank']} launches "
                                      f"{r['launches']} != {want} (pads {gpads})")
    print(f"phase 40: GEOM --tp {_TP}: 1 step of {B} molecules at pad 184 on each model rank, "
          f"loss {losses[0]:.4f}, valid NLL {summary['nll_val'][0]:.4f}, test NLL "
          f"{summary['nll_test'][0]:.4f}, stability {summary['stability'][0]}; launches per "
          f"rank {json.dumps({k: v for k, v in want.items() if v})} = what the code implies "
          f"for pads {gpads}; gathered states bit-identical; main() {wall:.1f} s on {card}",
          flush=True)
    res["geom"] = {"launches": {k: sum(r["launches"][k] for r in replicas)
                                for k in _no_launches()},
                   "pads": gpads, "losses": losses, "main_seconds": wall}
    torch.cuda.empty_cache()
    return res


def _graph_ms(fn, reps, replays=3):
    """Mean ms per call of ``fn`` (which launches on the current stream)
    from CUDA events around ``replays`` replays of a graph of ``reps``
    calls: the device's time, the host's issue left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def phase_node_gemm(card, reps=50):
    """Phase 42: the node GEMM alone (the library's ``egnn_node_gemm``, which
    runs ``run_node_gemm`` as every caller does) at the main path's shapes,
    each product held to float64 (of the bf16-rounded operands for the bf16
    forward) at 1e-4 of its largest element and timed with CUDA events
    (``reps`` launches captured in a CUDA graph, the replays timed: device
    time without the host's issue) beside its bound."""
    import torch

    from geoldm_tpu_torch.ops import cuda_build

    lib = cuda_build.library("egnn_block_bwd")
    H, E = 256, 2
    ld1 = 2 * H + E
    gen = torch.Generator(device="cuda").manual_seed(42)
    split = torch.empty(32 * H * H, device="cuda")

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def p(t):
        return None if t is None else t.data_ptr()

    def bf(t):
        return t.to(torch.bfloat16).double()

    def gemm(a1, b, c, M, N, K, lda1, ldb, ldc, ta=0, tb=0, a2=None, lda2=1, k1=None,
             pair=None, bias=None, resid=None, mask=None, epilogue=0, accumulate=0, bf16=0):
        """egnn_node_gemm on the current stream (which a graph capture
        replaces); pair: (a1', b', c') of a second product in the launch."""
        a1b, bb, cb = pair or (None, None, None)
        cap = 0 if bf16 else split.numel()
        return lambda: lib.egnn_node_gemm(
            p(a1), p(a2), p(b), p(c), p(a1b), p(bb), p(cb), p(bias), p(resid), p(mask),
            None if bf16 else p(split), lda1, K if k1 is None else k1, lda2, ta, ldb, tb, ldc, N,
            M, N, K, epilogue, accumulate, accumulate, 0, bf16, cap,
            torch.cuda.current_stream().cuda_stream)

    cases = []

    def case(name, M, N, K, problems, nbytes, bf16, run, outs, refs, prep=None):
        cases.append(dict(name=name, M=M, N=N, K=K, problems=problems, nbytes=nbytes,
                          bf16=bf16, run=run, outs=outs, refs=refs, prep=prep))

    # The forward chains' products (rows Mr of the node MLP and the src
    # projection, Mc of the dst one): #1's at the QM9 recipe and GEOM's bf16
    # pads; #3/#4's (and #5's recompute) at GEOM's pads past 64, B=16, f32
    # and bf16; #6's (and #7's recompute) on the SP slab window N=184, S=92,
    # whose projections are two launches of their own M.
    chains = [("qm9", 1856, 1856, 0)] + [(f"geom N={n}", 100 * n, 100 * n, 1)
                                         for n in (32, 48, 64)]
    chains += [(f"#3/#4 N={n}", 16 * n, 16 * n, bf16) for n in (96, 136, 184) for bf16 in (0, 1)]
    chains += [("#6 N=184 S=92", 16 * 92, 16 * 184, bf16) for bf16 in (0, 1)]
    for label, Mr, Mc, bf16 in chains:
        label += " bf16" if bf16 and label[0] == "#" else ""
        hc = rnd(Mc, H)
        h = hc if Mr == Mc else rnd(Mr, H)
        agg, u = rnd(Mr, H), rnd(Mr, H)
        w1, wn1, wn2 = rnd(H, ld1) * 0.06, rnd(H, 2 * H) * 0.04, rnd(H, H) * 0.06
        b, mask = rnd(H), (torch.rand(Mr, generator=gen, device="cuda") > 0.3).float()
        cast = bf if bf16 else (lambda t: t.double())
        proj = torch.empty(Mc, 2 * H, device="cuda")
        refs = [cast(h) @ cast(w1[:, :H]).T, cast(hc) @ cast(w1[:, H:2 * H]).T]
        if Mr == Mc:
            case(f"{label} projection pair", Mr, H, H, 2, 4 * (Mr * H + 2 * H * H + 2 * Mr * H),
                 bf16, gemm(h, w1, proj, Mr, H, H, H, ld1, 2 * H, tb=1,
                            pair=(h, w1[:, H:], proj[:, H:]), bf16=bf16),
                 [proj], [torch.cat(refs, 1)])
        else:
            src = gemm(h, w1, proj, Mr, H, H, H, ld1, 2 * H, tb=1, bf16=bf16)
            dst = gemm(hc, w1[:, H:], proj[:, H:], Mc, H, H, H, ld1, 2 * H, tb=1, bf16=bf16)
            case(f"{label} projections (src M {Mr}, dst M {Mc})", Mr + Mc, H, H, 1,
                 4 * (2 * (Mr + Mc) * H + 2 * H * H), bf16,
                 lambda src=src, dst=dst: src() or dst(), [proj[:Mr, :H], proj[:, H:]], refs)
        z = torch.empty(Mr, H, device="cuda")
        ref = torch.cat([cast(h), cast(agg)], 1) @ cast(wn1).T + b.double()
        case(f"{label} [h, agg] Wn1 + silu", Mr, H, 2 * H, 1,
             4 * (2 * Mr * H + 2 * H * H + Mr * H), bf16,
             gemm(h, wn1, z, Mr, H, 2 * H, H, 2 * H, H, tb=1, a2=agg, lda2=H, k1=H, bias=b,
                  epilogue=1, bf16=bf16), [z], [ref * torch.sigmoid(ref)])
        out = torch.empty(Mr, H, device="cuda")
        ref = (h.double() + cast(u) @ cast(wn2).T + b.double()) * mask.double()[:, None]
        case(f"{label} u Wn2 + residual, mask", Mr, H, H, 1, 4 * (3 * Mr * H + H * H), bf16,
             gemm(u, wn2, out, Mr, H, H, H, H, H, tb=1, bias=b, resid=h, mask=mask, epilogue=2,
                  bf16=bf16), [out], [ref])
        if label != "qm9":
            continue
        dh0 = rnd(Mr, H)
        dh = dh0.clone()
        ref = dh0.double() + h.double() @ w1[:, :H].double()
        case(f"{label} dh += rowsum W1 (ld {ld1})", Mr, H, H, 1, 4 * (3 * Mr * H + H * H), 0,
             gemm(h, w1, dh, Mr, H, H, H, ld1, H, accumulate=1), [dh], [ref],
             prep=lambda dh=dh, dh0=dh0: dh.copy_(dh0))
    for label, rows in (("qm9", 1856), ("#5 pad 184", 32 * 184)):
        d, a, d2, a2 = rnd(rows, H), rnd(rows, H), rnd(rows, H), rnd(rows, H)
        g8 = torch.empty(H, H, device="cuda")
        case(f"{label} weight gradient d^T u (K {rows})", H, H, rows, 1,
             4 * (2 * rows * H + H * H), 0, gemm(d, a, g8, H, H, rows, H, H, H, ta=1), [g8],
             [d.double().T @ a.double()])
        gw1 = torch.zeros(H, ld1, device="cuda")
        case(f"{label} W1 gradient pair (K {rows})", H, H, rows, 2, 4 * (4 * rows * H + 2 * H * H),
             0, gemm(d, a, gw1, H, H, rows, H, H, ld1, ta=1, pair=(d2, a2, gw1[:, H:])),
             [gw1[:, :H], gw1[:, H:2 * H]], [d.double().T @ a.double(),
                                             d2.double().T @ a2.double()])

    rows_out = []
    for c in cases:
        flop = 2.0 * c["M"] * c["N"] * c["K"] * c["problems"]
        t_ops = (flop / _BF16_PEAK if c["bf16"] else _TF32_SPLITS * flop / _TF32_PEAK) * 1e3
        t_bytes = c["nbytes"] / _BW_PEAK * 1e3
        if c["prep"]:
            c["prep"]()
        rc = c["run"]()
        torch.cuda.synchronize()
        _check(rc == 0, f"phase 42: {c['name']}: launch failed ({rc})")
        err = max(float((o.double() - r).abs().max() / r.abs().max())
                  for o, r in zip(c["outs"], c["refs"]))
        _check(err <= 1e-4, f"phase 42: {c['name']}: the node GEMM is {err:.3g} of max|ref| off "
                            f"the float64 product")
        ms = sum(_graph_ms(c["run"], reps) for _ in range(2)) / 2
        row = {"case": c["name"], "M": c["M"], "N": c["N"], "K": c["K"],
               "problems": c["problems"], "ms": ms, "rel_err": err,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        print(f"phase 42: node GEMM {c['name']}: M={c['M']} N={c['N']} K={c['K']} x"
              f"{c['problems']}: {ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), rel err {err:.2e} on {card}", flush=True)
        rows_out.append(row)
    return rows_out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from geoldm_tpu_torch.ops import cuda_build

    t_start = time.time()
    faulthandler.dump_traceback_later(_STALL_SECONDS, exit=False)
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
    # The grids on the tensor-core tile (#1, #2, #3/#4's row grid in the
    # libraries of #3/#4, #5 and #6, #5/#7's backward row grid in those of #5
    # and #7) and the tensor-core GEMMs: registers and spills per
    # instantiation; none may spill, and each row library holds its row grids.
    for name in ("egnn_block", "egnn_block_bwd", "egnn_block_lowp", "egnn_block_bwd_lowp",
                 *_ROW_GRIDS, "fused_optim"):
        row_grids, gemms = [0, 0], set()
        for k in _ptxas_kernels(info["libs"][name]["log"]):
            if not k["name"]:
                continue
            row_grids[0] += k["name"].startswith("rows_tile_kernel")
            row_grids[1] += k["name"].startswith("rows_bwd_tile_kernel")
            if k["name"].startswith("node_gemm_tc_kernel<"):
                gemms.add(tuple(int(x) for x in re.findall(r"=(\d)", k["name"])))
            print(f"phase 1: {name}: {k['name']}: {k.get('registers')} registers, "
                  f"{k.get('spill_stores')} bytes spill stores, {k.get('spill_loads')} bytes "
                  f"spill loads", flush=True)
            _check(k.get("spill_stores") == 0 and k.get("spill_loads") == 0,
                   f"{name}: {k['name']} spills")
        _check(tuple(row_grids) == _ROW_GRIDS.get(name, (0, 0)),
               f"{name}: {row_grids} rows_tile_kernel / rows_bwd_tile_kernel instantiations "
               f"in ptxas' log, expected {_ROW_GRIDS.get(name, (0, 0))}")
        _check(gemms == _NODE_GEMMS.get(name, set()),
               f"{name}: node_gemm_tc_kernel instantiations (BF16, GRAD16) {sorted(gemms)} in "
               f"ptxas' log, expected {sorted(_NODE_GEMMS.get(name, set()))}")
    print(f"phase 1: built {len(info['libs'])} kernel libraries with nvcc (sm_90a, in parallel) "
          f"in {info['seconds']:.1f} s{' (cached)' if info.get('cached') else ''}", flush=True)
    phase_seconds, clock = {}, [t_start]

    def lap(phases):
        phase_seconds[phases] = round(time.time() - clock[0], 1)
        clock[0] = time.time()

    lap("1")
    rows = phase_kernel(card_name)
    lap("2")
    with tempfile.TemporaryDirectory() as tmpdir:
        launches, chunks, serve_stats, model = phase_serve(card_name, tmpdir)
    phase_denoiser(model, card_name)
    del model
    lap("3-5")
    bwd_rows = phase_backward(card_name)
    lap("6")
    # Phases 7 and 13 keep their runs for phases 18-20 to resume and score.
    qm9_run = tempfile.TemporaryDirectory()
    geom_run = tempfile.TemporaryDirectory()
    train = phase_train(card_name, qm9_run.name)
    lap("7")
    grad = phase_grad(card_name)
    lap("8")
    tiled_rows = phase_tiled(card_name)
    lap("9")
    with tempfile.TemporaryDirectory() as tmpdir:
        geom_launches, geom_stats, model = phase_geom_serve(card_name, tmpdir)
    geom_err = phase_geom_denoiser(model, card_name)
    del model
    lap("10-11")
    tiled_bwd_rows = phase_tiled_backward(card_name)
    lap("12")
    geom_train = phase_geom_train(card_name, geom_run.name)
    lap("13")
    geom_grad = phase_grad(card_name, geom=True)
    lap("14")
    sp_rows = phase_sp_kernels(card_name)
    lap("15")
    with tempfile.TemporaryDirectory() as tmpdir:
        sp_train = phase_sp_train(card_name, tmpdir)
    lap("16")
    sp_grad = phase_sp_grad(card_name)
    lap("17")
    # The new phases print their times beside the card's name and power limit.
    resume = phase_resume(card, qm9_run.name, geom_run.name)
    lap("18")
    evaluation = phase_eval(card, qm9_run.name)
    lap("19")
    geom_eval = phase_geom_eval(card, geom_run.name)
    lap("20")
    bf16_rows = phase_bf16_kernels(card)
    lap("21")
    bf16_serving, bf16_launches = phase_bf16_serve(card, qm9_run.name)
    lap("22")
    bf16_bwd_rows = phase_bf16_backward(card)
    lap("23")
    with tempfile.TemporaryDirectory() as tmpdir:
        bf16_train = phase_bf16_train(card, tmpdir)
    lap("24")
    with tempfile.TemporaryDirectory() as tmpdir:
        bf16_sp = phase_bf16_sp(card, tmpdir)
    lap("25")
    cond_rows = phase_cond_kernels(card)
    cond_grad = phase_grad(card, cond=True)
    with tempfile.TemporaryDirectory() as tmpdir:
        conditional = phase_conditional(card, tmpdir)
    lap("26")
    with tempfile.TemporaryDirectory() as tmpdir:
        dp_train = phase_dp_train(card, tmpdir)
    lap("27")
    with tempfile.TemporaryDirectory() as tmpdir:
        grid_train = phase_grid_train(card, tmpdir)
    lap("28")
    with tempfile.TemporaryDirectory() as tmpdir:
        cond_sp = phase_cond_sp(card, tmpdir)
    lap("29")
    dp_eval = phase_dp_eval(card, qm9_run.name)
    lap("30")
    with tempfile.TemporaryDirectory() as tmpdir:
        edm = phase_edm(card, tmpdir)
    lap("31")
    with tempfile.TemporaryDirectory() as tmpdir:
        learned = phase_learned(card, tmpdir)
    lap("32")
    with tempfile.TemporaryDirectory() as tmpdir:
        gnn = phase_gnn(card, tmpdir)
    lap("33")
    with tempfile.TemporaryDirectory() as tmpdir:
        serving = phase_serve_warmup(card, tmpdir)
    lap("34")
    bench = phase_bench_train(card)
    lap("35")
    with tempfile.TemporaryDirectory() as tmpdir:
        rendering = phase_render(card, tmpdir)
    lap("36")
    with tempfile.TemporaryDirectory() as tmpdir:
        geom_data = phase_geom_data(card, tmpdir)
    lap("37")
    lowp_rows = phase_lowp_kernels(card)
    with tempfile.TemporaryDirectory() as tmpdir:
        lowp_train = phase_lowp_train(card, tmpdir)
    lap("38")
    with tempfile.TemporaryDirectory() as tmpdir:
        qm9_prep = phase_qm9_prepare(card, tmpdir)
    lap("39")
    with tempfile.TemporaryDirectory() as tmpdir:
        tp = phase_tp(card, tmpdir, qm9_run.name)
    lap("40")
    fused_optim_row = phase_fused_optim(card)
    lap("41")
    node_gemm_rows = phase_node_gemm(card)
    lap("42")
    qm9_run.cleanup()
    geom_run.cleanup()
    print(f"phase seconds: {json.dumps(phase_seconds)} on {card}", flush=True)

    main_row = next(r for r in rows if r["case"] == "sum" and r["N"] == 32)
    bwd_row = next(r for r in bwd_rows if r["case"] == "sum" and r["N"] == 29)
    print("details: " + json.dumps({
        "shapes": rows, "serving": serve_stats, "chunks": chunks, "backward": bwd_rows,
        "training": train, "grad": grad, "tiled": tiled_rows, "geom_serving": geom_stats,
        "geom_denoiser_max_abs_err": geom_err, "tiled_backward": tiled_bwd_rows,
        "geom_training": geom_train, "geom_grad": geom_grad, "sp_kernels": sp_rows,
        "sp_training": sp_train, "sp_grad": sp_grad, "resume": resume,
        "evaluation": evaluation, "geom_evaluation": geom_eval, "bf16_kernels": bf16_rows,
        "bf16_serving": bf16_serving, "bf16_backward": bf16_bwd_rows,
        "bf16_training": bf16_train, "bf16_sp": bf16_sp, "conditional_kernels": cond_rows,
        "conditional_grad": cond_grad, "conditional": conditional, "dp_training": dp_train,
        "grid_training": grid_train, "conditional_sp": cond_sp, "dp_eval": dp_eval,
        "edm": edm, "learned": learned, "gnn": gnn, "serve_warmup": serving,
        "bench_train": bench, "rendering": rendering, "geom_data": geom_data,
        "lowp_kernels": lowp_rows, "lowp_training": lowp_train, "qm9_prepare": qm9_prep,
        "tp": tp, "fused_optim": fused_optim_row, "node_gemm": node_gemm_rows,
        "phase_seconds": phase_seconds,
        "fwd_launches": {"serving": launches, "training": train["fwd_launches"],
                         "geom_serving": geom_launches},
        "seconds": time.time() - t_start}), flush=True)

    # Launches on the main paths: each path's own counts, read just after it
    # (phases 4, 7, 10, 13 and 16, the resumed, first-stage and evaluation
    # runs of phases 18-20, phase 26's conditional training, guided scoring
    # and serving, the ranks of phases 27-30's CLI runs, phases 31-33's
    # variants, phases 34-37: the servers' warm-ups and requests,
    # bench_train, the rendering paths and the GEOM data step, phase 39's
    # QM9 run on prepared splits, and the ranks of phase 40's --tp runs).
    geom_train_launches = geom_train["launches"]
    later = [resume["qm9_resume"]["launches"], resume["ae_path"]["vae_launches"],
             resume["ae_path"]["ldm_launches"], resume["geom_resume"]["launches"],
             evaluation["launches"], geom_eval["launches"], bf16_launches,
             conditional["train"]["launches"], conditional["eval"]["launches"],
             conditional["serve"]["launches"], dp_train["launches"], grid_train["launches"],
             cond_sp["launches"], dp_eval["launches"], edm["launches"], learned["launches"],
             gnn["launches"], serving["launches"], bench["launches"], rendering["launches"],
             geom_data["launches"], qm9_prep["launches"], tp["launches"],
             tp["resume_to_tp1"]["launches"], tp["geom"]["launches"]]

    def later_launches(kernel):
        return sum(counts[kernel] for counts in later)

    def tiled_entry(rows_, stage, name, source, line, launches_):
        main = next(r for r in rows_ if r["stage"] == stage and r["case"] == "sum"
                    and r["N"] == 184)
        return {"name": name, "route": "cuda", "source": f"geoldm_tpu_torch/csrc/{source}",
                "replaces": f"geoldm_tpu/ops/pallas_egnn_tiled.py:{line}",
                "launches": launches_,
                "max_abs_err": max(r["max_abs_err"] for r in rows_ if r["stage"] == stage),
                "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None,
                **({"bound_tc_ms": main["bound_tc_ms"]} if "bound_tc_ms" in main else {})}

    def sp_entry(direction, line):
        # One block's stages (a GCL and the coordinate update) on the second
        # slab of N=184 over 2 ranks; launches summed over phase 16's ranks.
        main = [r for r in sp_rows if r["dir"] == direction and r["case"] == "sum"
                and r["N"] == 184 and r["row0"] == r["S"]]
        suffix = "" if direction == "fwd" else "_bwd"
        # The conditional recipe's H=192 (phase 29 (a)): a block's two stages
        # on the second slab of N=30 over 2 ranks, as above.
        h192_all = [r for r in cond_sp["kernel_rows"] if r["dir"] == direction]
        h192 = [r for r in h192_all if r["row0"] == r["S"]]
        return {"name": f"egnn_sp_{direction}", "route": "cuda",
                "source": "geoldm_tpu_torch/csrc/egnn_sp.cu",
                "replaces": f"geoldm_tpu/ops/pallas_egnn_sp.py:{line}",
                "launches": sum(sp_train["launches"][f"sp_{stage}{suffix}"]
                                + later_launches(f"sp_{stage}{suffix}")
                                for stage in ("gcl_rows", "coord_rows")),
                "max_abs_err": max(r["max_abs_err"] for r in sp_rows + h192_all
                                   if r["dir"] == direction),
                "h192": {"N": 30, "S": 15, "B": h192[0]["B"],
                         **{k: sum(r[k] for r in h192)
                            for k in ("ms", "plain_ms", "bound_ms", "bound_tc_ms")}},
                "ms": sum(r["ms"] for r in main), "plain_ms": sum(r["plain_ms"] for r in main),
                "bound_ms": sum(r["bound_ms"] for r in main),
                "bound_by": ("operations" if all(r["bound_by"] == "operations" for r in main)
                             else "bytes"), "library_ms": None,
                "bound_tc_ms": sum(r["bound_tc_ms"] for r in main)}

    # The bf16 main paths: serving at bfloat16_mixed (phase 22) and bf16
    # training (phase 24: QM9 and GEOM through the CLIs); SP bf16 training
    # (phase 25's ranks).
    bf16_paths = [bf16_launches, bf16_train["qm9"]["launches"], bf16_train["geom"]["launches"],
                  bf16_sp["cli"]["launches"], edm["launches"], learned["launches"],
                  serving["launches"], bench["launches"], lowp_train["bfloat16"]["launches"]]

    def bf16_entry(kernel, name, source, replaces):
        # The bf16 forward variants at the main paths' widest shapes (QM9
        # N=32, B=64; N=184, B=16).
        mine = [r for r in bf16_rows if r["kernel"] == kernel]
        main = next(r for r in mine if r["N"] == (32 if kernel == "egnn_block" else 184))
        n_launched = sum(counts[f"{kernel}_bf16"] for counts in bf16_paths)
        _check(n_launched > 0, f"{name} was not launched on phases 22 and 24's paths")
        return {"name": name, "route": "cuda", "source": f"geoldm_tpu_torch/csrc/{source}",
                "replaces": f"geoldm_tpu/ops/{replaces}", "launches": n_launched,
                "max_abs_err": max(r["max_abs_err"] for r in mine), "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None, "f32_ms": main["f32_ms"]}

    def bf16_bwd_entry(kernel, name, source, replaces, launches_, n):
        # The bf16 backward variants at the training recipes' shapes (#2 at QM9
        # N=29, B=64; #5 at N=184, B=32), launched on phase 24's main paths.
        mine = [r for r in bf16_bwd_rows if r["kernel"] == kernel]
        main = next(r for r in mine if r["N"] == n)
        _check(launches_ > 0, f"{name} was not launched on phase 24's paths")
        return {"name": name, "route": "cuda", "source": f"geoldm_tpu_torch/csrc/{source}",
                "replaces": f"geoldm_tpu/ops/{replaces}", "launches": launches_,
                "max_abs_err": max(r["max_abs_err"] for r in mine), "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None, "f32_ms": main["f32_ms"]}

    def bf16_sp_entry(direction, line):
        # As sp_entry: a block's two stages on the second slab of N=184 over 2
        # ranks; launches summed over the ranks of phase 25's CLI run.
        kname = f"egnn_sp_{direction}"
        main = [r for r in bf16_bwd_rows if r["kernel"] == kname and r["N"] == 184
                and r["row0"] == r["S"]]
        suffix = "_bf16" if direction == "fwd" else "_bwd_bf16"
        n_launched = sum(bf16_sp["cli"]["launches"][f"sp_{stage}{suffix}"]
                         for stage in ("gcl_rows", "coord_rows"))
        _check(n_launched > 0, f"{kname}_bf16 was not launched in phase 25's CLI run")
        return {"name": f"{kname}_bf16", "route": "cuda",
                "source": "geoldm_tpu_torch/csrc/egnn_sp.cu",
                "replaces": f"geoldm_tpu/ops/pallas_egnn_sp.py:{line}", "launches": n_launched,
                "max_abs_err": max(r["max_abs_err"] for r in bf16_bwd_rows
                                   if r["kernel"] == kname),
                "ms": sum(r["ms"] for r in main), "plain_ms": sum(r["plain_ms"] for r in main),
                "bound_ms": sum(r["bound_ms"] for r in main),
                "bound_by": ("operations" if all(r["bound_by"] == "operations" for r in main)
                             else "bytes"), "library_ms": None,
                "f32_ms": sum(r["f32_ms"] for r in main)}

    train_paths = [bf16_train["qm9"]["launches"], bf16_train["geom"]["launches"],
                   bench["launches"], lowp_train["bfloat16"]["launches"]]

    def lowp_entry(kernel, name, source, line, n):
        # The low-precision variants of #1/#2 at QM9's pads (#1 at N=32, #2 at
        # N=29, B=64, H=256, the bf16 variants' shapes), launched on phase 38
        # (c)'s bfloat16_pallas run; H=192 at N=29 rides along.
        mine = [r for r in lowp_rows if r["kernel"] == kernel]
        main = next(r for r in mine if r["N"] == n and r["H"] == 256)
        at192 = next(r for r in mine if r["H"] == 192)
        n_launched = lowp_train["bfloat16_pallas"]["launches"][kernel]
        _check(n_launched > 0, f"{name} was not launched on phase 38 (c)'s path")
        return {"name": name, "route": "cuda", "source": f"geoldm_tpu_torch/csrc/{source}",
                "replaces": f"geoldm_tpu/ops/pallas_egnn.py:{line}", "launches": n_launched,
                "max_abs_err": max(r["max_abs_err"] for r in mine), "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None, "bf16_ms": main["bf16_ms"],
                "h192": {k: at192[k] for k in ("N", "B", "ms", "bf16_ms", "plain_ms",
                                               "bound_ms", "bound_by")}}
    report = {"kernels": [{
        "name": "egnn_block_fwd", "route": "cuda",
        "source": "geoldm_tpu_torch/csrc/egnn_block.cu",
        "replaces": "geoldm_tpu/ops/pallas_egnn.py:232",
        "launches": (launches + train["fwd_launches"] + geom_launches["egnn_block"]
                     + geom_train_launches["egnn_block"] + later_launches("egnn_block")),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "bound_tc_ms": main_row["bound_tc_ms"], "library_ms": None,
    }, {
        "name": "egnn_block_bwd", "route": "cuda",
        "source": "geoldm_tpu_torch/csrc/egnn_block_bwd.cu",
        "replaces": "geoldm_tpu/ops/pallas_egnn.py:255",
        "launches": (train["bwd_launches"] + geom_train_launches["egnn_block_bwd"]
                     + later_launches("egnn_block_bwd")),
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        "ms": bwd_row["ms"], "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"], "bound_by": bwd_row["bound_by"],
        "bound_tc_ms": bwd_row["bound_tc_ms"], "library_ms": None,
    }] + [tiled_entry(tiled_rows, stage, f"egnn_{stage}", "egnn_tiled.cu", line,
                      geom_launches[stage] + geom_train_launches[stage] + later_launches(stage))
           for stage, line in (("gcl_rows", 152), ("coord_rows", 166))]
        + [tiled_entry(tiled_bwd_rows, stage, f"egnn_{stage}_bwd", "egnn_tiled_bwd.cu", 201,
                       geom_train_launches[f"{stage}_bwd"] + later_launches(f"{stage}_bwd"))
           for stage in ("gcl_rows", "coord_rows")]
        + [sp_entry(direction, line) for direction, line in (("fwd", 144), ("bwd", 158))]
        + [bf16_entry(kernel, name, source, replaces)
           for kernel, name, source, replaces in (
               ("egnn_block", "egnn_block_fwd_bf16", "egnn_block.cu", "pallas_egnn.py:232"),
               ("gcl_rows", "egnn_gcl_rows_bf16", "egnn_tiled.cu", "pallas_egnn_tiled.py:152"),
               ("coord_rows", "egnn_coord_rows_bf16", "egnn_tiled.cu",
                "pallas_egnn_tiled.py:166"))]
        + [bf16_bwd_entry(kernel, name, source, replaces,
                          sum(counts[counter] for counts in train_paths), n)
           for kernel, name, source, replaces, counter, n in (
               ("egnn_block_bwd", "egnn_block_bwd_bf16", "egnn_block_bwd.cu",
                "pallas_egnn.py:255", "egnn_block_bwd_bf16", 29),
               ("gcl_rows_bwd", "egnn_gcl_rows_bwd_bf16", "egnn_tiled_bwd.cu",
                "pallas_egnn_tiled.py:201", "gcl_rows_bwd_bf16", 184),
               ("coord_rows_bwd", "egnn_coord_rows_bwd_bf16", "egnn_tiled_bwd.cu",
                "pallas_egnn_tiled.py:201", "coord_rows_bwd_bf16", 184))]
        + [bf16_sp_entry(direction, line) for direction, line in (("fwd", 144), ("bwd", 158))]
        + [lowp_entry("egnn_block_lowp", "egnn_block_fwd_lowp", "egnn_block_lowp.cu", 232, 32),
           lowp_entry("egnn_block_bwd_lowp", "egnn_block_bwd_lowp", "egnn_block_bwd_lowp.cu", 255,
                      29)]}
    # #1/#2 and their bf16 variants at the conditional recipe's H=192 (phase
    # 26 (a)): their errors count in max_abs_err, and N=29's times ride along.
    h192 = {"egnn_block_fwd": "egnn_block", "egnn_block_bwd": "egnn_block_bwd",
            "egnn_block_fwd_bf16": "egnn_block_bf16", "egnn_block_bwd_bf16": "egnn_block_bwd_bf16"}
    for entry in report["kernels"]:
        mine = [r for r in cond_rows if r["kernel"] == h192.get(entry["name"])]
        if mine:
            entry["max_abs_err"] = max([entry["max_abs_err"]] + [r["max_abs_err"] for r in mine])
            at29 = next(r for r in mine if r["N"] == 29)
            entry["h192"] = {k: at29[k] for k in ("N", "B", "ms", "plain_ms", "bound_ms",
                                                   "bound_by", "bound_tc_ms") if k in at29}
    # The fused optimizer step's kernels: launches on the training paths
    # above (one of each a step, checked on each path), errors and times
    # from phase 41 at the QM9 recipe's parameter list.
    for i, (kernel, line) in enumerate((("norm_kernel", 28), ("threshold_kernel", 28),
                                        ("update_kernel", 69))):
        n_launched = sum(counts[i] for _, counts in _FUSED_PATHS)
        _check(n_launched > 0, f"{kernel} was not launched on a training path")
        report["kernels"].append({
            "name": f"fused_optim_{kernel}", "route": "cuda",
            "source": "geoldm_tpu_torch/csrc/fused_optim.cu",
            "replaces": f"geoldm_tpu/train/optim.py:{line}", "launches": n_launched,
            "paths": len(_FUSED_PATHS), "max_abs_err": fused_optim_row["max_abs_err"],
            "ms": fused_optim_row["kernel_ms"][kernel], "plain_ms": None,
            "bound_ms": fused_optim_row["bound_ms"][kernel], "bound_by": "bytes",
            "library_ms": None})
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
