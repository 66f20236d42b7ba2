"""Bulk-sampling traffic: a closed loop of back-to-back calls of the
program's ``train/sampling.py:sample_bucketed`` (the path ``eval_analyze``
and the training loop's stability samples take), each generating a set of
molecules in size-bucketed chunks.

Every call's sizes are the histogram's quantiles (the same set each call,
in a new order) and its noise seed is fresh. Set-up runs one call of the
same sizes with the warm-up's few steps, which makes every chunk shape of
the window once. The window runs calls until ``--seconds`` have passed
(the last call runs to its end) and is judged over the calls' whole time.
The states of the window's first call are recorded where the model takes
them (``harness.record``), for the check to follow (``reference.sample``).

Workload keys: config, chips, precision, molecules_per_call, batch_size,
n_steps, eta, warmup_steps, check (limits), check_molecules.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from harness import check as C
from harness import data as D
from harness import faults, flops
from harness import model as HM
from harness import trace as TR
from harness.core import Outcome, device_record
from harness.record import Recorder
from harness.spec import RunSpec
from reference import model as R
from reference import sample as RS


CHECKED = 0  # the call whose molecules the check follows: the window's first
WARMUP = 10**6  # the warm-up call's index (its own stream of sizes and noise)


def run(spec: RunSpec) -> Outcome:
    with faults.planted(spec.fault):
        return _run(spec)


def _run(spec: RunSpec) -> Outcome:
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.train import sampling
    from geoldm_tpu_torch.utils.buckets import covering_buckets

    wl, cfg = spec.workload, spec.config
    device = torch.device(spec.device)
    info = get_dataset_info(cfg["dataset"])
    M = R.describe(cfg)
    sd = HM.weights(cfg, D.sub_seed(spec.seed, D.WEIGHTS), device)
    model = HM.program_model(cfg, sd, device)
    sd0 = {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}
    del sd
    buckets = covering_buckets(sampling.default_buckets(info), info["max_n_nodes"])
    base = D.quantile_sizes(cfg, wl["molecules_per_call"])

    recorder = Recorder(model)

    def call(k: int, n_steps: int):
        sizes = D.rng(spec.seed, D.TRAFFIC, k).permutation(base)
        seed = D.sub_seed(spec.seed, D.SAMPLE, k)
        if k == CHECKED:
            recorder.start()
        with torch.profiler.record_function("bench.sample_call"):
            one_hot, _, x, _ = sampling.sample_bucketed(
                model, seed, info, sizes, batch_size=wl["batch_size"], buckets=buckets,
                n_steps=n_steps, eta=wl["eta"], compute_dtype=wl["precision"])
        return sizes, seed, one_hot, x, recorder.stop() if k == CHECKED else None

    call(WARMUP, wl["warmup_steps"])  # every chunk shape of the window, once
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    calls, stretch, untraced_s = [], None, 0.0
    t0 = time.time()
    while time.time() - t0 < spec.seconds or (spec.trace and stretch is None):
        k = len(calls)
        traced = spec.trace and stretch is None and (
            k >= 1 or time.time() - t0 >= 0.3 * spec.seconds)
        tr = TR.Stretch(device) if traced else None
        if tr:
            tr.start()
        started = time.time()
        calls.append(call(k, wl["n_steps"]))
        if tr:
            stretch = {"summary": tr.stop(), "call": k}
        else:
            untraced_s += time.time() - started
    t1 = time.time()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    out = Outcome()
    n_mol = sum(len(c[0]) for c in calls)
    out.attempted = len(calls)
    out.e2e = {"sample_mol_per_s": n_mol / (t1 - t0), "setup_s": t0 - spec.start_wall,
               "peak_mem_gib": peak / 2**30}
    out.device = device_record(spec.chips, peak, name)
    if stretch is not None:
        s = stretch["summary"]
        out.device["busy_s"], out.device["window_s"] = s["busy_s"], s["window_s"]
        out.breakdown = TR.breakdown(s)
        sizes = calls[stretch["call"]][0]
        out.ctx = sample_ctx(M, wl, s, sizes, buckets)
        # The untraced calls (each of the same sizes) for mfu.sample.
        out.ctx["useful_flops"] *= len(calls) - 1
        out.ctx["untraced_s"] = untraced_s
        if untraced_s > 0:
            print(f"calls/s: traced {1.0 / s['window_s']:.4g}, untraced "
                  f"{(len(calls) - 1) / untraced_s:.4g}", file=sys.stderr)

    # The check: the program's state freed, then the reference on a sample
    # of the molecules the window returned, the largest among them.
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out.checks, out.numbers, out.detail = _check(spec, M, sd0, calls, CHECKED, buckets, device)
    return out


def sample_ctx(M, wl, summary, sizes, buckets) -> dict:
    """What the per-layer readers of a sampling cell read: the stretch's
    trace, the molecules it generated (true sizes), their useful FLOPs and
    the EGNN work's least time, chunk by chunk."""
    pk = flops.peak(wl["precision"])
    k = wl["n_steps"]
    useful = sum(flops.sample_flops(M, int(n), k) for n in sizes)
    least = 0.0
    for _, _, chunk, _ in RS.plan(sizes, wl["batch_size"], buckets):
        real = [int(sizes[i]) for i in chunk]
        least += (k + 1) * flops.least_seconds(M["dynamics"], real, pk)
        least += flops.least_seconds(M["decoder"], real, pk)
    return {"kind": "sample", "trace": summary, "molecules": len(sizes),
            "useful_flops": useful, "peak_flops": pk, "least_s": least, "chips": 1}


def pick(rng: np.random.Generator, sizes: np.ndarray, count: int) -> list:
    """Molecule indices of a call to check: its largest, then ``count``-1
    more drawn at random."""
    big = int(np.argmax(sizes))
    rest = [int(i) for i in rng.permutation(len(sizes)) if int(i) != big]
    return [big] + rest[:count - 1]


def follow_chunks(P, M, seed, sizes, buckets, chunks, wanted, x_served, types_served,
                  control: bool, wl: dict, batch_size: int, detail: dict) -> None:
    """Add to ``detail`` (``check.sample_detail``) the check's terms for the
    ``wanted`` molecules of one call (or dispatch) of ``sizes``: the
    reference follows each of their chunks' recorded states (``chunks``, in
    dispatch order) and the decoder's recorded input and output;
    ``x_served`` / ``types_served`` map a molecule index to what was served.
    With ``control`` the reference's own run, each stage a precision below
    the program's (``reference.sample.BELOW``), stands in the program's
    place."""
    jumps, final, dec = detail["stages"]
    for (ci, pad, chunk, padded), rec in zip(RS.plan(sizes, batch_size, buckets), chunks):
        rows = [r for r, i in enumerate(chunk) if int(i) in wanted]
        if not rows:
            continue
        if control:
            own = RS.trajectory(P, M, seed, ci, padded, pad, rows, wl["n_steps"], wl["eta"],
                                [RS.BELOW[p] for p in jumps], RS.BELOW[final], RS.BELOW[dec])
            states, dec_in, dec_out = own["z"], own["dec_in"], (own["x"], own["h"])
        else:
            idx = torch.as_tensor(rows, device=rec["dec_in"].device)
            states = [z[idx].float() for z in rec["z"]]
            dec_in = rec["dec_in"][idx].float()
            dec_out = tuple(t[idx].float() for t in rec["dec_out"])
        ref = RS.teacher(P, M, seed, ci, padded, pad, rows, wl["n_steps"], wl["eta"], states,
                         dec_in, dec_out, detail["stages"])
        for key in ("num", "unit", "dec_num", "dec_unit"):
            detail[key].append(ref[key].cpu())
        detail["dropped"] += ref["dropped"]
        detail["stages_all"] += ref["stages"]
        for j, r in enumerate(rows):
            i = int(chunk[r])
            n = int(sizes[i])
            x_dec, t_dec = dec_out[0][j], dec_out[1][j, :, :M["n_classes"]].argmax(-1)
            xs, ts = ((x_dec, t_dec) if control else (x_served(i, pad), types_served(i, pad)))
            detail["served"].append(C.served_gap(xs[:n], x_dec[:n], ts[:n], t_dec[:n]))


def _check(spec: RunSpec, M, sd0, calls, checked, buckets, device):
    wl = spec.workload
    P = {k: v.to(device) for k, v in sd0.items()}
    sizes, seed, one_hot, x, chunks = calls[checked]
    wanted = set(pick(D.rng(spec.seed, D.SAMPLE, 10**6), sizes, wl["check_molecules"]))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    detail = C.sample_detail(RS.stage_precisions(wl["precision"], wl["n_steps"]))
    try:
        follow_chunks(
            P, M, seed, sizes, buckets, chunks, wanted,
            lambda i, pad: torch.as_tensor(x[i, :pad], device=device),
            lambda i, pad: torch.as_tensor(one_hot[i, :pad], device=device).argmax(-1),
            spec.fault == "control", wl, wl["batch_size"], detail)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    numbers = C.sample_numbers(detail)
    return C.checks(numbers, spec.limits), numbers, detail
