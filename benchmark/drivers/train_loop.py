"""Training traffic: the program's epoch loop (``train/trainer.py:train_epoch``,
with its prefetch thread) over its own loader (``QM9Loader``) on a synthetic
split, as the QM9 training CLI runs it on one chip.

One train state is built from the seed's weights and handed through:
three steps through ``train_epoch`` on the loader's first batches (the
check follows them), then the window: ``train_epoch`` over the loader
until ``--seconds`` have passed. The loader is wrapped in a feed that stops
yielding at the window's end, so the window ends with ``train_epoch``'s
return, final loss read-back included.

Workload keys: config, chips, precision (the compute dtype), batch_size,
pad, split_size, prefetch, log_every, ref_block_edges, check.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from harness import check as C
from harness import data as D
from harness import faults, flops
from harness import model as HM
from harness import trace as TR
from harness.core import Outcome, device_record
from harness.spec import RunSpec
from reference import model as R
from reference import train as RT

CHECK_STEPS = 3
BETA1 = 0.9


class Feed:
    """The loader behind one iterator for the whole run, so the check's
    steps and the window see the rows of one shuffled pass each once.
    ``take(n)`` lets the next epoch yield n batches; ``until(deadline)``
    until the deadline passes. Records the raw batches it is asked to, and
    when each batch was taken."""

    def __init__(self, loader):
        self.loader = loader
        self.it = iter(loader)
        self.count = 0
        self.stop_at: Optional[int] = None
        self.deadline: Optional[float] = None
        self.record = False
        self.recorded: List[dict] = []
        self.sizes: List[np.ndarray] = []
        self.taken: List[float] = []

    def __len__(self):
        return len(self.loader)

    def take(self, n: int, record: bool = False):
        self.stop_at, self.deadline, self.record = self.count + n, None, record
        return self

    def until(self, deadline: float):
        self.stop_at, self.deadline, self.record = None, deadline, False
        return self

    def _stop(self) -> bool:
        if self.stop_at is None and self.deadline is not None and time.time() >= self.deadline:
            self.stop_at = self.count
        return self.stop_at is not None and self.count >= self.stop_at

    def __iter__(self):
        while not self._stop():
            try:
                raw = next(self.it)
            except StopIteration:  # a split shorter than the run: the next pass
                self.it = iter(self.loader)
                raw = next(self.it)
            self.count += 1
            self.taken.append(time.time())
            self.sizes.append(np.asarray(raw["n_atoms"]).copy())
            if self.record:
                self.recorded.append({k: np.array(v) for k, v in raw.items()
                                      if k in ("x", "h_cat", "h_int", "node_mask", "n_atoms")})
            yield raw


def run(spec: RunSpec):
    """One run -> its Outcome; with ``spec.extra["seeds"]`` one run a seed in
    the same process -> a list of Outcomes."""
    with faults.planted(spec.fault):
        seeds = (spec.extra or {}).get("seeds")
        if not seeds:
            return _run(spec)
        return [_run(dataclasses.replace(spec, seed=seed, extra=None)) for seed in seeds]


def _loader(spec: RunSpec, seed: int):
    wl, cfg = spec.workload, spec.config
    from geoldm_tpu_torch.data.qm9 import QM9Loader

    split = D.qm9_split(cfg, wl["split_size"], seed)
    loader = QM9Loader(split, batch_size=wl["batch_size"], pad_nodes=wl["pad"], shuffle=True,
                       include_charges=cfg["include_charges"], seed=D.sub_seed(seed, D.LOADER))
    return loader, split


def _run(spec: RunSpec) -> Outcome:
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train import train_step as ts
    from geoldm_tpu_torch.train import trainer

    wl, cfg = spec.workload, spec.config
    device = torch.device(spec.device)
    info = get_dataset_info(cfg["dataset"])
    M = R.describe(cfg)

    sd = HM.weights(cfg, D.sub_seed(spec.seed, D.WEIGHTS), device)
    model = HM.program_model(cfg, sd, device)
    sd0 = {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}
    del sd
    model_cfg = HM.program_config(cfg)
    state = ts.create_train_state(model, model_cfg, cfg["lr"], clip_grad=cfg["clip_grad"],
                                  ema_decay=cfg["ema_decay"])
    train_step = ts.make_train_step(model_cfg, cfg["ema_decay"], wl["precision"])
    loader, split = _loader(spec, spec.seed)
    nodes_dist = DistributionNodes(info.n_nodes)
    noise_seed = D.sub_seed(spec.seed, D.NOISE)
    noise = torch.Generator(device=device).manual_seed(noise_seed)
    feed = Feed(loader)
    rng = np.random.default_rng(0)  # host draws: none in these recipes (no augmentation)

    def epoch(it, step_fn=train_step, tag=0):
        losses, _ = trainer.train_epoch(state, step_fn, it, nodes_dist, noise, tag, rng=rng,
                                        prefetch=wl["prefetch"],
                                        log_every=wl["log_every"])
        return losses

    # The check's steps: the program from the seed's state, through the
    # window's own call and feed, on the first rows of the shuffled pass.
    named = list(state.model.named_parameters())
    losses = epoch(feed.take(1, record=True))
    grad1 = {}
    for name, p in named:
        st = state.optimizer.state.get(p)
        if st and "exp_avg" in st:
            grad1[name] = float(st["exp_avg"].double().norm()) / (1.0 - BETA1)
    losses += epoch(feed.take(CHECK_STEPS - 1, record=True))
    ema_params = dict(state.ema_model.named_parameters())
    clip_norms = [float(v) for v in state.clip.norms[:state.clip.count]]
    prog = {"losses": losses, "grad1": grad1, "clip_norms": clip_norms,
            "change": {n: float((p.detach() - sd0[n].to(device)).double().norm())
                       for n, p in named},
            "ema_change": {n: float((ema_params[n].detach() - sd0[n].to(device)).double().norm())
                           for n, _ in named}}
    check_batches = list(feed.recorded)  # the one pad is warm from these steps

    # The window.
    stretch = {}
    step_fn = train_step
    if spec.trace:
        step_fn = _traced(train_step, device, spec.seconds, stretch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    first = feed.count
    t0 = time.time()
    with torch.profiler.record_function("bench.window"):
        win = epoch(feed.until(t0 + spec.seconds), step_fn, tag=1)
    t1 = time.time()
    steps = len(win)
    sizes = feed.sizes[first:first + steps]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out = Outcome()
    batch = wl["batch_size"]
    out.attempted = steps
    out.failed = int(sum(1 for v in win if not np.isfinite(v)))
    out.e2e = {"train_mol_per_s": steps * batch / (t1 - t0), "setup_s": t0 - spec.start_wall,
               "peak_mem_gib": peak / 2**30}
    out.device = device_record(spec.chips, peak, name)
    _print_segments(feed.taken[first:first + steps], t0, t1, batch)
    if spec.trace and stretch.get("summary") is not None:
        s = stretch["summary"]
        out.device["busy_s"], out.device["window_s"] = s["busy_s"], s["window_s"]
        out.breakdown = TR.breakdown(s)
        out.ctx = _train_ctx(M, wl, s, sizes, stretch, t0, t1)

    # The check, after the window: the program's state freed, the reference
    # run in blocks on this card.
    del state, model, train_step, ema_params, named
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_batches = [_ref_batch(cfg, wl, b, split, device) for b in check_batches]
    out.checks, out.numbers, out.detail = _check(spec, M, sd0, ref_batches, noise_seed,
                                                 device, prog)
    return out


def _traced(step, device, seconds: float, stretch: dict):
    """The train step with the profiler started before the first step past
    30 % of the window and stopped after the first step past 70 %; records
    the stretch's first and last step (counted from the window's first) and
    the host times it started and stopped."""
    tr = TR.Stretch(device)
    clock = {"t0": None, "k": 0}

    def wrapped(state, batch, noise, keep=None):
        now = time.time()
        if clock["t0"] is None:
            clock["t0"] = now
        if "first" not in stretch and now - clock["t0"] >= 0.3 * seconds:
            stretch["first"], stretch["t_first"] = clock["k"], now
            tr.start()
        with torch.profiler.record_function("bench.train_step"):
            out = step(state, batch, noise, keep)
        clock["k"] += 1
        if "first" in stretch and "summary" not in stretch \
                and time.time() - clock["t0"] >= 0.7 * seconds:
            stretch["summary"] = tr.stop()
            stretch["last"], stretch["t_last"] = clock["k"], time.time()
        return out

    return wrapped


def _print_segments(taken: List[float], t0: float, t1: float, batch: int, parts: int = 5):
    """The window's rate in ``parts`` equal stretches of time (by when each
    step's batch was taken), on standard error: a rate that moves within a
    run, against one that differs from run to run."""
    edges = [t0 + (t1 - t0) * i / parts for i in range(parts + 1)]
    counts = [sum(1 for t in taken if lo <= t < hi) for lo, hi in zip(edges, edges[1:])]
    rates = [round(c * batch / ((t1 - t0) / parts), 1) for c in counts]
    print(f"window stretches (mol/s): {rates}", file=sys.stderr)


def _train_ctx(M, wl, summary: dict, sizes: List[np.ndarray], stretch: dict, t0: float,
               t1: float) -> dict:
    """What the per-layer readers of a train cell read: the stretch's trace
    summary and the EGNN work's least time over its steps (true sizes);
    the useful FLOPs of the window's untraced steps and their host seconds
    (the profiler slows the traced ones)."""
    pk = flops.peak(wl["precision"])
    work = sizes[stretch["first"]:stretch["last"]]
    least = 0.0
    for b in work:
        own = [int(n) for n in b]
        least += flops.least_seconds(M["encoder"], own, pk)
        least += flops.least_seconds(M["dynamics"], own, pk, backward=True)
        least += flops.least_seconds(M["decoder"], own, pk, backward=True)
    untraced = list(sizes[:stretch["first"]]) + list(sizes[stretch["last"]:])
    useful = sum(flops.useful_train_flops(M, int(n)) for b in untraced for n in b)
    untraced_s = (stretch["t_first"] - t0) + (t1 - stretch["t_last"])
    traced_rate = len(work) / summary["window_s"]
    print(f"steps/s: traced stretch {traced_rate:.4g}, untraced "
          f"{len(untraced) / untraced_s:.4g}", file=sys.stderr)
    return {"kind": "train", "trace": summary, "steps": len(work), "chips": 1,
            "useful_flops": useful, "untraced_s": untraced_s, "peak_flops": pk,
            "least_s": least}


def _ref_batch(cfg, wl, raw: dict, split, device) -> dict:
    """A check batch as the reference takes it: the molecules the loader
    put in it, found in the benchmark's own split and centred again."""
    n_atoms = np.asarray(raw["n_atoms"])
    pad = raw["x"].shape[1]
    pos, n_split = split["positions"], split["num_atoms"]
    d01 = pos[:, 1] - pos[:, 0]
    idx = C.match_rows(d01, n_split, raw["x"], n_atoms)
    x = np.stack([C.centred(pos[i], int(n), pad) for i, n in zip(idx, n_atoms)])
    h_cat = split["one_hot"][idx][:, :pad]
    h_int = split["charges"][idx][:, :pad, None]
    if (idx < 0).any():
        raise RuntimeError(f"{int((idx < 0).sum())} rows of a check batch are no molecule of "
                           "the split")
    mask = (np.arange(pad)[None, :] < n_atoms[:, None]).astype(np.float32)[..., None]
    if np.abs(x - raw["x"]).max() > 1e-4:
        raise RuntimeError("a check batch's coordinates differ from the split's molecules")
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32), device=device)  # noqa
    return {"x": t(x), "h_cat": t(h_cat * mask), "h_int": t(h_int * mask), "mask": t(mask),
            "log_pN": t(D.log_p_n(cfg, n_atoms))}


def _check(spec, M, sd0, batches, noise_seed, device, prog) -> list:
    cfg, wl = spec.config, spec.workload
    P0 = {k: v.to(device) for k, v in sd0.items()}
    trainable = [n for n, _, _ in R.param_specs(M)]
    pad = max(b["x"].shape[1] for b in batches)
    block = max(1, min(wl["batch_size"], wl.get("ref_block_edges", 131072) // (pad * pad)))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = RT.follow(P0, M, trainable, batches, noise_seed, cfg["lr"], cfg["ema_decay"],
                        block)
        if spec.fault == "control":  # the reference, in TF32, in the program's place
            ctl = RT.follow(P0, M, trainable, batches, noise_seed, cfg["lr"],
                            cfg["ema_decay"], block, q=R.tf32_round)
            prog = {"losses": ctl["losses"], "grad1": C.norms(ctl["grad1"]),
                    "change": C.norms(ctl["change"]), "ema_change": C.norms(ctl["ema_change"])}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    numbers = C.train_numbers(prog, ref)
    detail = {"prog": prog, "ref": {"losses": ref["losses"], "clip_norms": ref["clip_norms"],
                                    **{k: C.norms(ref[k]) for k in ("grad1", "change",
                                                                    "ema_change")}}}
    return C.checks(numbers, spec.limits), numbers, detail
