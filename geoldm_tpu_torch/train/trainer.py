"""Epoch-level training and evaluation (port of
``geoldm_tpu/train/trainer.py:34-412``).

- ``train_epoch``: host loader -> batch on the device -> one train step per
  batch; the host prep of batch k+1 (augment noise, rotation, log p(N), the
  copy to the device) runs on the ``prefetch_map`` thread while the device
  runs step k, and the loop synchronises only to log a loss every
  ``log_every``. Under a profiler the loop's wait for each batch is a
  ``train.data_wait`` span (``utils.spans``) and each issued batch adds its
  pair slots (rows x pad^2) to ``train.pair_slots`` and its molecules' n^2
  to ``train.pairs``, from the host's mask.
- ``evaluate_nll``: eval NLL (t0_always estimator) over a loader.
- ``evaluate_nll_packed``: the same NLL over a whole split staged on the
  device in segments, for one or more passes (the paper's 5 test passes).
- ``analyze_and_save``: bucketed generation, then stability and the
  validity/uniqueness/novelty triple.

Data parallelism (``parallel.sharding``): each function takes ``data``, this
rank's data group, or None on one rank. Every rank prepares the whole global
batch on the host with the shared numpy generator, exactly as one rank does,
then keeps its rows; the device draws come from ``sharding.GlobalNoise``.
Training trims a tail batch that D does not divide and reports the dropped
count (JAX's rule, ``geoldm_tpu/train/trainer.py:112-124``); the eval NLL
pads it with weight-0 repeats instead, so every molecule counts once;
generation fans its chunks out over the data ranks.

Noise: each epoch's train and eval draws come from a ``torch.Generator`` on
the device seeded from (seed, purpose, epoch) by the caller, so a seeded run
replays; host draws (augment noise, rotations, sampled sizes) come from the
caller's numpy generator, in the serial loop's order at any prefetch depth.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from geoldm_tpu_torch.evalsuite.analyze import analyze_stability_for_molecules
from geoldm_tpu_torch.models.distributions import DistributionNodes
from geoldm_tpu_torch.ops import com
from geoldm_tpu_torch.parallel import sharding
from geoldm_tpu_torch.train import sampling as sampling_mod
from geoldm_tpu_torch.train.augment import random_rotation
from geoldm_tpu_torch.train.conditioning import prepare_context
from geoldm_tpu_torch.train.prefetch import prefetch_map
from geoldm_tpu_torch.utils import spans
from geoldm_tpu_torch.utils.buckets import covering_buckets


def prepare_batch(raw: Dict[str, np.ndarray], nodes_dist: DistributionNodes, device,
                  augment_noise: float = 0.0, rng: Optional[np.random.Generator] = None,
                  data_augmentation: bool = False, conditioning=(), property_norms=None,
                  context_indicator: bool = False) -> Dict[str, torch.Tensor]:
    """Host-side batch prep (``prepare_host``), then the copy to
    ``device``."""
    return to_device(prepare_host(raw, nodes_dist, augment_noise, rng, data_augmentation,
                                  conditioning, property_norms, context_indicator), device)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def prepare_host(raw: Dict[str, np.ndarray], nodes_dist: DistributionNodes,
                 augment_noise: float = 0.0, rng: Optional[np.random.Generator] = None,
                 data_augmentation: bool = False, conditioning=(), property_norms=None,
                 context_indicator: bool = False) -> Dict[str, np.ndarray]:
    """log p(N), the optional CoM-free coordinate noise, then the optional
    random rotation, masked (reference train_test.py:22-44), and with
    ``conditioning`` the per-node context (``conditioning.prepare_context``),
    as numpy arrays."""
    rng = rng or np.random.default_rng()
    x = raw["x"]
    if augment_noise > 0:
        eps = rng.standard_normal(x.shape).astype(np.float32) * raw["node_mask"]
        eps -= eps.sum(axis=1, keepdims=True) / np.maximum(
            raw["node_mask"].sum(axis=1, keepdims=True), 1) * raw["node_mask"]
        x = x + eps * augment_noise
    if data_augmentation:
        x = random_rotation(x, rng) * raw["node_mask"]
    batch = {
        "x": x.astype(np.float32),
        "h_cat": raw["h_cat"],
        "h_int": raw["h_int"],
        "node_mask": raw["node_mask"],
        "log_pN": nodes_dist.log_prob(raw["n_atoms"]).astype(np.float32),
    }
    if conditioning:
        batch["context"] = prepare_context(conditioning, raw, property_norms,
                                           indicator=context_indicator)
    return batch


def pad_with_weight(batch: Dict[str, np.ndarray], target: int) -> Dict[str, np.ndarray]:
    """A batch of b molecules padded to ``target`` by repeating its leading
    molecules (``np.resize`` cycles rows), with ``weight`` 1 on the b real
    ones and 0 on the repeats (JAX's ``evaluate_nll``)."""
    b = len(batch["x"])
    out = {k: np.resize(v, (target,) + v.shape[1:]) for k, v in batch.items()}
    out["weight"] = (np.arange(target) < b).astype(np.float32)
    return out


_END = object()


def _waited(batches):
    """``batches``, each wait for the next one a ``train.data_wait`` span
    (id: the batch's index in the epoch; the last wait finds the end)."""
    batches = iter(batches)
    for i in itertools.count():
        with spans.span("train.data_wait", i):
            item = next(batches, _END)
        if item is _END:
            return
        yield item


def train_epoch(state, train_step, loader, nodes_dist: DistributionNodes, noise: com.Noise,
                epoch: int, *, augment_noise: float = 0.0, data_augmentation: bool = False,
                break_train_epoch: bool = False, log_every: int = 50,
                rng: Optional[np.random.Generator] = None, logger=None, prefetch: int = 2,
                conditioning=(), property_norms=None, context_indicator: bool = False,
                data: Optional[sharding.RankGroup] = None):
    """One pass over the loader -> (per-step losses as floats, seconds).
    ``logger`` (a ``utils.logging_utils.MetricLogger``) gets the batch loss
    and gradient norm every ``log_every`` steps. ``conditioning`` puts each
    batch's context under ``batch["context"]`` (``prepare_batch``). With
    ``data`` each step takes this rank's rows of the global batch and noise
    (module docstring); a tail batch is trimmed to a multiple of D, and a
    batch trimmed to nothing is skipped."""
    rng = rng or np.random.default_rng(epoch)
    device = next(state.model.parameters()).device
    noise = sharding.wrap_noise(noise, data)
    losses = []
    dropped = 0
    t0 = time.time()

    def prep(raw):
        nonlocal dropped
        batch = prepare_host(raw, nodes_dist, augment_noise, rng, data_augmentation,
                             conditioning, property_norms, context_indicator)
        if data is not None:
            b = len(batch["x"])
            dropped += b % data.size
            keep = b - b % data.size
            if keep == 0:
                return None
            batch = sharding.shard_rows({k: v[:keep] for k, v in batch.items()}, data)
        mask = batch["node_mask"]
        n = mask.reshape(len(mask), -1).sum(axis=1, dtype=np.int64)
        return int((n * n).sum()), mask.shape[0] * mask.shape[1] ** 2, to_device(batch, device)

    # break_train_epoch runs serially: a lookahead would advance the shared
    # rng past where the serial loop stops, changing later draws.
    depth = 0 if break_train_epoch else prefetch
    for i, prepped in enumerate(_waited(prefetch_map(prep, loader, depth=depth))):
        if prepped is None:
            continue
        pairs, slots, batch = prepped
        spans.count("train.pairs", pairs)
        spans.count("train.pair_slots", slots)
        metrics = train_step(state, batch, noise)
        losses.append(metrics["loss"])
        if i % log_every == 0:
            loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
            print(f"Epoch {epoch}, iter {i}/{len(loader)}: loss {loss:.3f}, "
                  f"grad norm {grad_norm:.2f}", flush=True)
            if logger is not None:
                logger.log({"batch_loss": loss, "grad_norm": grad_norm})
        if break_train_epoch:
            break
    if not losses:
        raise RuntimeError("train_epoch processed zero batches: the train split holds fewer "
                           "molecules than --batch_size, or every batch is smaller than the "
                           "data-parallel width (batch_size < dp?)")
    losses = torch.stack(losses).cpu().tolist()
    seconds = time.time() - t0
    print(f"Epoch {epoch} took {seconds:.1f}s, mean loss {float(np.mean(losses)):.3f}"
          + (f" ({dropped} tail molecules dropped for dp-divisibility)" if dropped else ""),
          flush=True)
    return losses, seconds


def evaluate_nll(model, eval_nll_fn, loader, nodes_dist: DistributionNodes, noise: com.Noise,
                 *, partition: str = "valid", augment_noise: float = 0.0,
                 rng: Optional[np.random.Generator] = None, prefetch: int = 2,
                 conditioning=(), property_norms=None, context_indicator: bool = False,
                 data: Optional[sharding.RankGroup] = None) -> float:
    """Mean NLL over a split with the t0_always estimator; like the
    reference, ``augment_noise`` applies here too (train_test.py:119-124).
    The weighted sum stays on the device and is fetched once. A conditional
    model gets each batch's context (``prepare_batch``). With ``data`` a
    batch that D does not divide is padded with weight-0 repeats to the
    loader's nominal batch size (or the next multiple of D), each rank
    evaluates its rows, and the sums are added over the data ranks: every
    molecule of the split counts exactly once (JAX ``:195-221``)."""
    rng = rng or np.random.default_rng(0)
    device = next(model.parameters()).device
    noise = sharding.wrap_noise(noise, data)
    total, count = torch.zeros((), dtype=torch.float32, device=device), 0
    nominal = getattr(loader, "batch_size", 0)

    def prep(raw):
        batch = prepare_host(raw, nodes_dist, augment_noise, rng,
                             conditioning=conditioning, property_norms=property_norms,
                             context_indicator=context_indicator)
        b = len(batch["x"])
        if data is not None:  # every rank's rows carry a weight, 0 on the repeats
            d = data.size
            target = (b if b % d == 0 else nominal if nominal >= b and nominal % d == 0
                      else -(-b // d) * d)
            batch = sharding.shard_rows(pad_with_weight(batch, target), data)
        return b, to_device(batch, device)

    for b, batch in prefetch_map(prep, loader, depth=prefetch):
        # The batch's weighted mean times its real count: its sum.
        w = batch["weight"].sum() if "weight" in batch else b
        total = total + eval_nll_fn(model, batch, noise) * w
        count += b
    if data is not None:
        total = sharding.all_reduce(total, data)
    mean = float(total) / max(count, 1)
    print(f"{partition} NLL: {mean:.4f}", flush=True)
    return mean


@torch.no_grad()
def evaluate_nll_packed(model, model_cfg, split: Dict[str, np.ndarray],
                        nodes_dist: DistributionNodes, noises: Sequence[com.Noise], *,
                        batch_size: int = 64, pad_nodes: int = 0, partition: str = "test",
                        augment_noise: float = 0.0, stage_bytes: int = 2 << 30,
                        compute_dtype=None, data: Optional[sharding.RankGroup] = None):
    """Per-pass mean NLLs (t0_always) over a whole split, one pass per noise
    source in ``noises`` (``geoldm_tpu/train/trainer.py:234-360``).

    The split is packed on the host into [steps, batch_size, ...] arrays
    (``data.collate.prepare_split_arrays``, padded to ``pad_nodes``) and
    copied to the device in segments of at most ``stage_bytes``; each
    segment is copied once and serves every pass (segments outer, passes
    inner), and each pass keeps its weighted sum on the device and fetches
    it once per segment. The molecule count is padded to a batch multiple by
    repeating the leading molecules with weight 0 (an all-zero mask would
    send NaN through the latent model's per-graph reductions). Each batch
    draws from its pass's noise source: with ``augment_noise`` > 0 first the
    CoM-free coordinate noise (reference eval-time augment,
    train_test.py:119-124), then the NLL's own draws. An empty split gives
    ``[0.0] * len(noises)``. The model runs in ``compute_dtype``.

    With ``data`` every packed batch is split over the data ranks: a batch
    size that D does not divide is raised to the next multiple (more weight-0
    rows), each rank stages and evaluates its rows of every batch with its
    rows of the global draws (``sharding.GlobalNoise``), and the sums are
    added over the ranks once at the end; with a batch size D divides, the
    draws are one rank's."""
    from geoldm_tpu_torch.data.collate import prepare_split_arrays
    from geoldm_tpu_torch.models import factory

    m = len(split["num_atoms"])
    if m == 0:
        return [0.0] * len(noises)
    device = next(model.parameters()).device
    n = pad_nodes or split["positions"].shape[1]
    n_atoms = np.asarray(split["num_atoms"])
    arrs = prepare_split_arrays(n_atoms, split["positions"], split["one_hot"], split["charges"],
                                n, model_cfg.include_charges)
    log_pN = nodes_dist.log_prob(n_atoms).astype(np.float32)
    if data is not None and batch_size % data.size:
        batch_size = -(-batch_size // data.size) * data.size
        print(f"{partition}: batch size raised to {batch_size} to split over {data.size} data "
              "ranks", flush=True)
    steps = -(-m // batch_size)
    mp = steps * batch_size
    weight = np.concatenate([np.ones(m, np.float32), np.zeros(mp - m, np.float32)])

    def pack(a):
        if len(a) < mp:
            a = np.resize(a, (mp,) + a.shape[1:])  # cycles whole rows, even past m
        return a.reshape((steps, batch_size) + a.shape[1:])

    packed = [pack(a.astype(np.float32)) for a in (arrs["x"], arrs["h_cat"], arrs["h_int"],
                                                   arrs["node_mask"], log_pN, weight)]
    if data is not None:
        rows = sharding.own_rows(batch_size, data)
        packed = [a[:, rows] for a in packed]
        noises = [sharding.GlobalNoise(noise, data) for noise in noises]
    bytes_per_step = sum(a.itemsize * int(np.prod(a.shape[1:])) for a in packed)
    seg_steps = max(1, int(stage_bytes // max(bytes_per_step, 1)))
    n_segs = -(-steps // seg_steps)
    if n_segs > 1:
        print(f"{partition}: staging {steps} batches in {n_segs} segments of <= {seg_steps} "
              f"({bytes_per_step * seg_steps / 2**30:.2f} GiB on the device at a time)",
              flush=True)
    nll_fn = factory.model_nll_fn(model_cfg, training=False, compute_dtype=compute_dtype)
    totals = [0.0] * len(noises)
    for s0 in range(0, steps, seg_steps):
        seg = [torch.from_numpy(np.ascontiguousarray(a[s0:s0 + seg_steps])).to(device)
               for a in packed]
        for i, noise in enumerate(noises):
            total = torch.zeros((), dtype=torch.float32, device=device)
            for x, h_cat, h_int, node_mask, lpn, w in zip(*seg):
                if augment_noise > 0:
                    eps = com.randn(noise, x.shape, x) * node_mask
                    x = x + com.remove_mean_with_mask(eps, node_mask) * augment_noise
                nll = nll_fn(model, noise, x, h_cat, h_int, node_mask) - lpn
                total = total + (nll * w).sum()
            totals[i] += float(total)
    if data is not None:
        totals = sharding.all_reduce(torch.tensor(totals, dtype=torch.float64), data).tolist()
    means = [t / m for t in totals]
    for i, val in enumerate(means):
        print(f"{partition}[{i}] NLL: {val:.4f}", flush=True)
    return means


def analyze_and_save(model, seed: int, dataset_info, nodes_dist: DistributionNodes, *,
                     n_samples: int = 500, batch_size: int = 100,
                     rng: Optional[np.random.Generator] = None, datadir: str = "data",
                     external_smiles=None, n_steps: Optional[int] = None, eta: float = 1.0,
                     method: str = "ddim", compute_dtype=None, prop_dist=None,
                     data: Optional[sharding.RankGroup] = None):
    """Generate ``n_samples`` molecules (sizes from the dataset histogram,
    size-bucketed, with the sampler settings of ``vdm.vdm_sample``) and score
    them -> (stability dict, validity triple, molecules) (reference
    train_test.py:176-197, eval_analyze.py:35-67). The triple is
    ([validity, uniqueness, novelty], unique SMILES) from the best backend
    available (``evalsuite.analyze.analyze_stability_for_molecules``);
    ``external_smiles`` replaces the training set of ``datadir`` as the
    novelty base. ``molecules["report"]`` names the stability path that ran
    and holds the host seconds of each part. A conditional model draws each
    chunk's properties from ``prop_dist`` with ``rng`` (JAX's order). With
    ``data`` the chunks fan out over the data ranks and every rank gets and
    scores the whole set, the molecules of one rank's run
    (``sampling.sample_bucketed``)."""
    rng = rng or np.random.default_rng(0)
    nodesxsample = nodes_dist.sample(n_samples, rng)
    buckets = covering_buckets(sampling_mod.default_buckets(dataset_info),
                               dataset_info["max_n_nodes"])
    t0 = time.time()
    one_hot, _, x, node_mask = sampling_mod.sample_bucketed(
        model, seed, dataset_info, nodesxsample, batch_size=min(batch_size, n_samples),
        buckets=buckets, n_steps=n_steps, eta=eta, method=method, compute_dtype=compute_dtype,
        prop_dist=prop_dist, rng=rng, data=data)
    report = {"generation_seconds": time.time() - t0}
    molecules = {"one_hot": one_hot, "x": x, "node_mask": node_mask[..., 0],
                 "n_atoms": nodesxsample, "report": report}
    t0 = time.time()
    validity, rdkit_tuple = analyze_stability_for_molecules(
        molecules, dataset_info, datadir=datadir, external_smiles=external_smiles,
        report=report)
    print(f"  [analyze_and_save] generation {report['generation_seconds']:.1f}s, analysis "
          f"{time.time() - t0:.1f}s for {n_samples} molecules (stability on the "
          f"{report['stability_path']} path)", flush=True)
    return validity, rdkit_tuple, molecules
