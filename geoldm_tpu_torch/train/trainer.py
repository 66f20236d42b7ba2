"""Epoch-level training and evaluation (port of
``geoldm_tpu/train/trainer.py:34-231, :363-412``).

- ``train_epoch``: host loader -> batch on the device -> one train step per
  batch; the loop is serial (the JAX package's prefetch thread waits for a
  later slice) and synchronises only to print a loss every ``log_every``.
- ``evaluate_nll``: eval NLL (t0_always estimator) over a loader.
- ``analyze_and_save``: bucketed generation, then the stability check.

Noise: each epoch's train and eval draws come from a ``torch.Generator`` on
the device seeded from (seed, purpose, epoch) by the caller, so a seeded run
replays.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from geoldm_tpu_torch.evalsuite.analyze import check_stability
from geoldm_tpu_torch.models.distributions import DistributionNodes
from geoldm_tpu_torch.ops import com
from geoldm_tpu_torch.train import sampling as sampling_mod
from geoldm_tpu_torch.utils.buckets import covering_buckets


def prepare_batch(raw: Dict[str, np.ndarray], nodes_dist: DistributionNodes, device,
                  augment_noise: float = 0.0,
                  rng: Optional[np.random.Generator] = None) -> Dict[str, torch.Tensor]:
    """Host-side batch prep: log p(N) and the optional CoM-free coordinate
    noise (reference train_test.py:22-44), then the copy to ``device``."""
    rng = rng or np.random.default_rng()
    x = raw["x"]
    if augment_noise > 0:
        eps = rng.standard_normal(x.shape).astype(np.float32) * raw["node_mask"]
        eps -= eps.sum(axis=1, keepdims=True) / np.maximum(
            raw["node_mask"].sum(axis=1, keepdims=True), 1) * raw["node_mask"]
        x = x + eps * augment_noise
    batch = {
        "x": x.astype(np.float32),
        "h_cat": raw["h_cat"],
        "h_int": raw["h_int"],
        "node_mask": raw["node_mask"],
        "log_pN": nodes_dist.log_prob(raw["n_atoms"]).astype(np.float32),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def train_epoch(state, train_step, loader, nodes_dist: DistributionNodes, noise: com.Noise,
                epoch: int, *, augment_noise: float = 0.0, break_train_epoch: bool = False,
                log_every: int = 50, rng: Optional[np.random.Generator] = None):
    """One pass over the loader -> (per-step losses as floats, seconds)."""
    rng = rng or np.random.default_rng(epoch)
    device = next(state.model.parameters()).device
    losses = []
    t0 = time.time()
    for i, raw in enumerate(loader):
        batch = prepare_batch(raw, nodes_dist, device, augment_noise, rng)
        metrics = train_step(state, batch, noise)
        losses.append(metrics["loss"])
        if i % log_every == 0:
            print(f"Epoch {epoch}, iter {i}/{len(loader)}: loss {float(metrics['loss']):.3f}, "
                  f"grad norm {float(metrics['grad_norm']):.2f}", flush=True)
        if break_train_epoch:
            break
    if not losses:
        raise RuntimeError("train_epoch processed zero batches: the train split holds fewer "
                           "molecules than --batch_size")
    losses = torch.stack(losses).cpu().tolist()
    seconds = time.time() - t0
    print(f"Epoch {epoch} took {seconds:.1f}s, mean loss {float(np.mean(losses)):.3f}",
          flush=True)
    return losses, seconds


def evaluate_nll(model, eval_nll_fn, loader, nodes_dist: DistributionNodes, noise: com.Noise,
                 *, partition: str = "valid", augment_noise: float = 0.0,
                 rng: Optional[np.random.Generator] = None) -> float:
    """Mean NLL over a split with the t0_always estimator; like the
    reference, ``augment_noise`` applies here too (train_test.py:119-124).
    The weighted sum stays on the device and is fetched once."""
    rng = rng or np.random.default_rng(0)
    device = next(model.parameters()).device
    total, count = torch.zeros((), dtype=torch.float32, device=device), 0
    for raw in loader:
        batch = prepare_batch(raw, nodes_dist, device, augment_noise, rng)
        b = batch["x"].shape[0]
        total = total + eval_nll_fn(model, batch, noise) * b
        count += b
    mean = float(total) / max(count, 1)
    print(f"{partition} NLL: {mean:.4f}", flush=True)
    return mean


def analyze_and_save(model, seed: int, dataset_info, nodes_dist: DistributionNodes, *,
                     n_samples: int = 500, batch_size: int = 100,
                     rng: Optional[np.random.Generator] = None):
    """Generate ``n_samples`` molecules (sizes from the dataset histogram,
    size-bucketed) and score their stability -> (validity dict, molecules)
    (reference train_test.py:176-197). RDKit metrics are not ported."""
    rng = rng or np.random.default_rng(0)
    nodesxsample = nodes_dist.sample(n_samples, rng)
    buckets = covering_buckets(sampling_mod.default_buckets(dataset_info),
                               dataset_info["max_n_nodes"])
    t0 = time.time()
    one_hot, _, x, node_mask = sampling_mod.sample_bucketed(
        model, seed, dataset_info, nodesxsample, batch_size=min(batch_size, n_samples),
        buckets=buckets)
    t_gen = time.time() - t0
    mol_stable = atm_stable = n_atoms = 0
    for i in range(len(x)):
        n_i = int(node_mask[i, :, 0].sum())
        stable, n_stable, n_all = check_stability(x[i, :n_i], np.argmax(one_hot[i, :n_i], axis=1),
                                                  dataset_info)
        mol_stable += int(stable)
        atm_stable += n_stable
        n_atoms += n_all
    validity = {"mol_stable": mol_stable / max(len(x), 1),
                "atm_stable": atm_stable / max(n_atoms, 1)}
    print(f"  [analyze_and_save] generation {t_gen:.1f}s for {n_samples} molecules", flush=True)
    molecules = {"one_hot": one_hot, "x": x, "node_mask": node_mask[..., 0],
                 "n_atoms": nodesxsample}
    return validity, molecules
