"""Property-classifier training (port of
``geoldm_tpu/train/classifier_train.py``; reference
qm9/property_prediction/main_qm9_prop.py:15-115, 170-218).

L1 loss on mean/MAD-normalized labels (the denormalized L1 at evaluation),
Adam with decoupled weight decay (optax ``scale_by_adam`` then
``add_decayed_weights``, scaled by -lr: AdamW's update), a cosine learning
rate over the epochs stepped at the start of each epoch, so epoch e trains
at ``cosine_lr(e + 1)``, and the best-on-valid weights kept, written to
``<outdir>/best/classifier.npy`` with the loss log ``<outdir>/losess.json``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from geoldm_tpu_torch.models import classifier as clf

CHECKPOINT = "classifier.npy"


def batch_for_classifier(raw: Dict[str, np.ndarray], prop: str, device
                         ) -> Dict[str, torch.Tensor]:
    """A QM9Loader batch on ``device``: the one-hot types are the node
    features (no charges; main_qm9_prop.py:31-35), the property the label."""
    arrays = {"h0": raw["h_cat"], "x": raw["x"], "node_mask": raw["node_mask"],
              "edge_mask": raw["edge_mask"], "label": raw[prop]}
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).to(device)
            for k, v in arrays.items()}


def _predict(model, batch, compute_dtype):
    return model(batch["h0"], batch["x"], batch["node_mask"], batch["edge_mask"], compute_dtype)


def train_loss(model, batch, mean: float, mad: float, compute_dtype=None) -> torch.Tensor:
    """Mean |pred - (label - mean) / mad|."""
    return (_predict(model, batch, compute_dtype) - (batch["label"] - mean) / mad).abs().mean()


def eval_loss(model, batch, mean: float, mad: float, compute_dtype=None) -> torch.Tensor:
    """Mean |mad * pred + mean - label|: the MAE in the property's units."""
    return (mad * _predict(model, batch, compute_dtype) + mean - batch["label"]).abs().mean()


def cosine_lr(lr: float, epochs: int, step: int) -> float:
    """optax.cosine_decay_schedule(lr, epochs) at ``step``."""
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(step, epochs) / epochs))


def make_optimizer(model, lr: float, weight_decay: float) -> torch.optim.Optimizer:
    """Adam (betas 0.9, 0.999, eps 1e-8) plus decoupled weight decay."""
    return torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=weight_decay)


def train_step(model, optimizer, batch, mean: float, mad: float, lr: float,
               compute_dtype=None) -> torch.Tensor:
    """One step at learning rate ``lr``; returns the loss (not synchronised)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    loss = train_loss(model, batch, mean, mad, compute_dtype)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def evaluate(model, loader, prop: str, mean: float, mad: float, device,
             compute_dtype=None) -> float:
    """The molecule-weighted MAE over a loader."""
    total, count = 0.0, 0
    for raw in loader:
        batch = batch_for_classifier(raw, prop, device)
        total += float(eval_loss(model, batch, mean, mad, compute_dtype)) * len(raw["x"])
        count += len(raw["x"])
    return total / max(count, 1)


def train_classifier(loaders: Dict[str, object], prop: str,
                     property_norms: Dict[str, Dict[str, float]], *, epochs: int = 1000,
                     lr: float = 1e-3, weight_decay: float = 1e-16, nf: int = 128,
                     n_layers: int = 7, attention: bool = True, node_attr: bool = False,
                     in_node_nf: int = 5, seed: int = 1, outdir: Optional[str] = None,
                     log_every: int = 20, compute_dtype=None, device="cuda",
                     model_name: str = "egnn") -> dict:
    """A whole run (JAX ``train_classifier``) of the classifier or a
    baseline (``model_name``), its weights drawn from
    ``torch.Generator().manual_seed(seed)``: returns {"state_dict": the
    best-on-valid weights (CPU), "epochs", "losess" (test MAE per epoch),
    "best_val", "best_test", "best_epoch"}."""
    mean, mad = property_norms[prop]["mean"], property_norms[prop]["mad"]
    model = clf.build_classifier(model_name, in_node_nf, nf, n_layers, attention, node_attr,
                                 device, torch.Generator().manual_seed(seed))
    device = next(model.parameters()).device
    optimizer = make_optimizer(model, lr, weight_decay)
    res = {"epochs": [], "losess": [], "best_val": 1e10, "best_test": 1e10, "best_epoch": 0}
    best = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    for epoch in range(epochs):
        epoch_lr = cosine_lr(lr, epochs, epoch + 1)
        model.train()
        for i, raw in enumerate(loaders["train"]):
            loss = train_step(model, optimizer, batch_for_classifier(raw, prop, device), mean,
                              mad, epoch_lr, compute_dtype)
            if i % log_every == 0:
                print(f"Epoch {epoch} \t Iteration {i} \t loss {float(loss):.4f}", flush=True)
        model.eval()
        val_loss = evaluate(model, loaders["valid"], prop, mean, mad, device, compute_dtype)
        test_loss = evaluate(model, loaders["test"], prop, mean, mad, device, compute_dtype)
        res["epochs"].append(epoch)
        res["losess"].append(test_loss)
        if val_loss < res["best_val"]:
            res["best_val"], res["best_test"], res["best_epoch"] = val_loss, test_loss, epoch
            best = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            if outdir:
                save_classifier(os.path.join(outdir, "best"), best)
        print(f"Val loss: {val_loss:.4f} \t test loss: {test_loss:.4f} \t epoch {epoch}",
              flush=True)
        if outdir:
            os.makedirs(outdir, exist_ok=True)
            with open(os.path.join(outdir, "losess.json"), "w") as f:
                json.dump(res, f, indent=4)
    return {"state_dict": best, **res}


def save_classifier(path: str, state_dict: dict) -> str:
    os.makedirs(path, exist_ok=True)
    torch.save(state_dict, os.path.join(path, CHECKPOINT))
    return path


def load_classifier(path: str, nf: int = 128, n_layers: int = 7, in_node_nf: int = 5,
                    attention: bool = True, node_attr: bool = False, device="cuda"):
    """The classifier of a training run's directory (``<path>/best``) or of
    a checkpoint directory, in eval mode on ``device``."""
    ckpt = os.path.join(path, CHECKPOINT)
    if not os.path.exists(ckpt):
        ckpt = os.path.join(path, "best", CHECKPOINT)
    model = clf.build_classifier("egnn", in_node_nf, nf, n_layers, attention, node_attr, device)
    model.load_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True), strict=True)
    return model.eval()
