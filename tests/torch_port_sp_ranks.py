"""What each rank of the port's sequence-parallel tests runs. Imports torch
and the port only (no jax), because ``parallel.sharding.spawn`` starts each
rank in a fresh interpreter that imports the module of the function it runs.
Every function takes plain numpy inputs and returns numpy results (rank 0's
reach the test); ``grid``, the last argument, is the rank's
``parallel.sharding.Grid`` (one data rank: its ``seq`` group splits the
rows), None for the single-device run the SP run is held against."""

import numpy as np
import torch
import torch.distributed as dist

from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.models import factory
from geoldm_tpu_torch.nn.egnn import EGNN
from geoldm_tpu_torch.ops import kernel_launches
from geoldm_tpu_torch.parallel import sharding, sp
from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step


def _gather(obj, grp):
    """``obj`` of every rank, in rank order ([obj] on one device)."""
    if grp is None:
        return [obj]
    out = [None] * grp.size
    dist.all_gather_object(out, obj)
    return out


def egnn_cases(cases, device, grid=None):
    """Per case (EGNN config kwargs, upstream state dict, h, x, node_mask and
    the cotangents gh, gx of the outputs): the EGNN's outputs and the
    gradients of sum(h_out * gh) + sum(x_out * gx) with respect to h, x and
    every weight (the blocks' summed over the ranks), whether every rank got
    the same results, and this rank's kernel launch counts so far."""
    grp = None if grid is None else grid.seq
    results = []
    for case in cases:
        egnn = EGNN(EGNNConfig(**case["cfg"]))
        egnn.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()},
                             strict=True)
        egnn = sp.attach(egnn.to(device), grp)
        h, x, mask, gh, gx = (torch.from_numpy(case[k]).to(device)
                              for k in ("h", "x", "mask", "gh", "gx"))
        h.requires_grad_()
        x.requires_grad_()
        h_out, x_out = egnn(h, x, mask)
        ((h_out * gh).sum() + (x_out * gx).sum()).backward()
        if grp is not None:
            sharding.reduce_grads(sp.block_parameters(egnn), grp)
        grads = {"h": h.grad, "x": x.grad, **{n: p.grad for n, p in egnn.named_parameters()}}
        out = {"h": h_out.detach().cpu().numpy(), "x": x_out.detach().cpu().numpy(),
               "grads": {k: g.cpu().numpy() for k, g in grads.items()}}
        mine = [out["h"], out["x"], *out["grads"].values()]
        ranks = _gather(mine, grp)
        out["ranks_agree"] = all(np.array_equal(a, b) for r in ranks for a, b in zip(r, ranks[0]))
        out["launches"] = kernel_launches()
        results.append(out)
    return results


def geom_train_step(kw, batch, seed, device, grid=None, compute_dtype=None):
    """One latent-diffusion train step of a GEOM-config model drawn from
    ``seed`` (``factory.make_latent_diffusion_config(geom, **kw)``) on
    ``batch`` with noise from a generator seeded ``seed + 1``, in
    ``compute_dtype`` -> the loss, every parameter's gradient after the
    step's clip (before the update), the replicas' train-state digests and
    kernel launch counts."""
    grp = None if grid is None else grid.seq
    cfg = factory.make_latent_diffusion_config(get_dataset_info("geom"), **kw)
    model = factory.build_model(cfg, device, torch.Generator().manual_seed(seed), sp_group=grp)
    state = create_train_state(model, cfg, 5e-5, ema_decay=0.999)
    step = make_train_step(cfg, 0.999, compute_dtype)
    noise = torch.Generator(device=device).manual_seed(seed + 1)
    metrics = step(state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()}, noise)
    return {"loss": float(metrics["loss"]),
            "grads": {n: p.grad.cpu().numpy() for n, p in model.named_parameters()
                      if p.grad is not None},
            "digests": _gather(sp.state_digest(state), grp),
            "launches": _gather(kernel_launches(), grp)}


def geom_train_step_bf16(kw, batch, seed, device, grid=None):
    """``geom_train_step`` in the bfloat16 compute dtype."""
    return geom_train_step(kw, batch, seed, device, grid, "bfloat16")
