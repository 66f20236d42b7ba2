"""What each rank of the port's data-parallel tests runs. Imports torch, numpy
and the port only (no jax), because ``parallel.sharding.spawn`` starts each
rank in a fresh interpreter that imports the module of the function it runs.
Every function takes plain numpy inputs, whole global batches and draws
included, and returns numpy results (rank 0's reach the test); ``grid``, the
last argument, which ``sharding.spawn`` appends to the others (so a caller
passes every other one), is the rank's ``parallel.sharding.Grid``, None for
the one-rank run the parallel run is held against."""

import numpy as np
import torch
import torch.distributed as dist

from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.models import factory
from geoldm_tpu_torch.models.distributions import DistributionNodes
from geoldm_tpu_torch.ops import fused_optim, kernel_launches
from geoldm_tpu_torch.parallel import sharding, sp
from geoldm_tpu_torch.train import sampling, trainer
from geoldm_tpu_torch.train.train_step import (
    create_train_state,
    make_eval_nll,
    make_train_step,
    state_elements,
)
from geoldm_tpu_torch.utils.checkpoint import full_state


class Replay:
    """A global noise source handing out given draws in order: ('n',
    normals) through __call__, ('i', integers) through randint, each of the
    global batch's shape."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, kind, shape):
        got_kind, a = self.draws.pop(0)
        assert got_kind == kind and tuple(a.shape) == tuple(shape), (got_kind, a.shape, shape)
        return torch.from_numpy(np.array(a))

    def __call__(self, shape):
        return self._next("n", shape)

    def randint(self, low, high, shape):
        return self._next("i", shape)


def _world(obj, grid):
    """``obj`` of every rank of the run, in rank order ([obj] on one rank)."""
    if grid is None:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _groups(grid):
    return (None, None) if grid is None else (grid.seq, grid.data)


def _model_group(grid):
    return None if grid is None else grid.model


def _model(spec, device, seq):
    """(config, model) of ``spec``: ``dataset`` and ``kw`` for
    ``factory.make_latent_diffusion_config``, weights from ``state`` (numpy
    state dict) or ``seed``."""
    cfg = factory.make_latent_diffusion_config(get_dataset_info(spec["dataset"]), **spec["kw"])
    gen = None if "state" in spec else torch.Generator().manual_seed(spec["seed"])
    model = factory.build_model(cfg, device, gen, sp_group=seq)
    if "state" in spec:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in spec["state"].items()},
                              strict=True)
    return cfg, model


def train_step(spec, batch, noise, opts=None, grid=None):
    """One latent-diffusion train step of ``spec``'s model on the global
    ``batch`` (numpy dict) with ``noise``: ("seed", s), a generator seeded s,
    or ("replay", draws), the global draws in the loss's order. ``opts``:
    ``keep`` (a global [B,1,1] keep mask), ``clip_grad``, ``compute_dtype``,
    ``context_dropout``. Each data rank takes its rows of the batch, the
    keep mask and every draw; under TP (the grid's ``model`` group) every
    parameter of ``kw['nf']`` width is sharded over the model ranks. -> the
    loss, the gradient norm, every gradient the optimizer applies (after the
    SP sum, the DP mean and the clip; under TP the shards gathered), the
    weights after the update, the train state as one rank holds it after the
    step (``utils.checkpoint.full_state``: AMSGrad's moments and the EMA
    gathered), every rank's train-state digest, launch counts (the fused
    optimizer step's apart: norm, threshold, update) and elements of
    optimizer and EMA state."""
    opts = opts or {}
    device = "cpu" if grid is None else grid.device
    seq, data = _groups(grid)
    tp = _model_group(grid)
    cfg, model = _model(spec, device, seq)
    lr, ema_decay = 1e-3, 0.99
    state = create_train_state(model, cfg, lr, clip_grad=opts.get("clip_grad", True),
                               ema_decay=ema_decay, dp_group=data, model_group=tp,
                               hidden_nf=spec["kw"]["nf"])
    step = make_train_step(cfg, ema_decay, opts.get("compute_dtype"),
                           opts.get("context_dropout", 0.0))
    keep = opts.get("keep")
    kind, arg = noise
    source = (torch.Generator(device=device).manual_seed(arg) if kind == "seed"
              else Replay(arg))
    local = sharding.shard_rows(batch, data)
    if keep is not None:
        keep = torch.from_numpy(sharding.shard_rows({"k": keep}, data)["k"]).to(device)
    out = step(state, {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                       for k, v in local.items()},
               sharding.wrap_noise(source, data), keep=keep)
    # The gradients the optimizer applied: after the step they are still
    # there, clipped in place (AdamW leaves them; the card's fused step
    # writes the clipped values back).
    grads = {n: p.grad.detach().cpu().numpy().copy()
             for n, p in model.named_parameters() if p.grad is not None}
    if state.shards:  # the shards' gradients, gathered over the model ranks
        names = {id(p): n for n, p in model.named_parameters()}
        mine = [(p, s) for p, s in state.shards if s.grad is not None]
        full = sharding.gather_shards([s.grad for _, s in mine], tp)
        grads.update({names[id(p)]: g.cpu().numpy() for (p, _), g in zip(mine, full)})
    full = full_state(state)
    return {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]), "grads": grads,
            "params": {n: p.detach().cpu().numpy() for n, p in model.named_parameters()},
            "ema": {n: full["ema"][n].numpy() for n, _ in model.named_parameters()},
            "moments": [{k: v.cpu().numpy() for k, v in e.items() if v.dim() >= 1}
                        for _, e in sorted(full["optim"]["state"].items())],
            "digests": _world(sp.state_digest(state), grid),
            "shard_digests": _world(sp.shard_digest(state) if state.shards else None, grid),
            "elements": _world(state_elements(state), grid),
            "launches": _world(kernel_launches(), grid),
            "fused_launches": _world(list(fused_optim.launches()), grid)}


def eval_nll(spec, raws, seed, pad_to=0, grid=None):
    """``trainer.evaluate_nll`` of ``spec``'s model over the raw batches
    ``raws`` (a list with the nominal ``batch_size``) with a generator seeded
    ``seed``. With no grid and ``pad_to``, the one-rank reference of a DP
    run: each batch padded to ``pad_to`` with weight-0 repeats, as the data
    ranks pad it, and weighted by its real count."""
    device = "cpu" if grid is None else grid.device
    seq, data = _groups(grid)
    cfg, model = _model(spec, device, seq)
    nodes = DistributionNodes(get_dataset_info(spec["dataset"]).n_nodes)
    eval_fn = make_eval_nll(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    if grid is None and pad_to:
        total, count = 0.0, 0
        for raw in raws:
            host = trainer.prepare_host(raw, nodes)
            b = len(host["x"])
            batch = trainer.to_device(trainer.pad_with_weight(host, pad_to), device)
            total += float(eval_fn(model, batch, gen)) * b
            count += b
        return total / count

    class Loader(list):
        batch_size = max(len(r["x"]) for r in raws)

    return trainer.evaluate_nll(model, eval_fn, Loader(raws), nodes, gen, prefetch=0,
                                data=data)


def sample(spec, seed, sizes, batch_size, prop_rows=None, grid=None):
    """``sampling.sample_bucketed`` of ``spec``'s model over ``sizes`` in
    chunks of ``batch_size`` (a conditional model draws its properties from
    a fixed property distribution built from ``prop_rows``) -> its four
    arrays and the numpy generator's next draw (the draws consumed)."""
    device = "cpu" if grid is None else grid.device
    _, data = _groups(grid)
    _, model = _model(spec, device, None)
    prop_dist, rng = None, np.random.default_rng(seed)
    if prop_rows is not None:
        from geoldm_tpu_torch.models.distributions import DistributionProperty

        n_atoms, values = prop_rows
        prop_dist = DistributionProperty(n_atoms, {"alpha": values})
        prop_dist.set_normalizer({"alpha": {"mean": float(values.mean()), "mad": 1.0}})
    out = sampling.sample_bucketed(model, seed, get_dataset_info(spec["dataset"]),
                                   np.asarray(sizes), batch_size=batch_size,
                                   prop_dist=prop_dist, rng=rng, data=data)
    return {"arrays": out, "rng_next": float(rng.random())}
