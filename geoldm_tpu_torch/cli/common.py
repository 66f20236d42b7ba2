"""Training CLI plumbing (port of ``geoldm_tpu/cli/common.py:17-434``): the
reference flag surface (QM9 and GEOM-Drugs defaults), flags -> ModelConfig,
and the training run: on one device, data-parallel, sequence-parallel,
tensor-parallel, or data-parallel with either.

``--dp D`` splits the global ``--batch_size`` over D data ranks and averages
their gradients (``parallel.sharding``); ``--sp S`` splits every EGNN's atom
rows over S ranks (``parallel.sp``); ``--tp T`` shards every parameter of
``--nf`` width (JAX's ``param_shardings(hidden_nf=nf)`` rule), with its
AMSGrad moments and EMA, over T model ranks, which gather the full weights
after each update and run the same kernels on the same rows
(``train.train_step``); D x S or D x T ranks together (``--sp`` and ``--tp``
do not combine, as in JAX). ``--dp 0`` (the default) means every card,
divided by ``--sp`` or ``--tp``, as JAX's ``make_mesh(dp=0)``; 1 with
``--device cpu``. One command spawns the ranks,
with the placement rule of ``parallel.sharding``; every rank prepares the
same global batches, keeps its rows and draws its rows of the global noise,
so the replicas stay bit-identical; only global rank 0 prints and writes
checkpoints, ``args.pickle`` and ``metrics.jsonl``. ``--conditioning``
trains a QM9 model conditioned on properties (also under ``--sp``), and
``--context_dropout`` p nulls a molecule's context with probability p per
step, for classifier-free guidance at sampling time (``vdm.guided_eps``). A
run
resumes from its ``latest/`` checkpoint (``--resume``, with the
checkpoint's model config) and a latent-diffusion run can start from a
trained first stage (``--ae_path``). ``--eval_n_steps`` K runs the periodic
stability samples as K-step DDIM jumps. ``--compute_dtype`` takes JAX's
four training choices: ``float32`` / ``pallas`` (f32 kernels) and
``bfloat16`` / ``bfloat16_pallas`` (the bf16 forward and backward kernels;
the eval NLL and stability samples run in it too, as JAX's do). Every model
variant trains: ``--diffusion_noise_schedule learned`` (with
``--diffusion_loss_type vlb``, as JAX's ``vdm_init`` requires; its log-SNR
range is printed and logged each epoch), ``--model gnn_dynamics``, and,
through ``--resume`` of its checkpoint, the plain E(n) diffusion model (JAX's
CLI builds only the VAE and the latent model from flags, and lets a
checkpoint's config win). ``--visualize True`` writes, at each stability
evaluation, a chain and 9 molecules sampled on the device as xyz files under
``<outdir>/<exp_name>/epoch_<e>/`` and renders them (``visualize_epoch``);
it needs matplotlib and imageio, and exits naming the one missing at
argument checking. ``--trace DIR`` profiles each epoch's train loop with
``torch.profiler`` (the card's kernels and the host) and writes one Chrome
trace a rank and epoch, ``DIR/trace_epoch<e>_rank<r>.json`` (JAX's
``jax.profiler`` trace per epoch); ``--visualize_every_batch`` is accepted
and unused, as in JAX. ``GEOLDM_PALLAS_EDGE_LOWP=1`` in the environment
runs ``--compute_dtype bfloat16_pallas`` with the whole-molecule blocks'
edge chain in bf16 (``nn.core``). Every flag of JAX's training CLIs is
ported.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os

import numpy as np


def add_model_args(p: argparse.ArgumentParser, qm9_defaults: bool = True) -> None:
    """The flags of the JAX CLI (reference main_qm9.py:23-133,
    main_geom_drugs.py:25-131), with the QM9 or the GEOM-Drugs defaults."""
    d = {"n_layers": 9, "lr": 1e-4, "batch_size": 64, "latent_nf": 1} if qm9_defaults else \
        {"n_layers": 4, "lr": 5e-5, "batch_size": 32, "latent_nf": 2}
    p.add_argument("--exp_name", type=str, default="geoldm_tpu_run")
    p.add_argument("--model", type=str, default="egnn_dynamics",
                   choices=["egnn_dynamics", "gnn_dynamics"])
    p.add_argument("--probabilistic_model", type=str, default="diffusion")
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--diffusion_noise_schedule", type=str, default="polynomial_2")
    p.add_argument("--diffusion_noise_precision", type=float, default=1e-5)
    p.add_argument("--diffusion_loss_type", type=str, default="l2", choices=["vlb", "l2"])
    p.add_argument("--n_epochs", type=int, default=3000)
    p.add_argument("--batch_size", type=int, default=d["batch_size"])
    p.add_argument("--lr", type=float, default=d["lr"])
    p.add_argument("--break_train_epoch", type=eval, default=False)
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ranks, each taking batch_size / dp molecules of every "
                        "batch (0: every card, divided by --sp)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks: each owns 1/tp of every --nf-wide parameter "
                        "with its optimizer state and EMA (--nf must divide by it)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks: split the EGNN's O(N^2) pair grid over atom "
                        "rows (pays off at GEOM-scale molecules)")
    p.add_argument("--condition_time", type=eval, default=True)
    p.add_argument("--clip_grad", type=eval, default=True)
    p.add_argument("--trace", type=str, default=None,
                   help="torch.profiler trace directory: one Chrome trace a rank and epoch of "
                        "the train loop")
    p.add_argument("--n_layers", type=int, default=d["n_layers"])
    p.add_argument("--inv_sublayers", type=int, default=1)
    p.add_argument("--nf", type=int, default=256)
    p.add_argument("--tanh", type=eval, default=True)
    p.add_argument("--attention", type=eval, default=True)
    p.add_argument("--norm_constant", type=float, default=1.0)
    p.add_argument("--sin_embedding", type=eval, default=False)
    p.add_argument("--remat", type=eval, default=None,
                   help="JAX-side option; the port's backward always recomputes each block")
    p.add_argument("--ode_regularization", type=float, default=1e-3)
    p.add_argument("--trainable_ae", action="store_true")
    p.add_argument("--latent_nf", type=int, default=d["latent_nf"])
    p.add_argument("--kl_weight", type=float, default=0.01)
    p.add_argument("--ae_path", type=str, default=None)
    p.add_argument("--train_diffusion", action="store_true",
                   help="train the latent diffusion (else: train the VAE)")
    p.add_argument("--dequantization", type=str, default="argmax_variational")
    p.add_argument("--n_report_steps", type=int, default=50)
    p.add_argument("--no_wandb", action="store_true")
    p.add_argument("--online", type=eval, default=True)
    p.add_argument("--wandb_usr", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test_epochs", type=int, default=10)
    p.add_argument("--save_model", type=eval, default=True)
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--augment_noise", type=float, default=0.0)
    p.add_argument("--context_dropout", type=float, default=0.0,
                   help="classifier-free guidance training: probability of nulling a "
                        "molecule's conditioning context per step (enables --cfg_scale at "
                        "sampling time)")
    p.add_argument("--n_stability_samples", type=int, default=500)
    p.add_argument("--eval_n_steps", type=int, default=None,
                   help="few-step DDIM sampling for the periodic stability analysis only")
    p.add_argument("--normalize_factors", type=eval, default=[1, 4, 10])
    # True for QM9 (main_qm9.py:125), False for GEOM (main_geom_drugs.py:121).
    p.add_argument("--include_charges", type=eval, default=qm9_defaults)
    p.add_argument("--visualize_every_batch", type=int, default=int(1e8))
    p.add_argument("--visualize", type=eval, default=False,
                   help="write and render a chain and 9 molecules at each stability evaluation "
                        "(needs matplotlib and imageio)")
    p.add_argument("--normalization_factor", type=float, default=1.0)
    p.add_argument("--aggregation_method", type=str, default="sum")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16", "pallas", "bfloat16_pallas"])
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--data_augmentation", type=eval, default=False)
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches prepared ahead on a host thread (0: serial)")
    p.add_argument("--conditioning", nargs="+", default=[],
                   help="properties to condition on: alpha gap homo lumo mu Cv")
    p.add_argument("--outdir", type=str, default="outputs")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu, which runs the plain PyTorch path")


def resolve_dp(args) -> int:
    """The data-parallel width the flags ask for: ``--dp``, or with ``--dp
    0`` every card divided by ``--sp`` or ``--tp``, as JAX's
    ``make_mesh(dp=0)`` (``n_dev // tp``) and ``max(1, n_dev // sp)`` (1 on
    the CPU and on one card)."""
    if args.dp <= 0:
        import torch

        n_dev = torch.cuda.device_count() if args.device != "cpu" else 1
        return max(1, n_dev // (max(args.sp, 1) * max(args.tp, 1)))
    return args.dp


@contextlib.contextmanager
def epoch_trace(trace_dir, epoch: int, rank: int, device):
    """``--trace``: the block under ``torch.profiler`` (the host's activity,
    and the card's when ``device`` is CUDA, with the program's ``geoldm.*``
    spans), written as a Chrome trace to
    ``trace_dir/trace_epoch<epoch>_rank<rank>.json``; nothing without a
    directory. The in-memory spans and counters (``utils.spans``) are
    cleared as each epoch's trace opens, so they hold the last epoch's."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from geoldm_tpu_torch.utils import spans

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    spans.clear()
    with profile(activities=acts) as prof:
        yield
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_epoch{epoch}_rank{rank}.json"))


def _check_tp(args) -> None:
    """``--nf`` must split evenly over ``--tp`` model ranks (JAX's
    ``device_put`` fails later on an uneven shard)."""
    if args.tp > 1 and args.nf % args.tp:
        raise SystemExit(f"--tp {args.tp} shards every --nf-wide parameter over {args.tp} "
                         f"model ranks, but --nf {args.nf} does not divide by {args.tp}")


def check_ported(args) -> None:
    """Exit with a message for any combination of flags the run refuses, at
    argument checking."""
    if args.sp > 1 and args.tp > 1:
        raise SystemExit("--sp and --tp cannot be combined")
    if args.tp < 1:
        raise SystemExit(f"--tp {args.tp}: the model ranks must be at least 1")
    _check_tp(args)
    dp = resolve_dp(args)
    if dp > args.batch_size:
        # JAX's train_epoch raises on an epoch of batches the data axis
        # cannot split; nothing falls back to fewer ranks.
        raise SystemExit(f"--dp {dp} splits every batch over {dp} data ranks, but "
                         f"--batch_size is {args.batch_size}")
    if args.visualize:
        from geoldm_tpu_torch.evalsuite.visualizer import require_renderer

        require_renderer("--visualize")
    if (args.train_diffusion and args.diffusion_noise_schedule == "learned"
            and args.diffusion_loss_type != "vlb"):
        # JAX's vdm_init asserts it (geoldm_tpu/diffusion/vdm.py:45-46).
        raise SystemExit("learned schedule requires vlb loss")


def build_model_config(args, dataset_info):
    from geoldm_tpu_torch.models import factory

    common = dict(
        include_charges=args.include_charges, context_node_nf=len(args.conditioning),
        # CFG training tells its null from a mean property by a trailing
        # is-conditioned channel (config.ModelConfig).
        context_indicator=bool(args.conditioning and args.context_dropout > 0),
        nf=args.nf, n_layers=args.n_layers,
        attention=args.attention, tanh=args.tanh, norm_constant=args.norm_constant,
        inv_sublayers=args.inv_sublayers, sin_embedding=args.sin_embedding,
        normalization_factor=args.normalization_factor,
        aggregation_method=args.aggregation_method,
    )
    if args.train_diffusion:
        return factory.make_latent_diffusion_config(
            dataset_info, latent_nf=args.latent_nf, kl_weight=args.kl_weight,
            trainable_ae=args.trainable_ae, diffusion_steps=args.diffusion_steps,
            noise_schedule=args.diffusion_noise_schedule,
            noise_precision=args.diffusion_noise_precision,
            loss_type=args.diffusion_loss_type,
            normalize_factors=tuple(float(v) for v in args.normalize_factors),
            model=args.model, condition_time=args.condition_time, **common)
    return factory.make_vae_config(dataset_info, latent_nf=args.latent_nf,
                                   kl_weight=args.kl_weight, **common)


def _generator(device, seed: int, *stream) -> "torch.Generator":
    """A device generator for one purpose of one epoch, seeded from
    (seed, *stream) so that a seeded run replays."""
    import torch

    state = np.random.SeedSequence([int(seed) % 2**64, *stream]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def visualize_epoch(model, epoch_dir: str, seed: int, dataset_info, nodes_dist,
                    rng: np.random.Generator, compute_dtype=None, prop_dist=None,
                    render: bool = True) -> dict:
    """Training's ``--visualize`` (``geoldm_tpu/cli/common.py:378-406``,
    reference train_test.py:152-174): a chain (``sampling.sample_chain``,
    noise from ``seed``) and 9 molecules with sizes from ``nodes_dist`` (noise
    from ``seed`` + 1), sampled on the model's device, written as xyz files
    to ``<epoch_dir>/chain`` and ``<epoch_dir>/molecules``, then rendered to
    the chain's GIF and a PNG per molecule unless ``render`` is False ->
    {"chain_frames", "molecules" (xyz paths), "gif", "pngs"}."""
    from geoldm_tpu_torch.evalsuite import visualizer as viz
    from geoldm_tpu_torch.train import sampling as sampling_mod

    chain_dir, mol_dir = os.path.join(epoch_dir, "chain"), os.path.join(epoch_dir, "molecules")
    ch_oh, ch_ch, ch_x = sampling_mod.sample_chain(model, seed, dataset_info, n_tries=1,
                                                   compute_dtype=compute_dtype,
                                                   prop_dist=prop_dist, rng=rng)
    viz.save_chain(chain_dir, ch_oh, ch_ch, ch_x, dataset_info)
    device = next(model.parameters()).device
    oh, ch, xs, nm = sampling_mod.sample(
        model, sampling_mod.chunk_generator(seed + 1, 0, device), dataset_info,
        nodes_dist.sample(9, rng), prop_dist=prop_dist, rng=rng, compute_dtype=compute_dtype)
    files = viz.save_xyz_file(mol_dir, oh.cpu().numpy(), ch.cpu().numpy(), xs.cpu().numpy(),
                              dataset_info, node_mask=nm)
    out = {"chain_frames": len(ch_x), "molecules": files, "gif": None, "pngs": []}
    if render:
        out["gif"] = viz.visualize_chain(chain_dir, dataset_info)
        out["pngs"] = viz.visualize(mol_dir, dataset_info)
    return out


def launch(args, train_fn):
    """``train_fn(args, None)``, or with D = ``resolve_dp(args)``, S =
    ``--sp`` and T = ``--tp`` over D*S*T > 1 ranks ``train_fn(args, grid)``
    in each spawned rank (``parallel.sharding.spawn``), returning rank 0's
    summary. ``train_fn`` is a module-level function (the ranks import
    it)."""
    dp = resolve_dp(args)
    if dp * args.sp * args.tp > 1:
        from geoldm_tpu_torch.parallel import sharding

        return sharding.spawn(dp, args.sp, train_fn, (args,), device=args.device, tp=args.tp)
    return train_fn(args, None)


def run_training(args, dataset_info, splits, loaders=None, grid=None) -> dict:
    """Train, evaluate and checkpoint (common.py:159-434). ``loaders``
    replaces the QM9Loaders built from ``splits`` (the GEOM entry point
    passes GeomLoaders); each must agree with the model on the charge
    channel. Returns a summary: per-epoch losses and seconds, valid/test
    NLLs, stability, the validity triples and the sizes sampled for it, the
    checkpoint directories written, the final train state and, on
    ``--resume``, ``resumed``: a CPU copy of the state as loaded (model, EMA,
    AdamW, clip, step).

    With ``--conditioning`` (QM9 splits only) each batch carries the
    normalized properties as context (norms from the split
    ``conditioning.compute_mean_mad`` names), and the stability samples draw
    them from the train split's ``DistributionProperty``; ``args.pickle``
    records ``context_node_nf`` and ``context_indicator``.

    With ``--resume`` the model config comes from the checkpoint's
    ``args.pickle`` and wins over the flags (JAX's rule), and the state from
    ``<resume>/latest``; per-epoch device noise comes from (seed, epoch), so
    ``--start_epoch k`` draws what an uninterrupted run draws in epoch k.
    With ``--ae_path`` (latent diffusion) the first stage's ``best/`` weights
    (EMA when training with EMA) replace the model's and the EMA model's
    ``vae`` before the first step; a resume then overrides them.

    With ``grid`` (a ``parallel.sharding.Grid``) this is one rank of a
    data-, sequence- or tensor-parallel run: the model's EGNNs run over the
    grid's SP group (train steps and valid/test NLL), each data rank takes
    its rows of every batch and of the noise, and the stability samples run
    on the single-device route, their chunks fanned out over the data ranks
    (as the JAX CLI samples without SP and over its data axis; the model
    ranks of a data row repeat them, as JAX's batch is replicated over
    ``model``); only global rank 0 writes checkpoints and metrics. Every
    rank loads the same checkpoints (under TP, keeping its rows). Under TP
    every rank gathers the EMA model before each evaluation and joins each
    save's gathers. The summary then holds, in place of the train state,
    ``replicas``: per rank (all D*S or D*T of them) its train-state digest
    (of the gathered state, and the one it resumed from), kernel launch
    counts (the fused optimizer step's apart), stability and sampled sizes,
    and under TP its shard digest and its elements of optimizer and EMA
    state."""
    import torch

    from geoldm_tpu_torch.data.qm9 import QM9Loader
    from geoldm_tpu_torch.models import factory
    from geoldm_tpu_torch.models.distributions import DistributionNodes, DistributionProperty
    from geoldm_tpu_torch.ops import fused_optim, kernel_launches
    from geoldm_tpu_torch.parallel import sp
    from geoldm_tpu_torch.train import conditioning as cond
    from geoldm_tpu_torch.train import trainer as trainer_mod
    from geoldm_tpu_torch.train.train_step import (
        create_train_state,
        ema_module,
        make_eval_nll,
        make_train_step,
        state_elements,
    )
    from geoldm_tpu_torch.utils import checkpoint as ckpt
    from geoldm_tpu_torch.utils.convert import MODEL_ARGS
    from geoldm_tpu_torch.utils.logging_utils import MetricLogger

    check_ported(args)
    model_cfg = build_model_config(args, dataset_info)
    if args.resume:
        resume_dir = ckpt.checkpoint_dir(args.resume, "latest")
        resumed_cfg = ckpt.load_model_config(resume_dir)
        if resumed_cfg != model_cfg:
            print("resume: using the checkpoint's model config (overrides CLI)", flush=True)
            model_cfg = resumed_cfg
            # The checkpoints this run writes pickle ``args``: give them the
            # resumed model's fields, so that they load as the model they hold.
            args = copy.copy(args)
            saved = ckpt.load_args(resume_dir)
            for name in MODEL_ARGS:
                if hasattr(saved, name):
                    setattr(args, name, getattr(saved, name))
            if model_cfg.kind == "diffusion":
                del args.train_diffusion  # EDM's args shape (utils.convert.checkpoint_kind)
            _check_tp(args)  # --tp is the run's; the width is the checkpoint's
    conditioning = list(args.conditioning)
    n_props = cond.property_channels(model_cfg)
    if n_props != len(conditioning):
        raise SystemExit(f"the model has {n_props} property channel(s) but --conditioning names "
                         f"{len(conditioning)}: {conditioning}")
    if conditioning and splits is None:
        raise SystemExit("--conditioning needs the QM9 splits' property arrays")
    # The checkpoints' args.pickle: the context width as upstream writes it,
    # and the indicator channel upstream lacks (utils.convert).
    args.context_node_nf = n_props
    args.context_indicator = model_cfg.context_indicator
    sp_group = grid.seq if grid is not None else None
    data = grid.data if grid is not None else None
    model_group = grid.model if grid is not None else None
    device = grid.device if grid is not None else args.device
    model = factory.build_model(model_cfg, device, torch.Generator().manual_seed(args.seed),
                                sp_group=sp_group)
    device = next(model.parameters()).device
    is_main = grid is None or grid.is_main
    if args.ae_path and model_cfg.kind == "latent_diffusion":
        # Before the train state, whose EMA starts as a copy of the model.
        model.vae.load_state_dict(ckpt.load_first_stage(args.ae_path,
                                                        use_ema=args.ema_decay > 0), strict=True)
        print(f"first stage loaded from {args.ae_path}", flush=True)
    state = create_train_state(model, model_cfg, args.lr, clip_grad=args.clip_grad,
                               ema_decay=args.ema_decay, dp_group=data,
                               model_group=model_group, hidden_nf=args.nf)
    summary = {"losses": [], "epoch_seconds": [], "nll_val": [], "nll_test": [],
               "stability": [], "rdkit": [], "sample_sizes": [], "checkpoints": [],
               "visualized": [], "state": state}
    if args.resume:
        ckpt.load_train_state(resume_dir, state)
        summary["resumed"] = ckpt.full_state(state)
        if grid is not None:
            summary["resumed_digest"] = sp.state_digest(state)
        print(f"resumed from {args.resume} at step {state.step}", flush=True)
    # JAX's rule (geoldm_tpu/cli/common.py:209-212, :326-330, :373): the
    # flag's name goes to the train step, the eval NLL and the stability
    # samples, each resolving it (nn.core.resolve_compute).
    train_step = make_train_step(model_cfg, args.ema_decay, args.compute_dtype,
                                 args.context_dropout if conditioning else 0.0)
    eval_nll = make_eval_nll(model_cfg, args.compute_dtype)
    learned = model_cfg.kind != "vae" and model_cfg.diffusion.noise_schedule == "learned"
    if model_cfg.kind != "vae":
        from geoldm_tpu_torch.diffusion.vdm import log_info

        print(f"schedule: {log_info(state.model.gamma)}", flush=True)
    include_charges = model_cfg.include_charges
    if loaders is None:
        loaders = {split: QM9Loader(data, batch_size=args.batch_size,
                                    pad_nodes=dataset_info.max_n_nodes, shuffle=split == "train",
                                    include_charges=include_charges,
                                    properties=tuple(conditioning), seed=args.seed)
                   for split, data in splits.items()}
    for split, loader in loaders.items():
        if loader.include_charges != include_charges:
            raise ValueError(f"{split} loader include_charges={loader.include_charges} but the "
                             f"model expects {include_charges}; rebuild the loaders with "
                             f"--include_charges {include_charges}")
    nodes_dist = DistributionNodes(dataset_info.n_nodes)
    prop_dist = property_norms = None
    if conditioning:
        property_norms = cond.compute_mean_mad(splits, conditioning, args.dataset)
        prop_dist = DistributionProperty(splits["train"]["num_atoms"],
                                         {k: splits["train"][k] for k in conditioning})
        prop_dist.set_normalizer(property_norms)
    cond_kw = dict(conditioning=conditioning, property_norms=property_norms,
                   context_indicator=model_cfg.context_indicator)
    outdir = os.path.join(args.outdir, args.exp_name)
    logger = MetricLogger(outdir=outdir if is_main else None,
                          use_wandb=is_main and not args.no_wandb, exp_name=args.exp_name,
                          online=args.online)
    best_nll_val = float("inf")
    rng = np.random.default_rng(args.seed)
    try:
        for epoch in range(args.start_epoch, args.n_epochs):
            with epoch_trace(args.trace, epoch, grid.rank if grid is not None else 0, device):
                losses, seconds = trainer_mod.train_epoch(
                    state, train_step, loaders["train"], nodes_dist,
                    _generator(device, args.seed, 0, epoch), epoch,
                    augment_noise=args.augment_noise, data_augmentation=args.data_augmentation,
                    break_train_epoch=args.break_train_epoch, log_every=args.n_report_steps,
                    rng=rng, logger=logger, prefetch=args.prefetch, data=data, **cond_kw)
            summary["losses"].append(losses)
            summary["epoch_seconds"].append(seconds)
            record = {"train_loss_epoch": float(np.mean(losses))}
            if learned:  # the learned schedule's log-SNR range as it trains
                record.update(log_info(state.model.gamma))
            logger.log(record, step=epoch)
            if epoch % args.test_epochs:
                continue
            # Every rank: under --tp the EMA is gathered over the model ranks.
            eval_model = ema_module(state)
            if model_cfg.kind != "vae":
                with sp.detached(eval_model):  # SP or not, the samples run on one device
                    validity, rdkit_tuple, molecules = trainer_mod.analyze_and_save(
                        eval_model, args.seed * 1000 + epoch, dataset_info, nodes_dist,
                        n_samples=args.n_stability_samples, rng=rng,
                        datadir=args.datadir, n_steps=args.eval_n_steps,
                        compute_dtype=args.compute_dtype, prop_dist=prop_dist, data=data)
                print(f"epoch {epoch} stability: {validity}", flush=True)
                if rdkit_tuple is not None:
                    v, u, n = rdkit_tuple[0]
                    print(f"epoch {epoch} validity {v:.4f} uniqueness {u:.4f} novelty {n:.4f}",
                          flush=True)
                logger.log(validity, step=epoch)
                summary["stability"].append(validity)
                if args.visualize and is_main:
                    # Rank 0 alone samples and writes, from its own numpy
                    # generator: the shared ``rng`` stays in step on every rank.
                    with sp.detached(eval_model):
                        summary["visualized"].append(visualize_epoch(
                            eval_model, os.path.join(outdir, f"epoch_{epoch}"),
                            args.seed * 1000 + epoch + 500, dataset_info, nodes_dist,
                            np.random.default_rng([args.seed, epoch]), args.compute_dtype,
                            prop_dist))
                summary["rdkit"].append(None if rdkit_tuple is None else rdkit_tuple[0])
                summary["sample_sizes"].append(molecules["n_atoms"])
            nll_val = trainer_mod.evaluate_nll(
                eval_model, eval_nll, loaders["valid"], nodes_dist,
                _generator(device, args.seed, 1, epoch), partition="valid",
                augment_noise=args.augment_noise, rng=rng, prefetch=args.prefetch, data=data,
                **cond_kw)
            logger.log({"nll_val": nll_val}, step=epoch)
            summary["nll_val"].append(nll_val)
            # Every rank saves (under --tp it joins the gathers); rank 0 writes.
            if args.save_model:
                args.current_epoch = epoch + 1
                path = ckpt.save_checkpoint(os.path.join(outdir, "latest"), state, args,
                                            args.ema_decay, write=is_main)
                summary["checkpoints"] += [path] if is_main else []
            if nll_val < best_nll_val and args.save_model:
                best_nll_val = nll_val
                path = ckpt.save_checkpoint(os.path.join(outdir, "best"), state, args,
                                            args.ema_decay, write=is_main)
                summary["checkpoints"] += [path] if is_main else []
                nll_test = trainer_mod.evaluate_nll(
                    eval_model, eval_nll, loaders["test"], nodes_dist,
                    _generator(device, args.seed, 2, epoch), partition="test",
                    augment_noise=args.augment_noise, rng=rng, prefetch=args.prefetch,
                    data=data, **cond_kw)
                logger.log({"nll_test": nll_test, "best_nll_val": best_nll_val}, step=epoch)
                summary["nll_test"].append(nll_test)
                print(f"best valid NLL {best_nll_val:.4f}, test NLL {nll_test:.4f}", flush=True)
            del eval_model
    finally:
        logger.close()
    if grid is not None:
        import torch.distributed as dist

        replica = {"rank": grid.rank, "digest": sp.state_digest(state),
                   "launches": kernel_launches(), "fused_launches": fused_optim.launches(),
                   "stability": summary["stability"],
                   "sample_sizes": [np.asarray(s).tolist() for s in summary["sample_sizes"]]}
        if state.model_group is not None:
            replica["shard_digest"] = sp.shard_digest(state)
            replica["state_elements"] = state_elements(state)
        if "resumed_digest" in summary:
            replica["resumed_digest"] = summary["resumed_digest"]
        replicas = [None] * dist.get_world_size()
        dist.all_gather_object(replicas, replica)
        summary["replicas"] = replicas
        del summary["state"]
    return summary
