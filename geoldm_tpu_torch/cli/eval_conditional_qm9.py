"""Conditional-generation evaluation: the property classifier's MAE on
generated molecules (port of ``geoldm_tpu/cli/eval_conditional_qm9.py``;
reference eval_conditional_qm9.py).

- ``edm``: sample molecules from the conditional generator with properties
  drawn from the train split's property-given-size distribution and score
  the classifier against those targets (with ``--cfg_scale`` guidance,
  ``--clip_z`` and ``--nodes_from_data`` sizes);
- ``qm9``: the classifier on the train split's real molecules;
- ``naive``: the same with the labels shuffled;
- ``qualitative``: the property swept over its range at 19 atoms with the
  noise held fixed (``train.sampling.sample_sweep_conditional``), sampled on
  the device, written as a chain of xyz frames to
  ``<generators_path>/sweep_<property>`` and rendered to a GIF there; it
  needs matplotlib and imageio, and exits naming the one missing at
  argument checking.

The normalizers and distributions follow the second-half protocol
(``train.conditioning.load_conditional_protocol``). The generator loads
from ``<generators_path>/best`` (``args.pickle``, EMA weights), the
classifier from ``<classifiers_path>/best/classifier.npy``.

  python -m geoldm_tpu_torch.cli.eval_conditional_qm9 \\
      --generators_path outputs/cond_alpha --classifiers_path outputs/cls_alpha \\
      --property alpha --iterations 100 --batch_size 100 --task edm
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="geoldm-tpu-torch conditional eval")
    p.add_argument("--generators_path", type=str, required=False)
    p.add_argument("--classifiers_path", type=str, required=False)
    p.add_argument("--property", type=str, default="alpha",
                   choices=["alpha", "gap", "homo", "lumo", "mu", "Cv"])
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--task", type=str, default="edm",
                   choices=["edm", "qm9", "naive", "qualitative"])
    p.add_argument("--datadir", type=str, default="data")
    p.add_argument("--classifier_nf", type=int, default=128)
    p.add_argument("--classifier_layers", type=int, default=7)
    p.add_argument("--debug_break", action="store_true")
    p.add_argument("--nodes_from_data", action="store_true",
                   help="molecule sizes from the loaded train split's histogram instead of "
                        "the QM9 table")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg_scale", type=float, default=1.0,
                   help="classifier-free guidance scale for the edm task (1.0: the plain "
                        "conditional model; needs a generator trained with --context_dropout)")
    p.add_argument("--clip_z", type=float, default=0.0,
                   help="per-step dynamic-range guard on the sampler state (0: none)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def write_sweep(model, seed: int, dataset_info, prop_dist, sweep_dir: str, **kw) -> str:
    """The qualitative task's frames (``sample_sweep_conditional``, noise
    from ``seed``; ``kw`` goes to it) written as xyz files ``chain_<i>.txt``
    to ``sweep_dir`` -> ``sweep_dir``. Each frame holds the sweep's real
    atoms only, as the reference writes them with the node mask (JAX's CLI
    writes the padding too: ROADMAP §3)."""
    from geoldm_tpu_torch.evalsuite import visualizer as viz
    from geoldm_tpu_torch.train import sampling as sampling_mod

    one_hot, charges, x, node_mask = sampling_mod.sample_sweep_conditional(
        model, seed, dataset_info, prop_dist, **kw)
    n = int(node_mask[0].sum())  # every frame has the sweep's n_nodes atoms, padded after them
    viz.save_chain(sweep_dir, one_hot[:, :n].cpu().numpy(), charges[:, :n].cpu().numpy(),
                   x[:, :n].cpu().numpy(), dataset_info)
    return sweep_dir


def main(argv=None):
    """The mean MAE over the scored batches (float); for ``qualitative`` the
    sweep GIF's path."""
    args = parse_args(argv)
    from geoldm_tpu_torch.evalsuite import visualizer as viz

    if args.task == "qualitative":
        viz.require_renderer("--task qualitative")
    import numpy as np
    import torch

    from geoldm_tpu_torch.data.collate import build_masks
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.qm9 import QM9Loader
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train import sampling as sampling_mod
    from geoldm_tpu_torch.train.classifier_train import load_classifier
    from geoldm_tpu_torch.train.conditioning import load_conditional_protocol
    from geoldm_tpu_torch.utils.checkpoint import checkpoint_dir
    from geoldm_tpu_torch.utils.convert import load_reference_checkpoint
    from geoldm_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    info = get_dataset_info("qm9")
    prop = args.property
    rng = np.random.default_rng(args.seed)
    splits, norms, prop_dist, nodes_dist_data, pad_data = load_conditional_protocol(
        args.datadir, [prop])
    mean, mad = norms[prop]["mean"], norms[prop]["mad"]
    classifier = load_classifier(args.classifiers_path, args.classifier_nf,
                                 args.classifier_layers, device=device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

    @torch.no_grad()
    def mae(one_hot, x, node_mask, edge_mask, label):
        pred = classifier(t(one_hot), t(x), t(node_mask), t(edge_mask))
        return float((mad * pred + mean - t(label)).abs().mean())

    losses = []
    if args.task == "edm":
        model, _, _ = load_reference_checkpoint(checkpoint_dir(args.generators_path, "best"),
                                                device)
        if args.nodes_from_data:
            nodes_dist, pad_nodes = nodes_dist_data, pad_data
        else:
            nodes_dist, pad_nodes = DistributionNodes(info.n_nodes), None
        for it in range(args.iterations):
            nodesxsample = nodes_dist.sample(args.batch_size, rng)
            ctx_norm = prop_dist.sample_batch(nodesxsample, rng)  # normalized targets
            one_hot, _, x, node_mask = sampling_mod.sample(
                model, sampling_mod.chunk_generator(args.seed, it, device), info,
                nodesxsample, pad_nodes=pad_nodes, context=ctx_norm,
                guidance_scale=args.cfg_scale, clip_z=args.clip_z)
            _, edge_mask = build_masks(node_mask[..., 0].sum(1).astype(int), node_mask.shape[1])
            losses.append(mae(one_hot.cpu().numpy(), x.cpu().numpy(), node_mask, edge_mask,
                              ctx_norm[:, 0] * mad + mean))
            print(f"iter {it}: MAE {losses[-1]:.4f} (running {np.mean(losses):.4f})",
                  flush=True)
            if args.debug_break:
                break
    elif args.task == "qualitative":
        model, _, _ = load_reference_checkpoint(checkpoint_dir(args.generators_path, "best"),
                                                device)
        sweep_dir = write_sweep(model, args.seed, info, prop_dist,
                                f"{args.generators_path}/sweep_{prop}")
        gif = viz.visualize_chain(sweep_dir, info)
        print(f"sweep gif: {gif}", flush=True)
        return gif
    else:
        loader = QM9Loader(splits["train"], args.batch_size, info.max_n_nodes, shuffle=True,
                           properties=(prop,), seed=args.seed)
        for it, batch in enumerate(loader):
            if it >= args.iterations:
                break
            label = batch[prop]
            if args.task == "naive":
                label = rng.permutation(label)
            losses.append(mae(batch["h_cat"], batch["x"], batch["node_mask"],
                              batch["edge_mask"], label))
            if args.debug_break:
                break
    if not losses:
        raise RuntimeError(f"task {args.task!r} scored zero batches: check --iterations and "
                           "the split sizes")
    mean_mae = float(np.mean(losses))
    print(f"{args.task} MAE over {len(losses)} iterations: {mean_mae:.4f}", flush=True)
    return mean_mae


if __name__ == "__main__":
    main()
