"""Sample molecules of a generative checkpoint (latent or plain diffusion)
for inspection on the card (port of ``geoldm_tpu/cli/eval_sample.py``): (a) ``--n_samples`` molecules, (b) up to
``--n_stable`` stable ones (2x oversampling), (c) ``--n_chains`` chains of
the dense reverse diffusion, retried up to ``--n_tries`` times for a stable
final molecule. Each is written as xyz-style text files
(``<outdir>/molecules/molecule_000.txt``, ``stable_molecules/``,
``chain_<c>/chain_000.txt`` ...; the reference's format, qm9/visualizer.py)
and as one ``.npz`` (one_hot, charges, x, node_mask or the chain's frames).

  python -m geoldm_tpu_torch.cli.eval_sample --model_path outputs/qm9_ldm \\
      [--n_steps 50 --sampler dpm2m]

``--model_path`` is an upstream-layout checkpoint directory or a run
directory whose ``best/`` is one; ``--outdir`` defaults to
``<model_path>/eval``. Molecules are padded to the dataset's largest size and
sampled in float32, as the JAX CLI samples them; the molecule set and the
stable set take the few-step settings, chains always run the dense sampler.
Try k of a chain and call k of the sets draw from generators seeded from
(``--seed``, k). ``--render True`` draws the files as the JAX CLI does
(``evalsuite.visualizer``): a PNG beside each molecule's file and a GIF per
chain, its frames three consecutive states overlaid (``--chain_uncertainty``,
the default) or one state each; it needs matplotlib and imageio and exits
naming the one missing at argument checking. ``--device cpu`` runs the
plain PyTorch path on the CPU.
"""

from __future__ import annotations

import argparse
import itertools
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="geoldm-tpu-torch sampling for inspection")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--n_samples", type=int, default=30)
    p.add_argument("--n_stable", type=int, default=10)
    p.add_argument("--n_chains", type=int, default=1)
    p.add_argument("--keep_frames", type=int, default=100)
    p.add_argument("--n_tries", type=int, default=10)
    p.add_argument("--dataset", type=str, default="qm9")
    p.add_argument("--remove_h", action="store_true")
    p.add_argument("--outdir", type=str, default=None)
    p.add_argument("--use_ema", type=eval, default=True)
    p.add_argument("--n_steps", type=int, default=None,
                   help="few-step sampling for the molecule set and the stable set "
                        "(chains always run dense)")
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--sampler", type=str, default="ddim", choices=["ddim", "dpm2m"])
    p.add_argument("--render", type=eval, default=False,
                   help="render a PNG per molecule and a GIF per chain (needs matplotlib and "
                        "imageio)")
    p.add_argument("--chain_uncertainty", type=eval, default=True,
                   help="render chain GIFs as 3-frame alpha overlays like the reference's "
                        "eval_sample (False: plain frames)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu, which runs the plain PyTorch path")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Sample and write; returns {"molecules": n, "stable": found, "chains":
    [frames per chain], "outdir": ..., "sample_calls": sampler calls of the
    two sets, "rendered": {"pngs": n, "gifs": [...]}}."""
    args = parse_args(argv)
    from geoldm_tpu_torch.evalsuite import visualizer as viz

    if args.render:
        viz.require_renderer("--render")
    import numpy as np

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.evalsuite.analyze import check_stability
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train import sampling as sampling_mod
    from geoldm_tpu_torch.utils.checkpoint import checkpoint_dir
    from geoldm_tpu_torch.utils.convert import load_reference_checkpoint

    model, model_cfg, _ = load_reference_checkpoint(checkpoint_dir(args.model_path, "best"),
                                                    args.device, use_ema=args.use_ema)
    if model_cfg.kind == "vae":
        raise SystemExit(f"{args.model_path} holds a 'vae' model; eval_sample samples "
                         "generative checkpoints (latent or plain diffusion)")
    dataset_info = get_dataset_info(args.dataset, args.remove_h)
    nodes_dist = DistributionNodes(dataset_info.n_nodes)
    outdir = args.outdir or os.path.join(args.model_path, "eval")
    rng = np.random.default_rng(args.seed)
    settings = dict(n_steps=args.n_steps, eta=args.eta, method=args.sampler)
    device = next(model.parameters()).device
    calls = itertools.count()

    def generate(n):
        gen = sampling_mod.chunk_generator(args.seed, next(calls), device)
        out = sampling_mod.sample(model, gen, dataset_info, nodes_dist.sample(n, rng),
                                  **settings)
        return [a.cpu().numpy() if hasattr(a, "cpu") else a for a in out]

    # (a) the molecule set.
    one_hot, charges, x, node_mask = generate(args.n_samples)
    grid_dir = os.path.join(outdir, "molecules")
    viz.save_xyz_file(grid_dir, one_hot, charges, x, dataset_info, node_mask=node_mask)
    np.savez(os.path.join(grid_dir, "molecules.npz"), one_hot=one_hot, charges=charges, x=x,
             node_mask=node_mask)
    print(f"saved {args.n_samples} molecules to {grid_dir}")

    # (b) stable molecules, 2x oversampling (reference eval_sample.py:62-93).
    stable_dir = os.path.join(outdir, "stable_molecules")
    found, kept = 0, []
    for _ in range(2 * args.n_stable // max(args.n_samples, 1) + 2):
        if found >= args.n_stable:
            break
        one_hot, charges, x, node_mask = generate(args.n_samples)
        for i in range(len(x)):
            n = int(node_mask[i, :, 0].sum())
            if check_stability(x[i, :n], np.argmax(one_hot[i, :n], axis=1), dataset_info)[0]:
                viz.save_xyz_file(stable_dir, one_hot[i:i + 1], charges[i:i + 1], x[i:i + 1],
                                  dataset_info, id_from=found, node_mask=node_mask[i:i + 1])
                kept.append((one_hot[i], charges[i], x[i], node_mask[i]))
                found += 1
                if found >= args.n_stable:
                    break
    if kept:
        np.savez(os.path.join(stable_dir, "stable_molecules.npz"),
                 **{k: np.stack(v) for k, v in zip(("one_hot", "charges", "x", "node_mask"),
                                                    zip(*kept))})
    print(f"saved {found} stable molecules to {stable_dir}")

    # (c) chains of the dense sampler.
    chains = []
    for c in range(args.n_chains):
        chain_oh, chain_ch, chain_x = sampling_mod.sample_chain(
            model, args.seed * 1000 + c, dataset_info, n_tries=args.n_tries,
            keep_frames=args.keep_frames)
        chain_dir = os.path.join(outdir, f"chain_{c}")
        viz.save_chain(chain_dir, chain_oh, chain_ch, chain_x, dataset_info)
        np.savez(os.path.join(chain_dir, "chain.npz"), one_hot=chain_oh, charges=chain_ch,
                 x=chain_x)
        chains.append(len(chain_x))
        print(f"saved a chain of {len(chain_x)} frames to {chain_dir}")
    rendered = {"pngs": 0, "gifs": []}
    if args.render:  # on the host, from the files written above
        rendered["pngs"] += len(viz.visualize(grid_dir, dataset_info, max_num=args.n_samples))
        if found:
            rendered["pngs"] += len(viz.visualize(stable_dir, dataset_info,
                                                  max_num=args.n_stable))
        for c in range(args.n_chains):
            chain_dir = os.path.join(outdir, f"chain_{c}")
            # The reference's eval_sample draws chains as 3-frame alpha
            # overlays: sampling uncertainty shows as ghosting.
            render_chain = (viz.visualize_chain_uncertainty if args.chain_uncertainty
                            else viz.visualize_chain)
            rendered["gifs"].append(render_chain(chain_dir, dataset_info))
            print(f"chain gif: {rendered['gifs'][-1]}")
        print(f"rendered {rendered['pngs']} molecule pictures and {len(rendered['gifs'])} "
              "chain GIFs")
    return {"molecules": args.n_samples, "stable": found, "chains": chains, "outdir": outdir,
            "sample_calls": next(calls), "rendered": rendered}


if __name__ == "__main__":
    main()
