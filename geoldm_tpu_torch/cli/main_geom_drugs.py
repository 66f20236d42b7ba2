"""Train GeoLDM on GEOM-Drugs on the card (port of
``geoldm_tpu/cli/main_geom_drugs.py``): the first-stage VAE by default,
latent diffusion with ``--train_diffusion``.

  # The reference recipe (README.md:98-99): bs 32, nf 256, 4 layers,
  # latent_nf 2, no charges, lr 5e-5 (the GEOM defaults of the flags):
  python -m geoldm_tpu_torch.cli.main_geom_drugs --exp_name geom_ldm \\
      --datadir data/geom --train_diffusion --trainable_ae

``--datadir`` holds ``geom_drugs_{[no_h_]conformations}.npy`` (rows of
mol_id, atomic number, x, y, z) and ``geom_permutation.npy`` (no extraction
here; ``data.synthetic.write_geom_conformers`` fabricates a file). Batches
are padded to the size buckets of ``data.geom.DEFAULT_BUCKETS``; blocks
padded past 64 atoms run the row-tiled kernels. ``--dp D`` splits every
batch over D spawned data ranks (``parallel.sharding``; the default 0 takes
every card), ``--sp S`` every EGNN's atom rows over S ranks (kernels #6 and
#7; ``parallel.sp``), both together a D x S grid; ``--tp T`` shards every
``--nf``-wide parameter, with its optimizer state and EMA, over T model
ranks (a D x T grid with ``--dp``); the command prints where the ranks run.
``--device cpu`` runs the plain PyTorch path on the CPU (with ``--dp``,
``--sp`` or ``--tp``, gloo ranks on the CPU). Checkpoints go to
``<outdir>/<exp_name>/{latest,best}/`` in the upstream layout with
``dataset='geom'``, which ``cli.serve --dataset geom`` loads.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    from geoldm_tpu_torch.cli.common import add_model_args

    p = argparse.ArgumentParser(description="geoldm-tpu-torch GEOM-Drugs training")
    add_model_args(p, qm9_defaults=False)
    p.add_argument("--dataset", type=str, default="geom")
    p.add_argument("--datadir", type=str, default="data/geom")
    p.add_argument("--conformations", type=int, default=30)
    p.add_argument("--remove_h", action="store_true")
    p.add_argument("--filter_molecule_size", type=int, default=None)
    p.add_argument("--sequential", action="store_true",
                   help="accepted for reference-command compatibility; bucketed batching "
                        "already bounds padding waste")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns ``cli.common.run_training``'s summary (rank 0's with
    ``--dp``, ``--sp`` or ``--tp``)."""
    args = parse_args(argv)

    from geoldm_tpu_torch.cli.common import check_ported, launch

    check_ported(args)
    return launch(args, train)


def train(args, grid=None) -> dict:
    """Load the splits and train (one rank of a DP, SP or TP run with
    ``grid``)."""
    from geoldm_tpu_torch.cli.common import run_training
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.geom import GeomLoader, load_split_data

    dataset_info = get_dataset_info("geom", args.remove_h)
    tag = f"{'no_h_' if args.remove_h else ''}{args.conformations}"
    train, val, test = load_split_data(os.path.join(args.datadir, f"geom_drugs_{tag}.npy"),
                                       val_proportion=0.1, test_proportion=0.1,
                                       filter_size=args.filter_molecule_size)
    loaders = {split: GeomLoader(data, dataset_info, batch_size=args.batch_size,
                                 shuffle=split == "train", include_charges=args.include_charges,
                                 seed=args.seed)
               for split, data in (("train", train), ("valid", val), ("test", test))}
    return run_training(args, dataset_info, None, loaders=loaders, grid=grid)


if __name__ == "__main__":
    main()
