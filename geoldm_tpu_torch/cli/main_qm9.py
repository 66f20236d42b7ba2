"""Train GeoLDM on QM9 on the card (port of ``geoldm_tpu/cli/main_qm9.py``):
the first-stage VAE by default, latent diffusion with ``--train_diffusion``.

  # The reference recipe (README.md:80-84):
  python -m geoldm_tpu_torch.cli.main_qm9 --exp_name qm9_ldm --datadir data \\
      --train_diffusion --trainable_ae --nf 256 --n_layers 9 --latent_nf 1 \\
      --diffusion_steps 1000 --diffusion_noise_schedule polynomial_2 \\
      --batch_size 64 --ema_decay 0.9999

``--datadir`` holds ``qm9/{train,valid,test}.npz``; missing ones are
prepared from the raw GDB9 files there, fetched if absent
(``data.qm9.prepare_qm9``), and ``--force_download`` rebuilds them.
``--dp D`` splits every batch over D spawned data ranks
(``parallel.sharding``; the default 0 takes every card), ``--sp S`` every
EGNN's atom rows over S ranks (``parallel.sp``), both together a D x S grid;
``--tp T`` shards every ``--nf``-wide parameter, with its optimizer state
and EMA, over T model ranks (a D x T grid with ``--dp``).
``--device cpu`` runs the plain PyTorch path on the CPU.
Checkpoints go to ``<outdir>/<exp_name>/{latest,best}/`` in the upstream
layout, which ``geoldm_tpu_torch.cli.serve --model_path`` loads.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    from geoldm_tpu_torch.cli.common import add_model_args

    p = argparse.ArgumentParser(description="geoldm-tpu-torch QM9 training")
    add_model_args(p)
    p.add_argument("--dataset", type=str, default="qm9",
                   choices=["qm9", "qm9_second_half", "qm9_first_half"])
    p.add_argument("--datadir", type=str, default="data")
    p.add_argument("--filter_n_atoms", type=int, default=None)
    p.add_argument("--remove_h", action="store_true")
    p.add_argument("--force_download", action="store_true")
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
    from geoldm_tpu_torch.data.qm9 import filter_atoms, load_qm9

    dataset_info = get_dataset_info("qm9" if "half" not in args.dataset else args.dataset,
                                    args.remove_h)
    splits, _ = load_qm9(args.datadir, dataset=args.dataset, remove_h=args.remove_h,
                         force_download=args.force_download)
    if args.filter_n_atoms is not None:
        splits = filter_atoms(splits, args.filter_n_atoms)
    return run_training(args, dataset_info, splits, grid=grid)


if __name__ == "__main__":
    main()
