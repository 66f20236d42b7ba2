"""Score a trained generative checkpoint (latent diffusion, or the plain
E(n) diffusion model, either noise schedule and dynamics) with the paper's
metrics on the card (port of ``geoldm_tpu/cli/eval_analyze.py``): generate
``--n_samples`` molecules
(size-bucketed; the model's full T, or ``--n_steps`` few-step jumps), then
atom and molecule stability, the
validity/uniqueness/novelty triple, and the valid and test NLL (the test
split in ``--n_test_passes`` passes, 5 as in the reference
eval_analyze.py:172-188), and write ``eval_log.txt`` and
``generated_smiles.txt`` into ``--model_path``.

  python -m geoldm_tpu_torch.cli.eval_analyze --model_path outputs/qm9_ldm \\
      --datadir data --n_samples 10000
  python -m geoldm_tpu_torch.cli.eval_analyze --model_path outputs/geom_ldm \\
      --dataset geom --datadir data/geom --conformation_file geom_drugs_30.npy

``--model_path`` is an upstream-layout checkpoint directory (``args.pickle``
+ ``generative_model[_ema].npy``, released GeoLDM checkpoints included) or a
run directory whose ``best/`` is one. The NLL runs on the device-resident
packed path (``train.trainer.evaluate_nll_packed``); QM9 pads to its 29
atoms, GEOM to 184. Stability runs on the native C++ batch when ``g++``
builds it (``evalsuite.native``), else on the numpy path. ``--device cpu``
runs the plain PyTorch path on the CPU. ``--n_steps`` K, ``--sampler``
(ddim, dpm2m) and ``--eta`` select the few-step sampler, ``--compute_dtype``
(``nn.core.COMPUTE_DTYPES``) the precision of the generation and of the NLL,
as JAX's CLI uses it. ``--dp D`` > 1 spawns D ranks (``parallel.sharding``):
the generation chunks fan out over them and the packed NLL splits every
batch's rows over them, with each rank's rows of the global draws, so the
molecules are one rank's, bit for bit, and the NLL one rank's up to the sum
order (with a ``--batch_size_nll`` D divides); rank 0 alone prints and
writes ``eval_log.txt`` and ``generated_smiles.txt``.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="geoldm-tpu-torch sample-quality eval")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--n_samples", type=int, default=10_000)
    p.add_argument("--batch_size_gen", type=int, default=100)
    p.add_argument("--batch_size_nll", type=int, default=64)
    p.add_argument("--dataset", type=str, default="qm9")
    p.add_argument("--conformation_file", type=str, default="geom_drugs_30.npy",
                   help="GEOM conformer npy under --datadir")
    p.add_argument("--datadir", type=str, default="data")
    p.add_argument("--remove_h", action="store_true")
    p.add_argument("--compute_dtype", type=str, default="float32")
    p.add_argument("--use_ema", type=eval, default=True)
    p.add_argument("--skip_nll", action="store_true")
    p.add_argument("--n_test_passes", type=int, default=5)
    p.add_argument("--augment_noise", type=float, default=0.0,
                   help="eval-time coordinate noise (the reference applies the training "
                        "augment_noise during NLL eval too, train_test.py:119-124)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks for the generation and the NLL")
    p.add_argument("--n_steps", type=int, default=None)
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--sampler", type=str, default="ddim", choices=["ddim", "dpm2m"])
    p.add_argument("--novelty_smiles", type=str, default=None,
                   help="text file of SMILES (one per line) to use as the novelty base "
                        "instead of the training set (no-RDKit fallback backend only; "
                        "entries are re-canonicalized with the built-in writer)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu, which runs the plain PyTorch path")
    return p.parse_args(argv)


def check_ported(args) -> None:
    """Raise on an unknown compute dtype, before any rank starts."""
    from geoldm_tpu_torch.nn.core import resolve_compute

    resolve_compute(args.compute_dtype)  # raises on an unknown name


def load_eval_splits(args, dataset_info) -> dict:
    """{"valid", "test"} split dicts for the packed NLL: QM9's npz splits, or
    GEOM's conformer file through its fixed permutation."""
    if args.dataset.startswith("geom"):
        from geoldm_tpu_torch.data import geom

        _, val, test = geom.load_split_data(os.path.join(args.datadir, args.conformation_file))
        return {"valid": geom.split_dict(val, dataset_info),
                "test": geom.split_dict(test, dataset_info)}
    from geoldm_tpu_torch.data.qm9 import load_qm9

    splits, _ = load_qm9(args.datadir, dataset=args.dataset, remove_h=args.remove_h)
    return splits


def main(argv=None) -> dict:
    """Evaluate; returns a summary: stability, the triple, the NLLs, the
    generated molecules and their count, the seconds of each part, and which
    stability path ran (rank 0's with ``--dp``, with every rank's kernel
    launch counts, ``launches_per_rank``)."""
    args = parse_args(argv)
    check_ported(args)
    if args.dp > 1:
        from geoldm_tpu_torch.parallel import sharding

        return sharding.spawn(args.dp, 1, evaluate, (args,), device=args.device)
    return evaluate(args, None)


def evaluate(args, grid=None) -> dict:
    """``main``'s work on one rank (of a ``--dp`` run with ``grid``)."""
    import numpy as np

    from geoldm_tpu_torch.cli.common import _generator
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train import trainer as trainer_mod
    from geoldm_tpu_torch.utils.checkpoint import checkpoint_dir
    from geoldm_tpu_torch.utils.convert import load_reference_checkpoint

    data = grid.data if grid is not None else None
    device = grid.device if grid is not None else args.device
    model, model_cfg, _ = load_reference_checkpoint(checkpoint_dir(args.model_path, "best"),
                                                    device, use_ema=args.use_ema)
    if model_cfg.kind == "vae":
        raise SystemExit(f"{args.model_path} holds a 'vae' model; eval_analyze scores "
                         "generative checkpoints (latent or plain diffusion)")
    device = next(model.parameters()).device
    dataset_info = get_dataset_info(args.dataset, args.remove_h)
    nodes_dist = DistributionNodes(dataset_info.n_nodes)
    rng = np.random.default_rng(args.seed)

    external_smiles = None
    if args.novelty_smiles:
        with open(args.novelty_smiles) as f:
            external_smiles = [ln.strip() for ln in f if ln.strip()]
        print(f"novelty base: {len(external_smiles)} external SMILES from {args.novelty_smiles}")

    t0 = time.time()
    validity, rdkit_tuple, molecules = trainer_mod.analyze_and_save(
        model, args.seed, dataset_info, nodes_dist, n_samples=args.n_samples,
        batch_size=args.batch_size_gen, rng=rng, datadir=args.datadir,
        external_smiles=external_smiles, n_steps=args.n_steps, eta=args.eta,
        method=args.sampler, compute_dtype=args.compute_dtype, data=data)
    elapsed = time.time() - t0
    n_done = len(molecules["x"])
    print(f"generated {n_done} molecules in {elapsed:.1f}s "
          f"({elapsed / max(n_done, 1):.3f} secs/sample, {n_done / elapsed:.2f} mol/s)")
    print(f"stability: {validity}")
    if rdkit_tuple is not None:
        vals = rdkit_tuple[0]
        print(f"validity {vals[0]:.4f} uniqueness {vals[1]:.4f} novelty {vals[2]:.4f}")

    nll_val = nll_test = None
    tests = []
    nll_seconds = 0.0
    if not args.skip_nll:
        splits = load_eval_splits(args, dataset_info)
        # GEOM pads to 184, a multiple of 8 above its 181 atoms, as the JAX
        # CLI does; the masks carry the real sizes, so the NLL is unchanged.
        pad_nll = (-(-dataset_info.max_n_nodes // 8) * 8 if args.dataset.startswith("geom")
                   else dataset_info.max_n_nodes)
        t_nll = time.time()
        nll_val = trainer_mod.evaluate_nll_packed(
            model, model_cfg, splits["valid"], nodes_dist, [_generator(device, args.seed, 1, 0)],
            batch_size=args.batch_size_nll, pad_nodes=pad_nll, partition="valid",
            augment_noise=args.augment_noise, compute_dtype=args.compute_dtype, data=data)[0]
        tests = trainer_mod.evaluate_nll_packed(
            model, model_cfg, splits["test"], nodes_dist,
            [_generator(device, args.seed, 2, i) for i in range(args.n_test_passes)],
            batch_size=args.batch_size_nll, pad_nodes=pad_nll, partition="test",
            augment_noise=args.augment_noise, compute_dtype=args.compute_dtype, data=data)
        nll_seconds = time.time() - t_nll
        nll_test = float(np.mean(tests))
        print(f"final test NLL: {nll_test:.4f} (+/- {np.std(tests):.4f}); "
              f"NLL phase {nll_seconds:.1f}s")

    summary = {"n_samples": n_done, "generation_seconds": elapsed, "stability": validity,
               "rdkit": None if rdkit_tuple is None else rdkit_tuple[0],
               "unique_smiles": None if rdkit_tuple is None else rdkit_tuple[1],
               "nll_val": nll_val, "nll_tests": tests, "nll_test": nll_test,
               "nll_seconds": nll_seconds, "report": molecules["report"],
               "molecules": molecules}
    if grid is not None:
        from geoldm_tpu_torch.ops import kernel_launches
        from geoldm_tpu_torch.parallel import sharding

        summary["launches_per_rank"] = sharding.all_gather_objects(kernel_launches(), data)
        if not grid.is_main:
            return summary
    with open(os.path.join(args.model_path, "eval_log.txt"), "w") as f:
        f.write(f"n_samples {n_done}\n")
        f.write(f"secs/sample {elapsed / max(n_done, 1):.4f}\n")
        f.write(f"mol_stable {validity['mol_stable']}\n")
        f.write(f"atm_stable {validity['atm_stable']}\n")
        if rdkit_tuple is not None:
            f.write(f"validity {rdkit_tuple[0][0]} uniqueness {rdkit_tuple[0][1]} "
                    f"novelty {rdkit_tuple[0][2]}\n")
        if nll_val is not None:
            f.write(f"nll_val {nll_val}\nnll_test {nll_test}\n")

    # The unique canonical SMILES of the generated set, sorted: a
    # --novelty_smiles base for a later run, or for external analysis.
    if rdkit_tuple is not None and rdkit_tuple[1]:
        smiles_path = os.path.join(args.model_path, "generated_smiles.txt")
        with open(smiles_path, "w") as f:
            f.write("\n".join(sorted(rdkit_tuple[1])) + "\n")
        print(f"wrote {len(rdkit_tuple[1])} unique SMILES to {smiles_path}")
    return summary


if __name__ == "__main__":
    main()
