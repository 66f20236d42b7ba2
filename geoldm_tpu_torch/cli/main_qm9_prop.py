"""Train the EGNN property classifier (port of
``geoldm_tpu/cli/main_qm9_prop.py``; reference
qm9/property_prediction/main_qm9_prop.py): train on qm9_first_half's train
split, validate on its valid split, test on qm9_second_half's train split,
with the property's mean/MAD from the first half's valid split.

  python -m geoldm_tpu_torch.cli.main_qm9_prop --property alpha --exp_name cls_alpha \\
      --datadir data --outf outputs

Writes ``<outf>/<exp_name>/best/classifier.npy`` (the best-on-valid
weights, which ``cli.eval_conditional_qm9 --classifiers_path`` loads) and
``losess.json``. ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="geoldm-tpu-torch property classifier")
    p.add_argument("--exp_name", type=str, default="classifier")
    p.add_argument("--batch_size", type=int, default=96)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--nf", type=int, default=128)
    p.add_argument("--attention", type=int, default=1)
    p.add_argument("--n_layers", type=int, default=7)
    p.add_argument("--property", type=str, default="alpha",
                   choices=["alpha", "gap", "homo", "lumo", "mu", "Cv", "G", "H", "r2", "U",
                            "U0", "zpve"])
    p.add_argument("--datadir", type=str, default="data")
    p.add_argument("--remove_h", action="store_true")
    p.add_argument("--node_attr", type=int, default=0)
    p.add_argument("--weight_decay", type=float, default=1e-16)
    p.add_argument("--model_name", type=str, default="egnn",
                   choices=["egnn", "naive", "numnodes"])
    p.add_argument("--outf", type=str, default="outputs")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   help="float32, or bfloat16: bf16 product operands, f32 accumulation")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns ``train.classifier_train.train_classifier``'s result."""
    args = parse_args(argv)
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.qm9 import QM9Loader, load_qm9
    from geoldm_tpu_torch.train import classifier_train as ct
    from geoldm_tpu_torch.train.conditioning import compute_mean_mad_from_arrays
    from geoldm_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    info = get_dataset_info("qm9", args.remove_h)
    first, _ = load_qm9(args.datadir, dataset="qm9_first_half", remove_h=args.remove_h)
    second, _ = load_qm9(args.datadir, dataset="qm9_second_half", remove_h=args.remove_h)
    pad, props = info.max_n_nodes, (args.property,)
    loaders = {
        "train": QM9Loader(first["train"], args.batch_size, pad, shuffle=True,
                           properties=props, seed=args.seed),
        "valid": QM9Loader(first["valid"], args.batch_size, pad, shuffle=False,
                           properties=props),
        # The other half's training molecules (main_qm9_prop.py:182-184).
        "test": QM9Loader(second["train"], args.batch_size, pad, shuffle=False,
                          properties=props),
    }
    property_norms = compute_mean_mad_from_arrays(first["valid"], [args.property])
    result = ct.train_classifier(
        loaders, args.property, property_norms, epochs=args.epochs, lr=args.lr,
        weight_decay=args.weight_decay, nf=args.nf, n_layers=args.n_layers,
        attention=bool(args.attention), node_attr=bool(args.node_attr),
        in_node_nf=len(info.atom_decoder), seed=args.seed,
        outdir=os.path.join(args.outf, args.exp_name),
        compute_dtype="bfloat16" if args.compute_dtype == "bfloat16" else None,
        device=device, model_name=args.model_name)
    print(f"best val {result['best_val']:.4f} test {result['best_test']:.4f} "
          f"at epoch {result['best_epoch']}", flush=True)
    return result


if __name__ == "__main__":
    main()
