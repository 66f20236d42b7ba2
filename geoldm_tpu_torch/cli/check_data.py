"""Dataset self-checks: stability of real data + distribution histograms
(port of ``geoldm_tpu/cli/check_data.py``; host-side numpy, no device).

The reference's calibration entry points (qm9/analyze.py:156-205
main_analyze_qm9 and :262-320 main_check_stability): the atom and molecule
stability of *real* dataset molecules (ground truth for the bond-inference
tables), and the size / atom-type / pairwise-distance histograms with the
distance histogram's KL and JS divergences against the dataset registry.

  python -m geoldm_tpu_torch.cli.check_data --dataset qm9 --datadir data --split train
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="geoldm-tpu-torch dataset self-check")
    p.add_argument("--dataset", type=str, default="qm9",
                   choices=["qm9", "qm9_first_half", "qm9_second_half"])
    p.add_argument("--datadir", type=str, default="data")
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--remove_h", action="store_true")
    p.add_argument("--max_molecules", type=int, default=0, help="0 = all")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import numpy as np

    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.qm9 import load_qm9
    from geoldm_tpu_torch.evalsuite import analyze as an

    info = get_dataset_info(
        "qm9" if "half" not in args.dataset else args.dataset, args.remove_h
    )
    splits, _ = load_qm9(args.datadir, dataset=args.dataset, remove_h=args.remove_h)
    d = splits[args.split]
    m = len(d["num_atoms"])
    if args.max_molecules:
        m = min(m, args.max_molecules)

    # Stability of real molecules (bond-table calibration).
    one_hot = d["one_hot"][:m]
    node_mask = (d["charges"][:m] > 0).astype(np.float32)
    mols = {
        "x": d["positions"][:m],
        "one_hot": one_hot,
        "node_mask": node_mask,
    }
    report = {}
    validity, _ = an.analyze_stability_for_molecules(mols, info, use_rdkit=False, report=report)
    print(
        f"{args.dataset}/{args.split} ({m} molecules): "
        f"mol_stable {100 * validity['mol_stable']:.2f}% "
        f"atm_stable {100 * validity['atm_stable']:.2f}%"
    )

    # Histograms.
    sizes = d["num_atoms"][:m]
    hist_nodes = an.DiscreteHistogram("n_nodes")
    hist_nodes.add(sizes)
    print("size histogram:", dict(sorted(hist_nodes.bins.items())))

    types = np.argmax(one_hot, axis=-1)[node_mask > 0]
    hist_types = an.DiscreteHistogram("atom_types")
    hist_types.add(types)
    print("atom-type histogram:", dict(sorted(hist_types.bins.items())))

    dist_hist = an.pairwise_distance_histogram(d["positions"][:m], node_mask)
    ref_hist = np.asarray(info.distance_histogram or dist_hist, dtype=np.float64)
    divergences = None
    if len(ref_hist) == len(dist_hist) and ref_hist.sum() > 0:
        divergences = (an.kl_divergence_sym(dist_hist, ref_hist),
                       an.js_divergence(dist_hist, ref_hist))
        print(
            "distance-histogram KL vs registry:",
            f"{divergences[0]:.4f}",
            "| JS:", f"{divergences[1]:.4f}",
        )
    return {"n_molecules": m, "stability": validity, "stability_path": report["stability_path"],
            "sizes": hist_nodes.bins, "atom_types": hist_types.bins,
            "distance_histogram": dist_hist, "kl_js": divergences}


if __name__ == "__main__":
    main()
