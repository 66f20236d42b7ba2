"""Extract GEOM-Drugs conformers from the crude msgpack dump (port of
``geoldm_tpu/cli/build_geom_dataset.py``; reference build_geom_dataset.py:236-244):
keeps each molecule's K lowest-energy conformers and writes the packed
(mol_id, atomic number, x, y, z) array, the SMILES list and the atom count
of each conformer. The streaming C++ extractor (``data.native_geom``) runs
when it builds; ``--no_native`` runs the Python one (``data.geom``), and a
host where the C++ one does not build says so and runs the Python one.

  python -m geoldm_tpu_torch.cli.build_geom_dataset --data_dir data/geom \\
      --conformations 30
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    """Extract; returns the written .npy path."""
    p = argparse.ArgumentParser(description="geoldm-tpu-torch GEOM extraction")
    p.add_argument("--conformations", type=int, default=30,
                   help="max conformations kept per molecule")
    p.add_argument("--remove_h", action="store_true")
    p.add_argument("--data_dir", type=str, default="data/geom")
    p.add_argument("--data_file", type=str, default="drugs_crude.msgpack")
    p.add_argument("--no_native", action="store_true",
                   help="run the Python extractor (default: the streaming C++ one when it "
                        "builds; the outputs are identical)")
    args = p.parse_args(argv)

    from geoldm_tpu_torch.data import native_geom
    from geoldm_tpu_torch.data.geom import extract_conformers

    if not args.no_native and native_geom.available():
        out = native_geom.extract_conformers_native(args.data_dir, args.data_file,
                                                    args.conformations, args.remove_h)
    else:
        if not args.no_native:
            print("native extractor unavailable; using the Python path")
        out = extract_conformers(args.data_dir, args.data_file, args.conformations,
                                 args.remove_h)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
