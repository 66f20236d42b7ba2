"""Molecule stability check (numpy copy of
``geoldm_tpu/evalsuite/analyze.py:19 check_stability``): per-molecule bond
orders from the threshold tables and valence checks against allowed bonds
(reference qm9/analyze.py:209-245).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from geoldm_tpu_torch.evalsuite import bond_analyze as ba


def check_stability(
    positions: np.ndarray,
    atom_types: np.ndarray,
    dataset_info,
    debug: bool = False,
) -> Tuple[bool, int, int]:
    """(molecule_stable, n_stable_atoms, n_atoms) for one molecule.

    reference: qm9/analyze.py:209-245. For GEOM the pair order uses the
    geom_predictor semantics (check_exists; same tables)."""
    positions = np.asarray(positions, dtype=np.float64)
    atom_types = np.asarray(atom_types, dtype=np.int64)
    assert positions.ndim == 2 and positions.shape[1] == 3
    decoder = tuple(dataset_info["atom_decoder"])

    orders = ba.pairwise_bond_orders(positions, atom_types, decoder)
    nr_bonds = orders.sum(axis=1)

    allowed = ba.allowed_bond_table(decoder)
    stable_atoms = 0
    for t, nb in zip(atom_types, nr_bonds):
        is_stable = int(nb) in allowed[int(t)]
        if not is_stable and debug:
            print(f"Invalid bonds for atom {decoder[int(t)]} with {int(nb)} bonds")
        stable_atoms += int(is_stable)
    return stable_atoms == len(atom_types), stable_atoms, len(atom_types)
