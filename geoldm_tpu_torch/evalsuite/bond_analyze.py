"""Distance-threshold bond-order inference from empirical bond lengths
(numpy copy of ``geoldm_tpu/evalsuite/bond_analyze.py``).

The bond-length tables (pm) are standard chemistry reference data (same
sources the reference cites: wiredchemist.com bond energies/lengths table) —
reference: qm9/bond_analyze.py:5-47, margins :92-93, valences :95-98.

TPU-native redesign: instead of a per-pair Python dict lookup inside an
O(N^2) loop (reference :101-126), the tables are compiled once per dataset
vocabulary into dense [S, S] threshold matrices, and bond orders for all
pairs of a (batched) molecule are computed with vectorized numpy
comparisons. The nesting bonds3 ⊂ bonds2 ⊂ bonds1 makes the order
computation a sum of three threshold tests.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np

# Single-bond lengths (pm).
BONDS1 = {
    "H": {"H": 74, "C": 109, "N": 101, "O": 96, "F": 92, "B": 119, "Si": 148,
          "P": 144, "As": 152, "S": 134, "Cl": 127, "Br": 141, "I": 161},
    "C": {"H": 109, "C": 154, "N": 147, "O": 143, "F": 135, "Si": 185,
          "P": 184, "S": 182, "Cl": 177, "Br": 194, "I": 214},
    "N": {"H": 101, "C": 147, "N": 145, "O": 140, "F": 136, "Cl": 175,
          "Br": 214, "S": 168, "I": 222, "P": 177},
    "O": {"H": 96, "C": 143, "N": 140, "O": 148, "F": 142, "Br": 172,
          "S": 151, "P": 163, "Si": 163, "Cl": 164, "I": 194},
    "F": {"H": 92, "C": 135, "N": 136, "O": 142, "F": 142, "S": 158,
          "Si": 160, "Cl": 166, "Br": 178, "P": 156, "I": 187},
    "B": {"H": 119, "Cl": 175},
    "Si": {"Si": 233, "H": 148, "C": 185, "O": 163, "S": 200, "F": 160,
           "Cl": 202, "Br": 215, "I": 243},
    "Cl": {"Cl": 199, "H": 127, "C": 177, "N": 175, "O": 164, "P": 203,
           "S": 207, "B": 175, "Si": 202, "F": 166, "Br": 214},
    "S": {"H": 134, "C": 182, "N": 168, "O": 151, "S": 204, "F": 158,
          "Cl": 207, "Br": 225, "Si": 200, "P": 210, "I": 234},
    "Br": {"Br": 228, "H": 141, "C": 194, "O": 172, "N": 214, "Si": 215,
           "S": 225, "F": 178, "Cl": 214, "P": 222},
    "P": {"P": 221, "H": 144, "C": 184, "O": 163, "Cl": 203, "S": 210,
          "F": 156, "N": 177, "Br": 222},
    "I": {"H": 161, "C": 214, "Si": 243, "N": 222, "O": 194, "S": 234,
          "F": 187, "I": 266},
    "As": {"H": 152},
}

# Double-bond lengths (pm).
BONDS2 = {
    "C": {"C": 134, "N": 129, "O": 120, "S": 160},
    "N": {"C": 129, "N": 125, "O": 121},
    "O": {"C": 120, "N": 121, "O": 121, "P": 150},
    "P": {"O": 150, "S": 186},
    "S": {"P": 186},
}

# Triple-bond lengths (pm).
BONDS3 = {
    "C": {"C": 120, "N": 116, "O": 113},
    "N": {"C": 116, "N": 110},
    "O": {"C": 113},
}

# Margins (pm), tuned (by the upstream authors) to maximize stability of true
# QM9 samples. reference: qm9/bond_analyze.py:92-93.
MARGIN1, MARGIN2, MARGIN3 = 10, 5, 3

ALLOWED_BONDS = {
    "H": 1, "C": 4, "N": 3, "O": 2, "F": 1, "B": 3, "Al": 3, "Si": 4,
    "P": (3, 5), "S": 4, "Cl": 1, "As": 3, "Br": 1, "I": 1, "Hg": (1, 2),
    "Bi": (3, 5),
}


# The upstream tables contain one asymmetric entry — bonds2 has C->S (160)
# but no S->C (reference: qm9/bond_analyze.py:37-41; its own symmetry checker
# at :78-89 is dead code). The reference sidesteps this by sorting the type
# pair before lookup in the GEOM path (qm9/analyze.py:225-229,
# rdkit_functions.py:178). We adopt the sorted-pair convention everywhere.
KNOWN_ASYMMETRIES = (("C", "S", 2),)


def check_consistency_bond_dictionaries() -> None:
    """Symmetry self-check of the tables (the working version of the
    reference's dead checker, bond_analyze.py:78-89)."""
    for order, table in ((1, BONDS1), (2, BONDS2), (3, BONDS3)):
        for a1, row in table.items():
            for a2, length in row.items():
                if (a1, a2, order) in KNOWN_ASYMMETRIES or (
                    a2, a1, order,
                ) in KNOWN_ASYMMETRIES:
                    continue
                assert a2 in table and a1 in table[a2], (a1, a2, order)
                assert table[a2][a1] == length, (a1, a2, order)


@lru_cache(maxsize=16)
def threshold_matrices(atom_decoder: tuple) -> tuple:
    """[S, S] bond thresholds (in pm, margins included; -inf = no bond).

    Symmetrized with the sorted-pair convention: the entry for (i, j) is
    looked up with the lower vocabulary index first, matching the
    reference's ``pair = sorted([type_i, type_j])`` semantics."""
    s = len(atom_decoder)
    thr1 = np.full((s, s), -np.inf)
    thr2 = np.full((s, s), -np.inf)
    thr3 = np.full((s, s), -np.inf)
    for i, a1 in enumerate(atom_decoder):
        for j, a2 in enumerate(atom_decoder):
            lo, hi = (i, j) if i <= j else (j, i)
            b1, b2 = atom_decoder[lo], atom_decoder[hi]
            if b1 in BONDS1 and b2 in BONDS1[b1]:
                thr1[i, j] = BONDS1[b1][b2] + MARGIN1
            if b1 in BONDS2 and b2 in BONDS2[b1]:
                thr2[i, j] = BONDS2[b1][b2] + MARGIN2
            if b1 in BONDS3 and b2 in BONDS3[b1]:
                thr3[i, j] = BONDS3[b1][b2] + MARGIN3
    return thr1, thr2, thr3


@lru_cache(maxsize=16)
def allowed_bond_table(atom_decoder: tuple) -> tuple:
    """Per-type tuple of allowed valences."""
    out = []
    for a in atom_decoder:
        allowed = ALLOWED_BONDS[a]
        out.append((allowed,) if isinstance(allowed, int) else tuple(allowed))
    return tuple(out)


def get_bond_order(atom1: str, atom2: str, distance: float, check_exists: bool = False) -> int:
    """Scalar bond order for one atom pair (distance in Angstrom).

    reference: qm9/bond_analyze.py:101-126."""
    d = 100.0 * distance  # Angstrom -> pm
    if check_exists and (atom1 not in BONDS1 or atom2 not in BONDS1[atom1]):
        return 0
    if d < BONDS1[atom1][atom2] + MARGIN1:
        if atom1 in BONDS2 and atom2 in BONDS2[atom1]:
            if d < BONDS2[atom1][atom2] + MARGIN2:
                if atom1 in BONDS3 and atom2 in BONDS3[atom1]:
                    if d < BONDS3[atom1][atom2] + MARGIN3:
                        return 3
                return 2
        return 1
    return 0


def geom_predictor(pair: tuple, distance: float, limit_bonds_to_one: bool = False) -> int:
    """GEOM bond predictor: same tables with check_exists
    (reference: qm9/bond_analyze.py:135-144)."""
    order = get_bond_order(pair[0], pair[1], distance, check_exists=True)
    if limit_bonds_to_one:
        return 1 if order > 0 else 0
    return order


def pairwise_bond_orders(
    positions: np.ndarray, atom_types: np.ndarray, atom_decoder: Sequence[str]
) -> np.ndarray:
    """[N, N] integer bond orders for one molecule (vectorized).

    positions in Angstrom [N, 3]; atom_types are vocabulary indices [N]."""
    thr1, thr2, thr3 = threshold_matrices(tuple(atom_decoder))
    diff = positions[:, None, :] - positions[None, :, :]
    d = 100.0 * np.sqrt(np.sum(diff * diff, axis=-1))  # pm
    t = np.asarray(atom_types)
    t1 = thr1[t[:, None], t[None, :]]
    t2 = thr2[t[:, None], t[None, :]]
    t3 = thr3[t[:, None], t[None, :]]
    orders = (d < t1).astype(np.int64)
    orders += ((d < t2) & (orders > 0)).astype(np.int64)
    orders += ((d < t3) & (orders > 1)).astype(np.int64)
    np.fill_diagonal(orders, 0)
    return orders
