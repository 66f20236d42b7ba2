"""Molecule stability metrics and distribution diagnostics (numpy copy of
``geoldm_tpu/evalsuite/analyze.py``).

- ``check_stability``: per-molecule bond orders from the threshold tables
  and valence checks against allowed bonds (reference qm9/analyze.py:209-245).
- ``analyze_stability_for_molecules``: stability over a generated set, on
  the native C++ batch (``evalsuite.native``) when it builds, else on the
  numpy path, then the validity/uniqueness/novelty triple with the best
  backend available (RDKit, else the pure-python fallback).
- Histograms and divergences (reference qm9/analyze.py:24-153), which
  ``cli.check_data`` uses.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

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


def molecules_from_padded(
    x: np.ndarray, one_hot: np.ndarray, node_mask: np.ndarray
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Strip padding: [(positions [n,3], atom_types [n]), ...].

    reference: qm9/analyze.py:337-349."""
    out = []
    n_atoms = np.asarray(node_mask).reshape(len(x), -1).sum(axis=1).astype(int)
    x = np.asarray(x)
    types = np.argmax(np.asarray(one_hot), axis=-1)
    for i in range(len(x)):
        n = n_atoms[i]
        out.append((x[i, :n], types[i, :n]))
    return out


_FALLBACK_WARNED = False


def _warn_fallback_once() -> None:
    global _FALLBACK_WARNED
    if not _FALLBACK_WARNED:
        print(
            "rdkit not installed: validity/uniqueness/novelty use the "
            "pure-python valence-based fallback (canonical SMILES from "
            "the built-in writer)."
        )
        _FALLBACK_WARNED = True


def stability_counts(x: np.ndarray, one_hot: np.ndarray, node_mask: np.ndarray, dataset_info,
                     use_native: Optional[bool] = None) -> Tuple[int, int, int, str]:
    """(stable molecules, stable atoms, atoms, path) over a padded set:
    x [M,N,3], one_hot [M,N,S], node_mask [M,N]. ``path`` names what ran:
    "native" (the C++ batch, ``evalsuite.native``) or "python" (numpy, one
    molecule at a time). ``use_native`` None takes the native batch when it
    builds; True requires it; False takes the numpy path."""
    from geoldm_tpu_torch.evalsuite import native

    if use_native is None:
        use_native = native.available()
    if use_native:
        stable_atoms, total_atoms, mol_stable = native.check_stability_batch(
            x, np.argmax(one_hot, axis=-1), node_mask.sum(axis=1).astype(np.int32), dataset_info)
        return int(mol_stable.sum()), int(stable_atoms.sum()), int(total_atoms.sum()), "native"
    molecule_stable = stable_atoms = n_atoms = 0
    for pos, types in molecules_from_padded(x, one_hot, node_mask):
        stable, n_stable, total = check_stability(pos, types, dataset_info)
        molecule_stable += int(stable)
        stable_atoms += n_stable
        n_atoms += total
    return molecule_stable, stable_atoms, n_atoms, "python"


def analyze_stability_for_molecules(
    molecule_list: Dict[str, np.ndarray],
    dataset_info,
    use_rdkit: Optional[bool] = None,
    datadir: str = "data",
    external_smiles=None,
    report: Optional[dict] = None,
) -> Tuple[Dict[str, float], Optional[tuple]]:
    """Aggregate stability (+ optional validity/uniqueness/novelty).

    molecule_list: dict with 'x' [M,N,3], 'one_hot' [M,N,S],
    'node_mask' [M,N] or [M,N,1]. external_smiles: optional SMILES list to
    use as the novelty base instead of the training set (fallback backend
    only). ``report``, when given, receives the stability path that ran
    ("native" or "python"), the triple's backend and the host seconds of
    each. reference: qm9/analyze.py:323-371."""
    x = np.asarray(molecule_list["x"])
    one_hot = np.asarray(molecule_list["one_hot"])
    node_mask = np.asarray(molecule_list["node_mask"]).reshape(len(x), -1)
    n_samples = len(x)
    report = {} if report is None else report

    t0 = time.perf_counter()
    molecule_stable, nr_stable_bonds, n_atoms, path = stability_counts(
        x, one_hot, node_mask, dataset_info)
    report.update(stability_path=path, stability_seconds=time.perf_counter() - t0)
    validity_dict = {
        "mol_stable": molecule_stable / float(max(n_samples, 1)),
        "atm_stable": nr_stable_bonds / float(max(n_atoms, 1)),
    }

    # use_rdkit: None = compute the validity triple with the best available
    # backend (RDKit, else the pure-python valence fallback); True = require
    # RDKit; False = skip the triple entirely.
    if use_rdkit is False:
        return validity_dict, None
    from geoldm_tpu_torch.evalsuite import rdkit_metrics as rm

    t0 = time.perf_counter()
    processed = molecules_from_padded(x, one_hot, node_mask)
    if use_rdkit is True:
        metrics = rm.BasicMolecularMetrics(dataset_info, datadir=datadir)
    else:
        metrics = rm.make_molecular_metrics(dataset_info, datadir=datadir,
                                            external_smiles=external_smiles)
        if metrics.source != "rdkit":
            _warn_fallback_once()
    rdkit_tuple = metrics.evaluate(processed)
    report.update(triple_backend=metrics.source, triple_seconds=time.perf_counter() - t0)
    return validity_dict, rdkit_tuple


def analyze_node_distribution(mol_list) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Histograms of molecule sizes and atom types over a processed list of
    (positions, atom_types) (reference: qm9/analyze.py:374-387)."""
    hist_nodes = DiscreteHistogram("n_nodes")
    hist_types = DiscreteHistogram("atom_types")
    for positions, atom_types in mol_list:
        hist_nodes.add([positions.shape[0]])
        hist_types.add(list(np.asarray(atom_types).reshape(-1)))
    return hist_nodes.bins, hist_types.bins


# ---------------------------------------------------------------------------
# Histograms and divergences (reference: qm9/analyze.py:24-153)
# ---------------------------------------------------------------------------


class DiscreteHistogram:
    def __init__(self, name: str = "histogram"):
        self.name = name
        self.bins: Dict[int, int] = {}

    def add(self, elements) -> None:
        vals, counts = np.unique(np.asarray(list(elements)), return_counts=True)
        for v, c in zip(vals, counts):
            self.bins[int(v)] = self.bins.get(int(v), 0) + int(c)


class ContinuousHistogram:
    def __init__(self, num_bins: int = 100, hist_range=(0.0, 13.0), name: str = "histogram",
                 ignore_zeros: bool = False):
        self.name = name
        self.bins = np.zeros(num_bins, dtype=np.int64)
        self.range = hist_range
        self.ignore_zeros = ignore_zeros

    def add(self, elements) -> None:
        e = np.asarray(elements, dtype=np.float64).reshape(-1)
        if self.ignore_zeros:
            e = e[e > 1e-8]
        idx = (e / self.range[1] * len(self.bins)).astype(np.int64)
        idx = np.minimum(idx, len(self.bins) - 1)
        self.bins += np.bincount(idx, minlength=len(self.bins))


def normalize_histogram(hist) -> np.ndarray:
    hist = np.asarray(hist, dtype=np.float64)
    return hist / hist.sum()


def kl_divergence(p1: np.ndarray, p2: np.ndarray) -> float:
    return float(np.sum(p1 * np.log(p1 / p2)))


def kl_divergence_sym(h1, h2) -> float:
    p1 = normalize_histogram(h1) + 1e-10
    p2 = normalize_histogram(h2) + 1e-10
    return (kl_divergence(p1, p2) + kl_divergence(p2, p1)) / 2.0


def js_divergence(h1, h2) -> float:
    p1 = normalize_histogram(h1) + 1e-10
    p2 = normalize_histogram(h2) + 1e-10
    m = (p1 + p2) / 2
    return (kl_divergence(p1, m) + kl_divergence(p2, m)) / 2


def earth_mover_distance(h1, h2) -> float:
    """The 1-D Wasserstein distance between the normalised histograms taken
    as samples (``scipy.stats.wasserstein_distance(p1, p2)``, as the
    reference calls it), in numpy: the integral of |CDF_1 - CDF_2| over the
    merged sorted values."""
    u, v = normalize_histogram(h1), normalize_histogram(h2)
    all_values = np.concatenate((u, v))
    all_values.sort(kind="mergesort")
    deltas = np.diff(all_values)
    u_cdf = np.sort(u).searchsorted(all_values[:-1], "right") / u.size
    v_cdf = np.sort(v).searchsorted(all_values[:-1], "right") / v.size
    return float(np.sum(np.multiply(np.abs(u_cdf - v_cdf), deltas)))


def pairwise_distance_histogram(
    x: np.ndarray, node_mask: np.ndarray, num_bins: int = 100, hist_range=(0.0, 13.0)
) -> np.ndarray:
    """Histogram of all intra-molecule pairwise distances over a batch
    (the dataset self-check of main_analyze_qm9 — qm9/analyze.py:156-205)."""
    hist = ContinuousHistogram(num_bins, hist_range, ignore_zeros=True)
    x = np.asarray(x) * np.asarray(node_mask).reshape(x.shape[0], x.shape[1], 1)
    diff = x[:, :, None, :] - x[:, None, :, :]
    dist = np.sqrt((diff * diff).sum(-1))
    hist.add(dist.reshape(-1))
    return hist.bins
