"""Validity / uniqueness / novelty metrics: RDKit-backed, with a pure-python
valence-based fallback (the port's copy of
``geoldm_tpu/evalsuite/rdkit_metrics.py:40-393``).

RDKit is an optional dependency (guarded import, like the reference's
qm9/analyze.py:1-6). When it is absent, ``FallbackMolecularMetrics`` gives
the same triple from the bond-inference tables alone: validity = no atom
exceeds its maximum allowed valence (RDKit's sanitize failure mode), and
molecule identity = a canonical SMILES from the pure-python writer in
``evalsuite/smiles.py``. The fallback triple is not numerically RDKit's (no
aromaticity or charge perception during bond inference).

The training-set SMILES (the novelty base) are cached in
``<datadir>/cache/`` under a name of the port's own, keyed on the dataset,
the absolute datadir and the bytes of its train split, so two splits, or two
datadirs, never share a cache file, and the JAX package's cache is never
read.

reference: qm9/rdkit_functions.py:76-188 (BasicMolecularMetrics,
build_molecule / build_xae_molecule), :11-67 (training-set SMILES cache).
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Callable, List, Optional, Sequence

import numpy as np

from geoldm_tpu_torch.evalsuite import bond_analyze as ba
from geoldm_tpu_torch.evalsuite import smiles as sm

try:
    from rdkit import Chem

    RDKIT_AVAILABLE = True
except ModuleNotFoundError:
    Chem = None
    RDKIT_AVAILABLE = False


def build_xae_molecule(positions: np.ndarray, atom_types: np.ndarray, dataset_info):
    """(X [N], A [N,N] bool, E [N,N] int) bond graph from coordinates.

    Bond orders come from the vectorized threshold tables; GEOM caps orders
    at 1 (reference: rdkit_functions.py:158-188, geom_predictor with
    limit_bonds_to_one)."""
    atom_types = np.asarray(atom_types, dtype=np.int64)
    orders = ba.pairwise_bond_orders(
        np.asarray(positions, dtype=np.float64), atom_types,
        tuple(dataset_info["atom_decoder"]),
    )
    if dataset_info["name"] == "geom":
        orders = np.minimum(orders, 1)
    # Directed graph: keep the lower triangle only.
    e = np.tril(orders, k=-1).astype(np.int64)
    a = e > 0
    return atom_types, a, e


_BOND_TYPES = None


def _bond_types():
    global _BOND_TYPES
    if _BOND_TYPES is None:
        _BOND_TYPES = [
            None,
            Chem.rdchem.BondType.SINGLE,
            Chem.rdchem.BondType.DOUBLE,
            Chem.rdchem.BondType.TRIPLE,
            Chem.rdchem.BondType.AROMATIC,
        ]
    return _BOND_TYPES


def build_molecule(positions, atom_types, dataset_info):
    """RWMol from inferred bonds (reference: rdkit_functions.py:144-155)."""
    assert RDKIT_AVAILABLE, "rdkit not installed"
    decoder = dataset_info["atom_decoder"]
    x, a, e = build_xae_molecule(positions, atom_types, dataset_info)
    mol = Chem.RWMol()
    for t in x:
        mol.AddAtom(Chem.Atom(decoder[int(t)]))
    rows, cols = np.nonzero(a)
    for i, j in zip(rows, cols):
        mol.AddBond(int(i), int(j), _bond_types()[int(e[i, j])])
    return mol


def mol2smiles(mol) -> Optional[str]:
    try:
        Chem.SanitizeMol(mol)
    except ValueError:
        return None
    return Chem.MolToSmiles(mol)


def compute_dataset_smiles(dataset_info, datadir: str) -> List[str]:
    """SMILES of the training set, for novelty (reference:
    rdkit_functions.py:11-44)."""
    from geoldm_tpu_torch.data.qm9 import load_qm9

    name = dataset_info["name"]
    splits, _ = load_qm9(datadir, dataset=name, remove_h=not dataset_info["with_h"])
    train = splits["train"]
    smiles = []
    for i in range(len(train["num_atoms"])):
        n = int(train["num_atoms"][i])
        pos = train["positions"][i, :n]
        types = np.argmax(train["one_hot"][i, :n], axis=-1)
        mol = build_molecule(pos, types, dataset_info)
        s = mol2smiles(mol)
        if s is not None:
            smiles.append(s)
    return smiles


def _train_smiles_cache(dataset_info, datadir: str, kind: str) -> str:
    """The cache file of one dataset's training-set SMILES of one ``kind``."""
    suffix = "" if dataset_info["with_h"] else "_noH"
    h = hashlib.sha256(os.path.abspath(datadir).encode())
    with open(os.path.join(datadir, "qm9", "train.npz"), "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return os.path.join(datadir, "cache", f"geoldm_tpu_torch_{dataset_info['name']}{suffix}_"
                                          f"{h.hexdigest()[:16]}_{kind}.pickle")


def _cached(path: str, compute: Callable[[], List[str]]) -> List[str]:
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    out = compute()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, path)
    return out


def retrieve_qm9_smiles(dataset_info, datadir: str = "data") -> List[str]:
    """Cached training-set SMILES (reference: rdkit_functions.py:47-67)."""
    return _cached(_train_smiles_cache(dataset_info, datadir, "smiles"),
                   lambda: compute_dataset_smiles(dataset_info, datadir))


class _MolecularMetricsBase:
    """Shared uniqueness/novelty/evaluate over molecule identity strings
    (RDKit canonical SMILES for the RDKit path, the built-in writer's
    canonical SMILES for the fallback).

    reference: qm9/rdkit_functions.py:102-133."""

    source = "abstract"
    dataset_smiles_list: Optional[List[str]] = None

    def compute_validity(self, generated: Sequence[tuple]):
        raise NotImplementedError

    def compute_uniqueness(self, valid: List[str]):
        return list(set(valid)), len(set(valid)) / len(valid)

    def compute_novelty(self, unique: List[str]):
        # Set membership: the QM9 training list is ~100k entries; a list
        # scan per unique molecule is O(10^9) comparisons at the 10k eval.
        known = set(self.dataset_smiles_list)
        novel = [s for s in unique if s not in known]
        return novel, len(novel) / len(unique)

    def evaluate(self, generated: Sequence[tuple]):
        valid, validity = self.compute_validity(generated)
        if validity > 0:
            unique, uniqueness = self.compute_uniqueness(valid)
            if self.dataset_smiles_list is not None:
                _, novelty = self.compute_novelty(unique)
            else:
                novelty = 0.0
        else:
            unique, uniqueness, novelty = None, 0.0, 0.0
        return [validity, uniqueness, novelty], unique


class BasicMolecularMetrics(_MolecularMetricsBase):
    """Validity (largest fragment), uniqueness, novelty via RDKit.

    reference: qm9/rdkit_functions.py:76-133."""

    source = "rdkit"

    def __init__(self, dataset_info, dataset_smiles_list=None, datadir: str = "data"):
        assert RDKIT_AVAILABLE, "rdkit not installed"
        self.dataset_info = dataset_info
        self.dataset_smiles_list = dataset_smiles_list
        if dataset_smiles_list is None and "qm9" in dataset_info["name"]:
            try:
                self.dataset_smiles_list = retrieve_qm9_smiles(dataset_info, datadir)
            except Exception:
                self.dataset_smiles_list = None

    def compute_validity(self, generated: Sequence[tuple]):
        valid = []
        for positions, atom_types in generated:
            mol = build_molecule(positions, atom_types, self.dataset_info)
            smiles = mol2smiles(mol)
            if smiles is not None:
                frags = Chem.rdmolops.GetMolFrags(mol, asMols=True)
                largest = max(frags, default=mol, key=lambda m: m.GetNumAtoms())
                valid.append(mol2smiles(largest))
        return valid, len(valid) / len(generated)


# ---------------------------------------------------------------------------
# Pure-python fallback (no RDKit): over-valence validity + canonical SMILES
# ---------------------------------------------------------------------------


def graph_canonical_key(symbols: Sequence[str], sym_orders: np.ndarray) -> str:
    """Permutation-invariant identity string for a bond graph via iterated
    Weisfeiler-Lehman relabeling (the same family of hash RDKit's Morgan
    algorithm uses). symbols: per-atom element strings; sym_orders: [N, N]
    symmetric integer bond orders."""
    n = len(symbols)
    sym_orders = np.asarray(sym_orders)
    neigh = [np.nonzero(sym_orders[i])[0] for i in range(n)]
    lab = [str(s) for s in symbols]
    for _ in range(max(1, min(n, 8))):
        lab = [
            hashlib.sha1(
                (
                    lab[i]
                    + "|"
                    + ",".join(
                        sorted(f"{int(sym_orders[i, j])}:{lab[j]}" for j in neigh[i])
                    )
                ).encode()
            ).hexdigest()[:16]
            for i in range(n)
        ]
    return hashlib.sha1(".".join(sorted(lab)).encode()).hexdigest()


def _connected_components(adj: np.ndarray) -> List[np.ndarray]:
    """Connected components of a boolean adjacency matrix (BFS)."""
    n = len(adj)
    seen = np.zeros(n, dtype=bool)
    comps = []
    for s in range(n):
        if seen[s]:
            continue
        stack = [s]
        seen[s] = True
        comp = []
        while stack:
            i = stack.pop()
            comp.append(i)
            for j in np.nonzero(adj[i])[0]:
                if not seen[j]:
                    seen[j] = True
                    stack.append(int(j))
        comps.append(np.array(sorted(comp)))
    return comps


def _largest_valid_fragment(positions, atom_types, dataset_info):
    """(symbols, sym_orders) of the largest fragment, or None when any atom
    exceeds its maximum allowed valence — mirroring RDKit sanitize's
    failure mode (under-valence = radical, sanitizes fine)."""
    x, a, e = build_xae_molecule(positions, atom_types, dataset_info)
    sym = e + e.T
    nr_bonds = sym.sum(axis=1)
    decoder = dataset_info["atom_decoder"]
    allowed = ba.allowed_bond_table(tuple(decoder))
    for t, nb in zip(x, nr_bonds):
        if int(nb) > max(allowed[int(t)]):
            return None
    adj = (a | a.T)
    comps = _connected_components(adj)
    largest = max(comps, key=len)
    syms = [decoder[int(t)] for t in x[largest]]
    return syms, sym[np.ix_(largest, largest)]


def molecule_graph_key(positions, atom_types, dataset_info) -> Optional[str]:
    """WL-hash identity of the largest valid fragment (legacy fallback key;
    superseded by molecule_fallback_smiles but kept as the cheap
    cross-check that the SMILES identity partitions molecules the same)."""
    frag = _largest_valid_fragment(positions, atom_types, dataset_info)
    if frag is None:
        return None
    return graph_canonical_key(*frag)


def molecule_fallback_smiles(positions, atom_types, dataset_info) -> Optional[str]:
    """Canonical SMILES (pure-python writer, evalsuite/smiles.py) of the
    largest valid fragment; None when over-valent. The string is standard,
    readable, and comparable to external SMILES after smiles.recanonicalize."""

    frag = _largest_valid_fragment(positions, atom_types, dataset_info)
    if frag is None:
        return None
    return sm.canonical_smiles(*frag)


def compute_dataset_fallback_smiles(dataset_info, datadir: str) -> List[str]:
    """Canonical fallback SMILES of the training set, for novelty (the
    rdkit-free analogue of compute_dataset_smiles)."""
    from geoldm_tpu_torch.data.qm9 import load_qm9

    name = dataset_info["name"]
    splits, _ = load_qm9(datadir, dataset=name, remove_h=not dataset_info["with_h"])
    train = splits["train"]
    keys = []
    for i in range(len(train["num_atoms"])):
        n = int(train["num_atoms"][i])
        pos = train["positions"][i, :n]
        types = np.argmax(train["one_hot"][i, :n], axis=-1)
        k = molecule_fallback_smiles(pos, types, dataset_info)
        if k is not None:
            keys.append(k)
    return keys


def retrieve_qm9_fallback_smiles(dataset_info, datadir: str = "data") -> List[str]:
    """Cached training-set fallback SMILES (the fallback's
    ``retrieve_qm9_smiles``)."""
    return _cached(_train_smiles_cache(dataset_info, datadir, "fbsmiles"),
                   lambda: compute_dataset_fallback_smiles(dataset_info, datadir))


def canonicalize_external_smiles(smiles_list: Sequence[str]):
    """Re-canonicalize an externally produced SMILES list (e.g. RDKit
    canonical strings from a published artifact) into this module's
    fallback form so it can serve as the novelty base. Returns
    (canonical_list, n_unsupported); entries using SMILES features outside
    the supported subset (stereo, isotopes, fragments) are counted and
    skipped rather than silently mis-parsed."""

    out, skipped = [], 0
    for s in smiles_list:
        try:
            out.append(sm.recanonicalize(s))
        except sm.SmilesError:
            skipped += 1
    return out, skipped


class FallbackMolecularMetrics(_MolecularMetricsBase):
    """RDKit-free validity/uniqueness/novelty from the bond-inference tables.

    Validity: no atom exceeds its max allowed valence. Identity: canonical
    SMILES of the largest fragment (pure-python writer — standard strings,
    parseable by any toolkit; permutation-invariant like RDKit's). Same
    evaluate() contract as BasicMolecularMetrics.

    The novelty base is the training set by default; pass
    ``external_smiles`` (a list of SMILES strings from any source) to score
    novelty against an external artifact instead — entries are
    re-canonicalized with the same writer so comparison is on equal terms."""

    source = "valence-fallback"

    def __init__(self, dataset_info, dataset_keys_list=None, datadir: str = "data",
                 external_smiles: Optional[Sequence[str]] = None):
        self.dataset_info = dataset_info
        self.dataset_smiles_list = dataset_keys_list
        if external_smiles is not None:
            canon, skipped = canonicalize_external_smiles(external_smiles)
            if skipped:
                print(f"[fallback-metrics] novelty base: skipped {skipped}/"
                      f"{len(external_smiles)} external SMILES outside the "
                      f"supported subset")
            self.dataset_smiles_list = canon
        elif dataset_keys_list is None and "qm9" in dataset_info["name"]:
            try:
                self.dataset_smiles_list = retrieve_qm9_fallback_smiles(
                    dataset_info, datadir)
            except Exception:
                self.dataset_smiles_list = None

    def compute_validity(self, generated: Sequence[tuple]):
        valid = []
        for positions, atom_types in generated:
            key = molecule_fallback_smiles(positions, atom_types, self.dataset_info)
            if key is not None:
                valid.append(key)
        return valid, len(valid) / len(generated)


def make_molecular_metrics(dataset_info, datadir: str = "data",
                           external_smiles: Optional[Sequence[str]] = None):
    """BasicMolecularMetrics when RDKit is installed, else the pure-python
    fallback (so eval always reports a validity triple). external_smiles
    (fallback path only) replaces the training set as the novelty base."""
    if RDKIT_AVAILABLE:
        return BasicMolecularMetrics(dataset_info, datadir=datadir)
    return FallbackMolecularMetrics(dataset_info, datadir=datadir,
                                    external_smiles=external_smiles)
