"""QM9 (GDB9): preparation and loading (port of ``geoldm_tpu/data/qm9.py``).

- Preparation (``:53-210``): the GDB9 tarball, the excluded-molecule list
  and the atomic thermochemical references from figshare (fetched only when
  missing; with no network a clear error says where to place them), the xyz
  records parsed with their scalar properties, the fixed seed-0 100k / valid
  / 10% split over the non-excluded molecules, per-molecule thermochemical
  energies, and ``<datadir>/qm9/{train,valid,test}.npz`` written
  (``prepare_qm9``; ``force_download`` rebuilds them from the raw files,
  fetching only those missing). Reference: qm9/data/prepare/*.
- Loading (``:213-360``): the splits with one-hot species, eV units, thermo
  subtraction, the seed-42 halves and remove_h, and static-shape batches.
  ``load_qm9`` prepares missing splits first, as JAX's does.

``data.synthetic.write_qm9_splits`` fabricates QM9-format splits for tests
and smoke runs.
"""

from __future__ import annotations

import logging
import os
import tarfile
import urllib.request
from os.path import join
from typing import Dict, Iterator, Optional

import numpy as np

from geoldm_tpu_torch.data.collate import edge_mask_from_node_mask, prepare_split_arrays

logger = logging.getLogger(__name__)

CHARGE_OF = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}

GDB9_URL_DATA = "https://springernature.figshare.com/ndownloader/files/3195389"
GDB9_URL_EXCLUDED = "https://springernature.figshare.com/ndownloader/files/3195404"
GDB9_URL_THERMO = "https://springernature.figshare.com/ndownloader/files/3195395"

QM9_TO_EV = {
    "U0": 27.2114, "U": 27.2114, "G": 27.2114, "H": 27.2114, "zpve": 27211.4,
    "gap": 27.2114, "homo": 27.2114, "lumo": 27.2114,
}

PROPERTY_NAMES = (
    "index", "A", "B", "C", "mu", "alpha", "homo", "lumo", "gap", "r2",
    "zpve", "U0", "U", "H", "G", "Cv",
)

N_GDB9 = 133885
N_EXCLUDED = 3054
N_TRAIN = 100000


def _fetch(url: str, dest: str) -> None:
    """``url`` to ``dest`` unless it is there; with no network a RuntimeError
    saying where to place the file."""
    if os.path.exists(dest):
        return
    try:
        logger.info("downloading %s -> %s", url, dest)
        urllib.request.urlretrieve(url, filename=dest)
    except Exception as e:  # no network
        raise RuntimeError(
            f"Cannot download {url} (no network egress?). Place the file at "
            f"{dest} manually, or point datadir at a prepared dataset.") from e


def parse_xyz_gdb9(lines) -> dict:
    """One GDB9 xyz record (text lines) -> its property dict
    (qm9/data/prepare/process.py:161-202)."""
    num_atoms = int(lines[0])
    mol_props_raw = lines[1].split()
    charges, positions = [], []
    for line in lines[2:num_atoms + 2]:
        atom, px, py, pz, _ = line.replace("*^", "e").split()
        charges.append(CHARGE_OF[atom])
        positions.append([float(px), float(py), float(pz)])
    freq_line = lines[num_atoms + 2]

    props = {"index": int(mol_props_raw[1])}
    for name, val in zip(PROPERTY_NAMES[1:], mol_props_raw[2:]):
        props[name] = float(val)
    props["omega1"] = max(float(w) for w in freq_line.split())
    return {
        "num_atoms": num_atoms,
        "charges": np.asarray(charges, dtype=np.int64),
        "positions": np.asarray(positions, dtype=np.float32),
        **props,
    }


def generate_splits(excluded_txt: str) -> Dict[str, np.ndarray]:
    """The fixed seed-0 split: 100k train / 10% test / the rest valid over
    the non-excluded GDB9 indices (qm9/data/prepare/qm9.py:66-135)."""
    with open(excluded_txt) as f:
        tokens = [line.split()[0] for line in f if line.split()]
    excluded = []
    for t in tokens:
        try:
            excluded.append(int(t) - 1)
        except ValueError:
            continue
    assert len(excluded) == N_EXCLUDED, f"expected {N_EXCLUDED} excluded, got {len(excluded)}"

    included = np.array(sorted(set(range(N_GDB9)) - set(excluded)))
    n_mols = N_GDB9 - N_EXCLUDED
    n_test = int(0.1 * n_mols)
    n_valid = n_mols - (N_TRAIN + n_test)

    perm = np.random.RandomState(0).permutation(n_mols)
    train, valid, test = np.split(perm, [N_TRAIN, N_TRAIN + n_valid])
    return {"train": included[train], "valid": included[valid], "test": included[test]}


def parse_thermo(atomref_txt: str) -> Dict[str, Dict[int, float]]:
    """Atomic thermochemical reference energies by target and charge
    (qm9/data/prepare/qm9.py:138-177)."""
    targets = ["zpve", "U0", "U", "H", "G", "Cv"]
    thermo: Dict[str, Dict[int, float]] = {t: {} for t in targets}
    with open(atomref_txt) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] not in CHARGE_OF:
                continue
            for target, value in zip(targets, parts[1:]):
                thermo[target][CHARGE_OF[parts[0]]] = float(value)
    return thermo


def _stack_molecules(molecules: list) -> Dict[str, np.ndarray]:
    """Per-molecule arrays padded to the largest atom count and stacked."""
    n_max = max(m["num_atoms"] for m in molecules)
    m_count = len(molecules)
    out: Dict[str, np.ndarray] = {
        "num_atoms": np.array([m["num_atoms"] for m in molecules], dtype=np.int64),
        "charges": np.zeros((m_count, n_max), dtype=np.int64),
        "positions": np.zeros((m_count, n_max, 3), dtype=np.float32),
    }
    for i, m in enumerate(molecules):
        n = m["num_atoms"]
        out["charges"][i, :n] = m["charges"]
        out["positions"][i, :n] = m["positions"]
    for key in molecules[0]:
        if key in out:
            continue
        out[key] = np.array([m[key] for m in molecules], dtype=np.float64)
    return out


def add_thermo_targets(data: Dict[str, np.ndarray],
                       thermo: Dict[str, Dict[int, float]]) -> Dict[str, np.ndarray]:
    """Per-molecule thermochemical energies, ``<target>_thermo``
    (qm9/data/prepare/qm9.py:180-227)."""
    charges = data["charges"]
    for target, per_charge in thermo.items():
        total = np.zeros(charges.shape[0], dtype=np.float64)
        for z, e in per_charge.items():
            total += e * np.sum(charges == z, axis=1)
        data[target + "_thermo"] = total
    return data


def prepare_qm9(datadir: str, force_download: bool = False) -> Dict[str, str]:
    """The raw GDB9 files (fetched where missing) -> ``<datadir>/qm9/
    {train,valid,test}.npz``; -> split -> npz path. Does nothing when the
    three exist, unless ``force_download`` (qm9/data/prepare/qm9.py:15-63)."""
    qm9dir = join(datadir, "qm9")
    os.makedirs(qm9dir, exist_ok=True)
    paths = {s: join(qm9dir, f"{s}.npz") for s in ("train", "valid", "test")}
    if not force_download and all(os.path.exists(p) for p in paths.values()):
        return paths

    tar_path = join(qm9dir, "dsgdb9nsd.xyz.tar.bz2")
    excluded_path = join(qm9dir, "uncharacterized.txt")
    thermo_path = join(qm9dir, "atomref.txt")
    _fetch(GDB9_URL_DATA, tar_path)
    _fetch(GDB9_URL_EXCLUDED, excluded_path)
    _fetch(GDB9_URL_THERMO, thermo_path)

    splits = generate_splits(excluded_path)
    thermo = parse_thermo(thermo_path)

    with tarfile.open(tar_path, "r") as tar:
        members = tar.getmembers()
        for split, idxs in splits.items():
            keep = set(int(i) for i in idxs)
            molecules = []
            for i, member in enumerate(members):
                if i not in keep:
                    continue
                with tar.extractfile(member) as f:
                    lines = [ln.decode("utf-8") for ln in f.readlines()]
                molecules.append(parse_xyz_gdb9(lines))
            data = add_thermo_targets(_stack_molecules(molecules), thermo)
            np.savez_compressed(paths[split], **data)
            logger.info("wrote %s (%d molecules)", paths[split], len(molecules))
    return paths


def _remove_hydrogens(data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop H atoms, re-centre, repack (reference: qm9/data/utils.py:87-110)."""
    pos, charges = data["positions"], data["charges"]
    keep = charges > 1
    new_pos = np.zeros_like(pos)
    new_charges = np.zeros_like(charges)
    for i in range(pos.shape[0]):
        m = keep[i]
        p = pos[i][m]
        p = p - p.mean(axis=0, keepdims=True)
        n = int(m.sum())
        new_pos[i, :n] = p
        new_charges[i, :n] = charges[i][m]
    data = dict(data)
    data["positions"] = new_pos
    data["charges"] = new_charges
    data["num_atoms"] = (new_charges > 0).sum(axis=1)
    return data


def load_qm9(datadir: str, dataset: str = "qm9", remove_h: bool = False,
             subtract_thermo: bool = True, force_download: bool = False):
    """QM9 splits as numpy dicts -> (splits, charge_scale); each split has
    positions [M,N,3], charges [M,N], num_atoms [M], one_hot [M,N,S] and the
    scalar properties in eV. ``dataset`` may be 'qm9', 'qm9_first_half' or
    'qm9_second_half' (seed-42 halves of train). Missing splits are
    prepared first (``prepare_qm9``, ``force_download`` passed on)."""
    paths = prepare_qm9(datadir, force_download=force_download)
    splits: Dict[str, Dict[str, np.ndarray]] = {}
    for split, path in paths.items():
        with np.load(path) as f:
            splits[split] = {k: f[k] for k in f.files}

    if dataset in ("qm9_first_half", "qm9_second_half"):
        n = len(splits["train"]["num_atoms"])
        perm = np.random.RandomState(42).permutation(n)
        sl = perm[n // 2:] if dataset == "qm9_second_half" else perm[:n // 2]
        splits["train"] = {k: v[sl] for k, v in splits["train"].items()}
    elif dataset != "qm9":
        raise ValueError(dataset)
    if remove_h:
        splits = {s: _remove_hydrogens(d) for s, d in splits.items()}

    # Species across all splits (sorted unique charges, 0 = padding removed).
    all_species = np.unique(np.concatenate([np.unique(d["charges"]) for d in splits.values()]))
    all_species = all_species[all_species != 0]
    for d in splits.values():
        if subtract_thermo:
            for key in list(d.keys()):
                if key.endswith("_thermo"):
                    base = key[:-len("_thermo")]
                    d[base] = d[base] - d[key]
        d["one_hot"] = (d["charges"][..., None] == all_species[None, None, :]).astype(np.float32)
        for key, factor in QM9_TO_EV.items():
            if key in d:
                d[key] = d[key] * factor
    return splits, float(all_species.max())


def filter_atoms(splits, n_nodes: int):
    """Keep only molecules with exactly ``n_nodes`` atoms (qm9/dataset.py:72-81)."""
    out = {}
    for split, d in splits.items():
        sel = d["num_atoms"] == n_nodes
        out[split] = {k: v[sel] for k, v in d.items()}
    return out


class QM9Loader:
    """Static-shape batch iterator over a loaded split: x [B,N,3]
    (CoM-centred), h_cat [B,N,S], h_int [B,N,1 or 0], node_mask, edge_mask,
    n_atoms and any requested properties. Training drops the last partial
    batch so every step has the same shape."""

    def __init__(self, data: Dict[str, np.ndarray], batch_size: int, pad_nodes: int,
                 shuffle: bool = True, include_charges: bool = True,
                 drop_last: Optional[bool] = None, properties: tuple = (), seed: int = 0):
        self.data = data
        self.batch_size = batch_size
        self.pad_nodes = pad_nodes
        self.shuffle = shuffle
        self.include_charges = include_charges
        self.drop_last = shuffle if drop_last is None else drop_last
        self.properties = tuple(properties)
        self._rng = np.random.default_rng(seed)
        self.num_molecules = len(data["num_atoms"])

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_molecules // self.batch_size
        return -(-self.num_molecules // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = (self._rng.permutation(self.num_molecules) if self.shuffle
                 else np.arange(self.num_molecules))
        stop = len(self) * self.batch_size if self.drop_last else self.num_molecules
        d = self.data
        for start in range(0, stop, self.batch_size):
            idx = order[start:start + self.batch_size]
            n_atoms = d["num_atoms"][idx]
            batch = prepare_split_arrays(n_atoms, d["positions"][idx], d["one_hot"][idx],
                                         d["charges"][idx], self.pad_nodes,
                                         self.include_charges)
            batch["edge_mask"] = edge_mask_from_node_mask(batch["node_mask"])
            batch["n_atoms"] = n_atoms
            for prop in self.properties:
                batch[prop] = d[prop][idx].astype(np.float32)
            yield batch
