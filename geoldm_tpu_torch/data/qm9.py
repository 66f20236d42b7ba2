"""QM9 from processed splits (port of ``geoldm_tpu/data/qm9.py:213-360``):
load ``<datadir>/qm9/{train,valid,test}.npz``, one-hot the species, convert
units, and iterate static-shape batches.

There is no download path: the processed splits must be on disk (the JAX
package's ``prepare_qm9`` writes them; ``data.synthetic.write_qm9_splits``
fabricates QM9-format splits for tests and smoke runs).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np

from geoldm_tpu_torch.data.collate import edge_mask_from_node_mask, prepare_split_arrays

QM9_TO_EV = {
    "U0": 27.2114, "U": 27.2114, "G": 27.2114, "H": 27.2114, "zpve": 27211.4,
    "gap": 27.2114, "homo": 27.2114, "lumo": 27.2114,
}


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
             subtract_thermo: bool = True):
    """Processed QM9 splits as numpy dicts -> (splits, charge_scale); each
    split has positions [M,N,3], charges [M,N], num_atoms [M], one_hot
    [M,N,S] and the scalar properties in eV. ``dataset`` may be 'qm9',
    'qm9_first_half' or 'qm9_second_half' (seed-42 halves of train)."""
    paths = {s: os.path.join(datadir, "qm9", f"{s}.npz") for s in ("train", "valid", "test")}
    missing = [p for p in paths.values() if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"processed QM9 splits not found: {', '.join(missing)}. This package does not "
            "download QM9; write the splits with geoldm_tpu_torch.data.synthetic."
            "write_qm9_splits (fabricated) or copy processed ones there")
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
