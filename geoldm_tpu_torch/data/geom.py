"""GEOM-Drugs conformers: extraction, fixed splits and size-bucketed
static-shape batches (port of ``geoldm_tpu/data/geom.py``).

- ``extract_conformers``: unpack the crude msgpack dump, keep each
  molecule's K lowest-energy conformers, optionally drop hydrogens, and
  save one [total_atoms, 5] array of (mol_id, atomic number, x, y, z) rows
  with the SMILES and the atom counts (reference build_geom_dataset.py:10-65);
  ``data.native_geom`` does the same in C++ without holding the dump.
- ``load_split_data``: split the ``geom_drugs_{tag}.npy`` rows (mol_id,
  atomic number, x, y, z) at mol_id boundaries, optionally drop molecules
  above a size, apply the fixed permutation ``geom_permutation.npy``, then
  take 10 % validation and 10 % test (reference build_geom_dataset.py:68-107).
- ``GeomLoader``: batches grouped into size buckets, each padded to its
  bucket's boundary and shuffled within and across buckets; the same file,
  seed and permutation give the JAX loader's batches in the JAX loader's
  order.
- ``split_dict``: a split stacked into the QM9 split-dict layout.

``cli.build_geom_dataset`` writes ``geom_drugs_{tag}.npy`` from the dump;
``data.synthetic.write_geom_conformers`` fabricates one for tests and smoke
runs. GEOM molecules carry no charge column: h_int is zeros.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from geoldm_tpu_torch.data.collate import build_masks
from geoldm_tpu_torch.utils.buckets import covering_buckets

DEFAULT_BUCKETS = (32, 48, 64, 80, 104, 128, 184)


def conformer_files(data_dir: str, conformations: int, remove_h: bool) -> Tuple[str, str, str]:
    """(rows .npy, atom counts .npy, SMILES .txt) an extraction writes."""
    tag = f"{'no_h_' if remove_h else ''}{conformations}"
    return (os.path.join(data_dir, f"geom_drugs_{tag}.npy"),
            os.path.join(data_dir, f"geom_drugs_n_{tag}.npy"),
            os.path.join(data_dir, "geom_drugs_smiles.txt"))


def extract_conformers(data_dir: str, data_file: str = "drugs_crude.msgpack",
                       conformations: int = 30, remove_h: bool = False) -> str:
    """msgpack -> geom_drugs_[no_h_]{K}.npy (+ SMILES, atom counts); returns
    the .npy path."""
    import msgpack

    save_file, counts_file, smiles_file = conformer_files(data_dir, conformations, remove_h)
    all_smiles: List[str] = []
    all_counts: List[int] = []
    rows: List[np.ndarray] = []
    mol_id = 0
    with open(os.path.join(data_dir, data_file), "rb") as f:
        for drugs_1k in msgpack.Unpacker(f):
            for smiles, info in drugs_1k.items():
                all_smiles.append(smiles)
                conformers = info["conformers"]
                energies = np.array([c["totalenergy"] for c in conformers])
                # A stable sort: ties keep their order, as the C++ extractor's
                # std::stable_sort does, so both write the same bytes.
                for idx in np.argsort(energies, kind="stable")[:conformations]:
                    coords = np.array(conformers[idx]["xyz"], dtype=float)  # n x 4
                    if remove_h:
                        coords = coords[coords[:, 0] != 1.0]
                    n = coords.shape[0]
                    all_counts.append(n)
                    rows.append(np.hstack([np.full((n, 1), mol_id, dtype=float), coords]))
                    mol_id += 1
    np.save(save_file, np.vstack(rows))
    with open(smiles_file, "w") as f:
        f.write("\n".join(all_smiles) + "\n")
    np.save(counts_file, np.array(all_counts))
    return save_file


def load_split_data(conformation_file: str, val_proportion: float = 0.1,
                    test_proportion: float = 0.1, filter_size: Optional[int] = None,
                    permutation_file: Optional[str] = None
                    ) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """-> (train, val, test) lists of [n, 4] (atomic_number, x, y, z) arrays.
    The permutation comes from ``geom_permutation.npy`` beside the file; if it
    is absent (or of another length) a seed-0 permutation is used, and an
    absent one is saved there, as the reference does."""
    if not os.path.exists(conformation_file):
        raise FileNotFoundError(
            f"GEOM conformer file not found: {conformation_file}. Extract one from the GEOM "
            "msgpack dump with python -m geoldm_tpu_torch.cli.build_geom_dataset, or "
            "fabricate one with geoldm_tpu_torch.data.synthetic.write_geom_conformers")
    base = os.path.dirname(os.path.abspath(conformation_file))
    all_data = np.load(conformation_file)
    mol_id = all_data[:, 0].astype(int)
    conformers = all_data[:, 1:]
    split_indices = np.nonzero(mol_id[:-1] - mol_id[1:])[0] + 1
    data_list = np.split(conformers, split_indices)

    if filter_size is not None:
        data_list = [m for m in data_list if m.shape[0] <= filter_size]
        if not data_list:
            raise ValueError(f"no molecule of at most {filter_size} atoms in {conformation_file}")

    perm_path = permutation_file or os.path.join(base, "geom_permutation.npy")
    if os.path.exists(perm_path):
        perm = np.load(perm_path)
        if len(perm) != len(data_list):
            print(f"warning: permutation length {len(perm)} != {len(data_list)} molecules "
                  "(different filter settings?); regenerating seed-0 perm")
            perm = np.random.RandomState(0).permutation(len(data_list))
    else:
        print(f"warning: {perm_path} missing; generating a seed-0 permutation")
        perm = np.random.RandomState(0).permutation(len(data_list))
        np.save(perm_path, perm)
    data_list = [data_list[i] for i in perm]

    num_mol = len(data_list)
    val_index = int(num_mol * val_proportion)
    test_index = val_index + int(num_mol * test_proportion)
    return data_list[test_index:], data_list[:val_index], data_list[val_index:test_index]


def _bucket_of(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"molecule with {n} atoms exceeds the largest bucket {buckets[-1]}")


class GeomLoader:
    """Size-bucketed static-shape batches over GEOM conformer lists: the
    QM9Loader's batch dicts (x CoM-centred, h_cat, h_int, node_mask,
    edge_mask, n_atoms), each padded to its bucket's boundary."""

    def __init__(self, data_list: Sequence[np.ndarray], dataset_info, batch_size: int,
                 shuffle: bool = True, include_charges: bool = True,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, drop_last: Optional[bool] = None,
                 seed: int = 0):
        self.dataset_info = dataset_info
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.include_charges = include_charges
        self.buckets = covering_buckets(buckets, dataset_info.max_n_nodes)
        self.drop_last = shuffle if drop_last is None else drop_last
        self._rng = np.random.default_rng(seed)
        self.atomic_numbers = np.asarray(dataset_info.atomic_numbers, dtype=np.int64)
        self.data_list = list(data_list)
        self._by_bucket: Dict[int, List[int]] = {b: [] for b in self.buckets}
        for i, mol in enumerate(self.data_list):
            self._by_bucket[_bucket_of(mol.shape[0], self.buckets)].append(i)

    def __len__(self) -> int:
        if self.drop_last:
            return sum(len(idxs) // self.batch_size for idxs in self._by_bucket.values())
        return sum(-(-len(idxs) // self.batch_size) for idxs in self._by_bucket.values())

    def _make_batch(self, idxs: List[int], pad: int) -> Dict[str, np.ndarray]:
        bsz = len(idxs)
        x = np.zeros((bsz, pad, 3), dtype=np.float32)
        h_cat = np.zeros((bsz, pad, len(self.atomic_numbers)), dtype=np.float32)
        n_atoms = np.zeros((bsz,), dtype=np.int64)
        for k, i in enumerate(idxs):
            mol = self.data_list[i]
            n = mol.shape[0]
            n_atoms[k] = n
            pos = mol[:, 1:4].astype(np.float32)
            x[k, :n] = pos - pos.mean(axis=0, keepdims=True)
            types = mol[:, 0].astype(np.int64)
            h_cat[k, :n] = (types[:, None] == self.atomic_numbers[None, :]).astype(np.float32)
        node_mask, edge_mask = build_masks(n_atoms, pad)
        return {
            "x": x * node_mask,
            "h_cat": h_cat * node_mask,
            "h_int": np.zeros((bsz, pad, 1 if self.include_charges else 0), dtype=np.float32),
            "node_mask": node_mask,
            "edge_mask": edge_mask,
            "n_atoms": n_atoms,
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        plan: List[Tuple[int, List[int]]] = []
        for b, idxs in self._by_bucket.items():
            idxs = list(idxs)
            if self.shuffle:
                self._rng.shuffle(idxs)
            stop = (len(idxs) // self.batch_size) * self.batch_size if self.drop_last \
                else len(idxs)
            for start in range(0, stop, self.batch_size):
                plan.append((b, idxs[start:start + self.batch_size]))
        if self.shuffle:
            self._rng.shuffle(plan)
        for pad, idxs in plan:
            yield self._make_batch(idxs, pad)


def split_dict(data_list: Sequence[np.ndarray], dataset_info,
               stored_n: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Stack a GEOM split (list of [n, 4] atomic_number+xyz arrays) into the
    QM9 split-dict layout (num_atoms / positions / one_hot / charges). The
    charges stay zero, as ``GeomLoader`` feeds h_int = zeros in training."""
    atomic = np.asarray(dataset_info.atomic_numbers, dtype=np.int64)
    m = len(data_list)
    num_atoms = np.array([mol.shape[0] for mol in data_list], dtype=np.int64)
    n = stored_n or (int(num_atoms.max()) if m else 0)
    positions = np.zeros((m, n, 3), dtype=np.float32)
    one_hot = np.zeros((m, n, len(atomic)), dtype=np.float32)
    charges = np.zeros((m, n), dtype=np.float32)
    for i, mol in enumerate(data_list):
        k = mol.shape[0]
        types = mol[:, 0].astype(np.int64)
        positions[i, :k] = mol[:, 1:4]
        one_hot[i, :k] = (types[:, None] == atomic[None, :]).astype(np.float32)
    return {"num_atoms": num_atoms, "positions": positions, "one_hot": one_hot,
            "charges": charges}
