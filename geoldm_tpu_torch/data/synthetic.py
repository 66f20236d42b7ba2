"""Synthetic molecules (port of ``geoldm_tpu/data/synthetic.py``), for tests
and smoke runs where the real data is not on disk: batches, QM9-format
splits, raw GDB9 files for QM9 preparation and GEOM-format conformer files.
Sizes follow the dataset's size histogram, atom types its type marginals,
coordinates are Gaussians at about bond-length scale, and QM9 charges are
the atomic numbers (the QM9 'charges' column).
"""

from __future__ import annotations

import io
import os
import tarfile
from typing import Dict, Optional

import numpy as np

from geoldm_tpu_torch.data.collate import build_masks, collate_molecules

_ATOMIC_NUMBER = {
    "H": 1, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9, "Al": 13, "Si": 14,
    "P": 15, "S": 16, "Cl": 17, "As": 33, "Br": 35, "I": 53, "Hg": 80,
    "Bi": 83,
}


def atomic_numbers(info) -> np.ndarray:
    if info.atomic_numbers:
        return np.asarray(info.atomic_numbers, dtype=np.float32)
    return np.asarray([_ATOMIC_NUMBER[a] for a in info.atom_decoder], dtype=np.float32)


def synthetic_batch(info, batch_size: int, pad_nodes: Optional[int] = None,
                    rng: Optional[np.random.Generator] = None, include_charges: bool = True,
                    coord_scale: float = 1.7, n_atoms=None) -> Dict[str, np.ndarray]:
    """A collated batch; ``n_atoms`` fixes the sizes instead of drawing them."""
    rng = rng or np.random.default_rng(0)
    pad_nodes = pad_nodes or info.max_n_nodes
    sizes = np.array([n for n, _ in info.n_nodes_histogram])
    counts = np.array([c for _, c in info.n_nodes_histogram], dtype=np.float64)
    type_counts = np.asarray(info.atom_type_counts, dtype=np.float64)
    type_probs = type_counts / type_counts.sum()
    z = atomic_numbers(info)

    if n_atoms is None:
        n_atoms = rng.choice(sizes, size=batch_size, p=counts / counts.sum())
    n_atoms = np.minimum(np.asarray(n_atoms), pad_nodes)
    positions, one_hots, charges = [], [], []
    for n in n_atoms:
        positions.append(rng.standard_normal((n, 3)).astype(np.float32) * coord_scale)
        types = rng.choice(len(type_probs), size=n, p=type_probs)
        one_hots.append(np.eye(len(type_probs), dtype=np.float32)[types])
        charges.append(z[types])
    return collate_molecules(positions, one_hots, charges, pad_nodes,
                             include_charges=include_charges)


def sampling_masks(info, batch_size: int, pad_nodes: Optional[int] = None,
                   rng: Optional[np.random.Generator] = None,
                   nodesxsample: Optional[np.ndarray] = None):
    """node/edge masks for sampling, sizes from the dataset histogram
    (reference: qm9/sampling.py:110-128) -> (node_mask, edge_mask, sizes)."""
    rng = rng or np.random.default_rng(0)
    pad_nodes = pad_nodes or info.max_n_nodes
    if nodesxsample is None:
        sizes = np.array([n for n, _ in info.n_nodes_histogram])
        counts = np.array([c for _, c in info.n_nodes_histogram], dtype=np.float64)
        nodesxsample = rng.choice(sizes, size=batch_size, p=counts / counts.sum())
    nodesxsample = np.minimum(np.asarray(nodesxsample), pad_nodes)
    return build_masks(nodesxsample, pad_nodes) + (nodesxsample,)


def write_qm9_splits(datadir: str, info, sizes: Dict[str, int], seed: int = 0) -> None:
    """Write ``<datadir>/qm9/{split}.npz`` in the processed-QM9 format that
    ``data.qm9.load_qm9`` reads (num_atoms, charges, positions and a few
    scalar properties), from ``synthetic_batch``. ``sizes`` maps each split
    to its molecule count. Each split's first molecule is given every species
    once, so the one-hot width is the dataset's whatever the draw."""
    rng = np.random.default_rng(seed)
    z = atomic_numbers(info).astype(np.int64)
    os.makedirs(os.path.join(datadir, "qm9"), exist_ok=True)
    for split, m in sizes.items():
        batch = synthetic_batch(info, m, rng=rng)
        n_atoms = batch["n_atoms"].copy()
        charges = (batch["h_cat"] @ z).astype(np.int64)  # padded rows stay 0
        n_atoms[0] = max(n_atoms[0], len(z))
        charges[0, :len(z)] = z
        positions = batch["x"].copy()
        positions[0, :n_atoms[0]] = rng.standard_normal((n_atoms[0], 3)) * 1.7
        np.savez_compressed(
            os.path.join(datadir, "qm9", f"{split}.npz"), num_atoms=n_atoms, charges=charges,
            positions=positions.astype(np.float32),
            alpha=rng.standard_normal(m) * 8 + 75, mu=np.abs(rng.standard_normal(m)),
            U0=rng.standard_normal(m), U0_thermo=rng.standard_normal(m))


def write_gdb9_raw(datadir: str, n_molecules: int, seed: int = 0) -> None:
    """The three raw files ``data.qm9.prepare_qm9`` reads, fabricated under
    ``<datadir>/qm9/``: a ``dsgdb9nsd.xyz.tar.bz2`` of ``n_molecules`` GDB9
    xyz records (3-9 atoms of H, C, N, O, F, sizes QM9 holds; the 15 scalar
    properties; a coordinate in the files' ``*^`` notation; the frequencies
    line and the two identifier lines), an ``uncharacterized.txt`` of the 3054 excluded ids
    (every 40th molecule) and an ``atomref.txt``. With 64 molecules each
    split receives some (50 / 7 / 5)."""
    from geoldm_tpu_torch.data.qm9 import N_EXCLUDED

    rng = np.random.default_rng(seed)
    qm9dir = os.path.join(datadir, "qm9")
    os.makedirs(qm9dir, exist_ok=True)
    symbols = ("H", "C", "N", "O", "F")
    with tarfile.open(os.path.join(qm9dir, "dsgdb9nsd.xyz.tar.bz2"), "w:bz2") as tar:
        for i in range(n_molecules):
            n = int(rng.integers(3, 10))
            atoms = rng.choice(symbols, size=n)
            props = rng.standard_normal(15) * 10
            lines = [str(n), "gdb " + str(i + 1) + "\t" + "\t".join(f"{v:.6f}" for v in props)]
            for a in atoms:
                xyz = rng.standard_normal(3) * 1.5
                coords = [f"{v:.10f}" if k else f"{v * 1e-5:.6e}".replace("e", "*^")
                          for k, v in enumerate(xyz)]
                lines.append(f"{a}\t" + "\t".join(coords) + f"\t{rng.standard_normal():.6f}")
            lines.append("\t".join(f"{v:.4f}" for v in rng.uniform(100, 4000, size=3 * n)))
            lines += ["SMILES\tSMILES", "InChI=1S/x\tInChI=1S/x"]
            data = ("\n".join(lines) + "\n").encode()
            info = tarfile.TarInfo(f"dsgdb9nsd_{i + 1:06d}.xyz")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    with open(os.path.join(qm9dir, "uncharacterized.txt"), "w") as f:
        f.write("Excluded molecules: index and reason\n")
        f.writelines(f"{i * 40 + 1} fabricated\n" for i in range(N_EXCLUDED))
    with open(os.path.join(qm9dir, "atomref.txt"), "w") as f:
        f.write("# atomic reference energies: zpve U0 U H G Cv\n")
        for sym in symbols:
            f.write(sym + " " + " ".join(f"{v:.6f}" for v in rng.standard_normal(6)) + "\n")


def write_geom_conformers(datadir: str, info, n_molecules: int, seed: int = 0,
                          sizes=()) -> str:
    """Write ``<datadir>/geom_drugs_30.npy`` in the format that
    ``data.geom.load_split_data`` reads (rows of mol_id, atomic number, x, y,
    z) -> its path. Sizes follow the dataset's size histogram and atom types
    its type marginals; the last ``len(sizes)`` molecules take the given
    sizes (each must be in the histogram, so that log p(N) is defined). The
    identity is written to ``geom_permutation.npy``, so the splits follow
    the file: 10 % validation, 10 % test, then train, which holds the given
    sizes when they are at most 80 % of the file."""
    rng = np.random.default_rng(seed)
    hist = dict(info.n_nodes_histogram)
    unknown = sorted({int(n) for n in sizes} - hist.keys())
    if unknown:
        raise ValueError(f"sizes {unknown} are not in the {info.name} size histogram")
    n_free = n_molecules - len(sizes)
    if n_free < 0:
        raise ValueError(f"{len(sizes)} given sizes for {n_molecules} molecules")
    known = np.array(sorted(hist))
    counts = np.array([hist[n] for n in known], dtype=np.float64)
    n_atoms = np.concatenate([rng.choice(known, size=n_free, p=counts / counts.sum()),
                              np.asarray(sizes, dtype=np.int64)]).astype(np.int64)
    type_counts = np.asarray(info.atom_type_counts, dtype=np.float64)
    z = atomic_numbers(info)
    rows = []
    for mol_id, n in enumerate(n_atoms):
        types = rng.choice(len(type_counts), size=n, p=type_counts / type_counts.sum())
        pos = rng.standard_normal((n, 3)) * 1.7
        rows.append(np.hstack([np.full((n, 1), mol_id, dtype=float), z[types][:, None], pos]))
    os.makedirs(datadir, exist_ok=True)
    path = os.path.join(datadir, "geom_drugs_30.npy")
    np.save(path, np.vstack(rows))
    np.save(os.path.join(datadir, "geom_permutation.npy"), np.arange(n_molecules))
    return path


def packb(obj) -> bytes:
    """``obj`` in msgpack, byte for byte what ``msgpack.packb`` (use_bin_type,
    float64) writes, for the types a GEOM crude dump holds: dict, list /
    tuple, str, bytes, int, float, bool and None. Lets a host without the
    msgpack package write a dump for ``cli.build_geom_dataset``."""
    import struct

    out = bytearray()

    def length(n, fix_base, fix_max, codes):
        if n <= fix_max:
            out.append(fix_base | n)
            return
        for code, fmt, top in codes:
            if n <= top:
                out.append(code)
                out.extend(struct.pack(fmt, n))
                return
        raise ValueError(f"length {n} is too long for msgpack")

    def enc(o):
        if o is None:
            out.append(0xC0)
        elif isinstance(o, bool):
            out.append(0xC3 if o else 0xC2)
        elif isinstance(o, int):
            if 0 <= o < 0x80 or -32 <= o < 0:
                out.extend(struct.pack(">b" if o < 0 else ">B", o))
                return
            table = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF), (0xCE, ">I", 0, 0xFFFFFFFF),
                     (0xCF, ">Q", 0, 2**64 - 1)) if o > 0 else (
                (0xD0, ">b", -2**7, 0), (0xD1, ">h", -2**15, 0), (0xD2, ">i", -2**31, 0),
                (0xD3, ">q", -2**63, 0))
            for code, fmt, lo, hi in table:
                if lo <= o <= hi:
                    out.append(code)
                    out.extend(struct.pack(fmt, o))
                    return
            raise ValueError(f"integer {o} does not fit msgpack's 64 bits")
        elif isinstance(o, float):
            out.append(0xCB)
            out.extend(struct.pack(">d", o))
        elif isinstance(o, str):
            b = o.encode("utf-8")
            length(len(b), 0xA0, 31, ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                                      (0xDB, ">I", 0xFFFFFFFF)))
            out.extend(b)
        elif isinstance(o, (bytes, bytearray)):
            length(len(o), 0xC4, -1, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                                      (0xC6, ">I", 0xFFFFFFFF)))
            out.extend(o)
        elif isinstance(o, (list, tuple)):
            length(len(o), 0x90, 15, ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF)))
            for v in o:
                enc(v)
        elif isinstance(o, dict):
            length(len(o), 0x80, 15, ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF)))
            for k, v in o.items():
                enc(k)
                enc(v)
        else:
            raise TypeError(f"cannot pack {type(o).__name__}")

    enc(obj)
    return bytes(out)


def write_geom_msgpack(datadir: str, info, n_smiles: int, conformers: int = 4, seed: int = 0,
                       sizes=(), chunk: int = 1000, data_file: str = "drugs_crude.msgpack"
                       ) -> str:
    """Write a crude GEOM-Drugs dump in the format ``cli.build_geom_dataset``
    reads: chunks of up to ``chunk`` molecules, ``{smiles: {"conformers":
    [{"totalenergy": e, "xyz": [[Z, x, y, z], ...]}, ...]}}`` -> its path.
    Molecule i has ``conformers`` conformers of ``sizes[i]`` atoms (default:
    drawn from the dataset's size histogram), atom types from its type
    marginals (hydrogens included), coordinates Gaussians at bond-length
    scale and random energies."""
    rng = np.random.default_rng(seed)
    if len(sizes) == 0:
        hist = np.array(info.n_nodes_histogram, dtype=np.float64)
        sizes = rng.choice(hist[:, 0].astype(int), size=n_smiles, p=hist[:, 1] / hist[:, 1].sum())
    type_counts = np.asarray(info.atom_type_counts, dtype=np.float64)
    z = atomic_numbers(info)
    os.makedirs(datadir, exist_ok=True)
    path = os.path.join(datadir, data_file)
    with open(path, "wb") as f:
        for start in range(0, n_smiles, chunk):
            block = {}
            for i in range(start, min(start + chunk, n_smiles)):
                n = int(sizes[i])
                types = rng.choice(len(type_counts), size=n, p=type_counts / type_counts.sum())
                block[f"C{i}N"] = {"conformers": [
                    {"totalenergy": float(rng.standard_normal()),
                     "xyz": [[int(z[t])] + [float(v) for v in rng.standard_normal(3) * 1.7]
                             for t in types]}
                    for _ in range(conformers)]}
            f.write(packb(block))
    return path
