"""MD17 molecular-dynamics dataset preparation (numpy copy of
``geoldm_tpu/data/md17.py``; reference qm9/data/prepare/md17.py,
process.py:106-158): the xyz/energy/forces record parser and a download
that only runs when asked for and says what to do without a network.
GeoLDM itself trains on QM9 and GEOM.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

CHARGE_OF = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9, "S": 16}

MD17_BASE_URL = "http://quantum-machine.org/gdml/data/npz/"
MD17_SUBSETS = {
    "aspirin": "md17_aspirin.npz",
    "benzene": "md17_benzene2017.npz",
    "ethanol": "md17_ethanol.npz",
    "malonaldehyde": "md17_malonaldehyde.npz",
    "naphthalene": "md17_naphthalene.npz",
    "salicylic": "md17_salicylic.npz",
    "toluene": "md17_toluene.npz",
    "uracil": "md17_uracil.npz",
}


def parse_xyz_md17(lines: List[str]) -> Dict[str, np.ndarray]:
    """Parse one MD17-style xyz record with an energy(;forces) comment line.

    reference: qm9/data/prepare/process.py:106-158."""
    num_atoms = None
    energy = None
    forces = None
    atom_types: List[int] = []
    positions: List[List[float]] = []
    line_counter = 0
    for line in lines:
        if line.startswith("#"):
            continue
        if line_counter == 0:
            num_atoms = int(line)
        elif line_counter == 1:
            parts = line.split(";")
            energy = float(parts[0])
            if len(parts) == 2:
                forces = [
                    [float(v.strip("[]\n ")) for v in f.split(",")]
                    for f in parts[1].split("],[")
                ]
        else:
            parts = line.split()
            if len(parts) == 4:
                atom_types.append(CHARGE_OF[parts[0]])
                positions.append([float(v) for v in parts[1:]])
        line_counter += 1
    out = {
        "num_atoms": np.asarray(num_atoms),
        "energy": np.asarray(energy),
        "charges": np.asarray(atom_types, dtype=np.int64),
        "positions": np.asarray(positions, dtype=np.float32),
    }
    if forces is not None:
        out["forces"] = np.asarray(forces, dtype=np.float32)
    return out


def download_md17(datadir: str, subset: str) -> str:
    """Fetch an MD17 npz (gated for no-egress environments)."""
    import urllib.request

    assert subset in MD17_SUBSETS, f"unknown MD17 subset {subset}"
    os.makedirs(datadir, exist_ok=True)
    dest = os.path.join(datadir, MD17_SUBSETS[subset])
    if os.path.exists(dest):
        return dest
    url = MD17_BASE_URL + MD17_SUBSETS[subset]
    try:
        urllib.request.urlretrieve(url, dest)
    except Exception as e:
        raise RuntimeError(
            f"Cannot download {url} (no network egress?). Place the file at "
            f"{dest} manually."
        ) from e
    return dest
