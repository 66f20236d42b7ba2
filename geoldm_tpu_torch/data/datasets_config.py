"""Dataset metadata for QM9 (port of the QM9 entries of
``geoldm_tpu/data/datasets_config.py``): atom vocabularies and the
molecule-size histograms that DistributionNodes samples from. The numbers
are dataset facts, matching the reference registry
(configs/datasets_config.py:3-134). GEOM-Drugs comes with its slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class DatasetInfo:
    name: str
    atom_decoder: Tuple[str, ...]
    max_n_nodes: int
    n_nodes_histogram: Tuple[Tuple[int, int], ...]  # (n_atoms, count) pairs
    atom_type_counts: Tuple[int, ...]  # per atom-type occurrence counts
    with_h: bool
    colors: Tuple[str, ...] = ()
    radii: Tuple[float, ...] = ()
    atomic_numbers: Tuple[int, ...] = ()  # only for GEOM
    distance_histogram: Tuple[int, ...] = ()

    @property
    def atom_encoder(self) -> Dict[str, int]:
        return {a: i for i, a in enumerate(self.atom_decoder)}

    @property
    def n_nodes(self) -> Dict[int, int]:
        return dict(self.n_nodes_histogram)

    @property
    def num_atom_types(self) -> int:
        return len(self.atom_decoder)

    # dict-style access for call sites mirroring the reference registry.
    def __getitem__(self, key: str):
        if key == "atom_decoder":
            return list(self.atom_decoder)
        if key == "atom_encoder":
            return self.atom_encoder
        if key == "n_nodes":
            return self.n_nodes
        if key == "max_n_nodes":
            return self.max_n_nodes
        if key == "atom_types":
            return dict(enumerate(self.atom_type_counts))
        if key == "name":
            return self.name
        if key == "with_h":
            return self.with_h
        if key == "colors_dic":
            return list(self.colors)
        if key == "radius_dic":
            return list(self.radii)
        if key == "atomic_nb":
            return list(self.atomic_numbers)
        if key == "distances":
            return list(self.distance_histogram)
        raise KeyError(key)


def _hist(d: Dict[int, int]) -> Tuple[Tuple[int, int], ...]:
    return tuple(sorted(d.items()))


QM9_WITH_H = DatasetInfo(
    name="qm9",
    atom_decoder=("H", "C", "N", "O", "F"),
    max_n_nodes=29,
    with_h=True,
    n_nodes_histogram=_hist({
        3: 1, 4: 4, 5: 5, 6: 9, 7: 16, 8: 49, 9: 124, 10: 362, 11: 807,
        12: 1689, 13: 3060, 14: 5136, 15: 7796, 16: 10644, 17: 13025,
        18: 13364, 19: 13832, 20: 9482, 21: 9970, 22: 3393, 23: 4848,
        24: 539, 25: 1506, 26: 48, 27: 266, 29: 25,
    }),
    atom_type_counts=(923537, 635559, 101476, 140202, 2323),
    colors=("#FFFFFF99", "C7", "C0", "C3", "C1"),
    radii=(0.46, 0.77, 0.77, 0.77, 0.77),
    distance_histogram=tuple([
        903054, 307308, 111994, 57474, 40384, 29170, 47152, 414344, 2202212,
        573726, 1490786, 2970978, 756818, 969276, 489242, 1265402, 4587994,
        3187130, 2454868, 2647422, 2098884, 2001974, 1625206, 1754172,
        1620830, 1710042, 2133746, 1852492, 1415318, 1421064, 1223156,
        1322256, 1380656, 1239244, 1084358, 981076, 896904, 762008, 659298,
        604676, 523580, 437464, 413974, 352372, 291886, 271948, 231328,
        188484, 160026, 136322, 117850, 103546, 87192, 76562, 61840, 49666,
        43100, 33876, 26686, 22402, 18358, 15518, 13600, 12128, 9480, 7458,
        5088, 4726, 3696, 3362, 3396, 2484, 1988, 1490, 984, 734, 600, 456,
        482, 378, 362, 168, 124, 94, 88, 52, 44, 40, 18, 16, 8, 6, 2, 0, 0,
        0, 0, 0, 0, 0,
    ]),
)

QM9_WITHOUT_H = DatasetInfo(
    name="qm9",
    atom_decoder=("C", "N", "O", "F"),
    max_n_nodes=29,
    with_h=False,
    n_nodes_histogram=_hist({
        1: 2, 2: 5, 3: 7, 4: 25, 5: 91, 6: 475, 7: 2404, 8: 13625, 9: 83366,
    }),
    atom_type_counts=(635559, 101476, 140202, 2323),
    colors=("C7", "C0", "C3", "C1"),
    radii=(0.77, 0.77, 0.77, 0.77),
    distance_histogram=tuple([
        594, 1232, 3706, 4736, 5478, 9156, 8762, 13260, 45674, 174676,
        469292, 1182942, 126722, 25768, 28532, 51696, 232014, 299916, 686590,
        677506, 379264, 162794, 158732, 156404, 161742, 156486, 236176,
        310918, 245558, 164688, 98830, 81786, 89318, 91104, 92788, 83772,
        81572, 85032, 56296, 32930, 22640, 24124, 24010, 22120, 19730, 21968,
        18176, 12576, 8224, 6772, 3906, 4416, 4306, 4110, 3700, 3592, 3134,
        2268, 774, 674, 514, 594, 622, 672, 642, 472, 300, 170, 104, 48, 54,
        78, 78, 56, 48, 36, 26, 4, 2, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0,
    ]),
)

QM9_SECOND_HALF = DatasetInfo(
    name="qm9_second_half",
    atom_decoder=("H", "C", "N", "O", "F"),
    max_n_nodes=29,
    with_h=True,
    n_nodes_histogram=_hist({
        3: 1, 4: 3, 5: 3, 6: 5, 7: 7, 8: 25, 9: 62, 10: 178, 11: 412,
        12: 845, 13: 1541, 14: 2587, 15: 3865, 16: 5344, 17: 6461, 18: 6695,
        19: 6944, 20: 4794, 21: 4962, 22: 1701, 23: 2380, 24: 267, 25: 754,
        26: 17, 27: 132, 29: 15,
    }),
    atom_type_counts=(461622, 317604, 50852, 70033, 1164),
    colors=("#FFFFFF99", "C7", "C0", "C3", "C1"),
    radii=(0.46, 0.77, 0.77, 0.77, 0.77),
)


def get_dataset_info(dataset_name: str, remove_h: bool = False) -> DatasetInfo:
    """reference: configs/datasets_config.py:137-154 (QM9 entries)."""
    if dataset_name in ("qm9", "qm9_first_half"):
        if remove_h and dataset_name != "qm9":
            raise ValueError(f"{dataset_name} without hydrogens is not configured")
        return QM9_WITHOUT_H if remove_h else QM9_WITH_H
    if dataset_name == "qm9_second_half":
        if remove_h:
            raise ValueError("qm9_second_half without hydrogens is not configured")
        return QM9_SECOND_HALF
    raise ValueError(f"unknown or not yet ported dataset {dataset_name!r}")
