"""Host-side categorical distributions over molecule sizes and conditioning
properties (port of ``geoldm_tpu/models/distributions.py``), numpy."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


class DistributionNodes:
    """Categorical over the number of atoms, from the dataset histogram
    (reference: qm9/models.py:178-215)."""

    def __init__(self, histogram: Dict[int, int]):
        self.n_nodes = np.array(sorted(histogram.keys()), dtype=np.int64)
        probs = np.array([histogram[n] for n in self.n_nodes], dtype=np.float64)
        self.probs = probs / probs.sum()
        self._idx_of = {int(n): i for i, n in enumerate(self.n_nodes)}
        self.entropy = float(np.sum(self.probs * np.log(self.probs + 1e-30)))

    def sample(self, n_samples: int = 1, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        idx = rng.choice(len(self.probs), size=n_samples, p=self.probs)
        return self.n_nodes[idx]

    def log_prob(self, batch_n_nodes: Sequence[int]) -> np.ndarray:
        ns = np.asarray(batch_n_nodes)
        unseen = sorted({int(n) for n in ns.ravel()} - self._idx_of.keys())
        if unseen:
            raise ValueError(
                f"molecule sizes {unseen} are not in the dataset's n_nodes histogram "
                f"(known: {int(self.n_nodes.min())}..{int(self.n_nodes.max())})")
        idcs = np.array([self._idx_of[int(n)] for n in ns])
        return np.log(self.probs + 1e-30)[idcs]


class DistributionProperty:
    """Per-molecule-size histograms of the conditioning properties, built
    from the train split (num_atoms [M], values [M]); draws are normalized
    with mean/MAD (reference: qm9/models.py:218-289). Draws follow JAX's
    numpy calls one for one, so a seeded ``Generator`` gives the same rows."""

    def __init__(self, num_atoms: np.ndarray, properties: Dict[str, np.ndarray],
                 num_bins: int = 1000, normalizer: Optional[Dict[str, Dict[str, float]]] = None):
        self.num_bins = num_bins
        self.properties = list(properties.keys())
        self.distributions: Dict[str, Dict[int, dict]] = {}
        num_atoms = np.asarray(num_atoms)
        for prop, values in properties.items():
            values = np.asarray(values, dtype=np.float64)
            dist = {}
            for n in range(int(num_atoms.min()), int(num_atoms.max()) + 1):
                vals = values[num_atoms == n]
                if len(vals) > 0:
                    dist[n] = self._histogram(vals)
            self.distributions[prop] = dist
        self.normalizer = normalizer

    def set_normalizer(self, normalizer: Dict[str, Dict[str, float]]) -> None:
        self.normalizer = normalizer

    def _histogram(self, values: np.ndarray) -> dict:
        prop_min, prop_max = values.min(), values.max()
        prop_range = prop_max - prop_min + 1e-12
        idx = ((values - prop_min) / prop_range * self.num_bins).astype(np.int64)
        idx = np.minimum(idx, self.num_bins - 1)
        hist = np.bincount(idx, minlength=self.num_bins).astype(np.float64)
        return {"probs": hist / hist.sum(), "params": (float(prop_min), float(prop_max))}

    def _normalize(self, val: float, prop: str) -> float:
        assert self.normalizer is not None, "call set_normalizer first"
        return (val - self.normalizer[prop]["mean"]) / self.normalizer[prop]["mad"]

    def _nearest_size(self, prop: str, n_nodes: int) -> int:
        """The nearest molecule size with data (the reference raises a
        KeyError on an unseen size, qm9/models.py:269)."""
        dist = self.distributions[prop]
        if int(n_nodes) in dist:
            return int(n_nodes)
        sizes = np.array(sorted(dist.keys()))
        return int(sizes[np.argmin(np.abs(sizes - int(n_nodes)))])

    def sample(self, n_nodes: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """One normalized row [P] for a molecule of ``n_nodes`` atoms: a bin
        from the size's histogram, then a uniform value inside it."""
        rng = rng or np.random.default_rng()
        vals = []
        for prop in self.properties:
            dist = self.distributions[prop][self._nearest_size(prop, int(n_nodes))]
            i = rng.choice(self.num_bins, p=dist["probs"])
            lo, hi = dist["params"]
            prop_range = hi - lo
            left = i / self.num_bins * prop_range + lo
            right = (i + 1) / self.num_bins * prop_range + lo
            vals.append(self._normalize(rng.uniform(left, right), prop))
        return np.array(vals, dtype=np.float32)

    def sample_batch(self, nodesxsample: Sequence[int],
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """[len(nodesxsample), P] normalized rows, one per molecule."""
        rng = rng or np.random.default_rng()
        return np.stack([self.sample(int(n), rng) for n in nodesxsample])
