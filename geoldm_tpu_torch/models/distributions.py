"""Categorical distribution over molecule sizes (port of
``geoldm_tpu/models/distributions.py:16-46``), host-side numpy."""

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
