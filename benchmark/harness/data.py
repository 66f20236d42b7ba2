"""Synthetic molecules and traffic from a configuration's frozen dataset
statistics: sizes from its size histogram, atom types from its type
frequencies, coordinates a random cloud. The work of a step or a request is
set by the sizes; so a set of sizes is the same for every seed (the
histogram's quantiles) and the seed picks their order, the types, the
coordinates and the noise."""

from __future__ import annotations

from typing import Dict

import numpy as np

# Streams drawn from one --seed, each its own.
WEIGHTS, DATA, NOISE, TRAFFIC, LOADER, SAMPLE = range(6)


def sub_seed(seed: int, stream: int, *more: int) -> int:
    """An independent 63-bit seed for one purpose of one run."""
    state = np.random.SeedSequence([int(seed) % 2**64, stream, *more]).generate_state(
        1, dtype=np.uint64)[0]
    return int(state) % 2**63


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream, *more))


def histogram(cfg: dict):
    """(sizes, probabilities) of the configuration's size histogram."""
    h = cfg["data"]["n_nodes_histogram"]
    sizes = np.array(sorted(int(k) for k in h), dtype=np.int64)
    p = np.array([h[str(s)] for s in sizes], dtype=np.float64)
    return sizes, p / p.sum()


def quantile_sizes(cfg: dict, m: int) -> np.ndarray:
    """``m`` sizes at the histogram's quantiles (i + 0.5) / m, ascending:
    the same multiset for every seed, following the histogram as closely as
    ``m`` draws can."""
    sizes, p = histogram(cfg)
    cdf = np.cumsum(p)
    u = (np.arange(m) + 0.5) / m
    return sizes[np.minimum(np.searchsorted(cdf, u, side="left"), len(sizes) - 1)]


def type_probs(cfg: dict) -> np.ndarray:
    c = np.asarray(cfg["data"]["atom_type_counts"], dtype=np.float64)
    return c / c.sum()


def cloud(r: np.random.Generator, n: int) -> np.ndarray:
    """A random cloud of ``n`` atoms at about a bond's spacing (Angstrom)."""
    return (r.standard_normal((n, 3)) * (0.9 * n ** (1.0 / 3.0))).astype(np.float32)


def qm9_split(cfg: dict, m: int, seed: int) -> Dict[str, np.ndarray]:
    """A split in the QM9 loader's layout: num_atoms [M], positions [M, N, 3],
    charges [M, N] (atomic numbers), one_hot [M, N, C]."""
    r = rng(seed, DATA)
    n_max = cfg["data"]["max_n_nodes"]
    sizes = r.permutation(quantile_sizes(cfg, m))
    nc = len(cfg["data"]["atom_decoder"])
    types = r.choice(nc, size=(m, n_max), p=type_probs(cfg))
    mask = np.arange(n_max)[None, :] < sizes[:, None]
    pos = (r.standard_normal((m, n_max, 3))
           * (0.9 * sizes[:, None, None] ** (1.0 / 3.0))).astype(np.float32) * mask[..., None]
    charges = np.asarray(cfg["data"]["charges"], dtype=np.float32)[types] * mask
    one_hot = (np.eye(nc, dtype=np.float32)[types] * mask[..., None]).astype(np.float32)
    return {"num_atoms": sizes.astype(np.int64), "positions": pos, "charges": charges,
            "one_hot": one_hot}


def log_p_n(cfg: dict, n_atoms) -> np.ndarray:
    """log p(N) of each size under the configuration's histogram."""
    sizes, p = histogram(cfg)
    lp = dict(zip(sizes.tolist(), np.log(p + 1e-30)))
    return np.array([lp[int(n)] for n in np.asarray(n_atoms)], dtype=np.float32)
