"""The traffic generators: the same seed gives the same inputs, every seed
the same set of sizes, and the sets follow the frozen histograms."""

import numpy as np
import pytest
import tiny  # noqa: F401

from harness import core
from harness import data as D


@pytest.mark.parametrize("cfg_name", ["qm9_ldm", "geom_ldm"])
def test_quantile_sizes_follow_the_histogram(cfg_name):
    cfg = core.config(cfg_name)
    sizes, p = D.histogram(cfg)
    m = 5000
    drawn = D.quantile_sizes(cfg, m)
    cdf_drawn = np.array([(drawn <= s).mean() for s in sizes])
    assert np.abs(cdf_drawn - np.cumsum(p)).max() <= 1.0 / m + 1e-12
    assert set(drawn) <= set(sizes.tolist())


def test_qm9_split_is_the_seeds():
    cfg = core.config("qm9_ldm")
    a, b = D.qm9_split(cfg, 300, 7), D.qm9_split(cfg, 300, 7)
    c = D.qm9_split(cfg, 300, 8)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["positions"], c["positions"])
    np.testing.assert_array_equal(np.sort(a["num_atoms"]), np.sort(c["num_atoms"]))
    n = a["num_atoms"]
    mask = np.arange(29)[None, :] < n[:, None]
    assert ((a["charges"] > 0) == mask).all()
    assert (a["one_hot"].sum(-1) == mask).all()


def test_sub_seeds_differ_by_purpose_and_take_large_seeds():
    seeds = {D.sub_seed(2**33 + 5, s) for s in range(6)}
    assert len(seeds) == 6 and all(0 <= s < 2**63 for s in seeds)
