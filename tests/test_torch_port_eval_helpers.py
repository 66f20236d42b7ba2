"""The evaluation helpers JAX's tests hold and no CLI calls, against the JAX
package's: ``analyze_node_distribution`` and ``earth_mover_distance``
(``evalsuite/analyze.py``), ``graph_canonical_key`` and
``molecule_graph_key`` (``evalsuite/rdkit_metrics.py``), on the molecules of
tests/test_rdkit_metrics.py and on random histograms."""

import numpy as np
import pytest

from geoldm_tpu.evalsuite import analyze as jan
from geoldm_tpu.evalsuite import rdkit_metrics as jrm
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.evalsuite import analyze as pan
from geoldm_tpu_torch.evalsuite import rdkit_metrics as prm
from tests.test_rdkit_metrics import BAD_O3H, GENERATED, H2, INFO, WATER, WATER_PERM

PINFO = get_dataset_info("qm9")


@pytest.mark.parametrize("name", ["WATER", "WATER_PERM", "H2", "BAD_O3H"])
def test_molecule_graph_key_matches_jax(name):
    mol = {"WATER": WATER, "WATER_PERM": WATER_PERM, "H2": H2, "BAD_O3H": BAD_O3H}[name]
    assert prm.molecule_graph_key(*mol, PINFO) == jrm.molecule_graph_key(*mol, INFO)


def test_graph_keys_partition_as_jax():
    keys = [prm.molecule_graph_key(*m, PINFO) for m in (WATER, WATER_PERM, H2, BAD_O3H)]
    assert keys[0] == keys[1] != keys[2] and keys[3] is None
    rng = np.random.default_rng(0)
    for n in (1, 3, 7):
        symbols = list(rng.choice(["C", "N", "O", "H"], size=n))
        orders = np.triu(rng.integers(0, 3, (n, n)), 1)
        orders = orders + orders.T
        assert prm.graph_canonical_key(symbols, orders) == jrm.graph_canonical_key(symbols, orders)


def test_analyze_node_distribution_matches_jax():
    assert pan.analyze_node_distribution(GENERATED) == jan.analyze_node_distribution(GENERATED)


@pytest.mark.parametrize("seed", range(4))
def test_earth_mover_distance_matches_jax(seed):
    rng = np.random.default_rng(seed)
    h1, h2 = rng.integers(0, 50, 30), rng.integers(0, 50, 30)
    h1[0] += 1
    h2[0] += 1
    assert pan.earth_mover_distance(h1, h2) == pytest.approx(jan.earth_mover_distance(h1, h2),
                                                             rel=1e-12, abs=1e-15)
    assert pan.earth_mover_distance(h1, h1) == 0.0
