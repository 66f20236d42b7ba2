"""QM9 preparation (``data.qm9``: the GDB9 xyz parser, the fixed split, the
thermochemical references, ``prepare_qm9`` and ``load_qm9``'s call of it)
against the JAX package's, on the fabricated records of
tests/test_qm9_data.py and on a small fabricated GDB9 tarball
(``data.synthetic.write_gdb9_raw``). ``urllib.request.urlretrieve`` raises
throughout: a test that reached the network would fail, not hang."""

import os

import numpy as np
import pytest

from geoldm_tpu.data import qm9 as jqm9
from geoldm_tpu_torch.data import qm9 as pqm9
from geoldm_tpu_torch.data.synthetic import write_gdb9_raw
from tests.test_qm9_data import XYZ_RECORD


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(url, filename=None, *a, **k):
        raise OSError(f"network refused in tests: {url}")

    monkeypatch.setattr(pqm9.urllib.request, "urlretrieve", refuse)


def _same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k
        else:
            assert type(g) is type(w) and g == w, k


@pytest.mark.parametrize("record", ["plain", "scientific"])
def test_parse_xyz_matches_jax(record):
    rec = XYZ_RECORD if record == "plain" else XYZ_RECORD.replace("-0.0126981359", "-1.23*^-5")
    _same(pqm9.parse_xyz_gdb9(rec.splitlines()), jqm9.parse_xyz_gdb9(rec.splitlines()))


def test_splits_thermo_and_targets_match_jax(tmp_path):
    excluded = tmp_path / "uncharacterized.txt"
    excluded.write_text("header line with no ints\n" + "".join(
        f"{i * 40 + 1} something\n" for i in range(pqm9.N_EXCLUDED)))
    _same(pqm9.generate_splits(str(excluded)), jqm9.generate_splits(str(excluded)))
    thermo = tmp_path / "atomref.txt"
    thermo.write_text("# header\nH 0.1 -0.5 -0.49 -0.49 -0.51 2.98\n"
                      "C 0.2 -37.8 -37.84 -37.84 -37.86 2.98\ngarbage line\n")
    assert pqm9.parse_thermo(str(thermo)) == jqm9.parse_thermo(str(thermo))
    mols = [pqm9.parse_xyz_gdb9(XYZ_RECORD.splitlines()),
            pqm9.parse_xyz_gdb9(XYZ_RECORD.replace("5\n", "3\n", 1).splitlines()[:5]
                                + XYZ_RECORD.splitlines()[7:])]
    stacked = pqm9._stack_molecules(mols)
    _same(stacked, jqm9._stack_molecules(mols))
    ref = pqm9.parse_thermo(str(thermo))
    _same(pqm9.add_thermo_targets(dict(stacked), ref), jqm9.add_thermo_targets(dict(stacked), ref))
    for name in ("GDB9_URL_DATA", "GDB9_URL_EXCLUDED", "GDB9_URL_THERMO", "QM9_TO_EV",
                 "PROPERTY_NAMES", "N_GDB9", "N_EXCLUDED", "N_TRAIN", "CHARGE_OF"):
        assert getattr(pqm9, name) == getattr(jqm9, name), name


def _npz(paths):
    out = {}
    for split, path in paths.items():
        with np.load(path) as f:
            out[split] = {k: f[k] for k in f.files}
    return out


@pytest.mark.parametrize("force_download", [False, True])
def test_prepare_qm9_writes_jax_npz(tmp_path, force_download):
    """``prepare_qm9`` from the same raw files writes the splits JAX's
    writes, key for key and bit for bit; with ``force_download`` it rebuilds
    splits already on disk (here a stale one) from the raw files."""
    roots = {}
    for side in ("port", "jax"):
        roots[side] = str(tmp_path / side)
        write_gdb9_raw(roots[side], 64, seed=3)
        if force_download:
            os.makedirs(os.path.join(roots[side], "qm9"), exist_ok=True)
            for split in ("train", "valid", "test"):
                np.savez_compressed(os.path.join(roots[side], "qm9", f"{split}.npz"),
                                    num_atoms=np.zeros(1))
    got = _npz(pqm9.prepare_qm9(roots["port"], force_download=force_download))
    want = _npz(jqm9.prepare_qm9(roots["jax"], force_download=force_download))
    assert [len(got[s]["num_atoms"]) for s in ("train", "valid", "test")] == [50, 7, 5]
    for split in want:
        _same(got[split], want[split])
    # Present splits are kept as they are without the flag.
    stamp = os.path.getmtime(os.path.join(roots["port"], "qm9", "train.npz"))
    pqm9.prepare_qm9(roots["port"])
    assert os.path.getmtime(os.path.join(roots["port"], "qm9", "train.npz")) == stamp


def test_load_qm9_prepares_missing_splits_as_jax(tmp_path):
    """``load_qm9`` on raw files alone prepares the splits, then loads what
    JAX's loads (one-hot species, eV units, thermo subtracted)."""
    for side in ("port", "jax"):
        write_gdb9_raw(str(tmp_path / side), 64, seed=4)
    got, scale = pqm9.load_qm9(str(tmp_path / "port"), force_download=True)
    want, jscale = jqm9.load_qm9(str(tmp_path / "jax"), force_download=True)
    assert scale == jscale
    for split in want:
        _same(got[split], want[split])


def test_fetch_without_network_says_where_to_place_the_file(tmp_path):
    with pytest.raises(RuntimeError, match="Place the file at .*atomref.txt"):
        pqm9._fetch(pqm9.GDB9_URL_THERMO, str(tmp_path / "atomref.txt"))
