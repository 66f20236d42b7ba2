"""The port's data builders, FLOP count and train-step benchmark against the
JAX package's on the CPU: GEOM extraction (the Python path, the port's own
binding of the C++ extractor and ``cli.build_geom_dataset``) against JAX's
Python extractor on the fixture of tests/test_native_geom.py, the MD17
record parser, ``utils.flops``' integers, ``cli.bench_train``'s JSON line,
and the msgpack encoder a host without msgpack writes a dump with."""

import json
import os

import msgpack
import numpy as np
import pytest

from geoldm_tpu.data import md17 as jmd17
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.data.geom import extract_conformers as jax_extract
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.utils import flops as jflops
from geoldm_tpu_torch.cli import bench_train, build_geom_dataset
from geoldm_tpu_torch.data import md17, native_geom
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.geom import extract_conformers, load_split_data
from geoldm_tpu_torch.data.synthetic import packb, write_geom_msgpack
from geoldm_tpu_torch.models import factory
from geoldm_tpu_torch.utils import flops
from tests.test_native_geom import _fake_dump


def _outputs(d, k, remove_h):
    tag = f"{'no_h_' if remove_h else ''}{k}"
    return (np.load(os.path.join(d, f"geom_drugs_{tag}.npy")),
            np.load(os.path.join(d, f"geom_drugs_n_{tag}.npy")),
            open(os.path.join(d, "geom_drugs_smiles.txt")).read())


@pytest.mark.parametrize("remove_h,k", [(False, 2), (True, 3), (False, 100)])
def test_extractors_match_jax(tmp_path, remove_h, k):
    """The port's Python extractor and its native binding write JAX's
    Python extractor's rows, counts and SMILES exactly."""
    assert native_geom.available()
    dirs = {name: tmp_path / name for name in ("jax", "py", "native")}
    for d in dirs.values():
        os.makedirs(d)
        _fake_dump(d / "drugs_crude.msgpack")
    jax_extract(str(dirs["jax"]), conformations=k, remove_h=remove_h)
    extract_conformers(str(dirs["py"]), conformations=k, remove_h=remove_h)
    native_geom.extract_conformers_native(str(dirs["native"]), conformations=k,
                                          remove_h=remove_h)
    want = _outputs(dirs["jax"], k, remove_h)
    assert len(want[0]) > 0 and want[0].shape[1] == 5
    for side in ("py", "native"):
        rows, counts, smiles = _outputs(dirs[side], k, remove_h)
        np.testing.assert_array_equal(rows, want[0])
        np.testing.assert_array_equal(counts, want[1])
        assert smiles == want[2]
    assert native_geom.build_info["path"].startswith(str(native_geom.BUILD_DIR))


def test_build_geom_dataset_cli(tmp_path, capsys, monkeypatch):
    """The CLI runs the native extractor, ``--no_native`` the Python one,
    with the same file; a host where the native one does not build says so
    and runs the Python one. The port's loader reads the result."""
    _fake_dump(tmp_path / "drugs_crude.msgpack")
    out = build_geom_dataset.main(["--data_dir", str(tmp_path), "--conformations", "2"])
    text = capsys.readouterr().out
    assert "native extractor:" in text and f"wrote {out}" in text
    native = np.load(out)
    build_geom_dataset.main(["--data_dir", str(tmp_path), "--conformations", "2",
                             "--no_native"])
    text = capsys.readouterr().out
    assert "native extractor" not in text
    np.testing.assert_array_equal(np.load(out), native)
    monkeypatch.setattr(native_geom, "available", lambda: False)
    build_geom_dataset.main(["--data_dir", str(tmp_path), "--conformations", "2"])
    assert "native extractor unavailable; using the Python path" in capsys.readouterr().out
    np.testing.assert_array_equal(np.load(out), native)
    train, val, test = load_split_data(out)
    n_mols = len(np.unique(native[:, 0]))
    assert len(train) + len(val) + len(test) == n_mols


def test_msgpack_encoder_matches_msgpack(tmp_path):
    """``data.synthetic.packb`` writes ``msgpack.packb``'s bytes: every
    width of every type a dump holds, and a generated GEOM dump chunk."""
    values = [None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
              2**64 - 1, -1, -32, -33, -128, -129, -2**15, -2**15 - 1, -2**31, -2**31 - 1,
              -2**63, 0.0, -0.0, 1.5, -2.25e-300, 1e300, "", "a" * 31, "b" * 32, "c" * 255,
              "d" * 256, "é" * 20, "x" * 70000, b"", b"ab", b"y" * 300, b"z" * 70000, [],
              list(range(15)), list(range(16)), list(range(70000)), {},
              {str(i): i for i in range(15)}, {str(i): [i, float(i)] for i in range(16)},
              (1, 2.0, "3")]
    for v in values:
        assert packb(v) == msgpack.packb(v)
    with pytest.raises(TypeError):
        packb({1.0j})
    path = write_geom_msgpack(str(tmp_path), get_dataset_info("geom"), 7, conformers=3,
                              seed=2, chunk=3)
    chunks = list(msgpack.Unpacker(open(path, "rb")))
    assert [len(c) for c in chunks] == [3, 3, 1]
    assert open(path, "rb").read() == b"".join(msgpack.packb(c) for c in chunks)
    conf = chunks[0]["C0N"]["conformers"]
    assert len(conf) == 3 and all(len(row) == 4 for row in conf[0]["xyz"])


@pytest.mark.parametrize("with_forces", [False, True])
def test_parse_xyz_md17_matches_jax(with_forces):
    rng = np.random.default_rng(3 + with_forces)
    atoms = rng.choice(list(md17.CHARGE_OF), size=6)
    pos = rng.standard_normal((6, 3)) * 2
    comment = f"{rng.standard_normal() * 1e3:.6f}"
    if with_forces:
        comment += ";" + ",".join(
            "[" + ",".join(f"{v:.5f}" for v in row) + "]" for row in rng.standard_normal((6, 3)))
    lines = ["# a header line\n", "6\n", comment + "\n"] + [
        f"{a} {x:.6f} {y:.6f} {z:.6f}\n" for a, (x, y, z) in zip(atoms, pos)] + ["\n"]
    got, want = md17.parse_xyz_md17(lines), jmd17.parse_xyz_md17(lines)
    assert sorted(got) == sorted(want) and ("forces" in got) == with_forces
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert md17.CHARGE_OF == jmd17.CHARGE_OF and md17.MD17_SUBSETS == jmd17.MD17_SUBSETS


def test_download_md17_uses_a_file_on_disk(tmp_path):
    """No network: a file already in place is returned as is; an unknown
    subset is refused before anything is fetched."""
    dest = tmp_path / md17.MD17_SUBSETS["ethanol"]
    dest.write_bytes(b"npz")
    assert md17.download_md17(str(tmp_path), "ethanol") == str(dest)
    with pytest.raises(AssertionError, match="unknown MD17 subset"):
        md17.download_md17(str(tmp_path), "caffeine")


_CONFIGS = {
    "qm9": dict(nf=256, n_layers=9),
    "qm9_trainable_ae": dict(nf=256, n_layers=9, trainable_ae=True),
    "geom": dict(nf=256, n_layers=4, latent_nf=2, include_charges=False, trainable_ae=True),
    "conditional": dict(nf=192, n_layers=9, context_node_nf=1, context_indicator=True,
                        normalize_factors=(1.0, 8.0, 1.0)),
    "sin_mean": dict(nf=64, n_layers=3, sin_embedding=True, aggregation_method="mean",
                     attention=False, inv_sublayers=2),
}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_flops_match_jax(name):
    dataset = "geom" if name == "geom" else "qm9"
    kw = _CONFIGS[name]
    pairs = [(factory.make_latent_diffusion_config(get_dataset_info(dataset), **kw),
              jfactory.make_latent_diffusion_config(jax_info(dataset), **kw))]
    vae_kw = {k: v for k, v in kw.items() if k not in ("trainable_ae", "normalize_factors")}
    pairs.append((factory.make_vae_config(get_dataset_info(dataset), **vae_kw),
                  jfactory.make_vae_config(jax_info(dataset), **vae_kw)))
    if "latent_nf" not in kw:
        dkw = {k: v for k, v in kw.items() if k != "trainable_ae"}
        pairs.append((factory.make_diffusion_model_config(get_dataset_info(dataset), **dkw),
                      jfactory.make_diffusion_model_config(jax_info(dataset), **dkw)))
    for pcfg, jcfg in pairs:
        for n in (16, 29, 32, 64, 184):
            for fn in ("forward_flops", "train_step_flops"):
                got, want = getattr(flops, fn)(pcfg, n), getattr(jflops, fn)(jcfg, n)
                assert got == want and isinstance(got, int), (fn, n)
            if pcfg.kind != "vae":
                assert flops.sample_flops(pcfg, n) == jflops.sample_flops(jcfg, n)
                assert flops.egnn_flops(pcfg.dynamics.egnn, n) == jflops.egnn_flops(
                    jcfg.dynamics.egnn, n)


def test_peak_table_is_the_h100s():
    """The port's peak is the H100 SXM's dense bf16 989 TFLOP/s (data sheet),
    keyed by the card's name; an unknown name and the CPU give None."""
    assert flops.device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.device_peak_flops("cpu") is None
    assert flops.device_peak_flops("TPU v5 lite") is None
    assert flops.mfu(1e12, 1.0, "cpu") is None
    assert flops.mfu(1e12, 0.0, "NVIDIA H100 80GB HBM3") is None
    assert np.isclose(flops.mfu(989e12, 2.0, "NVIDIA H100 80GB HBM3"), 0.5)


def test_bench_train_prints_jaxs_keys(capsys):
    out = bench_train.main(["--device", "cpu", "--nf", "16", "--n_layers", "2",
                            "--batch_size", "4", "--pad_nodes", "16", "--reps", "2",
                            "--remat", "True"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(line) == ["metric", "molecules_per_sec", "unit", "value"]
    assert line["metric"] == "qm9_train_steps_per_sec" and line["unit"] == "steps/s"
    assert line["value"] > 0 and abs(line["molecules_per_sec"] - line["value"] * 4) <= 0.06
    assert out["device"] == "cpu" and out["reps"] == 2 and out["seconds"] > 0
    assert out["model_cfg"].vae.decoder_egnn.hidden_nf == 16
