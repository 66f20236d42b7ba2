"""Port parity on CPU for the data layer and the training CLI: fabricated
QM9-format splits, ``load_qm9`` and ``QM9Loader`` batches against the JAX
package's, the synthetic batches, one epoch of ``cli.main_qm9 --device cpu``
whose checkpoint the port's server then loads and samples from, and the
two-line refusal of flags outside the slice."""

import numpy as np
import pytest
import torch

from geoldm_tpu.data import qm9 as jqm9
from geoldm_tpu.data import synthetic as jsynthetic
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu_torch.cli import main_qm9, serve
from geoldm_tpu_torch.data import qm9 as pqm9
from geoldm_tpu_torch.data import synthetic as psynthetic
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.ops import egnn_block
from geoldm_tpu_torch.utils.convert import load_reference_checkpoint

torch.set_num_threads(1)

INFO = get_dataset_info("qm9")


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    path = tmp_path_factory.mktemp("qm9data")
    psynthetic.write_qm9_splits(str(path), INFO, {"train": 24, "valid": 6, "test": 5}, seed=3)
    return str(path)


def test_synthetic_batch_matches_jax():
    for pad in (29, 12):
        got = psynthetic.synthetic_batch(INFO, 6, pad, np.random.default_rng(4))
        want = jsynthetic.synthetic_batch(jax_info("qm9"), 6, pad, np.random.default_rng(4))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got = psynthetic.sampling_masks(INFO, 5, 16, np.random.default_rng(6))
    want = jsynthetic.sampling_masks(jax_info("qm9"), 5, 16, np.random.default_rng(6))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_load_qm9_and_loader_match_jax(datadir):
    p_splits, p_scale = pqm9.load_qm9(datadir)
    j_splits, j_scale = jqm9.load_qm9(datadir)
    assert p_scale == j_scale == 9.0
    for split in ("train", "valid", "test"):
        assert set(p_splits[split]) == set(j_splits[split])
        for k, v in j_splits[split].items():
            np.testing.assert_array_equal(p_splits[split][k], v, err_msg=f"{split}/{k}")
        assert p_splits[split]["one_hot"].shape[-1] == 5
    for split, shuffle in (("train", True), ("valid", False)):
        kw = dict(batch_size=8, pad_nodes=29, shuffle=shuffle, seed=5)
        got = list(pqm9.QM9Loader(p_splits[split], **kw))
        want = list(jqm9.QM9Loader(j_splits[split], **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    filtered = pqm9.filter_atoms(p_splits, 9)
    for split, d in jqm9.filter_atoms(j_splits, 9).items():
        np.testing.assert_array_equal(filtered[split]["num_atoms"], d["num_atoms"])


def test_load_qm9_names_missing_files(tmp_path, monkeypatch):
    """With no splits and no raw files, ``load_qm9`` sets out to fetch the
    GDB9 tarball, as JAX's does; without the network it names the file to
    place (``urlretrieve`` refused here, so no test reaches the network)."""
    def refuse(url, filename=None, *a, **k):
        raise OSError(f"network refused in tests: {url}")

    monkeypatch.setattr(pqm9.urllib.request, "urlretrieve", refuse)
    with pytest.raises(RuntimeError, match="dsgdb9nsd.xyz.tar.bz2"):
        pqm9.load_qm9(str(tmp_path))


def test_main_qm9_on_cpu_trains_and_the_server_loads_its_checkpoint(datadir, tmp_path):
    fwd = egnn_block.launches
    summary = main_qm9.main([
        "--datadir", datadir, "--outdir", str(tmp_path), "--exp_name", "smoke",
        "--train_diffusion", "--trainable_ae", "--n_epochs", "1", "--test_epochs", "1",
        "--batch_size", "8", "--nf", "16", "--n_layers", "2", "--diffusion_steps", "8",
        "--n_stability_samples", "4", "--ema_decay", "0.99", "--device", "cpu"])
    assert egnn_block.launches == fwd  # the CPU runs the plain path
    losses = summary["losses"][0]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert np.isfinite(summary["nll_val"][0]) and np.isfinite(summary["nll_test"][0])
    assert set(summary["stability"][0]) == {"mol_stable", "atm_stable"}
    best = tmp_path / "smoke" / "best"
    for name in ("args.pickle", "generative_model.npy", "generative_model_ema.npy", "optim.npy"):
        assert (best / name).exists(), name
    model, cfg, args = load_reference_checkpoint(str(best), "cpu", use_ema=False)
    assert cfg.kind == "latent_diffusion" and cfg.dynamics.egnn.hidden_nf == 16
    assert args.current_epoch == 1
    ema, _, _ = load_reference_checkpoint(str(best), "cpu")
    moved = [not torch.equal(a, b) for a, b in zip(model.parameters(), ema.parameters())]
    assert any(moved)  # the EMA trails the trained weights

    service = serve.SamplerService(serve.parse_args(["--model_path", str(best), "--device",
                                                     "cpu"]))
    body = service.sample({"sizes": [5, 7], "seed": 1})
    assert body["n"] == 2 and [len(m) for m in body["molecules"]] == [5, 7]


def test_main_qm9_trains_the_vae_by_default(datadir, tmp_path):
    summary = main_qm9.main([
        "--datadir", datadir, "--outdir", str(tmp_path), "--exp_name", "vae",
        "--n_epochs", "1", "--batch_size", "12", "--nf", "16", "--n_layers", "1",
        "--device", "cpu"])
    assert np.all(np.isfinite(summary["losses"][0])) and summary["stability"] == []
    _, cfg, _ = load_reference_checkpoint(str(tmp_path / "vae" / "best"), "cpu")
    assert cfg.kind == "vae"


@pytest.mark.parametrize("flags", [
    ["--compute_dtype", "bfloat16"], ["--dp", "3", "--batch_size", "2"],
    ["--conditioning", "alpha", "--sp", "2", "--tp", "2"],
    ["--tp", "2"], ["--compute_dtype", "bfloat16_full"], ["--visualize", "True"],
    ["--compute_dtype", "bfloat16_mixed"], ["--model", "gnn_dynamics"],
    ["--conditioning", "alpha", "homo", "--dp", "4", "--batch_size", "3"],
])
def test_flags_outside_the_slice_are_refused(flags, datadir, tmp_path, monkeypatch):
    """Every flag of JAX's training CLIs is in the port: what is refused is
    a combination JAX refuses too (``--sp`` with ``--tp``, a global batch
    the data ranks cannot split). ``--tp 2`` trains over two model ranks
    (tests/test_torch_port_tp_cli.py holds it further). The compute dtypes
    are JAX's training choices: ``bfloat16`` trains (a bf16
    run starts and its losses are finite), ``bfloat16_full`` and
    ``bfloat16_mixed`` are sampling modes that argparse refuses (exit 2), as
    JAX's ``choices`` do. ``--model gnn_dynamics`` is in the slice since the
    model variants were ported: it trains (tests/test_torch_port_variants_cli.py
    holds it further). ``--visualize True`` is in the slice since the
    renderer was ported: it is refused only where matplotlib or imageio is
    missing, at argument checking, naming the package
    (tests/test_torch_port_render.py runs it)."""
    if flags == ["--visualize", "True"]:
        import sys

        monkeypatch.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(SystemExit) as e:
            main_qm9.main(["--datadir", str(tmp_path), "--device", "cpu", *flags])
        assert str(e.value.code) == ("--visualize renders with matplotlib and imageio; this "
                                     "Python lacks matplotlib")
        return
    if flags[:2] == ["--model", "gnn_dynamics"]:
        summary = main_qm9.main(["--datadir", datadir, "--outdir", str(tmp_path), "--device",
                                 "cpu", "--n_epochs", "1", "--batch_size", "12", "--nf", "16",
                                 "--n_layers", "1", "--train_diffusion", "--diffusion_steps",
                                 "4", "--n_stability_samples", "2", *flags])
        assert summary["losses"] and np.all(np.isfinite(summary["losses"][0]))
        return
    if flags == ["--tp", "2"]:
        summary = main_qm9.main(["--datadir", datadir, "--outdir", str(tmp_path), "--device",
                                 "cpu", "--n_epochs", "1", "--batch_size", "12", "--nf", "16",
                                 "--n_layers", "1", *flags])
        assert summary["losses"] and np.all(np.isfinite(summary["losses"][0]))
        assert len({r["digest"] for r in summary["replicas"]}) == 1
        return
    if flags[0] == "--compute_dtype":
        argv = ["--datadir", datadir, "--outdir", str(tmp_path), "--device", "cpu",
                "--n_epochs", "1", "--batch_size", "12", "--nf", "16", "--n_layers", "1", *flags]
        if flags[1] == "bfloat16":
            summary = main_qm9.main(argv)
            assert summary["losses"] and np.all(np.isfinite(summary["losses"][0]))
            return
        with pytest.raises(SystemExit) as e:
            main_qm9.main(argv)
        assert e.value.code == 2
        return
    with pytest.raises(SystemExit) as e:
        main_qm9.main(["--datadir", str(tmp_path), "--device", "cpu", *flags])
    if "--dp" in flags:  # --dp runs; a global batch smaller than D is refused, as JAX does
        assert str(e.value.code).startswith(f"--dp {flags[flags.index('--dp') + 1]} splits "
                                            "every batch")
        return
    # --conditioning runs under --sp; --sp with --tp is refused
    assert "--sp" in flags and str(e.value.code) == "--sp and --tp cannot be combined"
