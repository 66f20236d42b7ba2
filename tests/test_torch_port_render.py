"""The port's renderer against JAX's on the same arrays (xyz files byte for
byte, PNG pixels and GIF frames exactly: both draw with the same matplotlib
calls), and the rendering flags of the port's CLIs on the CPU: training's
``--visualize``, ``eval_sample --render`` and the exit that names a missing
package."""

import os
import random
import sys
from functools import partial

import imageio
import numpy as np
import pytest
import torch

from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.evalsuite import visualizer as jviz
from geoldm_tpu_torch.cli import common, eval_sample, main_qm9
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.synthetic import write_qm9_splits
from geoldm_tpu_torch.evalsuite import visualizer as viz
from geoldm_tpu_torch.models import factory
from geoldm_tpu_torch.train import sampling as psampling
from geoldm_tpu_torch.utils.convert import save_reference_checkpoint

torch.set_num_threads(1)

INFO = get_dataset_info("qm9")
JINFO = jax_info("qm9")


def _molecules(seed, m=3, n=12, info=INFO):
    """One-hot, charges, positions and a ragged node mask, numpy-seeded."""
    rng = np.random.default_rng(seed)
    s = len(info["atom_decoder"])
    one_hot = np.eye(s, dtype=np.float32)[rng.integers(0, s, (m, n))]
    x = (rng.standard_normal((m, n, 3)) * 1.4).astype(np.float32)
    sizes = rng.integers(n - 4, n + 1, m)
    node_mask = (np.arange(n)[None, :] < sizes[:, None]).astype(np.float32)[..., None]
    return one_hot, np.zeros((m, n, 1), np.float32), x, node_mask


def _files(d):
    return sorted(f for f in os.listdir(d))


def _gif_frames_expected(d, names):
    """The frames a GIF of these PNGs holds: the GIF writer merges equal
    consecutive frames (a chain ends with its final frame repeated)."""
    frames = [imageio.v2.imread(os.path.join(d, n)) for n in names]
    return 1 + sum(not np.array_equal(a, b) for a, b in zip(frames, frames[1:]))


@pytest.mark.parametrize("dataset,masked", [("qm9", True), ("qm9", False), ("geom", True)])
def test_xyz_files_and_loads_match_jax(tmp_path, dataset, masked):
    info, jinfo = get_dataset_info(dataset), jax_info(dataset)
    one_hot, charges, x, node_mask = _molecules(1, info=info)
    mask = node_mask if masked else None
    a = viz.save_xyz_file(str(tmp_path / "p"), one_hot, charges, x, info, id_from=3,
                          name="mol", node_mask=mask)
    b = jviz.save_xyz_file(str(tmp_path / "j"), one_hot, charges, x, jinfo, id_from=3,
                           name="mol", node_mask=mask)
    assert [os.path.basename(f) for f in a] == [os.path.basename(f) for f in b]
    for fa, fb in zip(a, b):
        assert open(fa, "rb").read() == open(fb, "rb").read()
        for got, want in zip(viz.load_molecule_xyz(fa, info), jviz.load_molecule_xyz(fb, jinfo)):
            np.testing.assert_array_equal(got, want)
    viz.save_chain(str(tmp_path / "pc"), one_hot, charges, x, info)
    jviz.save_chain(str(tmp_path / "jc"), one_hot, charges, x, jinfo)
    assert _files(tmp_path / "pc") == _files(tmp_path / "jc") == [f"chain_{i:03d}.txt"
                                                                  for i in range(3)]
    for f in _files(tmp_path / "pc"):
        assert (tmp_path / "pc" / f).read_bytes() == (tmp_path / "jc" / f).read_bytes()
    random.seed(5)
    got = viz.load_xyz_files(str(tmp_path / "p"))
    random.seed(5)
    want = jviz.load_xyz_files(str(tmp_path / "j"))
    assert [os.path.basename(f) for f in got] == [os.path.basename(f) for f in want]


@pytest.mark.parametrize("dataset,elev,azim,bg", [("qm9", 10, -60, "white"),
                                                   ("geom", 30, 20, "black")])
def test_plot_data3d_pixels_match_jax(tmp_path, dataset, elev, azim, bg):
    info, jinfo = get_dataset_info(dataset), jax_info(dataset)
    one_hot, _, x, node_mask = _molecules(2, info=info)
    n = int(node_mask[0].sum())
    types = np.argmax(one_hot[0, :n], axis=1)
    kw = dict(camera_elev=elev, camera_azim=azim, bg=bg)
    viz.plot_data3d(x[0, :n], types, info, save_path=str(tmp_path / "p.png"), **kw)
    jviz.plot_data3d(x[0, :n], types, jinfo, save_path=str(tmp_path / "j.png"), **kw)
    got, want = imageio.v2.imread(tmp_path / "p.png"), imageio.v2.imread(tmp_path / "j.png")
    assert got.shape == want.shape and got.shape[0] > 100
    np.testing.assert_array_equal(got, want)


def test_visualize_and_chain_gifs_match_jax(tmp_path):
    one_hot, charges, x, node_mask = _molecules(3, m=5)
    for side, mod, info in (("p", viz, INFO), ("j", jviz, JINFO)):
        mod.save_xyz_file(str(tmp_path / side / "mols"), one_hot[:2], charges[:2], x[:2], info,
                          node_mask=node_mask[:2])
        random.seed(0)
        mod.visualize(str(tmp_path / side / "mols"), info)
        mod.save_chain(str(tmp_path / side / "chain"), one_hot, charges, x, info)
        assert mod.visualize_chain(str(tmp_path / side / "chain"), info).endswith("output.gif")
        mod.save_chain(str(tmp_path / side / "unc"), one_hot, charges, x, info)
        mod.visualize_chain_uncertainty(str(tmp_path / side / "unc"), info, gif_name="u")
    for name in ("molecule_000.png", "molecule_001.png"):
        np.testing.assert_array_equal(imageio.v2.imread(tmp_path / "p" / "mols" / name),
                                      imageio.v2.imread(tmp_path / "j" / "mols" / name))
    for sub, gif, frames in (("chain", "output.gif", 5), ("unc", "u.gif", 3)):
        got = imageio.mimread(tmp_path / "p" / sub / gif)
        want = imageio.mimread(tmp_path / "j" / sub / gif)
        assert len(got) == len(want) == frames
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert viz.visualize_chain(str(tmp_path / "empty"), INFO) is None


def test_missing_render_packages_exit_named(tmp_path, monkeypatch):
    """A rendering flag on a host without matplotlib or imageio exits at
    argument checking naming the missing package(s); the run never starts."""
    assert viz.missing_renderer_packages() == []
    monkeypatch.setitem(sys.modules, "imageio", None)
    assert viz.missing_renderer_packages() == ["imageio"]
    with pytest.raises(SystemExit, match="--visualize renders with matplotlib and imageio; "
                                         "this Python lacks imageio"):
        main_qm9.main(["--datadir", str(tmp_path / "none"), "--visualize", "True",
                       "--device", "cpu"])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="lacks matplotlib and imageio"):
        eval_sample.main(["--model_path", str(tmp_path / "none"), "--render", "True",
                          "--device", "cpu"])


def test_visualize_through_main_qm9(tmp_path, monkeypatch):
    """``--visualize True``: at the stability evaluation the EMA model's
    chain and 9 molecules are written as xyz files under epoch_0/ and
    rendered (the chain's GIF, a PNG per molecule)."""
    write_qm9_splits(str(tmp_path), INFO, {"train": 8, "valid": 4, "test": 4}, seed=2)
    # A short chain keeps the CPU render cheap; the CLI's wiring is the same.
    monkeypatch.setattr(psampling, "sample_chain", partial(psampling.sample_chain,
                                                           keep_frames=4))
    summary = main_qm9.main([
        "--datadir", str(tmp_path), "--outdir", str(tmp_path / "out"), "--train_diffusion",
        "--trainable_ae", "--nf", "16", "--n_layers", "1", "--diffusion_steps", "4",
        "--batch_size", "8", "--n_epochs", "1", "--test_epochs", "1",
        "--n_stability_samples", "2", "--visualize", "True", "--device", "cpu", "--no_wandb"])
    epoch = tmp_path / "out" / "geoldm_tpu_run" / "epoch_0"
    (vis,) = summary["visualized"]
    assert vis["chain_frames"] == 14 and vis["gif"] == str(epoch / "chain" / "output.gif")
    chain_txt = [f for f in _files(epoch / "chain") if f.endswith(".txt")]
    assert chain_txt == [f"chain_{i:03d}.txt" for i in range(14)]
    chain_png = [f for f in _files(epoch / "chain") if f.endswith(".png")]
    assert chain_png == [f.replace(".txt", ".png") for f in chain_txt]
    assert len(imageio.mimread(epoch / "chain" / "output.gif")) == _gif_frames_expected(
        epoch / "chain", chain_png)
    mols = _files(epoch / "molecules")
    assert [f for f in mols if f.endswith(".txt")] == [f"molecule_{i:03d}.txt" for i in range(9)]
    assert sorted(os.path.basename(p) for p in vis["pngs"]) == [
        f"molecule_{i:03d}.png" for i in range(9)]
    # The chain is the EMA model's, from visualize_epoch's seed.
    ema = summary["state"].ema_model
    oh, ch, xs = psampling.sample_chain(ema, 500, INFO, n_tries=1)
    viz.save_chain(str(tmp_path / "again"), oh, ch, xs, INFO)
    for f in chain_txt:
        assert (tmp_path / "again" / f).read_bytes() == (epoch / "chain" / f).read_bytes()
    for f in [f for f in mols if f.endswith(".txt")]:
        pos, one_hot = viz.load_molecule_xyz(str(epoch / "molecules" / f), INFO)
        assert np.isfinite(pos).all() and (one_hot.sum(1) == 1).all()


@pytest.mark.parametrize("uncertainty,pictures", [("True", 12), ("False", 14)])
def test_eval_sample_render(tmp_path, uncertainty, pictures):
    """--render True: a PNG per molecule, a chain GIF of 3-frame overlays
    (12 pictures for 14 frames) or of single frames (14)."""
    cfg = factory.make_latent_diffusion_config(INFO, nf=16, n_layers=1, diffusion_steps=4)
    save_reference_checkpoint(factory.build_model(cfg, "cpu", torch.Generator().manual_seed(0)),
                              str(tmp_path / "ckpt"))
    out = tmp_path / "eval"
    summary = eval_sample.main(["--model_path", str(tmp_path / "ckpt"), "--outdir", str(out),
                                "--n_samples", "3", "--n_stable", "1", "--n_chains", "1",
                                "--keep_frames", "4", "--n_tries", "1", "--n_steps", "2",
                                "--render", "True", "--chain_uncertainty", uncertainty,
                                "--device", "cpu"])
    pngs = [f for f in _files(out / "molecules") if f.endswith(".png")]
    assert pngs == [f"molecule_{i:03d}.png" for i in range(3)]
    assert summary["rendered"]["pngs"] == 3 + summary["stable"]
    (gif,) = summary["rendered"]["gifs"]
    assert gif == str(out / "chain_0" / "output.gif")
    chain_png = [f for f in _files(out / "chain_0") if f.endswith(".png")]
    assert len(chain_png) == pictures
    assert len(imageio.mimread(gif)) == _gif_frames_expected(out / "chain_0", chain_png)


def test_visualize_epoch_without_rendering_writes_xyz_only(tmp_path):
    """``render=False`` (a host without the renderer): the xyz files alone."""
    cfg = factory.make_latent_diffusion_config(INFO, nf=16, n_layers=1, diffusion_steps=4)
    model = factory.build_model(cfg, "cpu", torch.Generator().manual_seed(4))
    from geoldm_tpu_torch.models.distributions import DistributionNodes

    out = common.visualize_epoch(model, str(tmp_path), 7, INFO, DistributionNodes(INFO.n_nodes),
                                 np.random.default_rng(0), render=False)
    assert out["chain_frames"] == 110 and out["gif"] is None and out["pngs"] == []
    assert len(out["molecules"]) == 9
    assert not [f for f in _files(tmp_path / "chain") if not f.endswith(".txt")]


def test_visualize_epoch_of_a_conditional_model(tmp_path):
    """A conditional (CFG) model's chain takes one property row drawn for the
    chain's 19 atoms, and its molecules rows drawn for their sizes, from the
    split's distribution, as JAX's ``sample_chain`` / ``sample`` draw them."""
    from geoldm_tpu_torch.train.conditioning import load_conditional_protocol

    write_qm9_splits(str(tmp_path), INFO, {"train": 64, "valid": 8, "test": 8}, seed=7)
    _, _, prop_dist, nodes, _ = load_conditional_protocol(str(tmp_path), ["alpha"])
    cfg = factory.make_latent_diffusion_config(INFO, nf=16, n_layers=1, diffusion_steps=4,
                                               context_node_nf=1, context_indicator=True)
    model = factory.build_model(cfg, "cpu", torch.Generator().manual_seed(5))
    seen = []
    real = model.dynamics.forward

    def spy(*a, **kw):
        seen.append(a[3] if len(a) > 3 else kw.get("context"))  # (t, xh, mask, context, ...)
        return real(*a, **kw)

    model.dynamics.forward = spy
    out = common.visualize_epoch(model, str(tmp_path / "vis"), 3, INFO, nodes,
                                 np.random.default_rng(1), prop_dist=prop_dist, render=False)
    assert out["chain_frames"] == 110 and len(out["molecules"]) == 9
    ctx = [c for c in seen if isinstance(c, torch.Tensor)]
    assert ctx and all(c.shape[-1] == 2 for c in ctx)  # alpha and the indicator
    chain_ctx = ctx[0][0]
    assert torch.all(chain_ctx[:, 1] == 1) and torch.all(chain_ctx[:, 0] == chain_ctx[0, 0])
