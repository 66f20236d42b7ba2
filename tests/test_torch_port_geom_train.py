"""Port parity on CPU for the GEOM-Drugs training slice: ``data/geom.py``
splits and batches against the JAX loader's on one fabricated conformer file,
GEOM-format train steps past 64 atoms against JAX's Pallas path (its
row-tiled kernels #3-#5 in interpret mode), the in-training sampling buckets,
and one epoch of ``cli.main_geom_drugs --device cpu`` whose checkpoint the
server loads with ``--dataset geom``."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu.config import TrainConfig
from geoldm_tpu.data import geom as jgeom
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.ops import pallas_egnn
from geoldm_tpu.ops.distance import build_edge_mask
from geoldm_tpu.train import sampling as jsampling
from geoldm_tpu.train import train_step as jts
from geoldm_tpu.utils.buckets import covering_buckets as jcovering_buckets
from geoldm_tpu.utils.torch_convert import state_dict_from_params
from geoldm_tpu_torch.cli import main_geom_drugs, serve
from geoldm_tpu_torch.data import geom as pgeom
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.synthetic import write_geom_conformers
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.models.distributions import DistributionNodes
from geoldm_tpu_torch.ops import egnn_block, egnn_tiled
from geoldm_tpu_torch.train import sampling as psampling
from geoldm_tpu_torch.train import train_step as pts
from geoldm_tpu_torch.train import trainer as ptrainer
from geoldm_tpu_torch.utils.convert import load_reference_checkpoint, state_dict_from_jax_params
from tests.torch_port_utils import Feed, jax_combined_draws, jax_ldm_draws, masked_inputs, t

torch.set_num_threads(1)

GEOM = get_dataset_info("geom")
# Losses: f32 through two frameworks' op orders.
RTOL = 2e-5
B, N, N_REAL = 2, 80, (80, 70)
KW = dict(nf=32, n_layers=1, latent_nf=2, include_charges=False)


@pytest.fixture(scope="module")
def geom_file(tmp_path_factory):
    """60 molecules: histogram sizes, then 8 past 64 atoms at the end (the
    train split, under the identity permutation)."""
    path = tmp_path_factory.mktemp("geomdata")
    return write_geom_conformers(str(path), GEOM, 60, seed=2,
                                 sizes=[70, 72, 75, 66, 81, 90, 101, 120])


def test_geom_splits_and_loader_match_jax(geom_file):
    for filter_size in (None, 90):
        got = pgeom.load_split_data(geom_file, filter_size=filter_size)
        want = jgeom.load_split_data(geom_file, filter_size=filter_size)
        for g_split, w_split in zip(got, want):
            assert len(g_split) == len(w_split) > 0
            for g, w in zip(g_split, w_split):
                np.testing.assert_array_equal(g, w)
    train, val, _ = want = jgeom.load_split_data(geom_file)
    assert max(m.shape[0] for m in train) > 64
    for data, shuffle in ((train, True), (val, False)):
        kw = dict(batch_size=4, shuffle=shuffle, include_charges=False, seed=5)
        got = pgeom.GeomLoader(data, GEOM, **kw)
        ref = jgeom.GeomLoader(data, jax_info("geom"), **kw)
        assert len(got) == len(ref) > 0 and got.buckets == ref.buckets
        for _ in range(2):  # the second epoch reshuffles from the same stream
            batches, refs = list(got), list(ref)
            assert len(batches) == len(refs) == len(got)
            for g, w in zip(batches, refs):
                assert set(g) == set(w)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    g, w = pgeom.split_dict(val, GEOM), jgeom.split_dict(val, jax_info("geom"))
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _geom_molecules(seed):
    """x (CoM-free), 16-type one-hot, no charge channel, node mask at pad 80."""
    _, x, _, mask = masked_inputs(seed, B, N, 1, N_REAL)
    types = np.random.default_rng(seed + 100).integers(0, 16, (B, N))
    h_cat = np.eye(16, dtype=np.float32)[types] * mask
    return x * 1.5, h_cat, np.zeros((B, N, 0), np.float32), mask


def _batches(x, h_cat, h_int, mask, log_pn):
    mj = jnp.asarray(mask)
    jb = {"x": jnp.asarray(x), "h_cat": jnp.asarray(h_cat), "h_int": jnp.asarray(h_int),
          "node_mask": mj, "edge_mask": build_edge_mask(mj), "log_pN": jnp.asarray(log_pn)}
    pb = {"x": t(x), "h_cat": t(h_cat), "h_int": t(h_int), "node_mask": t(mask),
          "log_pN": t(log_pn)}
    return jb, pb


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    monkeypatch.setattr(pallas_egnn, "egnn_apply_pallas",
                        functools.partial(pallas_egnn.egnn_apply_pallas, interpret=True))


def _assert_moves_match(model, start, want, atol, prefix=""):
    got = model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose((got[name] - start[name]).numpy(),
                                   (torch.from_numpy(np.array(w)) - start[name]).numpy(),
                                   atol=atol, err_msg=prefix + name)


def test_geom_train_steps_past_64_atoms_match_jax(jax_pallas_interpret):
    """Three latent-diffusion train steps on pad-80 GEOM-format batches
    (no charges, latent_nf 2): JAX's 'pallas' path runs its row-tiled
    kernels and their fused backward (#3-#5), the port the tiled Function
    on the CPU, on shared batches and noise."""
    assert pallas_egnn.dispatch_to_tiled(N, KW["nf"])
    T, lr, ema_decay = 20, 1e-3, 0.9
    jcfg = jfactory.make_latent_diffusion_config(jax_info("geom"), diffusion_steps=T,
                                                 trainable_ae=True, **KW)
    pcfg = pfactory.make_latent_diffusion_config(GEOM, diffusion_steps=T, trainable_ae=True,
                                                 **KW)
    tc = TrainConfig(lr=lr, ema_decay=ema_decay)
    jstate, tx = jts.create_train_state(jax.random.key(11), jcfg, tc)
    jstep = jax.jit(jts.make_train_step(jcfg, tc, tx, "pallas"))
    model = pfactory.build_model(pcfg, "cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params),
                                                     pcfg), strict=True)
    state = pts.create_train_state(model, pcfg, lr, ema_decay=ema_decay)
    pstep = pts.make_train_step(pcfg, ema_decay)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    calls = []
    apply = egnn_tiled.TiledEquivariantBlockFunction.apply
    egnn_tiled.TiledEquivariantBlockFunction.apply = lambda *a: calls.append(1) or apply(*a)
    try:
        for step in range(3):
            jb, pb = _batches(*_geom_molecules(20 + step), np.full(B, -4.0, np.float32))
            key = jax.random.fold_in(jax.random.key(12), step)
            jstate, jm = jstep(jstate, jb, key)
            pm = pstep(state, pb, Feed(jax_ldm_draws(key, B, N, 2, T, False)))
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=RTOL)
            np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    finally:
        egnn_tiled.TiledEquivariantBlockFunction.apply = apply
    # Decoder and denoiser blocks under grad, all past 64 (the encoder runs
    # under no_grad: its latent is detached).
    assert len(calls) == 3 * 2 * KW["n_layers"]
    # Three AMSGrad steps move a weight by up to 3 * lr; compare the moves.
    for params, got_model in ((jstate.params, model), (jstate.ema_params, state.ema_model)):
        want = state_dict_from_jax_params(jax.tree.map(np.asarray, params), pcfg)
        _assert_moves_match(got_model, start, want, 3e-2 * lr)


def test_geom_vae_step_past_64_atoms_matches_jax(jax_pallas_interpret):
    """One first-stage VAE step at pad 80: the encoder's gradient flows back
    through the tiled Function, dx0 included, and matches JAX's."""
    lr = 1e-3
    jcfg = jfactory.make_vae_config(jax_info("geom"), **KW)
    pcfg = pfactory.make_vae_config(GEOM, **KW)
    tc = TrainConfig(lr=lr, ema_decay=0.0)
    jstate, tx = jts.create_train_state(jax.random.key(13), jcfg, tc)
    jstep = jax.jit(jts.make_train_step(jcfg, tc, tx, "pallas"))
    model = pfactory.build_model(pcfg, "cpu")
    sd = state_dict_from_params(jax.tree.map(np.asarray, jstate.params), jcfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    state = pts.create_train_state(model, pcfg, lr, ema_decay=0.0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    jb, pb = _batches(*_geom_molecules(30), np.full(B, -4.0, np.float32))
    key = jax.random.key(14)
    jstate, jm = jstep(jstate, jb, key)
    pm = pts.make_train_step(pcfg, 0.0)(state, pb, Feed(jax_combined_draws(key, B, N, 3, 2)))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=RTOL)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want = state_dict_from_params(jax.tree.map(np.asarray, jstate.params), jcfg)
    _assert_moves_match(model, start, want, 3e-2 * lr)
    enc = [k for k in start if k.startswith("encoder.egnn.e_block_0.")]
    assert enc and all(not torch.equal(model.state_dict()[k], start[k]) for k in enc)


def test_geom_stability_sampling_uses_the_geom_buckets_as_jax(monkeypatch):
    """The trainer's in-training samples are bucketed with the dataset's
    buckets (jax trainer.py:395-396): the same sizes give JAX's chunk pads,
    not QM9's (16, 24, 32, then 184 for everything larger)."""
    port_pads, jax_pads, seen = [], [], {}

    def fake_port_sample(model, noise, dataset_info, nodesxsample, fix_noise=False,
                         pad_nodes=None, **sampler_settings):
        port_pads.append(pad_nodes)
        b = len(nodesxsample)
        mask = (np.arange(pad_nodes)[None] < np.asarray(nodesxsample)[:, None])
        return (torch.zeros(b, pad_nodes, 16), torch.zeros(b, pad_nodes, 0),
                torch.zeros(b, pad_nodes, 3), mask.astype(np.float32)[..., None])

    def fake_jax_sample(model_cfg, params, key, dataset_info, sizes, pad_nodes=None, **kw):
        jax_pads.append(pad_nodes)
        return tuple(np.zeros((len(sizes), pad_nodes, f), np.float32) for f in (16, 0, 3, 1))

    real = psampling.sample_bucketed

    def spy(model, seed, info, nodesxsample, batch_size, buckets, **kw):
        seen.update(sizes=np.asarray(nodesxsample), batch_size=batch_size)
        return real(model, seed, info, nodesxsample, batch_size=batch_size, buckets=buckets, **kw)

    monkeypatch.setattr(psampling, "sample", fake_port_sample)
    monkeypatch.setattr(psampling, "sample_bucketed",
                        lambda m, s, i, n, batch_size, buckets, **kw: spy(m, s, i, n, batch_size,
                                                                          buckets, **kw))
    monkeypatch.setattr(jsampling, "sample", fake_jax_sample)
    ptrainer.analyze_and_save(torch.nn.Linear(1, 1), 0, GEOM, DistributionNodes(GEOM.n_nodes),
                              n_samples=30, batch_size=8, rng=np.random.default_rng(3))
    jinfo = jax_info("geom")
    jsampling.sample_bucketed(None, None, jax.random.key(0), jinfo, seen["sizes"],
                              batch_size=seen["batch_size"],
                              buckets=jcovering_buckets(jsampling.default_buckets(jinfo),
                                                        jinfo["max_n_nodes"]))
    assert port_pads == jax_pads and len(port_pads) > 1
    assert set(port_pads) <= {32, 48, 64, 96, 136, 184}
    assert port_pads == psampling.chunk_pads(seen["sizes"], 8, (32, 48, 64, 96, 136, 184))


def test_main_geom_drugs_on_cpu_trains_and_the_server_loads_its_checkpoint(geom_file,
                                                                          tmp_path):
    launches = (egnn_block.launches, egnn_tiled.gcl_rows_launches,
                egnn_tiled.gcl_rows_bwd_launches)
    summary = main_geom_drugs.main([
        "--datadir", os.path.dirname(geom_file), "--outdir", str(tmp_path), "--exp_name", "geom",
        "--train_diffusion", "--trainable_ae", "--n_epochs", "1", "--test_epochs", "1",
        "--batch_size", "4", "--nf", "16", "--n_layers", "1", "--diffusion_steps", "6",
        "--n_stability_samples", "3", "--ema_decay", "0.99", "--device", "cpu"])
    # The CPU runs the plain path.
    assert (egnn_block.launches, egnn_tiled.gcl_rows_launches,
            egnn_tiled.gcl_rows_bwd_launches) == launches
    losses = summary["losses"][0]
    assert len(losses) >= 2 and np.all(np.isfinite(losses))
    assert np.isfinite(summary["nll_val"][0]) and np.isfinite(summary["nll_test"][0])
    best = tmp_path / "geom" / "best"
    model, cfg, args = load_reference_checkpoint(str(best), "cpu")
    assert args.dataset == "geom" and cfg.vae.include_charges is False
    assert cfg.vae.latent_nf == 2 and cfg.dynamics.egnn.n_layers == 1
    assert len(GEOM.atom_decoder) == cfg.vae.in_node_nf
    service = serve.SamplerService(serve.parse_args(["--model_path", str(best), "--dataset",
                                                     "geom", "--device", "cpu"]))
    body = service.sample({"sizes": [12, 70], "seed": 1})
    assert body["n"] == 2 and [len(m) for m in body["molecules"]] == [12, 70]


def test_main_geom_drugs_defaults_are_the_geom_recipe(tmp_path):
    args = main_geom_drugs.parse_args([])
    assert (args.lr, args.batch_size, args.n_layers, args.latent_nf, args.nf) == \
        (5e-5, 32, 4, 2, 256)
    assert args.include_charges is False and args.dataset == "geom"
    with pytest.raises(FileNotFoundError, match="geom_drugs_30.npy"):
        main_geom_drugs.main(["--datadir", str(tmp_path), "--device", "cpu"])
    # --visualize and --tp are ported: each run gets as far as the missing
    # data (under --tp 2 in both spawned ranks, whose error the launch raises).
    with pytest.raises(FileNotFoundError, match="geom_drugs_30.npy"):
        main_geom_drugs.main(["--datadir", str(tmp_path), "--visualize", "True",
                              "--device", "cpu"])
    with pytest.raises(torch.multiprocessing.ProcessRaisedException) as e:
        main_geom_drugs.main(["--datadir", str(tmp_path), "--tp", "2", "--device", "cpu"])
    assert "FileNotFoundError" in str(e.value) and "geom_drugs_30.npy" in str(e.value)
