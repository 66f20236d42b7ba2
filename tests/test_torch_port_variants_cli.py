"""The model variants through the port's entry points on the CPU, on
fabricated splits: ``cli.main_qm9 --diffusion_noise_schedule learned
--diffusion_loss_type vlb`` (the counterpart of
tests/test_cli_integration.py:247) with ``--resume``, ``--model
gnn_dynamics`` through ``cli.main_qm9`` and ``cli.main_geom_drugs``, the
plain E(n) diffusion model (kind 'diffusion') trained from its checkpoint
with ``--resume``, ``cli.eval_analyze``, ``cli.eval_sample`` and
``cli.serve`` on the learned-schedule and the plain-kind checkpoints, the
refusal JAX's ``vdm_init`` makes, and the ``args.pickle`` round trip of
every kind and variant (a VAE's and a latent model's still load as
before)."""

import argparse
import json
import os
import pickle
import threading

import numpy as np
import pytest
import torch

from geoldm_tpu_torch.cli import eval_analyze, eval_sample, main_geom_drugs, main_qm9, serve
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.synthetic import write_geom_conformers, write_qm9_splits
from geoldm_tpu_torch.diffusion.schedules import GammaNetwork, PredefinedNoiseSchedule
from geoldm_tpu_torch.models import factory
from geoldm_tpu_torch.nn.egnn import GNN
from geoldm_tpu_torch.train import train_step as pts
from geoldm_tpu_torch.utils import checkpoint as ckpt
from geoldm_tpu_torch.utils.convert import (
    checkpoint_kind,
    load_reference_checkpoint,
    model_config_from_reference_args,
    reference_args_from_model_config,
    save_reference_checkpoint,
)
from tests.test_torch_port_serve import _request

torch.set_num_threads(1)

INFO = get_dataset_info("qm9")
TINY = ["--nf", "16", "--n_layers", "1", "--diffusion_steps", "6", "--batch_size", "8",
        "--n_stability_samples", "4", "--device", "cpu", "--no_wandb"]
LEARNED = ["--diffusion_noise_schedule", "learned", "--diffusion_loss_type", "vlb"]


@pytest.fixture(scope="module")
def qm9_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("qm9_variants"))
    write_qm9_splits(path, INFO, {"train": 16, "valid": 6, "test": 6}, seed=3)
    return path


def _serve(model_path, requests):
    """Start cli.serve on ``model_path`` (CPU, a free port), answer each
    request body, stop. -> [(status, body)]."""
    srv, _ = serve.main(["--model_path", model_path, "--port", "0", "--batch_max", "8",
                         "--device", "cpu"], serve_forever=False)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        return [_request(base, "/sample", body) for body in requests]
    finally:
        srv.shutdown()
        srv.server_close()


def _check_served(replies, seeds=2):
    for code, body in replies:
        assert code == 200, body
        assert body["n"] == len(body["molecules"]) and body["n"] > 0
        assert all(np.isfinite([a[1:] for m in body["molecules"] for a in m]).ravel())
    assert replies[0][1]["molecules"] == replies[1][1]["molecules"]  # a seeded request replays


def _evaluate(model_path, qm9_dir):
    summary = eval_analyze.main(["--model_path", model_path, "--datadir", qm9_dir,
                                 "--n_samples", "4", "--batch_size_nll", "4",
                                 "--n_test_passes", "2", "--device", "cpu"])
    assert summary["n_samples"] == 4
    assert np.isfinite(summary["nll_val"]) and np.isfinite(summary["nll_test"])
    assert 0.0 <= summary["stability"]["mol_stable"] <= 1.0
    return summary


def test_main_qm9_learned_schedule_trains_resumes_evaluates_and_serves(qm9_dir, tmp_path):
    """The learned GammaNetwork trains inside the step (its parameters move
    and stay monotone with its endpoints), its log-SNR range is printed and
    logged each epoch into metrics.jsonl, the checkpoint reloads as a
    learned-schedule model, --resume continues from it, and eval_analyze and
    the server (a seeded DDIM request, its replay and a dense one) run on
    it."""
    out = str(tmp_path)
    argv = ["--datadir", qm9_dir, "--outdir", out, "--exp_name", "learned", "--train_diffusion",
            "--trainable_ae", *LEARNED, *TINY]
    first = main_qm9.main(argv + ["--n_epochs", "1", "--test_epochs", "1"])
    assert np.all(np.isfinite(first["losses"][0])) and np.isfinite(first["nll_val"][0])
    run = os.path.join(out, "learned")
    records = [json.loads(ln) for ln in open(os.path.join(run, "metrics.jsonl"))]
    snr = [r for r in records if "log_SNR_max" in r]
    assert len(snr) == 1 and snr[0]["_step"] == 0 and "train_loss_epoch" in snr[0]
    assert snr[0]["log_SNR_max"] > snr[0]["log_SNR_min"]
    model, cfg, args = load_reference_checkpoint(os.path.join(run, "latest"), "cpu",
                                                 use_ema=False)
    assert cfg.kind == "latent_diffusion" and cfg.diffusion.noise_schedule == "learned"
    assert isinstance(model.gamma, GammaNetwork) and args.diffusion_noise_schedule == "learned"
    fresh = factory.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    assert not torch.equal(model.gamma.l2.weight, fresh.gamma.l2.weight)  # it trained
    with torch.no_grad():
        g = model.gamma(torch.linspace(0, 1, 51)[:, None])[:, 0]
        assert abs(float(g[0] - model.gamma.gamma_0)) < 1e-5
        assert abs(float(g[-1] - model.gamma.gamma_1)) < 1e-4
    assert bool(torch.all(g[1:] > g[:-1]))

    resumed = main_qm9.main(argv + ["--n_epochs", "2", "--start_epoch", "1", "--test_epochs",
                                    "1", "--resume", run])
    assert resumed["resumed"]["step"] == len(first["losses"][0])
    assert all(torch.equal(resumed["resumed"]["model"][k], v)
               for k, v in model.state_dict().items())
    assert len(resumed["losses"]) == 1 and np.all(np.isfinite(resumed["losses"][0]))
    records = [json.loads(ln) for ln in open(os.path.join(run, "metrics.jsonl"))]
    assert [r["_step"] for r in records if "log_SNR_max" in r] == [0, 1]

    _evaluate(run, qm9_dir)
    body = {"sizes": [5, 9, 12], "seed": 7}
    _check_served(_serve(os.path.join(run, "best"), [
        {**body, "n_steps": 3, "eta": 0.0}, {**body, "n_steps": 3, "eta": 0.0}, body]))


def test_learned_schedule_with_l2_is_refused_as_jax(qm9_dir, tmp_path):
    with pytest.raises(SystemExit) as e:
        main_qm9.main(["--datadir", qm9_dir, "--outdir", str(tmp_path), "--train_diffusion",
                       "--diffusion_noise_schedule", "learned", "--diffusion_loss_type", "l2",
                       *TINY])
    assert str(e.value.code) == "learned schedule requires vlb loss"


def test_gnn_dynamics_trains_through_main_qm9(qm9_dir, tmp_path):
    """--model gnn_dynamics: the GNN denoiser (no kernel of its own) trains,
    samples and checkpoints; the checkpoint reloads with its dynamics.gnn."""
    summary = main_qm9.main(["--datadir", qm9_dir, "--outdir", str(tmp_path), "--exp_name",
                             "gnn", "--train_diffusion", "--trainable_ae", "--model",
                             "gnn_dynamics", "--n_epochs", "1", *TINY])
    assert np.all(np.isfinite(summary["losses"][0])) and summary["stability"]
    model, cfg, args = load_reference_checkpoint(str(tmp_path / "gnn" / "best"), "cpu")
    assert args.model == "gnn_dynamics" and cfg.dynamics.mode == "gnn_dynamics"
    assert isinstance(model.dynamics.gnn, GNN)


def test_gnn_dynamics_trains_through_main_geom_drugs(tmp_path):
    geom = str(tmp_path / "geom")
    write_geom_conformers(geom, get_dataset_info("geom"), 20, sizes=[30, 25, 28, 20])
    summary = main_geom_drugs.main([
        "--datadir", geom, "--outdir", str(tmp_path), "--exp_name", "gnn_geom",
        "--train_diffusion", "--trainable_ae", "--model", "gnn_dynamics", "--nf", "16",
        "--n_layers", "1", "--diffusion_steps", "4", "--batch_size", "4", "--n_epochs", "1",
        "--test_epochs", "1", "--n_stability_samples", "2", "--device", "cpu", "--no_wandb"])
    assert np.all(np.isfinite(summary["losses"][0]))
    _, cfg, _ = load_reference_checkpoint(str(tmp_path / "gnn_geom" / "best"), "cpu")
    assert cfg.dynamics.mode == "gnn_dynamics" and not cfg.include_charges


def _plain_checkpoint(path, **kw):
    """A plain-kind (EDM) training checkpoint: two train steps of a tiny
    model, written with utils.checkpoint.save_checkpoint and EDM's
    args.pickle shape (JAX's training CLI builds only the VAE and the latent
    model; a plain model comes from the library, as in JAX)."""
    cfg = factory.make_diffusion_model_config(INFO, nf=16, n_layers=1, diffusion_steps=6, **kw)
    model = factory.build_model(cfg, "cpu", torch.Generator().manual_seed(1))
    state = pts.create_train_state(model, cfg, 1e-4, ema_decay=0.999)
    step = pts.make_train_step(cfg, 0.999)
    rng = np.random.default_rng(0)
    from geoldm_tpu_torch.data.synthetic import synthetic_batch
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train import trainer

    nodes = DistributionNodes(INFO.n_nodes)
    for i in range(2):
        batch = trainer.to_device(trainer.prepare_host(synthetic_batch(INFO, 4, 12, rng), nodes),
                                  "cpu")
        step(state, batch, torch.Generator().manual_seed(i))
    ckpt.save_checkpoint(path, state, reference_args_from_model_config(cfg), 0.999)
    return cfg, state


@pytest.mark.parametrize("kw", [{}, {"model": "gnn_dynamics"}])
def test_plain_kind_resumes_evaluates_samples_and_serves(kw, qm9_dir, tmp_path):
    """The plain kind's checkpoint loads as the plain kind (EDM's args.pickle
    shape), --resume trains it through cli.main_qm9 (the checkpoint's config
    wins, as JAX's CLI lets it), and the checkpoints it writes keep the shape;
    eval_analyze, eval_sample and the server run on it."""
    start = str(tmp_path / "start")
    cfg, state = _plain_checkpoint(start, **kw)
    args = ckpt.load_args(start)
    assert not hasattr(args, "train_diffusion") and args.probabilistic_model == "diffusion"
    assert checkpoint_kind(args) == "diffusion" and ckpt.load_model_config(start) == cfg
    summary = main_qm9.main(["--datadir", qm9_dir, "--outdir", str(tmp_path), "--exp_name",
                             "edm", "--n_epochs", "1", "--test_epochs", "1", "--resume", start,
                             *TINY])
    assert summary["resumed"]["step"] == 2 and np.all(np.isfinite(summary["losses"][0]))
    best = str(tmp_path / "edm" / "best")
    model, got_cfg, saved = load_reference_checkpoint(best, "cpu")
    assert got_cfg == cfg and not hasattr(saved, "train_diffusion")
    assert type(model).__name__ == "EnVariationalDiffusion" and not hasattr(model, "vae")
    assert isinstance(model.gamma, PredefinedNoiseSchedule)
    _evaluate(str(tmp_path / "edm"), qm9_dir)
    out = eval_sample.main(["--model_path", str(tmp_path / "edm"), "--n_samples", "3",
                            "--n_stable", "0", "--n_chains", "1", "--keep_frames", "4",
                            "--device", "cpu"])
    assert out["molecules"] == 3 and out["chains"] == [14]
    body = {"sizes": [4, 9], "seed": 3}
    replies = _serve(best, [body, body, {"n_samples": 2, "seed": 4, "n_steps": 3}])
    _check_served(replies)
    assert replies[0][1]["n"] == 2


def _kinds():
    ldm = dict(nf=16, n_layers=2, latent_nf=2, diffusion_steps=6)
    return {
        "vae": factory.make_vae_config(INFO, nf=16, n_layers=2, latent_nf=2),
        "ldm": factory.make_latent_diffusion_config(INFO, trainable_ae=True, **ldm),
        "ldm_learned": factory.make_latent_diffusion_config(
            INFO, noise_schedule="learned", loss_type="vlb", **ldm),
        "ldm_gnn": factory.make_latent_diffusion_config(INFO, model="gnn_dynamics", **ldm),
        "edm": factory.make_diffusion_model_config(INFO, nf=16, n_layers=2, diffusion_steps=6),
        "edm_learned": factory.make_diffusion_model_config(
            INFO, nf=16, n_layers=2, diffusion_steps=6, noise_schedule="learned",
            loss_type="vlb"),
        "edm_gnn": factory.make_diffusion_model_config(INFO, nf=16, n_layers=2,
                                                       diffusion_steps=6, model="gnn_dynamics"),
    }


@pytest.mark.parametrize("name", ["ldm", "ldm_learned", "ldm_gnn", "edm", "edm_learned",
                                  "edm_gnn"])
def test_args_pickle_round_trip_of_each_variant(name, tmp_path):
    """Each generative variant's args.pickle reads back as its own config,
    its weights load strictly, and it never loads as another kind: a plain
    model's directory is not a first-stage VAE nor a latent model."""
    cfg = _kinds()[name]
    args = reference_args_from_model_config(cfg)
    assert model_config_from_reference_args(args, INFO) == cfg
    assert checkpoint_kind(args) == cfg.kind
    assert args.diffusion_noise_schedule == cfg.diffusion.noise_schedule
    assert args.model == cfg.dynamics.mode
    path = str(tmp_path / name)
    model = factory.build_model(cfg, "cpu", torch.Generator().manual_seed(2))
    save_reference_checkpoint(model, path)
    back, back_cfg, _ = load_reference_checkpoint(path, "cpu")
    assert back_cfg == cfg
    assert all(torch.equal(v, back.state_dict()[k]) for k, v in model.state_dict().items())
    with pytest.raises(ValueError, match="not a first-stage VAE"):
        ckpt.load_first_stage(path, use_ema=True)
    other = factory.make_latent_diffusion_config(INFO, nf=16, n_layers=2, latent_nf=2,
                                                 diffusion_steps=6)
    if cfg.kind == "diffusion":
        with pytest.raises(RuntimeError, match="Missing key"):
            factory.build_model(other, "cpu").load_state_dict(model.state_dict(), strict=True)


def test_vae_and_latent_args_still_load_as_before():
    """GeoLDM's args (``train_diffusion`` present) keep their kinds whatever
    ``probabilistic_model`` says; an args namespace with neither field stays a
    VAE; only EDM's shape (no ``train_diffusion``, ``probabilistic_model
    ='diffusion'``) is the plain kind. A VAE is not a generative sampler."""
    vae = _kinds()["vae"]
    geoldm = argparse.Namespace(train_diffusion=False, probabilistic_model="diffusion", nf=16,
                                n_layers=2, latent_nf=2)
    assert checkpoint_kind(geoldm) == "vae"
    assert model_config_from_reference_args(geoldm, INFO) == vae
    ldm_args = reference_args_from_model_config(_kinds()["ldm"])
    assert ldm_args.train_diffusion is True and checkpoint_kind(ldm_args) == "latent_diffusion"
    assert checkpoint_kind(argparse.Namespace(nf=16)) == "vae"
    with pytest.raises(ValueError, match="not a generative model"):
        reference_args_from_model_config(vae)
    with pytest.raises(ValueError, match="vae is not a generative sampler"):
        factory.model_sample_fn(vae)


def test_eval_and_serve_refuse_a_vae(qm9_dir, tmp_path):
    """A first-stage VAE checkpoint is refused by the generative entry points,
    as JAX's model_sample_fn refuses it."""
    vae_dir = str(tmp_path / "vae")
    main_qm9.main(["--datadir", qm9_dir, "--outdir", str(tmp_path), "--exp_name", "vae",
                   "--n_epochs", "1", *TINY])
    for run in (lambda: eval_analyze.main(["--model_path", vae_dir, "--datadir", qm9_dir,
                                           "--device", "cpu"]),
                lambda: serve.main(["--model_path", os.path.join(vae_dir, "best"), "--port",
                                    "0", "--device", "cpu"], serve_forever=False)):
        with pytest.raises(SystemExit, match="holds a 'vae' model"):
            run()
    with open(os.path.join(vae_dir, "best", "args.pickle"), "rb") as f:
        assert checkpoint_kind(pickle.load(f)) == "vae"


def test_variant_entry_points_default_to_the_card(tmp_path):
    """The plain kind, the learned schedule and the GNN build on the card by
    default, and the CLIs load their checkpoints there: without a card each
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    kinds = _kinds()
    for name in ("edm", "ldm_learned", "edm_gnn"):
        with pytest.raises(RuntimeError, match="cuda"):
            factory.build_model(kinds[name])
    path = str(tmp_path / "edm")
    save_reference_checkpoint(factory.build_model(kinds["edm"], "cpu"), path)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.SamplerService(serve.parse_args(["--model_path", path]))
    with pytest.raises(RuntimeError, match="cuda"):
        eval_analyze.main(["--model_path", path, "--skip_nll", "--n_samples", "2"])
