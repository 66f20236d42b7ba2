"""The conditional entry points of the port on the CPU: conditional
training through ``cli.main_qm9`` (``--conditioning``, ``--context_dropout``,
``--resume``), the ``args.pickle`` of a classifier-free guidance (CFG)
model, the conditional server over real HTTP, and ``cli.main_qm9_prop`` and
``cli.eval_conditional_qm9`` against the JAX CLIs on fabricated splits with
the same weights and, for generation, JAX's draws replayed.

Tolerances: the classifier CLI's losses and weights after one epoch 1e-4
relative (three Adam steps, tests/test_torch_port_conditional.py); the
qm9 / naive MAEs 1e-5 relative (one classifier forward per batch); the edm
MAE 1e-4 relative (a 6-step guided sampler run, then the classifier)."""

import os
import pickle
import threading

import jax
import numpy as np
import pytest
import torch

from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.models import classifier as jclf
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.utils import checkpoint as jckpt
from geoldm_tpu_torch.cli import common, eval_conditional_qm9, main_qm9, main_qm9_prop, serve
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.synthetic import write_qm9_splits
from geoldm_tpu_torch.models import classifier as pclf
from geoldm_tpu_torch.models import factory
from geoldm_tpu_torch.train import classifier_train as pct
from geoldm_tpu_torch.train import sampling as psampling
from geoldm_tpu_torch.train.conditioning import load_conditional_protocol
from geoldm_tpu_torch.utils.convert import (
    classifier_state_dict_from_jax_params,
    load_reference_checkpoint,
    model_config_from_reference_args,
    reference_args_from_model_config,
    save_reference_checkpoint,
    state_dict_from_jax_params,
)
from tests.test_torch_port_conditional import _sample_draws
from tests.test_torch_port_serve import _request
from tests.torch_port_utils import Feed

torch.set_num_threads(1)

INFO = get_dataset_info("qm9")
CFG_KW = dict(nf=16, n_layers=1, latent_nf=1, diffusion_steps=6, context_node_nf=1,
              context_indicator=True)


@pytest.fixture(scope="module")
def splits_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cond_cli"))
    write_qm9_splits(path, INFO, {"train": 64, "valid": 16, "test": 8}, seed=5)
    return path


def _train_argv(datadir, outdir):
    return ["--datadir", datadir, "--outdir", outdir, "--train_diffusion", "--trainable_ae",
            "--nf", "16", "--n_layers", "2", "--diffusion_steps", "6", "--batch_size", "8",
            "--test_epochs", "1", "--n_stability_samples", "4", "--device", "cpu",
            "--dataset", "qm9_second_half", "--no_wandb"]


def test_conditional_training_and_resume_keep_the_context_width(splits_dir, tmp_path):
    argv = _train_argv(splits_dir, str(tmp_path))
    first = main_qm9.main(argv + ["--n_epochs", "1", "--conditioning", "alpha",
                                  "--context_dropout", "0.1"])
    cfg = first["state"].model.cfg
    assert cfg.context_indicator and cfg.dynamics.context_node_nf == 2
    assert cfg.vae.context_node_nf == 2 and cfg.dynamics.egnn.in_node_nf == 1 + 1 + 2
    assert np.all(np.isfinite(first["losses"][0])) and np.isfinite(first["nll_val"][0])
    run = os.path.join(str(tmp_path), "geoldm_tpu_run")
    with open(os.path.join(run, "latest", "args.pickle"), "rb") as f:
        args = pickle.load(f)
    assert args.conditioning == ["alpha"] and args.context_node_nf == 1
    assert args.context_indicator is True
    model, loaded_cfg, _ = load_reference_checkpoint(os.path.join(run, "best"), "cpu")
    assert loaded_cfg == cfg
    # Resumed without the conditioning flags: the checkpoint's config and
    # properties win, and the run goes on at the same context width.
    second = main_qm9.main(argv + ["--n_epochs", "2", "--start_epoch", "1", "--resume", run])
    assert second["state"].model.cfg == cfg and second["state"].step == 2 * len(first["losses"][0])
    for k, v in first["state"].model.state_dict().items():
        assert torch.equal(second["resumed"]["model"][k], v.cpu()), k


def test_conditioning_is_refused_where_not_ported(splits_dir, tmp_path):
    """--conditioning runs under --sp now (two CPU ranks with context
    dropout, the replicas bit-identical); it is still refused where no
    property arrays come with the splits (GEOM)."""
    common.check_ported(main_qm9.parse_args(["--conditioning", "alpha", "--sp", "2"]))
    summary = main_qm9.main(_train_argv(splits_dir, str(tmp_path)) + [
        "--n_epochs", "1", "--conditioning", "alpha", "--context_dropout", "0.1", "--sp", "2",
        "--break_train_epoch", "True"])
    assert len(summary["losses"][0]) == 1 and np.all(np.isfinite(summary["losses"][0]))
    assert len({r["digest"] for r in summary["replicas"]}) == 1
    args = main_qm9.parse_args(_train_argv(splits_dir, str(tmp_path)) + ["--conditioning",
                                                                        "alpha"])
    with pytest.raises(SystemExit, match="QM9 splits' property arrays"):  # GEOM passes none
        common.run_training(args, INFO, None, loaders={})


def test_resume_keeps_an_unconditional_checkpoint_unconditional(splits_dir, tmp_path):
    """The checkpoint's config and property names win over --conditioning
    (the resume rule for every model field)."""
    out = str(tmp_path / "plain")
    main_qm9.main(_train_argv(splits_dir, out) + ["--n_epochs", "1"])
    run = os.path.join(out, "geoldm_tpu_run")
    resumed = main_qm9.main(_train_argv(splits_dir, out) + [
        "--n_epochs", "2", "--start_epoch", "1", "--resume", run, "--conditioning", "alpha"])
    assert resumed["state"].model.cfg.dynamics.context_node_nf == 0
    with open(os.path.join(run, "latest", "args.pickle"), "rb") as f:
        assert pickle.load(f).conditioning == []


def test_cfg_model_args_pickle_round_trip(tmp_path):
    cfg = factory.make_latent_diffusion_config(INFO, **CFG_KW)
    model = factory.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    save_reference_checkpoint(model, str(tmp_path), conditioning=["alpha"])
    loaded, cfg2, args = load_reference_checkpoint(str(tmp_path), "cpu")
    assert cfg2 == cfg and args.conditioning == ["alpha"] and args.context_indicator is True
    assert args.context_node_nf == 1
    for (k, a), (_, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(a, b), k
    # Without the field (an upstream or pre-port args.pickle) there is no
    # indicator channel.
    del args.context_indicator
    plain = model_config_from_reference_args(args, INFO)
    assert not plain.context_indicator and plain.dynamics.context_node_nf == 1
    with pytest.raises(ValueError, match="1 property channel"):
        reference_args_from_model_config(cfg)


# --- the conditional server ---

@pytest.fixture(scope="module")
def cond_server(splits_dir, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cond_serve") / "ckpt")
    cfg = factory.make_latent_diffusion_config(INFO, **CFG_KW)
    save_reference_checkpoint(factory.build_model(cfg, "cpu", torch.Generator().manual_seed(1)),
                              path, conditioning=["alpha"])
    srv, service = serve.main(["--model_path", path, "--port", "0", "--batch_max", "8",
                               "--device", "cpu", "--datadir", splits_dir, "--conditioning",
                               "alpha", "--compute_dtype", "float32"], serve_forever=False)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service, path
    srv.shutdown()
    srv.server_close()


def test_properties_request_replays_and_is_normalized(cond_server, splits_dir):
    base, service, _ = cond_server
    req = {"sizes": [5, 9, 12], "seed": 4, "properties": {"alpha": 70.0}, "n_steps": 3}
    code, a = _request(base, "/sample", req)
    assert code == 200 and a["n"] == 3 and a["properties"] == {"alpha": 70.0}
    assert a["cfg_scale"] == 1.0
    code, b = _request(base, "/sample", req)
    assert code == 200 and b["molecules"] == a["molecules"]
    _, norms, _, _, _ = load_conditional_protocol(splits_dir, ["alpha"])
    ctx, _ = service.request_context(req, np.array([5, 9]), 4)
    want = (70.0 - norms["alpha"]["mean"]) / norms["alpha"]["mad"]
    np.testing.assert_allclose(ctx, np.full((2, 1), want, np.float32))
    code, c = _request(base, "/sample", {**req, "properties": {"alpha": 90.0}})
    assert code == 200 and c["molecules"] != a["molecules"]


def test_unset_properties_are_drawn_from_the_split(cond_server, splits_dir):
    base, service, _ = cond_server
    code, a = _request(base, "/sample", {"n_samples": 3, "seed": 2, "cfg_scale": 2.1,
                                         "n_steps": 2})
    assert code == 200 and a["properties"] == "sampled-from-data-distribution"
    assert a["cfg_scale"] == 2.0
    _, _, _, nodes, pad = load_conditional_protocol(splits_dir, ["alpha"])
    assert service.max_request_size == pad
    assert all(len(m) in nodes.n_nodes for m in a["molecules"])


@pytest.mark.parametrize("cfg_scale,want", [(0.0, 0.0), (1.1, 1.0), (2.13, 2.25), (7.9, 8.0)])
def test_cfg_scale_is_quantised(cond_server, cfg_scale, want):
    _, service, _ = cond_server
    assert service.sampler_settings({"cfg_scale": cfg_scale})[4] == want


@pytest.mark.parametrize("body,fragment", [
    ({"sizes": [5], "properties": {"mu": 1.0}}, "properties is missing 'alpha'"),
    ({"sizes": [5], "properties": [70.0]}, "properties must be an object of {alpha} -> value"),
    ({"sizes": [5], "properties": {"alpha": "x"}}, "properties['alpha'] must be a number"),
    ({"sizes": [5], "cfg_scale": 11}, "cfg_scale must be in [0.0, 10.0]"),
    ({"sizes": [29]}, "sizes must be in [1, "),
])
def test_conditional_requests_are_validated(cond_server, body, fragment):
    base, _, _ = cond_server
    code, out = _request(base, "/sample", body)
    assert code == 400 and fragment in out["error"]


def test_conditional_checkpoint_needs_datadir_and_names(cond_server):
    _, _, path = cond_server
    for extra in ([], ["--conditioning", "alpha"], ["--datadir", "x", "--conditioning", "a",
                                                   "b"]):
        with pytest.raises(SystemExit, match="pass --datadir and --conditioning"):
            serve.SamplerService(serve.parse_args(["--model_path", path, "--device", "cpu",
                                                   *extra]))


def test_cfg_scale_is_one_without_a_context(tmp_path):
    cfg = factory.make_latent_diffusion_config(INFO, nf=16, n_layers=1, diffusion_steps=4)
    save_reference_checkpoint(factory.build_model(cfg, "cpu", torch.Generator().manual_seed(0)),
                              str(tmp_path))
    service = serve.SamplerService(serve.parse_args(["--model_path", str(tmp_path), "--device",
                                                     "cpu", "--cfg_scale", "3"]))
    assert service.sampler_settings({})[4] == 1.0
    assert service.sampler_settings({"cfg_scale": 2.0})[4] == 1.0
    a = service.sample({"sizes": [6, 8], "seed": 1, "cfg_scale": 2.0})
    b = service.sample({"sizes": [6, 8], "seed": 1})
    assert a["molecules"] == b["molecules"] and "cfg_scale" not in a


# --- the classifier CLIs against JAX's ---

def _jax_init_classifier(seed, nf, n_layers, build=pclf.build_classifier):
    params = jclf.classifier_init(jax.random.key(seed), 5, nf, n_layers, True, False)
    model = build("egnn", 5, nf, n_layers, device="cpu")
    model.load_state_dict(classifier_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)), strict=True)
    return params, model


def test_main_qm9_prop_one_epoch_matches_jax(splits_dir, tmp_path, monkeypatch):
    from geoldm_tpu.cli import main_qm9_prop as jprop

    argv = ["--datadir", splits_dir, "--epochs", "1", "--batch_size", "8", "--nf", "16",
            "--n_layers", "2", "--property", "alpha", "--exp_name", "cls"]
    jprop.main(argv + ["--outf", str(tmp_path / "jax")])
    with open(tmp_path / "jax" / "cls" / "losess.json") as f:
        import json

        want = json.load(f)
    # The port's run starts from JAX's initial weights.
    monkeypatch.setattr(pct.clf, "build_classifier",
                        lambda *a, **k: _jax_init_classifier(1, 16, 2)[1])
    got = main_qm9_prop.main(argv + ["--outf", str(tmp_path / "port"), "--device", "cpu"])
    for key in ("best_val", "best_test"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    assert got["best_epoch"] == want["best_epoch"] == 0
    template = jclf.classifier_init(jax.random.key(0), 5, 16, 2, True, False)
    jparams = jckpt.load_checkpoint(str(tmp_path / "jax" / "cls"), template, name="best")
    loaded = pct.load_classifier(str(tmp_path / "port" / "cls"), 16, 2, device="cpu")
    for name, w in classifier_state_dict_from_jax_params(
            jax.tree.map(np.asarray, jparams)).items():
        scale = max(1.0, float(w.abs().max()))
        assert float((loaded.state_dict()[name] - w).abs().max()) <= 1e-4 * scale, name


@pytest.fixture(scope="module")
def eval_checkpoints(splits_dir, tmp_path_factory):
    """One conditional CFG generator and one classifier, each written by
    both packages from the same weights."""
    root = tmp_path_factory.mktemp("cond_eval")
    jcfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **CFG_KW)
    params = jfactory.init_params(jax.random.key(3), jcfg)
    jckpt.save_checkpoint(str(root / "jgen"), {"params": params, "ema_params": params}, jcfg,
                          name="best")
    pcfg = factory.make_latent_diffusion_config(INFO, **CFG_KW)
    model = factory.build_model(pcfg, "cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), pcfg),
                          strict=True)
    save_reference_checkpoint(model, str(root / "pgen" / "best"), conditioning=["alpha"])
    cparams, classifier = _jax_init_classifier(4, 16, 2)
    jckpt.save_checkpoint(str(root / "jcls"), cparams, name="best")
    pct.save_classifier(str(root / "pcls" / "best"), classifier.state_dict())
    return root


@pytest.mark.parametrize("task,rtol", [("qm9", 1e-5), ("naive", 1e-5), ("edm", 1e-4)])
def test_eval_conditional_qm9_matches_jax(splits_dir, eval_checkpoints, task, rtol,
                                          monkeypatch):
    from geoldm_tpu.cli import eval_conditional_qm9 as jeval

    root = eval_checkpoints
    argv = ["--property", "alpha", "--iterations", "2", "--batch_size", "4", "--datadir",
            splits_dir, "--classifier_nf", "16", "--classifier_layers", "2", "--task", task,
            "--seed", "3", "--cfg_scale", "2", "--clip_z", "15"]
    want = jeval.main(argv + ["--generators_path", str(root / "jgen"), "--classifiers_path",
                              str(root / "jcls")])
    # JAX's draws: key(seed) split once per iteration, then ldm_sample's split.
    keys, key = [], jax.random.key(3)
    for _ in range(2):
        key, sub = jax.random.split(key)
        keys.append(jax.random.split(sub)[0])
    monkeypatch.setattr(psampling, "chunk_generator", lambda seed, it, device: Feed(
        _sample_draws(keys[it], 4, INFO["max_n_nodes"], CFG_KW["diffusion_steps"])))
    got = eval_conditional_qm9.main(argv + ["--generators_path", str(root / "pgen"),
                                            "--classifiers_path", str(root / "pcls"),
                                            "--device", "cpu"])
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_qualitative_task_is_not_ported(monkeypatch):
    """--task qualitative is ported (``test_qualitative_sweep_is_written_and_rendered``);
    where matplotlib is missing it exits at argument checking, naming it."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="--task qualitative renders with matplotlib and "
                                         "imageio; this Python lacks matplotlib"):
        eval_conditional_qm9.main(["--task", "qualitative"])


def test_qualitative_sweep_is_written_and_rendered(splits_dir, eval_checkpoints, monkeypatch):
    """The property sweep at 19 atoms (noise fixed), written as one xyz
    frame per value under <generators_path>/sweep_alpha and rendered to a GIF
    (5 frames instead of 100 keep the CPU render short)."""
    import functools

    import imageio

    from geoldm_tpu_torch.evalsuite.visualizer import load_molecule_xyz

    root = eval_checkpoints
    monkeypatch.setattr(psampling, "sample_sweep_conditional",
                        functools.partial(psampling.sample_sweep_conditional, n_frames=5))
    gif = eval_conditional_qm9.main(["--task", "qualitative", "--property", "alpha",
                                     "--datadir", splits_dir, "--generators_path",
                                     str(root / "pgen"), "--classifiers_path",
                                     str(root / "pcls"), "--classifier_nf", "16",
                                     "--classifier_layers", "2", "--device", "cpu"])
    sweep = root / "pgen" / "sweep_alpha"
    assert gif == str(sweep / "output.gif")
    frames = sorted(f for f in os.listdir(sweep) if f.endswith(".txt"))
    assert frames == [f"chain_{i:03d}.txt" for i in range(5)]
    for f in frames:
        pos, one_hot = load_molecule_xyz(str(sweep / f), INFO)
        assert pos.shape == (19, 3) and np.isfinite(pos).all() and (one_hot.sum(1) == 1).all()
    assert 1 <= len(imageio.mimread(gif)) <= 5
