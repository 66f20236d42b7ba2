"""Port parity on CPU for resumable training: the adaptive clip's state and
its round trip, random rotations and the augmented batch prep, the prefetch
thread, and the training CLIs' --resume, --ae_path, --data_augmentation,
--prefetch and metrics.jsonl, serial and under --sp 2 (gloo ranks), each
against the JAX package or against the uninterrupted run."""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.models.distributions import DistributionNodes as JNodes
from geoldm_tpu.train import augment as jaug
from geoldm_tpu.train import optim as joptim
from geoldm_tpu.train import trainer as jtrainer
from geoldm_tpu_torch.cli import main_geom_drugs, main_qm9
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.qm9 import QM9Loader, load_qm9
from geoldm_tpu_torch.data.synthetic import write_geom_conformers, write_qm9_splits
from geoldm_tpu_torch.models import factory
from geoldm_tpu_torch.models.distributions import DistributionNodes
from geoldm_tpu_torch.parallel import sp
from geoldm_tpu_torch.train import augment, optim, prefetch, trainer
from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step
from geoldm_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

INFO = get_dataset_info("qm9")
TINY = ["--nf", "16", "--n_layers", "1", "--diffusion_steps", "6", "--batch_size", "8",
        "--n_stability_samples", "3", "--ema_decay", "0.9", "--no_wandb", "--device", "cpu"]
# The keys JAX's run logs (geoldm_tpu/cli/common.py:364, :377, :416, :433;
# geoldm_tpu/train/trainer.py:148), per epoch and per logged batch.
JAX_EPOCH_KEYS = [{"train_loss_epoch"}, {"mol_stable", "atm_stable"}, {"nll_val"},
                  {"nll_test", "best_nll_val"}]
JAX_BATCH_KEYS = {"batch_loss", "grad_norm"}


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("qm9_resume"))
    write_qm9_splits(path, INFO, {"train": 24, "valid": 8, "test": 8}, seed=2)
    return path


@pytest.fixture(scope="module")
def run(datadir, tmp_path_factory):
    """One epoch of 3 steps with augmentation and prefetch: latest/ and best/."""
    outdir = str(tmp_path_factory.mktemp("runs"))
    summary = main_qm9.main(["--datadir", datadir, "--outdir", outdir, "--exp_name", "ldm",
                             "--train_diffusion", "--trainable_ae", "--n_epochs", "1",
                             "--data_augmentation", "True", "--prefetch", "2", *TINY])
    return os.path.join(outdir, "ldm"), summary


def test_clip_state_matches_jax_and_round_trips():
    """60 gradients through the port's clip and JAX's adaptive_grad_clip
    (the ring of 50 wraps); a copy loaded from the state dict then clips the
    next gradient bit for bit as the original."""
    rng = np.random.default_rng(0)
    clip = optim.AdaptiveGradClip("cpu")
    jclip = joptim.adaptive_grad_clip()
    jstate = jclip.init(None)
    for step in range(60):
        g = (rng.standard_normal(7) * (1e4 if step == 30 else 1.0)).astype(np.float32)
        clip([torch.from_numpy(g.copy())])
        _, jstate = jclip.update({"g": jnp.asarray(g)}, jstate)
    assert (clip.count, clip.head) == (int(jstate.count), int(jstate.head)) == (50, 61)
    np.testing.assert_allclose(clip.norms.numpy(), np.asarray(jstate.norms), rtol=1e-6)
    copy = optim.AdaptiveGradClip("cpu")
    copy.load_state_dict(clip.state_dict())
    g = rng.standard_normal(7).astype(np.float32) * 40
    a, b = torch.from_numpy(g.copy()), torch.from_numpy(g.copy())
    assert torch.equal(clip([a]), copy([b])) and torch.equal(a, b)
    assert torch.equal(clip.norms, copy.norms) and (clip.count, clip.head) == (copy.count,
                                                                               copy.head)
    with pytest.raises(ValueError, match="ring buffer"):
        optim.AdaptiveGradClip("cpu", max_len=10).load_state_dict(clip.state_dict())


def test_rotation_and_augmented_batch_prep_are_jax_bit_for_bit(datadir):
    splits, _ = load_qm9(datadir)
    raw = next(iter(QM9Loader(splits["train"], 8, INFO.max_n_nodes, shuffle=False)))
    x = raw["x"].astype(np.float32)
    assert np.array_equal(augment.random_rotation(x, np.random.default_rng(4)),
                          jaug.random_rotation(x, np.random.default_rng(4)))
    prng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        got = trainer.prepare_batch(raw, DistributionNodes(INFO.n_nodes), "cpu", 0.3, prng,
                                    data_augmentation=True)
        want = jtrainer.prepare_batch(raw, JNodes(jax_info("qm9").n_nodes), augment_noise=0.3,
                                      data_augmentation=True, rng=jrng)
        assert np.array_equal(got["x"].numpy(), np.asarray(want["x"]))
        assert np.array_equal(got["log_pN"].numpy(), np.asarray(want["log_pN"]))
        assert not got["x"].numpy()[raw["node_mask"][..., 0] == 0].any()
    assert prng.bit_generator.state == jrng.bit_generator.state


def test_prefetch_keeps_the_serial_order_and_reraises():
    def draws(depth):
        rng = np.random.default_rng(1)
        return list(prefetch.prefetch_map(lambda i: (i, rng.standard_normal(3)), range(9),
                                          depth=depth))

    serial, ahead = draws(0), draws(2)
    assert [i for i, _ in ahead] == list(range(9))
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(serial, ahead))

    def boom(i):
        if i == 3:
            raise KeyError("batch 3")
        return i

    got = []
    with pytest.raises(KeyError, match="batch 3"):
        for v in prefetch.prefetch_map(boom, range(9), depth=2):
            got.append(v)
    assert got == [0, 1, 2]


def _tiny_state(seed=0, **kw):
    cfg = factory.make_latent_diffusion_config(INFO, nf=16, n_layers=1, diffusion_steps=6,
                                               trainable_ae=True, **kw)
    model = factory.build_model(cfg, "cpu", torch.Generator().manual_seed(seed))
    return cfg, create_train_state(model, cfg, 1e-3, ema_decay=0.9)


def test_train_epoch_at_prefetch_depth_0_and_2_is_the_same(datadir):
    """The same seeded epoch (augment noise and rotations on the host rng)
    serial and with the prefetch thread: the same losses and weights, bit for
    bit."""
    splits, _ = load_qm9(datadir)
    results = []
    for depth in (0, 2):
        cfg, state = _tiny_state()
        loader = QM9Loader(splits["train"], 8, INFO.max_n_nodes, seed=3)
        losses, _ = trainer.train_epoch(
            state, make_train_step(cfg, 0.9), loader, DistributionNodes(INFO.n_nodes),
            torch.Generator().manual_seed(1), 0, augment_noise=0.1, data_augmentation=True,
            rng=np.random.default_rng(2), prefetch=depth)
        results.append((losses, sp.state_digest(state)))
    assert results[0] == results[1] and len(results[0][0]) == 3


def _assert_state_equals_checkpoint(snapshot, path):
    """A train state's CPU copy against the files of a checkpoint directory,
    tensor for tensor."""
    load = lambda name: torch.load(os.path.join(path, name), weights_only=True)  # noqa: E731
    for key, name in (("model", "generative_model.npy"), ("ema", "generative_model_ema.npy")):
        want = load(name)
        assert set(snapshot[key]) == set(want)
        assert all(torch.equal(snapshot[key][k], want[k]) for k in want), key
    want = load("optim.npy")
    assert snapshot["optim"]["param_groups"] == want["param_groups"]
    assert snapshot["optim"]["state"].keys() == want["state"].keys()
    for i, entry in want["state"].items():
        for k, v in entry.items():
            assert torch.equal(torch.as_tensor(snapshot["optim"]["state"][i][k]).cpu(),
                               torch.as_tensor(v).cpu()), (i, k)
    extra = load(ckpt.TRAIN_STATE)
    assert snapshot["step"] == extra["step"]
    assert torch.equal(snapshot["clip"]["norms"], extra["clip"]["norms"])
    assert (snapshot["clip"]["count"], snapshot["clip"]["head"]) == \
        (extra["clip"]["count"], extra["clip"]["head"])


def test_resume_loads_the_checkpoint_and_its_config_wins(run, datadir, capsys, tmp_path):
    """--resume with a conflicting --nf: the checkpoint's config (nf 16) is
    used and said so, the loaded state equals latest/ tensor for tensor, and
    metrics.jsonl gains epoch 1 with JAX's keys (as JAX's
    tests/test_cli_integration.py:365)."""
    run_dir, first = run
    saved = tmp_path / "latest"
    shutil.copytree(os.path.join(run_dir, "latest"), saved)  # the resumed run rewrites it
    summary = main_qm9.main(["--datadir", datadir, "--outdir", os.path.dirname(run_dir),
                             "--exp_name", "ldm", "--train_diffusion", "--trainable_ae",
                             "--n_epochs", "2", "--start_epoch", "1", "--test_epochs", "1",
                             "--resume", run_dir, *TINY[:1], "32", *TINY[2:]])
    out = capsys.readouterr().out
    assert "resume: using the checkpoint's model config (overrides CLI)" in out
    assert "resumed from" in out and "at step 3" in out
    assert summary["state"].model.cfg.dynamics.egnn.hidden_nf == 16
    assert summary["resumed"]["step"] == 3 and summary["state"].step == 6
    assert summary["resumed"]["clip"]["count"] == 4  # the seeded entry + 3 steps
    _assert_state_equals_checkpoint(summary["resumed"], str(saved))
    # The checkpoints the resumed run wrote hold the resumed model's args,
    # not the conflicting flag, so they load as the model they hold.
    for name in ("latest", "best"):
        assert ckpt.load_model_config(os.path.join(run_dir, name)) == summary["state"].model.cfg
    records = [json.loads(ln) for ln in open(os.path.join(run_dir, "metrics.jsonl"))]
    for epoch in (0, 1):
        keys = [set(r) - {"_time", "_step"} for r in records if r.get("_step") == epoch]
        assert keys == JAX_EPOCH_KEYS, (epoch, keys)
    assert [set(r) - {"_time"} for r in records if "_step" not in r] == [JAX_BATCH_KEYS] * 2
    assert all(np.isfinite(r[k]) for r in records for k in r if k != "_step")
    assert len(first["rdkit"]) == 1 and all(0 <= v <= 1 for v in first["rdkit"][0])
    assert "epoch 1 validity " in out and " uniqueness " in out and " novelty " in out


def test_resumed_first_step_is_the_uninterrupted_step(tmp_path, datadir):
    """Two steps, a checkpoint, then one more step on the same batch and
    noise in the original state and in a state resumed from the checkpoint
    (built from other weights): every tensor bit-identical afterwards."""
    splits, _ = load_qm9(datadir)
    batches = [trainer.prepare_batch(raw, DistributionNodes(INFO.n_nodes), "cpu")
               for raw in QM9Loader(splits["train"], 8, INFO.max_n_nodes, seed=0)]
    cfg, state = _tiny_state(0)
    step = make_train_step(cfg, 0.9)
    for batch in batches[:2]:
        step(state, batch, torch.Generator().manual_seed(7))
    args = main_qm9.parse_args(["--train_diffusion", "--trainable_ae", *TINY])
    ckpt.save_checkpoint(str(tmp_path), state, args, 0.9)
    _, resumed = _tiny_state(1)
    ckpt.load_train_state(str(tmp_path), resumed)
    assert resumed.step == state.step == 2
    assert sp.state_digest(resumed) == sp.state_digest(state)
    for s in (state, resumed):
        step(s, batches[2], torch.Generator().manual_seed(9))
    assert sp.state_digest(resumed) == sp.state_digest(state)
    for a, b in zip(state.model.state_dict().values(), resumed.model.state_dict().values()):
        assert torch.equal(a, b)
    assert ckpt.load_model_config(str(tmp_path)) == cfg


def test_a_checkpoint_without_the_clip_file_resumes_with_a_fresh_clip(tmp_path, run):
    run_dir, _ = run
    old = tmp_path / "old"
    shutil.copytree(os.path.join(run_dir, "latest"), old)
    os.remove(old / ckpt.TRAIN_STATE)
    _, state = _tiny_state(1)
    monkey = pytest.MonkeyPatch()
    monkey.setattr(ckpt, "_FRESH_CLIP_WARNED", False)
    with pytest.warns(UserWarning, match="start fresh"):
        ckpt.load_train_state(str(old), state)
    monkey.undo()
    assert state.step == 0 and state.clip.count == 1 and float(state.clip.norms[0]) == 3000.0
    want = torch.load(old / "generative_model.npy", weights_only=True)
    assert all(torch.equal(v, want[k]) for k, v in state.model.state_dict().items())


@pytest.fixture(scope="module")
def first_stage(datadir, tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("ae"))
    main_qm9.main(["--datadir", datadir, "--outdir", outdir, "--exp_name", "vae",
                   "--n_epochs", "1", "--break_train_epoch", "True", *TINY])
    return os.path.join(outdir, "vae")


def test_ae_path_loads_the_first_stage(first_stage, datadir, tmp_path):
    """JAX's two-stage protocol (tests/test_cli_integration.py:314): the
    latent diffusion's vae, and its EMA copy's, are the first stage's EMA
    weights before the first step, and a run with the frozen first stage
    keeps them."""
    want = torch.load(os.path.join(first_stage, "best", "generative_model_ema.npy"),
                      weights_only=True)
    common = ["--datadir", datadir, "--outdir", str(tmp_path), "--train_diffusion",
              "--ae_path", first_stage, *TINY]
    before = main_qm9.main(["--exp_name", "ldm0", "--n_epochs", "0", *common])["state"]
    after = main_qm9.main(["--exp_name", "ldm1", "--n_epochs", "1",
                           "--break_train_epoch", "True", *common])
    for model in (before.model, before.ema_model, after["state"].model):
        got = model.vae.state_dict()
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    assert len(after["losses"][0]) == 1 and os.path.exists(tmp_path / "ldm1" / "metrics.jsonl")
    no_ema = tmp_path / "no_ema"
    shutil.copytree(os.path.join(first_stage, "best"), no_ema)
    os.remove(no_ema / "generative_model_ema.npy")
    with pytest.raises(SystemExit, match="generative_model_ema.npy is missing"):
        main_qm9.main(["--exp_name", "ldm2", "--n_epochs", "0", *common[:-len(TINY) - 2],
                       "--ae_path", str(no_ema), *TINY])


@pytest.fixture(scope="module")
def geom_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("geom_resume"))
    write_geom_conformers(path, get_dataset_info("geom"), 20, seed=4,
                          sizes=[20, 25, 30, 28, 33, 22])
    flags = ["--datadir", path, "--outdir", path, "--exp_name", "geom", "--train_diffusion",
             "--trainable_ae", "--batch_size", "4", "--nf", "16", "--n_layers", "1",
             "--diffusion_steps", "6", "--n_stability_samples", "2", "--ema_decay", "0.99",
             "--no_wandb", "--device", "cpu"]
    first = main_geom_drugs.main([*flags, "--n_epochs", "1", "--prefetch", "0"])
    return os.path.join(path, "geom"), flags, first


def test_geom_resume_under_sp_keeps_the_replicas_identical(geom_run):
    """cli.main_geom_drugs --resume --data_augmentation --sp 2 on gloo ranks:
    every rank loads latest/ (equal digests), trains an augmented epoch, and
    the replicas end bit-identical."""
    run_dir, flags, first = geom_run
    summary = main_geom_drugs.main([*flags, "--n_epochs", "2", "--start_epoch", "1",
                                    "--resume", run_dir, "--data_augmentation", "True",
                                    "--sp", "2"])
    r0, r1 = summary["replicas"]
    assert r0["resumed_digest"] == r1["resumed_digest"]
    assert r0["digest"] == r1["digest"] != r0["resumed_digest"]
    _assert_state_equals_checkpoint(summary["resumed"], os.path.join(run_dir, "latest"))
    assert summary["resumed"]["step"] == len(first["losses"][0])
    assert np.all(np.isfinite(summary["losses"][0]))
