"""Few-step and reduced-precision sampling on the CPU, against the JAX
package: DDIM jumps at eta 0 / 0.5 / 1 and K = 1 / 7 / T, DPM-Solver++(2M),
the clip_z guard, the chain sampler's frames and slots, the mixed-precision
tail, the latent-diffusion sampler with its decode, the server's few-step
requests, ``eval_analyze --n_steps --sampler dpm2m``, ``eval_sample`` and the
training CLI's ``--eval_n_steps``. JAX's draws are rebuilt from its key splits
(``vdm_sample``: z_T, one per step, the final step) and handed to the port's
noise source (tests/torch_port_utils.py).

Tolerances: an f32 sampler run against JAX's, 1e-4 * max(1, max|ref|): each
step's denoiser agrees to ~1e-6 relative (tests/test_torch_port_egnn.py) and
a run of at most T = 10 jumps adds those up. With a ``full`` bf16 compute
dtype JAX also keeps activations in bf16 and the port does not, so the mixed
sampler is held at 5e-2 * max(1, max|ref|) (as the bf16 EGNN,
tests/test_torch_port_bf16.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu.cli import serve as jserve
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.diffusion import latent as jlatent
from geoldm_tpu.diffusion import vdm as jvdm
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.ops.distance import build_edge_mask
from geoldm_tpu.train import sampling as jsampling
from geoldm_tpu.utils.torch_convert import params_from_reference_state_dict
from geoldm_tpu_torch.cli import eval_analyze, eval_sample, main_qm9, serve
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.synthetic import write_qm9_splits
from geoldm_tpu_torch.diffusion import latent as platent
from geoldm_tpu_torch.diffusion import vdm as pvdm
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.train import sampling as psampling
from geoldm_tpu_torch.train import trainer as ptrainer
from geoldm_tpu_torch.utils.convert import save_reference_checkpoint
from tests.test_torch_port_serve import _request
from tests.torch_port_utils import Feed, jax_combined_draws, masked_inputs, t

torch.set_num_threads(1)

T = 10
KW = dict(nf=32, n_layers=2, latent_nf=1, diffusion_steps=T)
RTOL = 1e-4
MIXED_RTOL = 5e-2
INFO = get_dataset_info("qm9")
B, N, N_REAL = 3, 9, (5, 9, 7)


@pytest.fixture(scope="module")
def models():
    """The port model with seeded weights and the JAX params carrying them."""
    pcfg = pfactory.make_latent_diffusion_config(INFO, **KW)
    jcfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **KW)
    model = pfactory.build_model(pcfg, "cpu", torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, jcfg, params_from_reference_state_dict(sd, jcfg)


def _mask():
    return masked_inputs(0, B, N, 1, N_REAL)[3]


def _draws(key, k_steps: int, feat: int = 1):
    """JAX vdm_sample's draws from ``key``: z_T, ``k_steps`` steps, the
    final step (vdm.py:641, :702, :766)."""
    k_init, k_scan, k_final = jax.random.split(key, 3)
    draws = jax_combined_draws(k_init, B, N, 3, feat)
    if k_steps:
        for k in jax.random.split(k_scan, k_steps):
            draws += jax_combined_draws(k, B, N, 3, feat)
    return draws + jax_combined_draws(k_final, B, N, 3, feat)


def _jax_sample(models, mask, key, **kw):
    _, jcfg, params = models
    mj = jnp.asarray(mask)
    return jvdm.vdm_sample(params, jcfg.diffusion, jcfg.dynamics, key, mj, build_edge_mask(mj),
                           latent_space=True, **kw)


def _port_sample(models, mask, draws, **kw):
    model = models[0]
    with torch.no_grad():
        return pvdm.vdm_sample(model.dynamics, model.cfg.diffusion, Feed(draws), t(mask), **kw)


def _close(got, want, rtol, what=""):
    want = np.asarray(want)
    if want.size == 0:
        return
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rtol * scale, f"{what}: max|d|={err:.3e} > {rtol}*{scale:.3g}"


def _assert_samples(got, want, rtol=RTOL):
    for g, w, what in zip(got, want, ("x", "h_cat", "h_int")):
        assert tuple(g.shape) == tuple(np.asarray(w).shape), what
        _close(g, w, rtol, what)


@pytest.mark.parametrize("n_steps", [1, 7, T])
@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0])
def test_ddim_matches_jax(models, eta, n_steps):
    mask, key = _mask(), jax.random.key(11)
    want = _jax_sample(models, mask, key, n_steps=n_steps, eta=eta)
    got = _port_sample(models, mask, _draws(key, n_steps), n_steps=n_steps, eta=eta)
    _assert_samples(got, want)


def test_ddim_at_t_with_eta_1_is_the_dense_sampler(models):
    mask, key = _mask(), jax.random.key(12)
    draws = _draws(key, T)
    dense = _port_sample(models, mask, draws)
    strided = _port_sample(models, mask, draws, n_steps=T, eta=1.0)
    _assert_samples(strided, [d.numpy() for d in dense])
    _assert_samples(dense, _jax_sample(models, mask, key))


@pytest.mark.parametrize("n_steps", [2, T])
def test_dpm2m_matches_jax(models, n_steps):
    mask, key = _mask(), jax.random.key(13)
    want = _jax_sample(models, mask, key, n_steps=n_steps, method="dpm2m")
    got = _port_sample(models, mask, _draws(key, 0), n_steps=n_steps, method="dpm2m")
    _assert_samples(got, want)


@pytest.mark.parametrize("clip_z", [0.0, 0.5])
def test_clip_z_matches_jax(models, clip_z):
    mask, key = _mask(), jax.random.key(14)
    for kw, k_steps in (({}, T), ({"n_steps": 7, "eta": 0.0}, 7),
                        ({"n_steps": 3, "method": "dpm2m"}, 0)):
        want = _jax_sample(models, mask, key, clip_z=clip_z, **kw)
        got = _port_sample(models, mask, _draws(key, k_steps), clip_z=clip_z, **kw)
        _assert_samples(got, want)
        plain = _port_sample(models, mask, _draws(key, k_steps), **kw)
        same = all(torch.equal(a, b) for a, b in zip(got, plain))
        assert same == (clip_z == 0.0)  # 0 is the identity, bit for bit; 0.5 clips


@pytest.mark.parametrize("keep_frames", [4, 10, 13])
def test_chain_frames_and_slots_match_jax(models, keep_frames):
    mask, key = _mask(), jax.random.key(15)
    (xj, cj, ij), chain_j = _jax_sample(models, mask, key, keep_frames=keep_frames)
    (xp, cp, ip), chain_p = _port_sample(models, mask, _draws(key, T), keep_frames=keep_frames)
    _assert_samples((xp, cp, ip), (xj, cj, ij))
    assert tuple(chain_p.shape) == tuple(chain_j.shape) == (keep_frames, B, N, 3 + 1)
    _close(chain_p, chain_j, RTOL, "chain")
    gather = [T - 1 - -(-(k * T) // keep_frames) for k in range(keep_frames)]  # JAX's index
    assert pvdm.chain_slots(T, keep_frames) == [T - 1 - g % T for g in gather]
    with pytest.raises(ValueError, match="dense sampler"):
        _port_sample(models, mask, _draws(key, 3), keep_frames=4, n_steps=3)


def _dtype_log(model, monkeypatch):
    """Record the compute dtype of every denoiser and decoder call (both take
    it as their last positional argument)."""
    log = []
    for name, mod in (("dyn", model.dynamics), ("dec", model.vae.decoder)):
        def spy(*a, _fwd=mod.forward, _name=name):
            log.append((_name, a[-1]))
            return _fwd(*a)

        monkeypatch.setattr(mod, "forward", spy)
    return log


@pytest.mark.parametrize("k_steps,tail", [(1, 0), (5, 0), (10, 1), (15, 2), (20, 2), (25, 2),
                                          (50, 5), (1000, 100)])
def test_mixed_tail_is_rounded_as_jax(k_steps, tail):
    """round(0.1 K), Python's round as JAX's (0.5 -> 0, 1.5 -> 2, 2.5 -> 2),
    under bfloat16_mixed only."""
    assert pvdm.mixed_tail_steps("bfloat16_mixed", k_steps) == tail
    assert pvdm.mixed_tail_steps("bfloat16_full", k_steps) == 0
    assert pvdm.mixed_tail_steps("bfloat16", k_steps) == 0


@pytest.mark.parametrize("kw,k_steps,tail", [
    ({"n_steps": 10, "eta": 0.0}, 10, 1), ({"n_steps": 5, "method": "dpm2m"}, 5, 0),
    ({"n_steps": 7}, 7, 1), ({}, T, 1)])
def test_mixed_tail_runs_the_last_steps_and_the_final_step_in_f32(models, monkeypatch, kw,
                                                                   k_steps, tail):
    """The last round(0.1 K) steps and the final p(x|z0) step in f32 under
    bfloat16_mixed; the decoder in the compute dtype, as JAX's ldm_sample
    decodes. The sampler resolves the name once: the denoiser and the
    decoder get the operand dtype (None: f32)."""
    model = models[0]
    assert pvdm.mixed_tail_steps("bfloat16_mixed", k_steps) == tail
    log = _dtype_log(model, monkeypatch)
    draws = jax_combined_draws(jax.random.key(0), B, N, 3, 1)
    noise = Feed(draws + [("n", np.zeros(s, np.float32)) for s in [(B, N, 3), (B, N, 1)] * 40])
    platent.ldm_sample(model, noise, t(_mask()), compute_dtype="bfloat16_mixed", **kw)
    head = [torch.bfloat16] * (k_steps - tail)
    final = [None] if tail else [torch.bfloat16]
    assert [d for name, d in log if name == "dyn"] == head + [None] * tail + final
    assert [d for name, d in log if name == "dec"] == [torch.bfloat16]


@pytest.mark.parametrize("kw,k_steps", [({"n_steps": 10, "eta": 0.0}, 10),
                                        ({"n_steps": 10, "method": "dpm2m"}, 0)])
def test_mixed_sampler_matches_jax_bfloat16_mixed(models, kw, k_steps):
    mask, key = _mask(), jax.random.key(16)
    want = _jax_sample(models, mask, key, compute_dtype="bfloat16_mixed", **kw)
    got = _port_sample(models, mask, _draws(key, k_steps), compute_dtype="bfloat16_mixed", **kw)
    _assert_samples(got, want, MIXED_RTOL)


def test_few_step_ldm_sample_with_decode_matches_jax(models):
    model, jcfg, params = models
    mask, key = _mask(), jax.random.key(17)
    mj = jnp.asarray(mask)
    xj, cj, ij = jlatent.ldm_sample(params, jcfg.diffusion, jcfg.dynamics, jcfg.vae, key, mj,
                                    build_edge_mask(mj), n_steps=4, method="dpm2m", clip_z=2.0)
    k_diff, _ = jax.random.split(key)
    x, h_cat, h_int = platent.ldm_sample(model, Feed(_draws(k_diff, 0)), t(mask), n_steps=4,
                                         method="dpm2m", clip_z=2.0)
    _close(x, xj, RTOL, "x")
    real = mask[:, :, 0] > 0
    np.testing.assert_array_equal(h_cat.numpy().argmax(-1)[real], np.asarray(cj).argmax(-1)[real])
    np.testing.assert_array_equal(h_int.numpy(), np.asarray(ij))


def test_strided_grid_and_bad_settings():
    for k in (1, 3, 7, T):
        tau = pvdm.strided_grid(T, k)
        assert tau[0] == T and tau[-1] == 0 and all(a > b for a, b in zip(tau, tau[1:]))
    mask = t(_mask())
    with pytest.raises(ValueError, match="n_steps must be in"):
        pvdm.vdm_sample(None, pfactory.make_latent_diffusion_config(INFO, **KW).diffusion,
                        torch.Generator(), mask, n_steps=T + 1)
    with pytest.raises(ValueError, match="unknown sampling method"):
        pvdm.vdm_sample(None, None, None, mask, method="euler")


def test_rotate_chain_matches_jax():
    z = np.random.default_rng(0).standard_normal((1, 6, 9)).astype(np.float32)
    np.testing.assert_allclose(psampling.rotate_chain(z, 7), jsampling.rotate_chain(z, 7),
                               rtol=1e-12)


def test_sample_chain_replays_and_holds_the_final_frame(models):
    model = models[0]
    one_hot, charges, x = psampling.sample_chain(model, 3, INFO, n_tries=2, keep_frames=5)
    assert one_hot.shape == (15, 19, 5) and charges.shape == (15, 19, 1) and x.shape == (15, 19, 3)
    assert np.isfinite(x).all() and (x[-10:] == x[-1]).all()
    again = psampling.sample_chain(model, 3, INFO, n_tries=2, keep_frames=5)
    assert all(np.array_equal(a, b) for a, b in zip(again, (one_hot, charges, x)))


# --- the server -------------------------------------------------------------


@pytest.mark.parametrize("n_steps,want", [(7, 8), (4, 3), (49, 50), (1000, 1000), (17, 15),
                                          (999, 1000)])
def test_n_steps_snaps_to_jax_ladder(n_steps, want):
    assert serve._NSTEPS_LADDER == jserve._NSTEPS_LADDER
    assert serve.snap_n_steps(n_steps, 1000) == want
    # JAX's rule (serve.py:342-373), T itself a rung.
    assert want == min((k for k in (*jserve._NSTEPS_LADDER, 1000) if k <= 1000),
                       key=lambda k: (abs(k - n_steps), k))


@pytest.fixture(scope="module")
def few_step_server(tmp_path_factory):
    path = tmp_path_factory.mktemp("port_serve_fs") / "ckpt"
    cfg = pfactory.make_latent_diffusion_config(INFO, nf=16, n_layers=1, diffusion_steps=20)
    save_reference_checkpoint(pfactory.build_model(cfg, "cpu", torch.Generator().manual_seed(0)),
                              str(path))
    srv, service = serve.main(["--model_path", str(path), "--port", "0", "--batch_max", "8",
                               "--device", "cpu", "--n_steps", "7"], serve_forever=False)
    import threading

    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service
    srv.shutdown()
    srv.server_close()


@pytest.mark.parametrize("body,sampler", [
    ({}, {"n_steps": 7, "method": "ddim", "eta": 1.0, "protocol": "fewstep-7"}),
    ({"n_steps": 0}, {"n_steps": None, "protocol": "dense-T"}),
    ({"n_steps": 9, "eta": 0.0}, {"n_steps": 8, "eta": 0.0}),
    ({"n_steps": 7, "sampler": "dpm2m"}, {"n_steps": 7, "method": "dpm2m"}),
    ({"n_steps": 4, "clip_z": 1.1}, {"n_steps": 3, "clip_z": 1.0}),
    ({"n_steps": 20}, {"n_steps": 20, "compute_dtype": "bfloat16_mixed"}),
])
def test_few_step_requests_report_what_they_ran(few_step_server, body, sampler):
    base, _ = few_step_server
    code, out = _request(base, "/sample", {"sizes": [5, 12], "seed": 4, **body})
    assert code == 200, out
    assert {k: out["sampler"][k] for k in sampler} == sampler
    assert out["n"] == 2 and all(np.isfinite(a[1:]).all() for m in out["molecules"] for a in m)


@pytest.mark.parametrize("body,fragment", [
    ({"n_steps": 21}, "n_steps must be in [1, 20]"), ({"n_steps": "x"}, "must be an integer"),
    ({"eta": 1.5}, "eta must be in"), ({"sampler": "euler"}, "sampler must be"),
    ({"clip_z": -1}, "clip_z must be in"), ({"cfg_scale": 10.5}, "cfg_scale must be in"),
])
def test_few_step_requests_are_validated(few_step_server, body, fragment):
    base, _ = few_step_server
    code, out = _request(base, "/sample", {"sizes": [5], **body})
    assert code == 400 and fragment in out["error"]


def test_server_runs_the_sampler_it_reports(few_step_server, monkeypatch):
    _, service = few_step_server
    seen = []
    real = psampling.sample

    def spy(*a, **kw):
        seen.append({k: kw[k] for k in ("n_steps", "eta", "method", "clip_z", "compute_dtype")})
        return real(*a, **kw)

    monkeypatch.setattr(psampling, "sample", spy)
    service.sample({"sizes": [5], "seed": 1, "n_steps": 5, "sampler": "dpm2m", "clip_z": 2})
    assert seen == [{"n_steps": 5, "eta": 1.0, "method": "dpm2m", "clip_z": 2.0,
                     "compute_dtype": "bfloat16_mixed"}]


# --- the CLIs ---------------------------------------------------------------


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fs_ckpt") / "run")
    cfg = pfactory.make_latent_diffusion_config(INFO, nf=16, n_layers=1, diffusion_steps=12)
    save_reference_checkpoint(pfactory.build_model(cfg, "cpu", torch.Generator().manual_seed(1)),
                              os.path.join(path, "best"))
    return path


def test_eval_analyze_few_step_dpm2m(run_dir, tmp_path, monkeypatch):
    write_qm9_splits(str(tmp_path), INFO, {"train": 12, "valid": 4, "test": 4}, seed=2)
    seen = []
    real = ptrainer.analyze_and_save

    def spy(*a, **kw):
        seen.append({k: kw[k] for k in ("n_steps", "eta", "method", "compute_dtype")})
        return real(*a, **kw)

    monkeypatch.setattr(ptrainer, "analyze_and_save", spy)
    summary = eval_analyze.main(["--model_path", run_dir, "--datadir", str(tmp_path),
                                 "--n_samples", "6", "--n_steps", "4", "--sampler", "dpm2m",
                                 "--compute_dtype", "bfloat16_mixed", "--skip_nll",
                                 "--device", "cpu"])
    assert seen == [{"n_steps": 4, "eta": 1.0, "method": "dpm2m",
                     "compute_dtype": "bfloat16_mixed"}]
    assert summary["n_samples"] == 6 and np.isfinite(summary["molecules"]["x"]).all()


def test_eval_sample_writes_sets_and_chains(run_dir, tmp_path):
    out = str(tmp_path / "eval")
    summary = eval_sample.main(["--model_path", run_dir, "--outdir", out, "--n_samples", "4",
                                "--n_stable", "2", "--n_chains", "1", "--keep_frames", "6",
                                "--n_tries", "1", "--n_steps", "3", "--device", "cpu"])
    files = sorted(os.listdir(os.path.join(out, "molecules")))
    assert files == [f"molecule_{i:03d}.txt" for i in range(4)] + ["molecules.npz"]
    first = open(os.path.join(out, "molecules", "molecule_000.txt")).read().splitlines()
    assert len(first) == int(first[0]) + 2 and first[1] == ""
    chain = np.load(os.path.join(out, "chain_0", "chain.npz"))
    assert chain["x"].shape == (16, 19, 3) and summary["chains"] == [16]
    assert len([f for f in os.listdir(os.path.join(out, "chain_0")) if f.endswith(".txt")]) == 16
    assert 0 <= summary["stable"] <= 2
    # --render is ported (tests/test_torch_port_render.py); without imageio
    # it exits at argument checking, naming it.
    import sys

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "imageio", None)
        with pytest.raises(SystemExit, match="--render renders with matplotlib and imageio; "
                                             "this Python lacks imageio"):
            eval_sample.main(["--model_path", run_dir, "--render", "True", "--device", "cpu"])


def test_training_eval_n_steps_samples_few_step(tmp_path, monkeypatch):
    write_qm9_splits(str(tmp_path), INFO, {"train": 8, "valid": 4, "test": 4}, seed=1)
    seen = []
    real = psampling.sample_bucketed

    def spy(*a, **kw):
        seen.append(kw["n_steps"])
        return real(*a, **kw)

    monkeypatch.setattr(psampling, "sample_bucketed", spy)
    main_qm9.main(["--datadir", str(tmp_path), "--outdir", str(tmp_path / "out"),
                   "--train_diffusion", "--trainable_ae", "--nf", "16", "--n_layers", "1",
                   "--diffusion_steps", "8", "--batch_size", "8", "--n_epochs", "1",
                   "--test_epochs", "1", "--n_stability_samples", "3", "--eval_n_steps", "3",
                   "--device", "cpu"])
    assert seen == [3]
