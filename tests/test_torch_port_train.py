"""Port parity on CPU for the training slice: the VAE, VDM and latent-
diffusion losses, the optimizer stack, a 3-step train-step trajectory and
the eval NLL of a JAX-trained checkpoint, each against the JAX package on
numpy-seeded inputs. JAX's random draws are rebuilt from the same key
splits and handed to the port's noise sources (tests/torch_port_utils.py).
"""

import functools
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geoldm_tpu.config import TrainConfig
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.diffusion import latent as jldm
from geoldm_tpu.diffusion import vae as jvae
from geoldm_tpu.diffusion import vdm as jvdm
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.ops import pallas_egnn
from geoldm_tpu.ops.distance import build_edge_mask
from geoldm_tpu.train import optim as joptim
from geoldm_tpu.train import train_step as jts
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.diffusion import latent as pldm
from geoldm_tpu_torch.diffusion import vae as pvae
from geoldm_tpu_torch.diffusion import vdm as pvdm
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.train import optim as poptim
from geoldm_tpu_torch.train import train_step as pts
from geoldm_tpu_torch.utils.convert import state_dict_from_jax_params
from tests.torch_port_utils import (
    Feed,
    jax_combined_draws,
    jax_ldm_draws,
    jax_vdm_draws,
    masked_inputs,
    t,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
KW = dict(nf=32, n_layers=2, latent_nf=2, diffusion_steps=20, trainable_ae=True)
B, N, N_REAL = 3, 9, (4, 9, 7)
# Losses: f32 through two frameworks' op orders.
RTOL = 2e-5


def _ldm_pair(seed=0, **kw):
    kw = {**KW, **kw}
    jcfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **kw)
    pcfg = pfactory.make_latent_diffusion_config(get_dataset_info("qm9"), **kw)
    params = jfactory.init_params(jax.random.key(seed), jcfg)
    return jcfg, pcfg, params, _port_model(pcfg, params)


def _port_model(pcfg, params):
    model = pfactory.build_model(pcfg, "cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), pcfg),
                          strict=True)
    return model


def _molecules(seed, b=B, n=N, n_real=N_REAL):
    """x (CoM-free), one-hot types, charges, node mask as float32 numpy."""
    _, x, _, mask = masked_inputs(seed, b, n, 1, n_real)
    rng = np.random.default_rng(seed + 100)
    types = rng.integers(0, 5, (b, n))
    h_cat = np.eye(5, dtype=np.float32)[types] * mask
    h_int = np.array([1, 6, 7, 8, 9], dtype=np.float32)[types][..., None] * mask
    return x, h_cat, h_int, mask


def _jax_batch(x, h_cat, h_int, mask, log_pn):
    mj = jnp.asarray(mask)
    return {"x": jnp.asarray(x), "h_cat": jnp.asarray(h_cat), "h_int": jnp.asarray(h_int),
            "node_mask": mj, "edge_mask": build_edge_mask(mj), "log_pN": jnp.asarray(log_pn)}


def _port_batch(x, h_cat, h_int, mask, log_pn):
    return {"x": t(x), "h_cat": t(h_cat), "h_int": t(h_int), "node_mask": t(mask),
            "log_pN": t(log_pn)}


@pytest.mark.parametrize("training", [True, False])
def test_vae_loss_matches_jax(training):
    jcfg, _, params, model = _ldm_pair(1)
    x, h_cat, h_int, mask = _molecules(2)
    key = jax.random.key(3)
    mj = jnp.asarray(mask)
    want, info = jvae.compute_loss(params["vae"], jcfg.vae, key, jnp.asarray(x),
                                   jnp.asarray(h_cat), jnp.asarray(h_int), mj,
                                   build_edge_mask(mj), None, training)
    with torch.no_grad():
        got, (recon, kl) = pvae.compute_loss(
            model.vae, Feed(jax_combined_draws(key, B, N, 3, KW["latent_nf"])), t(x),
            t(h_cat), t(h_int), t(mask), None, training)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(recon.numpy(), np.asarray(info.loss_recon), rtol=RTOL)
    np.testing.assert_allclose(kl.numpy(), np.asarray(info.loss_kl), rtol=RTOL)


@pytest.mark.parametrize("training,t0_always", [(True, False), (False, True)])
def test_vdm_latent_loss_matches_jax(training, t0_always):
    jcfg, pcfg, params, model = _ldm_pair(4)
    _, z_x, _, mask = masked_inputs(5, B, N, 1, N_REAL)
    z_h = np.random.default_rng(6).standard_normal((B, N, 2)).astype(np.float32) * mask
    key = jax.random.key(7)
    mj = jnp.asarray(mask)
    want, info = jvdm.compute_loss(params, jcfg.diffusion, jcfg.dynamics, key, jnp.asarray(z_x),
                                   jnp.zeros((B, N, 0)), jnp.asarray(z_h), mj,
                                   build_edge_mask(mj), None, t0_always, training,
                                   latent_space=True)
    draws = jax_vdm_draws(key, B, N, 2, KW["diffusion_steps"], t0_always)
    with torch.no_grad():
        got, pinfo = pvdm.compute_loss(model.dynamics, pcfg.diffusion, Feed(draws), t(z_x),
                                       torch.zeros(B, N, 0), t(z_h), t(mask), None,
                                       t0_always, training)
    np.testing.assert_array_equal(pinfo.t_int.numpy(), np.asarray(info.t_int))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("training", [True, False])
def test_ldm_nll_matches_jax(training):
    jcfg, _, params, model = _ldm_pair(8)
    x, h_cat, h_int, mask = _molecules(9)
    key = jax.random.key(10)
    mj = jnp.asarray(mask)
    want = jldm.ldm_nll(params, jcfg.diffusion, jcfg.dynamics, jcfg.vae, key, jnp.asarray(x),
                        jnp.asarray(h_cat), jnp.asarray(h_int), mj, build_edge_mask(mj), None,
                        training, True)
    draws = jax_ldm_draws(key, B, N, 2, KW["diffusion_steps"], not training)
    with torch.no_grad():
        got = pldm.ldm_nll(model, Feed(draws), t(x), t(h_cat), t(h_int), t(mask), None, training)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


class _Tiny(torch.nn.Module):
    """Every parameter drawn from ``gen``: never from torch's global
    generator, whose state under ``-n 6 --dist loadfile`` depends on which
    files the worker ran first."""

    def __init__(self, gen: torch.Generator):
        super().__init__()
        self.a = torch.nn.Linear(4, 3)
        self.vae = torch.nn.Linear(3, 2)  # frozen when the VAE is not trainable
        with torch.no_grad():
            torch.nn.init.normal_(self.a.weight, generator=gen)
            for p in (self.a.bias, self.vae.weight, self.vae.bias):
                p.uniform_(-0.5, 0.5, generator=gen)


# AMSGrad's second bias correction at the counts of the test's 6 steps: JAX
# computes 1 - 0.999**c in float32 (geoldm_tpu/train/optim.py:113-114),
# torch.optim.AdamW in float64. Their worst relative difference (~2e-5)
# scales the step 1/sqrt(v / bc2) by up to that much (half of it, in fact).
_BC2_COUNTS = np.arange(1, 7)
BC2_REL = float(np.max(np.abs(
    (1 - np.float32(0.999) ** _BC2_COUNTS.astype(np.float32)).astype(np.float64)
    - (1 - 0.999 ** _BC2_COUNTS)) / (1 - 0.999 ** _BC2_COUNTS)))


def _optimizer_and_ema_against_jax(init_seed: int):
    """Clip + AMSGrad + weight decay + EMA over 6 steps of shared gradients,
    one a spike that trips the clip, with the 'vae' subtree frozen.

    Tolerance: each parameter (and its EMA) may differ from JAX's by
    lr * sum_k BC2_REL * max|u_k| over the steps so far, u_k JAX's step-k
    update in units of lr: the drift JAX's float32 bias correction causes
    (above), not the port's, which computes it as upstream PyTorch does.
    rtol 1e-5 covers the float32 rounding of the values themselves."""
    model = _Tiny(torch.Generator().manual_seed(init_seed))
    params = {k: jnp.asarray(v.detach().numpy()) for k, v in model.named_parameters()}
    mask = poptim.trainable_mask(model, "latent_diffusion", trainable_ae=False)
    assert mask == {"a.weight": True, "a.bias": True, "vae.weight": False, "vae.bias": False}
    lr, decay = 1e-2, 0.9
    tx = joptim.make_optimizer(lr=lr, weight_decay=1e-12, clip_grad=True, frozen_mask=mask)
    opt_state = tx.init(params)
    ema = dict(params)
    opt = poptim.make_optimizer(model, mask, lr=lr, weight_decay=1e-12)
    clip = poptim.AdaptiveGradClip("cpu")
    ema_model = _Tiny(torch.Generator().manual_seed(init_seed)).requires_grad_(False)
    ema_model.load_state_dict(model.state_dict())
    vae0 = model.vae.weight.detach().clone()
    rng = np.random.default_rng(1)
    atol = 0.0
    assert 1e-5 < BC2_REL < 2e-5
    for step in range(6):
        scale = 1e5 if step == 3 else 1.0
        grads = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        updates, opt_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                       opt_state, params)
        atol += lr * BC2_REL * max(float(np.abs(u).max()) / lr for u in updates.values())
        params = optax.apply_updates(params, updates)
        ema = joptim.ema_update(ema, params, decay)
        for name, p in model.named_parameters():
            p.grad = torch.tensor(grads[name]) if mask[name] else None
        norm = clip([p.grad for p in model.parameters() if p.grad is not None])
        want_norm = np.sqrt(sum(float(np.sum(g ** 2)) for k, g in grads.items() if mask[k]))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        opt.step()
        poptim.ema_update(ema_model, model, decay)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[name]),
                                       rtol=1e-5, atol=atol, err_msg=f"{name} step {step}")
        for name, p in ema_model.named_parameters():
            np.testing.assert_allclose(p.numpy(), np.asarray(ema[name]), rtol=1e-5, atol=atol)
    assert clip.count == 7 and float(clip.norms[4]) < 1e4  # the spike was recorded clipped
    assert torch.equal(model.vae.weight, vae0)


def test_optimizer_and_ema_match_jax():
    """The model's values come from its own generator, whatever torch's
    global generator holds (which files a worker ran first used to decide
    a.bias, and 6 of 60 global seeds moved it past an atol of 1e-7)."""
    _optimizer_and_ema_against_jax(0)


@pytest.mark.parametrize("init_seed", range(1, 21))
def test_optimizer_bound_holds_for_any_init(init_seed):
    """The derived bound holds over 20 seeds of the init generator, so it
    hides no seed."""
    _optimizer_and_ema_against_jax(init_seed)


@pytest.mark.parametrize("compute_dtype", [None, "pallas"])
def test_train_step_trajectory_matches_jax(compute_dtype, monkeypatch):
    """Three train steps on shared batches and noise. 'pallas' runs the JAX
    EGNN through the fused kernel pair in interpret mode."""
    if compute_dtype == "pallas":
        monkeypatch.setattr(pallas_egnn, "egnn_apply_pallas",
                            functools.partial(pallas_egnn.egnn_apply_pallas, interpret=True))
    jcfg, pcfg, _, _ = _ldm_pair()
    lr, ema_decay = 1e-3, 0.9
    tc = TrainConfig(lr=lr, ema_decay=ema_decay)
    jstate, tx = jts.create_train_state(jax.random.key(11), jcfg, tc)
    jstep = jax.jit(jts.make_train_step(jcfg, tc, tx, compute_dtype))
    model = _port_model(pcfg, jstate.params)
    state = pts.create_train_state(model, pcfg, lr, ema_decay=ema_decay)
    pstep = pts.make_train_step(pcfg, ema_decay)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    for step in range(3):
        x, h_cat, h_int, mask = _molecules(20 + step)
        log_pn = np.full(B, -2.0, dtype=np.float32)
        key = jax.random.fold_in(jax.random.key(12), step)
        jstate, jm = jstep(jstate, _jax_batch(x, h_cat, h_int, mask, log_pn), key)
        draws = jax_ldm_draws(key, B, N, 2, KW["diffusion_steps"], False)
        pm = pstep(state, _port_batch(x, h_cat, h_int, mask, log_pn), Feed(draws))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=RTOL)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params), pcfg)
    want_ema = state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.ema_params), pcfg)
    got, got_ema = model.state_dict(), state.ema_model.state_dict()
    # Three AMSGrad steps move a weight by up to 3 * lr; compare the moves.
    for name, w in want.items():
        np.testing.assert_allclose((got[name] - start[name]).numpy(),
                                   (w - start[name]).numpy(), atol=3e-2 * lr, err_msg=name)
        np.testing.assert_allclose((got_ema[name] - start[name]).numpy(),
                                   (want_ema[name] - start[name]).numpy(), atol=3e-2 * lr,
                                   err_msg=name)


def test_eval_nll_of_jax_trained_checkpoint_matches_jax():
    """The JAX-trained nf=64, 9-layer fixture (scripts/parity_train_ab_ldm.py
    config: T=500, trainable_ae) carried into the port through
    state_dict_from_jax_params; eval NLL on a shared 4-molecule batch."""
    with open(REPO / "ckpts_parity_r5" / "jax_s20_step300.pkl", "rb") as f:
        params = pickle.load(f)
    kw = dict(nf=64, n_layers=9, latent_nf=1, normalization_factor=1.0, diffusion_steps=500,
              trainable_ae=True)
    jcfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **kw)
    pcfg = pfactory.make_latent_diffusion_config(get_dataset_info("qm9"), **kw)
    model = _port_model(pcfg, params)
    b, n, n_real = 4, 12, (12, 9, 7, 11)
    x, h_cat, h_int, mask = _molecules(30, b, n, n_real)
    x = x * 1.5  # bond-length scale
    log_pn = np.full(b, -3.0, dtype=np.float32)
    key = jax.random.key(31)
    want = jax.jit(jts.make_eval_nll(jcfg))(params, _jax_batch(x, h_cat, h_int, mask, log_pn),
                                             key)
    got = pts.make_eval_nll(pcfg)(model, _port_batch(x, h_cat, h_int, mask, log_pn),
                                  Feed(jax_ldm_draws(key, b, n, 1, 500, True)))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
