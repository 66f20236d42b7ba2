"""The plain E(n) diffusion model (EDM, kind 'diffusion') against the JAX
package, on the CPU at small widths: normalisation, the t=0 term
``log_pxh_given_z0_without_constants`` (at extreme arguments too), the loss
in its single pass and t0_always, the NLL, the samplers with their one-hot
and charge decode and chain, and the train step, on both noise schedules.
Helpers and tolerances: tests/test_torch_port_variants.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu.config import TrainConfig
from geoldm_tpu.diffusion import vdm as jvdm
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.ops.distance import build_edge_mask
from geoldm_tpu.train import train_step as jts
from geoldm_tpu_torch.diffusion import schedules as psched
from geoldm_tpu_torch.diffusion import vdm as pvdm
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.train import train_step as pts
from geoldm_tpu_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_port_variants import (  # noqa: F401  (stable_jax_gamma: a fixture)
    B,
    CALL_RTOL,
    GRAD_RTOL,
    LDM_KW,
    LEARNED,
    LOSS_RTOL,
    N,
    N_REAL,
    SAMPLE_RTOL,
    T,
    _assert_grads,
    _close,
    _jax_nll,
    _jax_sample,
    _jgrads,
    _loss_and_grad,
    _molecules,
    _pair,
    _sample_draws,
    stable_jax_gamma,
)
from tests.torch_port_utils import (
    Feed,
    jax_combined_draws,
    jax_ldm_draws,
    jax_vdm_draws,
    masked_inputs,
    t,
)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The plain E(n) diffusion model (kind 'diffusion')
# ---------------------------------------------------------------------------


def test_normalize_and_unnormalize_match_jax():
    jcfg, pcfg, _, _ = _pair("edm", 0, normalize_factors=(1.5, 4.0, 10.0))
    x, h_cat, h_int, mask = _molecules(1)
    mj = jnp.asarray(mask)
    want = jvdm.normalize(jcfg.diffusion, jnp.asarray(x), jnp.asarray(h_cat),
                          jnp.asarray(h_int), mj)
    got = pvdm.normalize(pcfg.diffusion, t(x), t(h_cat), t(h_int), t(mask))
    for g, w, what in zip(got, want, ("x", "h_cat", "h_int", "delta_log_px")):
        _close(g, w, CALL_RTOL, what)
    back = pvdm.unnormalize(pcfg.diffusion, *got[:3], t(mask))
    jback = jvdm.unnormalize(jcfg.diffusion, *want[:3], mj)
    for g, w, orig in zip(back, jback, (x, h_cat, h_int)):
        _close(g, w, CALL_RTOL, "unnormalize")
        _close(g, orig, CALL_RTOL, "round trip")
    z = np.concatenate([x, h_cat, h_int], axis=2)
    _close(pvdm.unnormalize_z(pcfg.diffusion, t(z), t(mask)),
           jvdm.unnormalize_z(jcfg.diffusion, jnp.asarray(z), mj), CALL_RTOL, "unnormalize_z")


def _t0_inputs(seed, extreme=False):
    """Normalised (h_cat, h_int), z_0, gamma_0, eps, a prediction and the
    mask. Realistic: z_0 = alpha_0 xh + sigma_0 eps at the polynomial_2
    schedule's gamma(0), where each target's mass is ~1 and the others' are
    below the epsilon (the regime the t0_always pass evaluates). Extreme: z_0
    far from every target at a sharper gamma_0, where f32 erf rounds the CDF
    difference to 0 or below."""
    rng = np.random.default_rng(seed)
    x, h_cat, h_int, mask = _molecules(seed)
    xh = np.concatenate([x, h_cat / 4.0, h_int / 10.0], axis=2)
    eps = rng.standard_normal((B, N, 9)).astype(np.float32) * mask
    net = rng.standard_normal((B, N, 9)).astype(np.float32) * mask
    if extreme:
        z = rng.standard_normal((B, N, 9)).astype(np.float32) * mask
        z[:, :, 3:] += np.where(rng.random((B, N, 6)) < 0.5, -40.0, 40.0).astype(np.float32)
        gamma_0 = np.full((B, 1), -9.0, np.float32)
    else:
        g0 = float(psched.gamma_table("polynomial_2", T, 1e-5)[0])
        gamma_0 = np.full((B, 1), g0, np.float32)
        a0, s0 = np.sqrt(1 / (1 + np.exp(g0))), np.sqrt(1 / (1 + np.exp(-g0)))
        z = ((a0 * xh + s0 * eps) * mask).astype(np.float32)
    return h_cat / 4.0, h_int / 10.0, z, gamma_0, eps, net, mask


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_log_pxh_given_z0_matches_jax_and_stays_finite(extreme, training):
    """The t=0 term against JAX's, also at extreme arguments where f32 erf
    rounds the CDF difference to 0 or below: the clamp keeps the log finite,
    and its gradient with respect to z, eps, the prediction and gamma_0 is
    finite and JAX's."""
    jcfg, pcfg, _, _ = _pair("edm")
    h_cat, h_int, z, gamma_0, eps, net, mask = _t0_inputs(2, extreme)
    args = (h_cat, h_int, z, gamma_0, eps, net)

    def jfn(z_, g_, e_, n_):
        return jvdm.log_pxh_given_z0_without_constants(
            jcfg.diffusion, jnp.asarray(h_cat), jnp.asarray(h_int), z_, g_, e_, n_,
            jnp.asarray(mask), training)

    want = jfn(*(jnp.asarray(a) for a in (z, gamma_0, eps, net)))
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a)), argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(a) for a in (z, gamma_0, eps, net)))
    ins = [t(a).requires_grad_(True) for a in (z, gamma_0, eps, net)]
    got = pvdm.log_pxh_given_z0_without_constants(pcfg.diffusion, t(args[0]), t(args[1]),
                                                  ins[0], ins[1], ins[2], ins[3], t(mask),
                                                  training)
    assert bool(torch.isfinite(got).all())
    _close(got, want, CALL_RTOL, "log p(x, h | z0)")
    got.sum().backward()
    for i, what in zip(ins, ("z", "gamma_0", "eps", "net_out")):
        assert bool(torch.isfinite(i.grad).all()), what
        _close(i.grad, jg[("z", "gamma_0", "eps", "net_out").index(what)], GRAD_RTOL, what)


def test_single_pass_t0_select_keeps_the_gradient_finite(stable_jax_gamma):
    """The single pass computes the t=0 term for every t and masks it: at
    t > 0 with extreme states a NaN in the masked term would poison the
    gradient through the select. Every gradient stays finite and JAX's."""
    jcfg, pcfg, params, model = _pair("edm", 3, **LEARNED)
    x, h_cat, h_int, mask = _molecules(4)
    x = x * 50.0  # far from the data scale: extreme t=0 arguments at every t
    key = jax.random.key(5)
    mj = jnp.asarray(mask)
    nll = jfactory.model_nll_fn(jcfg, training=True)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(nll(p, key, jnp.asarray(x), jnp.asarray(h_cat),
                                                jnp.asarray(h_int), mj,
                                                build_edge_mask(mj)))))(params)
    got = pvdm.vdm_nll(model, Feed(jax_vdm_draws(key, B, N, 6, T, False)), t(x), t(h_cat),
                       t(h_int), t(mask), training=True)
    got.sum().backward()
    for name, p in model.named_parameters():
        if name != "gamma.l3.bias":  # cancels out of gamma: no gradient
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    _assert_grads(model, _jgrads(pcfg, jg), "single pass")


@pytest.mark.parametrize("schedule", ["polynomial_2", "learned"])
@pytest.mark.parametrize("training,t0_always", [(True, False), (False, True), (False, False)])
def test_plain_loss_matches_jax(schedule, training, t0_always, stable_jax_gamma):
    """compute_loss with latent_space=False: the single pass (its t=0 select)
    and the t0_always pass, l2 or (learned) vlb, with every gradient."""
    kw = LEARNED if schedule == "learned" else {}
    jcfg, pcfg, params, model = _pair("edm", 6, **kw)
    x, h_cat, h_int, mask = _molecules(7)
    mj = jnp.asarray(mask)
    xs = jvdm.normalize(jcfg.diffusion, jnp.asarray(x), jnp.asarray(h_cat), jnp.asarray(h_int),
                        mj)[:3]
    key = jax.random.key(8)

    def loss_fn(p):
        return jvdm.compute_loss(p, jcfg.diffusion, jcfg.dynamics, key, *xs, mj,
                                 build_edge_mask(mj), None, t0_always, training)[0]

    want, jg = _loss_and_grad(loss_fn, params)
    draws = jax_vdm_draws(key, B, N, 6, T, t0_always)
    got, _ = pvdm.compute_loss(model.dynamics, pcfg.diffusion, Feed(draws),
                               *(t(np.array(a)) for a in xs), t(mask), None, t0_always,
                               training, latent_space=False, gamma=model.gamma)
    _close(got, want, CALL_RTOL, "loss")
    got.sum().backward()
    _assert_grads(model, _jgrads(pcfg, jg), "loss")


def test_plain_loss_at_t_zero_matches_jax():
    """The single pass with t = 0 drawn for every molecule: the t=0 term is
    the estimator (JAX's randint stream fed with zeros)."""
    jcfg, pcfg, params, model = _pair("edm", 9)
    x, h_cat, h_int, mask = _molecules(10)
    mj = jnp.asarray(mask)
    xs = [np.array(a) for a in jvdm.normalize(jcfg.diffusion, jnp.asarray(x),
                                                jnp.asarray(h_cat), jnp.asarray(h_int), mj)[:3]]
    draws = [("i", np.zeros((B, 1), np.int32))] + jax_combined_draws(jax.random.key(11), B, N,
                                                                     3, 6)
    z = np.concatenate(xs, axis=2)
    with torch.no_grad():
        got, info = pvdm.compute_loss(model.dynamics, pcfg.diffusion, Feed(draws),
                                      *(t(a) for a in xs), t(mask), None, False, False,
                                      latent_space=False, gamma=model.gamma)
        gamma_0 = model.gamma(torch.zeros(B, 1))
        eps = torch.cat([t(np.array(draws[1][1])), t(np.array(draws[2][1]))], dim=2)
        eps = torch.cat([pvdm.com.remove_mean_with_mask(eps[..., :3] * t(mask), t(mask)),
                         eps[..., 3:] * t(mask)], dim=2)
        z_0 = pvdm.S.alpha(gamma_0, 3) * t(z) + pvdm.S.sigma(gamma_0, 3) * eps
        net = model.dynamics(torch.zeros(B, 1), z_0, t(mask))
        term = -pvdm.log_pxh_given_z0_without_constants(
            pcfg.diffusion, t(xs[1]), t(xs[2]), z_0, gamma_0, eps, net, t(mask), False)
        rest = (pvdm.kl_prior(pcfg.diffusion, model.gamma, t(z), t(mask))
                - pvdm.log_constants_p_x_given_z0(pcfg.diffusion, model.gamma, t(mask)))
    assert np.all(info.t_int.numpy() == 0)
    want = jvdm.log_pxh_given_z0_without_constants(
        jcfg.diffusion, jnp.asarray(xs[1]), jnp.asarray(xs[2]), jnp.asarray(z_0.numpy()),
        jnp.asarray(gamma_0.numpy()), jnp.asarray(eps.numpy()), jnp.asarray(net.numpy()), mj,
        False)
    _close(term, -np.asarray(want), CALL_RTOL, "t=0 term")
    _close(got, (rest + (T + 1) * term).numpy(), CALL_RTOL, "loss at t = 0")


@pytest.mark.parametrize("training", [True, False])
def test_vdm_nll_matches_jax(training):
    jcfg, pcfg, params, model = _pair("edm", 12, normalize_factors=(1.5, 4.0, 10.0))
    x, h_cat, h_int, mask = _molecules(13)
    key, mj = jax.random.key(14), jnp.asarray(mask)
    want = _jax_nll(params, jcfg, key, x, h_cat, h_int, mask, training)
    with torch.no_grad():
        got = pfactory.model_nll_fn(pcfg, training)(
            model, Feed(jax_vdm_draws(key, B, N, 6, T, not training)), t(x), t(h_cat),
            t(h_int), t(mask))
    _close(got, want, CALL_RTOL, "nll")


@pytest.mark.parametrize("schedule,kw", [
    ("polynomial_2", {}), ("polynomial_2", {"n_steps": 3, "eta": 0.0}),
])
def test_plain_sampler_matches_jax_with_exact_types_and_charges(schedule, kw, stable_jax_gamma):
    """vdm_sample for the plain kind: x within SAMPLE_RTOL, the final step's
    one-hot types and rounded charges exactly JAX's."""
    jcfg, pcfg, params, model = _pair("edm", 15, **(LEARNED if schedule == "learned" else {}))
    mask = masked_inputs(0, B, N, 1, N_REAL)[3]
    mj, key = jnp.asarray(mask), jax.random.key(16)
    want = _jax_sample(params, jcfg, key, mask, **kw)
    steps = 0 if kw.get("method") == "dpm2m" else kw.get("n_steps", T)
    got = pfactory.model_sample_fn(pcfg, **kw)(model, Feed(_sample_draws(key, steps, 6)),
                                               t(mask))
    _close(got[0], want[0], SAMPLE_RTOL, "x")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert np.all(got[2].numpy() == np.round(got[2].numpy()))
    assert np.all(got[1].numpy().sum(-1) == mask[..., 0])


@pytest.mark.parametrize("schedule,kw", [
    ("polynomial_2", {"n_steps": 4, "method": "dpm2m"}), ("learned", {}),
])
def test_plain_sampler_matches_jax_within_a_charge_rounding(schedule, kw, stable_jax_gamma):
    """DPM-Solver++(2M), and the dense sampler on the learned schedule, for
    the plain kind: x within SAMPLE_RTOL and the one-hot types exactly. The
    solver's extrapolation, and the learned schedule's gamma (~1e-6 of f32
    rounding in the port's form, more in JAX's), carry x's f32 noise (~1e-5
    relative) into charges of ~1e4 from the random denoiser, where a charge
    can round to the neighbouring integer: within that, plus one."""
    jcfg, pcfg, params, model = _pair("edm", 15, **(LEARNED if schedule == "learned" else {}))
    mask = masked_inputs(0, B, N, 1, N_REAL)[3]
    mj, key = jnp.asarray(mask), jax.random.key(16)
    want = _jax_sample(params, jcfg, key, mask, **kw)
    steps = 0 if kw.get("method") == "dpm2m" else T
    got = pfactory.model_sample_fn(pcfg, **kw)(model, Feed(_sample_draws(key, steps, 6)),
                                               t(mask))
    _close(got[0], want[0], SAMPLE_RTOL, "x")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    charges = np.asarray(want[2])
    err = float(np.abs(got[2].numpy() - charges).max())
    assert err <= SAMPLE_RTOL * max(1.0, float(np.abs(charges).max())) + 1.0, err
    assert np.all(got[2].numpy() == np.round(got[2].numpy()))


def test_plain_sampler_chain_matches_jax():
    """The dense sampler's chain of the plain kind: frames unnormalised,
    slot 0 the final (x, one-hot, charges)."""
    jcfg, pcfg, params, model = _pair("edm", 17)
    mask = masked_inputs(0, B, N, 1, N_REAL)[3]
    mj, key = jnp.asarray(mask), jax.random.key(18)
    (_, _, _), want = _jax_sample(params, jcfg, key, mask, keep_frames=4)
    with torch.no_grad():
        _, got = pvdm.vdm_sample(model.dynamics, pcfg.diffusion, Feed(_sample_draws(key, T, 6)),
                                 t(mask), keep_frames=4, latent_space=False, gamma=model.gamma)
    _close(got, want, SAMPLE_RTOL, "chain")


def _train_trajectory(kind, **kw):
    """Three train steps of the port and JAX from the same weights, batches
    and draws: the loss and gradient norm each step, and the weight and EMA
    moves after (as tests/test_torch_port_train.py's LDM trajectory)."""
    jcfg, pcfg, _, _ = _pair(kind, **kw)
    lr, ema_decay = 1e-3, 0.9
    tc = TrainConfig(lr=lr, ema_decay=ema_decay)
    jstate, tx = jts.create_train_state(jax.random.key(19), jcfg, tc)
    jstep = jax.jit(jts.make_train_step(jcfg, tc, tx))
    model = pfactory.build_model(pcfg, "cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params),
                                                     pcfg), strict=True)
    state = pts.create_train_state(model, pcfg, lr, ema_decay=ema_decay)
    pstep = pts.make_train_step(pcfg, ema_decay)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    feat = 6 if kind == "edm" else LDM_KW["latent_nf"]
    for step in range(3):
        x, h_cat, h_int, mask = _molecules(20 + step)
        log_pn = np.full(B, -2.0, dtype=np.float32)
        mj = jnp.asarray(mask)
        key = jax.random.fold_in(jax.random.key(21), step)
        jstate, jm = jstep(jstate, {"x": jnp.asarray(x), "h_cat": jnp.asarray(h_cat),
                                    "h_int": jnp.asarray(h_int), "node_mask": mj,
                                    "edge_mask": build_edge_mask(mj),
                                    "log_pN": jnp.asarray(log_pn)}, key)
        draws = (jax_vdm_draws(key, B, N, feat, T, False) if kind == "edm"
                 else jax_ldm_draws(key, B, N, feat, T, False))
        pm = pstep(state, {"x": t(x), "h_cat": t(h_cat), "h_int": t(h_int),
                           "node_mask": t(mask), "log_pN": t(log_pn)}, Feed(draws))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params), pcfg)
    want_ema = state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.ema_params), pcfg)
    got, got_ema = model.state_dict(), state.ema_model.state_dict()
    for name, w in want.items():
        keep = slice(None)
        if name == "dynamics.gnn.embedding_out.bias":
            # Its first 3 entries feed the velocity, whose CoM is removed: the
            # loss does not depend on them, their gradient is f32 noise, and
            # AMSGrad turns noise into lr-sized moves in either framework.
            keep = slice(3, None)
            assert float(np.abs(jgrad_vel_bias(state)).max()) < 1e-4
        np.testing.assert_allclose((got[name] - start[name]).numpy()[keep],
                                   (w - start[name]).numpy()[keep], atol=3e-2 * lr,
                                   err_msg=name)
        np.testing.assert_allclose((got_ema[name] - start[name]).numpy()[keep],
                                   (want_ema[name] - start[name]).numpy()[keep],
                                   atol=3e-2 * lr, err_msg=name)
    return model


def jgrad_vel_bias(state):
    """The port's last gradient of the GNN's velocity bias entries."""
    return state.model.dynamics.gnn.embedding_out.bias.grad[:3].numpy()


def test_plain_train_step_trajectory_matches_jax():
    """The plain kind's train step: the optimizer (everything trainable, as
    JAX's trainable_mask), the adaptive clip and the EMA included. (The
    learned schedule's steps are held by the gradient tests above and the
    SP/DP ones in tests/test_torch_port_variants_gnn.py: its gamma layers'
    gradients carry f32 noise, see ``_gamma_layer_ok``, which AMSGrad's
    normalised moves pass on.)"""
    model = _train_trajectory("edm")
    mask = pts.optim_mod.trainable_mask(model, model.cfg.kind, model.cfg.trainable_ae)
    assert all(mask.values())


