"""The learned noise schedule against the JAX package, on the CPU at small
widths: the learned gamma network (``diffusion/schedules.py``) and the
learned-schedule latent model's loss, gradients, samplers and bf16 step
(the plain E(n) diffusion model: tests/test_torch_port_variants_edm.py; the
GNN ablation, the legacy EGNN, the priors and the variants under SP and DP:
tests/test_torch_port_variants_gnn.py; both share this file's helpers and
tolerances). JAX's draws are rebuilt from its key splits and handed to the
port's noise sources (tests/torch_port_utils.py).

Tolerances (the existing port tests' for the same kind of output):
- one f32 call (the gamma network, a denoiser, an NLL, a loss) against JAX:
  CALL_RTOL 1e-5 * max(1, max|ref|) (tests/test_torch_port_conditional.py);
- gradients of a loss against ``jax.grad``: GRAD_RTOL 1e-4 * max(1,
  max|ref|) per tensor (the plain backward against JAX's vjp,
  tests/test_torch_port_block_grad.py), the gamma network's layers as
  ``_gamma_layer_ok`` says;
- a sampler run: SAMPLE_RTOL 1e-4 * max(1, max|ref|)
  (tests/test_torch_port_sampling.py); the final step's one-hot types and
  rounded charges exactly;
- a train step: the loss 2e-5 relative, the gradient norm 1e-4, three steps'
  weight and EMA moves within 3e-2 * lr (tests/test_torch_port_train.py);
- a bf16 step: tests/test_torch_port_bf16_train.py's STEP_RTOL with its flip
  allowance and SEPARATION.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu.config import TrainConfig
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.diffusion import schedules as jsched
from geoldm_tpu.diffusion import vdm as jvdm
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.ops.distance import build_edge_mask
from geoldm_tpu.train import train_step as jts
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.diffusion import schedules as psched
from geoldm_tpu_torch.diffusion import vdm as pvdm
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.train import train_step as pts
from geoldm_tpu_torch.utils.convert import state_dict_from_jax_params
from tests.torch_port_bf16_sites import JAX_STEP_FLIP_SHARE, SEPARATION, bf16_flips, \
    flips_allowed
from tests.torch_port_utils import (
    Feed,
    jax_combined_draws,
    jax_ldm_draws,
    jax_vdm_draws,
    masked_inputs,
    t,
)

torch.set_num_threads(1)

CALL_RTOL, GRAD_RTOL, SAMPLE_RTOL, LOSS_RTOL = 1e-5, 1e-4, 1e-4, 2e-5
STEP_RTOL = 2e-3  # tests/test_torch_port_bf16_train.py
T = 8
LEARNED = dict(noise_schedule="learned", loss_type="vlb")
LDM_KW = dict(nf=16, n_layers=2, latent_nf=2, diffusion_steps=T, trainable_ae=True)
EDM_KW = dict(nf=16, n_layers=2, diffusion_steps=T)
B, N, N_REAL = 3, 9, (4, 9, 7)
QM9 = get_dataset_info("qm9")


def _close(got, want, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size == 0:
        return
    assert np.all(np.isfinite(got)), f"{what}: not finite"
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max|d|={err:.3e} > {rtol}*{scale:.3g}"


def _pair(kind, seed=0, **kw):
    """(JAX config, port config, JAX params, port model with those weights)."""
    make_j = {"ldm": jfactory.make_latent_diffusion_config,
              "edm": jfactory.make_diffusion_model_config}[kind]
    make_p = {"ldm": pfactory.make_latent_diffusion_config,
              "edm": pfactory.make_diffusion_model_config}[kind]
    kw = {**(LDM_KW if kind == "ldm" else EDM_KW), **kw}
    jcfg, pcfg = make_j(jax_info("qm9"), **kw), make_p(QM9, **kw)
    params = jax.jit(jfactory.init_params, static_argnums=1)(jax.random.key(seed), jcfg)
    model = pfactory.build_model(pcfg, "cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), pcfg),
                          strict=True)
    return jcfg, pcfg, params, model


def _molecules(seed, b=B, n=N, n_real=N_REAL):
    """x (CoM-free), one-hot types, charges, node mask as float32 numpy."""
    _, x, _, mask = masked_inputs(seed, b, n, 1, n_real)
    types = np.random.default_rng(seed + 100).integers(0, 5, (b, n))
    h_cat = np.eye(5, dtype=np.float32)[types] * mask
    h_int = np.array([1, 6, 7, 8, 9], dtype=np.float32)[types][..., None] * mask
    return x * 1.5, h_cat, h_int, mask


def _loss_and_grad(loss_fn, params):
    """JAX's per-molecule loss and the gradient of its sum, compiled once
    (eager dispatch of the small models costs more than their compile)."""
    def total(p):
        loss = loss_fn(p)
        return jnp.sum(loss), loss

    (_, loss), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
    return loss, grads


def _jax_sample(params, jcfg, key, mask, **kw):
    """JAX's vdm_sample for the plain kind, compiled."""
    mj = jnp.asarray(mask)
    return jax.jit(lambda p, k: jvdm.vdm_sample(p, jcfg.diffusion, jcfg.dynamics, k, mj,
                                                 build_edge_mask(mj), **kw))(params, key)


def _jax_nll(params, jcfg, key, x, h_cat, h_int, mask, training):
    mj = jnp.asarray(mask)
    return jax.jit(lambda p: jvdm.vdm_nll(p, jcfg.diffusion, jcfg.dynamics, key,
                                          jnp.asarray(x), jnp.asarray(h_cat), jnp.asarray(h_int),
                                          mj, build_edge_mask(mj), None, training))(params)


def _jgrads(pcfg, grads):
    return {k: v.numpy() for k, v in
            state_dict_from_jax_params(jax.tree.map(np.asarray, grads), pcfg).items()}


def _assert_grads(model, want, what):
    """Every port gradient against JAX's by name; a parameter JAX's loss
    does not reach (the encoder's, the VAE's outside a latent loss) has no
    gradient in the port or a zero one in JAX."""
    got = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert got, what
    for name, w in want.items():
        if name in got and name.startswith("gamma.l"):
            _gamma_layer_ok(got[name], f"{what} {name}")
        elif name in got:
            _close(got[name], w, GRAD_RTOL, f"{what} {name}")
        elif name in dict(model.named_parameters()):
            assert not np.any(w), f"{what}: {name} has no gradient in the port"
    return got


# The gamma network's layer gradients in a loss are not compared element by
# element. Its normalisation makes gamma nearly invariant to them, so their
# gradient sums the loss's large vlb-weighted terms (dL/dgamma up to ~1e3 a
# molecule) against small, cancelling sensitivities: in f32 both frameworks
# land up to 55 % of the tensor's max from each other (l1.weight, in these
# tests on the CPU; PERF.md), and their f32 distances to the port's
# float64 run are of the same size. What they carry is held where it is
# well conditioned: gamma_0's and gamma_1's gradients, sum_i dL/dgamma_i (1 -
# u_i) and sum_i dL/dgamma_i u_i (u the normalised gamma), carry every vlb
# weight of the loss and are held to GRAD_RTOL; the layers' own chain rule is
# held at the network alone (test_gamma_network_gradient_matches_jax). The
# layers' gradients must be there and finite (at the full width they come
# out in steps of 2^-12 .. 2^-2 of rounding, l1.weight's exactly 0: smoke
# phase 32).


def _gamma_layer_ok(got, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.all(np.isfinite(got)), what


# ---------------------------------------------------------------------------
# The learned gamma network
# ---------------------------------------------------------------------------


def _stable_gamma_network_apply(params, t):
    """JAX's gamma_network_apply in the port's algebra
    (``GammaNetwork._tilde_minus_tilde0``): gamma_tilde(t) - gamma_tilde(0)
    as the sum of the layers' differences, l3's bias cancelled. The same
    function; JAX's own form subtracts two ~64-sized values whose difference
    is ~0.7 at the reference init, so its f32 result carries ~2e-4 of
    rounding (``test_gamma_network_matches_jax_on_a_grid_with_the_endpoints``
    holds the port to it within that, derived). The tests of what the
    network feeds (losses, gradients, samplers, steps) run JAX through this
    form (``stable_jax_gamma``), so they compare the wiring at f32's own
    tolerances."""
    t = t.astype(jnp.float32)
    pos = jsched._positive_linear
    l1_0 = pos(params["l1"], jnp.zeros((1, 1), jnp.float32))
    s_0 = jax.nn.sigmoid(pos(params["l2"], l1_0))

    def delta(a):
        l1_a = pos(params["l1"], a)
        return (l1_a - l1_0) + (jax.nn.sigmoid(pos(params["l2"], l1_a)) - s_0) @ \
            jax.nn.softplus(params["l3"]["w"])

    normalized = delta(t) / delta(jnp.ones((1, 1), jnp.float32))
    return params["gamma_0"] + (params["gamma_1"] - params["gamma_0"]) * normalized


@pytest.fixture
def stable_jax_gamma(monkeypatch):
    monkeypatch.setattr(jsched, "gamma_network_apply", _stable_gamma_network_apply)


def _gamma_rounding_bound(params):
    """The f32 rounding JAX's form of gamma(t) carries, from its
    conditioning (float64 arithmetic on its params): 16 ulps of the largest
    gamma_tilde on the grid, over gamma_tilde(1) - gamma_tilde(0), times
    gamma_1 - gamma_0."""
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    sp = lambda v: np.logaddexp(0.0, v)  # noqa: E731

    def tilde(v):
        l1 = v @ sp(p["l1"]["w"]) + p["l1"]["b"]
        return l1 + (1 / (1 + np.exp(-(l1 @ sp(p["l2"]["w"]) + p["l2"]["b"])))) @ \
            sp(p["l3"]["w"]) + p["l3"]["b"]

    g = tilde(T_GRID.astype(np.float64))
    g0, g1 = tilde(np.zeros((1, 1))), tilde(np.ones((1, 1)))
    span = float(abs(p["gamma_1"][0] - p["gamma_0"][0]))
    return 16 * 2.0 ** -24 * float(np.abs(g).max()) / abs((g1 - g0).item()) * span


def _gamma_pair(seed=3):
    """JAX's gamma network params (``gamma_network_init``) and the port's
    GammaNetwork carrying them through ``state_dict_from_jax_params``."""
    _, _, params, model = _pair("edm", seed, n_layers=1, **LEARNED)
    return params["gamma"], model.gamma


T_GRID = np.concatenate([[0.0, 1.0], np.linspace(0.0, 1.0, 11), [1e-3, 0.5, 0.999]]
                        ).astype(np.float32)[:, None]


def test_gamma_network_matches_jax_on_a_grid_with_the_endpoints():
    """Against JAX's gamma_network_apply within the rounding its own form
    carries (``_gamma_rounding_bound``, ~1e-3 here), and against the same
    function in the port's algebra at CALL_RTOL; gamma(0) and gamma(1) are
    gamma_0 and gamma_1 to within one ulp."""
    params, net = _gamma_pair()
    want = jsched.gamma_network_apply(params, jnp.asarray(T_GRID))
    with torch.no_grad():
        got = net(t(T_GRID))
        flat = net(t(T_GRID[:, 0]))  # [B] keeps its shape
        bf16 = net(t(T_GRID).bfloat16())  # cast to f32 first, as JAX casts it
    bound = _gamma_rounding_bound(params)
    assert 1e-5 < bound < 5e-3
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= bound
    stable = _stable_gamma_network_apply(params, jnp.asarray(T_GRID))
    _close(got, stable, CALL_RTOL, "gamma(t)")
    _close(flat, np.asarray(stable)[:, 0], CALL_RTOL, "gamma(t) over [B]")
    _close(bf16, _stable_gamma_network_apply(params, jnp.asarray(T_GRID, jnp.bfloat16)),
           CALL_RTOL, "gamma(bf16 t)")
    np.testing.assert_allclose(got.numpy()[:2, 0], [float(net.gamma_0.detach()),
                                                    float(net.gamma_1.detach())],
                               rtol=0, atol=1e-5)


def test_gamma_network_gradient_matches_jax():
    params, net = _gamma_pair(4)
    w = np.random.default_rng(5).standard_normal(T_GRID.shape).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(_stable_gamma_network_apply(p, jnp.asarray(T_GRID))
                                    * jnp.asarray(w)))(params)
    (net(t(T_GRID)) * t(w)).sum().backward()
    want = {"l1.weight": jg["l1"]["w"].T, "l1.bias": jg["l1"]["b"], "l2.weight": jg["l2"]["w"].T,
            "l2.bias": jg["l2"]["b"], "l3.weight": jg["l3"]["w"].T, "l3.bias": jg["l3"]["b"],
            "gamma_0": jg["gamma_0"], "gamma_1": jg["gamma_1"]}
    assert set(want) == {n for n, _ in net.named_parameters()}
    for name, p in net.named_parameters():
        if name == "l3.bias":  # cancels out of gamma: no gradient, and JAX's is 0
            assert p.grad is None and not np.any(want[name])
            continue
        _close(p.grad, want[name], GRAD_RTOL, name)


def test_gamma_network_is_monotone_with_its_endpoints():
    """As tests/test_schedules.py:87-97: gamma(0) = gamma_0, gamma(1) =
    gamma_1 and gamma increases on a fine grid, from the port's own init."""
    net = psched.GammaNetwork()
    pfactory.init_parameters(net, torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = net(torch.linspace(0, 1, 101)[:, None])[:, 0]
    assert abs(float(g[0]) - float(net.gamma_0.detach())) < 1e-5
    assert abs(float(g[-1]) - float(net.gamma_1.detach())) < 1e-4
    assert bool(torch.all(g[1:] > g[:-1]))
    assert float(net.l1.weight) < -1.0  # the -2 init offset (softplus keeps it positive)


def test_learned_schedule_requires_vlb_as_jax():
    for make in (pfactory.make_latent_diffusion_config, pfactory.make_diffusion_model_config):
        cfg = make(QM9, nf=8, n_layers=1, noise_schedule="learned", loss_type="l2")
        with pytest.raises(ValueError, match="learned schedule requires vlb loss"):
            pfactory.build_model(cfg, "cpu")
    with pytest.raises(AssertionError, match="learned schedule requires vlb loss"):
        jfactory.init_params(jax.random.key(0), jfactory.make_latent_diffusion_config(
            jax_info("qm9"), nf=8, n_layers=1, noise_schedule="learned", loss_type="l2"))
    # Predefined schedules keep JAX's sigma_0 check; the learned one skips it.
    with pytest.raises(ValueError, match="probably too large"):
        pfactory.build_model(pfactory.make_diffusion_model_config(
            QM9, nf=8, n_layers=1, noise_precision=0.1), "cpu")
    pfactory.build_model(pfactory.make_diffusion_model_config(
        QM9, nf=8, n_layers=1, noise_precision=0.1, **LEARNED), "cpu")


# ---------------------------------------------------------------------------
# The learned-schedule latent model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("training,t0_always", [(True, False), (False, True)])
def test_learned_latent_loss_and_gradients_match_jax(training, t0_always, stable_jax_gamma):
    """vdm.compute_loss with vlb in latent space: the loss and the gradient
    of its sum over the batch with respect to every parameter it reaches,
    the gamma network's included (through the vlb weight, the constants and
    the KL prior)."""
    jcfg, pcfg, params, model = _pair("ldm", 6, **LEARNED)
    _, z_x, _, mask = masked_inputs(7, B, N, 1, N_REAL)
    z_h = np.random.default_rng(8).standard_normal((B, N, 2)).astype(np.float32) * mask
    key = jax.random.key(9)
    mj = jnp.asarray(mask)

    def loss_fn(p):
        return jvdm.compute_loss(p, jcfg.diffusion, jcfg.dynamics, key, jnp.asarray(z_x),
                                 jnp.zeros((B, N, 0)), jnp.asarray(z_h), mj, build_edge_mask(mj),
                                 None, t0_always, training, latent_space=True)[0]

    want, jg = _loss_and_grad(loss_fn, params)
    got, _ = pvdm.compute_loss(model.dynamics, pcfg.diffusion,
                               Feed(jax_vdm_draws(key, B, N, 2, T, t0_always)), t(z_x),
                               torch.zeros(B, N, 0), t(z_h), t(mask), None, t0_always, training,
                               gamma=model.gamma)
    _close(got, want, CALL_RTOL, "loss")
    got.sum().backward()
    grads = _assert_grads(model, _jgrads(pcfg, jg), "loss")
    assert {f"gamma.{k}" for k in ("l1.weight", "l3.weight", "gamma_0", "gamma_1")} <= set(grads)


@pytest.mark.parametrize("n_steps", [None, 3])
def test_learned_latent_sampler_chunk_matches_jax(n_steps, stable_jax_gamma):
    """A dense chunk and a K-step DDIM chunk (eta 0) of the latent sampler
    on the learned schedule, with the VAE's decode."""
    jcfg, _, params, model = _pair("ldm", 10, **LEARNED)
    mask = masked_inputs(0, B, N, 1, N_REAL)[3]
    mj, key = jnp.asarray(mask), jax.random.key(11)
    kw = {} if n_steps is None else {"n_steps": n_steps, "eta": 0.0}
    from geoldm_tpu.diffusion import latent as jlatent
    want = jax.jit(lambda p, k: jlatent.ldm_sample(p, jcfg.diffusion, jcfg.dynamics, jcfg.vae,
                                                   k, mj, build_edge_mask(mj), **kw))(params, key)
    k_diff, _ = jax.random.split(key)
    got = pfactory.model_sample_fn(model.cfg, **kw)(
        model, Feed(_sample_draws(k_diff, n_steps or T, 2)), t(mask))
    for g, w, what in zip(got, want, ("x", "h_cat", "h_int")):
        _close(g, w, SAMPLE_RTOL, what)


def _sample_draws(key, k_steps, feat):
    """JAX vdm_sample's draws from ``key``: z_T, each step's, the final
    step's (vdm.py:641, :740, :776)."""
    k_init, k_scan, k_final = jax.random.split(key, 3)
    draws = jax_combined_draws(k_init, B, N, 3, feat)
    for k in jax.random.split(k_scan, k_steps):
        draws += jax_combined_draws(k, B, N, 3, feat)
    return draws + jax_combined_draws(k_final, B, N, 3, feat)


def test_learned_bf16_train_step_matches_jax(stable_jax_gamma):
    """One learned-schedule step in ``bfloat16`` against JAX's: the EGNNs
    round their products' operands to bf16, the gamma network stays f32 in
    both. Held as tests/test_torch_port_bf16_train.py holds the recipe step;
    the gamma network's gradients, all f32, to GRAD_RTOL against JAX's."""
    kw = {**LDM_KW, **LEARNED}
    jcfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **kw)
    pcfg = pfactory.make_latent_diffusion_config(QM9, **kw)
    tc = TrainConfig(lr=1e-3, ema_decay=0.9)
    jstate, tx = jts.create_train_state(jax.random.key(12), jcfg, tc)
    x, h_cat, h_int, mask = _molecules(13)
    log_pn = np.full(B, -2.0, np.float32)
    mj = jnp.asarray(mask)
    key = jax.random.key(14)
    nll = jfactory.model_nll_fn(jcfg, training=True, compute_dtype="bfloat16")
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jnp.mean(nll(
        p, key, jnp.asarray(x), jnp.asarray(h_cat), jnp.asarray(h_int), mj,
        build_edge_mask(mj), None) - jnp.asarray(log_pn))))(jstate.params)
    want = _jgrads(pcfg, jgrads)
    steps = {}
    for dtype in ("bfloat16", "float32"):
        model = pfactory.build_model(pcfg, "cpu")
        model.load_state_dict(state_dict_from_jax_params(
            jax.tree.map(np.asarray, jstate.params), pcfg), strict=True)
        state = pts.create_train_state(model, pcfg, tc.lr, ema_decay=tc.ema_decay,
                                       clip_grad=False)
        pm = pts.make_train_step(pcfg, tc.ema_decay, dtype)(
            state, {"x": t(x), "h_cat": t(h_cat), "h_int": t(h_int), "node_mask": t(mask),
                    "log_pN": t(log_pn)}, Feed(jax_ldm_draws(key, B, N, 2, T, False)))
        steps[dtype] = pm, {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    pm, grads = steps["bfloat16"]
    np.testing.assert_allclose(float(pm["loss"]), float(jloss), rtol=1e-5)
    err = dist = 0.0
    for name, g in grads.items():
        w = torch.from_numpy(want[name]).reshape(g.shape)
        scale = float(w.abs().max())
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), name
        if name.startswith("gamma.l"):  # f32 noise, not bf16's (_gamma_layer_ok)
            _gamma_layer_ok(g, name)
            continue
        diff = (g - w).abs()
        if name.endswith("weight"):
            flips = bf16_flips(g, w)
            assert int(flips.sum()) <= flips_allowed(g.numel(), JAX_STEP_FLIP_SHARE), name
            diff = diff.masked_fill(flips, 0.0)
        assert float(diff.max()) <= STEP_RTOL * scale, (name, float(diff.max()), scale)
        err += float((g - w).abs().mean()) / scale
        dist += float((g - steps["float32"][1][name]).abs().mean()) / scale
    assert SEPARATION * err <= dist, (err, dist)
    assert any(n.startswith("gamma.") for n in grads)
