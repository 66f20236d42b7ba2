"""Conditional QM9 generation in the port on the CPU, against the JAX
package on numpy-seeded inputs: the conditioning helpers, the property
distribution, the conditional latent-diffusion NLL, classifier-free
guidance (``guided_eps``, the guided samplers, ``sampling.sample`` with a
property distribution, the property sweep), the train step's context
dropout, the property classifier and its training steps. JAX weights carry
across through ``utils.convert``; JAX's draws are replayed from its key
splits (tests/torch_port_utils.py).

Tolerances: host-side numpy helpers exactly (the same numpy calls); one f32
NLL or denoiser call 1e-5 * max(1, max|ref|) (two frameworks' op orders); a
sampler run of at most T = 10 steps 1e-4 * max(1, max|ref|), as the
unconditional sampling tests (tests/test_torch_port_sampling.py); train
steps as tests/test_torch_port_train.py (loss 2e-5 relative, gradient norm
1e-4, weight moves 3e-2 * lr); the classifier's forward 1e-5 * max(1,
max|ref|), its weights after 3 Adam steps 1e-4 * max(1, max|ref|)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geoldm_tpu.config import TrainConfig
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.data.qm9 import load_qm9 as jload_qm9
from geoldm_tpu.diffusion import latent as jldm
from geoldm_tpu.diffusion import vdm as jvdm
from geoldm_tpu.models import classifier as jclf
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.models.distributions import DistributionProperty as JDistributionProperty
from geoldm_tpu.ops.distance import build_edge_mask
from geoldm_tpu.train import classifier_train as jct
from geoldm_tpu.train import conditioning as jcond
from geoldm_tpu.train import sampling as jsampling
from geoldm_tpu.train import train_step as jts
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.qm9 import load_qm9
from geoldm_tpu_torch.data.synthetic import write_qm9_splits
from geoldm_tpu_torch.diffusion import latent as pldm
from geoldm_tpu_torch.diffusion import vdm as pvdm
from geoldm_tpu_torch.models import classifier as pclf
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.models.distributions import DistributionProperty
from geoldm_tpu_torch.train import classifier_train as pct
from geoldm_tpu_torch.train import conditioning as pcond
from geoldm_tpu_torch.train import sampling as psampling
from geoldm_tpu_torch.train import train_step as pts
from geoldm_tpu_torch.utils.convert import (
    classifier_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from tests.torch_port_utils import Feed, jax_combined_draws, jax_ldm_draws, masked_inputs, t

torch.set_num_threads(1)

T = 10
KW = dict(nf=32, n_layers=2, latent_nf=1, diffusion_steps=T, trainable_ae=True,
          context_node_nf=1, context_indicator=True)
INFO = get_dataset_info("qm9")
B, N, N_REAL = 3, 9, (5, 9, 7)
CALL_RTOL = 1e-5
SAMPLE_RTOL = 1e-4
LOSS_RTOL = 2e-5
CLF_RTOL, CLF_STEP_RTOL = 1e-5, 1e-4


def _close(got, want, rtol, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size == 0:
        return
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max|d|={err:.3e} > {rtol}*{scale:.3g}"


@pytest.fixture(scope="module")
def splits_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cond_splits"))
    write_qm9_splits(path, INFO, {"train": 60, "valid": 16, "test": 8}, seed=3)
    return path


@pytest.fixture(scope="module")
def models():
    """JAX params of a conditional LDM with the indicator channel and the
    port model carrying them."""
    jcfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **KW)
    pcfg = pfactory.make_latent_diffusion_config(INFO, **KW)
    params = jfactory.init_params(jax.random.key(0), jcfg)
    model = pfactory.build_model(pcfg, "cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), pcfg),
                          strict=True)
    return model, jcfg, params


def _molecules(seed, b=B, n=N, n_real=N_REAL):
    _, x, _, mask = masked_inputs(seed, b, n, 1, n_real)
    types = np.random.default_rng(seed + 100).integers(0, 5, (b, n))
    h_cat = np.eye(5, dtype=np.float32)[types] * mask
    h_int = np.array([1, 6, 7, 8, 9], dtype=np.float32)[types][..., None] * mask
    return x, h_cat, h_int, mask


def _context(seed, mask, indicator=True):
    rng = np.random.default_rng(seed)
    batch = {"node_mask": mask, "alpha": (rng.standard_normal(len(mask)) * 8 + 75)}
    return pcond.prepare_context(["alpha"], batch, {"alpha": {"mean": 75.0, "mad": 6.0}},
                                 indicator=indicator)


# --- host-side helpers, exactly ---

@pytest.mark.parametrize("dataset", ["qm9", "qm9_first_half", "qm9_second_half"])
def test_compute_mean_mad_matches_jax(splits_dir, dataset):
    jsplits, _ = jload_qm9(splits_dir, dataset=dataset)
    psplits, _ = load_qm9(splits_dir, dataset=dataset)
    props = ["alpha", "mu", "U0"]
    want = jcond.compute_mean_mad(jsplits, props, dataset)
    assert pcond.compute_mean_mad(psplits, props, dataset) == want
    assert pcond.compute_mean_mad_from_arrays(psplits["test"], props) == \
        jcond.compute_mean_mad_from_arrays(jsplits["test"], props)
    split = "train" if dataset == "qm9" else "valid"
    assert want == pcond.compute_mean_mad_from_arrays(psplits[split], props)


def test_load_conditional_protocol_matches_jax(splits_dir):
    _, jn, jdist, jnodes, jpad = jcond.load_conditional_protocol(splits_dir, ["alpha", "mu"])
    _, pn, pdist, pnodes, ppad = pcond.load_conditional_protocol(splits_dir, ["alpha", "mu"])
    assert pn == jn and ppad == jpad
    np.testing.assert_array_equal(pnodes.n_nodes, jnodes.n_nodes)
    np.testing.assert_array_equal(pnodes.probs, jnodes.probs)
    sizes = pnodes.sample(12, np.random.default_rng(4))
    np.testing.assert_array_equal(sizes, jnodes.sample(12, np.random.default_rng(4)))
    np.testing.assert_array_equal(pdist.sample_batch(sizes, np.random.default_rng(5)),
                                  jdist.sample_batch(sizes, np.random.default_rng(5)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distribution_property_sample_batch_matches_jax(seed):
    """The same normalized rows bit for bit from the same seed, sizes
    missing from the histogram (nearest-size fallback) included."""
    rng = np.random.default_rng(seed)
    num_atoms = rng.integers(5, 20, size=200)
    props = {"alpha": rng.standard_normal(200) * 8 + 75, "gap": rng.standard_normal(200)}
    norms = jcond.compute_mean_mad_from_arrays(props, list(props))
    want = JDistributionProperty(num_atoms, props, num_bins=50)
    got = DistributionProperty(num_atoms, props, num_bins=50)
    want.set_normalizer(norms)
    got.set_normalizer(norms)
    sizes = np.concatenate([rng.integers(5, 20, size=10), [1, 3, 25]])
    rows = got.sample_batch(sizes, np.random.default_rng(seed + 10))
    np.testing.assert_array_equal(rows, want.sample_batch(sizes, np.random.default_rng(seed + 10)))
    assert rows.shape == (len(sizes), 2) and rows.dtype == np.float32


@pytest.mark.parametrize("indicator", [False, True])
def test_prepare_context_matches_jax(indicator):
    rng = np.random.default_rng(6)
    mask = masked_inputs(6, B, N, 1, N_REAL)[3]
    batch = {"node_mask": mask, "alpha": rng.standard_normal(B) * 8 + 75,
             "charge_map": rng.standard_normal((B, N)), "vec": rng.standard_normal((B, N, 2))}
    norms = {"alpha": {"mean": 75.0, "mad": 6.5}, "charge_map": {"mean": 0.1, "mad": 0.9},
             "vec": {"mean": -0.2, "mad": 1.3}}
    keys = ["alpha", "charge_map", "vec"]
    got = pcond.prepare_context(keys, batch, norms, indicator=indicator)
    np.testing.assert_array_equal(got, jcond.prepare_context(keys, batch, norms,
                                                             indicator=indicator))
    assert got.shape == (B, N, 4 + int(indicator))
    assert np.all(got[mask[..., 0] == 0] == 0)


def test_preprocess_input_matches_jax():
    rng = np.random.default_rng(7)
    one_hot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (B, N))]
    charges = rng.integers(0, 10, (B, N)).astype(np.float32)
    np.testing.assert_array_equal(pcond.preprocess_input(one_hot, charges, 2, 9.0),
                                  jcond.preprocess_input(one_hot, charges, 2, 9.0))


def test_property_channels_and_indicator():
    assert pcond.property_channels(pfactory.make_latent_diffusion_config(INFO, **KW)) == 1
    cfg = pfactory.make_latent_diffusion_config(INFO, **{**KW, "context_indicator": False})
    assert pcond.property_channels(cfg) == 1 and cfg.dynamics.context_node_nf == 1
    ctx = np.zeros((2, 4, 1), np.float32)
    pcfg = pfactory.make_latent_diffusion_config(INFO, **KW)
    got = psampling.append_indicator_if_needed(pcfg, ctx)
    np.testing.assert_array_equal(got, jsampling.append_indicator_if_needed(
        jfactory.make_latent_diffusion_config(jax_info("qm9"), **KW), ctx))
    assert got.shape == (2, 4, 2) and np.all(got[..., 1] == 1)
    assert psampling.append_indicator_if_needed(pcfg, got) is got


# --- the conditional model ---

@pytest.mark.parametrize("training", [True, False])
def test_conditional_ldm_nll_matches_jax(models, training):
    model, jcfg, params = models
    x, h_cat, h_int, mask = _molecules(9)
    ctx = _context(8, mask)
    key = jax.random.key(10)
    mj = jnp.asarray(mask)
    want = jldm.ldm_nll(params, jcfg.diffusion, jcfg.dynamics, jcfg.vae, key, jnp.asarray(x),
                        jnp.asarray(h_cat), jnp.asarray(h_int), mj, build_edge_mask(mj),
                        jnp.asarray(ctx), training, True)
    draws = jax_ldm_draws(key, B, N, 1, T, not training)
    with torch.no_grad():
        got = pldm.ldm_nll(model, Feed(draws), t(x), t(h_cat), t(h_int), t(mask), t(ctx),
                           training)
    _close(got, want, CALL_RTOL, "nll")
    with torch.no_grad():  # the context is live: another value, another NLL
        other = pldm.ldm_nll(model, Feed(draws), t(x), t(h_cat), t(h_int), t(mask),
                             t(ctx) * 0, training)
    assert not torch.allclose(other, got)


@pytest.mark.parametrize("w,calls", [(0.0, 1), (1.0, 1), (2.0, 2), (None, 1)])
def test_guided_eps_matches_jax_with_its_call_count(models, w, calls):
    """w=0: one call on the null context; w=1: one call; other w: two;
    no context (None here, an unconditional model): one call whatever w."""
    model, jcfg, params = models
    if w is None:
        kw = {**KW, "context_node_nf": 0, "context_indicator": False}
        jcfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **kw)
        params = jfactory.init_params(jax.random.key(1), jcfg)
        pcfg = pfactory.make_latent_diffusion_config(INFO, **kw)
        model = pfactory.build_model(pcfg, "cpu")
        model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                                         pcfg), strict=True)
    _, z, _, mask = masked_inputs(11, B, N, 1, N_REAL)
    z = np.concatenate([z, np.random.default_rng(12).standard_normal((B, N, 1)).astype(
        np.float32) * mask], axis=2)
    ctx = None if w is None else _context(13, mask)
    w_ = 2.0 if w is None else w
    tt = np.array([[0.3], [0.7], [0.5]], np.float32)
    mj = jnp.asarray(mask)
    want = jvdm.guided_eps(params, jcfg.dynamics, jnp.asarray(tt), jnp.asarray(z), mj,
                           build_edge_mask(mj), None if ctx is None else jnp.asarray(ctx), None,
                           w_)
    log = []

    def dyn(*a):
        log.append(a[3])
        return model.dynamics(*a)

    with torch.no_grad():
        got = pvdm.guided_eps(dyn, t(tt), t(z), t(mask), None if ctx is None else t(ctx),
                              None, w_)
    _close(got, want, CALL_RTOL, "eps")
    assert len(log) == calls
    if w == 0.0:
        assert float(log[0].abs().max()) == 0.0  # the null context
    if w == 2.0:
        assert torch.equal(log[0], t(ctx)) and float(log[1].abs().max()) == 0.0


def _sample_draws(key, b, n, k_steps, fix_noise=False):
    """JAX vdm_sample's draws from ``key`` (z_T, each step's, the final
    step's); [1, N, D] ones with fix_noise."""
    k_init, k_scan, k_final = jax.random.split(key, 3)
    bb = 1 if fix_noise else b
    keys = [k_init] + (list(jax.random.split(k_scan, k_steps)) if k_steps else []) + [k_final]
    return [d for k in keys for d in jax_combined_draws(k, bb, n, 3, 1)]


@pytest.mark.parametrize("kw,k_steps", [
    ({}, T), ({"n_steps": 4, "eta": 0.0, "clip_z": 1.0}, 4),
    ({"n_steps": 3, "method": "dpm2m", "clip_z": 1.0}, 0)])
def test_guided_samplers_match_jax(models, kw, k_steps):
    model, jcfg, params = models
    mask = masked_inputs(0, B, N, 1, N_REAL)[3]
    ctx = _context(14, mask)
    key = jax.random.key(15)
    mj = jnp.asarray(mask)
    want = jvdm.vdm_sample(params, jcfg.diffusion, jcfg.dynamics, key, mj, build_edge_mask(mj),
                           jnp.asarray(ctx), latent_space=True, guidance_scale=2.0, **kw)
    with torch.no_grad():
        got = pvdm.vdm_sample(model.dynamics, model.cfg.diffusion,
                              Feed(_sample_draws(key, B, N, k_steps)), t(mask), context=t(ctx),
                              guidance_scale=2.0, **kw)
    for g, w_, what in zip(got, want, ("x", "h_cat", "h_int")):
        _close(g, w_, SAMPLE_RTOL, what)


def test_conditional_latent_chain_matches_jax(models):
    """The dense sampler's chain with the context at every denoiser call and
    every frame decoded on it (``ldm_sample_chain``)."""
    model, jcfg, params = models
    mask = masked_inputs(0, B, N, 1, N_REAL)[3]
    ctx = _context(18, mask)
    key = jax.random.key(19)
    mj = jnp.asarray(mask)
    want = jldm.ldm_sample_chain(params, jcfg.diffusion, jcfg.dynamics, jcfg.vae, key, mj,
                                 build_edge_mask(mj), jnp.asarray(ctx), keep_frames=4)
    with torch.no_grad():
        got = pldm.ldm_sample_chain(model, Feed(_sample_draws(key, B, N, T)), t(mask),
                                    keep_frames=4, context=t(ctx))
    _close(got, want, SAMPLE_RTOL, "chain")


def _assert_molecules(got, want, mask):
    one_hot, charges, x, node_mask = got
    jo, jc, jx, jm = want
    np.testing.assert_array_equal(node_mask, np.asarray(jm))
    _close(x, jx, SAMPLE_RTOL, "x")
    real = mask[:, :, 0] > 0
    np.testing.assert_array_equal(one_hot.numpy().argmax(-1)[real],
                                  np.asarray(jo).argmax(-1)[real])
    np.testing.assert_array_equal(charges.numpy(), np.asarray(jc))


def test_sample_with_property_distribution_matches_jax(models, splits_dir):
    """``sampling.sample`` drawing its rows from a DistributionProperty,
    broadcasting them, appending the indicator, guided (w=2) DPM-Solver++
    with the decode on the context."""
    model, jcfg, params = models
    _, _, jdist, _, _ = jcond.load_conditional_protocol(splits_dir, ["alpha"])
    _, _, pdist, _, _ = pcond.load_conditional_protocol(splits_dir, ["alpha"])
    sizes = np.array([5, 9, 7])
    key = jax.random.key(16)
    want = jsampling.sample(jcfg, params, key, jax_info("qm9"), sizes, prop_dist=jdist,
                            pad_nodes=N, rng=np.random.default_rng(0), n_steps=3,
                            method="dpm2m", guidance_scale=2.0)
    k_diff, _ = jax.random.split(key)
    with torch.no_grad():
        got = psampling.sample(model, Feed(_sample_draws(k_diff, B, N, 0)), INFO, sizes,
                               pad_nodes=N, prop_dist=pdist, rng=np.random.default_rng(0),
                               n_steps=3, method="dpm2m", guidance_scale=2.0)
    _assert_molecules(got, want, masked_inputs(0, B, N, 1, N_REAL)[3])


def test_sample_sweep_conditional_matches_jax(models, splits_dir, monkeypatch):
    """Each property swept over its range at one size, with fixed noise."""
    model, jcfg, params = models
    _, _, jdist, _, _ = jcond.load_conditional_protocol(splits_dir, ["alpha"])
    _, _, pdist, _, _ = pcond.load_conditional_protocol(splits_dir, ["alpha"])
    # The size with the widest range of alpha values.
    n_nodes = max(pdist.distributions["alpha"],
                  key=lambda n: np.subtract(*pdist.distributions["alpha"][n]["params"][::-1]))
    key = jax.random.key(17)
    want = jsampling.sample_sweep_conditional(jcfg, params, key, jax_info("qm9"), jdist,
                                              n_nodes=n_nodes, n_frames=4)
    k_diff, _ = jax.random.split(key)
    pad = INFO["max_n_nodes"]
    draws = _sample_draws(k_diff, 4, pad, T, fix_noise=True)
    monkeypatch.setattr(psampling, "chunk_generator", lambda seed, i, device: Feed(draws))
    with torch.no_grad():
        got = psampling.sample_sweep_conditional(model, 0, INFO, pdist, n_nodes=n_nodes,
                                                 n_frames=4)
    mask = np.asarray(want[3])
    _assert_molecules(got, want, mask)
    assert len({m.tobytes() for m in got[2].numpy()}) == 4  # the sweep moves the molecule


# --- the train step's context dropout ---

def test_train_step_with_keep_mask_matches_jax(models):
    """Two steps with context_dropout 0.5: JAX draws its keep mask from a
    split of the step's key; the port takes that mask explicitly and the
    loss's draws from the rest of the key."""
    _, jcfg, _ = models
    pcfg = pfactory.make_latent_diffusion_config(INFO, **KW)
    lr, ema_decay, p = 1e-3, 0.9, 0.5
    tc = TrainConfig(lr=lr, ema_decay=ema_decay, context_dropout=p)
    jstate, tx = jts.create_train_state(jax.random.key(21), jcfg, tc)
    jstep = jax.jit(jts.make_train_step(jcfg, tc, tx))
    model = pfactory.build_model(pcfg, "cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params),
                                                     pcfg), strict=True)
    state = pts.create_train_state(model, pcfg, lr, ema_decay=ema_decay)
    pstep = pts.make_train_step(pcfg, ema_decay, context_dropout=p)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    kept = []
    for step in range(2):
        x, h_cat, h_int, mask = _molecules(30 + step)
        ctx = _context(40 + step, mask)
        log_pn = np.full(B, -2.0, dtype=np.float32)
        key = jax.random.fold_in(jax.random.key(22), step)
        mj = jnp.asarray(mask)
        jbatch = {"x": jnp.asarray(x), "h_cat": jnp.asarray(h_cat), "h_int": jnp.asarray(h_int),
                  "node_mask": mj, "edge_mask": build_edge_mask(mj),
                  "log_pN": jnp.asarray(log_pn), "context": jnp.asarray(ctx)}
        jstate, jm = jstep(jstate, jbatch, key)
        rest, k_drop = jax.random.split(key)
        keep = np.asarray(jax.random.bernoulli(k_drop, 1.0 - p, (B, 1, 1)), np.float32)
        kept.append(keep)
        pbatch = {"x": t(x), "h_cat": t(h_cat), "h_int": t(h_int), "node_mask": t(mask),
                  "log_pN": t(log_pn), "context": t(ctx)}
        pm = pstep(state, pbatch, Feed(jax_ldm_draws(rest, B, N, 1, T, False)), keep=t(keep))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    kept = np.concatenate(kept).ravel()
    assert 0 < kept.sum() < len(kept)  # both a kept and a nulled context ran
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params), pcfg)
    got = model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose((got[name] - start[name]).numpy(),
                                   (w - start[name]).numpy(), atol=3e-2 * lr, err_msg=name)


def test_train_step_gradient_with_keep_mask_matches_jax(models):
    """The gradient of one conditional train step's loss with a keep mask
    that nulls one molecule's context, per parameter tensor within 1e-3 *
    max|ref| of JAX's (the card-vs-CPU train-step gate, chip_smoke.py)."""
    model, jcfg, params = models
    pcfg = model.cfg
    x, h_cat, h_int, mask = _molecules(60)
    ctx = _context(61, mask)
    keep = np.array([1.0, 0.0, 1.0], np.float32)[:, None, None]
    log_pn = np.full(B, -2.0, dtype=np.float32)
    key = jax.random.key(62)
    mj = jnp.asarray(mask)
    jnll = jfactory.model_nll_fn(jcfg, training=True)

    def loss(p):
        nll = jnll(p, key, jnp.asarray(x), jnp.asarray(h_cat), jnp.asarray(h_int), mj,
                   build_edge_mask(mj), jnp.asarray(ctx * keep))
        return jnp.mean(nll - jnp.asarray(log_pn))

    jloss, jgrads = jax.value_and_grad(loss)(params)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads), pcfg)
    m = pfactory.build_model(pcfg, "cpu")
    m.load_state_dict(model.state_dict())
    state = pts.create_train_state(m, pcfg, 1e-3, clip_grad=False, ema_decay=0.0)
    step = pts.make_train_step(pcfg, 0.0, context_dropout=0.5)
    batch = {"x": t(x), "h_cat": t(h_cat), "h_int": t(h_int), "node_mask": t(mask),
             "log_pN": t(log_pn), "context": t(ctx)}
    grads = {}  # the step's gradient, read where the optimizer would apply it
    real_step = state.optimizer.step
    state.optimizer.step = lambda: grads.update(
        {k: p.grad.clone() for k, p in m.named_parameters() if p.grad is not None})
    out = step(state, batch, Feed(jax_ldm_draws(key, B, N, 1, T, False)), keep=t(keep))
    state.optimizer.step = real_step
    np.testing.assert_allclose(float(out["loss"]), float(jloss), rtol=LOSS_RTOL)
    assert set(grads) and set(grads) <= set(want)
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        assert float((g - want[name]).abs().max()) <= 1e-3 * scale, name


def test_context_keep_draws_from_the_generator(models):
    ctx = torch.ones(4000, 3, 2)
    gen = torch.Generator().manual_seed(0)
    keep = pts.context_keep(gen, ctx, 0.25)
    assert keep.shape == (4000, 1, 1) and set(keep.unique().tolist()) <= {0.0, 1.0}
    assert abs(float(keep.mean()) - 0.75) < 0.03
    assert torch.equal(keep, pts.context_keep(torch.Generator().manual_seed(0), ctx, 0.25))
    assert float(pts.context_keep(gen, ctx, 1.0).sum()) == 0.0
    with pytest.raises(ValueError, match="keep="):
        pts.context_keep(Feed([]), ctx, 0.25)


def test_full_context_dropout_makes_the_loss_context_invariant(models):
    """p = 1 nulls every context (the JAX test_cfg property), p = 0 keeps it."""
    model = models[0]
    x, h_cat, h_int, mask = _molecules(50)
    ctx = _context(51, mask)
    losses = {}
    for p in (0.0, 1.0):
        step = pts.make_train_step(model.cfg, 0.0, context_dropout=p)
        for shift in (0.0, 3.0):
            m = pfactory.build_model(model.cfg, "cpu")
            m.load_state_dict(model.state_dict())
            state = pts.create_train_state(m, model.cfg, 1e-3, ema_decay=0.0)
            batch = {"x": t(x), "h_cat": t(h_cat), "h_int": t(h_int), "node_mask": t(mask),
                     "log_pN": t(np.zeros(B, np.float32)), "context": t(ctx + shift * mask)}
            losses[p, shift] = float(step(state, batch, torch.Generator().manual_seed(3))["loss"])
    assert losses[1.0, 0.0] == losses[1.0, 3.0]
    assert losses[0.0, 0.0] != losses[0.0, 3.0]


# --- the property classifier ---

def _clf_inputs(seed, b=4, n=8, n_real=(5, 8, 6, 3)):
    h, x, _, mask = masked_inputs(seed, b, n, 5, n_real)
    h0 = np.eye(5, dtype=np.float32)[np.abs(h).argmax(-1)] * mask
    edge = np.asarray(build_edge_mask(jnp.asarray(mask)))
    return h0, x * 1.5, mask, edge


@pytest.mark.parametrize("node_attr", [False, True])
def test_classifier_forward_matches_jax(node_attr):
    params = jclf.classifier_init(jax.random.key(1), 5, 32, 3, True, node_attr)
    model = pclf.build_classifier("egnn", 5, 32, 3, True, node_attr, "cpu")
    model.load_state_dict(classifier_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)), strict=True)
    h0, x, mask, edge = _clf_inputs(2)
    want = jclf.classifier_apply(params, jnp.asarray(h0), jnp.asarray(x), jnp.asarray(mask),
                                 jnp.asarray(edge), node_attr)
    with torch.no_grad():
        got = model(t(h0), t(x), t(mask), t(edge))
    _close(got, want, CLF_RTOL, "prediction")
    names = set(model.state_dict())
    assert {"embedding.weight", "gcl_2.edge_mlp.2.bias", "gcl_0.node_mlp.0.weight",
            "gcl_1.att_mlp.0.weight", "node_dec.2.weight", "graph_dec.0.bias"} <= names


def test_classifier_bf16_forward_tracks_jax():
    """bf16 operands with f32 accumulation, as JAX's compute_dtype: within
    the bf16 EGNN's 5e-2 * max(1, max|ref|) of JAX's bf16 run
    (tests/test_torch_port_sampling.py's mixed gate), and apart from f32."""
    params = jclf.classifier_init(jax.random.key(3), 5, 32, 2, True, False)
    model = pclf.build_classifier("egnn", 5, 32, 2, device="cpu")
    model.load_state_dict(classifier_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)), strict=True)
    h0, x, mask, edge = _clf_inputs(4)
    want = jclf.classifier_apply(params, jnp.asarray(h0), jnp.asarray(x), jnp.asarray(mask),
                                 jnp.asarray(edge), False, jnp.bfloat16)
    with torch.no_grad():
        got = model(t(h0), t(x), t(mask), t(edge), "bfloat16")
        f32 = model(t(h0), t(x), t(mask), t(edge))
    _close(got, want, 5e-2, "bf16 prediction")
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("name", ["naive", "numnodes"])
def test_baselines_match_jax(name):
    if name == "naive":
        params = jclf.naive_init(jax.random.key(5))
        apply = jclf.naive_apply
    else:
        params = jclf.numnodes_init(jax.random.key(5), 16)
        apply = jclf.numnodes_apply
    model = pclf.build_classifier(name, hidden_nf=16, device="cpu")
    model.load_state_dict(classifier_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), name), strict=True)
    h0, x, mask, edge = _clf_inputs(6)
    want = apply(params, jnp.asarray(h0), jnp.asarray(x), jnp.asarray(mask), jnp.asarray(edge))
    with torch.no_grad():
        got = model(t(h0), t(x), t(mask), t(edge))
    _close(got, want, CLF_RTOL, name)


def test_cosine_lr_is_optax_schedule():
    schedule = optax.cosine_decay_schedule(1e-3, 7)
    for step in range(9):
        assert abs(pct.cosine_lr(1e-3, 7, step) - float(schedule(step))) <= 1e-9


def test_classifier_train_steps_match_jax():
    """Three Adam + decoupled-weight-decay steps at the schedule's rates."""
    wd, lr, epochs = 1e-3, 1e-3, 5
    params = jclf.classifier_init(jax.random.key(7), 5, 32, 2, True, False)
    model = pclf.build_classifier("egnn", 5, 32, 2, device="cpu")
    model.load_state_dict(classifier_state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)), strict=True)
    tx = optax.chain(optax.scale_by_adam(), optax.add_decayed_weights(wd))
    opt_state = tx.init(params)
    jstep = jct.make_train_step(tx)
    optimizer = pct.make_optimizer(model, lr, wd)
    mean, mad = 75.0, 6.0
    for step in range(3):
        h0, x, mask, edge = _clf_inputs(10 + step)
        label = np.random.default_rng(step).standard_normal(4).astype(np.float32) * 6 + 75
        raw = {"h_cat": h0, "x": x, "node_mask": mask, "edge_mask": edge, "alpha": label}
        step_lr = pct.cosine_lr(lr, epochs, step + 1)
        jbatch = jct.batch_for_classifier(raw, "alpha")
        params, opt_state, jloss = jstep(params, opt_state, jbatch, mean, mad, step_lr)
        ploss = pct.train_step(model, optimizer, pct.batch_for_classifier(raw, "alpha", "cpu"),
                               mean, mad, step_lr)
        _close(ploss, jloss, CLF_RTOL, f"loss {step}")
    want = classifier_state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    for name, w in want.items():
        _close(model.state_dict()[name], w.numpy(), CLF_STEP_RTOL, name)
