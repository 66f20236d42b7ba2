"""Port parity on CPU: one ancestral step with shared noise, and the whole
latent-diffusion sampler from a shared z_T with the noise set to zero on
both sides (JAX on its XLA backend)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.diffusion import latent as jlatent
from geoldm_tpu.diffusion import vdm as jvdm
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.ops import com as jcom
from geoldm_tpu.ops.distance import build_edge_mask
from geoldm_tpu.utils.torch_convert import params_from_reference_state_dict
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.diffusion import latent as platent
from geoldm_tpu_torch.diffusion import vdm as pvdm
from geoldm_tpu_torch.models import factory as pfactory
from tests.torch_port_utils import masked_inputs, t

torch.set_num_threads(1)

KW = dict(nf=32, n_layers=2, latent_nf=1, diffusion_steps=10)


def _models(seed=0):
    """The port model with seeded weights and the JAX params carrying them."""
    pcfg = pfactory.make_latent_diffusion_config(get_dataset_info("qm9"), **KW)
    jcfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **KW)
    model = pfactory.build_model(pcfg, "cpu", torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, jcfg, params_from_reference_state_dict(sd, jcfg)


def _z(seed, mask, feat):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(mask.shape[:2] + (3 + feat,)).astype(np.float32) * mask
    z[:, :, :3] = np.asarray(jcom.remove_mean_with_mask(jnp.asarray(z[:, :, :3]),
                                                        jnp.asarray(mask)))
    return z


def test_one_ancestral_step_matches_jax(monkeypatch):
    model, jcfg, params = _models()
    _, _, _, mask = masked_inputs(0, 3, 8, 1, (4, 8, 6))
    zt = _z(1, mask, 1)
    rng = np.random.default_rng(2)
    eps_x = rng.standard_normal((3, 8, 3)).astype(np.float32)
    eps_h = rng.standard_normal((3, 8, 1)).astype(np.float32)
    draws = iter([eps_x, eps_h])

    def jax_sample_normal(key, mu, sigma, node_mask, n_dims, feat_nf, fix_noise=False):
        ex = jcom.remove_mean_with_mask(jnp.asarray(eps_x) * node_mask, node_mask)
        return mu + sigma * jnp.concatenate([ex, jnp.asarray(eps_h) * node_mask], axis=2)

    monkeypatch.setattr(jvdm, "sample_normal", jax_sample_normal)
    s = np.full((3, 1), 4 / 10, dtype=np.float32)
    tt = np.full((3, 1), 5 / 10, dtype=np.float32)
    mj = jnp.asarray(mask)
    z_j = jvdm.sample_p_zs_given_zt(
        params, jcfg.diffusion, jcfg.dynamics, jvdm.make_gamma_fn(jcfg.diffusion, params),
        jax.random.key(0), jnp.asarray(s), jnp.asarray(tt), jnp.asarray(zt), mj,
        build_edge_mask(mj), None)
    with torch.no_grad():
        z_p = pvdm.sample_p_zs_given_zt(
            model.dynamics, model.cfg.diffusion, pvdm.make_gamma_fn(model.cfg.diffusion, "cpu"),
            lambda shape: next(draws), t(s), t(tt), t(zt), t(mask))
    np.testing.assert_allclose(z_p.numpy(), np.asarray(z_j), atol=2e-5, rtol=2e-5)


def test_zero_noise_ldm_sample_matches_jax(monkeypatch):
    model, jcfg, params = _models(seed=1)
    _, _, _, mask = masked_inputs(0, 3, 9, 1, (5, 9, 7))
    z_T = _z(3, mask, 1)
    monkeypatch.setattr(jvdm, "sample_combined_position_feature_noise",
                        lambda key, node_mask, n_dims, feat_nf: jnp.asarray(z_T))
    monkeypatch.setattr(jvdm, "sample_normal",
                        lambda key, mu, sigma, node_mask, n_dims, feat_nf, fix_noise=False: mu)
    mj = jnp.asarray(mask)
    x_j, cat_j, int_j = jlatent.ldm_sample(params, jcfg.diffusion, jcfg.dynamics, jcfg.vae,
                                           jax.random.key(0), mj, build_edge_mask(mj))
    # The port draws z_T's x block, then its h block, then only zeros.
    draws = iter([z_T[:, :, :3], z_T[:, :, 3:]])
    noise = lambda shape: next(draws, np.zeros(shape, dtype=np.float32))  # noqa: E731
    x_p, cat_p, int_p = platent.ldm_sample(model, noise, t(mask))

    x_j = np.asarray(x_j)
    scale = max(float(np.abs(x_j).max()), 1.0)
    np.testing.assert_allclose(x_p.numpy() / scale, x_j / scale, atol=5e-3)
    real = mask[:, :, 0] > 0
    np.testing.assert_array_equal(cat_p.numpy().argmax(-1)[real],
                                  np.asarray(cat_j).argmax(-1)[real])
    np.testing.assert_array_equal(int_p.numpy(), np.asarray(int_j))
