"""Port parity on CPU: CoM ops, distance features, schedules, configs and
the host-side copies (dataset metadata, masks, size distribution, buckets,
stability check) — geoldm_tpu_torch vs geoldm_tpu on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu import config as jcfg
from geoldm_tpu.data.collate import build_masks as jax_build_masks
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.diffusion import schedules as jS
from geoldm_tpu.evalsuite.analyze import check_stability as jax_check_stability
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.models.distributions import DistributionNodes as JaxNodes
from geoldm_tpu.ops import com as jcom
from geoldm_tpu.ops import distance as jdist
from geoldm_tpu.utils.buckets import covering_buckets as jax_covering
from geoldm_tpu_torch import config as pcfg
from geoldm_tpu_torch.data.collate import build_masks
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.diffusion import schedules as pS
from geoldm_tpu_torch.diffusion import vdm as pvdm
from geoldm_tpu_torch.evalsuite.analyze import check_stability
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.models.distributions import DistributionNodes
from geoldm_tpu_torch.ops import com as pcom
from geoldm_tpu_torch.ops import distance as pdist
from geoldm_tpu_torch.utils.buckets import covering_buckets
from tests.torch_port_utils import masked_inputs, t

torch.set_num_threads(1)


def test_com_ops_match_jax():
    _, x, _, mask = masked_inputs(0, 3, 7, 1, (3, 7, 5))
    x = x + 1.5 * mask  # non-zero CoM
    np.testing.assert_allclose(
        pcom.remove_mean_with_mask(t(x), t(mask)).numpy(),
        np.asarray(jcom.remove_mean_with_mask(jnp.asarray(x), jnp.asarray(mask))),
        atol=1e-6)
    np.testing.assert_array_equal(pcom.num_nodes(t(mask)).numpy(),
                                  np.asarray(jcom.num_nodes(jnp.asarray(mask))))
    np.testing.assert_allclose(pcom.sum_except_batch(t(x)).numpy(),
                               np.asarray(jcom.sum_except_batch(jnp.asarray(x))), atol=1e-5)


def test_com_likelihoods_and_kls_match_jax():
    _, x, _, mask = masked_inputs(2, 3, 7, 1, (3, 7, 5))
    rng = np.random.default_rng(3)
    q_mu, p_mu = (rng.standard_normal((3, 7, 2)).astype(np.float32) * mask for _ in range(2))
    q_s, p_s = (rng.uniform(0.5, 2.0, (3, 7, 2)).astype(np.float32) for _ in range(2))
    qb, pb = (rng.uniform(0.5, 2.0, 3).astype(np.float32) for _ in range(2))
    mj, xj = jnp.asarray(mask), jnp.asarray(x)
    d = pcom.subspace_dimensionality(t(mask), 3)
    pairs = [
        (d, jcom.subspace_dimensionality(mj, 3)),
        (pcom.center_gravity_zero_gaussian_log_likelihood_with_mask(t(x), t(mask)),
         jcom.center_gravity_zero_gaussian_log_likelihood_with_mask(xj, mj)),
        (pcom.standard_gaussian_log_likelihood_with_mask(t(x), t(mask)),
         jcom.standard_gaussian_log_likelihood_with_mask(xj, mj)),
        (pcom.gaussian_kl(t(q_mu), t(q_s), t(p_mu), t(p_s), t(mask)),
         jcom.gaussian_kl(*map(jnp.asarray, (q_mu, q_s, p_mu, p_s)), mj)),
        (pcom.gaussian_kl_for_dimension(t(x), t(qb), torch.zeros_like(t(x)), t(pb), d),
         jcom.gaussian_kl_for_dimension(xj, jnp.asarray(qb), jnp.zeros_like(xj),
                                        jnp.asarray(pb), jnp.asarray(d.numpy()))),
        (pcom.cdf_standard_gaussian(t(x)), jcom.cdf_standard_gaussian(xj)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_masked_gaussians_respect_mask_and_com():
    _, _, _, mask = masked_inputs(0, 4, 9, 1, (2, 9, 5, 7))
    gen = torch.Generator().manual_seed(0)
    z = pcom.sample_center_gravity_zero_gaussian_with_mask(gen, (4, 9, 3), t(mask))
    assert float((z * (1 - t(mask))).abs().max()) == 0.0
    assert float(z.sum(dim=1).abs().max()) < 1e-5
    h = pcom.sample_gaussian_with_mask(gen, (4, 9, 2), t(mask))
    assert float((h * (1 - t(mask))).abs().max()) == 0.0
    # An injected source replaces the generator draw for draw.
    eps = np.random.default_rng(1).standard_normal((4, 9, 3)).astype(np.float32)
    z2 = pcom.sample_center_gravity_zero_gaussian_with_mask(lambda s: eps, (4, 9, 3), t(mask))
    ref = jcom.remove_mean_with_mask(jnp.asarray(eps) * mask, jnp.asarray(mask))
    np.testing.assert_allclose(z2.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("norm_constant", [1.0, 0.5])
def test_distance_features_match_jax(norm_constant):
    _, x, _, mask = masked_inputs(2, 2, 6, 1, (4, 6))
    r_p, cd_p = pdist.coord2diff(t(x), norm_constant)
    r_j, cd_j = jdist.coord2diff(jnp.asarray(x), norm_constant)
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(cd_p.numpy(), np.asarray(cd_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pdist.sin_embedding(r_p).numpy(),
                               np.asarray(jdist.sin_embedding(r_j)), atol=2e-6)
    np.testing.assert_array_equal(pdist.build_edge_mask(t(mask)).numpy(),
                                  np.asarray(jdist.build_edge_mask(jnp.asarray(mask))))
    assert pdist.SIN_EMBEDDING_DIM == jdist.SIN_EMBEDDING_DIM
    assert pdist._FREQUENCIES == jdist._FREQUENCIES


@pytest.mark.parametrize("schedule,steps", [("polynomial_2", 1000), ("polynomial_2", 500),
                                            ("polynomial_3", 10), ("cosine", 50)])
def test_gamma_table_bit_exact(schedule, steps):
    a = pS.gamma_table(schedule, steps, 1e-5)
    b = jS.gamma_table(schedule, steps, 1e-5)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_schedule_algebra_matches_jax():
    table = jS.gamma_table("polynomial_2", 20, 1e-5)
    tt = np.linspace(0, 1, 21, dtype=np.float32)[:, None]
    ss = np.clip(tt - 1 / 20, 0, 1).astype(np.float32)
    g_t = pS.gamma_lookup(torch.tensor(table, dtype=torch.float32), t(tt), 20)
    g_s = pS.gamma_lookup(torch.tensor(table, dtype=torch.float32), t(ss), 20)
    jt = jS.gamma_lookup(jnp.asarray(table), jnp.asarray(tt), 20)
    js = jS.gamma_lookup(jnp.asarray(table), jnp.asarray(ss), 20)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(jt))
    for p_out, j_out in zip(pS.sigma_and_alpha_t_given_s(g_t, g_s, 3),
                            jS.sigma_and_alpha_t_given_s(jt, js, 3)):
        np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(pS.sigma(g_t, 3).numpy(), np.asarray(jS.sigma(jt, 3)), rtol=1e-6)
    np.testing.assert_allclose(pS.alpha(g_t, 3).numpy(), np.asarray(jS.alpha(jt, 3)), rtol=1e-6)


def test_configs_serialise_like_jax():
    kw = dict(nf=64, n_layers=3, latent_nf=2, diffusion_steps=100, sin_embedding=True,
              aggregation_method="mean", normalization_factor=100.0)
    p = pfactory.make_latent_diffusion_config(get_dataset_info("qm9"), **kw)
    j = jfactory.make_latent_diffusion_config(jax_info("qm9"), **kw)
    assert pcfg.dumps(p) == jcfg.dumps(j)
    assert pcfg.loads(jcfg.dumps(j)) == p
    assert p.dynamics.egnn.edge_feat_nf == j.dynamics.egnn.edge_feat_nf


def test_host_side_copies_match_jax():
    for name, remove_h in (("qm9", False), ("qm9", True), ("qm9_second_half", False)):
        p_info, j_info = get_dataset_info(name, remove_h), jax_info(name, remove_h)
        for f in ("name", "atom_decoder", "max_n_nodes", "n_nodes_histogram",
                  "atom_type_counts", "with_h"):
            assert getattr(p_info, f) == getattr(j_info, f), (name, f)
    info, jinfo = get_dataset_info("qm9"), jax_info("qm9")
    for p, j in zip(build_masks(np.array([3, 7, 1]), 8), jax_build_masks(np.array([3, 7, 1]), 8)):
        np.testing.assert_array_equal(p, j)
    nodes, jnodes = DistributionNodes(info.n_nodes), JaxNodes(jinfo.n_nodes)
    np.testing.assert_array_equal(nodes.sample(50, np.random.default_rng(4)),
                                  jnodes.sample(50, np.random.default_rng(4)))
    np.testing.assert_array_equal(nodes.log_prob([9, 19, 29]), jnodes.log_prob([9, 19, 29]))
    assert covering_buckets((16, 24, 32), 29) == jax_covering((16, 24, 32), 29)
    assert covering_buckets((16, 24), 29) == jax_covering((16, 24), 29)
    rng = np.random.default_rng(5)
    for n in (3, 9, 19):
        pos = rng.standard_normal((n, 3)) * 1.2
        types = rng.integers(0, 5, size=n)
        assert check_stability(pos, types, info) == jax_check_stability(pos, types, jinfo)


def test_fix_noise_shares_one_draw_across_the_batch():
    _, _, _, mask = masked_inputs(0, 3, 6, 1, (6, 6, 4))
    gen = torch.Generator().manual_seed(0)
    z = pvdm.sample_normal(gen, 0.0, 1.0, t(mask), 3, 2, fix_noise=True)
    assert torch.equal(z[0], z[1]) and not torch.equal(z[0, :4], z[2, :4])
    assert float(z[:, :, :3].sum(dim=1).abs().max()) < 1e-5
    assert float((z * (1 - t(mask))).abs().max()) == 0.0
