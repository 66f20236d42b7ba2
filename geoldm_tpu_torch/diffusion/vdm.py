"""E(n) variational diffusion, sampling part (port of
``geoldm_tpu/diffusion/vdm.py:56-813`` for fixed schedules and the dense
ancestral sampler).

The reverse loop is a plain Python loop over s = T-1 ... 0, as upstream
runs it (en_diffusion.py:776-782), and the final step stays in latent space
(the EnLatentDiffusion variant). Noise comes from a ``noise`` source
(``ops.com.Noise``: a ``torch.Generator`` or a callable), so tests can feed
the same numbers to both frameworks. DDIM/DPM-Solver, guidance, ``clip_z``,
the chain and the plain (non-latent) diffusion model wait for later slices.
"""

from __future__ import annotations

from typing import Callable

import torch

from geoldm_tpu_torch.config import DiffusionConfig
from geoldm_tpu_torch.diffusion import schedules as S
from geoldm_tpu_torch.ops import com


def make_gamma_fn(cfg: DiffusionConfig, device) -> Callable[[torch.Tensor], torch.Tensor]:
    """gamma(t) for t in [0,1] of a predefined schedule, shape-preserving."""
    if cfg.noise_schedule == "learned":
        raise NotImplementedError("the learned gamma schedule is not ported yet")
    table = torch.tensor(
        S.gamma_table(cfg.noise_schedule, cfg.timesteps, cfg.noise_precision),
        dtype=torch.float32, device=device)
    return lambda t: S.gamma_lookup(table, t, cfg.timesteps)


def sample_combined_position_feature_noise(noise: com.Noise, node_mask, n_dims: int,
                                           feat_nf: int) -> torch.Tensor:
    """CoM-zero noise on the x block, masked standard normal on the h block
    (reference: en_diffusion.py:749-760)."""
    b, n, _ = node_mask.shape
    z_x = com.sample_center_gravity_zero_gaussian_with_mask(noise, (b, n, n_dims), node_mask)
    z_h = com.sample_gaussian_with_mask(noise, (b, n, feat_nf), node_mask)
    return torch.cat([z_x, z_h], dim=2)


def sample_normal(noise: com.Noise, mu, sigma, node_mask, n_dims: int, feat_nf: int,
                  fix_noise: bool = False) -> torch.Tensor:
    """mu + sigma * eps with combined CoM-zero/standard noise. With
    ``fix_noise`` one [1, N, D] draw is broadcast over the batch, then
    masked and CoM-projected per sample (vdm.py:405-422)."""
    if fix_noise:
        _, n, _ = node_mask.shape
        raw_x = com.randn(noise, (1, n, n_dims), node_mask) * node_mask
        z_x = com.remove_mean_with_mask(raw_x, node_mask)
        z_h = com.randn(noise, (1, n, feat_nf), node_mask) * node_mask
        eps = torch.cat([z_x, z_h], dim=2)
    else:
        eps = sample_combined_position_feature_noise(noise, node_mask, n_dims, feat_nf)
    return mu + sigma * eps


def guided_eps(dynamics, t, z, node_mask):
    """Denoiser eps-hat of the unconditional model (context=None);
    classifier-free guidance joins with the conditional slice."""
    return dynamics(t, z, node_mask)


def compute_x_pred(net_out, zt, gamma_t) -> torch.Tensor:
    """Most-likely x given the eps prediction (en_diffusion.py:437-449)."""
    sigma_t = S.sigma(gamma_t, net_out.dim())
    alpha_t = S.alpha(gamma_t, net_out.dim())
    return 1.0 / alpha_t * (zt - sigma_t * net_out)


def _project_x(z, node_mask, n_dims):
    return torch.cat([com.remove_mean_with_mask(z[:, :, :n_dims], node_mask),
                      z[:, :, n_dims:]], dim=2)


def sample_p_zs_given_zt(dynamics, cfg: DiffusionConfig, gamma_fn, noise, s, t, zt,
                         node_mask, fix_noise: bool = False) -> torch.Tensor:
    """One ancestral step zs ~ p(z_s | z_t) (en_diffusion.py:716-747)."""
    gamma_s = gamma_fn(s)
    gamma_t = gamma_fn(t)
    sigma2_t_given_s, sigma_t_given_s, alpha_t_given_s = S.sigma_and_alpha_t_given_s(
        gamma_t, gamma_s, zt.dim())
    sigma_s = S.sigma(gamma_s, zt.dim())
    sigma_t = S.sigma(gamma_t, zt.dim())

    eps_t = guided_eps(dynamics, t, zt, node_mask)
    mu = zt / alpha_t_given_s - (sigma2_t_given_s / alpha_t_given_s / sigma_t) * eps_t
    sigma = sigma_t_given_s * sigma_s / sigma_t
    zs = sample_normal(noise, mu, sigma, node_mask, cfg.n_dims, cfg.in_node_nf, fix_noise)
    # Project the coordinate part back to zero CoM to stop numeric drift.
    return _project_x(zs, node_mask, cfg.n_dims)


def sample_p_xh_given_z0(dynamics, cfg: DiffusionConfig, gamma_fn, noise, z0, node_mask,
                         fix_noise: bool = False):
    """Final step p(x, h | z_0), staying in the latent representation
    (``latent_space=True``; EnLatentDiffusion, en_diffusion.py:1099-1122).
    -> (x [B,N,3], empty h_cat [B,N,0], latent h [B,N,F])."""
    b = z0.shape[0]
    zeros = torch.zeros((b, 1), dtype=torch.float32, device=z0.device)
    gamma_0 = gamma_fn(zeros)
    sigma_x = S.snr(-0.5 * gamma_0).reshape(b, 1, 1)
    net_out = guided_eps(dynamics, zeros, z0, node_mask)
    mu_x = compute_x_pred(net_out, z0, gamma_0)
    xh = sample_normal(noise, mu_x, sigma_x, node_mask, cfg.n_dims, cfg.in_node_nf, fix_noise)
    x = xh[:, :, :cfg.n_dims]
    return x, xh[:, :, :0], xh[:, :, cfg.n_dims:]


def vdm_sample(dynamics, cfg: DiffusionConfig, noise: com.Noise, node_mask,
               fix_noise: bool = False):
    """Dense ancestral sampling over all T steps, then the final latent-space
    step and a CoM re-projection (vdm.py:579-813 with n_steps=None, eta=1,
    method='ddim', guidance_scale=1, clip_z=0, latent_space=True)."""
    gamma_fn = make_gamma_fn(cfg, node_mask.device)
    b = node_mask.shape[0]
    if fix_noise:
        z = sample_normal(noise, 0.0, 1.0, node_mask, cfg.n_dims, cfg.in_node_nf, True)
    else:
        z = sample_combined_position_feature_noise(noise, node_mask, cfg.n_dims, cfg.in_node_nf)
    T = cfg.timesteps
    for s_idx in range(T - 1, -1, -1):
        s_arr = torch.full((b, 1), s_idx, dtype=torch.float32, device=z.device) / T
        t_arr = torch.full((b, 1), s_idx + 1, dtype=torch.float32, device=z.device) / T
        z = sample_p_zs_given_zt(dynamics, cfg, gamma_fn, noise, s_arr, t_arr, z,
                                 node_mask, fix_noise)
    x, h_cat, h_int = sample_p_xh_given_z0(dynamics, cfg, gamma_fn, noise, z, node_mask,
                                           fix_noise)
    # Final CoM-drift guard (reference: en_diffusion.py:789-793).
    x = com.remove_mean_with_mask(x * node_mask, node_mask)
    return x, h_cat, h_int
