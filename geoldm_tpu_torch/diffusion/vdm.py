"""E(n) variational diffusion (port of ``geoldm_tpu/diffusion/vdm.py:56-813``
for fixed schedules): the training loss in latent space and the dense
ancestral sampler.

The reverse loop is a plain Python loop over s = T-1 ... 0, as upstream
runs it (en_diffusion.py:776-782), and the final step stays in latent space
(the EnLatentDiffusion variant). Noise comes from a ``noise`` source
(``ops.com.Noise``: a ``torch.Generator`` or a callable), so tests can feed
the same numbers to both frameworks. DDIM/DPM-Solver, guidance, ``clip_z``,
the chain and the plain (non-latent) diffusion model, whose t=0 term is
``log_pxh_given_z0_without_constants``, wait for later slices.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

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


def kl_prior(cfg: DiffusionConfig, gamma_fn, xh, node_mask) -> torch.Tensor:
    """KL(q(z_T | x) || N(0, I)) per molecule (vdm.py:136-157)."""
    b = xh.shape[0]
    gamma_T = gamma_fn(torch.ones((b, 1), dtype=torch.float32, device=xh.device))
    mu_T = S.alpha(gamma_T, xh.dim()) * xh
    mu_T_x, mu_T_h = mu_T[:, :, :cfg.n_dims], mu_T[:, :, cfg.n_dims:]
    sigma_T_x = S.sigma(gamma_T, 1).reshape(b)
    sigma_T_h = S.sigma(gamma_T, mu_T_h.dim())
    kl_h = com.gaussian_kl(mu_T_h, sigma_T_h * torch.ones_like(mu_T_h),
                           torch.zeros_like(mu_T_h), torch.ones_like(mu_T_h), node_mask)
    kl_x = com.gaussian_kl_for_dimension(
        mu_T_x, sigma_T_x, torch.zeros_like(mu_T_x), torch.ones_like(sigma_T_x),
        com.subspace_dimensionality(node_mask, cfg.n_dims))
    return kl_x + kl_h


def compute_error(cfg: DiffusionConfig, net_out, eps, training: bool) -> torch.Tensor:
    """Squared eps error per molecule, mean-normalised under training l2
    (vdm.py:167-175)."""
    err = com.sum_except_batch((eps - net_out) ** 2)
    if training and cfg.loss_type == "l2":
        err = err / ((cfg.n_dims + cfg.in_node_nf) * net_out.shape[1])
    return err


def log_constants_p_x_given_z0(cfg: DiffusionConfig, gamma_fn, node_mask) -> torch.Tensor:
    """Constant part of log p(x | z0) on the (N-1)*3 subspace (vdm.py:178-188)."""
    b = node_mask.shape[0]
    degrees_of_freedom_x = (com.num_nodes(node_mask) - 1.0) * cfg.n_dims
    gamma_0 = gamma_fn(torch.zeros((b, 1), dtype=torch.float32, device=node_mask.device))
    log_sigma_x = 0.5 * gamma_0.reshape(b)
    return degrees_of_freedom_x * (-log_sigma_x - 0.5 * math.log(2 * math.pi))


class VDMLossInfo(NamedTuple):
    t_int: torch.Tensor
    error: torch.Tensor


def compute_loss(dynamics, cfg: DiffusionConfig, noise: com.Noise, x, h_cat, h_int, node_mask,
                 context: Optional[torch.Tensor], t0_always: bool, training: bool,
                 latent_space: bool = True):
    """Estimator of -log p(x, h) up to the constants the caller adds
    (vdm.py:260-370), on normalised inputs. ``latent_space=True`` (the
    EnLatentDiffusion path) makes the t=0 term the plain eps error.

    Draws from ``noise``, in order: t (``randint``), the eps of z_t (x block,
    then h block) and, with ``t0_always``, the eps of z_0."""
    if not latent_space:
        raise NotImplementedError("the plain diffusion model's t=0 term "
                                  "(log_pxh_given_z0_without_constants) is not ported yet")
    gamma_fn = make_gamma_fn(cfg, x.device)
    b = x.shape[0]
    t_int = com.randint(noise, 1 if t0_always else 0, cfg.timesteps + 1, (b, 1), x).float()
    t_is_zero = (t_int == 0).float()
    s = (t_int - 1) / cfg.timesteps
    t = t_int / cfg.timesteps
    gamma_s, gamma_t = gamma_fn(s), gamma_fn(t)

    eps = sample_combined_position_feature_noise(noise, node_mask, cfg.n_dims, cfg.in_node_nf)
    xh = torch.cat([x, h_cat, h_int], dim=2)
    z_t = S.alpha(gamma_t, x.dim()) * xh + S.sigma(gamma_t, x.dim()) * eps
    net_out = dynamics(t, z_t, node_mask, context)
    error = compute_error(cfg, net_out, eps, training)

    l2_training = training and cfg.loss_type == "l2"
    if l2_training:
        snr_weight = torch.ones_like(error)
    else:
        snr_weight = (S.snr(gamma_s - gamma_t) - 1.0).reshape(b)
    loss_t_larger_than_zero = 0.5 * snr_weight * error

    neg_log_constants = -log_constants_p_x_given_z0(cfg, gamma_fn, node_mask)
    if l2_training:
        neg_log_constants = torch.zeros_like(neg_log_constants)
    kl_prior_ = kl_prior(cfg, gamma_fn, xh, node_mask)

    if t0_always:
        # A dedicated second pass at t=0 (the eval estimator).
        t_zeros = torch.zeros_like(s)
        gamma_0 = gamma_fn(t_zeros)
        eps_0 = sample_combined_position_feature_noise(noise, node_mask, cfg.n_dims,
                                                       cfg.in_node_nf)
        z_0 = S.alpha(gamma_0, x.dim()) * xh + S.sigma(gamma_0, x.dim()) * eps_0
        net_out0 = dynamics(t_zeros, z_0, node_mask, context)
        loss_term_0 = 0.5 * compute_error(cfg, net_out0, eps_0, training)
        loss = kl_prior_ + cfg.timesteps * loss_t_larger_than_zero + neg_log_constants \
            + loss_term_0
    else:
        # One pass; the t=0 term is selected by masking.
        loss_term_0 = 0.5 * error
        loss_t = (loss_term_0 * t_is_zero.reshape(b)
                  + (1.0 - t_is_zero).reshape(b) * loss_t_larger_than_zero)
        estimator = loss_t if l2_training else (cfg.timesteps + 1) * loss_t
        loss = kl_prior_ + estimator + neg_log_constants
    return loss, VDMLossInfo(t_int=t_int.reshape(b), error=error)


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
