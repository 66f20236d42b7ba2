"""E(n) variational diffusion (port of ``geoldm_tpu/diffusion/vdm.py:41-824``):
the plain E(n) diffusion model over (x, h) (EDM, upstream
``EnVariationalDiffusion``), its NLL and training loss, the same loss in a
latent space (the EnLatentDiffusion path of ``diffusion.latent``) and the
sampler.

The model's ``gamma`` module gives gamma(t): the table of a predefined
schedule or the learned ``GammaNetwork`` (``diffusion.schedules``), whose
gradient reaches the loss through the vlb weights. The plain kind's t=0
term is ``log_pxh_given_z0_without_constants`` (the decoding of x, one-hot
h and integer charges); in latent space it is the plain eps error.

The sampler (``vdm_sample``) runs the dense ancestral loop over s = T-1 ...
0, as upstream runs it (en_diffusion.py:776-782), or, with ``n_steps``, an
``eta`` other than 1 or ``method='dpm2m'``, K jumps over an integer sub-grid
of the T timesteps: the DDIM family (``sample_p_zs_given_zt_ddim``) or
DPM-Solver++(2M). ``clip_z`` guards each step's state; a ``full``
low-precision compute dtype with a ``mixed_tail`` runs the last steps and
the final p(x | z0) step in f32; ``keep_frames`` returns the dense
sampler's chain. The final step stays in latent space (``latent_space``, the
EnLatentDiffusion variant) or unnormalises, one-hots h and rounds the
charges (the plain kind). The loops are plain Python loops. Noise comes from
a ``noise`` source (``ops.com.Noise``: a ``torch.Generator`` or a callable),
drawn in JAX's key order (z_T, each step's, the final step's), so tests can
feed the same numbers to both frameworks. A conditional model's ``context``
reaches every denoiser call, and ``guidance_scale`` w blends the conditional
and the null-context eps (classifier-free guidance, ``guided_eps``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from geoldm_tpu_torch.config import DiffusionConfig, ModelConfig
from geoldm_tpu_torch.diffusion import schedules as S
from geoldm_tpu_torch.nn.core import resolve_compute
from geoldm_tpu_torch.nn.dynamics import EGNNDynamics
from geoldm_tpu_torch.ops import com


class EnVariationalDiffusion(nn.Module):
    """The plain E(n) diffusion model (kind 'diffusion'), in upstream's module
    layout: ``buffer``, ``gamma`` (the schedule's table, or the learned
    ``GammaNetwork``) and ``dynamics`` (reference en_diffusion.py:254-296;
    ``vdm_init``, vdm.py:41-53)."""

    def __init__(self, model_cfg: ModelConfig):
        super().__init__()
        d = model_cfg.diffusion
        self.cfg = model_cfg
        self.register_buffer("buffer", torch.zeros(1))
        self.gamma = S.make_gamma_module(d.noise_schedule, d.timesteps, d.noise_precision)
        self.dynamics = EGNNDynamics(model_cfg.dynamics)


def make_gamma_fn(cfg: DiffusionConfig, gamma) -> Callable[[torch.Tensor], torch.Tensor]:
    """gamma(t) for t in [0, 1], shape-preserving over [B] or [B, 1]
    (vdm.py:56-76): the model's ``gamma`` module, or, given a device in its
    place, the table of ``cfg``'s predefined schedule on it. The learned
    schedule has no table: it needs the model's ``GammaNetwork``."""
    if isinstance(gamma, nn.Module):
        return gamma
    if cfg.noise_schedule == "learned":
        raise ValueError("the learned schedule is the model's GammaNetwork: pass model.gamma")
    table = torch.tensor(
        S.gamma_table(cfg.noise_schedule, cfg.timesteps, cfg.noise_precision),
        dtype=torch.float32, device=gamma)
    return lambda t: S.gamma_lookup(table, t, cfg.timesteps)


def normalize(cfg: DiffusionConfig, x, h_cat, h_int, node_mask):
    """(x, h_cat, h_int) scaled by ``norm_values`` and shifted by
    ``norm_biases``, and the log-det of the x scaling per molecule
    (vdm.py:84-94; en_diffusion.py:344-360)."""
    x = x / cfg.norm_values[0]
    delta_log_px = -com.subspace_dimensionality(node_mask, cfg.n_dims) * math.log(
        cfg.norm_values[0])
    h_cat = (h_cat.float() - cfg.norm_biases[1]) / cfg.norm_values[1] * node_mask
    h_int = (h_int.float() - cfg.norm_biases[2]) / cfg.norm_values[2]
    if cfg.include_charges:
        h_int = h_int * node_mask
    return x, h_cat, h_int, delta_log_px


def unnormalize(cfg: DiffusionConfig, x, h_cat, h_int, node_mask):
    """The inverse of ``normalize`` (vdm.py:97-103)."""
    x = x * cfg.norm_values[0]
    h_cat = (h_cat * cfg.norm_values[1] + cfg.norm_biases[1]) * node_mask
    h_int = h_int * cfg.norm_values[2] + cfg.norm_biases[2]
    if cfg.include_charges:
        h_int = h_int * node_mask
    return x, h_cat, h_int


def _split_h(cfg: DiffusionConfig, z):
    """z [B,N,3+C+inc] -> (its categorical block, its charge block [B,N,inc])."""
    nd, inc = cfg.n_dims, int(cfg.include_charges)
    d = z.shape[2]
    return z[:, :, nd:d - inc], z[:, :, d - inc:d]


def unnormalize_z(cfg: DiffusionConfig, z, node_mask):
    """A state z [B,N,3+C+inc] unnormalised block by block (vdm.py:106-113)."""
    h_cat, h_int = _split_h(cfg, z)
    x, h_cat, h_int = unnormalize(cfg, z[:, :, :cfg.n_dims], h_cat, h_int, node_mask)
    return torch.cat([x, h_cat, h_int], dim=2)


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


def log_pxh_given_z0_without_constants(cfg: DiffusionConfig, h_cat, h_int, z_t, gamma_0, eps,
                                       net_out, node_mask, training: bool,
                                       epsilon: float = 1e-10) -> torch.Tensor:
    """log p(x, h | z_0) without its constants, per molecule (vdm.py:191-247;
    en_diffusion.py:505-566): the x part's eps error with weight 1, the
    integer charges' Gaussian mass over +-0.5 around the target, and the
    one-hot types' mass around the peak, normalised over the classes. A CDF
    difference is a probability mass, which f32 ``erf`` can round to a
    little below 0 at extreme arguments; it is clamped at 0 before the
    epsilon, as JAX clamps it, so the log stays finite (the single pass
    computes this term for every t and masks it, and a NaN would poison the
    gradient through the select)."""
    nd = cfg.n_dims
    z_h_cat, z_h_int = _split_h(cfg, z_t)
    sigma_0 = S.sigma(gamma_0, z_t.dim())
    sigma_0_cat = sigma_0 * cfg.norm_values[1]
    sigma_0_int = sigma_0 * cfg.norm_values[2]

    log_p_x_given_z_wc = -0.5 * compute_error(cfg, net_out[:, :, :nd], eps[:, :, :nd], training)

    def log_mass(centered, scale):
        cdf = com.cdf_standard_gaussian
        return torch.log(torch.clamp(cdf((centered + 0.5) / scale)
                                     - cdf((centered - 0.5) / scale), min=0.0) + epsilon)

    h_integer = torch.round(h_int * cfg.norm_values[2] + cfg.norm_biases[2])
    est_h_int = z_h_int * cfg.norm_values[2] + cfg.norm_biases[2]
    log_ph_integer = com.sum_except_batch(log_mass(h_integer - est_h_int, sigma_0_int)
                                          * node_mask)

    onehot = h_cat * cfg.norm_values[1] + cfg.norm_biases[1]
    est_h_cat = z_h_cat * cfg.norm_values[1] + cfg.norm_biases[1]
    log_ph_cat_prop = log_mass(est_h_cat - 1.0, sigma_0_cat)
    log_probabilities = log_ph_cat_prop - torch.logsumexp(log_ph_cat_prop, dim=2, keepdim=True)
    log_ph_cat = com.sum_except_batch(log_probabilities * onehot * node_mask)
    return log_p_x_given_z_wc + log_ph_integer + log_ph_cat


class VDMLossInfo(NamedTuple):
    t_int: torch.Tensor
    error: torch.Tensor


def compute_loss(dynamics, cfg: DiffusionConfig, noise: com.Noise, x, h_cat, h_int, node_mask,
                 context: Optional[torch.Tensor], t0_always: bool, training: bool,
                 latent_space: bool = True, compute_dtype=None, gamma=None):
    """Estimator of -log p(x, h) up to the constants the caller adds
    (vdm.py:260-370), on normalised inputs. ``latent_space=True`` (the
    EnLatentDiffusion path) makes the t=0 term the plain eps error; False
    (the plain kind) makes it ``log_pxh_given_z0_without_constants``.
    ``gamma``: the model's gamma module (None: ``cfg``'s predefined table).

    Draws from ``noise``, in order: t (``randint``), the eps of z_t (x block,
    then h block) and, with ``t0_always``, the eps of z_0."""
    gamma_fn = make_gamma_fn(cfg, x.device if gamma is None else gamma)
    b = x.shape[0]

    def neg_log_pxh_z0(z, gamma_0, eps_, net_out_, error_):
        if latent_space:
            return 0.5 * error_
        return -log_pxh_given_z0_without_constants(cfg, h_cat, h_int, z, gamma_0, eps_,
                                                   net_out_, node_mask, training)

    t_int = com.randint(noise, 1 if t0_always else 0, cfg.timesteps + 1, (b, 1), x).float()
    t_is_zero = (t_int == 0).float()
    s = (t_int - 1) / cfg.timesteps
    t = t_int / cfg.timesteps
    gamma_s, gamma_t = gamma_fn(s), gamma_fn(t)

    eps = sample_combined_position_feature_noise(noise, node_mask, cfg.n_dims, cfg.in_node_nf)
    xh = torch.cat([x, h_cat, h_int], dim=2)
    z_t = S.alpha(gamma_t, x.dim()) * xh + S.sigma(gamma_t, x.dim()) * eps
    net_out = dynamics(t, z_t, node_mask, context, compute_dtype)
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
        net_out0 = dynamics(t_zeros, z_0, node_mask, context, compute_dtype)
        loss_term_0 = neg_log_pxh_z0(z_0, gamma_0, eps_0, net_out0,
                                     compute_error(cfg, net_out0, eps_0, training))
        loss = kl_prior_ + cfg.timesteps * loss_t_larger_than_zero + neg_log_constants \
            + loss_term_0
    else:
        # One pass; the t=0 term is computed for every t and selected by
        # masking.
        loss_term_0 = neg_log_pxh_z0(z_t, gamma_t, eps, net_out, error)
        loss_t = (loss_term_0 * t_is_zero.reshape(b)
                  + (1.0 - t_is_zero).reshape(b) * loss_t_larger_than_zero)
        estimator = loss_t if l2_training else (cfg.timesteps + 1) * loss_t
        loss = kl_prior_ + estimator + neg_log_constants
    return loss, VDMLossInfo(t_int=t_int.reshape(b), error=error)


def vdm_nll(model: EnVariationalDiffusion, noise: com.Noise, x, h_cat, h_int, node_mask,
            context: Optional[torch.Tensor] = None, training: bool = False,
            compute_dtype=None) -> torch.Tensor:
    """-log p(x, h) per molecule [B] of the plain kind (the l2 surrogate when
    training with l2; vdm.py:373-397, en_diffusion.py:690-714): normalise,
    ``compute_loss`` with ``t0_always`` when evaluating, minus the x
    scaling's log-det. Draws as ``compute_loss``; the denoiser runs in
    ``compute_dtype`` (a name resolved here)."""
    cfg = model.cfg.diffusion
    compute_dtype = resolve_compute(compute_dtype).operand
    x, h_cat, h_int, delta_log_px = normalize(cfg, x, h_cat, h_int, node_mask)
    if training and cfg.loss_type == "l2":
        delta_log_px = torch.zeros_like(delta_log_px)
    loss, _ = compute_loss(model.dynamics, cfg, noise, x, h_cat, h_int, node_mask, context,
                           t0_always=not training, training=training, latent_space=False,
                           compute_dtype=compute_dtype, gamma=model.gamma)
    return loss - delta_log_px


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


def guided_eps(dynamics, t, z, node_mask, context=None, compute_dtype=None,
               guidance_scale: float = 1.0):
    """Denoiser eps-hat in ``compute_dtype`` with classifier-free guidance
    (Ho & Salimans 2022; vdm.py:425-455): eps_u + w (eps_c - eps_u), eps_u
    the all-zero null context ``--context_dropout`` trains. No context, or
    w = 0: one call (with the null context at w = 0); w = 1: one call with
    the context; any other w: two calls."""
    if context is None or guidance_scale == 0.0:
        context = None if context is None else torch.zeros_like(context)
        return dynamics(t, z, node_mask, context, compute_dtype)
    eps = dynamics(t, z, node_mask, context, compute_dtype)
    if guidance_scale == 1.0:
        return eps
    eps_u = dynamics(t, z, node_mask, torch.zeros_like(context), compute_dtype)
    return eps_u + guidance_scale * (eps - eps_u)


def compute_x_pred(net_out, zt, gamma_t) -> torch.Tensor:
    """Most-likely x given the eps prediction (en_diffusion.py:437-449)."""
    sigma_t = S.sigma(gamma_t, net_out.dim())
    alpha_t = S.alpha(gamma_t, net_out.dim())
    return 1.0 / alpha_t * (zt - sigma_t * net_out)


def _project_x(z, node_mask, n_dims):
    return torch.cat([com.remove_mean_with_mask(z[:, :, :n_dims], node_mask),
                      z[:, :, n_dims:]], dim=2)


def sample_p_zs_given_zt(dynamics, cfg: DiffusionConfig, gamma_fn, noise, s, t, zt,
                         node_mask, fix_noise: bool = False, compute_dtype=None, context=None,
                         guidance_scale: float = 1.0) -> torch.Tensor:
    """One ancestral step zs ~ p(z_s | z_t) (en_diffusion.py:716-747)."""
    gamma_s = gamma_fn(s)
    gamma_t = gamma_fn(t)
    sigma2_t_given_s, sigma_t_given_s, alpha_t_given_s = S.sigma_and_alpha_t_given_s(
        gamma_t, gamma_s, zt.dim())
    sigma_s = S.sigma(gamma_s, zt.dim())
    sigma_t = S.sigma(gamma_t, zt.dim())

    eps_t = guided_eps(dynamics, t, zt, node_mask, context, compute_dtype, guidance_scale)
    mu = zt / alpha_t_given_s - (sigma2_t_given_s / alpha_t_given_s / sigma_t) * eps_t
    sigma = sigma_t_given_s * sigma_s / sigma_t
    zs = sample_normal(noise, mu, sigma, node_mask, cfg.n_dims, cfg.in_node_nf, fix_noise)
    # Project the coordinate part back to zero CoM to stop numeric drift.
    return _project_x(zs, node_mask, cfg.n_dims)


def sample_p_zs_given_zt_ddim(dynamics, cfg: DiffusionConfig, gamma_fn, noise, s, t, zt,
                              node_mask, eta: float = 0.0, fix_noise: bool = False,
                              compute_dtype=None, context=None,
                              guidance_scale: float = 1.0) -> torch.Tensor:
    """The reverse jump z_t -> z_s for any s < t, DDIM family (vdm.py:494-537;
    Song et al. 2021, eq. 12): predict x from eps, then re-noise to level s
    with stochasticity ``eta``. eta=1 is the ancestral posterior step
    (algebraically ``sample_p_zs_given_zt``), eta=0 the deterministic
    probability-flow jump. The noise is drawn whatever eta, as JAX draws
    it."""
    gamma_s = gamma_fn(s)
    gamma_t = gamma_fn(t)
    _, sigma_t_given_s, _ = S.sigma_and_alpha_t_given_s(gamma_t, gamma_s, zt.dim())
    alpha_s = S.alpha(gamma_s, zt.dim())
    sigma_s = S.sigma(gamma_s, zt.dim())
    sigma_t = S.sigma(gamma_t, zt.dim())

    eps_t = guided_eps(dynamics, t, zt, node_mask, context, compute_dtype, guidance_scale)
    x_pred = compute_x_pred(eps_t, zt, gamma_t)
    # eta scales the ancestral posterior std; the remaining variance rides
    # the predicted eps direction so Var(z_s) stays sigma_s^2.
    sigma_tilde = eta * (sigma_t_given_s * sigma_s / sigma_t)
    dir_coef = torch.sqrt(torch.clamp(sigma_s ** 2 - sigma_tilde ** 2, min=0.0))
    mu = alpha_s * x_pred + dir_coef * eps_t
    zs = sample_normal(noise, mu, sigma_tilde, node_mask, cfg.n_dims, cfg.in_node_nf, fix_noise)
    return _project_x(zs, node_mask, cfg.n_dims)


def sample_p_xh_given_z0(dynamics, cfg: DiffusionConfig, gamma_fn, noise, z0, node_mask,
                         fix_noise: bool = False, compute_dtype=None, context=None,
                         guidance_scale: float = 1.0, latent_space: bool = True):
    """Final step p(x, h | z_0) (vdm.py:540-576). With ``latent_space`` (the
    EnLatentDiffusion variant, en_diffusion.py:1099-1122) h stays the latent
    one: -> (x [B,N,3], empty h_cat [B,N,0], latent h [B,N,F]). Otherwise
    (the plain kind, en_diffusion.py:477-497) the types are the one-hot
    argmax and the charges the rounded value of z_0's unnormalised h blocks:
    -> (x, h_cat one-hot [B,N,C], h_int [B,N,inc])."""
    b = z0.shape[0]
    zeros = torch.zeros((b, 1), dtype=torch.float32, device=z0.device)
    gamma_0 = gamma_fn(zeros)
    sigma_x = S.snr(-0.5 * gamma_0).reshape(b, 1, 1)
    net_out = guided_eps(dynamics, zeros, z0, node_mask, context, compute_dtype,
                         guidance_scale)
    mu_x = compute_x_pred(net_out, z0, gamma_0)
    xh = sample_normal(noise, mu_x, sigma_x, node_mask, cfg.n_dims, cfg.in_node_nf, fix_noise)
    x = xh[:, :, :cfg.n_dims]
    if latent_space:
        return x, xh[:, :, :0], xh[:, :, cfg.n_dims:]
    h_cat, h_int = _split_h(cfg, z0)
    x, h_cat, h_int = unnormalize(cfg, x, h_cat, h_int, node_mask)
    h_cat = F.one_hot(torch.argmax(h_cat, dim=2), cfg.num_classes).float() * node_mask
    return x, h_cat, torch.round(h_int) * node_mask


def strided_grid(timesteps: int, n_steps: int) -> list:
    """The few-step sampler's integer sub-grid tau_0 = T > ... > tau_K = 0
    (vdm.py:684-688): strictly decreasing for K <= T, since consecutive gaps
    are at least floor(T/K) >= 1."""
    return [((n_steps - k) * timesteps) // n_steps for k in range(n_steps + 1)]


def mixed_tail_steps(compute_dtype, n_steps: int) -> int:
    """How many final sampler steps run in f32: round(mixed_tail * K) under a
    ``full`` compute dtype (``bfloat16_mixed``: 10 %), else 0."""
    spec = resolve_compute(compute_dtype)
    return int(round(spec.mixed_tail * n_steps)) if spec.full else 0


def chain_slots(timesteps: int, keep_frames: int) -> list:
    """The step s whose state chain slot k keeps (vdm.py:801-811): upstream
    writes slot floor(s * keep / T) at every step, so the surviving frame of
    slot k is the smallest s in it, ceil(k * T / keep). With keep > T a slot
    can fall past the last step (s = T); JAX's gather index T - 1 - s is
    then -1 and wraps to the state after step 0, and so does this one."""
    T = timesteps
    return [T - 1 - (T - 1 + (k * T) // -keep_frames) % T for k in range(keep_frames)]


def vdm_sample(dynamics, cfg: DiffusionConfig, noise: com.Noise, node_mask,
               fix_noise: bool = False, compute_dtype=None, keep_frames: Optional[int] = None,
               n_steps: Optional[int] = None, eta: float = 1.0, method: str = "ddim",
               clip_z: float = 0.0, context: Optional[torch.Tensor] = None,
               guidance_scale: float = 1.0, latent_space: bool = True, gamma=None):
    """Reverse diffusion, then the final step and a CoM re-projection
    (vdm.py:579-813): in latent space (``latent_space``, the latent model's
    denoiser) or decoded to one-hot types and rounded charges (the plain
    kind). ``gamma``: the model's gamma module (None: ``cfg``'s predefined
    table).

    - Dense (the defaults): the T ancestral steps.
    - ``n_steps`` K (even K = T), ``eta`` other than 1 or ``method='dpm2m'``:
      K jumps over ``strided_grid(T, K)``, ``method='ddim'`` with
      stochasticity ``eta`` or ``'dpm2m'``, DPM-Solver++(2M) (Lu et al.
      2022; deterministic, ``eta`` ignored). K = T with eta 1 is the dense
      sampler up to rounding.
    - ``clip_z`` > 0 clamps each step's state to [-clip_z, clip_z] and
      re-projects the coordinates to zero CoM; 0 leaves it untouched.
    - ``context`` [B, N, ctx] (a conditional model) goes to every denoiser
      call, each of which ``guided_eps`` guides with ``guidance_scale``.
    - ``compute_dtype`` (a name or ``ComputeSpec``, resolved here once by
      ``nn.core.resolve_compute``): the denoiser's operand dtype; under a
      ``full`` spec the last ``mixed_tail_steps`` steps and the final step
      run in f32.
    - ``keep_frames`` F (dense sampler only): also return the chain
      [F, B, N, D], slot k the state after step ``chain_slots(T, F)[k]``
      (unnormalised for the plain kind) and slot 0 the final (x, h_cat,
      h_int).

    Noise draws, in order: z_T (x, then h), one per step (none for dpm2m),
    the final step's."""
    if method not in ("ddim", "dpm2m"):
        raise ValueError(f"unknown sampling method {method!r}")
    gamma_fn = make_gamma_fn(cfg, node_mask.device if gamma is None else gamma)
    b = node_mask.shape[0]
    dev = node_mask.device

    def guard(z):
        if clip_z <= 0:
            return z
        zx = com.remove_mean_with_mask(
            torch.clamp(z[:, :, :cfg.n_dims], -clip_z, clip_z) * node_mask, node_mask)
        zh = torch.clamp(z[:, :, cfg.n_dims:], -clip_z, clip_z)
        return torch.cat([zx, zh], dim=2) * node_mask

    if fix_noise:
        z = sample_normal(noise, 0.0, 1.0, node_mask, cfg.n_dims, cfg.in_node_nf, True)
    else:
        z = sample_combined_position_feature_noise(noise, node_mask, cfg.n_dims, cfg.in_node_nf)
    T = cfg.timesteps
    K = T if n_steps is None else int(n_steps)
    if not 1 <= K <= T:
        raise ValueError(f"n_steps must be in [1, {T}], got {K}")
    strided = n_steps is not None or eta != 1.0 or method != "ddim"
    want_chain = keep_frames is not None
    if strided and want_chain:
        raise ValueError("chain visualization requires the dense sampler (n_steps=None, eta=1.0)")
    spec = resolve_compute(compute_dtype)
    tail = mixed_tail_steps(spec, K) if not want_chain else 0
    step_dtype = [spec.operand if k < K - tail else None for k in range(K)]

    def full(v):
        return torch.full((b, 1), v, dtype=torch.float32, device=dev)

    if strided:
        tau = strided_grid(T, K)
        grid = torch.tensor(tau, dtype=torch.float32) / T
        if method == "dpm2m":
            # Each jump t -> s evaluates x_pred once at level t and
            # extrapolates x(lambda) through the previous evaluation, lambda =
            # -gamma/2: h = lambda_s - lambda_t, c = h / (2 h_prev),
            #   D = (1 + c) x_t - c x_prev     (first jump: D = x_t)
            #   z_s = (sigma_s / sigma_t) z - alpha_s expm1(-h) D.
            x_prev = torch.zeros_like(z)
            h_prev = torch.ones((b, 1, 1), device=dev)
            not_first = torch.zeros((), device=dev)
            for k in range(K):
                s_arr, t_arr = full(float(grid[k + 1])), full(float(grid[k]))
                gamma_s, gamma_t = gamma_fn(s_arr), gamma_fn(t_arr)
                h = S.inflate(-0.5 * gamma_s, z.dim()) - S.inflate(-0.5 * gamma_t, z.dim())
                eps_t = guided_eps(dynamics, t_arr, z, node_mask, context, step_dtype[k],
                                   guidance_scale)
                x_t = compute_x_pred(eps_t, z, gamma_t)
                c = not_first * (h / (2.0 * h_prev))
                d = (1.0 + c) * x_t - c * x_prev
                z_s = (S.sigma(gamma_s, z.dim()) / S.sigma(gamma_t, z.dim())) * z \
                    - S.alpha(gamma_s, z.dim()) * torch.expm1(-h) * d
                z = guard(_project_x(z_s, node_mask, cfg.n_dims) * node_mask)
                x_prev, h_prev, not_first = x_t, h, torch.ones((), device=dev)
        else:
            for k in range(K):
                z = guard(sample_p_zs_given_zt_ddim(
                    dynamics, cfg, gamma_fn, noise, full(float(grid[k + 1])),
                    full(float(grid[k])), z, node_mask, eta, fix_noise, step_dtype[k],
                    context, guidance_scale))
    else:
        keep = {}
        slots = chain_slots(T, keep_frames) if want_chain else []
        for k, s_idx in enumerate(range(T - 1, -1, -1)):
            s_arr = torch.full((b, 1), s_idx, dtype=torch.float32, device=dev) / T
            t_arr = torch.full((b, 1), s_idx + 1, dtype=torch.float32, device=dev) / T
            z = guard(sample_p_zs_given_zt(dynamics, cfg, gamma_fn, noise, s_arr, t_arr, z,
                                           node_mask, fix_noise, step_dtype[k], context,
                                           guidance_scale))
            if s_idx in slots:
                keep[s_idx] = z if latent_space else unnormalize_z(cfg, z, node_mask)
        frames = [keep[s] for s in slots]
    final_dtype = None if tail > 0 else spec.operand
    x, h_cat, h_int = sample_p_xh_given_z0(dynamics, cfg, gamma_fn, noise, z, node_mask,
                                           fix_noise, final_dtype, context, guidance_scale,
                                           latent_space)
    # Final CoM-drift guard (reference: en_diffusion.py:789-793).
    x = com.remove_mean_with_mask(x * node_mask, node_mask)
    if want_chain:
        frames[0] = torch.cat([x, h_cat, h_int], dim=2)
        return (x, h_cat, h_int), torch.stack(frames)
    return x, h_cat, h_int


@torch.no_grad()
def log_info(gamma: nn.Module) -> dict:
    """log_SNR_max and log_SNR_min, -gamma(0) and -gamma(1), of the model's
    gamma module (vdm.py:816-824; en_diffusion.py:840-855)."""
    dev = next(iter(list(gamma.parameters()) + list(gamma.buffers()))).device
    zeros = torch.zeros((1, 1), dtype=torch.float32, device=dev)
    return {"log_SNR_max": float(-gamma(zeros).reshape(())),
            "log_SNR_min": float(-gamma(torch.ones_like(zeros)).reshape(()))}
