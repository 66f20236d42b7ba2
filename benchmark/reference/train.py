"""Plain PyTorch GeoLDM training: the latent diffusion loss with a trainable
decoder (GeoLDM's QM9 and GEOM-Drugs recipes: l2 loss, ``trainable_ae``),
the adaptive gradient clip, AMSGrad with decoupled weight decay and the
EMA, written from upstream (en_diffusion.py:1125-1191, utils.py:30-66,
torch.optim.AdamW's published algorithm, equivariant_diffusion/utils.py:5-18).

``follow`` takes the benchmark's initial state dict, batches and noise seed
and runs the first steps of training, in blocks of molecules so that a
GEOM-sized batch fits: the gradient of the batch mean is the sum of each
block's. Its draws replay a ``torch.Generator`` in the order GeoLDM's
training step draws: per step the encoder's noise (coordinates, then
latent features), the timestep, the diffusion noise (coordinates, then
features), each at the whole batch's shape.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from reference import model as R


def draw_step_noise(gen: torch.Generator, b: int, n: int, lat: int, T: int, device) -> dict:
    """One train step's draws at the batch's shape, in GeoLDM's order."""
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    return {"enc_x": torch.randn((b, n, 3), **kw), "enc_h": torch.randn((b, n, lat), **kw),
            "t": torch.randint(0, T + 1, (b, 1), generator=gen, device=device),
            "eps_x": torch.randn((b, n, 3), **kw), "eps_h": torch.randn((b, n, lat), **kw)}


def step_nll(P, M, batch: dict, draws: dict, q=None) -> torch.Tensor:
    """The training loss's per-molecule term, nll - log p(N) ([B]), of a
    block of molecules (GeoLDM's EnLatentDiffusion.forward with l2 training
    and a trainable decoder)."""
    x, h_cat, h_int, mask = batch["x"], batch["h_cat"], batch["h_int"], batch["mask"]
    b, n, _ = x.shape
    lat = M["latent_nf"]
    gamma = P["gamma.gamma"]
    with torch.no_grad():  # the latent is detached: the encoder gets no gradient
        z_x, z_h = R.encode(P, M, x, torch.cat([h_cat, h_int], -1), mask, q)
        sigma0 = torch.sqrt(torch.sigmoid(gamma[0]))
        ex = R.remove_mean(draws["enc_x"] * mask, mask)
        eh = draws["enc_h"] * mask
        z_x = z_x + sigma0 * ex
        z_h = z_h + sigma0 * eh
    # Reconstruction through the decoder, normalised per entry when training.
    x_rec, h_rec = R.decode(P, M, z_x, z_h, mask, q)
    nc = M["n_classes"]
    err = ((x_rec - x) ** 2).reshape(b, -1).sum(-1)
    logp = torch.log_softmax(h_rec[..., :nc], dim=-1)
    labels = h_cat.argmax(-1)
    err = err - logp.gather(-1, labels[..., None])[..., 0].sum(1)
    if M["include_charges"]:
        err = err + ((h_rec[..., -1:] - h_int) ** 2).reshape(b, -1).sum(-1)
    recon = err / ((3 + M["in_node_nf"]) * n)
    # Diffusion in latent space at a timestep t in {0, ..., T}.
    t_int = draws["t"]
    g_t = gamma[t_int.reshape(-1)].reshape(b, 1, 1)
    alpha_t = torch.sqrt(torch.sigmoid(-g_t))
    sigma_t = torch.sqrt(torch.sigmoid(g_t))
    eps = torch.cat([R.remove_mean(draws["eps_x"] * mask, mask), draws["eps_h"] * mask], -1)
    z = torch.cat([z_x, z_h], -1)
    z_t = alpha_t * z + sigma_t * eps
    t = (t_int.to(torch.float32) / M["T"]).reshape(b, 1)
    eps_hat = R.dynamics(P, M, t, z_t, mask, q)
    diff_err = ((eps - eps_hat) ** 2).reshape(b, -1).sum(-1) / ((3 + lat) * n)
    # KL of q(z_T | z) against N(0, I): x on the zero-CoM subspace.
    g_T = gamma[-1]
    mu_T = torch.sqrt(torch.sigmoid(-g_T)) * z
    s_T = torch.sqrt(torch.sigmoid(g_T))
    kl_h = ((torch.log(1.0 / (s_T + 1e-8) + 1e-8) + 0.5 * (s_T * s_T + mu_T[..., 3:] ** 2) - 0.5)
            * mask).reshape(b, -1).sum(-1)
    d = (mask.reshape(b, -1).sum(-1) - 1.0) * 3
    kl_x = (d * torch.log(1.0 / (s_T + 1e-8) + 1e-8)
            + 0.5 * (d * s_T * s_T + (mu_T[..., :3] ** 2).reshape(b, -1).sum(-1)) - 0.5 * d)
    return kl_x + kl_h + 0.5 * diff_err + recon - batch["log_pN"]


class Clip:
    """Adaptive clipping at 1.5 mean + 2 std of the last 50 recorded norms,
    the record seeded with 3000 (upstream utils.py:30-66)."""

    def __init__(self):
        self.norms = [3000.0]

    def __call__(self, grads: List[torch.Tensor]) -> float:
        norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
        mean = sum(self.norms) / len(self.norms)
        std = math.sqrt(max(sum((v - mean) ** 2 for v in self.norms) / len(self.norms), 0.0))
        limit = 1.5 * mean + 2.0 * std
        scale = min(limit / (norm + 1e-12), 1.0)
        for g in grads:
            g.mul_(scale)
        self.norms = (self.norms + [min(norm, limit)])[-50:]
        return norm


def amsgrad(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: dict,
            step: int, lr: float, wd: float = 1e-12, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8) -> None:
    """One AdamW step with AMSGrad (torch.optim.AdamW's algorithm) on every
    parameter that has a gradient."""
    for name, g in grads.items():
        p = params[name]
        s = state.setdefault(name, {"m": torch.zeros_like(p), "v": torch.zeros_like(p),
                                    "vmax": torch.zeros_like(p)})
        p.mul_(1.0 - lr * wd)
        s["m"].mul_(b1).add_(g, alpha=1.0 - b1)
        s["v"].mul_(b2).addcmul_(g, g, value=1.0 - b2)
        torch.maximum(s["vmax"], s["v"], out=s["vmax"])
        denom = s["vmax"].sqrt() / math.sqrt(1.0 - b2 ** step) + eps
        p.addcdiv_(s["m"], denom, value=-lr / (1.0 - b1 ** step))


def _rows(batch: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in batch.items()}


def follow(P0: Dict[str, torch.Tensor], M: dict, trainable: List[str], batches: List[dict],
           noise_seed: int, lr: float, ema_decay: float, block: int, q=None) -> dict:
    """Train from the state dict ``P0`` on ``batches`` (each on the device:
    x, h_cat, h_int, mask, log_pN) with the draws of a generator seeded with
    ``noise_seed``. -> {"losses": per step, "grad1": the first step's
    clipped gradient (name -> tensor), "change": parameter minus initial
    after the last step, "ema_change": EMA minus initial}. ``trainable``:
    the parameters that get a gradient. ``q``: the products' operand
    rounding (None: float32)."""
    device = next(iter(P0.values())).device
    P = {k: v.detach().clone() for k, v in P0.items()}
    ema = {k: P0[k].detach().clone() for k in trainable}
    gen = torch.Generator(device=device).manual_seed(int(noise_seed))
    clip, opt = Clip(), {}
    out = {"losses": []}
    for k, batch in enumerate(batches):
        b, n = batch["x"].shape[:2]
        draws = draw_step_noise(gen, b, n, M["latent_nf"], M["T"], device)
        leaves = {name: P[name].detach().requires_grad_() for name in trainable}
        Pg = dict(P, **leaves)
        grads = {}
        total = 0.0
        for lo in range(0, b, block):
            hi = min(lo + block, b)
            term = step_nll(Pg, M, _rows(batch, lo, hi), _rows(draws, lo, hi), q).sum() / b
            gs = torch.autograd.grad(term, [leaves[nm] for nm in trainable], allow_unused=True)
            for nm, g in zip(trainable, gs):
                if g is not None:
                    grads[nm] = grads[nm] + g if nm in grads else g
            total += float(term.detach())
        out["losses"].append(total)
        # The encoder's parameters get none: its latent is detached.
        used = {nm: grads[nm] for nm in trainable if nm in grads}
        clip(list(used.values()))
        if k == 0:
            out["grad1"] = {nm: g.clone() for nm, g in used.items()}
        with torch.no_grad():
            amsgrad(P, used, opt, k + 1, lr)
            for nm in ema:
                ema[nm].mul_(ema_decay).add_(P[nm], alpha=1.0 - ema_decay)
    out["clip_norms"] = list(clip.norms)
    out["change"] = {nm: P[nm] - P0[nm] for nm in trainable}
    out["ema_change"] = {nm: ema[nm] - P0[nm] for nm in trainable}
    return out
