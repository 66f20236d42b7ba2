"""Plain PyTorch GeoLDM: the state-dict layout, the noise schedule and the
forward passes of the E(n) EGNN, the VAE's encoder and decoder and the
denoiser, written from the published model (GeoLDM, arXiv:2305.01140;
upstream egnn/egnn_new.py, egnn/models.py, equivariant_diffusion/en_diffusion.py).

Functional: every function takes the state dict ``P`` (name -> tensor, the
upstream layout) and a model description ``M`` (``describe``). Pairwise
quantities are dense [B, N, N, *] tensors and the first edge layer takes the
concatenation [h_i, h_j, e_ij], as upstream builds it. ``q`` rounds the
operands of every matrix product (None: float32, the reference; a lower
precision: the correctness check's control). Imports nothing but torch and
numpy.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


# ---------------------------------------------------------------------------
# The model description and the state-dict layout
# ---------------------------------------------------------------------------


def describe(cfg: dict) -> dict:
    """The widths of each EGNN of the latent diffusion model a configuration
    file states (upstream qm9/models.py): the encoder (one layer), the
    decoder and the denoiser, each ``n_layers`` deep."""
    nc = len(cfg["data"]["atom_decoder"])
    inc = int(cfg["include_charges"])
    in_nf = nc + inc
    lat = cfg["latent_nf"]
    nf = cfg["nf"]
    common = dict(hidden=nf, attention=cfg["attention"], tanh=cfg["tanh"], coords_range=15.0,
                  norm_constant=cfg["norm_constant"],
                  normalization_factor=cfg["normalization_factor"])
    return {
        "n_classes": nc, "include_charges": bool(inc), "in_node_nf": in_nf, "latent_nf": lat,
        "T": cfg["diffusion_steps"], "schedule": cfg["diffusion_noise_schedule"],
        "precision": cfg["diffusion_noise_precision"],
        "norm_values": tuple(float(v) for v in cfg["normalize_factors"]),
        "encoder_sigma": 0.0032,
        "encoder": dict(common, in_nf=in_nf, out_nf=nf, layers=1),
        "decoder": dict(common, in_nf=lat, out_nf=in_nf, layers=cfg["n_layers"]),
        "dynamics": dict(common, in_nf=lat + 1, out_nf=lat + 1, layers=cfg["n_layers"]),
    }


def _egnn_specs(prefix: str, e: dict) -> List[Tuple[str, tuple, str]]:
    nf = e["hidden"]
    edge_in = 2 * nf + 2
    out = [(f"{prefix}embedding.weight", (nf, e["in_nf"]), "w"),
           (f"{prefix}embedding.bias", (nf,), "b"),
           (f"{prefix}embedding_out.weight", (e["out_nf"], nf), "w"),
           (f"{prefix}embedding_out.bias", (e["out_nf"],), "b")]
    for i in range(e["layers"]):
        b = f"{prefix}e_block_{i}."
        out += [(b + "gcl_0.edge_mlp.0.weight", (nf, edge_in), "w"),
                (b + "gcl_0.edge_mlp.0.bias", (nf,), "b"),
                (b + "gcl_0.edge_mlp.2.weight", (nf, nf), "w"),
                (b + "gcl_0.edge_mlp.2.bias", (nf,), "b"),
                (b + "gcl_0.node_mlp.0.weight", (nf, 2 * nf), "w"),
                (b + "gcl_0.node_mlp.0.bias", (nf,), "b"),
                (b + "gcl_0.node_mlp.2.weight", (nf, nf), "w"),
                (b + "gcl_0.node_mlp.2.bias", (nf,), "b")]
        if e["attention"]:
            out += [(b + "gcl_0.att_mlp.0.weight", (1, nf), "w"),
                    (b + "gcl_0.att_mlp.0.bias", (1,), "b")]
        out += [(b + "gcl_equiv.coord_mlp.0.weight", (nf, edge_in), "w"),
                (b + "gcl_equiv.coord_mlp.0.bias", (nf,), "b"),
                (b + "gcl_equiv.coord_mlp.2.weight", (nf, nf), "w"),
                (b + "gcl_equiv.coord_mlp.2.bias", (nf,), "b"),
                (b + "gcl_equiv.coord_mlp.4.weight", (1, nf), "xavier")]
    return out


def param_specs(M: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter in upstream's state-dict order;
    init 'w' / 'b' is torch's Linear default U(-1/sqrt(fan_in), ...), 'xavier'
    the coordinate MLP's last layer, xavier-uniform with gain 0.001
    (egnn_new.py:75-76)."""
    nf = M["dynamics"]["hidden"]
    lat = M["latent_nf"]
    return (_egnn_specs("dynamics.egnn.", M["dynamics"])
            + _egnn_specs("vae.encoder.egnn.", M["encoder"])
            + [("vae.encoder.final_mlp.0.weight", (nf, nf), "w"),
               ("vae.encoder.final_mlp.0.bias", (nf,), "b"),
               ("vae.encoder.final_mlp.2.weight", (2 * lat + 1, nf), "w"),
               ("vae.encoder.final_mlp.2.bias", (2 * lat + 1,), "b")]
            + _egnn_specs("vae.decoder.egnn.", M["decoder"]))


def init_bounds(specs) -> List[float]:
    """The half-width of each parameter's uniform init (``param_specs``)."""
    out = []
    weight_fan_in = {}
    for name, shape, kind in specs:
        if kind == "w":
            weight_fan_in[name.rsplit(".", 1)[0]] = shape[1]
            out.append(1.0 / math.sqrt(shape[1]))
        elif kind == "b":
            out.append(1.0 / math.sqrt(weight_fan_in[name.rsplit(".", 1)[0]]))
        else:
            out.append(0.001 * math.sqrt(6.0 / (shape[0] + shape[1])))
    return out


def gamma_table(M: dict) -> np.ndarray:
    """gamma(t) at t = 0, 1/T, ..., 1 of the 'polynomial_<power>' schedule
    (en_diffusion.py:23-52, :176-203), float64."""
    kind, power = M["schedule"].split("_")
    if kind != "polynomial":
        raise ValueError(f"the reference implements the polynomial schedules, not {kind}")
    T, s = M["T"], M["precision"]
    steps = T + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1 - np.power(x / steps, float(power))) ** 2
    alphas2 = np.concatenate([np.ones(1), alphas2])
    step = np.clip(alphas2[1:] / alphas2[:-1], 0.001, 1.0)
    alphas2 = (1 - 2 * s) * np.cumprod(step) + s
    return -(np.log(alphas2) - np.log(1 - alphas2))


def buffers(M: dict, device) -> Dict[str, torch.Tensor]:
    """The state dict's buffers: the schedule's table and two placeholders."""
    return {"buffer": torch.zeros(1, device=device),
            "gamma.gamma": torch.tensor(gamma_table(M), dtype=torch.float32, device=device),
            "vae.buffer": torch.zeros(1, device=device)}


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def linear(P, name: str, x: torch.Tensor, q: Quant = None) -> torch.Tensor:
    w = P[name + ".weight"]
    if q is not None:
        x, w = q(x), q(w)
    y = x @ w.T
    b = P.get(name + ".bias")
    return y if b is None else y + b


def remove_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x minus its mean over the real atoms, masked ([B, N, D], [B, N, 1])."""
    return x - x.sum(1, keepdim=True) / mask.sum(1, keepdim=True) * mask


def _sq_dist(x: torch.Tensor):
    diff = x[:, :, None, :] - x[:, None, :, :]
    return (diff * diff).sum(-1, keepdim=True), diff


def _pairs(h: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    b, n, f = h.shape
    return torch.cat([h[:, :, None, :].expand(b, n, n, f), h[:, None, :, :].expand(b, n, n, f),
                      e], dim=-1)


def egnn(P, prefix: str, E: dict, h, x, mask, q: Quant = None):
    """The E(n) EGNN (egnn_new.py:108-197): embedding, ``layers`` blocks of one
    GCL and one equivariant coordinate update, embedding_out. -> (h, x)."""
    n = h.shape[1]
    eye = torch.eye(n, dtype=mask.dtype, device=mask.device)[None, :, :, None]
    edge_mask = mask[:, :, None, :] * mask[:, None, :, :] * (1.0 - eye)
    radial0, _ = _sq_dist(x)
    norm_f = E["normalization_factor"]
    h = linear(P, prefix + "embedding", h, q)
    for i in range(E["layers"]):
        b = f"{prefix}e_block_{i}."
        radial, diff = _sq_dist(x)
        coord_diff = diff / (torch.sqrt(radial + 1e-8) + E["norm_constant"])
        e = torch.cat([radial, radial0], dim=-1)
        m = F.silu(linear(P, b + "gcl_0.edge_mlp.0", _pairs(h, e), q))
        m = F.silu(linear(P, b + "gcl_0.edge_mlp.2", m, q))
        if E["attention"]:
            m = m * torch.sigmoid(linear(P, b + "gcl_0.att_mlp.0", m, q))
        agg = (m * edge_mask).sum(2) / norm_f
        upd = linear(P, b + "gcl_0.node_mlp.2",
                     F.silu(linear(P, b + "gcl_0.node_mlp.0", torch.cat([h, agg], -1), q)), q)
        h = (h + upd) * mask
        c = F.silu(linear(P, b + "gcl_equiv.coord_mlp.0", _pairs(h, e), q))
        c = F.silu(linear(P, b + "gcl_equiv.coord_mlp.2", c, q))
        s = linear(P, b + "gcl_equiv.coord_mlp.4", c, q)
        if E["tanh"]:
            s = torch.tanh(s) * E["coords_range"]
        x = (x + (coord_diff * s * edge_mask).sum(2) / norm_f) * mask
        h = h * mask
    return linear(P, prefix + "embedding_out", h, q) * mask, x


def encode(P, M, x, h, mask, q: Quant = None):
    """The VAE encoder's posterior means (egnn/models.py:137-263) -> (z_x
    [B,N,3], z_h [B,N,L])."""
    h_out, x_out = egnn(P, "vae.encoder.egnn.", M["encoder"], h * mask, x * mask, mask, q)
    z_x = remove_mean(x_out * mask, mask)
    f = linear(P, "vae.encoder.final_mlp.2",
               F.silu(linear(P, "vae.encoder.final_mlp.0", h_out, q)), q) * mask
    return z_x, f[..., 1:1 + M["latent_nf"]]


def decode(P, M, z_x, z_h, mask, q: Quant = None):
    """The VAE decoder (egnn/models.py:287-402) -> (x [B,N,3], h [B,N,in_nf]:
    the atom-type logits, then the charge)."""
    h_out, x_out = egnn(P, "vae.decoder.egnn.", M["decoder"], z_h * mask, z_x * mask, mask, q)
    return remove_mean(x_out * mask, mask), h_out * mask


def dynamics(P, M, t, z, mask, q: Quant = None):
    """The denoiser eps(z_t, t) (egnn/models.py:8-113): the time as one more
    node feature, the velocity projected to zero centre of mass."""
    b, n, _ = z.shape
    z = z * mask
    x, h = z[..., :3], z[..., 3:]
    h = torch.cat([h, t.reshape(b, 1, 1).expand(b, n, 1).to(z.dtype)], dim=-1)
    h_out, x_out = egnn(P, "dynamics.egnn.", M["dynamics"], h, x, mask, q)
    vel = remove_mean((x_out - x) * mask, mask)
    return torch.cat([vel, h_out[..., :-1]], dim=-1)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude mapped to 448, e4m3's largest finite value), back in float32:
    the operands of an fp8 product with float32 accumulation."""
    amax = t.detach().abs().amax().clamp(min=1e-12)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero as the tensor cores' conversion), back in float32: the operands of
    a TF32 product with float32 accumulation."""
    bits = t.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (rounded - t).detach()
