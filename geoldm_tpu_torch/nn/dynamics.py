"""Dynamics / encoder / decoder wrappers around the EGNN (port of
``geoldm_tpu/nn/dynamics.py``), named as upstream egnn/models.py.

- ``EGNNDynamics``: the denoiser. Appends the time channel to h, runs the
  EGNN (or, in the ``gnn_dynamics`` ablation, the GNN on [x, h]), returns
  [vel, h] with the velocity projected to the zero-CoM subspace (reference
  EGNN_dynamics_QM9, egnn/models.py:8-113).
- ``EGNNEncoder``: x, h -> the latent posterior's means and stds
  (reference EGNN_encoder_QM9, egnn/models.py:137-263).
- ``EGNNDecoder``: latent -> (x, h) (reference egnn/models.py:287-402).

The reference's NaN guards become branchless whole-tensor resets
(``_nan_reset``), so no step synchronises the host with the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from geoldm_tpu_torch.config import DynamicsConfig, EGNNConfig
from geoldm_tpu_torch.nn.core import linear
from geoldm_tpu_torch.nn.egnn import EGNN, GNN
from geoldm_tpu_torch.ops.com import remove_mean_with_mask


def _nan_reset(x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Replace the whole tensor by ``fill`` if it contains any NaN."""
    return torch.where(torch.isnan(x).any(), torch.full_like(x, fill), x)


class EGNNDynamics(nn.Module):
    """eps-prediction network (dynamics_apply, dynamics.py:87-143). Mode
    ``egnn_dynamics`` runs the EGNN (``egnn``) on (h, x); ``gnn_dynamics``
    (the ablation) runs the GNN (``gnn``) on [x, h] and reads the velocity
    from its first 3 output channels (dynamics.py:118-131)."""

    def __init__(self, cfg: DynamicsConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.mode == "egnn_dynamics":
            self.egnn = EGNN(cfg.egnn)
        elif cfg.mode == "gnn_dynamics":
            self.gnn = GNN(cfg.egnn)
        else:
            raise ValueError(f"unknown dynamics mode {cfg.mode!r}")

    def forward(self, t: torch.Tensor, xh: torch.Tensor, node_mask: torch.Tensor,
                context: Optional[torch.Tensor] = None, compute_dtype=None) -> torch.Tensor:
        """t [B, 1] (or a scalar), xh [B, N, 3 + F] -> [B, N, 3 + F].
        ``compute_dtype``: the EGNN's (``nn.egnn``); the rest stays f32."""
        cfg = self.cfg
        b, n, dims = xh.shape
        h_dims = dims - cfg.n_dims
        xh = xh * node_mask
        x = xh[..., :cfg.n_dims]
        h = xh[..., cfg.n_dims:] if h_dims else torch.ones((b, n, 1), dtype=xh.dtype,
                                                            device=xh.device)
        if cfg.condition_time:
            t = torch.as_tensor(t, dtype=xh.dtype, device=xh.device)
            h = torch.cat([h, t.reshape(-1, 1, 1).expand(b, n, 1)], dim=-1)
        if context is not None:
            h = torch.cat([h, context], dim=-1)

        if cfg.mode == "egnn_dynamics":
            h_final, x_final = self.egnn(h, x.contiguous(), node_mask, compute_dtype)
            vel = (x_final - x) * node_mask
        else:
            out = self.gnn(torch.cat([x, h], dim=-1), node_mask, compute_dtype)
            vel = out[..., :cfg.n_dims] * node_mask
            h_final = out[..., cfg.n_dims:]

        if context is not None:
            h_final = h_final[..., :h_final.shape[-1] - cfg.context_node_nf]
        if cfg.condition_time:
            h_final = h_final[..., :-1]
        vel = remove_mean_with_mask(_nan_reset(vel), node_mask)
        return vel if h_dims == 0 else torch.cat([vel, h_final], dim=-1)


class EGNNEncoder(nn.Module):
    """VAE encoder: one-block EGNN + final MLP to 2*latent_nf + 1
    (encoder_apply, dynamics.py:166-208)."""

    def __init__(self, cfg: EGNNConfig, latent_nf: int, n_dims: int = 3):
        super().__init__()
        self.latent_nf = latent_nf
        self.n_dims = n_dims
        self.egnn = EGNN(cfg)
        self.final_mlp = nn.Sequential(nn.Linear(cfg.hidden_nf, cfg.hidden_nf), nn.SiLU(),
                                       nn.Linear(cfg.hidden_nf, 2 * latent_nf + 1))

    def forward(self, xh: torch.Tensor, node_mask: torch.Tensor,
                context: Optional[torch.Tensor] = None, compute_dtype=None):
        """xh [B,N,3+F] -> (vel_mean [B,N,3], vel_std [B,1,1], h_mean [B,N,L],
        h_std [B,N,L]). vel_std is per molecule: its logit is summed over
        the nodes (reference egnn/models.py:240-245). ``compute_dtype``: the
        EGNN's and the final MLP's (``nn.egnn``)."""
        b, n, dims = xh.shape
        xh = xh * node_mask
        x = xh[..., :self.n_dims]
        h = xh[..., self.n_dims:] if dims > self.n_dims else torch.ones(
            (b, n, 1), dtype=xh.dtype, device=xh.device)
        if context is not None:
            h = torch.cat([h, context], dim=-1)
        h_final, x_final = self.egnn(h, x.contiguous(), node_mask, compute_dtype)
        vel = remove_mean_with_mask(_nan_reset(x_final * node_mask), node_mask)
        mlp, dt = self.final_mlp, compute_dtype
        h_final = linear(mlp[2], F.silu(linear(mlp[0], h_final, dt)), dt) * node_mask
        vel_std = torch.exp(0.5 * h_final[..., :1].sum(dim=1, keepdim=True))  # [B,1,1]
        h_mean = h_final[..., 1:1 + self.latent_nf]
        h_std = torch.exp(0.5 * h_final[..., 1 + self.latent_nf:])
        return vel, _nan_reset(vel_std, 1.0), h_mean, _nan_reset(h_std, 1.0)


class EGNNDecoder(nn.Module):
    """latent [B,N,3+latent_nf] -> (x [B,N,3], h [B,N,out]) (decoder_apply,
    dynamics.py:220-247)."""

    def __init__(self, cfg: EGNNConfig, n_dims: int = 3):
        super().__init__()
        self.n_dims = n_dims
        self.egnn = EGNN(cfg)

    def forward(self, z_xh: torch.Tensor, node_mask: torch.Tensor,
                context: Optional[torch.Tensor] = None, compute_dtype=None):
        b, n, dims = z_xh.shape
        z_xh = z_xh * node_mask
        x = z_xh[..., :self.n_dims]
        h = z_xh[..., self.n_dims:] if dims > self.n_dims else torch.ones(
            (b, n, 1), dtype=z_xh.dtype, device=z_xh.device)
        if context is not None:
            h = torch.cat([h, context], dim=-1)
        h_final, x_final = self.egnn(h, x.contiguous(), node_mask, compute_dtype)
        vel = remove_mean_with_mask(_nan_reset(x_final * node_mask), node_mask)
        return vel, h_final * node_mask
