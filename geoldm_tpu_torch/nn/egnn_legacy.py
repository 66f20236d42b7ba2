"""The legacy EGNN: a coordinate update inside every layer (port of
``geoldm_tpu/nn/egnn_legacy.py``; reference egnn/egnn.py:7-152, ``E_GCL`` and
``EGNN``), named as upstream: ``embedding``, ``embedding_out``,
``gcl_{i}.edge_mlp.{0,2}``, ``node_mlp.{0,2}``, ``coord_mlp.{0,2}``,
``att_mlp.0``.

Each layer runs its edge MLP over [h_i, h_j, d_ij^2, e_ij] (the raw squared
distance of the current coordinates and, as the edge attribute, the input
coordinates' one), then the coordinate update, whose tanh range is
``coords_range / n_layers`` (x19 under 'mean' aggregation), then the node
MLP with a residual over a plain neighbour sum. The JAX package keeps it for
its library surface and ablations, outside any Pallas kernel, so it is a
plain PyTorch module here too, dense over [B, N, N, *].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.nn.core import linear
from geoldm_tpu_torch.nn.egnn import _pair_first_layer
from geoldm_tpu_torch.ops.distance import coord2diff


class LegacyGCL(nn.Module):
    """One ``E_GCL`` layer (reference egnn/egnn.py:7-103)."""

    def __init__(self, cfg: EGNNConfig, edges_in_d: int = 1):
        super().__init__()
        nf = cfg.hidden_nf
        self.cfg = cfg
        self.edge_mlp = nn.Sequential(nn.Linear(2 * nf + 1 + edges_in_d, nf), nn.SiLU(),
                                      nn.Linear(nf, nf), nn.SiLU())
        self.node_mlp = nn.Sequential(nn.Linear(2 * nf, nf), nn.SiLU(), nn.Linear(nf, nf))
        self.coord_mlp = nn.Sequential(nn.Linear(nf, nf), nn.SiLU(), nn.Linear(nf, 1, bias=False))
        if cfg.attention:
            self.att_mlp = nn.Sequential(nn.Linear(nf, 1), nn.Sigmoid())

    def forward(self, h, x, edge_attr, node_mask, edge_mask, compute_dtype=None):
        cfg, dt = self.cfg, compute_dtype
        radial, coord_diff = coord2diff(x, cfg.norm_constant)
        pre = _pair_first_layer(self.edge_mlp[0], h, torch.cat([radial, edge_attr], dim=-1), dt)
        m = F.silu(linear(self.edge_mlp[2], F.silu(pre), dt))
        if cfg.attention:
            m = m * torch.sigmoid(linear(self.att_mlp[0], m, dt))
        if edge_mask is not None:
            m = m * edge_mask

        coords_range = cfg.coords_range / max(cfg.n_layers, 1)
        if cfg.aggregation_method == "mean":
            coords_range = coords_range * 19
        s = linear(self.coord_mlp[2], F.silu(linear(self.coord_mlp[0], m, dt)), dt)
        if cfg.tanh:
            s = torch.tanh(s) * coords_range
        trans = coord_diff * s
        if edge_mask is not None:
            trans = trans * edge_mask
        x = x + trans.sum(dim=2)

        node_in = torch.cat([h, m.sum(dim=2)], dim=-1)
        h = h + linear(self.node_mlp[2], F.silu(linear(self.node_mlp[0], node_in, dt)), dt)
        if node_mask is not None:
            h, x = h * node_mask, x * node_mask
        return h, x


class LegacyEGNN(nn.Module):
    """The legacy EGNN (reference egnn/egnn.py:106-152; ``legacy_egnn_init``
    / ``legacy_egnn_apply``). h [B,N,in_node_nf], x [B,N,3], node_mask
    [B,N,1] or None, edge_mask [B,N,N,1] or None -> (h [B,N,out_node_nf],
    x [B,N,3]). ``compute_dtype``: None or ``torch.bfloat16``, the linear
    layers' operand dtype."""

    def __init__(self, cfg: EGNNConfig, in_edge_nf: int = 1):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Linear(cfg.in_node_nf, cfg.hidden_nf)
        self.embedding_out = nn.Linear(cfg.hidden_nf, cfg.out_node_nf)
        for i in range(cfg.n_layers):
            self.add_module(f"gcl_{i}", LegacyGCL(cfg, in_edge_nf))

    def forward(self, h, x, node_mask: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None, compute_dtype=None):
        radial0, _ = coord2diff(x)
        h = linear(self.embedding, h, compute_dtype)
        for i in range(self.cfg.n_layers):
            h, x = getattr(self, f"gcl_{i}")(h, x, radial0, node_mask, edge_mask, compute_dtype)
        h = linear(self.embedding_out, h, compute_dtype)
        if node_mask is not None:
            h = h * node_mask
        return h, x
