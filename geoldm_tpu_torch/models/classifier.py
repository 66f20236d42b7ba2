"""EGNN property regressor, the classifier that scores conditional
generation (port of ``geoldm_tpu/models/classifier.py``; reference
qm9/property_prediction/models_property.py:6-160, whose module names it
keeps: ``embedding``, ``gcl_{i}.edge_mlp.{0,2}``, ``gcl_{i}.node_mlp.{0,2}``,
``gcl_{i}.att_mlp.0``, ``node_dec.{0,2}``, ``graph_dec.{0,2}``).

Unlike the generative EGNN it updates no coordinates, takes the raw squared
distance as its only edge feature, sums messages plainly (no normalization
factor), adds each layer's output to its input (recurrent residual) and
optionally feeds the input features h0 to every node MLP (``node_attr``).
Readout: ``node_dec`` -> masked sum over the atoms -> ``graph_dec`` -> one
scalar per molecule. Dense masked tensors, plain PyTorch (the JAX model has
no kernel); ``compute_dtype`` rounds every product's operands as
``nn.core.linear`` does. Baselines: ``NaiveRegressor`` (a constant) and
``NumNodesRegressor`` (an MLP of the atom count).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from geoldm_tpu_torch.nn.core import linear, resolve_compute, round_operand
from geoldm_tpu_torch.ops.distance import coord2diff
from geoldm_tpu_torch.utils.device import resolve_device


class _GCLMask(nn.Module):
    """One E_GCL_mask layer (models_property.py:6-40)."""

    def __init__(self, hidden_nf: int, node_attr_nf: int, attention: bool):
        super().__init__()
        self.edge_mlp = nn.Sequential(nn.Linear(2 * hidden_nf + 1, hidden_nf), nn.SiLU(),
                                      nn.Linear(hidden_nf, hidden_nf), nn.SiLU())
        self.node_mlp = nn.Sequential(nn.Linear(2 * hidden_nf + node_attr_nf, hidden_nf),
                                      nn.SiLU(), nn.Linear(hidden_nf, hidden_nf))
        self.att_mlp = (nn.Sequential(nn.Linear(hidden_nf, 1), nn.Sigmoid()) if attention
                        else None)

    def forward(self, h, h0, radial, edge_mask, node_attr: bool, dt):
        f = h.shape[-1]
        w = self.edge_mlp[0].weight  # [H, 2H + 1]: source, target, radial
        hr, wr = round_operand(h, dt), round_operand(w, dt)
        src, dst = F.linear(hr, wr[:, :f]), F.linear(hr, wr[:, f:2 * f])
        pre = (src[:, :, None, :] + dst[:, None, :, :]
               + F.linear(round_operand(radial, dt), wr[:, 2 * f:]) + self.edge_mlp[0].bias)
        m = F.silu(linear(self.edge_mlp[2], F.silu(pre), dt))
        if self.att_mlp is not None:
            m = m * torch.sigmoid(linear(self.att_mlp[0], m, dt))
        agg = (m * edge_mask).sum(dim=2)  # plain segment sum
        node_in = torch.cat([h, agg, h0] if node_attr else [h, agg], dim=-1)
        return h + linear(self.node_mlp[2], F.silu(linear(self.node_mlp[0], node_in, dt)), dt)


class PropertyClassifier(nn.Module):
    """h0 [B,N,F0], x [B,N,3], node_mask [B,N,1], edge_mask [B,N,N,1] ->
    the normalized property [B] (models_property.py:89-129)."""

    def __init__(self, in_node_nf: int = 5, hidden_nf: int = 128, n_layers: int = 7,
                 attention: bool = True, node_attr: bool = False):
        super().__init__()
        self.node_attr = node_attr
        self.n_layers = n_layers
        self.embedding = nn.Linear(in_node_nf, hidden_nf)
        for i in range(n_layers):
            self.add_module(f"gcl_{i}", _GCLMask(hidden_nf, in_node_nf if node_attr else 0,
                                                 attention))
        self.node_dec = nn.Sequential(nn.Linear(hidden_nf, hidden_nf), nn.SiLU(),
                                      nn.Linear(hidden_nf, hidden_nf))
        self.graph_dec = nn.Sequential(nn.Linear(hidden_nf, hidden_nf), nn.SiLU(),
                                       nn.Linear(hidden_nf, 1))

    def forward(self, h0, x, node_mask, edge_mask, compute_dtype=None):
        dt = resolve_compute(compute_dtype).dtype
        radial, _ = coord2diff(x)
        h = linear(self.embedding, h0, dt)
        for i in range(self.n_layers):
            h = getattr(self, f"gcl_{i}")(h, h0, radial, edge_mask, self.node_attr, dt)
        h = linear(self.node_dec[2], F.silu(linear(self.node_dec[0], h, dt)), dt) * node_mask
        pooled = h.sum(dim=1)
        return linear(self.graph_dec[2], F.silu(linear(self.graph_dec[0], pooled, dt)), dt)[:, 0]


class NaiveRegressor(nn.Module):
    """A constant: one linear map of zero (models_property.py:133-145)."""

    def __init__(self):
        super().__init__()
        self.linear = nn.Linear(1, 1)

    def forward(self, h0, x, node_mask, edge_mask, compute_dtype=None):
        return self.linear(torch.zeros((node_mask.shape[0], 1), device=node_mask.device))[:, 0]


class NumNodesRegressor(nn.Module):
    """An MLP of the atom count / 29 (models_property.py:148-160)."""

    def __init__(self, nf: int = 128):
        super().__init__()
        self.linear1 = nn.Linear(1, nf)
        self.linear2 = nn.Linear(nf, 1)

    def forward(self, h0, x, node_mask, edge_mask, compute_dtype=None):
        n = node_mask[..., 0].sum(dim=1, keepdim=True) / 29.0
        return self.linear2(F.silu(self.linear1(n)))[:, 0]


def build_classifier(model_name: str = "egnn", in_node_nf: int = 5, hidden_nf: int = 128,
                     n_layers: int = 7, attention: bool = True, node_attr: bool = False,
                     device="cuda", generator: Optional[torch.Generator] = None) -> nn.Module:
    """A classifier (``egnn``) or baseline (``naive``, ``numnodes``) on
    ``device`` (the card unless the caller asks for the CPU), its weights
    drawn from ``generator`` as ``nn.Linear`` draws them by default."""
    if model_name == "naive":
        model = NaiveRegressor()
    elif model_name == "numnodes":
        model = NumNodesRegressor(hidden_nf)
    elif model_name == "egnn":
        model = PropertyClassifier(in_node_nf, hidden_nf, n_layers, attention, node_attr)
    else:
        raise ValueError(f"unknown classifier {model_name!r}")
    if generator is not None:
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, nn.Linear):
                    bound = 1.0 / mod.in_features ** 0.5
                    mod.weight.uniform_(-bound, bound, generator=generator)
                    mod.bias.uniform_(-bound, bound, generator=generator)
    return model.to(resolve_device(device))
