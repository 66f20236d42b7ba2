"""Dense-masked E(n)-equivariant GNN as ``nn.Module``s (port of
``geoldm_tpu/nn/egnn.py:109-302``), and the non-equivariant ``GNN`` of the
``gnn_dynamics`` ablation (its GCLs without edge features, plain PyTorch
ops: JAX runs it outside any Pallas kernel).

Modules and parameters carry the upstream GeoLDM names
(egnn/egnn_new.py: ``e_block_{i}.gcl_{j}.edge_mlp.{0,2}``, ``att_mlp.0``,
``node_mlp.{0,2}``, ``gcl_equiv.coord_mlp.{0,2,4}``, ``embedding``,
``embedding_out``), so upstream state dicts load with ``strict=True``.

Node tensors stay ``[B, N, F]``; pairwise quantities are dense
``[B, N, N, *]``. The first edge-MLP layer is split into source/target/edge
weight slices instead of materialising the ``[h_i, h_j, e_ij]`` concat.
``EGNN.forward`` runs each block through ``ops.egnn_block.block_forward``,
which routes by the padded node count N: N <= 64 (QM9, GEOM's 32/48/64
buckets) to the whole-block CUDA kernels, N > 64 (GEOM's 96/136/184) to the
row-tiled GCL and coordinate kernels of ``ops.egnn_tiled``; on the CPU each
route runs its plain PyTorch version. Under grad each route goes through its
autograd Function, whose backward is a kernel too (#2, #5). An EGNN attached
to a sequence-parallel group (``parallel.sp.attach``) runs its blocks over
its rank's slab of rows instead (``parallel.sp.egnn_forward_sp``: kernels #6
and #7).

``compute_dtype`` ``torch.bfloat16`` (a name resolved by the sampler, the
NLL or the train step, ``nn.core``) selects the bf16 variants: every linear
layer's operands rounded to bf16, f32 accumulation (JAX's ``linear`` /
``_matmul`` under a bf16 compute dtype); each block runs the bf16 variants
of kernels #1, #3 and #4 (#6 under sequence parallelism) on the card, and
under grad their bf16 backwards #2, #5 (#7), the modules' forwards with
``compute_dtype=torch.bfloat16`` and autograd on the CPU. Each product
rounds its own operands, as JAX's ``_matmul`` does, so the gradient it
returns to each is rounded on its own.

``BF16_EDGE_LOWP`` (``bfloat16_pallas`` under GEOLDM_PALLAS_EDGE_LOWP=1,
``nn.core``) is ``torch.bfloat16`` everywhere but in a block that
``ops.egnn_block`` keeps whole as JAX's Pallas path does: there the GCL's
and the coordinate update's edge chain run in bf16 as ``_block_math``'s
with ``edge_dtype`` bf16 (``pallas_egnn.py:160-228``; ``_lowp_*`` below, the
plain version of kernels #1/#2's low-precision variants). The GNN, the
sequence-parallel route and the row-tiled blocks take it as
``torch.bfloat16``, as JAX never reads the switch there.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.nn.core import BF16_EDGE_LOWP, linear, operand_dtype, round_operand
from geoldm_tpu_torch.ops import egnn_block
from geoldm_tpu_torch.ops.distance import build_edge_mask, coord2diff, sin_embedding


def _pair_first_layer(lin: nn.Linear, h: torch.Tensor, edge_attr: Optional[torch.Tensor],
                      dtype: Optional[torch.dtype] = None):
    """lin([h_i, h_j, e_ij]) for all pairs without building the concat; each
    product's operands rounded to ``dtype`` (None: f32)."""
    f = h.shape[-1]
    w = round_operand(lin.weight, dtype)  # [out, 2f + E]
    src = round_operand(h, dtype) @ w[:, :f].T
    dst = round_operand(h, dtype) @ w[:, f:2 * f].T
    pre = src[:, :, None, :] + dst[:, None, :, :]
    if edge_attr is not None and w.shape[1] > 2 * f:
        pre = pre + round_operand(edge_attr, dtype) @ w[:, 2 * f:].T
    return pre + lin.bias


def _lowp_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``_sigmoid`` of a bf16 ``x`` (``pallas_egnn.py:68-75``): in f32,
    rounded to bf16."""
    return torch.sigmoid(x.float()).to(torch.bfloat16)


def _lowp_silu(x: torch.Tensor) -> torch.Tensor:
    """``_silu`` of a bf16 ``x``: x * _sigmoid(x), the product in bf16."""
    return x * _lowp_sigmoid(x)


def _lowp_linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``_matmul(x, w, bf16, out_dtype=bf16) + cast_b(b)`` on a bf16 ``x``:
    the product of bf16 operands accumulated in f32 and rounded to bf16,
    the bias rounded to bf16 and added in bf16."""
    out = F.linear(x.float(), round_operand(lin.weight, torch.bfloat16)).to(torch.bfloat16)
    return out + lin.bias.to(torch.bfloat16)


def _lowp_messages(edge_mlp: nn.Sequential, pre: torch.Tensor) -> torch.Tensor:
    """silu(silu(pre) W2 + b2) with the chain in bf16, from the f32
    pre-activation (rounded to bf16 first, as ``edge_pre`` returns it)."""
    return _lowp_silu(_lowp_linear(edge_mlp[2], _lowp_silu(pre.to(torch.bfloat16))))


def _aggregate(m: torch.Tensor, edge_mask: torch.Tensor, cfg: EGNNConfig) -> torch.Tensor:
    """Masked neighbour sum. 'sum' divides by normalization_factor; 'mean'
    divides by the PADDED node count (every edge of the dense list counts,
    as in the reference's unsorted_segment_mean over the full edge list)."""
    agg = (m * edge_mask).sum(dim=2)
    if cfg.aggregation_method == "sum":
        return agg / cfg.normalization_factor
    if cfg.aggregation_method == "mean":
        return agg / m.shape[2]
    raise ValueError(cfg.aggregation_method)


class GCL(nn.Module):
    """Graph convolution layer (reference egnn_new.py:5-65). ``edges_in_d``:
    the edge features' width (default: the EGNN's distance features; 0 in
    the GNN)."""

    def __init__(self, cfg: EGNNConfig, edges_in_d: Optional[int] = None):
        super().__init__()
        nf = cfg.hidden_nf
        e = cfg.edge_feat_nf if edges_in_d is None else edges_in_d
        self.cfg = cfg
        self.edge_mlp = nn.Sequential(nn.Linear(2 * nf + e, nf), nn.SiLU(),
                                      nn.Linear(nf, nf), nn.SiLU())
        self.node_mlp = nn.Sequential(nn.Linear(2 * nf, nf), nn.SiLU(),
                                      nn.Linear(nf, nf))
        if cfg.attention:
            self.att_mlp = nn.Sequential(nn.Linear(nf, 1), nn.Sigmoid())

    def forward(self, h, edge_attr, node_mask, edge_mask, compute_dtype=None):
        dt = compute_dtype
        pre = _pair_first_layer(self.edge_mlp[0], h, edge_attr, dt)
        if dt is BF16_EDGE_LOWP:
            mij = _lowp_messages(self.edge_mlp, pre)
            if self.cfg.attention:
                mij = mij * _lowp_sigmoid(_lowp_linear(self.att_mlp[0], mij))
            mij = mij.float()
        else:
            mij = F.silu(linear(self.edge_mlp[2], F.silu(pre), dt))
            if self.cfg.attention:
                mij = mij * torch.sigmoid(linear(self.att_mlp[0], mij, dt))
        agg = _aggregate(mij, edge_mask, self.cfg)
        node = self.node_mlp
        out = h + linear(node[2], F.silu(linear(node[0], torch.cat([h, agg], dim=-1), dt)), dt)
        return out * node_mask


class EquivariantUpdate(nn.Module):
    """Equivariant coordinate update (reference egnn_new.py:68-105);
    last layer bias-free."""

    def __init__(self, cfg: EGNNConfig):
        super().__init__()
        nf, e = cfg.hidden_nf, cfg.edge_feat_nf
        self.cfg = cfg
        self.coord_mlp = nn.Sequential(nn.Linear(2 * nf + e, nf), nn.SiLU(),
                                       nn.Linear(nf, nf), nn.SiLU(),
                                       nn.Linear(nf, 1, bias=False))

    def forward(self, h, x, coord_diff, edge_attr, node_mask, edge_mask, compute_dtype=None):
        dt = compute_dtype
        pre = _pair_first_layer(self.coord_mlp[0], h, edge_attr, dt)
        if dt is BF16_EDGE_LOWP:
            mid = _lowp_messages(self.coord_mlp, pre)  # the w3 product's output stays f32
        else:
            mid = F.silu(linear(self.coord_mlp[2], F.silu(pre), dt))
        s = linear(self.coord_mlp[4], mid, dt)  # [B, N, N, 1]
        if self.cfg.tanh:
            s = torch.tanh(s) * self.cfg.coords_range_layer
        x = x + _aggregate(coord_diff * s, edge_mask, self.cfg)
        return x * node_mask


class EquivariantBlock(nn.Module):
    """inv_sublayers GCLs then one coordinate update (reference
    egnn_new.py:108-147). The block's own distance features are
    concatenated with the EGNN-level ones from the input coordinates."""

    def __init__(self, cfg: EGNNConfig):
        super().__init__()
        self.cfg = cfg
        for j in range(cfg.inv_sublayers):
            self.add_module(f"gcl_{j}", GCL(cfg))
        self.gcl_equiv = EquivariantUpdate(cfg)

    def forward(self, h, x, edge_attr0, node_mask, edge_mask, compute_dtype=None):
        """``compute_dtype``: None, ``torch.bfloat16`` (the linear layers'
        operand dtype) or ``BF16_EDGE_LOWP`` (the edge chain in bf16 too)."""
        radial, coord_diff = coord2diff(x, self.cfg.norm_constant)
        dist = sin_embedding(radial) if self.cfg.sin_embedding else radial
        edge_attr = torch.cat([dist, edge_attr0], dim=-1)
        for j in range(self.cfg.inv_sublayers):
            h = getattr(self, f"gcl_{j}")(h, edge_attr, node_mask, edge_mask, compute_dtype)
        x = self.gcl_equiv(h, x, coord_diff, edge_attr, node_mask, edge_mask, compute_dtype)
        return h * node_mask, x


class EGNN(nn.Module):
    """Full EGNN (reference egnn_new.py:150-197). h [B,N,in_node_nf],
    x [B,N,3], node_mask [B,N,1] -> (h [B,N,out_node_nf], x [B,N,3]).
    The edge mask is the node-mask outer product minus the diagonal."""

    def __init__(self, cfg: EGNNConfig):
        super().__init__()
        self.cfg = cfg
        self.sp = None  # a parallel.sharding.RankGroup: run the blocks over slabs of rows
        self.embedding = nn.Linear(cfg.in_node_nf, cfg.hidden_nf)
        self.embedding_out = nn.Linear(cfg.hidden_nf, cfg.out_node_nf)
        for i in range(cfg.n_layers):
            self.add_module(f"e_block_{i}", EquivariantBlock(cfg))

    def forward(self, h, x, node_mask, compute_dtype=None):
        """``compute_dtype``: None, ``torch.bfloat16`` (the linear layers'
        operand dtype) or ``BF16_EDGE_LOWP`` (``ops.egnn_block.block_forward``
        decides per block where the edge chain runs in bf16; the
        sequence-parallel route takes it as ``torch.bfloat16``)."""
        if self.sp is not None:
            from geoldm_tpu_torch.parallel.sp import egnn_forward_sp

            return egnn_forward_sp(self, h, x, node_mask, self.sp, operand_dtype(compute_dtype))
        x0 = x
        h = linear(self.embedding, h, compute_dtype)
        for i in range(self.cfg.n_layers):
            h, x = egnn_block.block_forward(getattr(self, f"e_block_{i}"), h, x, x0, node_mask,
                                            compute_dtype)
        return linear(self.embedding_out, h, compute_dtype) * node_mask, x


class GNN(nn.Module):
    """The non-equivariant GNN of the ablation (reference egnn_new.py:200-232;
    ``gnn_init`` / ``gnn_apply``, geoldm_tpu/nn/egnn.py:266-302): embedding,
    ``n_layers`` GCLs without edge features over the fully connected graph
    (the edge mask: the node mask's outer product minus the diagonal),
    ``embedding_out``. h [B,N,in_node_nf], node_mask [B,N,1] ->
    [B,N,out_node_nf]. JAX runs it on XLA, outside any Pallas kernel, so
    its products are PyTorch ops on the card too; ``compute_dtype`` rounds
    each product's operands as the EGNN's do."""

    def __init__(self, cfg: EGNNConfig):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Linear(cfg.in_node_nf, cfg.hidden_nf)
        self.embedding_out = nn.Linear(cfg.hidden_nf, cfg.out_node_nf)
        for i in range(cfg.n_layers):
            self.add_module(f"gcl_{i}", GCL(cfg, edges_in_d=0))

    def forward(self, h, node_mask, compute_dtype=None):
        compute_dtype = operand_dtype(compute_dtype)  # JAX's GNN runs on XLA: no edge chain
        edge_mask = build_edge_mask(node_mask)
        h = linear(self.embedding, h, compute_dtype)
        for i in range(self.cfg.n_layers):
            h = getattr(self, f"gcl_{i}")(h, None, node_mask, edge_mask, compute_dtype)
        return linear(self.embedding_out, h, compute_dtype) * node_mask


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every weight from ``generator`` with the reference's init:
    torch-default U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases,
    xavier-uniform with gain 0.001 for each coordinate MLP's last layer
    (egnn_new.py:75-76; the legacy EGNN's ``coord_mlp.2``, egnn.py:40-41),
    and the torch default shifted by ``weight_init_offset`` for the learned
    gamma network's positive layers (en_diffusion.py:140-148)."""
    with torch.no_grad():
        for name, mod in module.named_modules():
            offset = getattr(mod, "weight_init_offset", None)
            if not isinstance(mod, nn.Linear) and offset is None:
                continue
            fan_out, fan_in = mod.weight.shape
            legacy_coord = name.endswith("coord_mlp.2") and mod.bias is None
            if name.endswith("coord_mlp.4") or legacy_coord:
                bound = 0.001 * math.sqrt(6.0 / (fan_in + fan_out))
            else:
                bound = 1.0 / math.sqrt(fan_in)
            mod.weight.copy_(torch.empty_like(mod.weight, device="cpu")
                             .uniform_(-bound, bound, generator=generator) + (offset or 0.0))
            if mod.bias is not None:
                b = 1.0 / math.sqrt(fan_in)
                mod.bias.copy_(torch.empty_like(mod.bias, device="cpu")
                               .uniform_(-b, b, generator=generator))
