"""Row-tiled EquivariantBlock stages for large molecules (GEOM-Drugs pads to
96/136/184 atoms): the hand-written CUDA kernels, their plain PyTorch
versions and the block forward that chains them. Counterpart of
``geoldm_tpu/ops/pallas_egnn_tiled.py``.

- Kernel #3, ``gcl_rows``: one GCL for every row against all columns,
  ``(h_i + node_mlp([h_i, agg_i])) * m_i`` (TPU kernel
  ``_make_gcl_rows_kernel`` over ``_gcl_rows_math :86``).
- Kernel #4, ``coord_rows``: the coordinate update,
  ``(x_i + sum_j coord_diff_ij * s_ij * e_ij / div) * m_i`` (TPU kernel
  ``_make_coord_rows_kernel`` over ``_coord_rows_math :123``).
- ``tiled_block_forward``: ``inv_sublayers`` x #3, then #4, every GCL seeing
  the same x (``_tiled_block_fwd_impl :373``).

The CUDA kernels (``csrc/egnn_tiled.cu``) stream the columns in tiles of 32
through shared memory and keep each row's sums on chip; the plain versions
work on one [B, T, N, H] row slab at a time (T = ``PLAIN_TILE`` rows of
every molecule), so no [B, N, N, H] edge tensor is ever held. Both take any
N; 'mean' divides by the caller's N, the padded width the EGNN was given,
as the dense path does. A wrapper given a CUDA tensor launches its kernel or
raises; only CPU tensors take a plain version.

``gcl_rows_launches`` / ``coord_rows_launches`` count kernel calls: one per
GCL / coordinate stage on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from geoldm_tpu_torch.ops import cuda_build
from geoldm_tpu_torch.ops.distance import sin_embedding
from geoldm_tpu_torch.ops.egnn_block import MAX_HIDDEN, _check, _pointer_table

MAX_TILED_NODES = 1024  # csrc/egnn_tiled.cu:kMaxTiledNodes
PLAIN_TILE = 16  # rows per slab of the plain versions

gcl_rows_launches = 0
coord_rows_launches = 0

_GCL_NAMES = ("edge_mlp.0.weight", "edge_mlp.0.bias", "edge_mlp.2.weight", "edge_mlp.2.bias",
              "att_mlp.0.weight", "att_mlp.0.bias", "node_mlp.0.weight", "node_mlp.0.bias",
              "node_mlp.2.weight", "node_mlp.2.bias")
_COORD_NAMES = ("coord_mlp.0.weight", "coord_mlp.0.bias", "coord_mlp.2.weight",
                "coord_mlp.2.bias", "coord_mlp.4.weight")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _divisor(cfg, n: int) -> float:
    if cfg.aggregation_method == "sum":
        return cfg.normalization_factor
    if cfg.aggregation_method == "mean":
        return n
    raise ValueError(cfg.aggregation_method)


def _row_slab(cfg, lin, h, x, x0, node_mask, r0: int, r1: int):
    """Rows r0..r1 of every molecule against all N columns -> (silu(pre)
    [B,T,N,H], coord_diff [B,T,N,3], edge mask [B,T,N,1]): the pair features
    (``_pair_features``), the split first layer (``_edge_pre_rows``) and the
    edge mask with the diagonal at the global row (``_row_edge_mask``)."""
    n, f = h.shape[1], h.shape[2]
    diff = x[:, r0:r1, None, :] - x[:, None, :, :]
    radial = (diff * diff).sum(dim=-1, keepdim=True)
    coord_diff = diff / (torch.sqrt(radial + 1e-8) + cfg.norm_constant)
    diff0 = x0[:, r0:r1, None, :] - x0[:, None, :, :]
    radial0 = (diff0 * diff0).sum(dim=-1, keepdim=True)
    if cfg.sin_embedding:
        radial, radial0 = sin_embedding(radial), sin_embedding(radial0)
    eattr = torch.cat([radial, radial0], dim=-1)
    w = lin.weight  # [H, 2H + E]
    pre = ((h[:, r0:r1] @ w[:, :f].T)[:, :, None, :] + (h @ w[:, f:2 * f].T)[:, None, :, :]
           + eattr @ w[:, 2 * f:].T + lin.bias)
    row = torch.arange(r0, r1, device=h.device)[:, None]
    off_diag = (row != torch.arange(n, device=h.device)[None, :]).to(h.dtype)
    emask = (node_mask[:, r0:r1, None, :] * node_mask[:, None, :, :]
             * off_diag[None, :, :, None])
    return F.silu(pre), coord_diff, emask


def gcl_rows_plain(gcl, h, x, x0, node_mask, tile: int = PLAIN_TILE):
    """Plain PyTorch version of kernel #3 (``_gcl_rows_math``): ``gcl`` an
    ``nn.egnn.GCL``; h [B,N,H], x/x0 [B,N,3], node_mask [B,N,1] -> h [B,N,H]."""
    cfg = gcl.cfg
    n = h.shape[1]
    out = []
    for r0 in range(0, n, tile):
        r1 = min(r0 + tile, n)
        act, _, emask = _row_slab(cfg, gcl.edge_mlp[0], h, x, x0, node_mask, r0, r1)
        m = F.silu(gcl.edge_mlp[2](act))
        if cfg.attention:
            m = m * gcl.att_mlp(m)
        agg = (m * emask).sum(dim=2) / _divisor(cfg, n)
        hi = h[:, r0:r1]
        out.append((hi + gcl.node_mlp(torch.cat([hi, agg], dim=-1))) * node_mask[:, r0:r1])
    return torch.cat(out, dim=1)


def coord_rows_plain(equiv, h, x, x0, node_mask, tile: int = PLAIN_TILE):
    """Plain PyTorch version of kernel #4 (``_coord_rows_math``): ``equiv``
    an ``nn.egnn.EquivariantUpdate`` -> x [B,N,3]."""
    cfg = equiv.cfg
    n = h.shape[1]
    mlp = equiv.coord_mlp
    out = []
    for r0 in range(0, n, tile):
        r1 = min(r0 + tile, n)
        act, coord_diff, emask = _row_slab(cfg, mlp[0], h, x, x0, node_mask, r0, r1)
        s = mlp[4](F.silu(mlp[2](act)))
        if cfg.tanh:
            s = torch.tanh(s) * cfg.coords_range_layer
        aggx = (coord_diff * s * emask).sum(dim=2) / _divisor(cfg, n)
        out.append((x[:, r0:r1] + aggx) * node_mask[:, r0:r1])
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _validate(module, names, h, x, x0, node_mask) -> dict:
    """What both kernels refuse; returns the stage's weights by name."""
    cfg = module.cfg
    b, n, hidden = h.shape
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"egnn_tiled kernels need CUDA tensors, got {dev}")
    if not 1 <= n <= MAX_TILED_NODES:
        raise ValueError(f"egnn_tiled kernels take 1 to {MAX_TILED_NODES} nodes per molecule; "
                         f"got N={n}")
    if hidden % 32 or not 32 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"egnn_tiled kernels need hidden_nf a multiple of 32 in "
                         f"[32, {MAX_HIDDEN}]; got {hidden}")
    if hidden != cfg.hidden_nf:
        raise ValueError(f"h has {hidden} features, the stage expects {cfg.hidden_nf}")
    if b > 65535:
        raise ValueError(f"egnn_tiled kernels take at most 65535 molecules; got B={b}")
    shapes = {"h": (b, n, hidden), "x": (b, n, 3), "x0": (b, n, 3), "node_mask": (b, n, 1)}
    for name, t in dict(h=h, x=x, x0=x0, node_mask=node_mask).items():
        _check(name, t, shapes[name], dev)
    params = dict(module.named_parameters())
    weights = {name: params[name] for name in names}
    for name, w in weights.items():
        _check(name, w, w.shape, dev)
    w1 = weights[names[0]]
    if w1.shape != (hidden, 2 * hidden + cfg.edge_feat_nf):
        raise ValueError(f"{names[0]} has shape {tuple(w1.shape)}, "
                         f"expected {(hidden, 2 * hidden + cfg.edge_feat_nf)}")
    return weights


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.egnn_tiled_error_string(rc).decode()} (cudaError {rc})")


def gcl_rows_cuda(gcl, h, x, x0, node_mask):
    """Kernel #3 on the card: h [B,N,H], x/x0 [B,N,3], node_mask [B,N,1] ->
    the GCL's h [B,N,H]."""
    global gcl_rows_launches
    names = [n if gcl.cfg.attention or not n.startswith("att_mlp") else None
             for n in _GCL_NAMES]
    weights = _validate(gcl, [n for n in names if n], h, x, x0, node_mask)
    cfg = gcl.cfg
    b, n, hidden = h.shape
    dev = h.device
    lib = cuda_build.library("egnn_tiled")
    h_out = torch.empty_like(h)
    proj = torch.empty((b * n, 2 * hidden), device=dev, dtype=torch.float32)
    agg = torch.empty((b * n, hidden), device=dev, dtype=torch.float32)
    tmp = torch.empty((b * n, hidden), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.egnn_gcl_rows(
            h.data_ptr(), x.data_ptr(), x0.data_ptr(), node_mask.data_ptr(), h_out.data_ptr(),
            proj.data_ptr(), agg.data_ptr(), tmp.data_ptr(), _pointer_table(names, weights),
            b, n, hidden, cfg.edge_feat_nf, int(cfg.attention), int(cfg.sin_embedding),
            int(cfg.aggregation_method == "mean"), float(cfg.norm_constant),
            float(cfg.normalization_factor), stream)
    _raise_on(rc, lib, "egnn_tiled gcl_rows")
    gcl_rows_launches += 1
    return h_out


def coord_rows_cuda(equiv, h, x, x0, node_mask):
    """Kernel #4 on the card: -> the updated coordinates x [B,N,3]."""
    global coord_rows_launches
    weights = _validate(equiv, _COORD_NAMES, h, x, x0, node_mask)
    cfg = equiv.cfg
    b, n, hidden = h.shape
    dev = h.device
    lib = cuda_build.library("egnn_tiled")
    x_out = torch.empty_like(x)
    proj = torch.empty((b * n, 2 * hidden), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.egnn_coord_rows(
            h.data_ptr(), x.data_ptr(), x0.data_ptr(), node_mask.data_ptr(), x_out.data_ptr(),
            proj.data_ptr(), _pointer_table(_COORD_NAMES, weights), b, n, hidden,
            cfg.edge_feat_nf, int(cfg.sin_embedding), int(cfg.tanh),
            int(cfg.aggregation_method == "mean"), float(cfg.coords_range_layer),
            float(cfg.norm_constant), float(cfg.normalization_factor), stream)
    _raise_on(rc, lib, "egnn_tiled coord_rows")
    coord_rows_launches += 1
    return x_out


def tiled_block_forward(block, h, x, x0, node_mask):
    """One ``nn.egnn.EquivariantBlock`` through the row-tiled stages:
    ``inv_sublayers`` x #3, then #4 -> (h [B,N,H], x [B,N,3]). The kernels
    for tensors on the card, their plain versions on the CPU."""
    if h.is_cuda:
        gcl_rows, coord_rows = gcl_rows_cuda, coord_rows_cuda
    elif h.device.type == "cpu":
        gcl_rows, coord_rows = gcl_rows_plain, coord_rows_plain
    else:
        raise ValueError(f"egnn_tiled: unsupported device {h.device}")
    for j in range(block.cfg.inv_sublayers):
        h = gcl_rows(getattr(block, f"gcl_{j}"), h, x, x0, node_mask)
    return h, coord_rows(block.gcl_equiv, h, x, x0, node_mask)
