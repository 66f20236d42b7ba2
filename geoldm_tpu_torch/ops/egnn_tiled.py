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
- Kernel #5, ``gcl_rows_backward`` / ``coord_rows_backward``: the backward of
  one stage, dh, dx, the exact dx0 and every weight gradient of the stage
  summed over the batch, from the stage's inputs and the cotangent of its
  output (TPU kernel ``_make_rows_bwd_kernel :201`` via ``_call_rows_bwd
  :267``).
- ``TiledEquivariantBlockFunction``: ``tiled_block_forward`` as forward,
  saving only the block inputs and the weights; its backward re-runs the
  GCL chain with #3, keeping each GCL's node chain, and runs #5 over the
  stages in reverse, handing each GCL stage its chain
  (``_tiled_block_bwd_impl :465``).

The forward kernels (``csrc/egnn_tiled.cu``) walk each row's columns in
64-column windows, each a tile whose W2 product runs on the tensor cores in
split TF32 (f32 accuracy), and keep each row's sums on chip; the edge grid
of the backward (``csrc/egnn_tiled_bwd.cu``) walks the same windows with its
edge products in split TF32 too, writes three edge-sized buffers for the
passes that cross rows (whose products also run on the tensor cores) and
runs the molecules in groups whose scratch stays under
``MAX_BWD_SCRATCH_BYTES``. The plain
versions work on one [B, T, N, H] row slab at a time (T = ``PLAIN_TILE``
rows of every molecule), so the forward never holds a [B, N, N, H] edge
tensor; the plain backward is ``torch.autograd.grad`` of the plain stage.
All take any N; 'mean' divides by the caller's N, the padded width the EGNN
was given, as the dense path does. The plain versions are cases of
``gcl_rows_window`` / ``coord_rows_window``, which compute a slab of rows
against all columns and also serve the sequence-parallel slabs
(``ops.egnn_sp``). A wrapper given a CUDA tensor launches its kernel or
raises; only CPU tensors take a plain version.

The kernels' bf16 variants (``compute_dtype=torch.bfloat16``: JAX's
``bfloat16`` compute dtypes, ``_matmul`` in ``_edge_pre_rows``,
``_gcl_rows_math``, ``_coord_rows_math``) run every forward product on bf16
operands with f32 accumulation, and their backward is that forward's vjp
(each product's cotangent f32, each gradient of a bf16 operand rounded to
bf16). Their plain versions round each product's operands to bf16
(``nn.core.round_operand``) and differentiate that with autograd; a stage
rounds each weight once, whatever its slabs, so a weight's gradient is
rounded once after its sum over every row, as the kernels round it.

``gcl_rows_launches`` / ``coord_rows_launches`` count forward kernel calls,
one per GCL / coordinate stage on the card, ``gcl_rows_bf16_launches`` /
``coord_rows_bf16_launches`` those of the bf16 variants;
``gcl_rows_bwd_launches`` / ``coord_rows_bwd_launches`` count kernel #5's,
one per stage backward, ``gcl_rows_bwd_bf16_launches`` /
``coord_rows_bwd_bf16_launches`` its bf16 variant's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from geoldm_tpu_torch.nn.core import round_operand
from geoldm_tpu_torch.ops import cuda_build
from geoldm_tpu_torch.ops.distance import sin_embedding
from geoldm_tpu_torch.ops.egnn_block import (
    MAX_HIDDEN,
    _block_weight_names,
    _check,
    _pointer_table,
    bf16_variant,
    block_param_names,
)

MAX_TILED_NODES = 1024  # csrc/egnn_rows.cuh:kMaxTiledNodes
PLAIN_TILE = 16  # rows per slab of the plain versions
# Device scratch of one stage backward (csrc/egnn_tiled_bwd.cu), almost all
# of it three [G, N, N, H] f32 buffers for a group of G molecules: 3.3 GB
# for the GEOM recipe's B=32, N=184, H=256 in one group.
MAX_BWD_SCRATCH_BYTES = 4 << 30

gcl_rows_launches = 0
coord_rows_launches = 0
gcl_rows_bf16_launches = 0
coord_rows_bf16_launches = 0
gcl_rows_bwd_launches = 0
coord_rows_bwd_launches = 0
gcl_rows_bwd_bf16_launches = 0
coord_rows_bwd_bf16_launches = 0

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


def _rounded(lin, dtype):
    """(weight, bias, dtype) of a linear layer, the weight rounded to
    ``dtype`` (None: as it is) once for a whole stage."""
    return round_operand(lin.weight, dtype), lin.bias, dtype


def _apply(wb, x):
    """The linear layer ``wb`` = ``_rounded(...)`` on x rounded to its dtype
    (``nn.core.linear``)."""
    w, b, dtype = wb
    return F.linear(round_operand(x, dtype), w, b)


def _first_layer(lin, h, dtype):
    """(W1 rounded to ``dtype``, its dst projection of all columns h [B,N,H]
    -> [B,N,H]), once per stage."""
    w = round_operand(lin.weight, dtype)  # [H, 2H + E]
    f = h.shape[2]
    return w, round_operand(h, dtype) @ w[:, f:2 * f].T


def _row_slab(cfg, lin, full, rows, row0: int, r0: int, r1: int, dtype=None, first=None):
    """Global rows r0..r1 of every molecule against all N columns -> (silu(pre)
    [B,T,N,H], coord_diff [B,T,N,3], edge mask [B,T,N,1]): the pair features
    (``_pair_features``), the split first layer (``_edge_pre_rows``) and the
    edge mask with the diagonal at the global row (``_row_edge_mask``).
    ``full`` = (h, x, x0, node_mask) [B,N,*] gives the columns, ``rows`` the
    same tensors for the slab whose first row is the global row ``row0``
    (the full view itself on one device). ``dtype``: the first layer's
    operand dtype (None: f32); ``first``: ``_first_layer(lin, full[0],
    dtype)``, which a stage computes once for all its slabs (else here)."""
    h, x, x0, node_mask = full
    hr, xr, x0r, mr = rows
    n, f = h.shape[1], h.shape[2]
    w, dst = _first_layer(lin, h, dtype) if first is None else first
    a, b = r0 - row0, r1 - row0
    diff = xr[:, a:b, None, :] - x[:, None, :, :]
    radial = (diff * diff).sum(dim=-1, keepdim=True)
    coord_diff = diff / (torch.sqrt(radial + 1e-8) + cfg.norm_constant)
    diff0 = x0r[:, a:b, None, :] - x0[:, None, :, :]
    radial0 = (diff0 * diff0).sum(dim=-1, keepdim=True)
    if cfg.sin_embedding:
        radial, radial0 = sin_embedding(radial), sin_embedding(radial0)
    eattr = round_operand(torch.cat([radial, radial0], dim=-1), dtype)
    src = round_operand(hr[:, a:b], dtype) @ w[:, :f].T
    pre = src[:, :, None, :] + dst[:, None, :, :] + eattr @ w[:, 2 * f:].T + lin.bias
    row = torch.arange(r0, r1, device=h.device)[:, None]
    off_diag = (row != torch.arange(n, device=h.device)[None, :]).to(h.dtype)
    emask = (mr[:, a:b, None, :] * node_mask[:, None, :, :] * off_diag[None, :, :, None])
    return F.silu(pre), coord_diff, emask


def _gcl_aggregate(gcl, ws, full, rows, row0: int, r0: int, r1: int, div: float, dtype=None):
    """The GCL's aggregate of the global rows r0..r1 of every molecule
    against all columns, divided by ``div`` -> [B,r1-r0,H]; ``dtype`` the
    products' operand dtype, ``ws`` = ``_edge_weights(gcl, full[0],
    dtype)``."""
    cfg = gcl.cfg
    act, _, emask = _row_slab(cfg, gcl.edge_mlp[0], full, rows, row0, r0, r1, dtype, ws[0])
    m = F.silu(_apply(ws[1], act))
    if cfg.attention:
        m = m * torch.sigmoid(_apply(ws[2], m))
    return (m * emask).sum(dim=2) / div


def _edge_weights(gcl, h, dtype):
    """A GCL's edge-MLP weights rounded once for the stage: (the first layer
    with its dst projection of h, the second layer, the gate or None)."""
    att = _rounded(gcl.att_mlp[0], dtype) if gcl.cfg.attention else None
    return _first_layer(gcl.edge_mlp[0], h, dtype), _rounded(gcl.edge_mlp[2], dtype), att


def gcl_aggregate_window(gcl, full, rows, row0: int, div: float, tile: int = PLAIN_TILE,
                         compute_dtype=None):
    """The GCL's aggregate over the slab ``rows`` (as ``gcl_rows_window``) ->
    [B,S,H]."""
    s = rows[0].shape[1]
    ws = _edge_weights(gcl, full[0], compute_dtype)
    return torch.cat([_gcl_aggregate(gcl, ws, full, rows, row0, row0 + a,
                                     row0 + min(a + tile, s), div, compute_dtype)
                      for a in range(0, s, tile)], dim=1)


def _node_mlp(gcl, dtype):
    """out(h, agg, mask) of a GCL's node MLP and residual, its weights
    rounded once, and its pre-activation z."""
    w1, w2 = _rounded(gcl.node_mlp[0], dtype), _rounded(gcl.node_mlp[2], dtype)

    def out(h, agg, mask):
        z = _apply(w1, torch.cat([h, agg], dim=-1))
        u = gcl.node_mlp[1](z)
        return (h + _apply(w2, u)) * mask, z, u
    return out


def gcl_rows_window(gcl, full, rows, row0: int, div: float, tile: int = PLAIN_TILE,
                    keep_chain: bool = False, compute_dtype=None):
    """Plain PyTorch version of kernels #3 and #6: one GCL for the slab
    ``rows`` (h, x, x0, node_mask at [B,S,*], first global row ``row0``)
    against the columns ``full`` ([B,N,*]); aggregates divided by ``div`` ->
    the slab's h [B,S,H], and with ``keep_chain`` also its node chain [3,
    B,S,H]: the aggregate, the node MLP's pre-activation z and silu(z), which
    the stage backward takes in place of running them again. A bf16
    ``compute_dtype`` (torch.bfloat16): #3's bf16 variant."""
    hr, mr = rows[0], rows[3]
    ws = _edge_weights(gcl, full[0], compute_dtype)
    node = _node_mlp(gcl, compute_dtype)
    out, chain = [], []
    for a in range(0, hr.shape[1], tile):
        b = min(a + tile, hr.shape[1])
        agg = _gcl_aggregate(gcl, ws, full, rows, row0, row0 + a, row0 + b, div, compute_dtype)
        h, z, u = node(hr[:, a:b], agg, mr[:, a:b])
        out.append(h)
        chain.append(torch.stack([agg, z, u]))
    h = torch.cat(out, dim=1)
    return (h, torch.cat(chain, dim=2)) if keep_chain else h


def coord_rows_window(equiv, full, rows, row0: int, div: float, tile: int = PLAIN_TILE,
                      compute_dtype=None):
    """Plain PyTorch version of kernels #4 and #6: the coordinate update of
    the slab ``rows`` against the columns ``full`` -> the slab's x [B,S,3].
    A bf16 ``compute_dtype`` (torch.bfloat16): #4's bf16 variant."""
    cfg = equiv.cfg
    xr, mr = rows[1], rows[3]
    mlp = equiv.coord_mlp
    first = _first_layer(mlp[0], full[0], compute_dtype)
    w2, w3 = _rounded(mlp[2], compute_dtype), _rounded(mlp[4], compute_dtype)
    out = []
    for a in range(0, xr.shape[1], tile):
        b = min(a + tile, xr.shape[1])
        act, coord_diff, emask = _row_slab(cfg, mlp[0], full, rows, row0, row0 + a, row0 + b,
                                           compute_dtype, first)
        s = _apply(w3, F.silu(_apply(w2, act)))
        if cfg.tanh:
            s = torch.tanh(s) * cfg.coords_range_layer
        aggx = (coord_diff * s * emask).sum(dim=2) / div
        out.append((xr[:, a:b] + aggx) * mr[:, a:b])
    return torch.cat(out, dim=1)


def gcl_rows_plain(gcl, h, x, x0, node_mask, tile: int = PLAIN_TILE, keep_chain: bool = False,
                   compute_dtype=None):
    """Plain PyTorch version of kernel #3 (``_gcl_rows_math``): ``gcl`` an
    ``nn.egnn.GCL``; h [B,N,H], x/x0 [B,N,3], node_mask [B,N,1] -> h [B,N,H]
    (and its node chain [3,B,N,H] with ``keep_chain``). A bf16
    ``compute_dtype``: its bf16 variant's."""
    full = (h, x, x0, node_mask)
    return gcl_rows_window(gcl, full, full, 0, _divisor(gcl.cfg, h.shape[1]), tile, keep_chain,
                           compute_dtype)


def coord_rows_plain(equiv, h, x, x0, node_mask, tile: int = PLAIN_TILE, compute_dtype=None):
    """Plain PyTorch version of kernel #4 (``_coord_rows_math``): ``equiv``
    an ``nn.egnn.EquivariantUpdate`` -> x [B,N,3]. A bf16 ``compute_dtype``:
    its bf16 variant's."""
    full = (h, x, x0, node_mask)
    return coord_rows_window(equiv, full, full, 0, _divisor(equiv.cfg, h.shape[1]), tile,
                             compute_dtype)


class _Bound(torch.nn.Module):
    """``fn(module, *args)`` as a module's forward, so that
    ``torch.func.functional_call`` can put given tensors in place of the
    module's weights."""

    def __init__(self, module, fn):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.module, *args)


def _call_with(module, names, weights, fn, *args):
    """``fn(module, *args)`` with ``weights`` in place of the parameters
    ``names`` of ``module``."""
    params = {f"module.{n}": w for n, w in zip(names, weights)}
    return torch.func.functional_call(_Bound(module, fn), params, args)


def _gcl_slots(gcl) -> list:
    """The GCL's weight names in the kernels' pointer order, ``None`` in the
    attention slots of a GCL without attention."""
    return [n if gcl.cfg.attention or not n.startswith("att_mlp") else None for n in _GCL_NAMES]


def stage_weight_names(module) -> list:
    """A GCL's or an EquivariantUpdate's weight names in the order the stage
    backwards return their gradients."""
    if hasattr(module, "coord_mlp"):
        return list(_COORD_NAMES)
    return [n for n in _gcl_slots(module) if n]


def _stage_backward_plain(module, names, stage_fn, h, x, x0, node_mask, g_out, weights,
                          compute_dtype=None):
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (h, x, x0)]
        ws = [w.detach().requires_grad_() for w in weights]
        out = _call_with(module, names, ws, lambda m, *a: stage_fn(
            m, *a, compute_dtype=compute_dtype), *inputs, node_mask)
        grads = torch.autograd.grad(out, inputs + ws, g_out, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(inputs + ws, grads)]
    return grads[0], grads[1], grads[2], grads[3:]


def gcl_backward_from_chain(gcl, weights, leaves, hr, mr, agg_fn, g_out, chain,
                            compute_dtype=None):
    """The plain backward of a GCL stage from a kept node chain, split at the
    aggregate as the kernels split it: the node MLP's vjp at the kept
    aggregate ``chain[0]``, then the vjp of ``agg_fn(gcl, *leaves)`` with the
    aggregate's gradient. leaves: the input leaves (hr, the slab's h, is one
    of them), weights: leaves in ``stage_weight_names`` order -> the
    gradients of leaves + weights. A bf16 ``compute_dtype``: the node MLP's
    products on bf16 operands (``agg_fn`` runs its own)."""
    names = stage_weight_names(gcl)
    with torch.enable_grad():
        agg = _call_with(gcl, names, weights, agg_fn, *leaves)
        agg_in = chain[0].detach().requires_grad_()
        out = _call_with(gcl, names, weights, lambda m, h_, a_: _node_mlp(m, compute_dtype)(
            h_, a_, mr)[0], hr, agg_in)
        node = torch.autograd.grad(out, [hr, agg_in, *weights], g_out, allow_unused=True)
        edge = torch.autograd.grad(agg, [*leaves, *weights], node[1], allow_unused=True)
    grads = [ge if t is not hr else (node[0] if ge is None else ge + node[0])
             for t, ge in zip(leaves, edge[:len(leaves)])]
    grads += [gn if ge is None else (ge if gn is None else ge + gn)
              for gn, ge in zip(node[2:], edge[len(leaves):])]
    return [torch.zeros_like(t) if g is None else g for t, g in zip([*leaves, *weights], grads)]


def gcl_rows_backward_plain(gcl, h, x, x0, node_mask, g_out, weights=None, chain=None,
                            compute_dtype=None):
    """Plain PyTorch version of kernel #5 on a GCL stage:
    ``torch.autograd.grad`` of ``gcl_rows_plain`` (as the Pallas kernel
    ``jax.vjp``s ``_gcl_rows_math``). g_out [B,N,H], the cotangent of the
    stage's output -> (dh, dx, dx0, [weight gradients in pointer order
    without the empty attention slots]). ``weights`` replace the module's
    parameters when given. chain: the node chain ``gcl_rows_plain(...,
    keep_chain=True)`` kept for this h (the CPU route of
    ``TiledEquivariantBlockFunction``), whose aggregate the node MLP's vjp
    then takes (``gcl_backward_from_chain``), or None. A bf16
    ``compute_dtype``: the bf16 variant's (autograd through the plain bf16
    stage)."""
    names = stage_weight_names(gcl)
    if weights is None:
        params = dict(gcl.named_parameters())
        weights = [params[n] for n in names]
    if chain is None:
        return _stage_backward_plain(gcl, names, gcl_rows_plain, h, x, x0, node_mask, g_out,
                                     weights, compute_dtype)
    leaves = [t.detach().requires_grad_() for t in (h, x, x0)]
    ws = [w.detach().requires_grad_() for w in weights]
    div = _divisor(gcl.cfg, h.shape[1])

    def agg_fn(m, h_, x_, x0_):
        full = (h_, x_, x0_, node_mask)
        return gcl_aggregate_window(m, full, full, 0, div, compute_dtype=compute_dtype)

    grads = gcl_backward_from_chain(gcl, ws, leaves, leaves[0], node_mask, agg_fn, g_out, chain,
                                    compute_dtype)
    return grads[0], grads[1], grads[2], grads[3:]


def coord_rows_backward_plain(equiv, h, x, x0, node_mask, g_out, weights=None,
                              compute_dtype=None):
    """Plain PyTorch version of kernel #5 on the coordinate stage
    (``_coord_rows_math``): g_out [B,N,3] -> (dh, dx, dx0, [weight
    gradients of coord_mlp.{0,2,4}]). A bf16 ``compute_dtype``: the bf16
    variant's."""
    if weights is None:
        params = dict(equiv.named_parameters())
        weights = [params[n] for n in _COORD_NAMES]
    return _stage_backward_plain(equiv, _COORD_NAMES, coord_rows_plain, h, x, x0, node_mask,
                                 g_out, weights, compute_dtype)


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


def _raise_on(rc: int, error_string, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: {error_string(rc).decode()} "
                           f"(cudaError {rc})")


def node_chain_buffers(shape, dev, keep: bool):
    """(chain or None, agg, z or None, hidden) of a GCL kernel over ``shape``
    = (B, S, H) rows: with ``keep`` the three are the planes of one [3,B,S,H]
    chain (the aggregate, z and silu(z)) for the stage backward, else the
    aggregate and silu(z) are scratch and z is not stored."""
    if keep:
        chain = torch.empty((3, *shape), device=dev, dtype=torch.float32)
        return chain, chain[0], chain[1], chain[2]
    agg, hidden = (torch.empty(shape, device=dev, dtype=torch.float32) for _ in range(2))
    return None, agg, None, hidden


def check_chain(chain, shape, dev):
    """A chain handed to a GCL backward: None, or [3, *shape] f32 on dev."""
    if chain is not None:
        _check("chain", chain, (3, *shape), dev)


def gcl_rows_cuda(gcl, h, x, x0, node_mask, keep_chain: bool = False, compute_dtype=None):
    """Kernel #3 on the card: h [B,N,H], x/x0 [B,N,3], node_mask [B,N,1] ->
    the GCL's h [B,N,H], and with ``keep_chain`` also its node chain
    [3,B,N,H] (the aggregate, z and silu(z)) for ``gcl_rows_backward_cuda``.
    A bf16 ``compute_dtype``: its bf16 variant (whose chain is the bf16
    backward's)."""
    global gcl_rows_launches, gcl_rows_bf16_launches
    bf16 = bf16_variant(compute_dtype, "egnn_tiled gcl_rows")
    names = _gcl_slots(gcl)
    weights = _validate(gcl, [n for n in names if n], h, x, x0, node_mask)
    cfg = gcl.cfg
    b, n, hidden = h.shape
    dev = h.device
    lib = cuda_build.library("egnn_tiled")
    h_out = torch.empty_like(h)
    proj = torch.empty((b * n, 2 * hidden), device=dev, dtype=torch.float32)
    chain, agg, z, tmp = node_chain_buffers((b, n, hidden), dev, keep_chain)
    # bf16: the bf16 W2, converted by the kernel's call, after z.
    w2bf = (torch.empty((hidden, hidden), device=dev, dtype=torch.bfloat16),) if bf16 else ()
    fn = lib.egnn_gcl_rows_bf16 if bf16 else lib.egnn_gcl_rows
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            h.data_ptr(), x.data_ptr(), x0.data_ptr(), node_mask.data_ptr(), h_out.data_ptr(),
            proj.data_ptr(), agg.data_ptr(), tmp.data_ptr(), None if z is None else z.data_ptr(),
            *[t.data_ptr() for t in w2bf],
            _pointer_table(names, weights), b, n, hidden, cfg.edge_feat_nf, int(cfg.attention),
            int(cfg.sin_embedding), int(cfg.aggregation_method == "mean"),
            float(cfg.norm_constant), float(cfg.normalization_factor), stream)
    _raise_on(rc, lib.egnn_tiled_error_string, f"egnn_tiled gcl_rows{' bf16' if bf16 else ''}")
    if bf16:
        gcl_rows_bf16_launches += 1
    else:
        gcl_rows_launches += 1
    return (h_out, chain) if keep_chain else h_out


def coord_rows_cuda(equiv, h, x, x0, node_mask, compute_dtype=None):
    """Kernel #4 on the card, or its bf16 variant for a bf16
    ``compute_dtype``: -> the updated coordinates x [B,N,3]."""
    global coord_rows_launches, coord_rows_bf16_launches
    bf16 = bf16_variant(compute_dtype, "egnn_tiled coord_rows")
    weights = _validate(equiv, _COORD_NAMES, h, x, x0, node_mask)
    cfg = equiv.cfg
    b, n, hidden = h.shape
    dev = h.device
    lib = cuda_build.library("egnn_tiled")
    x_out = torch.empty_like(x)
    proj = torch.empty((b * n, 2 * hidden), device=dev, dtype=torch.float32)
    table = _pointer_table(_COORD_NAMES, weights)
    args = (b, n, hidden, cfg.edge_feat_nf, int(cfg.sin_embedding), int(cfg.tanh),
            int(cfg.aggregation_method == "mean"), float(cfg.coords_range_layer),
            float(cfg.norm_constant), float(cfg.normalization_factor))
    ptrs = (h.data_ptr(), x.data_ptr(), x0.data_ptr(), node_mask.data_ptr(), x_out.data_ptr(),
            proj.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bf16:
            w2bf = torch.empty((hidden, hidden), device=dev, dtype=torch.bfloat16)
            rc = lib.egnn_coord_rows_bf16(*ptrs, w2bf.data_ptr(), table, *args, stream)
        else:
            rc = lib.egnn_coord_rows(*ptrs, table, *args, stream)
    _raise_on(rc, lib.egnn_tiled_error_string, f"egnn_tiled coord_rows{' bf16' if bf16 else ''}")
    if bf16:
        coord_rows_bf16_launches += 1
    else:
        coord_rows_launches += 1
    return x_out


def bwd_scratch(floats, b: int, dev, what: str):
    """(molecules per group, scratch tensor) of a stage backward whose group
    of g molecules needs ``floats(g)`` floats of scratch: the largest group
    whose scratch stays under ``MAX_BWD_SCRATCH_BYTES``."""
    cap = MAX_BWD_SCRATCH_BYTES // 4
    if floats(1) > cap:
        raise ValueError(
            f"{what}: one molecule needs {4 * floats(1)} bytes of device scratch, over "
            f"MAX_BWD_SCRATCH_BYTES={MAX_BWD_SCRATCH_BYTES}")
    unit = max(1, floats(2) - floats(1))
    group = min(b, 1 + (cap - floats(1)) // unit)
    while group > 1 and floats(group) > cap:
        group -= 1
    return group, torch.empty(floats(group), device=dev, dtype=torch.float32)


def _stage_scratch(lib, b: int, n: int, hidden: int, e: int, dev, bf16: bool = False):
    return bwd_scratch(lambda g: lib.egnn_rows_backward_scratch_floats(g, n, hidden, e, int(bf16)),
                       b, dev, f"egnn_tiled backward at N={n}, hidden_nf={hidden}")


def gcl_rows_backward_cuda(gcl, h, x, x0, node_mask, g_out, chain=None, compute_dtype=None):
    """Kernel #5 on a GCL stage on the card: the stage's input h [B,N,H],
    x/x0 [B,N,3], node_mask [B,N,1] and the cotangent g_out [B,N,H] of its
    output -> (dh, dx, dx0, [weight gradients summed over the batch, in
    ``gcl_rows_backward_plain``'s order]). chain: the node chain
    ``gcl_rows_cuda(..., keep_chain=True)`` kept for this h, which the
    kernel takes instead of running the GCL's edge grid again, or None (it
    runs it: the same bits). A bf16 ``compute_dtype``: the bf16 variant
    (chain from the bf16 ``gcl_rows_cuda``)."""
    global gcl_rows_bwd_launches, gcl_rows_bwd_bf16_launches
    bf16 = bf16_variant(compute_dtype, "egnn_tiled gcl_rows backward")
    names = _gcl_slots(gcl)
    g_out = g_out.contiguous()
    weights = _validate(gcl, [n for n in names if n], h, x, x0, node_mask)
    _check("g_out", g_out, h.shape, h.device)
    check_chain(chain, h.shape, h.device)
    cfg = gcl.cfg
    b, n, hidden = h.shape
    lib = cuda_build.library("egnn_tiled_bwd")
    group, scratch = _stage_scratch(lib, b, n, hidden, cfg.edge_feat_nf, h.device, bf16)
    grads = {name: torch.empty_like(w) for name, w in weights.items()}
    dh, dx, dx0 = torch.empty_like(h), torch.empty_like(x), torch.empty_like(x0)
    fn = lib.egnn_gcl_rows_backward_bf16 if bf16 else lib.egnn_gcl_rows_backward
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = fn(
            h.data_ptr(), x.data_ptr(), x0.data_ptr(), node_mask.data_ptr(), g_out.data_ptr(),
            None if chain is None else chain.data_ptr(), dh.data_ptr(), dx.data_ptr(),
            dx0.data_ptr(), _pointer_table(names, weights),
            _pointer_table(names, grads), scratch.data_ptr(), b, group, n, hidden,
            cfg.edge_feat_nf, int(cfg.attention), int(cfg.sin_embedding),
            int(cfg.aggregation_method == "mean"), float(cfg.norm_constant),
            float(cfg.normalization_factor), stream)
    _raise_on(rc, lib.egnn_tiled_bwd_error_string,
              f"egnn_tiled gcl_rows{' bf16' if bf16 else ''} backward")
    if bf16:
        gcl_rows_bwd_bf16_launches += 1
    else:
        gcl_rows_bwd_launches += 1
    return dh, dx, dx0, [grads[name] for name in names if name]


def coord_rows_backward_cuda(equiv, h, x, x0, node_mask, g_out, compute_dtype=None):
    """Kernel #5 on the coordinate stage on the card: g_out [B,N,3], the
    cotangent of the updated x -> (dh, dx, dx0, [weight gradients of
    coord_mlp.{0,2,4}]). A bf16 ``compute_dtype``: the bf16 variant."""
    global coord_rows_bwd_launches, coord_rows_bwd_bf16_launches
    bf16 = bf16_variant(compute_dtype, "egnn_tiled coord_rows backward")
    g_out = g_out.contiguous()
    weights = _validate(equiv, _COORD_NAMES, h, x, x0, node_mask)
    _check("g_out", g_out, x.shape, h.device)
    cfg = equiv.cfg
    b, n, hidden = h.shape
    lib = cuda_build.library("egnn_tiled_bwd")
    group, scratch = _stage_scratch(lib, b, n, hidden, cfg.edge_feat_nf, h.device, bf16)
    grads = {name: torch.empty_like(w) for name, w in weights.items()}
    dh, dx, dx0 = torch.empty_like(h), torch.empty_like(x), torch.empty_like(x0)
    fn = lib.egnn_coord_rows_backward_bf16 if bf16 else lib.egnn_coord_rows_backward
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = fn(
            h.data_ptr(), x.data_ptr(), x0.data_ptr(), node_mask.data_ptr(), g_out.data_ptr(),
            dh.data_ptr(), dx.data_ptr(), dx0.data_ptr(), _pointer_table(_COORD_NAMES, weights),
            _pointer_table(_COORD_NAMES, grads), scratch.data_ptr(), b, group, n, hidden,
            cfg.edge_feat_nf, int(cfg.sin_embedding), int(cfg.tanh),
            int(cfg.aggregation_method == "mean"), float(cfg.coords_range_layer),
            float(cfg.norm_constant), float(cfg.normalization_factor), stream)
    _raise_on(rc, lib.egnn_tiled_bwd_error_string,
              f"egnn_tiled coord_rows{' bf16' if bf16 else ''} backward")
    if bf16:
        coord_rows_bwd_bf16_launches += 1
    else:
        coord_rows_bwd_launches += 1
    return dh, dx, dx0, [grads[name] for name in _COORD_NAMES]


def tiled_block_forward(block, h, x, x0, node_mask, compute_dtype=None):
    """One ``nn.egnn.EquivariantBlock`` through the row-tiled stages:
    ``inv_sublayers`` x #3, then #4 -> (h [B,N,H], x [B,N,3]). The kernels
    for tensors on the card, their plain versions on the CPU; a bf16
    ``compute_dtype`` selects their bf16 variants."""
    if h.is_cuda:
        gcl_rows, coord_rows = gcl_rows_cuda, coord_rows_cuda
    elif h.device.type == "cpu":
        gcl_rows, coord_rows = gcl_rows_plain, coord_rows_plain
    else:
        raise ValueError(f"egnn_tiled: unsupported device {h.device}")
    for j in range(block.cfg.inv_sublayers):
        h = gcl_rows(getattr(block, f"gcl_{j}"), h, x, x0, node_mask,
                     compute_dtype=compute_dtype)
    return h, coord_rows(block.gcl_equiv, h, x, x0, node_mask, compute_dtype=compute_dtype)


def _stage_weights(block, weights) -> tuple:
    """The Function's weights (``block_params`` order) split by stage ->
    ([one list per GCL], coordinate list)."""
    gcls, coord = _block_weight_names(block)
    it = iter(weights)
    stages = [[next(it) for name in names if name is not None] for names in gcls + [coord]]
    return stages[:-1], stages[-1]


def _tiled_function_forward(ctx, compute_dtype, block, h, x, x0, node_mask, weights):
    if h.is_cuda:
        h_out, x_out = tiled_block_forward(block, h, x, x0, node_mask, compute_dtype)
    else:
        h_out, x_out = _call_with(block, block_param_names(block), weights,
                                  tiled_block_forward, h, x, x0, node_mask, compute_dtype)
    ctx.block, ctx.compute_dtype = block, compute_dtype
    ctx.save_for_backward(h, x, x0, node_mask, *weights)
    return h_out, x_out


class TiledEquivariantBlockFunction(torch.autograd.Function):
    """One block through the row-tiled stages, forward and backward:
    ``apply(block, compute_dtype, h, x, x0, node_mask, *block_params(block))``
    (``compute_dtype`` None or torch.bfloat16, the bf16 variants of #3/#4,
    keeping each GCL's chain in the backward's re-run, and #5). The forward
    is ``tiled_block_forward``; only the block inputs and the weights are
    saved. The backward re-runs the GCL chain (#3) for each GCL's input and
    keeps each GCL's node chain (the aggregate, z and silu(z)), runs the
    coordinate stage's backward, then each GCL stage's in reverse (#5),
    handing it its node chain, so that #5 runs no GCL edge grid of its own,
    and sums dx and dx0. On CPU tensors it runs the plain versions with the
    given weights (for tests, and to keep the CPU's memory to one stage's),
    the chain handed over likewise."""

    @staticmethod
    def forward(ctx, block, compute_dtype, h, x, x0, node_mask, *weights):
        return _tiled_function_forward(ctx, compute_dtype, block, h, x, x0, node_mask, weights)

    @staticmethod
    @once_differentiable
    def backward(ctx, dh_out, dx_out):
        h, x, x0, node_mask, *weights = ctx.saved_tensors
        block, dt = ctx.block, ctx.compute_dtype
        gcls = [getattr(block, f"gcl_{j}") for j in range(block.cfg.inv_sublayers)]
        gcl_ws, coord_ws = _stage_weights(block, weights)
        if h.is_cuda:
            def gcl_fwd(j, *a):
                return gcl_rows_cuda(gcls[j], *a, keep_chain=True, compute_dtype=dt)

            def gcl_bwd(j, *a, chain):
                return gcl_rows_backward_cuda(gcls[j], *a, chain=chain, compute_dtype=dt)

            def coord_bwd(*a):
                return coord_rows_backward_cuda(block.gcl_equiv, *a, compute_dtype=dt)
        else:
            def gcl_fwd(j, *a):
                return _call_with(gcls[j], stage_weight_names(gcls[j]), gcl_ws[j],
                                  lambda m, *b: gcl_rows_plain(m, *b, keep_chain=True,
                                                               compute_dtype=dt), *a)

            def gcl_bwd(j, *a, chain):
                return gcl_rows_backward_plain(gcls[j], *a, weights=gcl_ws[j], chain=chain,
                                               compute_dtype=dt)

            def coord_bwd(*a):
                return coord_rows_backward_plain(block.gcl_equiv, *a, weights=coord_ws,
                                                 compute_dtype=dt)

        hs, chains = [h], []
        for j in range(len(gcls)):
            h_j, chain_j = gcl_fwd(j, hs[-1], x, x0, node_mask)
            hs.append(h_j)
            chains.append(chain_j)
        dh_c, dx, dx0, d_coord = coord_bwd(hs[-1], x, x0, node_mask, dx_out)
        g = dh_out + dh_c
        d_gcls = [None] * len(gcls)
        for j in range(len(gcls) - 1, -1, -1):
            g, dx_j, dx0_j, d_gcls[j] = gcl_bwd(j, hs[j], x, x0, node_mask, g, chain=chains[j])
            dx = dx + dx_j
            dx0 = dx0 + dx0_j
        return (None, None, g, dx, dx0, None, *[w for ws in d_gcls + [d_coord] for w in ws])
