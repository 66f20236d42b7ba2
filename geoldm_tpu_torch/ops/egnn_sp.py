"""Sequence-parallel (SP) slab stages: one GCL or one coordinate update over a
rank's slab of rows against all gathered columns, the hand-written CUDA
kernels and their plain PyTorch versions. Counterpart of
``geoldm_tpu/ops/pallas_egnn_sp.py``.

- Kernel #6, ``sp_gcl_rows`` / ``sp_coord_rows``: #3's or #4's math for the
  slab (TPU kernel ``_make_sp_fwd_kernel :144`` via ``sp_stage_apply :284``).
- Kernel #7, ``sp_gcl_rows_backward`` / ``sp_coord_rows_backward``: the
  stage's backward on the slab, with the full-view gradients (dh, dx, dx0 at
  [B,N,*]) returned apart from the row-view gradients ([B,S,*]), as
  ``_sp_stage_bwd_impl :235`` returns them, and the slab's share of every
  weight gradient summed over the batch (TPU kernel ``_make_sp_bwd_kernel
  :158``).

Every stage takes ``full`` = (h [B,N,H], x [B,N,3], x0 [B,N,3], node_mask
[B,N,1]), the columns gathered from every rank, and ``rows``, the same four
tensors at [B,S,*] for this rank's slab, whose first row is the global row
``row0``; the diagonal is masked at the global row. 'mean' divides by
``mean_div``, the EGNN's N before the SP pad. The kernels (``csrc/egnn_sp.cu``)
are #3-#5's over a row window and take any S from 1 to N. A wrapper given
CUDA tensors launches its kernel or raises; only CPU tensors take a plain
version. The plain forwards are ``egnn_tiled``'s windowed versions; the
plain backwards are ``torch.autograd.grad`` of them with the full view and
the row view as distinct leaves.

A bf16 ``compute_dtype`` (torch.bfloat16) selects the bf16 variants, the
bf16 grids of #3/#4 and #5 over the slab (``ops.egnn_tiled``), whose plain
versions are the windowed bf16 plain stages and autograd through them.

``sp_gcl_rows_launches`` / ``sp_coord_rows_launches`` count #6's kernel calls,
``sp_gcl_rows_bwd_launches`` / ``sp_coord_rows_bwd_launches`` #7's; the
``*_bf16_launches`` counters those of their bf16 variants.
"""

from __future__ import annotations

import torch

from geoldm_tpu_torch.ops import cuda_build
from geoldm_tpu_torch.ops.egnn_block import _check, _pointer_table, bf16_variant
from geoldm_tpu_torch.ops.egnn_tiled import (
    _COORD_NAMES,
    _call_with,
    _divisor,
    _gcl_slots,
    _raise_on,
    _validate,
    bwd_scratch,
    check_chain,
    coord_rows_window,
    gcl_aggregate_window,
    gcl_backward_from_chain,
    gcl_rows_window,
    node_chain_buffers,
    stage_weight_names,
)

sp_gcl_rows_launches = 0
sp_coord_rows_launches = 0
sp_gcl_rows_bwd_launches = 0
sp_coord_rows_bwd_launches = 0
sp_gcl_rows_bf16_launches = 0
sp_coord_rows_bf16_launches = 0
sp_gcl_rows_bwd_bf16_launches = 0
sp_coord_rows_bwd_bf16_launches = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def sp_gcl_rows_plain(gcl, full, rows, row0: int, mean_div: int, keep_chain: bool = False,
                      compute_dtype=None):
    """Plain PyTorch version of kernel #6 on a GCL -> the slab's h [B,S,H]
    (and its node chain [3,B,S,H] with ``keep_chain``)."""
    return gcl_rows_window(gcl, full, rows, row0, _divisor(gcl.cfg, mean_div),
                           keep_chain=keep_chain, compute_dtype=compute_dtype)


def sp_coord_rows_plain(equiv, full, rows, row0: int, mean_div: int, compute_dtype=None):
    """Plain PyTorch version of kernel #6 on the coordinate update -> the
    slab's x [B,S,3]."""
    return coord_rows_window(equiv, full, rows, row0, _divisor(equiv.cfg, mean_div),
                             compute_dtype=compute_dtype)


def _sp_backward_plain(module, names, stage_fn, full, rows, row0, mean_div, g_out, weights,
                       compute_dtype):
    if weights is None:
        params = dict(module.named_parameters())
        weights = [params[n] for n in names]
    with torch.enable_grad():
        f = [t.detach().requires_grad_() for t in full[:3]]
        r = [t.detach().requires_grad_() for t in rows[:3]]
        ws = [w.detach().requires_grad_() for w in weights]
        out = _call_with(module, names, ws, lambda m, *a: stage_fn(
            m, *a, compute_dtype=compute_dtype), (*f, full[3]), (*r, rows[3]), row0, mean_div)
        grads = torch.autograd.grad(out, f + r + ws, g_out, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(f + r + ws, grads)]
    return (*grads[:6], grads[6:])


def sp_gcl_rows_backward_plain(gcl, full, rows, row0, mean_div, g_out, weights=None,
                               chain=None, compute_dtype=None):
    """Plain PyTorch version of kernel #7 on a GCL: ``torch.autograd.grad`` of
    ``sp_gcl_rows_plain`` (as the Pallas kernel ``jax.vjp``s the slab math).
    g_out [B,S,H] -> (dh, dx, dx0 of the full view, dh, dx, dx0 of the rows,
    [weight gradients in ``stage_weight_names`` order]). ``weights`` replace
    the module's parameters when given. chain: the slab's node chain
    ``sp_gcl_rows_plain(..., keep_chain=True)`` kept (the CPU route of
    ``SPEquivariantBlockFunction``), whose aggregate the node MLP's vjp then
    takes (``egnn_tiled.gcl_backward_from_chain``), or None. A bf16
    ``compute_dtype``: the bf16 variant's."""
    if chain is None:
        return _sp_backward_plain(gcl, stage_weight_names(gcl), sp_gcl_rows_plain, full, rows,
                                  row0, mean_div, g_out, weights, compute_dtype)
    if weights is None:
        params = dict(gcl.named_parameters())
        weights = [params[n] for n in stage_weight_names(gcl)]
    leaves = [t.detach().requires_grad_() for t in (*full[:3], *rows[:3])]
    ws = [w.detach().requires_grad_() for w in weights]
    div = _divisor(gcl.cfg, mean_div)

    def agg_fn(m, h, x, x0, hr, xr, x0r):
        return gcl_aggregate_window(m, (h, x, x0, full[3]), (hr, xr, x0r, rows[3]), row0, div,
                                    compute_dtype=compute_dtype)

    grads = gcl_backward_from_chain(gcl, ws, leaves, leaves[3], rows[3], agg_fn, g_out, chain,
                                    compute_dtype)
    return (*grads[:6], grads[6:])


def sp_coord_rows_backward_plain(equiv, full, rows, row0, mean_div, g_out, weights=None,
                                 compute_dtype=None):
    """Plain PyTorch version of kernel #7 on the coordinate update: g_out
    [B,S,3] -> as ``sp_gcl_rows_backward_plain``."""
    return _sp_backward_plain(equiv, list(_COORD_NAMES), sp_coord_rows_plain, full, rows, row0,
                              mean_div, g_out, weights, compute_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _validate_sp(module, names, full, rows, row0: int, mean_div: int) -> dict:
    """What the kernels refuse; returns the stage's weights by name."""
    if any(t.device.type != "cuda" for t in (*full, *rows)):
        raise ValueError("egnn_sp kernels need CUDA tensors, got "
                         f"{sorted({str(t.device) for t in (*full, *rows)})}")
    weights = _validate(module, names, *full)
    b, n, hidden = full[0].shape
    s = rows[0].shape[1] if rows[0].dim() == 3 else 0
    if not (s >= 1 and 0 <= row0 and row0 + s <= n):
        raise ValueError(f"egnn_sp: the slab of {s} rows at row {row0} must lie in the N={n} "
                         "columns")
    if mean_div < 1:
        raise ValueError(f"egnn_sp: mean_div must be >= 1, got {mean_div}")
    for name, t, f in zip(("h_rows", "x_rows", "x0_rows", "mask_rows"), rows, (hidden, 3, 3, 1)):
        _check(name, t, (b, s, f), full[0].device)
    return weights


def sp_gcl_rows_cuda(gcl, full, rows, row0: int, mean_div: int, keep_chain: bool = False,
                     compute_dtype=None):
    """Kernel #6 on a GCL on the card -> the slab's h [B,S,H], and with
    ``keep_chain`` its node chain [3,B,S,H] for ``sp_gcl_rows_backward_cuda``.
    A bf16 ``compute_dtype``: the bf16 variant."""
    global sp_gcl_rows_launches, sp_gcl_rows_bf16_launches
    bf16 = bf16_variant(compute_dtype, "egnn_sp gcl_rows")
    names = _gcl_slots(gcl)
    weights = _validate_sp(gcl, [n for n in names if n], full, rows, row0, mean_div)
    cfg = gcl.cfg
    b, n, hidden = full[0].shape
    s = rows[0].shape[1]
    dev = full[0].device
    lib = cuda_build.library("egnn_sp")
    h_out = torch.empty_like(rows[0])
    proj = torch.empty((b * n, 2 * hidden), device=dev, dtype=torch.float32)
    chain, agg, z, tmp = node_chain_buffers((b, s, hidden), dev, keep_chain)
    w2bf = (torch.empty((hidden, hidden), device=dev, dtype=torch.bfloat16),) if bf16 else ()
    fn = lib.egnn_sp_gcl_rows_bf16 if bf16 else lib.egnn_sp_gcl_rows
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            *[t.data_ptr() for t in (*full, *rows)], h_out.data_ptr(), proj.data_ptr(),
            agg.data_ptr(), tmp.data_ptr(), z.data_ptr() if keep_chain else None,
            *[t.data_ptr() for t in w2bf], _pointer_table(names, weights), b, n, s, row0,
            hidden, cfg.edge_feat_nf, int(cfg.attention), int(cfg.sin_embedding),
            int(cfg.aggregation_method == "mean"), mean_div, float(cfg.norm_constant),
            float(cfg.normalization_factor), stream)
    _raise_on(rc, lib.egnn_sp_error_string, f"egnn_sp gcl_rows{' bf16' if bf16 else ''}")
    if bf16:
        sp_gcl_rows_bf16_launches += 1
    else:
        sp_gcl_rows_launches += 1
    return (h_out, chain) if keep_chain else h_out


def sp_coord_rows_cuda(equiv, full, rows, row0: int, mean_div: int, compute_dtype=None):
    """Kernel #6 on the coordinate update on the card -> the slab's x [B,S,3].
    A bf16 ``compute_dtype``: the bf16 variant."""
    global sp_coord_rows_launches, sp_coord_rows_bf16_launches
    bf16 = bf16_variant(compute_dtype, "egnn_sp coord_rows")
    weights = _validate_sp(equiv, _COORD_NAMES, full, rows, row0, mean_div)
    cfg = equiv.cfg
    b, n, hidden = full[0].shape
    s = rows[0].shape[1]
    dev = full[0].device
    lib = cuda_build.library("egnn_sp")
    x_out = torch.empty_like(rows[1])
    proj = torch.empty((b * n, 2 * hidden), device=dev, dtype=torch.float32)
    w2bf = (torch.empty((hidden, hidden), device=dev, dtype=torch.bfloat16),) if bf16 else ()
    fn = lib.egnn_sp_coord_rows_bf16 if bf16 else lib.egnn_sp_coord_rows
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            *[t.data_ptr() for t in (*full, *rows)], x_out.data_ptr(), proj.data_ptr(),
            *[t.data_ptr() for t in w2bf], _pointer_table(_COORD_NAMES, weights), b, n, s,
            row0, hidden, cfg.edge_feat_nf,
            int(cfg.sin_embedding), int(cfg.tanh), int(cfg.aggregation_method == "mean"),
            mean_div, float(cfg.coords_range_layer), float(cfg.norm_constant),
            float(cfg.normalization_factor), stream)
    _raise_on(rc, lib.egnn_sp_error_string, f"egnn_sp coord_rows{' bf16' if bf16 else ''}")
    if bf16:
        sp_coord_rows_bf16_launches += 1
    else:
        sp_coord_rows_launches += 1
    return x_out


def _backward_buffers(lib, cfg, full, rows, g_out, out_feat, bf16):
    """Checks the cotangent; -> (group, scratch, the six gradient tensors)."""
    b, n, hidden = full[0].shape
    s = rows[0].shape[1]
    dev = full[0].device
    _check("g_out", g_out, (b, s, out_feat), dev)
    e = cfg.edge_feat_nf
    group, scratch = bwd_scratch(
        lambda g: lib.egnn_sp_backward_scratch_floats(g, s, n, hidden, e, int(bf16)), b, dev,
        f"egnn_sp backward at S={s}, N={n}, hidden_nf={hidden}")
    grads = [torch.empty_like(t) for t in (*full[:3], *rows[:3])]
    return group, scratch, grads


def sp_gcl_rows_backward_cuda(gcl, full, rows, row0: int, mean_div: int, g_out, chain=None,
                              compute_dtype=None):
    """Kernel #7 on a GCL on the card: g_out [B,S,H], the cotangent of the
    slab's output; chain: the slab's node chain ``sp_gcl_rows_cuda(...,
    keep_chain=True)`` kept for these inputs, or None (the kernel runs it:
    the same bits) -> (dh, dx, dx0 [B,N,*], dh, dx, dx0 of the rows [B,S,*],
    [weight gradients in ``sp_gcl_rows_backward_plain``'s order]). A bf16
    ``compute_dtype``: the bf16 variant."""
    global sp_gcl_rows_bwd_launches, sp_gcl_rows_bwd_bf16_launches
    bf16 = bf16_variant(compute_dtype, "egnn_sp gcl_rows backward")
    names = _gcl_slots(gcl)
    g_out = g_out.contiguous()
    weights = _validate_sp(gcl, [n for n in names if n], full, rows, row0, mean_div)
    cfg = gcl.cfg
    b, n, hidden = full[0].shape
    s = rows[0].shape[1]
    lib = cuda_build.library("egnn_sp")
    group, scratch, grads = _backward_buffers(lib, cfg, full, rows, g_out, hidden, bf16)
    wgrads = {name: torch.empty_like(w) for name, w in weights.items()}
    dev = full[0].device
    check_chain(chain, (b, s, hidden), dev)
    fn = lib.egnn_sp_gcl_rows_backward_bf16 if bf16 else lib.egnn_sp_gcl_rows_backward
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            *[t.data_ptr() for t in (*full, *rows, g_out)],
            None if chain is None else chain.data_ptr(), *[t.data_ptr() for t in grads],
            _pointer_table(names, weights), _pointer_table(names, wgrads), scratch.data_ptr(),
            b, group, n, s, row0, hidden, cfg.edge_feat_nf, int(cfg.attention),
            int(cfg.sin_embedding), int(cfg.aggregation_method == "mean"), mean_div,
            float(cfg.norm_constant), float(cfg.normalization_factor), stream)
    _raise_on(rc, lib.egnn_sp_error_string,
              f"egnn_sp gcl_rows{' bf16' if bf16 else ''} backward")
    if bf16:
        sp_gcl_rows_bwd_bf16_launches += 1
    else:
        sp_gcl_rows_bwd_launches += 1
    return (*grads, [wgrads[name] for name in names if name])


def sp_coord_rows_backward_cuda(equiv, full, rows, row0: int, mean_div: int, g_out,
                                compute_dtype=None):
    """Kernel #7 on the coordinate update on the card: g_out [B,S,3] -> as
    ``sp_gcl_rows_backward_cuda``, with the weight gradients of
    coord_mlp.{0,2,4}. A bf16 ``compute_dtype``: the bf16 variant."""
    global sp_coord_rows_bwd_launches, sp_coord_rows_bwd_bf16_launches
    bf16 = bf16_variant(compute_dtype, "egnn_sp coord_rows backward")
    g_out = g_out.contiguous()
    weights = _validate_sp(equiv, _COORD_NAMES, full, rows, row0, mean_div)
    cfg = equiv.cfg
    b, n, hidden = full[0].shape
    s = rows[0].shape[1]
    lib = cuda_build.library("egnn_sp")
    group, scratch, grads = _backward_buffers(lib, cfg, full, rows, g_out, 3, bf16)
    wgrads = {name: torch.empty_like(w) for name, w in weights.items()}
    dev = full[0].device
    fn = lib.egnn_sp_coord_rows_backward_bf16 if bf16 else lib.egnn_sp_coord_rows_backward
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            *[t.data_ptr() for t in (*full, *rows, g_out, *grads)],
            _pointer_table(_COORD_NAMES, weights), _pointer_table(_COORD_NAMES, wgrads),
            scratch.data_ptr(), b, group, n, s, row0, hidden, cfg.edge_feat_nf,
            int(cfg.sin_embedding), int(cfg.tanh), int(cfg.aggregation_method == "mean"),
            mean_div, float(cfg.coords_range_layer), float(cfg.norm_constant),
            float(cfg.normalization_factor), stream)
    _raise_on(rc, lib.egnn_sp_error_string,
              f"egnn_sp coord_rows{' bf16' if bf16 else ''} backward")
    if bf16:
        sp_coord_rows_bwd_bf16_launches += 1
    else:
        sp_coord_rows_bwd_launches += 1
    return (*grads, [wgrads[name] for name in _COORD_NAMES])


def stage_fns(module, on_card: bool):
    """(forward, backward) of ``module``'s stage, a GCL or an
    EquivariantUpdate: the kernels on the card, the plain versions on the
    CPU."""
    if hasattr(module, "coord_mlp"):
        return ((sp_coord_rows_cuda, sp_coord_rows_backward_cuda) if on_card
                else (sp_coord_rows_plain, sp_coord_rows_backward_plain))
    return ((sp_gcl_rows_cuda, sp_gcl_rows_backward_cuda) if on_card
            else (sp_gcl_rows_plain, sp_gcl_rows_backward_plain))
