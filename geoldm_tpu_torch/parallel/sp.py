"""Sequence parallelism (SP): the EGNN's atom rows split over S ranks
(counterpart of ``geoldm_tpu/parallel/sp.py``, which shards them over a mesh
``seq`` axis inside ``shard_map``). Each rank owns a contiguous slab of S_r =
N / S rows of every molecule; per stage it gathers the [B, N, H] node
features and [B, N, 3] coordinates from every rank and computes only its
own rows' edges with the slab kernels of ``ops.egnn_sp`` (#6 forward, #7
backward), so no rank holds more than its [B, S_r, N, H] share of the pair
grid. SP is meant for the pair grid of large molecules (GEOM-Drugs).

Ranks are processes joined by ``torch.distributed``; ``sharding.spawn``
starts them. An SP group (``sharding.Grid.seq``, a ``sharding.RankGroup``) is
one data row of the grid: every collective here runs on the group's own
process group (``RankGroup.pg``), so the data replicas never mix.

Every rank holds the model's replicated state (weights, batch, noise) and
runs the same code; only the EGNN blocks work on slabs. The boundaries
between replicated and slab tensors are autograd-aware collectives:

===========================================  ==========  ========================
boundary                                     forward     backward
===========================================  ==========  ========================
inside a block, to a stage's full view       all_gather  reduce-scatter (sum, own
                                                         slab)
a replicated tensor entering the slab        slice       all-reduce (sum)
region as rows and columns (x, also as
x0's column view)
the same, as rows only (the embedded h)      slice       all_gather
leaving the slab region for replicated code  all_gather  own slab only, no sum
(after the last block)
===========================================  ==========  ========================

Leaving needs no sum because the replicated code after it computes the same,
whole gradient on every rank. The embedded h enters the blocks as rows only
(each block gathers its own full view), so its slab gradients are disjoint
and a gather makes the whole. Reduce-scatter is an all-reduce and a slice
(gloo has no reduce-scatter for every tensor). The weights of the blocks
get only their slab's share of the gradient on each rank: the train step
sums them over the group (``sharding.reduce_grads``); every other weight's gradient is
already whole and identical on every rank.

'mean' aggregation divides by the EGNN's N before the SP pad, as the dense
path does; N is padded to a multiple of S (the kernels mask ragged tails,
so the TPU kernels' 8-row slab alignment does not carry over).
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from geoldm_tpu_torch.nn.core import linear
from geoldm_tpu_torch.nn.egnn import EGNN
from geoldm_tpu_torch.ops import egnn_block, egnn_sp, egnn_tiled
from geoldm_tpu_torch.parallel.sharding import RankGroup, all_reduce


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def all_gather_rows(t: torch.Tensor, grp: RankGroup) -> torch.Tensor:
    """[B, S_r, F] slabs of every rank -> [B, S * S_r, F], in rank order."""
    src = t.detach().to(grp.wire).contiguous()
    parts = [torch.empty_like(src) for _ in range(grp.size)]
    dist.all_gather(parts, src, group=grp.pg)
    return torch.cat(parts, dim=1).to(t.device)


def reduce_scatter_rows(t: torch.Tensor, grp: RankGroup) -> torch.Tensor:
    """The sum over the ranks of [B, N, F] gradients -> this rank's slab."""
    s = t.shape[1] // grp.size
    return all_reduce(t, grp)[:, grp.rank * s:(grp.rank + 1) * s].contiguous()


class _EnterRows(torch.autograd.Function):
    """A replicated [B, N, F] tensor entering the slab region as rows only
    -> this rank's slab [B, S_r, F]; backward: every rank's slab gradient,
    gathered (the transpose of ``_Leave``)."""

    @staticmethod
    def forward(ctx, t, grp):
        ctx.grp = grp
        s = t.shape[1] // grp.size
        return t[:, grp.rank * s:(grp.rank + 1) * s].contiguous()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return all_gather_rows(g, ctx.grp), None


class _Enter(torch.autograd.Function):
    """A replicated [B, N, F] tensor entering the slab region as rows and
    columns -> (this rank's slab [B, S_r, F], a column view [B, N, F]);
    backward: both views' gradients summed over the ranks."""

    @staticmethod
    def forward(ctx, t, grp):
        ctx.grp = grp
        s = t.shape[1] // grp.size
        return t[:, grp.rank * s:(grp.rank + 1) * s].contiguous(), t.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, g_rows, g_full):
        grp = ctx.grp
        s = g_rows.shape[1]
        g = g_full.clone()
        g[:, grp.rank * s:(grp.rank + 1) * s] += g_rows
        return all_reduce(g, grp), None


class _Leave(torch.autograd.Function):
    """Slab rows leaving for replicated code: all_gather; backward: the own
    slab of the gradient, which is whole on every rank."""

    @staticmethod
    def forward(ctx, t, grp):
        ctx.grp = grp
        return all_gather_rows(t, grp)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        grp = ctx.grp
        s = g.shape[1] // grp.size
        return g[:, grp.rank * s:(grp.rank + 1) * s].contiguous(), None


# ---------------------------------------------------------------------------
# The EGNN over slabs
# ---------------------------------------------------------------------------


def sp_block_forward(block, grp, mean_div, h, x, x0, node_mask, x0_full, mask_full,
                     compute_dtype=None):
    """One ``nn.egnn.EquivariantBlock`` on this rank's slab (h [B,S_r,H], x,
    x0 [B,S_r,3], node_mask [B,S_r,1]; x0_full, mask_full the block-invariant
    columns [B,N,*]): one x gather, then per GCL one h gather and #6, then
    one h gather and #6 on the coordinate update -> the slab's (h, x). The
    kernels on the card, the plain versions on the CPU; a bf16
    ``compute_dtype``, their bf16 variants."""
    row0 = grp.rank * h.shape[1]
    x_full = all_gather_rows(x, grp)
    stages = [getattr(block, f"gcl_{j}") for j in range(block.cfg.inv_sublayers)]
    for stage in stages + [block.gcl_equiv]:
        fwd, _ = egnn_sp.stage_fns(stage, h.is_cuda)
        full = (all_gather_rows(h, grp), x_full, x0_full, mask_full)
        out = fwd(stage, full, (h, x, x0, node_mask), row0, mean_div,
                  compute_dtype=compute_dtype)
        if stage is block.gcl_equiv:
            x = out
        else:
            h = out
    return h, x


def _sp_function_forward(ctx, compute_dtype, block, grp, mean_div, h, x, x0, node_mask,
                         x0_full, mask_full, weights):
    args = (grp, mean_div, h, x, x0, node_mask, x0_full, mask_full, compute_dtype)
    if h.is_cuda:
        h_out, x_out = sp_block_forward(block, *args)
    else:
        h_out, x_out = egnn_tiled._call_with(block, egnn_block.block_param_names(block),
                                             weights, sp_block_forward, *args)
    ctx.block, ctx.grp, ctx.mean_div, ctx.compute_dtype = block, grp, mean_div, compute_dtype
    ctx.save_for_backward(h, x, x0, node_mask, x0_full, mask_full, *weights)
    return h_out, x_out


class SPEquivariantBlockFunction(torch.autograd.Function):
    """One block over this rank's slab, forward and backward:
    ``apply(block, compute_dtype, grp, mean_div, h, x, x0, node_mask,
    x0_full, mask_full, *block_params(block))`` (``compute_dtype`` None or
    torch.bfloat16, the bf16 variants of #6 and #7). The forward is ``sp_block_forward``; only the
    block inputs and the weights are saved. The backward re-runs the gathers
    and the GCL chain (#6), keeping each GCL's node chain over the slab, runs
    #7 over the stages in reverse, handing each GCL stage its chain, and
    reduce-scatters each stage's full-view dh and the block's summed
    full-view dx; the full-view dx0 is x0_full's gradient. Every rank runs
    the same collectives in the same order. On CPU tensors it runs the plain
    versions with the given weights."""

    @staticmethod
    def forward(ctx, block, compute_dtype, grp, mean_div, h, x, x0, node_mask, x0_full,
                mask_full, *weights):
        return _sp_function_forward(ctx, compute_dtype, block, grp, mean_div, h, x, x0,
                                    node_mask, x0_full, mask_full, weights)

    @staticmethod
    @once_differentiable
    def backward(ctx, dh_out, dx_out):
        h, x, x0, node_mask, x0_full, mask_full, *weights = ctx.saved_tensors
        block, grp, mean_div, dt = ctx.block, ctx.grp, ctx.mean_div, ctx.compute_dtype
        row0 = grp.rank * h.shape[1]
        gcls = [getattr(block, f"gcl_{j}") for j in range(block.cfg.inv_sublayers)]
        gcl_ws, coord_ws = egnn_tiled._stage_weights(block, weights)
        on_card = h.is_cuda

        def fwd(stage, ws, *a):
            fn, _ = egnn_sp.stage_fns(stage, on_card)
            if on_card:
                return fn(stage, *a, keep_chain=True, compute_dtype=dt)
            return egnn_tiled._call_with(stage, egnn_tiled.stage_weight_names(stage), ws,
                                         lambda m, *b: fn(m, *b, keep_chain=True,
                                                          compute_dtype=dt), *a)

        def bwd(stage, ws, *a, **kw):
            _, fn = egnn_sp.stage_fns(stage, on_card)
            kw["compute_dtype"] = dt
            return fn(stage, *a, **kw) if on_card else fn(stage, *a, weights=ws, **kw)

        x_full = all_gather_rows(x, grp)
        hs, h_fulls, chains = [h], [], []
        for j, gcl in enumerate(gcls):
            h_fulls.append(all_gather_rows(hs[-1], grp))
            full = (h_fulls[-1], x_full, x0_full, mask_full)
            h_j, chain_j = fwd(gcl, gcl_ws[j], full, (hs[-1], x, x0, node_mask), row0, mean_div)
            hs.append(h_j)
            chains.append(chain_j)
        full = (all_gather_rows(hs[-1], grp), x_full, x0_full, mask_full)
        dh_f, dx_f, dx0_f, dh_r, dx, dx0, d_coord = bwd(
            block.gcl_equiv, coord_ws, full, (hs[-1], x, x0, node_mask), row0, mean_div, dx_out)
        g = dh_out + dh_r + reduce_scatter_rows(dh_f, grp)
        d_gcls = [None] * len(gcls)
        for j in range(len(gcls) - 1, -1, -1):
            full = (h_fulls[j], x_full, x0_full, mask_full)
            dh_fj, dx_fj, dx0_fj, dh_r, dx_j, dx0_j, d_gcls[j] = bwd(
                gcls[j], gcl_ws[j], full, (hs[j], x, x0, node_mask), row0, mean_div, g,
                chain=chains[j])
            g = dh_r + reduce_scatter_rows(dh_fj, grp)
            dx_f, dx0_f = dx_f + dx_fj, dx0_f + dx0_fj
            dx, dx0 = dx + dx_j, dx0 + dx0_j
        dx = dx + reduce_scatter_rows(dx_f, grp)
        return (None, None, None, None, g, dx, dx0, None, dx0_f, None,
                *[w for ws in d_gcls + [d_coord] for w in ws])


def egnn_forward_sp(egnn, h, x, node_mask, grp: RankGroup, compute_dtype=None):
    """``nn.egnn.EGNN.forward`` with the blocks over this rank's slab: same
    contract (h [B,N,in], x [B,N,3], node_mask [B,N,1] -> (h [B,N,out], x
    [B,N,3])), replicated inputs and outputs. N is padded to a multiple of
    the group size inside; 'mean' divides by the given N. ``compute_dtype``
    (None or torch.bfloat16): the linear layers' operand dtype, as the
    dense EGNN's (JAX's ``egnn_apply_sp``)."""
    b, n, _ = h.shape
    pad = -n % grp.size
    if pad:
        h, x, node_mask = (F.pad(t, (0, 0, 0, pad)) for t in (h, x, node_mask))
    node_mask = node_mask.contiguous()
    h = linear(egnn.embedding, h, compute_dtype)
    h = _EnterRows.apply(h, grp)
    x, x_full = _Enter.apply(x.contiguous(), grp)
    x0, x0_full = x, x_full  # x0 is the EGNN's input x, in both views
    s = h.shape[1]
    mask = node_mask[:, grp.rank * s:(grp.rank + 1) * s].contiguous()
    for i in range(egnn.cfg.n_layers):
        block = getattr(egnn, f"e_block_{i}")
        args = (grp, n, h, x, x0, mask, x0_full, node_mask)
        if torch.is_grad_enabled():
            h, x = SPEquivariantBlockFunction.apply(block, compute_dtype, *args,
                                                    *egnn_block.block_params(block))
        else:
            h, x = sp_block_forward(block, *args, compute_dtype)
    h = _Leave.apply(h, grp)
    x = _Leave.apply(x, grp)
    h = linear(egnn.embedding_out, h, compute_dtype) * node_mask
    return h[:, :n], x[:, :n]


# ---------------------------------------------------------------------------
# Models and train states
# ---------------------------------------------------------------------------


def _egnns(model):
    return [m for m in model.modules() if isinstance(m, EGNN)]


def attach(model, grp: Optional[RankGroup]):
    """Run every EGNN of ``model`` (encoder, decoder, denoiser) over slabs of
    ``grp`` (None: on one device)."""
    for m in _egnns(model):
        m.sp = grp
    return model


def model_group(model) -> Optional[RankGroup]:
    """The group ``attach`` gave the model's EGNNs, or None."""
    return next((m.sp for m in _egnns(model) if m.sp is not None), None)


@contextlib.contextmanager
def detached(model):
    """Within the block, every EGNN of ``model`` runs on one device."""
    saved = [(m, m.sp) for m in _egnns(model)]
    attach(model, None)
    try:
        yield model
    finally:
        for m, grp in saved:
            m.sp = grp


def block_parameters(model) -> list:
    """The weights of every block of an EGNN attached to a group: the ones
    whose gradient each rank holds only its slab's share of."""
    return [p for m in _egnns(model) if m.sp is not None
            for i in range(m.cfg.n_layers) for p in getattr(m, f"e_block_{i}").parameters()]


def _hash_tensors(h, tensors) -> None:
    for t in tensors:
        h.update(torch.as_tensor(t).detach().cpu().contiguous().numpy().tobytes())


def state_digest(state) -> str:
    """sha256 of a train state's bytes as one rank holds it
    (``utils.checkpoint.full_state``): the model's and the EMA model's
    parameters, the optimizer state, the clip's ring buffer and the step.
    Replicas in step have equal digests. Under TP the EMA and the moments
    are gathered first, so every rank must call it."""
    from geoldm_tpu_torch.utils.checkpoint import full_state

    full = full_state(state)
    h = hashlib.sha256()
    names = [n for n, _ in state.model.named_parameters()]
    _hash_tensors(h, [full["model"][n] for n in names])
    _hash_tensors(h, [(full["ema"] or full["model"])[n] for n in names])
    for _, entry in sorted(full["optim"]["state"].items()):
        _hash_tensors(h, [entry[k] for k in sorted(entry)])
    if full["clip"] is not None:
        _hash_tensors(h, [full["clip"]["norms"]])
        h.update(f"{full['clip']['count']},{full['clip']['head']}".encode())
    h.update(f"step {full['step']}".encode())
    return h.hexdigest()


def shard_digest(state) -> str:
    """sha256 of what this rank itself holds under TP: its shards (and the
    replicated parameters), their EMA and AdamW's state. The ranks of one
    model index agree on it; the ranks of a data row hold other rows."""
    from geoldm_tpu_torch.train import train_step as ts

    h = hashlib.sha256()
    _hash_tensors(h, ts.owned(state) + list(state.ema_params))
    for _, entry in sorted(state.optimizer.state_dict()["state"].items()):
        _hash_tensors(h, [entry[k] for k in sorted(entry)])
    return h.hexdigest()
