"""Data parallelism (DP), tensor parallelism (TP) and the grid of ranks
(counterpart of ``geoldm_tpu/parallel/sharding.py``, whose ``data`` mesh
axis shards the batch while XLA inserts the gradient all-reduce, and whose
``model`` axis shards the hidden-width parameters).

``--batch_size`` is the global batch: each of D data ranks computes B/D of
its molecules, and the gradient is the mean over the global batch, so a DP-D
step is a one-rank step on the same global batch, summed in another order.
With ``--sp S`` as well, D x S ranks form a grid: rank r sits at data index
r // S and seq index r % S, as on JAX's (data, seq) mesh
(``geoldm_tpu/parallel/sp.py:54-67``). The S ranks of a data row split the
atom rows of that row's molecules (``parallel.sp``); the D ranks of a seq
column hold different molecules and average their gradients.

With ``--tp T`` instead of ``--sp``, D x T ranks form the grid of JAX's
``make_mesh(dp, tp)`` (``devices.reshape(dp, tp)``): rank r at data index
r // T and model index r % T. JAX's ``param_shardings(hidden_nf=nf)``
column-shards every parameter leaf whose last dimension is ``nf``
(``tp_sharded``); the T ranks of a data row each own 1/T of those leaves
(``own_shard``), with their optimizer state and EMA, and put the full
weights back together after each update (``gather_shards``). The batch is
split over ``data`` only, as JAX's ``batch_sharding``, so the ranks of a
data row run the same whole-operand kernels on the same rows, as JAX's
Pallas route does (a ``pallas_call`` is opaque to GSPMD).

Ranks are processes joined by ``torch.distributed``; ``spawn`` starts them
and prints the placement rule (``placement``), for all D*S (or D*T) ranks:

- ``--device cpu``: every rank on the CPU, gloo;
- at least D*S cards: rank r on ``cuda:r``, NCCL;
- one card: every rank on ``cuda:0``, gloo (NCCL refuses two ranks on one
  GPU). Gloo's collectives here take CPU tensors, so every collective on a
  CUDA tensor is staged through host memory (``RankGroup.wire``);
- anything else raises.

Noise. Every rank prepares the whole global batch with the shared numpy
generator, so the host draws are one rank's, and keeps its rows
(``shard_rows``). Device draws go through ``GlobalNoise``: each is made at
the global batch's shape from the shared source and this rank's rows are
returned, so a DP step draws exactly what one rank draws.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import sys
import tempfile
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from geoldm_tpu_torch.utils.device import resolve_device

# Longest wait of one collective before the ranks give up.
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


@dataclass
class RankGroup:
    """This rank's place in a group of ranks: its index ``rank`` among the
    group's ``size`` ranks, the backend, this rank's device and the group's
    process group ``pg`` (None: every rank of the run)."""

    rank: int
    size: int
    backend: str
    device: torch.device
    pg: Optional[object] = None

    @property
    def wire(self) -> torch.device:
        """Where the backend takes a collective's tensors: host memory for
        gloo (on a card, collectives are staged through it), the rank's card
        for NCCL, which takes CUDA tensors only."""
        return torch.device("cpu") if self.backend == "gloo" else self.device

    def __deepcopy__(self, memo):
        # A model's copy (the EMA model) stays in the same group.
        return self


@dataclass
class Grid:
    """This rank's place in the D x S (or D x T) grid: its global ``rank``,
    ``data`` (the D ranks of its seq or model column, over which the batch
    is split; None when D = 1), ``seq`` (the S ranks of its data row, over
    which the atom rows are split; None when S = 1) and ``model`` (the T
    ranks of its data row, over which the hidden-width parameters are
    sharded; None when T = 1)."""

    rank: int
    device: torch.device
    data: Optional[RankGroup] = None
    seq: Optional[RankGroup] = None
    model: Optional[RankGroup] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def placement(size: int, device="cuda"):
    """(the device of each rank, backend, the rule as one line) for ``size``
    ranks on ``device``'s type (module docstring)."""
    if size < 2:
        raise ValueError(f"a run over ranks needs at least 2 of them, got {size}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * size, "gloo", f"{size} ranks on the CPU, backend gloo"
    n = torch.cuda.device_count()
    if n >= size:
        return ([torch.device("cuda", r) for r in range(size)], "nccl",
                f"{size} ranks on cuda:0..cuda:{size - 1}, one card each, backend nccl")
    if n == 1:
        return ([torch.device("cuda", 0)] * size, "gloo",
                f"{size} ranks sharing cuda:0, backend gloo, collectives staged through "
                "host memory")
    raise ValueError(f"{size} ranks need one card per rank or one card shared by every rank; "
                     f"this host has {n} cards")


def _make_grid(rank: int, dp: int, sp: int, backend: str, dev, tp: int = 1) -> Grid:
    """Every rank creates every row's and every column's group, in the same
    order (``dist.new_group`` is collective); a grid of one row or one
    column uses the world group. A data row is S seq ranks or T model ranks
    (never both)."""
    grid = Grid(rank, dev)
    inner = sp * tp
    d, i = divmod(rank, inner)
    row = None
    if dp > 1 and inner > 1:
        rows = [dist.new_group([k * inner + j for j in range(inner)]) for k in range(dp)]
        cols = [dist.new_group([k * inner + j for k in range(dp)]) for j in range(inner)]
        grid.data = RankGroup(d, dp, backend, dev, cols[i])
        row = RankGroup(i, inner, backend, dev, rows[d])
    elif dp > 1:
        grid.data = RankGroup(d, dp, backend, dev)
    else:
        row = RankGroup(i, inner, backend, dev)
    if tp > 1:
        grid.model = row
    else:
        grid.seq = row
    return grid


def _rank_main(rank, dp, sp, fn, args, device, store, threads, tp=1):
    size = dp * sp * tp
    devices, backend, _ = placement(size, device)
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(store, 'rendezvous')}",
                            rank=rank, world_size=size, timeout=COLLECTIVE_TIMEOUT)
    try:
        grid = _make_grid(rank, dp, sp, backend, dev, tp)
        with open(os.devnull, "w") as quiet, \
                contextlib.redirect_stdout(quiet if rank else sys.stdout):  # rank 0 prints
            out = fn(*args, grid)
        if rank == 0:
            with open(os.path.join(store, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(dp: int, sp: int, fn, args=(), device="cuda", tp: int = 1):
    """Run ``fn(*args, grid)`` in D*S*T spawned ranks (``grid`` the rank's
    ``Grid``; S or T is 1) and return rank 0's result, which must pickle.
    Prints the placement rule; on the card every kernel library is built
    once, before the ranks load them. Rendezvous through a file in a fresh
    temporary directory. A rank that raises fails the run."""
    if sp > 1 and tp > 1:
        raise ValueError("--sp and --tp cannot be combined")
    size = dp * sp * tp
    devices, _, rule = placement(size, device)
    inner, name = (sp, "sp") if sp > 1 else (tp, "tp")
    label = "dp" if inner == 1 else name if dp == 1 else f"dp x {name}"
    axis = "seq" if sp > 1 else "model"
    print(f"{label}: {rule}"
          + (f" (data index r // {inner}, {axis} index r % {inner})" if dp > 1 and inner > 1
             else ""), flush=True)
    if devices[0].type == "cuda":
        from geoldm_tpu_torch.ops import cuda_build

        cuda_build.build()
    threads = max(1, torch.get_num_threads() // size)
    with tempfile.TemporaryDirectory() as store:
        torch.multiprocessing.spawn(
            _rank_main, args=(dp, sp, fn, args, device, store, threads, tp),
            nprocs=size, join=True)
        with open(os.path.join(store, "result.pkl"), "rb") as f:
            return pickle.load(f)


# ---------------------------------------------------------------------------
# Rows and noise
# ---------------------------------------------------------------------------


def own_rows(b: int, grp: RankGroup) -> slice:
    """This data rank's rows of a global batch of ``b`` (a multiple of the
    group size)."""
    if b % grp.size:
        raise ValueError(f"a global batch of {b} does not split over {grp.size} data ranks")
    n = b // grp.size
    return slice(grp.rank * n, (grp.rank + 1) * n)


def shard_rows(batch: dict, grp: Optional[RankGroup]) -> dict:
    """This data rank's B/D rows of every entry of a global batch (JAX's
    ``shard_batch``); the batch itself with no group."""
    if grp is None:
        return batch
    rows = own_rows(len(next(iter(batch.values()))), grp)
    return {k: v[rows] for k, v in batch.items()}


class GlobalNoise:
    """A noise source (``ops.com.Noise``) drawing for the global batch: each
    draw has the global batch's leading size (the local one times D), is made
    from ``source`` (a ``torch.Generator`` or a callable source, e.g. a
    replay of another framework's draws) and this rank's rows of it are
    returned. Every rank holds the same source, so the ranks together see
    one rank's draws."""

    def __init__(self, source, grp: RankGroup):
        self.source, self.grp = source, grp

    def _global(self, shape):
        return (shape[0] * self.grp.size,) + tuple(shape[1:])

    def _draw(self, kind, shape, *args):
        """The source's ``kind`` draw ("randn", "randint" or "rand", ``args``
        before the shape) at the global shape -> this rank's rows."""
        g = self._global(shape)
        if isinstance(self.source, torch.Generator):
            t = getattr(torch, kind)(*args, g, generator=self.source, device=self.source.device)
        else:
            t = (self.source if kind == "randn" else getattr(self.source, kind))(*args, g)
        t = torch.as_tensor(t)
        if tuple(t.shape) != g:
            raise ValueError(f"noise source returned {tuple(t.shape)}, wanted {g}")
        return t[own_rows(g[0], self.grp)]

    def __call__(self, shape):
        return self._draw("randn", shape)

    def randint(self, low, high, shape):
        return self._draw("randint", shape, low, high)

    def rand(self, shape):
        """Uniforms in [0, 1) (the keep mask of ``train_step.context_keep``)."""
        return self._draw("rand", shape)


def wrap_noise(noise, grp: Optional[RankGroup]):
    """``noise`` as this data rank's ``GlobalNoise`` (itself with no group)."""
    return noise if grp is None else GlobalNoise(noise, grp)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, grp: RankGroup) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks, in a new tensor on ``t``'s
    device (wherever ``t`` lies, the collective runs on ``grp.wire``)."""
    buf = t.detach().to(grp.wire, copy=True)
    dist.all_reduce(buf, group=grp.pg)
    return buf.to(t.device)


def reduce_grads(params, grp: RankGroup, *scalars: torch.Tensor, mean: bool = False):
    """Replace the gradients of ``params`` by their sum over the group (their
    mean with ``mean``) and return the sums or means of ``scalars`` (0-d
    tensors), all in one collective: the SP sum of the slab weights over a
    seq group, then the DP mean of every gradient over a data group."""
    grads = [p.grad for p in params if p.grad is not None]
    parts = [g.reshape(-1) for g in grads] + [s.detach().reshape(1).to(torch.float32)
                                              for s in scalars]
    if not parts:
        return ()
    flat = all_reduce(torch.cat(parts), grp)
    if mean:
        flat = flat / grp.size
    vals = flat.split([g.numel() for g in grads] + [1] * len(scalars))
    for g, v in zip(grads, vals):
        g.copy_(v.view_as(g))
    return tuple(v.reshape(()) for v in vals[len(grads):])


def all_gather_objects(obj, grp: Optional[RankGroup]) -> list:
    """``obj`` of every rank of the group, in rank order ([obj] with no
    group)."""
    if grp is None:
        return [obj]
    out = [None] * grp.size
    dist.all_gather_object(out, obj, group=grp.pg)
    return out



# ---------------------------------------------------------------------------
# Tensor parallelism: JAX's rule, the shards and their gather
# ---------------------------------------------------------------------------


def jax_last_dim(p: torch.Tensor) -> int:
    """The last dimension of the JAX leaf that ``p`` (a parameter of the
    port's upstream layout) comes from. ``utils.convert._lin_out`` writes a
    JAX linear layer's ``w`` (in, out) transposed, as the ``Linear`` weight
    (out, in), and its ``b`` (out,) as it is; every other parameter leaf
    (the learned schedule's ``gamma_0``, ``gamma_1``) is 1-D and written as
    it is. So JAX's last dimension is dim 0 of every port parameter."""
    return int(p.shape[0])


def tp_sharded(p: torch.Tensor, hidden_nf: Optional[int], tp: int) -> bool:
    """JAX's rule (``geoldm_tpu/parallel/sharding.py:52-68``), copied by
    shape: a parameter is sharded over the T model ranks iff T > 1 and its
    JAX leaf's last dimension equals ``hidden_nf``, biases included, and
    whatever else has that width by coincidence (an ``embedding_out`` whose
    output is ``nf`` wide, a gamma network layer of ``nf`` units)."""
    return tp > 1 and bool(hidden_nf) and p.dim() >= 1 and jax_last_dim(p) == hidden_nf


def own_shard(t: torch.Tensor, grp: RankGroup) -> torch.Tensor:
    """This model rank's rows of dim 0 of a sharded tensor (JAX's last
    dimension: the model index m holds columns m*nf/T..(m+1)*nf/T), a view
    that shares ``t``'s storage: the inverse of ``gather_shards``."""
    return t[own_rows(t.shape[0], grp)]


@torch.no_grad()
def gather_shards(shards, grp: RankGroup, out=None) -> list:
    """Every model rank's rows of each tensor of ``shards`` (this rank's
    rows, each [nf/T, ...]) put back together in rank order, in one flat
    all_gather on ``grp.wire`` -> the full tensors ([nf, ...], new, on the
    shards' device), or written into ``out`` (the full tensors) when
    given."""
    shards = list(shards)
    if not shards:
        return []
    dev = shards[0].device
    mine = torch.cat([s.reshape(-1) for s in shards]).to(grp.wire)
    flat = torch.empty((grp.size, mine.numel()), dtype=mine.dtype, device=grp.wire)
    dist.all_gather(list(flat.unbind(0)), mine, group=grp.pg)
    flat = flat.to(dev)
    if out is None:
        out = [torch.empty((s.shape[0] * grp.size,) + tuple(s.shape[1:]), dtype=s.dtype,
                           device=dev) for s in shards]
    off = 0
    for s, full in zip(shards, out):
        n = s.numel()
        full.view(grp.size, n).copy_(flat[:, off:off + n])
        off += n
    return out
