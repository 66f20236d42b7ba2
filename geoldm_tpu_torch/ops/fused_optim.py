"""A training step's optimizer tail on the card, in three hand-written
launches (``csrc/fused_optim.cu``).

The tail is what a step does after the backward and the SP/DP gradient
sums: the adaptive clip (the global norm, a threshold from the clip's ring
buffer, every gradient scaled in place), torch's AdamW with amsgrad and
the EMA. The train step (``train/train_step.py``) runs it here on CUDA
tensors and as plain PyTorch on the CPU (``train/optim.py``).

``FusedStep`` runs the three launches a step: the squares of every
gradient (two sums under TP: the replicated gradients and this rank's
shards, the second summed over the model ranks by the caller's
``reduce``), the threshold (the norm, the clip's scale, the ring buffer's
entry, on the device), and one elementwise pass that writes the clipped
gradient back to ``p.grad``, steps AMSGrad as torch's foreach path does,
element by element, and moves the EMA of every parameter, those without a
gradient too. It leaves ``optimizer`` a ``torch.optim.AdamW`` whose
``state[p]`` holds ``step``, ``exp_avg``, ``exp_avg_sq`` and
``max_exp_avg_sq`` (allocated at the first step, for parameters with a
gradient only, as torch allocates them), so ``state_dict()`` /
``load_state_dict()`` keep AdamW's format both ways. The steps are 0-d
views of one host tensor, raised once a step; every stepped parameter is
at one step count.

``FusedStep`` takes CUDA tensors or raises: float32, contiguous, on one
device. Its device tables (pointers and sizes of every parameter, moment
and EMA) are built at the first step and again when AdamW's state is
replaced (``load_state_dict``) or the set of parameters with a gradient
changes; the gradients' pointers, which autograd reallocates every step,
go in the launches' parameter blocks, at most 448 a launch.

``launches()`` counts the kernels' launches (norm, threshold, update):
one of each a step up to 448 stepped tensors, one norm and update more for
each further 448.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from geoldm_tpu_torch.ops import cuda_build

norm_launches = 0
threshold_launches = 0
update_launches = 0

# csrc/fused_optim.cu:Tensor and Chunk, field for field.
TENSOR_DTYPE = np.dtype([("p", "<u8"), ("m", "<u8"), ("v", "<u8"), ("vmax", "<u8"),
                         ("e", "<u8"), ("n", "<i8"), ("shard", "<i4"), ("pad", "<i4")])
CHUNK_DTYPE = np.dtype([("tensor", "<i4"), ("index", "<i4")])
MOMENTS = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")

_layout: dict = {}


def launches() -> tuple:
    """(norm, threshold, update) launches in this process."""
    return norm_launches, threshold_launches, update_launches


def reset_launches() -> None:
    global norm_launches, threshold_launches, update_launches
    norm_launches = threshold_launches = update_launches = 0


def _lib():
    lib = cuda_build.library("fused_optim")
    if not _layout:
        out = (ctypes.c_int * 5)()
        lib.fused_optim_layout(out)
        _layout.update(chunk=out[0], norm_chunks=out[1], max_grads=out[2], tensor=out[3],
                       chunk_bytes=out[4])
        if (_layout["tensor"], _layout["chunk_bytes"]) != (TENSOR_DTYPE.itemsize,
                                                           CHUNK_DTYPE.itemsize):
            raise RuntimeError(f"fused_optim: the library's table layout {_layout} is not "
                               "TENSOR_DTYPE / CHUNK_DTYPE")
    return lib


def _check(name: str, t: torch.Tensor, device: torch.device, numel: Optional[int] = None):
    if t.device != device:
        raise ValueError(f"fused_optim: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"fused_optim: {name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"fused_optim: {name} must be contiguous")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"fused_optim: {name} has {t.numel()} elements, expected {numel}")


def _check_optimizer(optimizer) -> None:
    if not isinstance(optimizer, torch.optim.AdamW) or len(optimizer.param_groups) != 1:
        raise ValueError("fused_optim: takes a torch.optim.AdamW with one parameter group")
    group = optimizer.param_groups[0]
    if not group.get("amsgrad") or any(group.get(k) for k in ("maximize", "capturable",
                                                              "differentiable", "fused")):
        raise ValueError("fused_optim: takes AdamW(amsgrad=True) without maximize, "
                         "capturable, differentiable or fused")


class FusedStep:
    """The tail of one train state on the card (module docstring).

    ``shard``: per parameter ``optimizer`` steps, in its order, whether it
    is this rank's shard of a TP-sharded parameter; ``reduce`` sums the
    shards' squares (a 1-element tensor) over the model ranks and returns
    the sum, needed with any shard; ``ema`` / ``sources``: per model
    parameter its EMA and what the EMA averages (empty without EMA), every
    stepped parameter among the sources; ``clip``: the adaptive clip's state
    (``norms``, its ring buffer on the card, ``count``, ``head`` and
    ``advance()``, as ``train.optim.AdaptiveGradClip`` has them) or None
    (the norm alone, no scaling)."""

    def __init__(self, optimizer: torch.optim.Optimizer, shard: Sequence[bool],
                 ema: Sequence[torch.Tensor] = (), sources: Sequence[torch.Tensor] = (),
                 ema_decay: float = 0.0, clip=None,
                 reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        _check_optimizer(optimizer)
        self.params = list(optimizer.param_groups[0]["params"])
        self.shard = [bool(s) for s in shard]
        if len(self.shard) != len(self.params):
            raise ValueError("fused_optim: one shard flag per parameter the optimizer steps")
        if any(self.shard) and reduce is None:
            raise ValueError("fused_optim: TP shards need a reduce over the model ranks")
        self.device = self.params[0].device
        if self.device.type != "cuda":
            raise ValueError(f"fused_optim kernels need CUDA tensors, got {self.device}")
        self.ema, self.sources = list(ema), list(sources)
        if ema_decay > 0 and (not self.ema or len(self.ema) != len(self.sources)):
            raise ValueError("fused_optim: an EMA needs one EMA tensor per source")
        self.ema_decay = float(ema_decay) if self.ema else 0.0
        for i, p in enumerate(self.params):
            _check(f"parameter {i}", p.detach(), self.device)
        for i, (e, s) in enumerate(zip(self.ema, self.sources)):
            _check(f"EMA {i}", e.detach(), self.device, s.numel())
            _check(f"EMA source {i}", s.detach(), self.device)
        if clip is not None:
            _check("the clip's ring buffer", clip.norms, self.device)
        self.optimizer, self.clip, self.reduce = optimizer, clip, reduce
        self._opt_state = optimizer.state
        self._present = None
        self._grads: list = []

    def current(self, optimizer: torch.optim.Optimizer) -> bool:
        """Whether the tables still describe ``optimizer``'s state (a
        ``load_state_dict`` replaces it)."""
        return optimizer is self.optimizer and optimizer.state is self._opt_state

    # -- tables ----------------------------------------------------------

    def _moments(self, p: torch.Tensor) -> dict:
        """AdamW's state of ``p``, allocated as torch's first step does."""
        st = self.optimizer.state[p]
        if not st:
            st["step"] = torch.tensor(0.0, dtype=torch.float32)
            for k in MOMENTS:
                st[k] = torch.zeros_like(p, memory_format=torch.preserve_format)
        missing = [k for k in ("step",) + MOMENTS if k not in st]
        if missing:
            raise ValueError(f"fused_optim: AdamW state without {missing}")
        return st

    def _build(self, present: tuple) -> None:
        _lib()
        chunk, per_block, cap = _layout["chunk"], _layout["norm_chunks"], _layout["max_grads"]
        stepped = [i for i, ok in enumerate(present) if ok]
        if not stepped:
            raise ValueError("fused_optim: no parameter has a gradient")
        states = {i: self._moments(self.params[i]) for i in stepped}
        value = {float(states[i]["step"]) for i in stepped}
        if len(value) != 1:  # the launches share one step's bias corrections
            raise ValueError(f"fused_optim: the parameters with a gradient are at steps "
                             f"{sorted(value)}, not one")
        self.order = stepped
        dtype = states[stepped[0]]["step"].dtype
        self.steps = torch.full((len(stepped),), value.pop(), dtype=dtype)
        for pos, i in enumerate(self.order):
            states[i]["step"] = self.steps[pos]
        src = {(s.data_ptr(), s.numel()): j for j, s in enumerate(self.sources)}
        rows, keep, covered = [], [], set()
        for i in self.order:
            p, st = self.params[i].detach(), states[i]
            for k in MOMENTS:
                _check(f"{k} of parameter {i}", st[k], self.device, p.numel())
            e = 0
            if self.ema_decay > 0:
                j = src.get((p.data_ptr(), p.numel()))
                if j is None:
                    raise ValueError(f"fused_optim: parameter {i} is no EMA source")
                covered.add(j)
                e = self.ema[j].data_ptr()
                keep.append(self.ema[j])
            rows.append((p.data_ptr(), *(st[k].data_ptr() for k in MOMENTS), e, p.numel(),
                         int(self.shard[i]), 0))
            keep += [p, *(st[k] for k in MOMENTS)]
        for j, (e, s) in enumerate(zip(self.ema, self.sources)):
            if self.ema_decay > 0 and j not in covered:  # no gradient: the EMA alone
                rows.append((s.data_ptr(), 0, 0, 0, e.data_ptr(), s.numel(), 0, 0))
                keep += [s, e]
        table = np.array(rows, dtype=TENSOR_DTYPE)
        counts = [math.ceil(int(n) / chunk) for n in table["n"]]
        start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        chunks = np.zeros(int(start[-1]), dtype=CHUNK_DTYPE)
        chunks["tensor"] = np.repeat(np.arange(len(rows), dtype=np.int32), counts)
        chunks["index"] = np.arange(int(start[-1])) - np.repeat(start[:-1], counts)
        # Launches: runs of at most `cap` stepped tensors.
        n_stepped = len(self.order)
        self.ranges = [[t0, min(t0 + cap, n_stepped), int(start[t0]),
                        int(start[min(t0 + cap, n_stepped)])]
                       for t0 in range(0, n_stepped, cap)]
        self.ranges[-1].append(int(start[-1]))  # the last update takes the EMA-only chunks
        for r in self.ranges[:-1]:
            r.append(r[3])
        blocks = [math.ceil((r[3] - r[2]) / per_block) for r in self.ranges]
        self.slots = np.concatenate([[0], np.cumsum(blocks)]).astype(int).tolist()
        dev = self.device
        self.table = torch.from_numpy(table.view(np.uint8)).to(dev)
        self.chunks = torch.from_numpy(chunks.view(np.uint8)).to(dev)
        self.partials = torch.zeros(2 * max(1, self.slots[-1]), dtype=torch.float64, device=dev)
        self.counter = torch.zeros(1, dtype=torch.int32, device=dev)
        self.sums = torch.zeros(2, dtype=torch.float32, device=dev)
        self.scale = torch.ones(1, dtype=torch.float32, device=dev)
        self.any_shard = any(self.shard[i] for i in self.order)
        self._keep = keep  # the table's pointers stay valid while it lives
        self._present = present

    # -- the step --------------------------------------------------------

    def clip_norm(self) -> torch.Tensor:
        """The first two launches: the global norm of the gradients (a 0-d
        device tensor, returned) and, with a clip, its scale and ring-buffer
        entry; the clip's counters advance."""
        global norm_launches, threshold_launches
        grads = [p.grad for p in self.params]
        present = tuple(g is not None for g in grads)
        if present != self._present:
            self._build(present)
        ptrs = []
        for i in self.order:
            g, p = grads[i], self.params[i]
            if (g.dtype != torch.float32 or not g.is_contiguous() or g.device != self.device
                    or g.numel() != p.numel()):
                _check(f"gradient of parameter {i}", g, self.device, p.numel())
            ptrs.append(g.data_ptr())
        self._grads = [(ctypes.c_void_p * (r[1] - r[0]))(*ptrs[r[0]:r[1]]) for r in self.ranges]
        lib = _lib()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        for r, arr, slot in zip(self.ranges, self._grads, self.slots):
            if r[3] == r[2]:  # empty tensors alone
                continue
            _ok(lib, lib.fused_optim_norm(
                self.table.data_ptr(), self.chunks.data_ptr(), r[2], r[3], r[0], arr, len(arr),
                self.partials.data_ptr(), slot, self.counter.data_ptr(), self.slots[-1],
                self.sums.data_ptr(), stream), "norm")
            norm_launches += 1
        shard_sum = self.reduce(self.sums[1:2]) if self.any_shard else None
        grad_norm = torch.empty((), dtype=torch.float32, device=self.device)
        clip = self.clip
        ring = (None, 0, 0, 0) if clip is None else (clip.norms.data_ptr(), clip.count,
                                                      clip.head, clip.norms.shape[0])
        _ok(lib, lib.fused_optim_threshold(
            self.sums.data_ptr(), None if shard_sum is None else shard_sum.data_ptr(), *ring,
            grad_norm.data_ptr(), self.scale.data_ptr(), stream), "threshold")
        threshold_launches += 1
        if clip is not None:
            clip.advance()
        return grad_norm

    def update(self) -> None:
        """The third launch: clip, AMSGrad and EMA with the gradients that
        ``clip_norm`` took."""
        global update_launches
        group = self.optimizer.param_groups[0]
        lr, (beta1, beta2) = float(group["lr"]), group["betas"]
        beta1, beta2 = float(beta1), float(beta2)
        eps, wd = float(group["eps"]), float(group["weight_decay"])
        self.steps += 1
        lib = _lib()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        d = self.ema_decay
        # torch.optim.adam._multi_tensor_adam's scalars, in float64
        step = float(self.steps[0])
        bc1 = 1 - beta1 ** step
        bc2 = 1 - beta2 ** step
        for r, arr in zip(self.ranges, self._grads):
            if r[4] == r[2]:
                continue
            _ok(lib, lib.fused_optim_update(
                self.table.data_ptr(), self.chunks.data_ptr(), r[2], r[4], r[0], arr, len(arr),
                self.scale.data_ptr(), 1 - lr * wd, 1 - beta1, beta2, 1 - beta2,
                (lr / bc1) * -1, bc2 ** 0.5, eps, d, 1.0 - d, int(d > 0), stream), "update")
            update_launches += 1
        self._grads = []


def _ok(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"fused_optim {what} kernel launch failed: "
                           f"{lib.fused_optim_error_string(code).decode()}")
