"""How the EGNN computes (port of ``geoldm_tpu/nn/core.py:24-94``): the
``ComputeSpec`` a compute-dtype name resolves to, and the linear layer that
honours it.

The port serves seven names:

- ``float32``, ``pallas``, ``xla``: the f32 kernels (JAX's two backends are
  one route here: the hand-written kernels on the card, their plain
  versions on the CPU).
- ``bfloat16``, ``bfloat16_pallas``: every matrix product of the EGNN takes
  bf16 operands and accumulates in f32; activations, sums, biases and the
  schedule algebra stay f32 (JAX's ``_matmul`` / ``linear``). On the card
  they run the bf16 variants of kernels #1, #3, #4 and #6, and under grad
  those of the backward kernels #2, #5 and #7. With ``float32`` and
  ``pallas`` they are the training CLIs' choices, as JAX's.
- ``bfloat16_pallas`` with ``GEOLDM_PALLAS_EDGE_LOWP=1`` in the environment
  (JAX's switch, ``pallas_egnn.py:49-55``, read here when the name is
  resolved): as ``bfloat16``, and where JAX's Pallas path keeps a molecule
  whole (``ops.egnn_block.whole_molecule``) the block's edge chain runs in
  bf16 too (``edge_lowp``, ``BF16_EDGE_LOWP``): kernels #1/#2's
  low-precision variants on the card. Under ``bfloat16`` (JAX's XLA
  backend), the ``full`` names, SP and the row-tiled sizes the switch
  changes nothing, as in JAX.
- ``bfloat16_full`` (sampling only, as in JAX): the same kernels. JAX's
  ``full`` also casts the activations and parameters to bf16
  (``geoldm_tpu/nn/dynamics.py:39-49``); the port keeps them in f32, so it
  is at least as accurate.
- ``bfloat16_mixed``: ``bfloat16_full`` with the last ``round(0.1 * K)``
  sampler steps and the final p(x | z0) step in f32 (``mixed_tail``,
  ``diffusion/vdm.py``).

JAX's sequence-parallel spec (``sp_mesh``) and Pallas interpret mode are
TPU-side options and have no counterpart.

A name is resolved once, where it enters: the sampler (``vdm.vdm_sample``,
``latent.ldm_sample``) and the NLL (``latent.ldm_nll``, ``vae.vae_nll``),
which the train step and the eval NLL call. Below them the
denoiser, the encoder and decoder, the EGNN and the kernel wrappers take
the spec's ``operand`` alone: None (f32), ``torch.bfloat16`` or
``BF16_EDGE_LOWP``.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class _EdgeLowp:
    """The type of ``BF16_EDGE_LOWP``."""

    def __repr__(self):
        return "BF16_EDGE_LOWP"


# The operand dtype of ``bfloat16_pallas`` under GEOLDM_PALLAS_EDGE_LOWP=1:
# bf16 products as ``torch.bfloat16``, and in a whole-molecule block the edge
# chain in bf16 (``nn.egnn``'s plain version, kernels #1/#2's low-precision
# variants). ``operand_dtype`` maps it to ``torch.bfloat16``.
BF16_EDGE_LOWP = _EdgeLowp()


def edge_lowp_enabled() -> bool:
    """JAX's switch (``pallas_egnn.py:_edge_lowp_enabled``): the variable
    GEOLDM_PALLAS_EDGE_LOWP set to ``1``."""
    return os.environ.get("GEOLDM_PALLAS_EDGE_LOWP", "0") == "1"


def operand_dtype(dtype):
    """The products' operand dtype of an operand value (``ComputeSpec.operand``):
    None, or ``torch.bfloat16`` for both bf16 values."""
    return torch.bfloat16 if dtype is BF16_EDGE_LOWP else dtype


class ComputeSpec(NamedTuple):
    """``dtype``: None (f32) or ``torch.bfloat16`` (bf16 matrix-product
    operands, f32 accumulation). ``full``: the sampler-level low-precision
    mode. ``mixed_tail``: the fraction of final sampler steps forced to f32
    under ``full``. ``edge_lowp``: the edge chain of a whole-molecule block
    in bf16 as well (``bfloat16_pallas`` under GEOLDM_PALLAS_EDGE_LOWP=1).
    (JAX's ``backend`` has no field: its 'xla' and 'pallas' run the same
    kernels here, and only ``edge_lowp`` tells them apart.)"""

    dtype: Optional[torch.dtype] = None
    full: bool = False
    mixed_tail: float = 0.0
    edge_lowp: bool = False

    @property
    def operand(self):
        """What the model below the sampler or NLL takes: ``dtype``, or
        ``BF16_EDGE_LOWP`` with ``edge_lowp``."""
        return BF16_EDGE_LOWP if self.edge_lowp else self.dtype


COMPUTE_DTYPES = ("float32", "pallas", "xla", "bfloat16", "bfloat16_pallas", "bfloat16_full",
                  "bfloat16_mixed")


def resolve_compute(compute_dtype) -> ComputeSpec:
    """None, a ``ComputeSpec``, one of ``COMPUTE_DTYPES``, a torch dtype
    (float32, bfloat16) or ``BF16_EDGE_LOWP`` -> ComputeSpec
    (``nn/core.py:resolve_compute``). ``bfloat16_pallas`` reads
    GEOLDM_PALLAS_EDGE_LOWP here."""
    if compute_dtype is None:
        return ComputeSpec()
    if isinstance(compute_dtype, ComputeSpec):
        return compute_dtype
    if compute_dtype is BF16_EDGE_LOWP:
        return ComputeSpec(torch.bfloat16, edge_lowp=True)
    if isinstance(compute_dtype, str):
        if compute_dtype in ("float32", "pallas", "xla"):
            return ComputeSpec()
        if compute_dtype == "bfloat16":
            return ComputeSpec(torch.bfloat16)
        if compute_dtype == "bfloat16_pallas":
            return ComputeSpec(torch.bfloat16, edge_lowp=edge_lowp_enabled())
        if compute_dtype == "bfloat16_full":
            return ComputeSpec(torch.bfloat16, True)
        if compute_dtype == "bfloat16_mixed":
            return ComputeSpec(torch.bfloat16, True, 0.1)
        raise ValueError(f"unknown compute dtype {compute_dtype!r}; the port serves "
                         f"{', '.join(COMPUTE_DTYPES)}")
    if compute_dtype == torch.float32:
        return ComputeSpec()
    if compute_dtype == torch.bfloat16:
        return ComputeSpec(torch.bfloat16)
    raise ValueError(f"unsupported compute dtype {compute_dtype!r}")


def round_operand(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``t`` rounded to ``dtype`` (an operand value: to nearest, ties to
    even) and back to f32; unchanged for None. A product of two bf16 values
    is exact in f32, so an f32 product of rounded operands is a bf16 product
    with f32 accumulation."""
    return t if dtype is None else t.to(operand_dtype(dtype)).float()


def linear(lin: torch.nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """``lin(x)`` with the operands rounded to ``dtype`` and the bias added in
    f32 (``nn/core.py:linear``)."""
    if dtype is None:
        return lin(x)
    return F.linear(round_operand(x, dtype), round_operand(lin.weight, dtype), lin.bias)
