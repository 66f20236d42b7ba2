"""What a bf16 test needs to tell the precisions apart (no JAX: the card
tests import it too).

A bf16 variant and its plain version round the same operands but sum in
other orders, so an operand at a rounding tie flips by one bf16 ulp and the
largest difference between them is that of a flip. The gate on the largest
difference is therefore loose against the rounding itself. The mean
difference is not set by the rare flips: a bf16 variant must be at least
``SEPARATION`` times closer, on the mean, to its plain bf16 version than to
the plain f32 version, and than to a plain version that leaves one rounding
site in f32 (``unrounded``). A variant that ran f32 products, or skipped a
site, fails that."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from geoldm_tpu_torch.nn import core
from geoldm_tpu_torch.nn import egnn as nn_egnn
from geoldm_tpu_torch.ops import egnn_tiled

SEPARATION = 10.0
# 'edge_feat': the first layer's edge features (the pair distances, [..., E]);
# 'gate': the products with one output (the attention gate, the coordinate
# scale w3), both operands.
SITES = ("edge_feat", "gate")


@contextlib.contextmanager
def unrounded(site: str, edge_feat_nf: int):
    """Within the block, the plain bf16 versions (``nn.egnn``'s modules and
    ``ops.egnn_tiled``'s stages) leave ``site``'s operands in f32 and round
    every other product's operands as before."""
    if site not in SITES:
        raise ValueError(site)

    def round_operand(t, dtype):
        if site == "edge_feat" and t.shape[-1] == edge_feat_nf:
            return t
        return core.round_operand(t, dtype)

    def linear(lin, x, dtype=None):
        return core.linear(lin, x, None if site == "gate" and lin.out_features == 1 else dtype)

    modules = (nn_egnn, egnn_tiled)
    saved = [(m, m.round_operand, m.linear) for m in modules]
    for m in modules:
        m.round_operand, m.linear = round_operand, linear
    try:
        yield
    finally:
        for m, r, lin in saved:
            m.round_operand, m.linear = r, lin


def mean_abs(a, b) -> float:
    a, b = (t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t)) for t in (a, b))
    return float((a.double() - b.double()).abs().mean())


def assert_separated(got, want, other, what: str) -> None:
    """``got`` at least SEPARATION times closer to ``want`` than to
    ``other``, on the mean absolute difference."""
    err, dist = mean_abs(got, want), mean_abs(got, other)
    assert SEPARATION * err <= dist, (
        f"{what}: mean|d| {err:.3e} to the bf16 reference, {dist:.3e} to the other: not "
        f"{SEPARATION:g}x apart")
