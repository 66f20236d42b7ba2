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
site, fails that. A bf16 backward is held the same way, and also against a
plain backward that rounds one site too many: the cotangent operand of the
transposed products and weight gradients, which the vjp of a bf16 product
keeps in f32 (site ``cotangent``)."""

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
# The backward's sites: the forward's, and 'cotangent': each linear layer's
# cotangent rounded to bf16 before its transposed product and weight
# gradient (the wrong rounding a bf16 mma on the cotangent would make).
BWD_SITES = SITES + ("cotangent",)


class _RoundCotangent(torch.autograd.Function):
    """The identity, whose backward rounds the cotangent to bf16."""

    @staticmethod
    def forward(ctx, t):
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


@contextlib.contextmanager
def unrounded(site: str, edge_feat_nf: int):
    """Within the block, the plain bf16 versions (``nn.egnn``'s modules and
    ``ops.egnn_tiled``'s stages) leave ``site``'s operands in f32 and round
    every other product's operands as before; for ``cotangent``, they also
    round each linear layer's cotangent (its output's gradient) to bf16."""
    if site not in BWD_SITES:
        raise ValueError(site)

    def round_operand(t, dtype):
        if site == "edge_feat" and t.shape[-1] == edge_feat_nf:
            return t
        return core.round_operand(t, dtype)

    def trap(out, dtype):
        return _RoundCotangent.apply(out) if site == "cotangent" and dtype is not None else out

    def linear(lin, x, dtype=None):
        dtype = None if site == "gate" and lin.out_features == 1 else dtype
        return trap(core.linear(lin, x, dtype), dtype)

    def rounded(lin, dtype):
        return tiled_rounded(lin, None if site == "gate" and lin.out_features == 1 else dtype)

    def apply(wb, x):
        return trap(tiled_apply(wb, x), wb[2])

    tiled_rounded, tiled_apply = egnn_tiled._rounded, egnn_tiled._apply
    saved = (nn_egnn.round_operand, nn_egnn.linear, egnn_tiled.round_operand)
    nn_egnn.round_operand, nn_egnn.linear, egnn_tiled.round_operand = round_operand, linear, \
        round_operand
    egnn_tiled._rounded, egnn_tiled._apply = rounded, apply
    try:
        yield
    finally:
        nn_egnn.round_operand, nn_egnn.linear, egnn_tiled.round_operand = saved
        egnn_tiled._rounded, egnn_tiled._apply = tiled_rounded, tiled_apply


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


# A bf16 backward's weight gradients are rounded to bf16 (kernel and plain
# version alike): where the two f32 sums straddle a rounding tie they end one
# bf16 step apart, up to 2^-7 of the element. Ties decided otherwise further
# up (an operand gradient rounded to bf16 on the other side of its tie) shift
# those sums by ~1e-4 relative, so such flips are common; the mean
# separation, not their count, tells a wrong rounding site. A tensor may
# have at most the larger of FLIP_FLOOR elements and a share of them flipped,
# set from the worst readings (PERF.md §2; H100 80GB HBM3 at 700 W):
# - FLIP_SHARE: a bf16 kernel against its plain version on the card (worst
#   20.0% of a 131584-element weight gradient, #2 at N=29; a 3-block EGNN
#   at H=64 27.6% of 192 elements);
# - STEP_FLIP_SHARE: a whole train step on the card against the CPU's,
#   where each kernel's flips move the next one's ties (worst 52% of
#   a 256-element attention weight, QM9 step; 37% GEOM). Twice that is no
#   cap; the separation and the per-element gate hold such a step;
# - JAX_FLIP_SHARE: the CPU's plain bf16 backward of a block or stage
#   against JAX's (worst 2.44% of 9728 elements);
# - JAX_STEP_FLIP_SHARE: a whole CPU train step against JAX's (worst 10.1% of
#   2112 elements);
# - FLIP_FLOOR: a tensor of a few dozen elements (the gate's weight) flips
#   by a few of them at once (worst 8 of 64 against JAX).
FLIP_SHARE = 0.4
STEP_FLIP_SHARE = 0.75
# The gradients a bf16 backward rounds once after their f32 sum, by name
# suffix: the weights', and with the low-precision edge chain also those of
# the biases it casts to bf16 (b2 of the edge and coordinate MLPs, the gate's
# bias); their one-step flips count apart as a weight gradient's.
ROUNDED = ("weight",)
LOWP_ROUNDED = ROUNDED + ("edge_mlp.2.bias", "att_mlp.0.bias", "coord_mlp.2.bias")
JAX_FLIP_SHARE = 0.05
JAX_STEP_FLIP_SHARE = 0.2
FLIP_FLOOR = 16


def flips_allowed(numel: int, share: float) -> float:
    """How many of a tensor's ``numel`` elements may be one bf16 step off."""
    return max(share * numel, FLIP_FLOOR)


def bf16_flips(g, w):
    """Elements where two bf16-valued tensors are neighbouring bf16 values:
    their bit patterns differ by one, with the same sign."""
    gb, wb = (t.to(torch.bfloat16).view(torch.int16).int() for t in (g, w))
    return ((gb - wb).abs() == 1) & ((gb < 0) == (wb < 0))


def bf16_grads_report(names, got, want, want_f32, want_cot=None, rtol=5e-3,
                      flip_share=FLIP_SHARE, separation=SEPARATION, rounded=ROUNDED):
    """A bf16 backward's outputs against its plain bf16 version -> a dict:
    ``problems`` (empty when it passes), ``max_rel`` / ``worst`` (the largest
    max|d| / max(1, max|ref|) and its tensor), ``max_abs`` (the largest
    max|d|), both without the flips, ``mean_err``, ``mean_to_f32``,
    ``mean_to_cotangent`` (the mean over every output element of |d| in
    units of its tensor's max(1, max|ref|)), ``flips`` and ``max_flip_share``
    / ``worst_flip`` (the largest share of a tensor flipped, and its name).
    Every tensor is
    finite and within rtol * max(1, max|ref|) of the reference, a weight
    gradient's one-step flips excepted (``flips_allowed``), and a
    one-element output within the larger of that and its own distance
    between the plain bf16 and f32 versions (the attention bias's gradient
    sums the gate's over every edge with cancellation, and bf16 moves that
    sum by up to a few percent of itself); on that
    mean the result is SEPARATION times closer to the plain bf16 version
    than to the plain f32 one and than to ``want_cot`` (the plain version
    rounding the cotangents), when given. (Each element counts once, so a
    one-element bias, whose sum over every edge carries the f32 order's
    noise, does not outweigh a weight matrix.) ``flip_share`` and
    ``separation`` replace FLIP_SHARE and SEPARATION (JAX_FLIP_SHARE against
    JAX; STEP_FLIP_SHARE and a smaller separation for a whole train step on
    the card, whose kernels' tie flips compound through every block).
    ``rounded``: the name suffixes of the tensors rounded once to bf16 (the
    weight gradients; LOWP_ROUNDED for the low-precision chain), whose
    flips count apart."""
    out = {"problems": [], "max_rel": 0.0, "worst": "", "max_abs": 0.0, "mean_err": 0.0,
           "mean_to_f32": 0.0, "mean_to_cotangent": 0.0, "flips": 0, "max_flip_share": 0.0,
           "worst_flip": ""}
    count = 0
    for i, (name, g, w, w32) in enumerate(zip(names, got, want, want_f32)):
        g, w, w32 = (t.detach().double() for t in (g, w, w32))
        if not bool(torch.isfinite(g).all()):
            out["problems"].append(f"{name} not finite")
        scale = max(1.0, float(w.abs().max()))
        diff = (g - w).abs()
        if name.endswith(rounded):
            flip = bf16_flips(g, w)
            n_flip = int(flip.sum())
            if n_flip > flips_allowed(g.numel(), flip_share):
                out["problems"].append(f"{name}: {n_flip} of {g.numel()} one bf16 step off")
            out["flips"] += n_flip
            if n_flip / g.numel() >= out["max_flip_share"]:
                out["max_flip_share"], out["worst_flip"] = n_flip / g.numel(), name
            diff = diff.masked_fill(flip, 0.0)
        out["max_abs"] = max(out["max_abs"], float(diff.max()))
        d = float(diff.max()) / scale
        if g.numel() == 1:
            d = min(d, rtol * float(diff.max()) / max(float((w - w32).abs().max()), 1e-30))
        if d > rtol:
            out["problems"].append(f"{name}: max|d| {d:.3e} of max(1, max|ref|) > {rtol}")
        if d >= out["max_rel"]:
            out["max_rel"], out["worst"] = d, name
        out["mean_err"] += float((g - w).abs().sum()) / scale
        out["mean_to_f32"] += float((g - w32).abs().sum()) / scale
        if want_cot is not None:
            out["mean_to_cotangent"] += float((g - want_cot[i].detach().double()).abs().sum()
                                              ) / scale
        count += g.numel()
    for key in ("mean_err", "mean_to_f32", "mean_to_cotangent"):
        out[key] /= max(count, 1)
    for key, label in (("mean_to_f32", "the plain f32 version"),
                       ("mean_to_cotangent", "the version rounding the cotangents")):
        if (key == "mean_to_f32" or want_cot is not None) and \
                separation * out["mean_err"] > out[key]:
            out["problems"].append(f"mean distance {out[key]:.3e} to {label} is not "
                                   f"{separation:g}x the mean error {out['mean_err']:.3e}")
    return out


# An SP-2 bf16 train step against the same step on one rank: each rank rounds
# its slab's share of the dst projection's gradient and of every weight
# gradient (as JAX's sp_stage_apply does), so the two differ at bf16's own
# level. Per tensor within SP_RTOL * max|ref| (worst readings 7.3e-3 on the
# CPU, 5.2e-3 on an H100); a one-element tensor, where larger, within
# 1/SP_SEPARATION of its own distance between the one-rank bf16 and f32 steps
# (the attention bias's gradient, a sum over every edge with cancellation:
# 2.4e-2 of itself on the CPU, an eighth of that distance). On the mean
# SP_SEPARATION times closer to the one-rank bf16 step than to the f32 one
# (readings 7.6 on the CPU, 18.5 on an H100).
SP_RTOL, SP_SEPARATION = 1e-2, 4.0


def sp_grads_report(got, want, want_f32, rtol=SP_RTOL, separation=SP_SEPARATION):
    """SP-2 bf16 gradients against the one-rank bf16 (``want``) and f32
    (``want_f32``) ones, dicts of name -> numpy array -> a dict:
    ``problems`` (empty when it passes), ``worst_rel`` / ``worst`` (the
    largest max|d| / max|ref| over tensors of more than one element),
    ``one_element`` (the largest such ratio of a one-element tensor),
    ``mean_err`` and ``mean_to_f32`` (the sums over tensors of mean|d| /
    max|ref|)."""
    out = {"problems": [], "worst_rel": 0.0, "worst": "", "one_element": 0.0,
           "mean_err": 0.0, "mean_to_f32": 0.0}
    if set(got) != set(want):
        out["problems"].append("SP and one rank gave gradients to different parameters")
        return out
    for name, w in want.items():
        g = got[name]
        if not np.isfinite(g).all():
            out["problems"].append(f"{name} not finite")
        scale = float(np.abs(w).max())
        d = float(np.abs(g - w).max())
        tol = rtol * scale
        if w.size == 1:
            tol = max(tol, float(np.abs(w - want_f32[name]).max()) / separation)
            out["one_element"] = max(out["one_element"], d / scale if scale else 0.0)
        elif scale and d / scale >= out["worst_rel"]:
            out["worst_rel"], out["worst"] = d / scale, name
        if d > tol:
            out["problems"].append(f"{name}: max|d| {d:.3e} > {tol:.3e}")
        if scale:
            out["mean_err"] += float(np.abs(g - w).mean()) / scale
            out["mean_to_f32"] += float(np.abs(g - want_f32[name]).mean()) / scale
    if separation * out["mean_err"] > out["mean_to_f32"]:
        out["problems"].append(f"mean distance {out['mean_to_f32']:.3e} to the f32 step is not "
                               f"{separation:g}x the mean error {out['mean_err']:.3e}")
    return out
