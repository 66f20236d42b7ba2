"""Plain PyTorch GeoLDM sampling: the few-step DDIM sampler in latent space,
then the VAE decode (GeoLDM's EnLatentDiffusion.sample; the DDIM jump of
Song et al. 2021, eq. 12), and the way a request's molecules are split
into size-bucketed chunks, each with its own noise stream.

With random weights the denoiser does not undo the noise, so a DDIM
trajectory is unstable: a rounding in its first steps moves the final
molecule by far more than the rounding. So the reference follows a run
step by step (``teacher``), as a language model's served tokens are
scored one position at a time: from the run's own state before each stage
(each jump, the final step, the decoder) it recomputes the stage in
float32 and measures how far the run's result lies from it, beside how
far the stage moves when its products take the operands of the precision
the run states for it (``stage_precisions``, ``UNIT``). Every chunk draws its noise from a generator seeded
from (request seed, chunk index): z_T (coordinates, then latent
features), one draw a jump and one for the final step, each at the
chunk's whole shape; the chosen rows are computed alone, since every
molecule of a chunk is computed on its own. ``trajectory`` is the
reference's own run, which the check's control puts in the program's
place.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from reference import model as R


def chunk_seed(seed: int, chunk_index: int) -> int:
    """The noise seed of one chunk of a request."""
    return int(np.random.SeedSequence([int(seed) % 2**64, chunk_index]).generate_state(
        1, dtype=np.uint64)[0])


def plan(sizes, batch_size: int, buckets) -> List[tuple]:
    """(chunk index, pad, molecule indices, padded sizes) of each chunk a
    request of ``sizes`` is split into: molecules grouped by the smallest
    bucket (a multiple of 8) that holds them, ``batch_size`` at a time, the
    last chunk of a bucket padded to the next power of two by repeating its
    last size."""
    sizes = np.asarray(sizes)
    bs = sorted({-(-int(b) // 8) * 8 for b in buckets})
    need = -(-int(sizes.max()) // 8) * 8
    if bs[-1] < need:
        bs.append(need)
    out = []
    for i, pad in enumerate(bs):
        lo = bs[i - 1] if i else 0
        idx = np.where((sizes > lo) & (sizes <= pad))[0]
        for start in range(0, len(idx), batch_size):
            chunk = idx[start:start + batch_size]
            s = sizes[chunk]
            if len(s) < batch_size:
                k = min(1 << (len(s) - 1).bit_length() if len(s) > 1 else 1, batch_size)
                s = np.concatenate([s, np.full(k - len(s), s[-1], dtype=s.dtype)])
            out.append((len(out), pad, chunk, s))
    return out


def _gamma(P, t: torch.Tensor, T: int) -> torch.Tensor:
    return P["gamma.gamma"][torch.round(t * T).long()][..., None]


def _sig(g):
    return torch.sqrt(torch.sigmoid(g))


def _alp(g):
    return torch.sqrt(torch.sigmoid(-g))


class _Chunk:
    """One chunk's masks and its noise stream, replayed for chosen rows."""

    def __init__(self, P, M, seed, chunk_index, padded_sizes, pad, rows):
        self.dev = P["gamma.gamma"].device
        self.lat = M["latent_nf"]
        self.b, self.pad = len(padded_sizes), pad
        mask = (torch.arange(pad, device=self.dev)[None, :]
                < torch.as_tensor(np.asarray(padded_sizes), device=self.dev)[:, None])
        self.rows = torch.as_tensor(np.asarray(rows), device=self.dev, dtype=torch.long)
        self.mask = mask.to(torch.float32)[..., None][self.rows]
        self.gen = torch.Generator(device=self.dev).manual_seed(chunk_seed(seed, chunk_index))

    def noise(self):
        """The chunk's next draw (coordinates, then latent features, each at
        the chunk's whole shape), the chosen rows masked and centred."""
        kw = dict(generator=self.gen, device=self.dev, dtype=torch.float32)
        x = torch.randn((self.b, self.pad, 3), **kw)[self.rows]
        h = torch.randn((self.b, self.pad, self.lat), **kw)[self.rows]
        return torch.cat([R.remove_mean(x * self.mask, self.mask), h * self.mask], -1)


def _grid(n_steps: int, T: int):
    tau = [((n_steps - k) * T) // n_steps for k in range(n_steps + 1)]
    return torch.tensor(tau, dtype=torch.float32) / T


def _jump(P, M, c: _Chunk, k: int, grid, z, eps_hat, eta: float):
    """The DDIM jump k (z_t -> z_s) given the denoiser's output -> (z_s, the
    coefficient on eps_hat)."""
    r = z.shape[0]
    t = torch.full((r, 1), float(grid[k]), device=c.dev)
    s = torch.full((r, 1), float(grid[k + 1]), device=c.dev)
    g_t, g_s = _gamma(P, t, M["T"]), _gamma(P, s, M["T"])
    s2_ts = -torch.expm1(F.softplus(g_s) - F.softplus(g_t))
    sigma_tilde = eta * (torch.sqrt(s2_ts) * _sig(g_s) / _sig(g_t))
    dir_coef = torch.sqrt(torch.clamp(_sig(g_s) ** 2 - sigma_tilde ** 2, min=0.0))
    x_pred = (z - _sig(g_t) * eps_hat) / _alp(g_t)
    zs = _alp(g_s) * x_pred + dir_coef * eps_hat + sigma_tilde * c.noise()
    zs = torch.cat([R.remove_mean(zs[..., :3], c.mask), zs[..., 3:]], -1)
    return zs, dir_coef - _alp(g_s) * _sig(g_t) / _alp(g_t)


def _final(P, M, c: _Chunk, z, eps_hat):
    """The final step p(z_0 | z): -> (the decoder's input, the coefficient
    on eps_hat)."""
    zeros = torch.zeros((z.shape[0], 1), device=c.dev)
    g0 = _gamma(P, zeros, M["T"])
    mu = (z - _sig(g0) * eps_hat) / _alp(g0)
    zxh = mu + torch.exp(0.5 * g0) * c.noise()
    x = R.remove_mean(zxh[..., :3] * c.mask, c.mask)
    return torch.cat([x, zxh[..., 3:]], -1), -_sig(g0) / _alp(g0)


def stage_precisions(precision: str, n_steps: int):
    """The precision each stage of a sampling run computes in under a compute
    dtype (the program's rule, frozen): -> (one for each of the K jumps, the
    final step's, the decoder's), each "bf16" (bf16 products, f32
    accumulation) or "f32". ``bfloat16_mixed`` runs its last round(0.1 K)
    jumps and the final step in float32, the other jumps and the decoder in
    bf16; ``float32`` runs everything in float32."""
    if precision in ("float32", "pallas", "xla"):
        return ["f32"] * n_steps, "f32", "f32"
    tail = int(round(0.1 * n_steps)) if precision == "bfloat16_mixed" else 0
    jumps = ["bf16" if k < n_steps - tail else "f32" for k in range(n_steps)]
    return jumps, ("f32" if tail else "bf16"), "bf16"


@torch.no_grad()
def trajectory(P, M, seed: int, chunk_index: int, padded_sizes, pad: int, rows, n_steps: int,
               eta: float, q_jumps=None, q_final=None, q_dec=None) -> dict:
    """The reference's own run of the chosen ``rows`` of one chunk, jump k's
    products' operands rounded by ``q_jumps[k]``, the final step's by
    ``q_final`` and the decoder's by ``q_dec`` (None: float32) -> {z: the
    denoiser's K+1 inputs, dec_in, x, h} (what the program records of its
    own run)."""
    c = _Chunk(P, M, seed, chunk_index, padded_sizes, pad, rows)
    grid = _grid(n_steps, M["T"])
    q_jumps = q_jumps or [None] * n_steps
    z = c.noise()
    states = []
    for k in range(n_steps):
        states.append(z)
        t = torch.full((z.shape[0], 1), float(grid[k]), device=c.dev)
        eps_hat = R.dynamics(P, M, t, z, c.mask, q_jumps[k])
        z, _ = _jump(P, M, c, k, grid, z, eps_hat, eta)
    states.append(z)
    eps0 = R.dynamics(P, M, torch.zeros((z.shape[0], 1), device=c.dev), z, c.mask, q_final)
    dec_in, _ = _final(P, M, c, z, eps0)
    x, h = R.decode(P, M, dec_in[..., :3], dec_in[..., 3:], c.mask, q_dec)
    return {"z": states, "dec_in": dec_in, "x": x, "h": h}


def _row_norm(t, mask):
    return (t * mask).reshape(t.shape[0], -1).norm(dim=1)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest even), back in float32: the
    operands of a bf16 product with float32 accumulation."""
    return t.to(torch.bfloat16).to(torch.float32)


# A stage's own rounding, whose size is the unit a stage's gap is read in,
# and the next precision below it, which the check's control computes in.
UNIT = {"bf16": bf16_round, "f32": R.tf32_round}
BELOW = {"bf16": R.fp8_round, "f32": R.tf32_round}


@torch.no_grad()
def teacher(P, M, seed: int, chunk_index: int, padded_sizes, pad: int, rows, n_steps: int,
            eta: float, states, dec_in, dec_out, stages) -> dict:
    """Follow a run's own states step by step (``states``: the K+1 denoiser
    inputs of the chosen rows; ``dec_in``, ``dec_out``: the decoder's input
    and its output (x, h)), each stage recomputed in float32 from the run's
    state before it; ``stages``: ``stage_precisions``. -> {num: [K+2, rows],
    the distance of the run's start, each jump's and the final step's
    result from the reference's; unit: [K+2, rows], how far the same stage
    moves when the reference's products take the operands of the stage's
    own precision (``UNIT``; 0 for the start, which is the chunk's noise);
    dec_num, dec_unit: [rows], the same for the decoder's output; dropped,
    stages: the (row, stage) terms left out by ``_stage`` and all of them}."""
    jumps, final, dec = stages
    c = _Chunk(P, M, seed, chunk_index, padded_sizes, pad, rows)
    grid = _grid(n_steps, M["T"])
    z0 = c.noise()
    terms = [(_row_norm(states[0] - z0, c.mask), torch.zeros(z0.shape[0], device=c.dev),
              torch.ones(z0.shape[0], dtype=torch.bool, device=c.dev))]
    for k in range(n_steps):
        t = torch.full((z0.shape[0], 1), float(grid[k]), device=c.dev)
        eps_hat = R.dynamics(P, M, t, states[k], c.mask)
        eps_own = R.dynamics(P, M, t, states[k], c.mask, UNIT[jumps[k]])
        nxt, coef = _jump(P, M, c, k, grid, states[k], eps_hat, eta)
        terms.append(_stage(states[k + 1], nxt, coef * (eps_own - eps_hat), c.mask))
    zeros = torch.zeros((z0.shape[0], 1), device=c.dev)
    eps0 = R.dynamics(P, M, zeros, states[n_steps], c.mask)
    eps0_own = R.dynamics(P, M, zeros, states[n_steps], c.mask, UNIT[final])
    fin, coef = _final(P, M, c, states[n_steps], eps0)
    terms.append(_stage(dec_in, fin, coef * (eps0_own - eps0), c.mask))
    ref = torch.cat(R.decode(P, M, dec_in[..., :3], dec_in[..., 3:], c.mask), -1)
    own = torch.cat(R.decode(P, M, dec_in[..., :3], dec_in[..., 3:], c.mask, UNIT[dec]), -1)
    dec_num, dec_unit, dec_ok = _stage(torch.cat(dec_out, -1), ref, own - ref, c.mask)
    num, unit, ok = (torch.stack(t) for t in zip(*terms))
    return {"num": num, "unit": unit, "dec_num": dec_num, "dec_unit": dec_unit,
            "dropped": int((~ok).sum()) + int((~dec_ok).sum()), "stages": int(ok.numel())
            + int(dec_ok.numel())}


def _stage(run, ref, shift, mask):
    """One stage's terms for each row: (the distance of the run's result
    from the reference's, the size of the reference's ``shift`` under the
    stage's own rounding, whether the row counts). A row counts where the
    reference itself is finite there; the random weights carry some states
    past float32's range, where neither side computes. A run that leaves
    the range where the reference does not reads inf."""
    num, unit = _row_norm(run - ref, mask), _row_norm(shift, mask)
    ok = torch.isfinite(_row_norm(ref, mask)) & torch.isfinite(unit)
    num = torch.nan_to_num(num, nan=float("inf"))
    zero = torch.zeros_like(num)
    return torch.where(ok, num, zero), torch.where(ok, unit, zero), ok
