"""The numbers that decide ``correct``, each against the limit its cell's
workload file states (``check`` there).

Training: the program's first steps against the reference's from the same
initial weights, batches and noise: each step's loss (relative gap), and
per parameter leaf the norm of the first gradient as the optimizer got it,
of the parameters' change after the steps and of the EMA's change; a leaf's
gap is |norm(program) - norm(reference)| over the larger of the
reference's norm and the median leaf's, and the number is the widest gap
over the leaves (the first gradient) or the median leaf's (the changes).
Leaves whose reference gradient is under a thousandth of the median leaf's
are left out (they move by round-off alone).

Sampling: for a sample of the molecules the timed path returned, each
stage the run passed through (the start, the jumps, the final step, the
decoder) against the float32 reference from the run's own state before it,
in units of the stage's own rounding; and the served molecules against the
decoder's output.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

from harness.core import Check


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def counted_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return sorted(k for k, v in ref_grad.items() if v >= 1e-3 * med)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> List[float]:
    """Each counted leaf's |norm(program) - norm(reference)| over the larger
    of the reference's norm and the median leaf's."""
    med = statistics.median(ref[k] for k in leaves)
    return [abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med) for k in leaves]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog``: {losses, grad1, change, ema_change} as per-leaf norms (and
    losses); ``ref``: ``reference.train.follow``'s output. The changes after
    the steps are compared by the median leaf's gap: the widest swings with
    rounding on some seeds (``*_widest_gap``, readings), where the second
    step's loss explodes and its clipped gradient of a small decoder leaf
    is a cancelling sum."""
    rg = norms(ref["grad1"])
    leaves = counted_leaves(rg)
    change = leaf_gaps(prog["change"], norms(ref["change"]), leaves)
    ema = leaf_gaps(prog["ema_change"], norms(ref["ema_change"]), leaves)
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-12)
                        for a, b in zip(prog["losses"], ref["losses"])),
        "grad1_gap": max(leaf_gaps(prog["grad1"], rg, leaves)),
        "change_gap": statistics.median(change),
        "ema_change_gap": statistics.median(ema),
        "change_widest_gap": max(change),
        "ema_change_widest_gap": max(ema),
    }


def sample_detail(stages) -> dict:
    """An empty record of a sampling check's terms (``sample_numbers``);
    ``stages``: ``reference.sample.stage_precisions``."""
    return {"stages": stages, "num": [], "unit": [], "dec_num": [], "dec_unit": [],
            "served": [], "dropped": 0, "stages_all": 0}


def served_gap(x_served, x_dec, t_served, t_dec) -> float:
    """A served molecule against the decoder's output: the widest coordinate
    gap plus the atoms served another type (a value the same on both sides,
    a non-finite one included, is no gap; one that differs is inf where it
    is not finite)."""
    same = (x_served == x_dec) | (torch.isnan(x_served) & torch.isnan(x_dec))
    gap = torch.nan_to_num((x_served - x_dec).abs(), nan=float("inf"))
    gap = torch.where(same, torch.zeros_like(gap), gap)
    return float(gap.max()) + float((t_served != t_dec).sum())


def _ratio(num, unit) -> float:
    """The root of the summed squares of ``num`` over that of ``unit``."""
    n = sum(float((t ** 2).sum()) for t in num)
    u = sum(float((t ** 2).sum()) for t in unit)
    return (n / u) ** 0.5 if u > 0 else float("inf")


def sample_numbers(detail: dict) -> Dict[str, float]:
    """A followed sampling run's numbers, over every followed molecule, each
    stage's gap from the float32 reference read in units of how far the
    stage's own precision moves the reference there (the root of the summed
    squares of each; ``reference.sample.teacher``). A stage computed as the
    program states reads about 1 in bf16 units and far under 1 in TF32
    units; one computed a precision lower reads about 1 in TF32 units and
    about 16 in bf16 units.

    - ``first_jump_gap``: the start (z_T) and the first jump.
    - ``jumps_gap``: the other jumps in bf16 (random weights carry their
      states far from any molecule, where a rounding swings more from seed
      to seed than at the first jump).
    - ``tail_gap``: the jumps after the first and the final step in float32
      (``bfloat16_mixed``'s tail), in TF32 units.
    - ``decode_gap``: the decoder's output (coordinates and type logits)
      from the run's decoder input, in its precision's units.
    - ``served_gap``: the served molecules against the decoder's output
      where the model made them: the widest coordinate gap (Angstrom) plus
      the atoms served another type; 0 unless an answer is altered between
      the model and the client.
    - ``dropped_share``: the share of (molecule, stage) terms left out
      because the reference itself leaves float32's range there: a reading."""
    if not detail["served"] or not detail["num"]:
        return {k: float("inf") for k in
                ("first_jump_gap", "jumps_gap", "tail_gap", "decode_gap", "served_gap")}
    jumps, final, _ = detail["stages"]
    num = [torch.as_tensor(t) for t in detail["num"]]
    unit = [torch.as_tensor(t) for t in detail["unit"]]
    later = jumps[1:] + [final]  # stages 2 .. K+1 of num and unit
    groups = {"jumps_gap": [2 + i for i, p in enumerate(later) if p == "bf16"],
              "tail_gap": [2 + i for i, p in enumerate(later) if p == "f32"]}
    out = {"first_jump_gap": _ratio([n[:2] for n in num], [u[1] for u in unit])}
    for name, idx in groups.items():
        if idx:
            out[name] = _ratio([n[idx] for n in num], [u[idx] for u in unit])
    out["decode_gap"] = _ratio(detail["dec_num"], detail["dec_unit"])
    out["served_gap"] = max(detail["served"])
    out["dropped_share"] = detail["dropped"] / max(detail["stages_all"], 1)
    return out


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """The compared numbers (those the cell's workload file gives a limit; a
    number the run could not read fails)."""
    return [Check(k, float(numbers.get(k, float("inf"))), float(limits[k])) for k in limits]


def match_rows(d01_split: np.ndarray, n_split: np.ndarray, x: np.ndarray,
               n_atoms: np.ndarray) -> np.ndarray:
    """The split index of each batch row, found by its atom count and its
    second atom's offset from its first (unchanged by centring) -> indices,
    -1 where no single molecule matches."""
    out = np.full(len(n_atoms), -1, dtype=np.int64)
    for r, (n, row) in enumerate(zip(n_atoms, x)):
        d = row[1] - row[0]
        hit = np.nonzero((n_split == n) & (np.abs(d01_split - d).max(axis=1) < 1e-4))[0]
        if len(hit) == 1:
            out[r] = hit[0]
    return out


def centred(pos: np.ndarray, n: int, pad: int) -> np.ndarray:
    """A molecule's coordinates centred on its atoms, padded to ``pad``."""
    p = pos[:n].astype(np.float32)
    out = np.zeros((pad, 3), dtype=np.float32)
    out[:n] = p - p.sum(axis=0, keepdims=True) / np.float32(n)
    return out
