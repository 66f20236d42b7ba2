"""Faults planted under the timed path, so that a test can see the check
catch each one the cell can have. ``control`` is no fault in the program:
the check then takes the reference, in the next precision below the
cell's, in the program's place."""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "answer", "tail_bf16", "control")


@contextlib.contextmanager
def planted(fault: str):
    """``fault`` planted for the body of the ``with`` (nothing for none, the
    control or a fault in the reference), then taken out again."""
    undo = apply(fault)
    try:
        yield
    finally:
        for mod, name, value in undo:
            setattr(mod, name, value)


def apply(fault: str) -> list:
    """Plant ``fault`` -> [(module, name, original)] to restore."""
    if not fault or fault == "control":
        return []
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "unchanged":
        from geoldm_tpu_torch.train import train_step as ts

        make = ts.make_train_step

        def make_unchanged(*a, **k):
            step = make(*a, **k)

            def frozen(state, batch, noise, keep=None):
                saved = [p.detach().clone() for p in state.model.parameters()]
                ema = ([p.detach().clone() for p in state.ema_model.parameters()]
                       if state.ema_model is not None else [])
                out = step(state, batch, noise, keep)
                for p, s in zip(state.model.parameters(), saved):
                    p.data.copy_(s)
                if ema:
                    for p, s in zip(state.ema_model.parameters(), ema):
                        p.data.copy_(s)
                return out

            return frozen

        ts.make_train_step = make_unchanged
        return [(ts, "make_train_step", make)]
    elif fault == "half_batch":
        from geoldm_tpu_torch.train import train_step as ts

        make = ts.make_train_step

        def make_half(*a, **k):
            step = make(*a, **k)

            def half(state, batch, noise, keep=None):
                b = len(batch["x"])
                return step(state, {key: v[:b // 2] for key, v in batch.items()}, noise, keep)

            return half

        ts.make_train_step = make_half
        return [(ts, "make_train_step", make)]
    elif fault == "tail_bf16":
        # bfloat16_mixed's float32 tail (its last jumps and the final step)
        # run in bf16, as the rest of the run.
        from geoldm_tpu_torch.diffusion import vdm

        tail = vdm.mixed_tail_steps
        vdm.mixed_tail_steps = lambda compute_dtype, n_steps: 0
        return [(vdm, "mixed_tail_steps", tail)]
    elif fault == "answer":
        from geoldm_tpu_torch.diffusion import vae

        decode = vae.decode

        def altered(*a, **k):
            x, h_cat, h_int = decode(*a, **k)
            x = x.clone()
            x[:, 0, 0] += 1.0  # the first atom of every molecule moved by 1 Angstrom
            return x, h_cat.roll(1, dims=2), h_int

        vae.decode = altered
        return [(vae, "decode", decode)]
    return []
