"""The frozen FLOP count equals the program's at the two recipes' shapes."""

import pytest
import tiny  # noqa: F401

from harness import core, flops
from reference import model as R


@pytest.mark.parametrize("cfg_name", ["qm9_ldm", "geom_ldm"])
@pytest.mark.parametrize("n", [9, 19, 29, 48, 64, 104, 184])
def test_counts_equal_the_programs(cfg_name, n):
    from geoldm_tpu_torch.utils import flops as program

    from harness import model as HM

    cfg = core.config(cfg_name)
    M = R.describe(cfg)
    mc = HM.program_config(cfg)
    assert flops.egnn_flops(M["encoder"], n) == program.egnn_flops(mc.vae.encoder_egnn, n)
    assert flops.egnn_flops(M["decoder"], n) == program.egnn_flops(mc.vae.decoder_egnn, n)
    assert flops.egnn_flops(M["dynamics"], n) == program.egnn_flops(mc.dynamics.egnn, n)
    assert flops.train_step_flops(M, n) == program.train_step_flops(mc, n)
    assert flops.sample_flops(M, n, M["T"]) == program.sample_flops(mc, n)


def test_useful_train_flops_leave_out_the_encoders_backward():
    M = R.describe(core.config("qm9_ldm"))
    enc = flops.egnn_flops(M["encoder"], 29)
    assert flops.train_step_flops(M, 29) - flops.useful_train_flops(M, 29) == 2 * enc


def test_least_time_is_the_larger_bound():
    M = R.describe(core.config("geom_ldm"))
    e = M["dynamics"]
    fast = flops.least_seconds(e, [48] * 32, 1e30)  # FLOPs free: the bytes bound
    assert fast > 0
    per_block = 4 * (flops.block_weights(e) + 32 * 2 * (48 * 256 + 48 * 3)) / flops.HBM_BYTES_PER_S
    assert abs(fast - e["layers"] * per_block) < 1e-15
    slow = flops.least_seconds(e, [48] * 32, 1e9)
    assert slow > fast
    assert flops.least_seconds(e, [48] * 32, 1e9, backward=True) == pytest.approx(3 * slow)
