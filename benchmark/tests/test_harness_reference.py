"""The plain reference agrees with the program's plain CPU path at a tiny
width: a sound run of each single-chip cell reads numbers far inside the
cells' limits, and the reference's own pieces match the program's."""

import numpy as np
import pytest
import torch
import tiny

from harness import core, model as HM
from harness.record import Recorder
from reference import model as R
from reference import sample as RS


def _tiny_cfg(name):
    return dict(core.config(name), nf=16, n_layers=2)


@pytest.mark.parametrize("name", ["qm9_ldm", "geom_ldm"])
def test_weights_load_strictly_into_the_programs_model(name):
    cfg = _tiny_cfg(name)
    sd = HM.weights(cfg, 3, "cpu")
    model = HM.program_model(cfg, sd, "cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.numel() for k, v in sd.items() if k not in ("buffer", "vae.buffer", "gamma.gamma"))
    torch.testing.assert_close(model.gamma.gamma, sd["gamma.gamma"], rtol=0, atol=0)


def test_full_width_layouts_count_the_published_parameters():
    for name, n in (("qm9_ldm", 11402526), ("geom_ldm", 5479969)):
        M = R.describe(core.config(name))
        assert sum(int(np.prod(s)) for _, s, _ in R.param_specs(M)) == n


@pytest.mark.parametrize("name", ["qm9_ldm", "geom_ldm"])
def test_denoiser_and_decoder_match_the_program(name):
    cfg = _tiny_cfg(name)
    M = R.describe(cfg)
    sd = HM.weights(cfg, 4, "cpu")
    model = HM.program_model(cfg, sd, "cpu")
    g = torch.Generator().manual_seed(0)
    n = 20
    mask = (torch.arange(24)[None, :] < torch.tensor([n, 13])[:, None]).float()[..., None]
    z = torch.randn((2, 24, 3 + M["latent_nf"]), generator=g) * mask
    t = torch.tensor([[0.3], [0.9]])
    with torch.no_grad():
        torch.testing.assert_close(R.dynamics(sd, M, t, z, mask),
                                   model.dynamics(t, z, mask), rtol=1e-4, atol=1e-5)
        xr, hr = R.decode(sd, M, z[..., :3], z[..., 3:], mask)
        xp, hp = model.vae.decoder(z, mask)
        torch.testing.assert_close(xr, xp, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(hr, hp, rtol=1e-4, atol=1e-4)


def test_reference_follows_the_programs_float32_sampler_to_rounding():
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.train import sampling

    cfg = _tiny_cfg("qm9_ldm")
    M = R.describe(cfg)
    sd = HM.weights(cfg, 5, "cpu")
    model = HM.program_model(cfg, sd, "cpu")
    sizes = np.array([19, 25, 12, 29, 9])
    rec = Recorder(model)
    rec.start()
    oh, _, x, _ = sampling.sample_bucketed(model, 77, get_dataset_info("qm9"), sizes,
                                           batch_size=4, buckets=(16, 24, 32), n_steps=5,
                                           eta=0.0, compute_dtype="float32")
    chunks = rec.stop()
    plan = RS.plan(sizes, 4, (16, 24, 32))
    assert len(chunks) == len(plan)
    for (ci, pad, chunk, padded), c in zip(plan, chunks):
        rows = list(range(len(chunk)))
        own = RS.trajectory(sd, M, 77, ci, padded, pad, rows, 5, 0.0)
        # The same start (the chunk's noise); a free run then drifts apart
        # by rounding alone (random weights make the sampler unstable).
        torch.testing.assert_close(own["z"][0], c["z"][0][:len(rows)], rtol=0, atol=1e-6)
        torch.testing.assert_close(own["z"][1], c["z"][1][:len(rows)], rtol=1e-4, atol=1e-4)
        n = len(rows)
        ref = RS.teacher(sd, M, 77, ci, padded, pad, rows, 5, 0.0,
                         [z[:n] for z in c["z"]], c["dec_in"][:n],
                         tuple(t[:n] for t in c["dec_out"]), RS.stage_precisions("float32", 5))
        # Every stage within a small share of what TF32 operands would move it.
        assert float(ref["num"][1:].norm()) < 1e-2 * float(ref["unit"][1:].norm())
        assert float(ref["dec_num"].norm()) < 1e-2 * float(ref["dec_unit"].norm())
        for j, i in enumerate(chunk):
            k = int(sizes[i])
            assert torch.equal(torch.as_tensor(x[i, :k]), c["dec_out"][0][j, :k])
            assert torch.equal(torch.as_tensor(oh[i, :k]).argmax(-1),
                               c["dec_out"][1][j, :k, :M["n_classes"]].argmax(-1))


@pytest.mark.parametrize("cell", ["qm9_train", "geom_sample"])
def test_a_sound_tiny_run_is_correct(cell):
    line = tiny.result(cell, seconds=1.5)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
