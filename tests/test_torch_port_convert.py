"""Port weight carry-over: JAX params on the in-repo fixtures, the upstream
checkpoint directory round trip, and the pickled-args config mapping."""

import argparse
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu import config as jcfg
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.nn.dynamics import dynamics_apply
from geoldm_tpu.ops.distance import build_edge_mask
from geoldm_tpu.utils.torch_convert import (
    model_config_from_reference_args as jax_config_from_args,
)
from geoldm_tpu_torch import config as pcfg
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.utils.convert import (
    load_reference_checkpoint,
    model_config_from_reference_args,
    reference_args_from_model_config,
    save_reference_checkpoint,
    state_dict_from_jax_params,
)
from tests.torch_port_utils import masked_inputs, t

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "..", "ckpts_parity_r5")
# The fixtures' parity config (scripts/parity_train_ab_ldm.py:147-175).
FIXTURE_KW = dict(nf=64, n_layers=9, latent_nf=1, normalization_factor=1.0,
                  diffusion_steps=500, trainable_ae=True)


@pytest.fixture(scope="module")
def fixture_pair():
    with open(os.path.join(FIXTURES, "jax_s20_step300.pkl"), "rb") as f:
        params = pickle.load(f)
    ref = torch.load(os.path.join(FIXTURES, "torch_s20_step300.pt"), weights_only=True)
    cfg = pfactory.make_latent_diffusion_config(get_dataset_info("qm9"), **FIXTURE_KW)
    return params, ref, cfg


def test_fixture_state_dict_matches_torch_twin_key_for_key(fixture_pair):
    params, ref, cfg = fixture_pair
    sd = state_dict_from_jax_params(params, cfg)
    assert len(sd) == len(ref) == 304
    assert list(sd) == list(ref)
    for k in ref:
        assert sd[k].shape == ref[k].shape and sd[k].dtype == ref[k].dtype, k
    # The twins were trained separately from one init; the entries training
    # never touches (schedule table, buffers, the frozen encoder) agree bit
    # for bit, which pins the layout and the transposes.
    frozen = [k for k in ref if not k.startswith(("dynamics.", "vae.decoder."))]
    assert len(frozen) == 26
    for k in frozen:
        assert torch.equal(sd[k], ref[k]), k
    model = pfactory.build_model(cfg, "cpu")
    model.load_state_dict(sd, strict=True)
    model.load_state_dict(ref, strict=True)


def test_fixture_denoiser_matches_jax(fixture_pair):
    params, _, cfg = fixture_pair
    model = pfactory.build_model(cfg, "cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg), strict=True)
    jax_model_cfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **FIXTURE_KW)
    _, x, _, mask = masked_inputs(11, 3, 9, 1, (6, 9, 4))
    zh = np.random.default_rng(12).standard_normal((3, 9, 1)).astype(np.float32) * mask
    xh = np.concatenate([x, zh], axis=2)
    tt = np.array([[0.02], [0.4], [0.9]], dtype=np.float32)
    with torch.no_grad():
        out_p = model.dynamics(t(tt), t(xh), t(mask))
    mj = jnp.asarray(mask)
    out_j = dynamics_apply(params["dynamics"], jax_model_cfg.dynamics, jnp.asarray(tt),
                           jnp.asarray(xh), mj, build_edge_mask(mj))
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), atol=2e-5, rtol=2e-5)


def test_reference_checkpoint_round_trip(tmp_path):
    cfg = pfactory.make_latent_diffusion_config(get_dataset_info("qm9"), nf=16, n_layers=1,
                                                diffusion_steps=5)
    model = pfactory.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    save_reference_checkpoint(model, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["args.pickle", "generative_model.npy",
                                            "generative_model_ema.npy"]
    loaded, cfg2, args = load_reference_checkpoint(str(tmp_path), "cpu")
    assert cfg2 == cfg and args.dataset == "qm9"
    for (k, a), (_, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("ns", [
    dict(nf=64, n_layers=3, latent_nf=2, diffusion_steps=200, sin_embedding=True),
    dict(nf=192, n_layers=9, normalization_factor=100, aggregation_method="mean",
         diffusion_noise_schedule="cosine"),
    dict(),  # args pickled before the later options existed
])
def test_config_from_reference_args_matches_jax(ns):
    args = argparse.Namespace(train_diffusion=True, **ns)
    p = model_config_from_reference_args(args, get_dataset_info("qm9"))
    j = jax_config_from_args(args, jax_info("qm9"))
    assert pcfg.dumps(p) == jcfg.dumps(j)
    back = model_config_from_reference_args(reference_args_from_model_config(p),
                                            get_dataset_info("qm9"))
    assert back == p
