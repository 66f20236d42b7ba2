"""The GNN ablation (``--model gnn_dynamics``), the legacy EGNN and the
priors against the JAX package, and the learned schedule and the GNN under
SP-2 and DP-2 against one rank, on the CPU at small widths (the learned
schedule and the plain kind alone: tests/test_torch_port_variants.py and
_edm.py, whose helpers and tolerances this file shares).

Tolerances: one f32 call against JAX CALL_RTOL, a sampler run SAMPLE_RTOL,
a train step as tests/test_torch_port_train.py (those of
tests/test_torch_port_variants.py); SP-2 and DP-2 against one rank: the loss
1e-5 relative, every gradient within 1e-3 * max|ref|
(tests/test_torch_port_sp_train.py), the learned gamma network's layers as
``_gamma_layer_ok`` says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu.config import EGNNConfig as JaxEGNNConfig
from geoldm_tpu.config import TrainConfig
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.diffusion import priors as jpriors
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.nn.core import sp_spec
from geoldm_tpu.nn.dynamics import dynamics_apply
from geoldm_tpu.nn.egnn import gnn_apply, gnn_init
from geoldm_tpu.nn.egnn_legacy import legacy_egnn_apply, legacy_egnn_init
from geoldm_tpu.ops.distance import build_edge_mask
from geoldm_tpu.parallel.sp import make_sp_mesh
from geoldm_tpu.train import train_step as jts
from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.data.synthetic import synthetic_batch
from geoldm_tpu_torch.diffusion import priors as ppriors
from geoldm_tpu_torch.diffusion import vdm as pvdm
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.models.distributions import DistributionNodes
from geoldm_tpu_torch.nn.egnn import GNN
from geoldm_tpu_torch.nn.egnn_legacy import LegacyEGNN
from geoldm_tpu_torch.parallel import sharding
from geoldm_tpu_torch.train import trainer as ptrainer
from geoldm_tpu_torch.utils.convert import gnn_state_dict, legacy_egnn_state_dict
from tests.test_torch_port_variants import (
    B,
    CALL_RTOL,
    LDM_KW,
    LEARNED,
    N,
    N_REAL,
    QM9,
    SAMPLE_RTOL,
    T,
    _close,
    _gamma_layer_ok,
    _jax_nll,
    _jax_sample,
    _molecules,
    _pair,
    _sample_draws,
)
from tests.test_torch_port_variants_edm import _train_trajectory
from tests.torch_port_utils import Feed, jax_combined_draws, jax_vdm_draws, masked_inputs, t
import torch_port_dp_ranks as ranks

torch.set_num_threads(1)

PAR_LOSS_RTOL, PAR_GRAD_RTOL = 1e-5, 1e-3


# ---------------------------------------------------------------------------
# The GNN ablation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["edm", "ldm"])
def test_gnn_train_step_trajectory_matches_jax(kind):
    """Three train steps of a gnn_dynamics model, plain and latent, against
    JAX's (as tests/test_torch_port_train.py's latent trajectory)."""
    model = _train_trajectory(kind, model="gnn_dynamics")
    assert hasattr(model.dynamics, "gnn")


def test_gnn_matches_jax_gnn_apply():
    cfg = dict(in_node_nf=7, out_node_nf=7, hidden_nf=16, n_layers=2, attention=True)
    params = gnn_init(jax.random.key(22), JaxEGNNConfig(**cfg), in_edge_nf=0)
    net = GNN(EGNNConfig(**cfg))
    net.load_state_dict(gnn_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    h, _, _, mask = masked_inputs(23, B, N, 7, N_REAL)
    mj = jnp.asarray(mask)
    want = gnn_apply(params, JaxEGNNConfig(**cfg), jnp.asarray(h), None, mj, build_edge_mask(mj))
    with torch.no_grad():
        _close(net(t(h), t(mask)), want, CALL_RTOL, "gnn")


@pytest.mark.parametrize("kind", ["edm", "ldm"])
def test_gnn_dynamics_matches_jax(kind):
    """The gnn_dynamics denoiser: the GNN on [x, h, t], the velocity from its
    first 3 channels, the time channel stripped, NaN reset and CoM removal."""
    jcfg, pcfg, params, model = _pair(kind, 24, model="gnn_dynamics")
    feat = 6 if kind == "edm" else LDM_KW["latent_nf"]
    _, x, _, mask = masked_inputs(25, B, N, 1, N_REAL)
    h = np.random.default_rng(26).standard_normal((B, N, feat)).astype(np.float32) * mask
    xh = np.concatenate([x, h], axis=2)
    tt = np.array([[0.1], [0.5], [1.0]], np.float32)
    mj = jnp.asarray(mask)
    want = dynamics_apply(params["dynamics"], jcfg.dynamics, jnp.asarray(tt), jnp.asarray(xh),
                          mj, build_edge_mask(mj))
    with torch.no_grad():
        got = model.dynamics(t(tt), t(xh), t(mask))
    _close(got, want, CALL_RTOL, "eps")
    assert not hasattr(model.dynamics, "egnn") and "dynamics.gnn.gcl_1.att_mlp.0.weight" in \
        model.state_dict()


def test_gnn_ablation_loss_and_sample_match_jax():
    """tests/test_gnn_ablation.py's plain-kind GNN model (there marked slow),
    small: its l2 training loss and a sample against JAX's."""
    jcfg, pcfg, params, model = _pair("edm", 27, model="gnn_dynamics")
    x, h_cat, h_int, mask = _molecules(28)
    key, mj = jax.random.key(29), jnp.asarray(mask)
    want = _jax_nll(params, jcfg, key, x, h_cat, h_int, mask, True)
    with torch.no_grad():
        got = pvdm.vdm_nll(model, Feed(jax_vdm_draws(key, B, N, 6, T, False)), t(x), t(h_cat),
                           t(h_int), t(mask), training=True)
    _close(got, want, CALL_RTOL, "loss")
    skey = jax.random.key(30)
    want = _jax_sample(params, jcfg, skey, mask)
    got = pfactory.model_sample_fn(pcfg)(model, Feed(_sample_draws(skey, T, 6)), t(mask))
    _close(got[0], want[0], SAMPLE_RTOL, "x")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# ---------------------------------------------------------------------------
# The legacy EGNN and the priors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("agg,attention", [("sum", True), ("mean", False)])
def test_legacy_egnn_matches_jax(agg, attention):
    cfg = dict(in_node_nf=5, out_node_nf=4, hidden_nf=16, n_layers=3, attention=attention,
               aggregation_method=agg, norm_constant=1.0)
    params = legacy_egnn_init(jax.random.key(31), JaxEGNNConfig(**cfg))
    net = LegacyEGNN(EGNNConfig(**cfg))
    net.load_state_dict(legacy_egnn_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    h, x, _, mask = masked_inputs(32, B, N, 5, N_REAL)
    mj = jnp.asarray(mask)
    wh, wx = legacy_egnn_apply(params, JaxEGNNConfig(**cfg), jnp.asarray(h), jnp.asarray(x), mj,
                               build_edge_mask(mj))
    with torch.no_grad():
        gh, gx = net(t(h), t(x), t(mask), _edge_mask(mask))
    _close(gh, wh, CALL_RTOL, "h")
    _close(gx, wx, CALL_RTOL, "x")
    # The port's own init: the coordinate MLP's last layer xavier with gain 0.001.
    pfactory.init_parameters(net, torch.Generator().manual_seed(0))
    assert float(net.gcl_0.coord_mlp[2].weight.detach().abs().max()) < 1e-3


def _edge_mask(mask):
    from geoldm_tpu_torch.ops.distance import build_edge_mask as pbuild

    return pbuild(t(mask))


def test_priors_match_jax():
    _, x, _, mask = masked_inputs(33, B, N, 1, N_REAL)
    z_h = np.random.default_rng(34).standard_normal((B, N, 4)).astype(np.float32) * mask
    _close(ppriors.position_feature_prior_log_prob(t(x), t(z_h), t(mask)),
           jpriors.position_feature_prior_log_prob(jnp.asarray(x), jnp.asarray(z_h),
                                                   jnp.asarray(mask)), CALL_RTOL, "log p(x, h)")
    full = masked_inputs(35, B, N, 1, (N, N, N))[1]
    _close(ppriors.position_prior_log_prob(t(full)),
           jpriors.position_prior_log_prob(jnp.asarray(full)), CALL_RTOL, "log p(x)")
    key = jax.random.key(36)
    jx, jh = jpriors.position_feature_prior_sample(key, 3, 4, jnp.asarray(mask))
    px, ph = ppriors.position_feature_prior_sample(Feed(jax_combined_draws(key, B, N, 3, 4)), 3,
                                                   4, t(mask))
    _close(px, jx, CALL_RTOL, "z_x")
    _close(ph, jh, CALL_RTOL, "z_h")
    gx, gh = ppriors.position_feature_prior_sample(torch.Generator().manual_seed(0), 3, 4,
                                                   t(mask))
    assert float((gx.sum(1)).abs().max()) < 1e-5 and float((gx * (1 - t(mask))).abs().max()) == 0
    assert float((gh * (1 - t(mask))).abs().max()) == 0
    s = ppriors.position_prior_sample(torch.Generator().manual_seed(1), (B, N, 3), "cpu")
    assert s.shape == (B, N, 3) and float(s.sum(1).abs().max()) < 1e-5
    if not torch.cuda.is_available():  # the card by default, and no quiet CPU run
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            ppriors.position_prior_sample(torch.Generator(), (B, N, 3))


# ---------------------------------------------------------------------------
# Parallel: the learned schedule and the GNN under SP-2 and DP-2
# ---------------------------------------------------------------------------


def _batch(seed, b, n=9):
    raw = synthetic_batch(QM9, b, n, np.random.default_rng(seed))
    return ptrainer.prepare_host(raw, DistributionNodes(QM9.n_nodes))


def _assert_parallel(got, want, size):
    assert abs(got["loss"] - want["loss"]) <= PAR_LOSS_RTOL * abs(want["loss"])
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        if name.startswith("gamma.l"):  # see _gamma_layer_ok
            _gamma_layer_ok(got["grads"][name], name)
            continue
        err = float(np.abs(got["grads"][name] - g).max())
        assert err <= PAR_GRAD_RTOL * float(np.abs(g).max()), (name, err)
    assert len(got["digests"]) == size and len(set(got["digests"])) == 1


@pytest.mark.parametrize("dp,sp,model", [(1, 2, "egnn_dynamics"), (2, 1, "egnn_dynamics"),
                                         (1, 2, "gnn_dynamics")])
def test_parallel_step_matches_one_rank(dp, sp, model):
    """SP-2 and DP-2 learned-schedule steps against one rank: the gamma
    network is replicated, so its gradient must come out whole, not S times
    itself (it is not among ``sp.block_parameters``) and under DP the mean
    of the ranks'. The GNN denoiser under ``--sp 2`` runs replicated on every
    rank, as JAX runs it (``test_jax_gnn_runs_under_an_sp_mesh``), beside the
    VAE's EGNNs over the slabs."""
    kw = {**LDM_KW, "model": model, **(LEARNED if model == "egnn_dynamics" else {})}
    spec = {"dataset": "qm9", "kw": kw, "seed": 37}
    batch = _batch(38, 4)
    want = ranks.train_step(spec, batch, ("seed", 39))
    got = sharding.spawn(dp, sp, ranks.train_step, (spec, batch, ("seed", 39), {}),
                         device="cpu")
    _assert_parallel(got, want, dp * sp)
    if model == "egnn_dynamics":
        assert any(n.startswith("gamma.") for n in want["grads"])


def test_jax_gnn_runs_under_an_sp_mesh():
    """What JAX does with ``--model gnn_dynamics --sp 2``: gnn_apply has no SP
    route, and the GNN runs replicated inside the SP train step, whose loss
    equals the one-device step's."""
    if len(jax.devices()) < 2:
        pytest.skip("needs two JAX devices (the test configuration provides 8)")
    cfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), nf=16, n_layers=1, latent_nf=1,
                                                diffusion_steps=T, trainable_ae=True,
                                                model="gnn_dynamics")
    tc = TrainConfig(lr=1e-3, ema_decay=0.999)
    state, tx = jts.create_train_state(jax.random.key(0), cfg, tc)
    b = _batch(40, 2)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    batch["edge_mask"] = build_edge_mask(batch["node_mask"])
    _, m_ref = jax.jit(jts.make_train_step(cfg, tc, tx))(state, batch, jax.random.key(1))
    mesh = make_sp_mesh(dp=1, sp=2)
    _, m_sp = jax.jit(jts.make_train_step(cfg, tc, tx, compute_dtype=sp_spec(mesh)))(
        state, batch, jax.random.key(1))
    np.testing.assert_allclose(float(m_sp["loss"]), float(m_ref["loss"]), rtol=1e-5)
