"""Data-parallel (DP) training on the CPU over gloo ranks, at small widths:
DP-2 and DP-4 train steps, a DP-2 x SP-2 step and a bf16 DP-2 step against
one rank on the same global batch and noise, and the DP-2 step against JAX's
step on a ``make_mesh(dp=2)`` mesh with JAX's draws replayed
(tests/test_torch_port_dp_eval.py holds the rest of DP and conditioning
under SP).

Tolerances: the SP tests' (tests/test_torch_port_sp_train.py): loss 1e-5
relative, every gradient within 1e-3 * max|ref| (the same f32 math summed in
another order: per-rank means averaged, gathers, all-reduces); one f32 NLL
call against JAX 2e-5 relative (two frameworks' op orders, as
tests/test_torch_port_train.py); bf16 through ``sp_grads_report``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.ops.distance import build_edge_mask
from geoldm_tpu.parallel import sharding as jshd
from geoldm_tpu.train import train_step as jts
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.synthetic import synthetic_batch
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.models.distributions import DistributionNodes
from geoldm_tpu_torch.parallel import sharding
from geoldm_tpu_torch.train import trainer as ptrainer
from geoldm_tpu_torch.utils.convert import state_dict_from_jax_params
from tests.torch_port_bf16_sites import sp_grads_report
from tests.torch_port_utils import jax_ldm_draws
import torch_port_dp_ranks as ranks

torch.set_num_threads(1)

QM9 = get_dataset_info("qm9")
NODES = DistributionNodes(QM9.n_nodes)
KW = dict(nf=32, n_layers=2, latent_nf=2, diffusion_steps=20, trainable_ae=True)
GEOM_KW = dict(nf=32, n_layers=2, latent_nf=2, include_charges=False, trainable_ae=True,
               diffusion_steps=20)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3
CALL_RTOL = 2e-5


def _qm9_batch(seed, b, n=9):
    """A prepared global batch of b QM9 molecules padded to n (numpy)."""
    raw = synthetic_batch(QM9, b, n, np.random.default_rng(seed))
    return ptrainer.prepare_host(raw, NODES)


def _geom_batch(seed, n, sizes):
    geom = get_dataset_info("geom")
    raw = synthetic_batch(geom, len(sizes), n, np.random.default_rng(seed),
                          include_charges=False, n_atoms=sizes)
    return ptrainer.prepare_host(raw, DistributionNodes(geom.n_nodes))


def _assert_grads(got, want, what):
    """Every gradient within GRAD_RTOL * max|ref|. JAX's pytree also holds
    the encoder's weights, which get no gradient in the port (its latent is
    detached): theirs must be zero there."""
    assert got and set(got) <= set(want), what
    for name in set(want) - set(got):
        assert not name.startswith("vae.encoder.") or not np.any(want[name]), (what, name)
    for name, g in want.items():
        if name not in got:
            continue
        err = float(np.abs(got[name] - g).max())
        assert err <= GRAD_RTOL * float(np.abs(g).max()), (what, name, err)


def _assert_step(got, want, size):
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    _assert_grads(got["grads"], want["grads"], "gradients")
    assert len(got["digests"]) == size and len(set(got["digests"])) == 1, \
        "the replicas differ after the step"


@pytest.mark.parametrize("dp", [2, 4])
def test_dp_train_step_matches_one_rank(dp):
    """A DP-D step (each rank B/D molecules and its rows of the global
    draws; gradients and loss averaged over the ranks before the clip)
    against one rank's step on the same global batch: the loss, every
    gradient the optimizer applies, and the replicas bit-identical after."""
    spec = {"dataset": "qm9", "kw": KW, "seed": 3}
    batch = _qm9_batch(5, 8)
    want = ranks.train_step(spec, batch, ("seed", 4))
    got = sharding.spawn(dp, 1, ranks.train_step, (spec, batch, ("seed", 4), {}),
                         device="cpu")
    _assert_step(got, want, dp)


def test_dp_x_sp_train_step_matches_one_rank():
    """DP-2 x SP-2 (four ranks: each data row splits the atom rows of its
    two molecules, 19 padded to 20) against one rank."""
    spec = {"dataset": "geom", "kw": GEOM_KW, "seed": 3}
    batch = _geom_batch(7, 19, [19, 14, 17, 11])
    want = ranks.train_step(spec, batch, ("seed", 4))
    got = sharding.spawn(2, 2, ranks.train_step, (spec, batch, ("seed", 4), {}), device="cpu")
    _assert_step(got, want, 4)


def test_bf16_dp_train_step_matches_one_rank():
    """A DP-2 step in bfloat16 against the one-rank bf16 step, held to
    ``sp_grads_report``'s gates (the per-rank backwards round at the same
    sites as one rank's, but sum other partial batches)."""
    spec = {"dataset": "qm9", "kw": KW, "seed": 3}
    batch = _qm9_batch(5, 8)
    bf16 = {"compute_dtype": "bfloat16"}
    want = ranks.train_step(spec, batch, ("seed", 4), bf16)
    want_f32 = ranks.train_step(spec, batch, ("seed", 4))
    got = sharding.spawn(2, 1, ranks.train_step, (spec, batch, ("seed", 4), bf16),
                         device="cpu")
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    r = sp_grads_report(got["grads"], want["grads"], want_f32["grads"])
    assert not r["problems"], r["problems"]
    assert len(set(got["digests"])) == 1, "the replicas differ after the step"


def _jax_pair(kw, seed, dataset="qm9"):
    jcfg = jfactory.make_latent_diffusion_config(jax_info(dataset), **kw)
    pcfg = pfactory.make_latent_diffusion_config(get_dataset_info(dataset), **kw)
    params = jfactory.init_params(jax.random.key(seed), jcfg)
    state = {k: v.numpy() for k, v in state_dict_from_jax_params(
        jax.tree.map(np.asarray, params), pcfg).items()}
    return jcfg, pcfg, params, state


def _jax_batch(batch):
    mj = jnp.asarray(batch["node_mask"])
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    out["edge_mask"] = build_edge_mask(mj)
    return out


def _jax_grads(jcfg, pcfg, params, batch, key, mesh=None, keep=None):
    """JAX's loss and gradient (as the port's state dict) of one training
    loss, with the batch sharded over ``mesh``'s data axis when given."""
    jnll = jfactory.model_nll_fn(jcfg, training=True)
    jb = _jax_batch(batch)
    if mesh is not None:
        jb = jshd.shard_batch(jb, mesh)
        params = jshd.shard_params(params, mesh)
    context = None if "context" not in jb else jb["context"] * (1.0 if keep is None else keep)

    def loss(p):
        nll = jnll(p, key, jb["x"], jb["h_cat"], jb["h_int"], jb["node_mask"],
                   jb["edge_mask"], context)
        return jnp.mean(nll - jb["log_pN"])

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads), pcfg)
    return float(jloss), {k: v.numpy() for k, v in want.items()}


def test_dp_train_step_matches_jax_dp2_mesh():
    """The port's DP-2 step against JAX's ``make_train_step`` on a (data=2)
    mesh, the batch sharded over it (``shard_batch``), with JAX's global
    draws replayed to both ranks, each taking its rows: the loss, the
    gradient norm, every gradient (JAX's from ``value_and_grad`` under the
    same mesh) and the weights' move (3e-2 * lr, as
    tests/test_torch_port_train.py)."""
    from geoldm_tpu.config import TrainConfig

    kw = {**KW, "n_layers": 1}
    jcfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **kw)
    pcfg = pfactory.make_latent_diffusion_config(QM9, **kw)
    lr = 1e-3
    tc = TrainConfig(lr=lr, ema_decay=0.99, clip_grad=False)
    jstate, tx = jts.create_train_state(jax.random.key(11), jcfg, tc)
    start = {k: v.numpy() for k, v in state_dict_from_jax_params(
        jax.tree.map(np.asarray, jstate.params), pcfg).items()}
    batch = _qm9_batch(6, 4)
    key = jax.random.key(12)
    mesh = jshd.make_mesh(dp=2)
    assert mesh.shape[jshd.DATA_AXIS] == 2
    jloss, want = _jax_grads(jcfg, pcfg, jstate.params, batch, key, mesh)
    sharded = jstate._replace(params=jshd.shard_params(jstate.params, mesh),
                              ema_params=jshd.shard_params(jstate.ema_params, mesh))
    jnew, jm = jax.jit(jts.make_train_step(jcfg, tc, tx))(
        sharded, jshd.shard_batch(_jax_batch(batch), mesh), key)
    draws = jax_ldm_draws(key, 4, 9, KW["latent_nf"], KW["diffusion_steps"], False)
    got = sharding.spawn(2, 1, ranks.train_step,
                         ({"dataset": "qm9", "kw": kw, "state": start}, batch,
                          ("replay", draws), {"clip_grad": False}), device="cpu")
    np.testing.assert_allclose(got["loss"], float(jm["loss"]), rtol=CALL_RTOL)
    np.testing.assert_allclose(got["loss"], jloss, rtol=CALL_RTOL)
    np.testing.assert_allclose(got["grad_norm"], float(jm["grad_norm"]), rtol=1e-4)
    _assert_grads(got["grads"], want, "DP-2 vs JAX's dp=2 mesh")
    moved = state_dict_from_jax_params(jax.tree.map(np.asarray, jnew.params), pcfg)
    for name, p in got["params"].items():
        np.testing.assert_allclose(p - start[name], moved[name].numpy() - start[name],
                                   atol=3e-2 * lr, err_msg=name)
    assert len(set(got["digests"])) == 1
