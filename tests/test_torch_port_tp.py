"""Tensor parallelism (``--tp``) on the CPU over gloo ranks, at small widths:
the sharded parameter set against JAX's ``param_shardings(hidden_nf=nf)``,
TP-2 and DP-2 x TP-2 train steps against one rank (f32 and bfloat16), the
DP-2 x TP-2 step against JAX's step on a ``make_mesh(dp=2, tp=2)`` mesh
with JAX's draws replayed, and each rank's elements of AMSGrad and EMA
state.

Tolerances: f32 as tests/test_torch_port_dp.py (loss and gradient norm 1e-5
relative; every gradient, AMSGrad moment and EMA within 1e-3 * max|ref|,
the weights' move within 3e-2 * lr); bf16 1e-2 * max|ref| (PERF.md §2), its
DP-2 x TP-2 gradients through ``sp_grads_report`` as the bf16 DP-2 step's.
The gradient norm is held at 1e-5 relative because a factor of T would show
there first: nothing is summed over the model ranks."""

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
KW = dict(nf=32, n_layers=2, latent_nf=2, diffusion_steps=20, trainable_ae=True)
LR = 1e-3
RTOL = {None: 1e-3, "bfloat16": 1e-2}
LOSS_RTOL, CALL_RTOL = 1e-5, 2e-5


def _qm9_batch(seed, b, n=9):
    raw = synthetic_batch(QM9, b, n, np.random.default_rng(seed))
    return ptrainer.prepare_host(raw, DistributionNodes(QM9.n_nodes))


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------


def _configs(name, nf=16):
    """(JAX config, port config) of each model the rule is held on."""
    kw = dict(nf=nf, n_layers=2)
    if name == "vae":
        return (jfactory.make_vae_config(jax_info("qm9"), latent_nf=2, **kw),
                pfactory.make_vae_config(QM9, latent_nf=2, **kw))
    ds, extra = {"qm9_ldm": ("qm9", dict(latent_nf=1)),
                 "geom_ldm": ("geom", dict(latent_nf=2, include_charges=False)),
                 "gnn": ("qm9", dict(latent_nf=1, model="gnn_dynamics"))}[name]
    return (jfactory.make_latent_diffusion_config(jax_info(ds), **kw, **extra),
            pfactory.make_latent_diffusion_config(get_dataset_info(ds), **kw, **extra))


def _owners(leaf, mesh, nf):
    """Each element's model index on ``mesh`` under JAX's sharding of the
    leaf at ``hidden_nf=nf`` (-1 where every model index holds it)."""
    sh = jshd.param_shardings(leaf, mesh, hidden_nf=nf)
    arr = jax.device_put(leaf, sh)
    if jshd.MODEL_AXIS not in tuple(sh.spec):
        return np.full(leaf.shape, -1.0, np.float32)
    col = {d: j for j, d in enumerate(mesh.devices[0])}
    out = np.full(leaf.shape, np.nan, np.float32)
    for shard in arr.addressable_shards:
        out[shard.index] = col[shard.device]
    return out


@pytest.mark.parametrize("name", ["qm9_ldm", "geom_ldm", "vae", "gnn"])
def test_sharded_set_equals_jax_param_shardings(name):
    """JAX's ``param_shardings(params, make_mesh(dp=1, tp=2), hidden_nf=nf)``,
    its per-element model index mapped through ``state_dict_from_jax_params``,
    against the port's rule and shards: the same parameters sharded, and rank
    m's rows (``sharding.own_shard``) exactly the elements JAX puts on model
    index m."""
    nf, tp = 16, 2
    jcfg, pcfg = _configs(name, nf)
    params = jax.tree.map(np.asarray, jfactory.init_params(jax.random.key(0), jcfg))
    mesh = jshd.make_mesh(dp=1, tp=tp)
    owners = state_dict_from_jax_params(jax.tree.map(lambda a: _owners(a, mesh, nf), params),
                                        pcfg)
    model = pfactory.build_model(pcfg, "cpu", torch.Generator().manual_seed(0))
    n_sharded = 0
    for rank in range(tp):
        grp = sharding.RankGroup(rank, tp, "gloo", torch.device("cpu"))
        for pname, p in model.named_parameters():
            own = owners[pname]
            assert own.shape == p.shape, pname
            sharded = sharding.tp_sharded(p, nf, tp)
            assert bool((own >= 0).all()) if sharded else bool((own == -1).all()), \
                (name, pname, tuple(p.shape))
            if sharded:
                assert bool((sharding.own_shard(own, grp) == rank).all()), (name, pname, rank)
                n_sharded += rank == 0
    assert n_sharded > 0
    assert not any(sharding.tp_sharded(p, nf, 1) for p in model.parameters())


# ---------------------------------------------------------------------------
# Steps against one rank
# ---------------------------------------------------------------------------


def _rule_elements(spec, tp):
    """The elements of optimizer and EMA state a rank must hold: the
    replicated parameters whole, the sharded ones 1/T; AMSGrad's three
    moments of the ones that get a gradient (AdamW keeps no state for the
    encoder, whose latent is detached)."""
    cfg = pfactory.make_latent_diffusion_config(get_dataset_info(spec["dataset"]), **spec["kw"])
    model = pfactory.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    nf = spec["kw"]["nf"]
    per = [(p.numel() // tp if sharding.tp_sharded(p, nf, tp) else p.numel(),
            not name.startswith("vae.encoder.") and (cfg.trainable_ae or
                                                     not name.startswith("vae.")))
           for name, p in model.named_parameters()]
    return {"optim": 3 * sum(n for n, t in per if t), "ema": sum(n for n, _ in per)}


def _gate(got, want, rtol, what):
    for name, ref in want.items():
        err = float(np.abs(np.asarray(got[name]) - ref).max())
        assert err <= rtol * float(np.abs(ref).max()), (what, name, err)


def _assert_tp_step(got, want, start, dp, tp, rtol, grads=True):
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    # No factor of T: the norm over the shards and the replicated leaves is
    # one rank's.
    assert abs(got["grad_norm"] - want["grad_norm"]) <= LOSS_RTOL * want["grad_norm"]
    if grads:
        assert set(got["grads"]) == set(want["grads"])
        _gate(got["grads"], want["grads"], rtol, "gradients")
    for name, p in want["params"].items():
        np.testing.assert_allclose(got["params"][name] - start[name], p - start[name],
                                   atol=3e-2 * LR, err_msg=name)
    _gate(got["ema"], want["ema"], rtol, "EMA")
    assert len(got["moments"]) == len(want["moments"])
    for g, w in zip(got["moments"], want["moments"]):
        assert set(g) == set(w) == {"exp_avg", "exp_avg_sq", "max_exp_avg_sq"}
        _gate(g, w, rtol, "AMSGrad moments")
    assert len(got["digests"]) == dp * tp and len(set(got["digests"])) == 1, \
        "the gathered train states differ"
    # The ranks of one model index hold the same shards; a data row's
    # model ranks hold other rows.
    shard = got["shard_digests"]
    for m in range(tp):
        assert len({shard[d * tp + m] for d in range(dp)}) == 1
    assert len({shard[m] for m in range(tp)}) == tp


def _start(spec):
    cfg = pfactory.make_latent_diffusion_config(get_dataset_info(spec["dataset"]), **spec["kw"])
    model = pfactory.build_model(cfg, "cpu", torch.Generator().manual_seed(spec["seed"]))
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_tp_train_step_matches_one_rank(dp, tp, compute_dtype):
    """A TP-2 (two model ranks, the whole batch each) and a DP-2 x TP-2 step
    (rank r at data index r // 2, model index r % 2) against one rank's step
    on the same global batch and noise: the loss, the gradient norm, every
    gradient the optimizer applies (the shards gathered), the weights, the
    gathered AMSGrad moments and EMA; the D x T gathered states
    bit-identical, the shards of one model index too; and each rank's
    elements of optimizer and EMA state exactly the replicated count plus
    the sharded count over T. In bf16 the DP-2 x TP-2 gradients go through
    ``sp_grads_report`` against one rank (its data ranks' backwards sum
    other partial batches), and the rest is held against the DP-2 bf16 step
    on the same rows, since a bf16 sign flip of a tiny gradient moves a
    weight by 2 lr at AMSGrad's first step."""
    spec = {"dataset": "qm9", "kw": KW, "seed": 3}
    batch = _qm9_batch(5, 8)
    opts = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    want = ranks.train_step(spec, batch, ("seed", 4), opts)
    got = sharding.spawn(dp, 1, ranks.train_step, (spec, batch, ("seed", 4), opts),
                         device="cpu", tp=tp)
    bf16_split = compute_dtype is not None and dp > 1
    if bf16_split:
        want_f32 = ranks.train_step(spec, batch, ("seed", 4))
        r = sp_grads_report(got["grads"], want["grads"], want_f32["grads"])
        assert not r["problems"], r["problems"]
        want = sharding.spawn(dp, 1, ranks.train_step, (spec, batch, ("seed", 4), opts),
                              device="cpu")
    _assert_tp_step(got, want, _start(spec), dp, tp, RTOL[compute_dtype])
    rule = _rule_elements(spec, tp)
    assert got["elements"] == [rule] * (dp * tp), (got["elements"], rule)
    assert all(e == _rule_elements(spec, 1) for e in want["elements"])


# ---------------------------------------------------------------------------
# Against JAX's (data=2, model=2) mesh
# ---------------------------------------------------------------------------


def _jax_batch(batch):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    out["edge_mask"] = build_edge_mask(out["node_mask"])
    return out


def test_tp_train_step_matches_jax_dp2_tp2_mesh():
    """The port's DP-2 x TP-2 step against JAX's ``make_train_step`` on a
    ``make_mesh(dp=2, tp=2)`` mesh, the params and EMA sharded with
    ``shard_params(..., hidden_nf=nf)`` and the batch over ``data``, with
    JAX's global draws replayed to every rank, each data rank taking its
    rows: the loss, the gradient norm, every gradient (JAX's from
    ``value_and_grad`` under the same mesh) and the weights' move (3e-2 * lr,
    as the DP-2 test)."""
    from geoldm_tpu.config import TrainConfig

    kw = {**KW, "n_layers": 1}
    nf = kw["nf"]
    jcfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **kw)
    pcfg = pfactory.make_latent_diffusion_config(QM9, **kw)
    tc = TrainConfig(lr=LR, ema_decay=0.99, clip_grad=False, dp=2, tp=2)
    jstate, tx = jts.create_train_state(jax.random.key(11), jcfg, tc)
    start = {k: v.numpy() for k, v in state_dict_from_jax_params(
        jax.tree.map(np.asarray, jstate.params), pcfg).items()}
    batch = _qm9_batch(6, 4)
    key = jax.random.key(12)
    mesh = jshd.make_mesh(dp=2, tp=2)
    assert dict(mesh.shape) == {jshd.DATA_AXIS: 2, jshd.MODEL_AXIS: 2}
    params = jshd.shard_params(jstate.params, mesh, hidden_nf=nf)
    jb = jshd.shard_batch(_jax_batch(batch), mesh)
    jnll = jfactory.model_nll_fn(jcfg, training=True)

    def loss(p):
        nll = jnll(p, key, jb["x"], jb["h_cat"], jb["h_int"], jb["node_mask"], jb["edge_mask"],
                   None)
        return jnp.mean(nll - jb["log_pN"])

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    want = {k: v.numpy() for k, v in state_dict_from_jax_params(
        jax.tree.map(np.asarray, jgrads), pcfg).items()}
    sharded = jstate._replace(params=params,
                              ema_params=jshd.shard_params(jstate.ema_params, mesh, hidden_nf=nf))
    jnew, jm = jax.jit(jts.make_train_step(jcfg, tc, tx))(sharded, jb, key)
    draws = jax_ldm_draws(key, 4, 9, kw["latent_nf"], kw["diffusion_steps"], False)
    got = sharding.spawn(2, 1, ranks.train_step,
                         ({"dataset": "qm9", "kw": kw, "state": start}, batch,
                          ("replay", draws), {"clip_grad": False}), device="cpu", tp=2)
    np.testing.assert_allclose(got["loss"], float(jm["loss"]), rtol=CALL_RTOL)
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=CALL_RTOL)
    np.testing.assert_allclose(got["grad_norm"], float(jm["grad_norm"]), rtol=1e-4)
    assert got["grads"] and set(got["grads"]) <= set(want)
    for name in set(want) - set(got["grads"]):  # the detached encoder: zero in JAX
        assert not name.startswith("vae.encoder.") or not np.any(want[name]), name
    _gate(got["grads"], {k: want[k] for k in got["grads"]}, 1e-3, "TP-2 x DP-2 vs JAX")
    moved = state_dict_from_jax_params(jax.tree.map(np.asarray, jnew.params), pcfg)
    for name, p in got["params"].items():
        np.testing.assert_allclose(p - start[name], moved[name].numpy() - start[name],
                                   atol=3e-2 * LR, err_msg=name)
    assert len(set(got["digests"])) == 1
