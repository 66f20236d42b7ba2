"""Data parallelism on the CPU, beside tests/test_torch_port_dp.py: a
conditional SP-2 step against one rank and JAX; tail trimming against JAX's
``train_epoch``; the weighted eval NLL against JAX's ``make_eval_nll``; the
DP eval NLL of a split with a tail; DP sampling, molecule for molecule; the
global noise source; and the device each backend's collectives take their
tensors on. Tolerances as tests/test_torch_port_dp.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.models.distributions import DistributionNodes as JNodes
from geoldm_tpu.parallel import sharding as jshd
from geoldm_tpu.train import train_step as jts
from geoldm_tpu.train import trainer as jtrainer
from geoldm_tpu_torch.data.synthetic import synthetic_batch
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.parallel import sharding, sp
from geoldm_tpu_torch.train import train_step as pts
from geoldm_tpu_torch.train import trainer as ptrainer
from tests.test_torch_port_dp import (
    CALL_RTOL,
    KW,
    LOSS_RTOL,
    NODES,
    QM9,
    _assert_grads,
    _assert_step,
    _jax_batch,
    _jax_grads,
    _jax_pair,
    _qm9_batch,
)
from tests.torch_port_utils import Feed, jax_ldm_draws
import torch_port_dp_ranks as ranks

torch.set_num_threads(1)

COND_KW = dict(nf=32, n_layers=2, latent_nf=1, diffusion_steps=10, trainable_ae=True,
               context_node_nf=1, context_indicator=True)


def _cond_batch(seed, b=4, n=9):
    batch = _qm9_batch(seed, b, n)
    rng = np.random.default_rng(seed + 1)
    mask = batch["node_mask"]
    alpha = rng.standard_normal((b, 1, 1)).astype(np.float32)
    batch["context"] = np.concatenate([np.broadcast_to(alpha, (b, n, 1)),
                                       np.ones((b, n, 1), np.float32)], axis=-1) * mask
    return batch


def test_conditional_sp_train_step_matches_one_rank_and_jax():
    """--conditioning under SP: the context joins h before the EGNN's
    embedding, which every rank applies to the whole replicated h before
    taking its slab. An SP-2 conditional step (a keep mask nulling one
    molecule's context) against the one-rank step and JAX's gradient."""
    jcfg, pcfg, params, state = _jax_pair(COND_KW, 21)
    batch = _cond_batch(8)
    keep = np.array([1.0, 0.0, 1.0, 1.0], np.float32)[:, None, None]
    key = jax.random.key(22)
    jloss, want_jax = _jax_grads(jcfg, pcfg, params, batch, key, keep=jnp.asarray(keep))
    draws = jax_ldm_draws(key, 4, 9, 1, COND_KW["diffusion_steps"], False)
    spec = {"dataset": "qm9", "kw": COND_KW, "state": state}
    opts = {"keep": keep, "clip_grad": False, "context_dropout": 0.5}
    want = ranks.train_step(spec, batch, ("replay", draws), opts)
    got = sharding.spawn(1, 2, ranks.train_step, (spec, batch, ("replay", draws), opts),
                         device="cpu")
    _assert_step(got, want, 2)
    np.testing.assert_allclose(got["loss"], jloss, rtol=CALL_RTOL)
    _assert_grads(got["grads"], want_jax, "conditional SP-2 vs JAX")


class _Ranks:
    """A stand-in data group of D ranks, for code that runs no collective."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size


def test_tail_trimming_matches_jax_train_epoch(capsys):
    """Batches of 6, 5, 2 and 6 over 3 data ranks: JAX trims the tail of 5
    to 3 and skips the batch of 2 (4 molecules dropped, printed); each port
    rank takes its rows of the same trimmed batches and prints the same
    count."""
    raws = [synthetic_batch(QM9, b, 9, np.random.default_rng(30 + i))
            for i, b in enumerate((6, 5, 2, 6))]
    seen = []

    def jstep(state, batch, key):
        seen.append(np.asarray(batch["x"]))
        return state, {"loss": jnp.zeros(()), "grad_norm": jnp.zeros(())}

    from geoldm_tpu.models.distributions import DistributionNodes as JNodes

    jtrainer.train_epoch(None, jstep, raws, JNodes(jax_info("qm9").n_nodes), jax.random.key(0),
                         0, mesh=jshd.make_mesh(dp=3), prefetch=0)
    jax_out = capsys.readouterr().out
    assert "(4 tail molecules dropped for dp-divisibility)" in jax_out
    model = torch.nn.Linear(1, 1)
    per_rank = []
    for r in range(3):
        mine = []

        def pstep(state, batch, noise):
            mine.append(batch["x"].numpy())
            return {"loss": torch.zeros(()), "grad_norm": torch.zeros(())}

        state = type("S", (), {"model": model})()
        ptrainer.train_epoch(state, pstep, raws, NODES, torch.Generator(), 0, prefetch=0,
                             data=_Ranks(r, 3))
        out = capsys.readouterr().out
        assert "(4 tail molecules dropped for dp-divisibility)" in out
        per_rank.append(mine)
    assert [len(b) for b in seen] == [6, 3, 6]
    for i, want in enumerate(seen):
        np.testing.assert_array_equal(np.concatenate([p[i] for p in per_rank]), want)


def test_tail_of_nothing_raises_as_jax_does():
    raws = [synthetic_batch(QM9, 2, 9, np.random.default_rng(1))]
    state = type("S", (), {"model": torch.nn.Linear(1, 1)})()
    with pytest.raises(RuntimeError, match="zero batches"):
        ptrainer.train_epoch(state, None, raws, NODES, torch.Generator(), 0, prefetch=0,
                             data=_Ranks(0, 3))


def test_weighted_eval_nll_matches_jax():
    """Three molecules padded to four by repeating the first with weight 0
    (``trainer.pad_with_weight``, JAX's np.resize rule): the port's
    weighted eval NLL against JAX's ``make_eval_nll`` with ``weight``."""
    jcfg, pcfg, params, state = _jax_pair(KW, 31)
    batch = ptrainer.pad_with_weight(_qm9_batch(32, 3), 4)
    np.testing.assert_array_equal(batch["weight"], [1, 1, 1, 0])
    np.testing.assert_array_equal(batch["x"][3], batch["x"][0])
    key = jax.random.key(33)
    want = float(jax.jit(jts.make_eval_nll(jcfg))(params, _jax_batch(batch), key))
    model = pfactory.build_model(pcfg, "cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    draws = jax_ldm_draws(key, 4, 9, KW["latent_nf"], KW["diffusion_steps"], True)
    got = pts.make_eval_nll(pcfg)(model, ptrainer.to_device(batch, "cpu"), Feed(draws))
    np.testing.assert_allclose(float(got), want, rtol=CALL_RTOL)
    # Weight 0 on a molecule removes it from the mean.
    unweighted = {k: v[:3] for k, v in batch.items() if k != "weight"}
    draws3 = jax_ldm_draws(key, 3, 9, KW["latent_nf"], KW["diffusion_steps"], True)
    alone = float(jax.jit(jts.make_eval_nll(jcfg))(params, _jax_batch(unweighted), key))
    got3 = pts.make_eval_nll(pcfg)(model, ptrainer.to_device(unweighted, "cpu"), Feed(draws3))
    np.testing.assert_allclose(float(got3), alone, rtol=CALL_RTOL)


def test_dp_eval_nll_counts_every_molecule_once():
    """Batches of 4, 4 and 3 molecules over 2 data ranks: the tail is
    padded to the nominal 4 with a weight-0 repeat; the DP mean equals one
    rank's mean over the same padded batches, weighted by the real counts."""
    spec = {"dataset": "qm9", "kw": KW, "seed": 3}
    raws = [synthetic_batch(QM9, b, 9, np.random.default_rng(40 + i))
            for i, b in enumerate((4, 4, 3))]
    want = ranks.eval_nll(spec, raws, 9, 4)
    got = sharding.spawn(2, 1, ranks.eval_nll, (spec, raws, 9, 0), device="cpu")
    assert abs(got - want) <= LOSS_RTOL * abs(want)


@pytest.mark.parametrize("conditional", [False, True])
def test_dp_sampling_equals_one_rank(conditional):
    """Seven molecules in chunks of at most 2 (four chunks over two buckets)
    fanned out over 2 data ranks: the same molecules as one rank's run, bit
    for bit, and the same numpy draws consumed (a conditional model draws
    every chunk's properties on every rank, in dispatch order)."""
    kw = COND_KW if conditional else KW
    spec = {"dataset": "qm9", "kw": {**kw, "diffusion_steps": 6}, "seed": 5}
    sizes = [5, 19, 7, 21, 6, 9, 18]
    props = (np.array([5, 6, 7, 9, 18, 19, 21] * 3), np.linspace(60, 90, 21)) \
        if conditional else None
    want = ranks.sample(spec, 3, sizes, 2, props)
    got = sharding.spawn(2, 1, ranks.sample, (spec, 3, sizes, 2, props), device="cpu")
    assert got["rng_next"] == want["rng_next"]
    for g, w in zip(got["arrays"], want["arrays"]):
        np.testing.assert_array_equal(g, w)


def test_global_noise_rows_are_one_ranks_draws():
    """Each data rank's draws are its rows of the one-rank draw, for every
    kind of draw, from a generator and from a replayed source."""
    one = torch.Generator().manual_seed(0)
    want_n, want_i, want_u = (torch.randn((6, 2), generator=one),
                              torch.randint(0, 9, (6, 1), generator=one),
                              torch.rand((6, 1, 1), generator=one))
    for r in range(3):
        noise = sharding.GlobalNoise(torch.Generator().manual_seed(0), _Ranks(r, 3))
        rows = slice(2 * r, 2 * r + 2)
        assert torch.equal(noise((2, 2)), want_n[rows])
        assert torch.equal(noise.randint(0, 9, (2, 1)), want_i[rows])
        assert torch.equal(noise.rand((2, 1, 1)), want_u[rows])
    replay = sharding.GlobalNoise(ranks.Replay([("n", np.arange(8.0).reshape(4, 2))]),
                                  _Ranks(1, 2))
    assert replay((2, 2)).tolist() == [[4.0, 5.0], [6.0, 7.0]]
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_rows({"x": np.zeros((5, 1))}, _Ranks(0, 2))


@pytest.mark.parametrize("backend,device,wire", [
    ("gloo", "cpu", "cpu"), ("gloo", "cuda:0", "cpu"), ("nccl", "cuda:1", "cuda:1")])
def test_collectives_run_where_the_backend_takes_tensors(backend, device, wire):
    """Gloo takes host tensors (on a card, collectives are staged through
    host memory); NCCL takes tensors on the rank's card only."""
    assert sharding.RankGroup(0, 2, backend, torch.device(device)).wire == torch.device(wire)


class _Handed(Exception):
    """Raised by a mocked collective once it has seen its tensor."""


@pytest.mark.parametrize("collective", ["all_reduce", "all_gather_rows"])
def test_a_host_tensor_reaches_an_nccl_collective_on_the_card(monkeypatch, collective):
    """The packed NLL sums its totals as a host tensor: on an NCCL group (one
    card per rank) the collective must get them on the rank's card. The meta
    device stands in for the card and the collective is mocked; the card
    test of tests/test_torch_port_cuda.py runs a real NCCL group."""
    seen = []

    def handed(*args, group=None):
        seen.append(args[-1].device)
        raise _Handed

    monkeypatch.setattr(torch.distributed, collective.split("_rows")[0], handed)
    grp = sharding.RankGroup(0, 2, "nccl", torch.device("meta"))
    fn = sharding.all_reduce if collective == "all_reduce" else sp.all_gather_rows
    with pytest.raises(_Handed):
        fn(torch.ones(1, 2, 3, dtype=torch.float64), grp)
    assert seen == [torch.device("meta")]
