"""Sequence-parallel (SP) training on the CPU: one SP-2 latent-diffusion train
step over gloo ranks against the port's single-rank step on the same weights,
batch and noise (the only check that catches a factor of S in a gradient),
the replicas bit-identical afterwards; one ``cli.main_geom_drugs --sp 2
--device cpu`` epoch; the flag rules (``--sp`` with ``--tp`` refused as JAX
refuses it, a ``--dp`` wider than the batch refused, ``--dp 0`` resolving to
every card over ``--sp``) and the rank placement rule."""

import copy
import os

import numpy as np
import pytest
import torch

from geoldm_tpu_torch.cli import main_geom_drugs, main_qm9
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.synthetic import write_geom_conformers
from geoldm_tpu_torch.models import factory
from geoldm_tpu_torch.parallel import sharding, sp
import torch_port_sp_ranks

torch.set_num_threads(1)

GEOM = get_dataset_info("geom")
KW = dict(nf=32, n_layers=2, latent_nf=2, include_charges=False, trainable_ae=True,
          diffusion_steps=20)
# SP vs one rank: the same f32 math in other sum orders (slab kernels'
# plain versions, gathers, the all-reduced block gradients).
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3


def _geom_batch(seed, n, sizes):
    rng = np.random.default_rng(seed)
    mask = (np.arange(n)[None] < np.asarray(sizes)[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((len(sizes), n, 3)).astype(np.float32) * 1.5 * mask
    x -= x.sum(axis=1, keepdims=True) / mask.sum(axis=1, keepdims=True) * mask
    types = rng.integers(0, len(GEOM.atom_decoder), (len(sizes), n))
    h_cat = np.eye(len(GEOM.atom_decoder), dtype=np.float32)[types] * mask
    return {"x": x.astype(np.float32), "h_cat": h_cat, "h_int": np.zeros((len(sizes), n, 0),
                                                                          np.float32),
            "node_mask": mask, "log_pN": np.full(len(sizes), -4.0, np.float32)}


@pytest.mark.parametrize("size,n,sizes", [(2, 19, (19, 14)), (4, 21, (21, 17))])
def test_sp_train_step_matches_one_rank(size, n, sizes):
    """Loss and every gradient (after the step's block-gradient all-reduce)
    of an SP step against the same step on one rank; the pad (19 -> 20, 21 ->
    24) runs masked slab rows; every replica ends bit-identical."""
    batch = _geom_batch(7, n, sizes)
    want = torch_port_sp_ranks.geom_train_step(KW, batch, 3, "cpu")
    got = sharding.spawn(1, size, torch_port_sp_ranks.geom_train_step, (KW, batch, 3, "cpu"),
                         device="cpu")
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        err = float(np.abs(got["grads"][name] - g).max())
        assert err <= GRAD_RTOL * float(np.abs(g).max()), (name, err)
    assert len(got["digests"]) == size and len(set(got["digests"])) == 1, \
        "the replicas differ after the step"


@pytest.fixture(scope="module")
def geom_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("geom_sp")
    write_geom_conformers(str(path), GEOM, 20, seed=4, sizes=[20, 25, 30, 28, 33, 22])
    return str(path)


def test_main_geom_drugs_sp_on_cpu_keeps_the_replicas_in_step(geom_dir, tmp_path):
    summary = main_geom_drugs.main([
        "--datadir", geom_dir, "--outdir", str(tmp_path), "--exp_name", "sp", "--sp", "2",
        "--train_diffusion", "--trainable_ae", "--n_epochs", "1", "--test_epochs", "1",
        "--batch_size", "4", "--nf", "32", "--n_layers", "1", "--diffusion_steps", "6",
        "--n_stability_samples", "3", "--ema_decay", "0.99", "--device", "cpu"])
    losses = summary["losses"][0]
    assert len(losses) >= 2 and np.all(np.isfinite(losses))
    assert np.isfinite(summary["nll_val"][0]) and np.isfinite(summary["nll_test"][0])
    assert "state" not in summary and [r["rank"] for r in summary["replicas"]] == [0, 1]
    r0, r1 = summary["replicas"]
    assert r0["digest"] == r1["digest"], "the replicas' train states differ"
    # The stability samples run on every rank, on the single-device route,
    # from the same seed and draws.
    assert r0["stability"] == r1["stability"] == summary["stability"]
    assert r0["sample_sizes"] == r1["sample_sizes"] and len(r0["sample_sizes"][0]) == 3
    assert r0["launches"] == r1["launches"] and not any(r0["launches"].values())  # CPU: plain
    assert os.path.isdir(tmp_path / "sp" / "best") and os.path.isdir(tmp_path / "sp" / "latest")


@pytest.mark.parametrize("main", [main_geom_drugs.main, main_qm9.main])
@pytest.mark.parametrize("flags,message", [
    (["--sp", "2", "--tp", "2"], "--sp and --tp cannot be combined"),
    (["--sp", "2", "--dp", "4", "--batch_size", "2"], "--dp 4 splits every batch"),
    (["--tp", "3"], "--tp 3 shards every --nf-wide parameter over 3 model ranks, but --nf 256"),
])
def test_sp_flag_rules(main, flags, message, tmp_path):
    with pytest.raises(SystemExit) as e:
        main(["--datadir", str(tmp_path), "--device", "cpu", *flags])
    assert str(e.value.code).startswith(message)


def test_dp_resolves_to_one_beside_sp_on_one_card(monkeypatch):
    """``--dp 0`` (the default) is every card divided by ``--sp``, as JAX's
    ``make_mesh(dp=0)`` and ``max(1, n_dev // sp)``; 1 on the CPU."""
    from geoldm_tpu_torch.cli.common import resolve_dp

    args = main_geom_drugs.parse_args(["--sp", "2"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_dp(args) == 1
    assert resolve_dp(main_geom_drugs.parse_args([])) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert resolve_dp(args) == 2  # a 2 x 2 grid, one card per rank
    assert resolve_dp(main_geom_drugs.parse_args([])) == 4
    assert resolve_dp(main_geom_drugs.parse_args(["--device", "cpu"])) == 1
    assert resolve_dp(main_geom_drugs.parse_args(["--sp", "2", "--dp", "1"])) == 1


@pytest.mark.parametrize("cards,size,want", [
    (1, 2, ("gloo", ["cuda:0", "cuda:0"])),
    (1, 4, ("gloo", ["cuda:0"] * 4)),
    (4, 2, ("nccl", ["cuda:0", "cuda:1"])),
    (2, 2, ("nccl", ["cuda:0", "cuda:1"])),
    (2, 4, None),
])
def test_rank_placement_rule(monkeypatch, cards, size, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want is None:
        with pytest.raises(ValueError, match="one card per rank"):
            sharding.placement(size, "cuda")
        return
    devices, backend, rule = sharding.placement(size, "cuda")
    assert (backend, [str(d) for d in devices]) == want and backend in rule
    devices, backend, _ = sharding.placement(size, "cpu")
    assert backend == "gloo" and {str(d) for d in devices} == {"cpu"}


def test_groups_attach_to_every_egnn_and_survive_the_ema_copy():
    cfg = factory.make_latent_diffusion_config(GEOM, **{**KW, "n_layers": 1})
    grp = sharding.RankGroup(rank=1, size=2, backend="gloo", device=torch.device("cpu"))
    model = factory.build_model(cfg, "cpu", torch.Generator().manual_seed(0), sp_group=grp)
    assert sp.model_group(model) is grp
    assert sp.model_group(copy.deepcopy(model)) is grp  # the EMA model
    blocks = sp.block_parameters(model)
    names = {id(p): n for n, p in model.named_parameters()}
    assert blocks and all(".e_block_" in names[id(p)] for p in blocks)
    assert len(blocks) == sum(1 for n in names.values() if ".e_block_" in n)
    with sp.detached(model):
        assert sp.model_group(model) is None
    assert sp.model_group(model) is grp


def test_launch_counters_read_and_reset_in_one_registry():
    from geoldm_tpu_torch import ops
    from geoldm_tpu_torch.ops import egnn_block, egnn_sp, egnn_tiled

    saved = ops.kernel_launches()
    try:
        assert set(saved) == set(ops.LAUNCH_COUNTERS) and len(saved) == 22  # 10 + 10 bf16 + 2 lowp
        egnn_block.bwd_launches, egnn_tiled.coord_rows_launches = 2, 3
        egnn_sp.sp_gcl_rows_bwd_launches = 5
        got = ops.kernel_launches()
        assert (got["egnn_block_bwd"], got["coord_rows"], got["sp_gcl_rows_bwd"]) == (2, 3, 5)
        ops.reset_kernel_launches()
        assert ops.kernel_launches() == dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    finally:
        for k, (mod, attr) in ops.LAUNCH_COUNTERS.items():
            setattr(getattr(ops, mod), attr, saved[k])
