"""bf16 training on the CPU against the JAX package: the plain bf16 backwards
of the block (#2), the row-tiled stages (#5) and the SP slab stages (#7)
against JAX's bf16 vjps, one QM9-recipe train step in ``bfloat16`` against
JAX's, and the training CLIs in bf16 (``--compute_dtype bfloat16_pallas``,
``--resume``, ``--sp 2`` over gloo, the SP-2 step against one rank).

The plain bf16 backward is ``torch.autograd.grad`` of the plain bf16 forward:
every product takes bf16 operands (``nn.core.round_operand``), so its
transpose returns each operand's gradient rounded to bf16 while the
cotangent stays f32, as ``jax.vjp`` of ``_matmul`` does. Each comparison also
holds the port SEPARATION times closer, on the mean (over every element,
each difference in units of its tensor's max(1, max|ref|)), to JAX's bf16
gradients than to the port's f32 ones (``tests/torch_port_bf16_sites.py:
bf16_grads_report``).

Tolerances: per tensor 2e-3 * max(1, max|ref|) (BLOCK_RTOL). Both sides round
the same values to bf16 but sum in other orders, so an operand or a weight
gradient that sits at a rounding tie ends one bf16 step (2^-8 relative)
apart; the gate holds a few such flips, and a weight gradient's flips of
its own rounding are counted apart: at most the larger of 16 elements and
JAX_FLIP_SHARE (5%) of it, or JAX_STEP_FLIP_SHARE (20%) in a whole train
step (the readings, at most 8 of 64 elements, 2.44% of 9728 and, in the
step, 10.1% of 2112, are in tests/torch_port_bf16_sites.py). JAX's row-tiled and
SP kernels (#5, #7) round each grid step's weight gradient before adding the
steps in f32 (``_accumulate``), one step per molecule at these shapes; the
port rounds the batch's sum once (ROADMAP §3, deliberate), so those tests run
the plain version molecule by molecule, which puts its rounding sites where
JAX's are, and add its weight gradients in f32."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu.config import EGNNConfig as JaxEGNNConfig
from geoldm_tpu.config import TrainConfig
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.nn.egnn import block_apply, egnn_init
from geoldm_tpu.ops import pallas_egnn_sp as jsp
from geoldm_tpu.ops import pallas_egnn_tiled as jtiled
from geoldm_tpu.ops.distance import build_edge_mask, coord2diff, sin_embedding
from geoldm_tpu.ops.pallas_egnn import fused_block_apply
from geoldm_tpu.train import train_step as jts
from geoldm_tpu_torch.cli import main_geom_drugs, main_qm9
from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.synthetic import write_geom_conformers, write_qm9_splits
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.nn.egnn import EGNN
from geoldm_tpu_torch.ops import egnn_block, egnn_sp, egnn_tiled
from geoldm_tpu_torch.parallel import sharding
from geoldm_tpu_torch.train import train_step as pts
from geoldm_tpu_torch.utils.convert import state_dict_from_jax_params
from tests.torch_port_bf16_sites import (JAX_FLIP_SHARE, JAX_STEP_FLIP_SHARE, SEPARATION,
                                         bf16_flips, bf16_grads_report, flips_allowed,
                                         sp_grads_report)
from tests.torch_port_utils import (Feed, block_grads_by_name, jax_ldm_draws, load_egnn_from_jax,
                                    masked_inputs, t)
import torch_port_sp_ranks

torch.set_num_threads(1)

BLOCK_RTOL = 2e-3
BF16 = torch.bfloat16
BASE = dict(in_node_nf=6, out_node_nf=6, hidden_nf=64, n_layers=1, inv_sublayers=1,
            attention=True, tanh=True, coords_range=15.0, norm_constant=1.0,
            sin_embedding=False, normalization_factor=100.0, aggregation_method="sum")
VARIANTS = {
    "sum": {},
    "no_attention": {"attention": False},
    "sin": {"sin_embedding": True},
    "inv_sublayers_2": {"inv_sublayers": 2},
    "mean_no_tanh": {"aggregation_method": "mean", "tanh": False, "normalization_factor": 1.0},
}


@functools.lru_cache(maxsize=None)
def _pair(variant, seed=0):
    d = {**BASE, **VARIANTS[variant]}
    pcfg, jcfg = EGNNConfig(**d), JaxEGNNConfig(**d)
    params = egnn_init(jax.random.key(seed), jcfg)
    block = load_egnn_from_jax(EGNN(pcfg), params, pcfg.attention).e_block_0
    return block, jcfg, jax.tree.map(lambda a: a[0], params["blocks"])


def _arrays(seed, n, n_real, hidden=64):
    """h, x, x0, mask of ragged molecules and the cotangents of a block's two
    outputs (numpy)."""
    _, x, x0, mask = masked_inputs(seed, len(n_real), n, 1, n_real)
    rng = np.random.default_rng(seed + 10)
    h = rng.standard_normal((len(n_real), n, hidden)).astype(np.float32) * mask
    cots = [rng.standard_normal((len(n_real), n, f)).astype(np.float32) for f in (hidden, 3)]
    return (h, x, x0, mask), cots


def _assert_report(what, names, got, want, want_f32):
    r = bf16_grads_report(names, [t(np.asarray(a)) for a in got],
                          [t(np.asarray(a)).reshape(np.shape(g)) for a, g in zip(want, got)],
                          [t(np.asarray(a)) for a in want_f32], rtol=BLOCK_RTOL,
                          flip_share=JAX_FLIP_SHARE)
    assert not r["problems"], f"{what}: {r['problems']}"


def _flat(r, k=3):
    return [a.detach().numpy() for a in (*r[:k], *r[k])]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_block_backward_plain_matches_pallas_vjp_and_xla(variant):
    """The plain bf16 block backward against ``jax.vjp`` of the fused block
    in bf16 (``_make_bwd_kernel`` in interpret mode, exact dx0) and of the
    XLA ``block_apply(..., "bfloat16")`` (dx0 through the initial distance
    features): dh, dx, dx0 and every weight gradient within BLOCK_RTOL,
    SEPARATION times closer to both than the port's f32 backward."""
    block, jcfg, bp = _pair(variant)
    (h, x, x0, mask), (gh, gx) = _arrays(1, 9, (5, 9))
    args = [t(a) for a in (h, x, x0, mask, gh, gx)]
    got = _flat(egnn_block.block_backward_plain(block, *args, compute_dtype=BF16))
    f32 = _flat(egnn_block.block_backward_plain(block, *args))
    names = ["dh", "dx", "dx0"] + egnn_block.block_param_names(block)

    hj, xj, x0j, mj = map(jnp.asarray, (h, x, x0, mask))
    cot = (jnp.asarray(gh), jnp.asarray(gx))
    _, vjp = jax.vjp(lambda p, h_, x_, x0_: fused_block_apply(
        jcfg, p, h_, x_, x0_, mj, jnp.bfloat16, True, None, "pallas"), bp, hj, xj, x0j)
    dbp, *d_in = vjp(cot)

    def xla(p, h_, x_, x0_):
        radial0, _ = coord2diff(x0_)
        e0 = sin_embedding(radial0) if jcfg.sin_embedding else radial0
        return block_apply(p, jcfg, h_, x_, e0, mj, build_edge_mask(mj), "bfloat16")

    _, vjp_x = jax.vjp(xla, bp, hj, xj, x0j)
    dbp_x, *d_in_x = vjp_x(cot)
    for ref, grads, inputs in (("pallas", dbp, d_in), ("xla", dbp_x, d_in_x)):
        by_name = block_grads_by_name(grads, jcfg.attention)
        want = [*inputs, *[by_name[k] for k in names[3:]]]
        _assert_report(f"{variant} vs JAX {ref}", names, got, want, f32)


def _per_molecule(fn, batched_args, b, n_views=1):
    """fn over each molecule alone (its tensors' first axis sliced), the
    per-molecule input gradients stacked and the weight gradients added in
    f32: JAX's grid-step rounding of the weight gradients."""
    outs = [fn(*[a[i:i + 1] if isinstance(a, torch.Tensor) and a.dim() == 3 else a
                 for a in batched_args]) for i in range(b)]
    k = 3 * n_views
    ins = [torch.cat([o[j] for o in outs]) for j in range(k)]
    ws = [sum(o[k][j] for o in outs) for j in range(len(outs[0][k]))]
    return [*ins, ws]


@pytest.mark.parametrize("variant", ["sum", "sin", "mean_no_tanh"])
def test_bf16_tiled_block_backward_plain_matches_pallas_vjp(variant):
    """The row-tiled block in bf16 through ``TiledEquivariantBlockFunction``
    (its CPU route: the plain bf16 stage backwards, each GCL handed its kept
    node chain) against ``jax.vjp`` of ``tiled_block_apply(..., jnp.bfloat16,
    True, tile=8)`` (kernels #3-#5 in interpret mode), 20 atoms padded to 24
    for JAX, 'mean' told the caller's 20. Molecule by molecule (module
    docstring); within BLOCK_RTOL, SEPARATION times closer than f32."""
    block, jcfg, bp = _pair(variant, seed=2)
    n = 20
    (h, x, x0, mask), (gh, gx) = _arrays(3, n, (n, n - 7))
    names = ["dh", "dx", "dx0"] + egnn_block.block_param_names(block)

    def port(dtype):
        def one(h_, x_, x0_, m_, gh_, gx_):
            inputs = [a.clone().requires_grad_() for a in (h_, x_, x0_)]
            ws = egnn_block.block_params(block)
            outs = egnn_tiled.TiledEquivariantBlockFunction.apply(block, dtype, *inputs, m_,
                                                                  *ws)
            grads = torch.autograd.grad(outs, inputs + ws, (gh_, gx_))
            return [*grads[:3], list(grads[3:])]

        return _flat(_per_molecule(one, [t(a) for a in (h, x, x0, mask, gh, gx)], 2))

    def pad(a):
        return jnp.pad(jnp.asarray(a), ((0, 0), (0, 24 - n), (0, 0)))

    hj, xj, x0j, mj = map(pad, (h, x, x0, mask))
    _, vjp = jax.vjp(lambda p, h_, x_, x0_: jtiled.tiled_block_apply(
        jcfg, p, h_, x_, x0_, mj, jnp.bfloat16, True, 8, "pallas", n), bp, hj, xj, x0j)
    dbp, *d_in = vjp((pad(gh), pad(gx)))
    by_name = block_grads_by_name(dbp, jcfg.attention)
    want = [np.asarray(a)[:, :n] for a in d_in] + [by_name[k] for k in names[3:]]
    _assert_report(f"tiled {variant}", names, port(BF16), want, port(None))


N_SP, SLAB = 24, 8  # JAX's slab kernels tile rows in multiples of 8


@pytest.mark.parametrize("r0", [0, 8])
@pytest.mark.parametrize("variant", ["sum", "mean_no_tanh"])
def test_bf16_sp_stage_backward_plain_matches_jax(variant, r0):
    """The plain bf16 SP stage backwards (#7's) against ``jax.vjp`` of
    ``sp_stage_apply`` in bf16 (the slab kernels in interpret mode), at the
    first slab and mid-grid (the diagonal at the global row), molecules of
    20 and 17 atoms padded to 24 ('mean' over 20); full-view and row-view
    gradients apart and the slab's weight gradients, molecule by molecule
    (module docstring); within BLOCK_RTOL, SEPARATION times closer than
    f32."""
    block, jcfg, bp = _pair(variant, seed=4)
    _, x, x0, mask = masked_inputs(2, 2, N_SP, 1, (20, 17))
    h = np.random.default_rng(12).standard_normal((2, N_SP, 64)).astype(np.float32) * mask
    full = (h, x, x0, mask)
    rows = tuple(a[:, r0:r0 + SLAB] for a in full)
    mean_div = 20 if variant == "mean_no_tanh" else 0
    tiles = jsp.sp_stage_tiles(SLAB, N_SP, 64)
    rng = np.random.default_rng(r0 + 1)
    for kind, module, fn, feat in (
            ("gcl", block.gcl_0, egnn_sp.sp_gcl_rows_backward_plain, 64),
            ("coord", block.gcl_equiv, egnn_sp.sp_coord_rows_backward_plain, 3)):
        g = rng.standard_normal((2, SLAB, feat)).astype(np.float32)
        weights = (jtiled._gcl_weight_dict(jcfg, bp["gcls"][0])[0] if kind == "gcl"
                   else jtiled._coord_weight_dict(bp))
        _, vjp = jax.vjp(lambda w, f, r: jsp.sp_stage_apply(
            jcfg, kind, N_SP, tiles, jnp.bfloat16, True, mean_div, w, f, r,
            jnp.asarray([r0], jnp.int32)), weights, tuple(map(jnp.asarray, full)),
            tuple(map(jnp.asarray, rows)))
        dws, d_full, d_rows = vjp(jnp.asarray(g))
        keys, _, _ = jsp._stage_props(jcfg, kind)
        want = [*d_full[:3], *d_rows[:3]] + [
            np.asarray(dws[k]).T if np.ndim(dws[k]) == 2 else dws[k] for k in keys]

        def port(dtype):
            def one(h_, x_, x0_, m_, hr, xr, x0r, mr, g_):
                return fn(module, (h_, x_, x0_, m_), (hr, xr, x0r, mr), r0, 20, g_,
                          compute_dtype=dtype)
            return _flat(_per_molecule(one, [t(a) for a in (*full, *rows, g)], 2, n_views=2), 6)

        names = ["dh", "dx", "dx0", "dh_rows", "dx_rows", "dx0_rows"] + \
            egnn_tiled.stage_weight_names(module)
        _assert_report(f"SP {variant} {kind} r0={r0}", names, port(BF16), want, port(None))


# ---------------------------------------------------------------------------
# A train step and the CLIs.
# ---------------------------------------------------------------------------

KW = dict(nf=32, n_layers=2, latent_nf=2, diffusion_steps=20, trainable_ae=True)
B, N, N_REAL = 3, 9, (4, 9, 7)
# A whole step's gradient, port vs JAX in bf16: per tensor max|d| <=
# STEP_RTOL * max|ref| (no floor of 1: small gradients are held too), a
# weight gradient's one-step rounding flips excepted (``flips_allowed`` at
# JAX_STEP_FLIP_SHARE: 10.1% of 2112 elements at most; else 1.1e-3, a
# flip); the loss within LOSS_RTOL (7e-8 on the CPU).
STEP_RTOL, LOSS_RTOL = 2e-3, 1e-5


def _molecules(seed):
    _, x, _, mask = masked_inputs(seed, B, N, 1, N_REAL)
    types = np.random.default_rng(seed + 100).integers(0, 5, (B, N))
    h_cat = np.eye(5, dtype=np.float32)[types] * mask
    h_int = np.array([1, 6, 7, 8, 9], dtype=np.float32)[types][..., None] * mask
    return x, h_cat, h_int, mask, np.full(B, -2.0, dtype=np.float32)


def test_bf16_train_step_matches_jax():
    """One QM9-recipe train step (nf 32, 2 layers, trainable_ae) in
    ``bfloat16``: the port's ``make_train_step(..., "bfloat16")`` against
    JAX's from the same weights (``state_dict_from_jax_params``) and draws:
    the loss and the gradient norm, and every gradient (the port's after its
    step, JAX's by ``jax.grad`` of the step's loss) within STEP_RTOL, on the
    mean SEPARATION times closer to JAX's bf16 gradient than to the port's
    f32 step."""
    jcfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **KW)
    pcfg = pfactory.make_latent_diffusion_config(get_dataset_info("qm9"), **KW)
    tc = TrainConfig(lr=1e-3, ema_decay=0.9)
    jstate, tx = jts.create_train_state(jax.random.key(11), jcfg, tc)
    x, h_cat, h_int, mask, log_pn = _molecules(20)
    mj = jnp.asarray(mask)
    jbatch = {"x": jnp.asarray(x), "h_cat": jnp.asarray(h_cat), "h_int": jnp.asarray(h_int),
              "node_mask": mj, "edge_mask": build_edge_mask(mj), "log_pN": jnp.asarray(log_pn)}
    key = jax.random.key(12)
    jstep = jts.make_train_step(jcfg, tc, tx, "bfloat16")
    nll = jfactory.model_nll_fn(jcfg, training=True, compute_dtype="bfloat16")

    def step_and_grads(state, batch):
        grads = jax.grad(lambda p: jnp.mean(nll(
            p, key, batch["x"], batch["h_cat"], batch["h_int"], batch["node_mask"],
            batch["edge_mask"], None) - batch["log_pN"]))(state.params)
        return jstep(state, batch, key)[1], grads

    jm, jgrads = jax.jit(step_and_grads)(jstate, jbatch)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads), pcfg)

    steps = {}
    for dtype in ("bfloat16", "float32"):
        model = pfactory.build_model(pcfg, "cpu")
        model.load_state_dict(state_dict_from_jax_params(
            jax.tree.map(np.asarray, jstate.params), pcfg), strict=True)
        state = pts.create_train_state(model, pcfg, tc.lr, ema_decay=tc.ema_decay)
        pm = pts.make_train_step(pcfg, tc.ema_decay, dtype)(
            state, {"x": t(x), "h_cat": t(h_cat), "h_int": t(h_int), "node_mask": t(mask),
                    "log_pN": t(log_pn)},
            Feed(jax_ldm_draws(key, B, N, 2, KW["diffusion_steps"], False)))
        steps[dtype] = pm, {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    pm, grads = steps["bfloat16"]
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    assert grads and set(grads) <= set(want)
    err = dist = 0.0
    for name, g in grads.items():
        w = torch.from_numpy(np.asarray(want[name])).reshape(g.shape)
        scale = float(w.abs().max())
        diff = (g - w).abs()
        if name.endswith("weight"):
            flips = bf16_flips(g, w)
            assert int(flips.sum()) <= flips_allowed(g.numel(), JAX_STEP_FLIP_SHARE), name
            diff = diff.masked_fill(flips, 0.0)
        assert float(diff.max()) <= STEP_RTOL * scale, (name, float(diff.max()), scale)
        err += float((g - w).abs().mean()) / scale
        dist += float((g - steps["float32"][1][name]).abs().mean()) / scale
    assert SEPARATION * err <= dist, (err, dist)


@pytest.fixture(scope="module")
def qm9_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("qm9_bf16"))
    write_qm9_splits(path, get_dataset_info("qm9"), {"train": 16, "valid": 6, "test": 6}, seed=2)
    return path


def test_main_qm9_trains_in_bf16_and_resumes(qm9_dir, tmp_path):
    """``cli.main_qm9 --compute_dtype bfloat16_pallas --device cpu``: one
    latent-diffusion epoch with finite losses, NLLs and stability samples in
    bf16; then ``--resume`` of that run for a second epoch in ``bfloat16``
    (the checkpoint holds the model, the flag the dtype)."""
    argv = ["--datadir", qm9_dir, "--outdir", str(tmp_path), "--exp_name", "bf16",
            "--train_diffusion", "--trainable_ae", "--nf", "16", "--n_layers", "2",
            "--diffusion_steps", "6", "--batch_size", "8", "--test_epochs", "1",
            "--n_stability_samples", "3", "--ema_decay", "0.9", "--device", "cpu",
            "--no_wandb"]
    first = main_qm9.main(argv + ["--n_epochs", "1", "--compute_dtype", "bfloat16_pallas"])
    assert np.all(np.isfinite(first["losses"][0])) and len(first["losses"][0]) == 2
    assert np.isfinite(first["nll_val"][0]) and np.isfinite(first["nll_test"][0])
    assert first["stability"] and first["sample_sizes"][0].shape == (3,)
    resumed = main_qm9.main(argv + ["--n_epochs", "2", "--start_epoch", "1", "--compute_dtype",
                                    "bfloat16", "--resume", str(tmp_path / "bf16")])
    assert resumed["state"].step == 4 and np.all(np.isfinite(resumed["losses"][0]))


GEOM = get_dataset_info("geom")
SP_KW = dict(nf=32, n_layers=2, latent_nf=2, include_charges=False, trainable_ae=True,
             diffusion_steps=20)


def test_main_geom_drugs_bf16_sp2_on_cpu(tmp_path):
    """``cli.main_geom_drugs --compute_dtype bfloat16 --sp 2 --device cpu``:
    one epoch over two gloo ranks with finite losses and NLLs, the replicas'
    train states bit-identical."""
    write_geom_conformers(str(tmp_path), GEOM, 20, seed=4, sizes=[20, 25, 30, 28, 33, 22])
    summary = main_geom_drugs.main([
        "--datadir", str(tmp_path), "--outdir", str(tmp_path / "out"), "--exp_name", "sp",
        "--sp", "2", "--compute_dtype", "bfloat16", "--train_diffusion", "--trainable_ae",
        "--n_epochs", "1", "--test_epochs", "1", "--batch_size", "4", "--nf", "32",
        "--n_layers", "1", "--diffusion_steps", "6", "--n_stability_samples", "3",
        "--ema_decay", "0.99", "--device", "cpu", "--no_wandb"])
    assert len(summary["losses"][0]) >= 2 and np.all(np.isfinite(summary["losses"][0]))
    assert np.isfinite(summary["nll_val"][0]) and np.isfinite(summary["nll_test"][0])
    r0, r1 = summary["replicas"]
    assert r0["digest"] == r1["digest"]
    assert os.path.isdir(tmp_path / "out" / "sp" / "best")


def _geom_batch(seed, n, sizes):
    rng = np.random.default_rng(seed)
    mask = (np.arange(n)[None] < np.asarray(sizes)[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((len(sizes), n, 3)).astype(np.float32) * 1.5 * mask
    x -= x.sum(axis=1, keepdims=True) / mask.sum(axis=1, keepdims=True) * mask
    types = rng.integers(0, len(GEOM.atom_decoder), (len(sizes), n))
    h_cat = np.eye(len(GEOM.atom_decoder), dtype=np.float32)[types] * mask
    return {"x": x.astype(np.float32), "h_cat": h_cat,
            "h_int": np.zeros((len(sizes), n, 0), np.float32), "node_mask": mask,
            "log_pN": np.full(len(sizes), -4.0, np.float32)}


def test_bf16_sp_train_step_matches_one_rank():
    """SP-2 vs one rank in bf16: the forward and the loss are the same
    (within 1e-5 of the loss: f32 order); the backward rounds at other sites
    (ROADMAP §3), so the steps are held to ``sp_grads_report``: per tensor
    within SP_RTOL (1e-2) * max|ref|, a one-element tensor within a quarter
    of its own bf16-vs-f32 distance where that is larger, and on the mean
    SP_SEPARATION (4) times closer to the one-rank bf16 step than to its f32
    step (tests/torch_port_bf16_sites.py, with the readings)."""
    batch = _geom_batch(7, 19, (19, 14))
    want = torch_port_sp_ranks.geom_train_step_bf16(SP_KW, batch, 3, "cpu")
    want_f32 = torch_port_sp_ranks.geom_train_step(SP_KW, batch, 3, "cpu")
    got = sharding.spawn(1, 2, torch_port_sp_ranks.geom_train_step_bf16,
                         (SP_KW, batch, 3, "cpu"), device="cpu")
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    r = sp_grads_report(got["grads"], want["grads"], want_f32["grads"])
    assert not r["problems"], r["problems"]
    assert len(set(got["digests"])) == 1, "the replicas differ after the step"
