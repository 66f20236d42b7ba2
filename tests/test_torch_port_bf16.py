"""The bf16 compute dtypes on the CPU, against the JAX package: the compute
names (``nn/core.py:resolve_compute``); the plain bf16 versions of kernel #1
(the block) and of #3/#4 (the row-tiled stages) against JAX's Pallas kernels
with a bf16 compute dtype (``bfloat16_pallas``, interpret mode) and JAX's
``bfloat16`` XLA path, per block or stage; the bf16 denoiser against JAX's
``bfloat16``; the packed NLL in bf16 against JAX's; the whole EGNN against
JAX's ``bfloat16_full``.

Each bf16 comparison also holds the port SEPARATION times closer, on the
mean, to JAX's bf16 result than to the f32 one, and than to a plain version
that leaves one rounding site in f32 (``tests/torch_port_bf16_sites.py``):
the gate on the largest difference alone would pass an f32 product.

Tolerances: per block or stage 2e-3 * max(1, max|ref|). Both sides round the
same operands to bf16 and multiply them exactly in f32, but sum in other
orders, and an operand that sits at a rounding tie flips by one bf16 ulp
(2^-8 relative) under another order; 2e-3 bounds a few such flips. The EGNN
against ``bfloat16_full``: 5e-2 * max(1, max|ref|), since JAX's ``full`` also
keeps activations and parameters in bf16 and the port keeps them in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu.config import EGNNConfig as JaxEGNNConfig
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.nn import core as jcore
from geoldm_tpu.nn.dynamics import _run_egnn, dynamics_apply, dynamics_init
from geoldm_tpu.nn.egnn import (
    block_apply,
    egnn_init,
    equivariant_update_apply,
    gcl_apply,
)
from geoldm_tpu.ops import pallas_egnn_tiled as jtiled
from geoldm_tpu.ops.distance import build_edge_mask, coord2diff, sin_embedding
from geoldm_tpu.ops.pallas_egnn import fused_block_apply
from geoldm_tpu.train import trainer as jtrainer
from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.models.distributions import DistributionNodes
from geoldm_tpu_torch.nn import core as pcore
from geoldm_tpu_torch.nn.dynamics import EGNNDynamics
from geoldm_tpu_torch.nn.egnn import EGNN
from geoldm_tpu_torch.ops import egnn_block, egnn_tiled
from geoldm_tpu_torch.train import trainer as ptrainer
from tests.test_torch_port_eval import JINFO, _pass_feeds, datadir, pair  # noqa: F401
from tests.torch_port_bf16_sites import SITES, assert_separated, unrounded
from tests.torch_port_utils import load_egnn_from_jax, masked_inputs, t

torch.set_num_threads(1)

BLOCK_RTOL = 2e-3
FULL_RTOL = 5e-2
BF16 = torch.bfloat16
BASE = dict(in_node_nf=6, out_node_nf=6, hidden_nf=64, n_layers=2, inv_sublayers=1,
            attention=True, tanh=True, coords_range=15.0, norm_constant=1.0,
            sin_embedding=False, normalization_factor=100.0, aggregation_method="sum")
VARIANTS = {
    "sum": {},
    "no_attention": {"attention": False},
    "sin": {"sin_embedding": True},
    "inv_sublayers_2": {"inv_sublayers": 2},
    "mean_no_tanh": {"aggregation_method": "mean", "tanh": False, "normalization_factor": 1.0},
}
JAX_TILE = 8


def _close(got, want, rtol, what=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max|d|={err:.3e} > {rtol}*{scale:.3g}"


def _pair(variant, seed=0):
    d = {**BASE, **VARIANTS[variant]}
    pcfg, jcfg = EGNNConfig(**d), JaxEGNNConfig(**d)
    params = egnn_init(jax.random.key(seed), jcfg)
    return load_egnn_from_jax(EGNN(pcfg), params, pcfg.attention), jcfg, params


def _hidden_inputs(seed, n, n_real):
    _, x, x0, mask = masked_inputs(seed, len(n_real), n, 1, n_real)
    h = np.random.default_rng(seed + 10).standard_normal(
        (len(n_real), n, BASE["hidden_nf"])).astype(np.float32) * mask
    return h, x, x0, mask


@pytest.mark.parametrize("name", pcore.COMPUTE_DTYPES)
def test_compute_names_resolve_as_jax(name):
    got, want = pcore.resolve_compute(name), jcore.resolve_compute(name)
    assert (got.dtype == BF16) == (want.dtype == jnp.bfloat16)
    assert (got.full, got.mixed_tail) == (want.full, want.mixed_tail)


def test_unknown_compute_name_raises():
    with pytest.raises(ValueError, match="bfloat16_mixed"):
        pcore.resolve_compute("float16")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_block_plain_matches_pallas_and_xla(variant):
    egnn, jcfg, params = _pair(variant)
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    h, x, x0, mask = _hidden_inputs(1, 9, (5, 9))
    with torch.no_grad():
        h_p, x_p = egnn_block.block_forward(egnn.e_block_0, t(h), t(x), t(x0), t(mask), BF16)
    hj, xj, x0j, mj = map(jnp.asarray, (h, x, x0, mask))
    h_f, x_f = fused_block_apply(jcfg, bp, hj, xj, x0j, mj, jnp.bfloat16, True)
    radial0, _ = coord2diff(x0j)
    e0 = sin_embedding(radial0) if jcfg.sin_embedding else radial0
    h_x, x_x = block_apply(bp, jcfg, hj, xj, e0, mj, build_edge_mask(mj), "bfloat16")
    with torch.no_grad():
        h_32, _ = egnn_block.block_forward(egnn.e_block_0, t(h), t(x), t(x0), t(mask))
    for ref, (ref_h, ref_x) in (("pallas", (h_f, x_f)), ("xla", (h_x, x_x))):
        _close(h_p, ref_h, BLOCK_RTOL, f"h vs {ref}")
        _close(x_p, ref_x, BLOCK_RTOL, f"x vs {ref}")
        # The rounding is real: the f32 block is SEPARATION times farther.
        assert_separated(h_p, np.asarray(ref_h), h_32, f"h vs {ref} and the f32 block")


def _jax_stage(jcfg, block_params, stage, n, arrays):
    """One stage through JAX's row-tiled Pallas kernel in bf16 (interpret
    mode), N padded to a multiple of the tile, 'mean' told the caller's N."""
    pad = -(-n // JAX_TILE) * JAX_TILE - n
    args = [jnp.pad(jnp.asarray(a), ((0, 0), (0, pad), (0, 0))) for a in arrays]
    b, n_pad = args[0].shape[0], n + pad
    if stage == "gcl":
        gw, keys = jtiled._gcl_weight_dict(jcfg, block_params["gcls"][0])
        kernel = jtiled._make_gcl_rows_kernel(jcfg, n_pad, JAX_TILE, jnp.bfloat16, keys, n)
        out = jtiled._call_rows(kernel, b, n_pad, JAX_TILE, jcfg.hidden_nf, jnp.float32, True,
                                args, [gw[k] for k in keys])
    else:
        cw = jtiled._coord_weight_dict(block_params)
        kernel = jtiled._make_coord_rows_kernel(jcfg, n_pad, JAX_TILE, jnp.bfloat16, n)
        out = jtiled._call_rows(kernel, b, n_pad, JAX_TILE, 3, jnp.float32, True, args,
                                [cw[k] for k in jtiled._COORD_KEYS])
    return np.asarray(out)[:, :n]


def _xla_stage(jcfg, bp, stage, arrays):
    """The same stage on JAX's XLA path with compute dtype 'bfloat16'."""
    h, x, x0, mask = map(jnp.asarray, arrays)
    radial, coord_diff = coord2diff(x, jcfg.norm_constant)
    radial0, _ = coord2diff(x0)
    feats = [sin_embedding(r) if jcfg.sin_embedding else r for r in (radial, radial0)]
    edge_attr = jnp.concatenate(feats, axis=-1)
    emask = build_edge_mask(mask)
    if stage == "gcl":
        return gcl_apply(bp["gcls"][0], jcfg, h, edge_attr, mask, emask, "bfloat16")
    return equivariant_update_apply(bp["coord_mlp"], jcfg, h, x, coord_diff, edge_attr, mask,
                                    emask, "bfloat16")


@pytest.mark.parametrize("stage", ["gcl", "coord"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_stage_plain_matches_pallas_tiled_and_xla(variant, stage):
    egnn, jcfg, params = _pair(variant)
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    n = 20
    arrays = _hidden_inputs(2, n, (n - 5, n))
    block = egnn.e_block_0
    with torch.no_grad():
        if stage == "gcl":
            got = egnn_tiled.gcl_rows_plain(block.gcl_0, *map(t, arrays), tile=7,
                                            compute_dtype=BF16)
        else:
            got = egnn_tiled.coord_rows_plain(block.gcl_equiv, *map(t, arrays), tile=7,
                                              compute_dtype=BF16)
    _close(got, _jax_stage(jcfg, bp, stage, n, arrays), BLOCK_RTOL, "vs pallas")
    _close(got, _xla_stage(jcfg, bp, stage, arrays), BLOCK_RTOL, "vs xla")


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("stage", ["gcl", "coord"])
def test_bf16_plain_rounds_each_site_as_jax(stage, site):
    """The plain bf16 stages round the edge features and the one-output
    products (gate, coordinate scale) where JAX's bf16 kernels do: JAX's
    result is SEPARATION times closer to them than to a version that leaves
    the site in f32. (The card tests hold the kernels to these versions.)"""
    egnn, jcfg, params = _pair("mean_no_tanh" if stage == "coord" else "sum")
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    n = 20
    arrays = _hidden_inputs(4, n, (n - 5, n))
    block = egnn.e_block_0
    fn, mod = ((egnn_tiled.gcl_rows_plain, block.gcl_0) if stage == "gcl"
               else (egnn_tiled.coord_rows_plain, block.gcl_equiv))
    with torch.no_grad():
        got = fn(mod, *map(t, arrays), tile=7, compute_dtype=BF16)
        with unrounded(site, block.cfg.edge_feat_nf):
            other = fn(mod, *map(t, arrays), tile=7, compute_dtype=BF16)
    want = _jax_stage(jcfg, bp, stage, n, arrays)
    _close(got, want, BLOCK_RTOL, "vs pallas")
    assert_separated(torch.from_numpy(want), got, other, f"JAX vs the port, {site} in f32")


def test_bf16_tiled_block_is_the_bf16_block():
    """Past 64 atoms the EGNN's blocks run #3/#4's bf16 variants: on the CPU
    their plain versions agree with the whole-block one within the gate."""
    egnn, _, _ = _pair("inv_sublayers_2")
    args = list(map(t, _hidden_inputs(3, 70, (70, 41))))
    with torch.no_grad():
        h_b, x_b = egnn_block.block_forward_plain(egnn.e_block_0, *args, compute_dtype=BF16)
        h_t, x_t = egnn_block.block_forward(egnn.e_block_0, *args, BF16)  # N > 64: tiled
    _close(h_t, h_b, BLOCK_RTOL, "h")
    _close(x_t, x_b, BLOCK_RTOL, "x")


def test_bf16_denoiser_matches_jax_bfloat16():
    kw = dict(nf=64, n_layers=2, latent_nf=2, diffusion_steps=10)
    jcfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **kw)
    pcfg = pfactory.make_latent_diffusion_config(get_dataset_info("qm9"), **kw)
    params = dynamics_init(jax.random.key(6), jcfg.dynamics)
    dyn = EGNNDynamics(pcfg.dynamics)
    load_egnn_from_jax(dyn, params["egnn"], True, prefix="egnn.")
    _, x, _, mask = masked_inputs(7, 3, 8, 1, (3, 8, 6))
    zh = np.random.default_rng(8).standard_normal((3, 8, 2)).astype(np.float32) * mask
    xh = np.concatenate([x, zh], axis=2)
    tt = np.array([[0.1], [0.5], [1.0]], dtype=np.float32)
    mj = jnp.asarray(mask)
    for name in ("bfloat16", "bfloat16_pallas"):
        with torch.no_grad():
            got = dyn(t(tt), t(xh), t(mask), None, pcore.resolve_compute(name).dtype)
        want = dynamics_apply(params, jcfg.dynamics, jnp.asarray(tt), jnp.asarray(xh), mj,
                              build_edge_mask(mj), None, "bfloat16")
        # Two blocks of bf16 products, each within BLOCK_RTOL.
        _close(got, want, 2 * BLOCK_RTOL, name)


@pytest.mark.parametrize("n,n_real", [(9, (5, 9)), (70, (70, 52))])
def test_bf16_egnn_matches_jax_bfloat16_full(n, n_real):
    egnn, jcfg, params = _pair("sin")
    h, x, _, mask = masked_inputs(4, len(n_real), n, 6, n_real)
    with torch.no_grad():
        h_p, x_p = egnn(t(h), t(x), t(mask), pcore.resolve_compute("bfloat16_full").dtype)
    mj = jnp.asarray(mask)
    h_j, x_j = _run_egnn(params, jcfg, jnp.asarray(h), jnp.asarray(x), mj, build_edge_mask(mj),
                         "bfloat16_full")
    _close(h_p, h_j, FULL_RTOL, "h")
    _close(x_p, x_j, FULL_RTOL, "x")


def test_bf16_refuses_autograd_and_sequence_parallelism(monkeypatch):
    """(Named for the refusals it held before bf16 training.) bf16 now runs
    under autograd and under sequence parallelism: the blocks' Functions in
    bf16 give the plain bf16 backward's gradients (the whole-molecule
    one exactly, the row-tiled one within BLOCK_RTOL, its sums in another
    order), and the SP EGNN hands its dtype to the slab path. The kernel
    wrappers, forward and backward, still take no compute name (the
    sampler, the NLL and the train step resolve names): TypeError."""
    from geoldm_tpu_torch.parallel import sp as sp_mod

    egnn, _, _ = _pair("sum")
    h, x, x0, mask = map(t, _hidden_inputs(5, 9, (5, 9)))
    block = egnn.e_block_0
    cots = (t(np.random.default_rng(3).standard_normal(h.shape).astype(np.float32)),
            t(np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)))
    for fn, mod, extra in ((egnn_block.block_forward_cuda, block, ()),
                           (egnn_tiled.gcl_rows_cuda, block.gcl_0, ()),
                           (egnn_tiled.coord_rows_cuda, block.gcl_equiv, ()),
                           (egnn_block.block_backward_cuda, block, cots),
                           (egnn_tiled.gcl_rows_backward_cuda, block.gcl_0, cots[:1]),
                           (egnn_tiled.coord_rows_backward_cuda, block.gcl_equiv, cots[1:])):
        with pytest.raises(TypeError, match="resolve_compute"):
            fn(mod, h, x, x0, mask, *extra, compute_dtype="bfloat16")
    want = egnn_block.block_backward_plain(block, h, x, x0, mask, *cots, compute_dtype=BF16)
    want = [*want[:3], *want[3]]
    for fn, rtol in ((egnn_block.EquivariantBlockFunction, 0.0),
                     (egnn_tiled.TiledEquivariantBlockFunction, BLOCK_RTOL)):
        inputs = [a.clone().requires_grad_() for a in (h, x, x0)]
        ws = egnn_block.block_params(block)
        outs = fn.apply(block, BF16, *inputs[:3], mask, *ws)
        got = torch.autograd.grad(outs, inputs + ws, cots)
        for name, g, w in zip(["dh", "dx", "dx0"] + egnn_block.block_param_names(block), got,
                              want):
            _close(g, w.numpy(), rtol, f"{fn.__name__} {name}")
    seen = []
    monkeypatch.setattr(sp_mod, "egnn_forward_sp",
                        lambda e, h_, x_, m_, grp, dtype: seen.append((grp, dtype)) or (h_, x_))
    egnn.sp = "group"
    egnn(t(np.zeros((1, 9, 6), np.float32)), x[:1], mask[:1], BF16)
    assert seen == [("group", BF16)]


def test_bf16_packed_nll_matches_jax(datadir, pair):  # noqa: F811
    """eval_analyze's NLL in a bf16 compute dtype: the encoder, decoder and
    denoiser through the bf16 plain versions against JAX's evaluate_nll_packed
    with compute dtype 'bfloat16', the same draws. Per-pass means of sums
    of bf16-product models: the gate of the denoiser, 2 * BLOCK_RTOL."""
    from geoldm_tpu.data.qm9 import load_qm9 as jload
    from geoldm_tpu.models.distributions import DistributionNodes as JNodes
    from geoldm_tpu_torch.data.qm9 import load_qm9

    jcfg, pcfg, params, model = pair
    jsplits, _ = jload(datadir)
    psplits, _ = load_qm9(datadir)
    key = jax.random.key(9)
    want = jtrainer.evaluate_nll_packed(params, jcfg, jsplits["valid"],
                                        JNodes(JINFO.n_nodes), key, batch_size=3, n_passes=2,
                                        pad_nodes=29, partition="valid",
                                        compute_dtype="bfloat16")
    steps = -(-len(psplits["valid"]["num_atoms"]) // 3)
    got = ptrainer.evaluate_nll_packed(
        model, pcfg, psplits["valid"], DistributionNodes(get_dataset_info("qm9").n_nodes),
        _pass_feeds(key, 2, steps, 3, 29, False), batch_size=3, pad_nodes=29,
        partition="valid", compute_dtype="bfloat16")
    _close(np.asarray(got), np.asarray(want), 2 * BLOCK_RTOL, "NLL")
