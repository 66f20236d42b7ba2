"""Port parity on CPU for the sequence-parallel (SP) slab kernels: the plain
versions of #6 (forward) and #7 (backward) against the JAX
``pallas_egnn_sp.sp_stage_apply`` / ``_sp_stage_bwd_impl`` in interpret mode,
at the first slab and at later ones (whose diagonal sits at a global row),
'sum', 'mean' over an SP-padded N, and sin features. The CUDA kernels are
held against these plain versions in ``test_torch_port_cuda.py``, which needs
a card; the SP EGNN over gloo ranks is in ``test_torch_port_sp_egnn.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoldm_tpu.config import EGNNConfig as JaxEGNNConfig
from geoldm_tpu.nn.egnn import egnn_init
from geoldm_tpu.ops import pallas_egnn_sp as jsp
from geoldm_tpu.ops import pallas_egnn_tiled as jtiled
from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.nn.egnn import EGNN
from geoldm_tpu_torch.ops import egnn_sp
from tests.torch_port_utils import assert_routes_agree, load_egnn_from_jax, masked_inputs, t

torch.set_num_threads(1)

BASE = dict(in_node_nf=6, out_node_nf=6, hidden_nf=32, n_layers=2, inv_sublayers=1,
            attention=True, tanh=True, coords_range=15.0, norm_constant=1.0,
            sin_embedding=False, normalization_factor=100.0, aggregation_method="sum")
# Two frameworks' f32 op orders: each tensor within RTOL * max(1, max|ref|).
RTOL = 2e-5
VARIANTS = {
    "sum": {},
    "sin": {"sin_embedding": True},
    # The slab columns are padded past the EGNN's 20 atoms: 'mean' divides by 20.
    "mean": {"aggregation_method": "mean", "normalization_factor": 1.0, "tanh": False},
}
N, SLAB = 24, 8  # JAX's slab kernels tile rows in multiples of 8


def _assert_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{name}: max|d|={err:.3e} > {RTOL}*{scale:.3g}"


@functools.lru_cache(maxsize=None)
def _stage_case(variant, seed):
    """(port block, JAX config, JAX block params, full view [2,24,*] as numpy,
    mean_div): molecules of 20 and 17 atoms padded to 24."""
    d = {**BASE, **VARIANTS[variant], "n_layers": 1}
    pcfg, jcfg = EGNNConfig(**d), JaxEGNNConfig(**d)
    params = egnn_init(jax.random.key(seed), jcfg)
    block = load_egnn_from_jax(EGNN(pcfg), params, pcfg.attention).e_block_0
    _, x, x0, mask = masked_inputs(seed, 2, N, 1, (20, 17))
    h = np.random.default_rng(seed + 10).standard_normal((2, N, 32)).astype(np.float32) * mask
    return block, jcfg, jax.tree.map(lambda a: a[0], params["blocks"]), (h, x, x0, mask), 20


def _jax_stage(jcfg, bp, kind):
    if kind == "gcl":
        gw, _ = jtiled._gcl_weight_dict(jcfg, bp["gcls"][0])
        return gw
    return jtiled._coord_weight_dict(bp)


def _slab(full, r0):
    return tuple(a[:, r0:r0 + SLAB] for a in full)


@functools.lru_cache(maxsize=None)
def _jax_stage_fn(variant, seed, kind, backward):
    """The JAX slab stage (interpret mode), jitted once for every r0: (weights,
    full, rows, r0_base[, g]) -> its output, or (dws, d_full, d_rows)."""
    _, jcfg, _, _, mean_div = _stage_case(variant, seed)
    fn = jsp._sp_stage_bwd_impl if backward else jsp.sp_stage_apply
    return jax.jit(functools.partial(fn, jcfg, kind, N, jsp.sp_stage_tiles(SLAB, N, 32), None,
                                     True, mean_div if variant == "mean" else 0))


def _jax_views(full, r0):
    return (tuple(map(jnp.asarray, full)), tuple(map(jnp.asarray, _slab(full, r0))),
            jnp.asarray([r0], dtype=jnp.int32))


@pytest.mark.parametrize("r0", [0, 8, 16])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_sp_stage_matches_jax_sp_stage_apply(variant, r0):
    block, jcfg, bp, full, mean_div = _stage_case(variant, 1)
    for kind, module, fn in (("gcl", block.gcl_0, egnn_sp.sp_gcl_rows_plain),
                             ("coord", block.gcl_equiv, egnn_sp.sp_coord_rows_plain)):
        want = _jax_stage_fn(variant, 1, kind, False)(_jax_stage(jcfg, bp, kind),
                                                      *_jax_views(full, r0))
        got = fn(module, tuple(map(t, full)), tuple(map(t, _slab(full, r0))), r0, mean_div)
        _assert_close(got.detach().numpy(), want, f"{kind} r0={r0}")


@pytest.mark.parametrize("r0", [0, 8, 16])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_sp_stage_backward_matches_jax(variant, r0):
    """Full-view and row-view gradients apart, and the slab's weight
    gradients, against ``_sp_stage_bwd_impl`` (the in-kernel vjp)."""
    block, jcfg, bp, full, mean_div = _stage_case(variant, 2)
    rng = np.random.default_rng(r0)
    for kind, module, fn, feat in (
            ("gcl", block.gcl_0, egnn_sp.sp_gcl_rows_backward_plain, 32),
            ("coord", block.gcl_equiv, egnn_sp.sp_coord_rows_backward_plain, 3)):
        g = rng.standard_normal((2, SLAB, feat)).astype(np.float32)
        dws, d_full, d_rows = _jax_stage_fn(variant, 2, kind, True)(
            _jax_stage(jcfg, bp, kind), *_jax_views(full, r0), jnp.asarray(g))
        got = fn(module, tuple(map(t, full)), tuple(map(t, _slab(full, r0))), r0, mean_div, t(g))
        for name, a, w in zip(("dh", "dx", "dx0", "dh_rows", "dx_rows", "dx0_rows"), got[:6],
                              (*d_full, *d_rows)):
            _assert_close(a.numpy(), w, f"{kind} r0={r0} {name}")
        keys, _, _ = jsp._stage_props(jcfg, kind)
        assert len(got[6]) == len(keys) == len(list(module.parameters()))
        for key, a in zip(keys, got[6]):
            w = np.asarray(dws[key])
            w = w.T if w.ndim == 2 else w  # JAX weights are [in, out]
            _assert_close(a.numpy().reshape(w.shape), w, f"{kind} r0={r0} d{key}")


@pytest.mark.parametrize("r0", [0, 16])
@pytest.mark.parametrize("variant", ["sum", "mean"])
def test_plain_sp_gcl_backward_from_the_forward_chain_matches_its_recompute(variant, r0):
    """The plain #7 on a GCL given the slab's node chain #6 kept (the SP
    Function's CPU route) agrees with the whole-stage autograd within f32
    sum order."""
    block, _, _, full, mean_div = _stage_case(variant, 3)
    full_t, rows_t = tuple(map(t, full)), tuple(map(t, _slab(full, r0)))
    with torch.no_grad():
        h, chain = egnn_sp.sp_gcl_rows_plain(block.gcl_0, full_t, rows_t, r0, mean_div,
                                             keep_chain=True)
        assert torch.equal(h, egnn_sp.sp_gcl_rows_plain(block.gcl_0, full_t, rows_t, r0,
                                                        mean_div))
    g = t(np.random.default_rng(r0 + 5).standard_normal((2, SLAB, 32)).astype(np.float32))
    own = egnn_sp.sp_gcl_rows_backward_plain(block.gcl_0, full_t, rows_t, r0, mean_div, g)
    handed = egnn_sp.sp_gcl_rows_backward_plain(block.gcl_0, full_t, rows_t, r0, mean_div, g,
                                                chain=chain)
    assert_routes_agree([*own[:6], *own[6]], [*handed[:6], *handed[6]])
