"""The low-precision edge chain (``GEOLDM_PALLAS_EDGE_LOWP=1`` under
``bfloat16_pallas``) on the CPU, against the JAX package: the plain version
of kernels #1/#2's low-precision variants (``nn.core.BF16_EDGE_LOWP``, the
modules' forward and autograd through it) against JAX's Pallas kernels with
the switch on (``fused_block_apply``, interpret mode), where the switch
applies and where it changes nothing, the port's copy of JAX's routing, and
one ``bfloat16_pallas`` train step against JAX's.

JAX reads the switch when it traces, so each JAX call here sets the
variable and clears JAX's caches before and after.

Two readings of JAX. XLA on the CPU does not round where ``_block_math``
says: inside a fusion it keeps the f32 value across a bf16 convert (excess
precision), so the jitted kernel (interpret mode runs under jit) lands about
as far from ``_block_math`` op by op as from JAX without the switch (mean
3.2e-4 against 3.5e-4 on the forward here). And the transpose of a
broadcast (the gradients of the bf16 biases b2 and ba, and of the gate)
reduces in bf16 there. The source's reading is ``_block_math`` evaluated
op by op (``jax.disable_jit``) and its ``jax.vjp`` with those reductions
accumulated in f32 (``_f32_bf16_reductions``), as torch's and the kernels'
are. Against the kernel in interpret mode the port is held within
LOWP_RTOL * max(1, max|ref|) (the bf16 gate of test_torch_port_bf16.py's
EGNN; readings up to 7e-3, b2's gradient); against the source's reading it is LOWP_SEPARATION times closer on
the mean to JAX with the switch than without (readings: forward 7.5e-10 vs
3.5e-4, backward 2.3e-10 vs 2.0e-4 in units of each tensor's scale)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lax import lax as jax_lax

from geoldm_tpu.config import EGNNConfig as JaxEGNNConfig
from geoldm_tpu.config import TrainConfig
from geoldm_tpu.data.datasets_config import get_dataset_info as jax_info
from geoldm_tpu.models import factory as jfactory
from geoldm_tpu.nn.egnn import egnn_init
from geoldm_tpu.ops import pallas_egnn as jpe
from geoldm_tpu.ops.distance import build_edge_mask
from geoldm_tpu.train import train_step as jts
from geoldm_tpu_torch.config import EGNNConfig
from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.models import factory as pfactory
from geoldm_tpu_torch.nn import core as pcore
from geoldm_tpu_torch.nn.core import BF16_EDGE_LOWP
from geoldm_tpu_torch.nn.egnn import EGNN, GNN
from geoldm_tpu_torch.ops import egnn_block
from geoldm_tpu_torch.train import train_step as pts
from geoldm_tpu_torch.utils.convert import state_dict_from_jax_params
from tests.torch_port_utils import (Feed, block_grads_by_name, jax_ldm_draws, load_egnn_from_jax,
                                    masked_inputs, t)

torch.set_num_threads(1)

ENV = "GEOLDM_PALLAS_EDGE_LOWP"
BF16 = torch.bfloat16
LOWP_RTOL = 5e-2
LOWP_SEPARATION = 1000.0
H = 32
CFG = dict(in_node_nf=6, out_node_nf=6, hidden_nf=H, n_layers=1, inv_sublayers=2,
           attention=True, tanh=True, coords_range=15.0, norm_constant=1.0,
           sin_embedding=False, normalization_factor=1.0, aggregation_method="sum")


@contextlib.contextmanager
def _switch(monkeypatch, on: bool):
    """JAX's switch set (or cleared) for a trace of its own."""
    jax.clear_caches()
    with monkeypatch.context() as m:
        m.setenv(ENV, "1" if on else "0")
        yield
    jax.clear_caches()


@contextlib.contextmanager
def _f32_bf16_reductions(monkeypatch):
    """JAX's broadcast transpose reducing bf16 values in f32 and rounding
    once (XLA on the CPU accumulates them in bf16)."""
    orig = jax_lax.reduce_sum

    def reduce_sum(operand, axes):
        if operand.dtype == jnp.bfloat16:
            return orig(operand.astype(jnp.float32), axes).astype(jnp.bfloat16)
        return orig(operand, axes)

    with monkeypatch.context() as m:
        m.setattr(jax_lax, "reduce_sum", reduce_sum)
        yield


def _block(seed=0):
    pcfg, jcfg = EGNNConfig(**CFG), JaxEGNNConfig(**CFG)
    params = egnn_init(jax.random.key(seed), jcfg)
    egnn = load_egnn_from_jax(EGNN(pcfg), params, True)
    return egnn.e_block_0, jcfg, jax.tree.map(lambda a: a[0], params["blocks"])


def _arrays(n, seed=1):
    n_real = (n - 3, n)
    _, x, x0, mask = masked_inputs(seed, 2, n, 1, n_real)
    rng = np.random.default_rng(seed + 10)
    h = rng.standard_normal((2, n, H)).astype(np.float32) * mask
    gh = rng.standard_normal((2, n, H)).astype(np.float32) * mask
    gx = rng.standard_normal((2, n, 3)).astype(np.float32) * mask
    return (h, x, x0, mask), (gh, gx)


def _port(block, arrays, cots, dtype):
    ins = [t(a) for a in arrays]
    with torch.no_grad():
        out = egnn_block.block_forward_plain(block, *ins, compute_dtype=dtype)
    dh, dx, dx0, dws = egnn_block.block_backward_plain(block, *ins, *map(t, cots),
                                                       compute_dtype=dtype)
    return [o.numpy() for o in out], [a.numpy() for a in (dh, dx, dx0, *dws)]


def _jax_flat(block, grads, n_gcl):
    """(dh, dx, dx0, weight gradients in the port's order) from a vjp's
    (flat weight list or block pytree, dh, dx, dx0)."""
    dws = grads[0]
    if isinstance(dws, (list, tuple)):
        dws = jpe._unflatten_block_grads(list(dws), n_gcl, True)
    named = block_grads_by_name(dws, True)
    names = egnn_block.block_param_names(block)
    return [np.asarray(g) for g in grads[1:4]] + [np.asarray(named[k]) for k in names]


def _jax_kernel(jcfg, bp, arrays, cots):
    """JAX's #1 and its #2 (fused_block_apply's vjp), interpret mode, bf16."""
    h, x, x0, mask = map(jnp.asarray, arrays)
    out, vjp = jax.vjp(lambda p, h_, x_, x0_: jpe.fused_block_apply(
        jcfg, p, h_, x_, x0_, mask, jnp.bfloat16, True), bp, h, x, x0)
    return [np.asarray(o) for o in out], vjp(tuple(map(jnp.asarray, cots)))


def _jax_source(jcfg, bp, arrays, cots):
    """``_block_math`` op by op and its vjp (the whole batch one group)."""
    h, x, x0, mask = map(jnp.asarray, arrays)
    ws = jpe._block_weight_list(bp, True)
    n, b = h.shape[1], h.shape[0]
    with jax.disable_jit():
        out, vjp = jax.vjp(lambda w, h_, x_, x0_: jpe._block_math(
            jcfg, n, b, jnp.bfloat16, list(w), h_, x_, x0_, mask), ws, h, x, x0)
        grads = vjp(tuple(map(jnp.asarray, cots)))
    return [np.asarray(o) for o in out], grads


def _mean_rel(got, want):
    """Mean over every element of |d| in units of its tensor's max(1, max|ref|)."""
    tot = count = 0.0
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64).reshape(np.shape(g))
        tot += np.abs(np.asarray(g, np.float64) - w).sum() / max(1.0, np.abs(w).max())
        count += w.size
    return tot / count


def _assert_close(got, want, what, rtol=LOWP_RTOL):
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).reshape(np.shape(g))
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, f"{what} tensor {k}: max|d| {err:.3e} > {rtol}*{scale:.3g}"


@pytest.mark.parametrize("n", [8, 13])
def test_plain_lowp_block_matches_jax_with_the_switch(n, monkeypatch):
    """The plain low-precision forward and backward (dh, dx, dx0, every
    weight gradient) against JAX's #1/#2 with the switch on (interpret mode),
    within LOWP_RTOL; and LOWP_SEPARATION times closer to the source's
    reading with the switch than without, on the forward and the backward
    alike."""
    block, jcfg, bp = _block()
    arrays, cots = _arrays(n)
    out, grads = _port(block, arrays, cots, BF16_EDGE_LOWP)
    with _switch(monkeypatch, True):
        k_out, k_grads = _jax_kernel(jcfg, bp, arrays, cots)
    _assert_close(out, k_out, "forward vs the kernel")
    _assert_close(grads, _jax_flat(block, k_grads, 2), "backward vs the kernel")
    reading = {}
    for on in (True, False):
        with _switch(monkeypatch, on), _f32_bf16_reductions(monkeypatch):
            s_out, s_grads = _jax_source(jcfg, bp, arrays, cots)
        reading[on] = s_out, _jax_flat(block, s_grads, 2)
    for what, k in (("forward", 0), ("backward", 1)):
        mine = out if k == 0 else grads
        err, dist = _mean_rel(mine, reading[True][k]), _mean_rel(mine, reading[False][k])
        assert LOWP_SEPARATION * err <= dist, (
            f"{what}: mean {err:.3e} to _block_math with the switch, {dist:.3e} without: not "
            f"{LOWP_SEPARATION:g}x apart")


def _egnn_out(egnn, name_or_dtype, n, seed=3):
    _, x, _, mask = masked_inputs(seed, 2, n, 1, (n - 2, n))
    h = np.random.default_rng(seed).standard_normal((2, n, 6)).astype(np.float32) * mask
    dtype = pcore.resolve_compute(name_or_dtype).operand
    with torch.no_grad():
        return [o.numpy() for o in egnn(t(h), t(x), t(mask), dtype)]


@pytest.mark.parametrize("case", ["bfloat16", "bfloat16_full", "bfloat16_mixed", "float32",
                                  "tiled_44", "tiled_64", "tiled_96", "sp", "gnn"])
def test_switch_changes_nothing_elsewhere(case, monkeypatch):
    """With the variable set, the compute names of JAX's XLA backend and f32,
    sizes JAX routes to its row-tiled kernels, the sequence-parallel route
    and the GNN compute as without it, bit for bit; ``bfloat16_pallas`` at a
    whole molecule does not."""
    egnn = EGNN(EGNNConfig(**{**CFG, "n_layers": 2}))
    if case.startswith("tiled_"):
        n = int(case.split("_")[1])
        assert egnn_block.block_operand(n, H, BF16_EDGE_LOWP) is BF16
        block = egnn.e_block_0
        arrays, _ = _arrays(n, seed=4)
        ins = [t(a) for a in arrays]
        with torch.no_grad():
            got = egnn_block.block_forward(block, *ins, BF16_EDGE_LOWP)
            want = egnn_block.block_forward(block, *ins, BF16)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        return
    if case == "sp":
        from geoldm_tpu_torch.parallel import sp

        seen = []
        monkeypatch.setattr(sp, "egnn_forward_sp",
                            lambda egnn_, h, x, mask, grp, dt: seen.append(dt) or (h, x))
        egnn.sp = object()
        monkeypatch.setenv(ENV, "1")
        egnn(torch.zeros(1, 4, 6), torch.zeros(1, 4, 3), torch.ones(1, 4, 1),
             pcore.resolve_compute("bfloat16_pallas").operand)
        assert seen == [BF16]
        return
    if case == "gnn":
        gnn = GNN(EGNNConfig(**{**CFG, "in_node_nf": 9, "out_node_nf": 9}))
        h = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 7, 9)).astype(
            np.float32))
        mask = torch.ones(2, 7, 1)
        with torch.no_grad():
            assert torch.equal(gnn(h, mask, BF16_EDGE_LOWP), gnn(h, mask, BF16))
        return
    monkeypatch.setenv(ENV, "1")
    assert not pcore.resolve_compute(case).edge_lowp
    got = _egnn_out(egnn, case, 9)
    monkeypatch.setenv(ENV, "0")
    want = _egnn_out(egnn, case, 9)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    monkeypatch.setenv(ENV, "1")
    lowp = _egnn_out(egnn, "bfloat16_pallas", 9)
    assert not all(np.array_equal(g, w) for g, w in zip(lowp, _egnn_out(egnn, BF16, 9)))


@pytest.mark.parametrize("on", [True, False])
@pytest.mark.parametrize("hidden", [32, 192, 256])
def test_routing_copy_matches_jax(hidden, on, monkeypatch):
    """``egnn_block.dispatch_to_tiled`` against JAX's for n = 1 ... 184 at the
    default bwd_mode, with the switch on and off, in bf16 and f32; and where
    the chain applies: n <= 40, 48 and 56 at these widths."""
    monkeypatch.setenv(ENV, "1" if on else "0")
    operand = BF16_EDGE_LOWP if on else BF16
    for n in range(1, 185):
        assert egnn_block.dispatch_to_tiled(n, hidden, operand) == \
            jpe.dispatch_to_tiled(n, hidden, jnp.bfloat16), (n, hidden, on)
        assert egnn_block.dispatch_to_tiled(n, hidden, None) == \
            jpe.dispatch_to_tiled(n, hidden, None), (n, hidden, on)
    whole = [n for n in range(1, 185) if egnn_block.whole_molecule(n, hidden)]
    assert whole == list(range(1, 41)) + [48, 56]


def test_compute_names_carry_the_switch(monkeypatch):
    """``bfloat16_pallas`` takes the chain with the variable "1" and only
    then, as JAX's ``_edge_lowp_enabled``; the spec's operand says so."""
    for value, want in (("1", True), ("0", False), ("true", False), (None, False)):
        if value is None:
            monkeypatch.delenv(ENV, raising=False)
        else:
            monkeypatch.setenv(ENV, value)
        spec = pcore.resolve_compute("bfloat16_pallas")
        assert spec.edge_lowp is want and spec.dtype is BF16
        assert spec.operand is (BF16_EDGE_LOWP if want else BF16)
        assert jpe._edge_lowp_enabled() is want
    assert pcore.resolve_compute(BF16_EDGE_LOWP).operand is BF16_EDGE_LOWP
    assert pcore.operand_dtype(BF16_EDGE_LOWP) is BF16


KW = dict(nf=16, n_layers=1, latent_nf=2, diffusion_steps=6, trainable_ae=True)
B, N, N_REAL = 2, 8, (5, 8)
# The step against JAX's with the switch (jitted: XLA's excess precision
# inside its fusions, module docstring): the loss within STEP_LOSS_RTOL
# (reading 8.3e-7), each gradient within STEP_RTOL * max(1, max|ref|)
# (reading 9.8e-4, a bf16 step of the output embedding's weight gradient).
STEP_LOSS_RTOL, STEP_RTOL = 1e-5, 5e-3


def test_lowp_train_step_matches_jax(monkeypatch):
    """One ``bfloat16_pallas`` train step of a tiny LDM (nf 16, 1 layer, T=6)
    with the switch on: the port's ``make_train_step`` against JAX's (its
    Pallas kernels in interpret mode) from the same weights and draws, the
    loss and every gradient; and the port's step is not its bf16 step."""
    import functools

    jcfg = jfactory.make_latent_diffusion_config(jax_info("qm9"), **KW)
    pcfg = pfactory.make_latent_diffusion_config(get_dataset_info("qm9"), **KW)
    tc = TrainConfig(lr=1e-3, ema_decay=0.9)
    jstate, tx = jts.create_train_state(jax.random.key(11), jcfg, tc)
    _, x, _, mask = masked_inputs(21, B, N, 1, N_REAL)
    types = np.random.default_rng(121).integers(0, 5, (B, N))
    h_cat = np.eye(5, dtype=np.float32)[types] * mask
    h_int = np.array([1, 6, 7, 8, 9], dtype=np.float32)[types][..., None] * mask
    log_pn = np.full(B, -2.0, dtype=np.float32)
    mj = jnp.asarray(mask)
    jbatch = {"x": jnp.asarray(x), "h_cat": jnp.asarray(h_cat), "h_int": jnp.asarray(h_int),
              "node_mask": mj, "edge_mask": build_edge_mask(mj), "log_pN": jnp.asarray(log_pn)}
    key = jax.random.key(12)
    monkeypatch.setattr(jpe, "egnn_apply_pallas",
                        functools.partial(jpe.egnn_apply_pallas, interpret=True))
    with _switch(monkeypatch, True):
        nll = jfactory.model_nll_fn(jcfg, training=True, compute_dtype="bfloat16_pallas")
        jloss, jgrads = jax.value_and_grad(lambda p: jnp.mean(nll(
            p, key, jbatch["x"], jbatch["h_cat"], jbatch["h_int"], mj, jbatch["edge_mask"],
            None) - jbatch["log_pN"]))(jstate.params)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads), pcfg)

    steps = {}
    for value in ("1", "0"):
        monkeypatch.setenv(ENV, value)
        model = pfactory.build_model(pcfg, "cpu")
        model.load_state_dict(state_dict_from_jax_params(
            jax.tree.map(np.asarray, jstate.params), pcfg), strict=True)
        state = pts.create_train_state(model, pcfg, tc.lr, ema_decay=tc.ema_decay)
        pm = pts.make_train_step(pcfg, tc.ema_decay, "bfloat16_pallas")(
            state, {"x": t(x), "h_cat": t(h_cat), "h_int": t(h_int), "node_mask": t(mask),
                    "log_pN": t(log_pn)},
            Feed(jax_ldm_draws(key, B, N, 2, KW["diffusion_steps"], False)))
        steps[value] = pm, {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    pm, grads = steps["1"]
    np.testing.assert_allclose(float(pm["loss"]), float(jloss), rtol=STEP_LOSS_RTOL)
    assert grads and set(grads) <= set(want)
    _assert_close([g.numpy() for g in grads.values()], [want[k] for k in grads], "step",
                  STEP_RTOL)
    assert any(not torch.equal(g, steps["0"][1][k]) for k, g in grads.items())
