"""The fused optimizer step (``ops.fused_optim``: the clip's norm and
threshold, AMSGrad and the EMA in three launches, ``csrc/fused_optim.cu``)
against its plain version (the train step's on the CPU: the clip,
``torch.optim.AdamW.step`` and ``ema_update``) on the card, and the train
step on every training path taking it. Imports no jax, so it runs on a
machine with a card and no JAX:

    python -m pytest tests/test_torch_port_cuda_optim.py -q -m cuda

Skips where torch.cuda is unavailable (the kernels have no CPU mode).

Tolerance: the kernels follow torch's foreach ops element by element, but
the norm adds its squares in another order (in double), so the clip's scale
may differ in its last bit wherever the clip trips, and a moment that
cancels towards 0 then carries that bit as a large share of itself. So
every tensor is held within RTOL of its own largest element, and the norms
within RTOL of themselves."""

import copy

import numpy as np
import pytest
import torch

from geoldm_tpu_torch.ops import fused_optim
from geoldm_tpu_torch.parallel import sharding
from geoldm_tpu_torch.train.optim import AdaptiveGradClip, ema_update
import torch_port_dp_ranks as ranks

pytestmark = pytest.mark.cuda

RTOL = 1e-6
LR, DECAY = 1e-3, 0.999
MOMENTS = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qm9_specs():
    """(shape, gets a gradient, at an odd offset) of the QM9 recipe's 301
    parameters (the encoder's 23 get none: its latent is detached), then
    1-element and odd-length tensors, and views that start 4 bytes past a
    16-byte boundary, some of them crossing chunks with a ragged end."""
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models import factory

    cfg = factory.make_latent_diffusion_config(get_dataset_info("qm9"), trainable_ae=True)
    model = factory.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    specs = [(tuple(p.shape), not n.startswith("vae.encoder."), False)
             for n, p in model.named_parameters()]
    assert len(specs) == 301 and sum(g for _, g, _ in specs) == 278
    specs += [((1,), True, False), ((7,), True, False), ((4099,), True, False),
              ((1,), True, True), ((13, 5), True, True), ((8195,), True, True),
              ((3, 4097), False, True), ((5,), False, False)]
    return specs


class _Tail:
    """A parameter list with its AdamW (amsgrad), clip and EMA, built from
    ``seed`` alike for every run; ``fused`` steps it with the kernels."""

    def __init__(self, specs, card, seed=0, fused=False):
        gen = torch.Generator().manual_seed(seed)
        self.specs, self.card = specs, card
        self.params, self.ema = [], []
        for shape, _, odd in specs:
            w = torch.randn(shape, generator=gen) * 0.05
            self.params.append(torch.nn.Parameter(self._place(w, odd)))
            self.ema.append(self._place(w, odd))
        self.stepped = list(self.params)  # the encoder's too: AdamW skips a missing gradient
        self.optimizer = torch.optim.AdamW(self.stepped, lr=LR, weight_decay=1e-12,
                                           amsgrad=True)
        self.clip = AdaptiveGradClip(card)
        self.fused = None
        if fused:
            self.fused = fused_optim.FusedStep(self.optimizer, [False] * len(self.stepped),
                                               self.ema, self.params, DECAY, self.clip)

    def _place(self, t, odd):
        if not odd:
            return t.to(self.card).contiguous()
        base = torch.zeros(t.numel() + 1, device=self.card)
        base[1:] = t.reshape(-1).to(self.card)
        return base[1:].view(t.shape)

    def grads(self, step, sigma):
        """Seeded gradients of step ``step``, None where a spec gets none."""
        for k, (p, (shape, grad, odd)) in enumerate(zip(self.params, self.specs)):
            if not grad:
                p.grad = None
                continue
            gen = torch.Generator(device=self.card).manual_seed(1000 * step + k)
            g = torch.empty(shape, device=self.card).normal_(generator=gen) * sigma
            p.grad = self._place(g, odd)

    def step(self):
        if self.fused is not None:
            norm = self.fused.clip_norm()
            self.fused.update()
            return norm
        norm = self.clip([p.grad for p in self.params if p.grad is not None])
        self.optimizer.step()
        ema_update(self.ema, self.params, DECAY)
        return norm

    def tensors(self):
        out = {f"param {i}": p.detach() for i, p in enumerate(self.params)}
        out.update({f"ema {i}": e for i, e in enumerate(self.ema)})
        for i, p in enumerate(self.params):
            st = self.optimizer.state.get(p, {})
            out.update({f"{k} {i}": st[k] for k in MOMENTS if k in st})
        return out


def _run(tail, steps, spike=10, sigma=1e-3):
    """``steps`` steps; at ``spike`` the gradients are 1e4 times larger,
    so the clip trips. -> the norms."""
    norms = []
    for s in range(steps):
        tail.grads(s, sigma * (1e4 if s == spike else 1.0))
        norms.append(tail.step())
    return torch.stack(norms).cpu()


def _assert_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        err = float((g - w).abs().max())
        assert err <= RTOL * float(w.abs().max()), f"{name}: max|d|={err:.3e}"


def test_fused_step_matches_plain_at_the_qm9_recipe(card):
    """20 steps over the QM9 recipe's parameter list (and odd tensors and
    views) with a spike that trips the clip: parameters, the three moments,
    the EMA of every tensor (the encoder's, without a gradient, too), each
    step's norm and the ring buffer as the plain version's; no moment for a
    tensor without a gradient; the clip's counters and every step alike."""
    specs = _qm9_specs()
    plain, fused = _Tail(specs, card), _Tail(specs, card, fused=True)
    n_plain, n_fused = _run(plain, 20), _run(fused, 20)
    torch.testing.assert_close(n_fused, n_plain, rtol=RTOL, atol=0)
    assert float(n_plain[10]) > 1e3 * float(n_plain[9])
    torch.testing.assert_close(fused.clip.norms.cpu(), plain.clip.norms.cpu(), rtol=RTOL, atol=0)
    assert float(plain.clip.norms[11]) < float(n_plain[10]) / 10  # the spike was clipped
    assert (fused.clip.count, fused.clip.head) == (plain.clip.count, plain.clip.head) == (21, 21)
    _assert_close(fused.tensors(), plain.tensors())
    for (shape, grad, _), p, q in zip(specs, plain.params, fused.params):
        st_p, st_f = plain.optimizer.state.get(p, {}), fused.optimizer.state.get(q, {})
        assert set(st_f) == set(st_p) == (set(MOMENTS) | {"step"} if grad else set())
        if grad:
            assert float(st_f["step"]) == float(st_p["step"]) == 20.0


def test_fused_step_replays_bit_for_bit(card):
    """Two runs of the kernels from the same state and gradients give the
    same bits (the norm's partials are added in a fixed order)."""
    specs = _qm9_specs()
    runs = [_Tail(specs, card, fused=True) for _ in range(2)]
    norms = [_run(t, 12) for t in runs]
    assert torch.equal(norms[0], norms[1])
    assert torch.equal(runs[0].clip.norms, runs[1].clip.norms)
    a, b = runs[0].tensors(), runs[1].tensors()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_fused_step_is_three_launches(card):
    """A step after the first (which allocates the moments and builds the
    tables) is exactly three device kernels, and one of each counter."""
    specs = _qm9_specs()
    tail = _Tail(specs, card, fused=True)
    _run(tail, 2)
    before = fused_optim.launches()
    tail.grads(2, 1e-3)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        tail.step()
        torch.cuda.synchronize()
    after = fused_optim.launches()
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    kernels = [ev.name() for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == torch.autograd.DeviceType.CUDA
               and not ev.is_user_annotation() and ev.duration_ns() > 0]
    assert len(kernels) == 3, kernels


def test_fused_step_refuses_what_it_cannot_take(card):
    """float64, bfloat16, non-contiguous or host tensors, tensors on two
    devices, and a non-contiguous gradient raise."""
    def make(params, ema=None, sources=None):
        opt = torch.optim.AdamW(params, lr=LR, amsgrad=True)
        return fused_optim.FusedStep(opt, [False] * len(params), ema or [], sources or [],
                                     DECAY if ema else 0.0)

    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeError, match="float32"):
            make([torch.nn.Parameter(torch.zeros(8, device=card, dtype=dtype))])
    with pytest.raises(ValueError, match="contiguous"):
        make([torch.nn.Parameter(torch.zeros(6, 4, device=card).t())])
    with pytest.raises(ValueError, match="CUDA tensors"):
        make([torch.nn.Parameter(torch.zeros(8))])
    p = torch.nn.Parameter(torch.zeros(8, device=card))
    with pytest.raises(ValueError, match="is on cpu"):
        make([p, torch.nn.Parameter(torch.zeros(8))])
    with pytest.raises(ValueError, match="is on cpu"):
        make([p], [torch.zeros(8)], [p])
    with pytest.raises(ValueError, match="AdamW"):
        fused_optim.FusedStep(torch.optim.AdamW([p], amsgrad=False), [False])
    q = torch.nn.Parameter(torch.zeros(4, 6, device=card))
    step = make([q])
    q.grad = torch.ones(6, 4, device=card).t()
    with pytest.raises(ValueError, match="contiguous"):
        step.clip_norm()


def test_fused_step_splits_past_448_tensors(card):
    """1000 stepped tensors (more than twice a launch's 448 gradient
    pointers) and 100 without a gradient take three norm and three update
    launches a step, and still match the plain version, the clip tripping
    at the spike."""
    specs = [((1 + (k * 37) % 300,), k % 11 != 3, k % 5 == 1) for k in range(1100)]
    plain, fused = _Tail(specs, card), _Tail(specs, card, fused=True)
    n_plain = _run(plain, 6, spike=4)
    before = fused_optim.launches()
    n_fused = _run(fused, 6, spike=4)
    assert [a - b for a, b in zip(fused_optim.launches(), before)] == [18, 6, 18]
    torch.testing.assert_close(n_fused, n_plain, rtol=RTOL, atol=0)
    torch.testing.assert_close(fused.clip.norms.cpu(), plain.clip.norms.cpu(), rtol=RTOL, atol=0)
    assert float(plain.clip.norms[5]) < float(n_plain[4]) / 1.1  # the spike was clipped
    _assert_close(fused.tensors(), plain.tensors())


def test_fused_step_refuses_parameters_at_different_steps(card):
    """AdamW states at two step counts (the launches share one step's bias
    corrections) raise at the first fused step."""
    specs = [((8,), True, False), ((5,), True, False)]
    src = _Tail(specs, card)
    _run(src, 2, spike=-1)
    state = src.optimizer.state_dict()
    state["state"][1]["step"] = torch.tensor(1.0)
    tail = _Tail(specs, card, fused=True)
    tail.optimizer.load_state_dict(state)
    tail.fused = fused_optim.FusedStep(tail.optimizer, [False, False], tail.ema, tail.params,
                                       DECAY, tail.clip)
    tail.grads(2, 1e-3)
    with pytest.raises(ValueError, match=r"at steps \[1.0, 2.0\], not one"):
        tail.fused.clip_norm()


@pytest.mark.parametrize("first", ["plain", "fused"])
def test_state_crosses_between_plain_and_fused(card, first):
    """An AdamW, clip and EMA state written after 5 steps of one version
    loads into the other, and the 6th step of both matches within RTOL;
    the optimizer's state dict has the same keys, shapes and steps either
    way."""
    specs = _qm9_specs()
    src = _Tail(specs, card, fused=first == "fused")
    _run(src, 5, spike=3)
    dst = _Tail(specs, card, seed=1, fused=first == "plain")
    with torch.no_grad():
        for a, b in zip(dst.params + dst.ema, src.params + src.ema):
            a.copy_(b)
    # A checkpoint's copy (torch.load_state_dict keeps the step tensors it is given).
    dst.optimizer.load_state_dict(copy.deepcopy(src.optimizer.state_dict()))
    dst.clip.load_state_dict(src.clip.state_dict())
    if dst.fused is not None:  # the train step rebuilds it after a load
        dst.fused = fused_optim.FusedStep(dst.optimizer, [False] * len(dst.stepped), dst.ema,
                                          dst.params, DECAY, dst.clip)
    for t in (src, dst):
        t.grads(5, 1e-3)
    n_src, n_dst = src.step(), dst.step()
    torch.testing.assert_close(n_dst.cpu(), n_src.cpu(), rtol=RTOL, atol=0)
    _assert_close(dst.tensors(), src.tensors())
    sd_src, sd_dst = src.optimizer.state_dict(), dst.optimizer.state_dict()
    assert sd_src["param_groups"] == sd_dst["param_groups"]
    assert sorted(sd_src["state"]) == sorted(sd_dst["state"])
    for i, e in sd_src["state"].items():
        f = sd_dst["state"][i]
        assert set(e) == set(f) == set(MOMENTS) | {"step"}
        assert all(e[k].shape == f[k].shape and e[k].dtype == f[k].dtype for k in e)
        assert float(e["step"]) == float(f["step"]) == 6.0


# ---------------------------------------------------------------------------
# The train step: every path on the card takes the fused step
# ---------------------------------------------------------------------------


def _model(card, kind):
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models import factory

    info = get_dataset_info(kind)
    kw = dict(latent_nf=2, include_charges=False) if kind == "geom" else {}
    cfg = factory.make_latent_diffusion_config(info, nf=32, n_layers=2, diffusion_steps=20,
                                               trainable_ae=True, **kw)
    return info, cfg, factory.build_model(cfg, card, torch.Generator().manual_seed(1))


@pytest.mark.parametrize("kind,pad,compute_dtype", [("qm9", 29, None), ("qm9", 29, "bfloat16"),
                                                     ("geom", 80, None)])
def test_train_step_takes_the_fused_step(card, kind, pad, compute_dtype):
    """Three train steps (QM9 f32 and bf16 at pad 29, GEOM at pad 80 through
    the row-tiled kernels): one launch of each fused kernel a step; under a
    profiler the counter ``train.fused_optimizer`` equals the ``train.step``
    spans and no ``train.ema`` span opens; the encoder gets no moment and
    stays put, the EMA moves."""
    from geoldm_tpu_torch.data.synthetic import synthetic_batch
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step
    from geoldm_tpu_torch.train.trainer import prepare_batch
    from geoldm_tpu_torch.utils import spans

    info, cfg, model = _model(card, kind)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, cfg, 1e-3, ema_decay=0.99)
    step = make_train_step(cfg, 0.99, compute_dtype)
    nodes = DistributionNodes(info.n_nodes)
    sizes = [pad, pad - 3, pad - 9]
    before = fused_optim.launches()
    spans.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for s in range(3):
            raw = synthetic_batch(info, 3, pad, np.random.default_rng(s),
                                  include_charges=kind == "qm9", n_atoms=sizes)
            noise = torch.Generator(device=card).manual_seed(s)
            step(state, prepare_batch(raw, nodes, card), noise)
        torch.cuda.synchronize()
    after = fused_optim.launches()
    assert [a - b for a, b in zip(after, before)] == [3, 3, 3]
    names = [r[0] for r in spans.records()]
    assert spans.counters().get("train.fused_optimizer") == names.count("train.step") == 3
    assert "train.ema" not in names and names.count("train.optimizer") == 3
    spans.clear()
    for name, p in model.named_parameters():
        encoder = name.startswith("vae.encoder.")
        assert (p.grad is None) == encoder, name
        assert bool(state.optimizer.state.get(p)) != encoder, name
        assert torch.equal(p.detach(), start[name]) == encoder, name
    ema = dict(state.ema_model.named_parameters())
    assert any(not torch.equal(ema[n].detach(), start[n]) for n in start if "dynamics" in n)


def _one_rank_on_the_card(args, tmp_path):
    """``ranks.train_step`` as one rank on the card (a one-rank gloo group
    in this process, so its gathers over the world run)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        before = fused_optim.update_launches
        out = ranks.train_step(*args, sharding.Grid(0, torch.device("cuda")))
        assert fused_optim.update_launches == before + 1
        return out
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dp,sp,tp", [(1, 1, 2), (2, 1, 1), (1, 2, 1)])
def test_parallel_train_steps_take_the_fused_step(card, tmp_path, dp, sp, tp):
    """TP-2, DP-2 and SP-2 with every rank on the card (gloo) against one
    rank on the card, every rank through the fused step (one launch of each
    kernel): the loss, the gradient norm (one rank's: nothing summed over the
    model ranks), the weights' move within 3e-2 * lr, the gathered moments
    and EMA within 1e-3 * max|ref| (the tolerances of PR 17's TP tests), and
    the gathered states alike on every rank."""
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.data.synthetic import synthetic_batch
    from geoldm_tpu_torch.models.distributions import DistributionNodes
    from geoldm_tpu_torch.train import trainer

    info = get_dataset_info("qm9")
    spec = {"dataset": "qm9", "kw": dict(nf=32, n_layers=2, latent_nf=2, diffusion_steps=20,
                                         trainable_ae=True), "seed": 3}
    raw = synthetic_batch(info, 8, 9, np.random.default_rng(5))
    batch = trainer.prepare_host(raw, DistributionNodes(info.n_nodes))
    args = (spec, batch, ("seed", 4), {})
    want = _one_rank_on_the_card(args, tmp_path)
    got = sharding.spawn(dp, sp, ranks.train_step, args, device="cuda", tp=tp)
    assert got["fused_launches"] == [[1, 1, 1]] * (dp * sp * tp)
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-5 * want["grad_norm"]
    for name, p in want["params"].items():
        np.testing.assert_allclose(got["params"][name], p, atol=3e-2 * 1e-3, err_msg=name)
    for name, e in want["ema"].items():
        assert np.abs(got["ema"][name] - e).max() <= 1e-3 * np.abs(e).max(), name
    assert len(got["moments"]) == len(want["moments"])
    for g, w in zip(got["moments"], want["moments"]):
        assert set(g) == set(w) == set(MOMENTS)
        for k in MOMENTS:
            assert np.abs(g[k] - w[k]).max() <= 1e-3 * np.abs(w[k]).max(), k
    assert len(set(got["digests"])) == 1
