"""The port's spans and counters (``geoldm_tpu_torch.utils.spans``): nothing
without a profiler, names, ids, parents and counters under one, and where the
training loop, the train step and the sampler put them. The program's
results are the same with and without a profiler."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.data.qm9 import QM9Loader, load_qm9
from geoldm_tpu_torch.data.synthetic import write_qm9_splits
from geoldm_tpu_torch.models import factory
from geoldm_tpu_torch.models.distributions import DistributionNodes
from geoldm_tpu_torch.parallel import sp
from geoldm_tpu_torch.train import sampling, trainer
from geoldm_tpu_torch.train.train_step import create_train_state, make_train_step
from geoldm_tpu_torch.utils import spans

INFO = get_dataset_info("qm9")
STEP_CHILDREN = ["train.zero_grad", "train.forward", "train.backward", "train.clip",
                 "train.optimizer", "train.ema"]


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def cleared():
    spans.clear()
    yield
    spans.clear()


class Clock:
    """A stand-in for the ``time`` module the spans read, set by hand."""

    def __init__(self):
        self.now = 0

    def perf_counter_ns(self):
        return self.now


def test_without_a_profiler_nothing_is_recorded():
    assert spans.span("a", 1) is spans.NULL and spans.span("b") is spans.NULL
    with spans.span("a", 1) as s:
        spans.count("c", 3)
    assert s is spans.NULL
    assert spans.records() == [] and spans.counters() == {} and spans.dropped() == 0


def test_under_a_profiler_names_ids_parents_and_counters_are_recorded(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(spans, "time", clock)
    with _profiler() as prof:
        with spans.span("outer", 7):
            clock.now = 10
            with spans.span("inner", 7):
                clock.now = 25
            spans.count("c", 2)
            spans.count("c", 3)
            clock.now = 40
        with spans.span("next"):
            clock.now = 41
    assert spans.records() == [("inner", 7, "outer", 10, 25), ("outer", 7, None, 0, 40),
                               ("next", None, None, 40, 41)]
    assert spans.counters() == {"c": 5}
    names = {e.name for e in prof.events()}
    assert {"geoldm.outer", "geoldm.inner", "geoldm.next"} <= names
    spans.clear()
    assert spans.records() == [] and spans.counters() == {}


def test_the_span_list_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 2)
    with _profiler():
        for k in range(5):
            with spans.span("s", k):
                pass
    assert [r[1] for r in spans.records()] == [0, 1] and spans.dropped() == 3


def test_threads_keep_their_own_parents_and_lose_no_count():
    """More threads than cores, a short switch interval: every count and
    span kept, each thread's spans parented on its own stack."""
    threads, rounds = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiler():
            def work(t):
                for _ in range(rounds):
                    with spans.span("outer", t):
                        with spans.span("inner", t):
                            spans.count("n", 1)

            pool = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(switch)
    recs = spans.records()
    assert spans.counters() == {"n": threads * rounds}
    assert len(recs) == 2 * threads * rounds
    assert all(p == ("outer" if n == "inner" else None) for n, _, p, _, _ in recs)


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("qm9_spans"))
    write_qm9_splits(path, INFO, {"train": 24, "valid": 4, "test": 4}, seed=3)
    return load_qm9(path)[0]


def _tiny(seed=0):
    cfg = factory.make_latent_diffusion_config(INFO, nf=16, n_layers=1, diffusion_steps=6,
                                               trainable_ae=True)
    model = factory.build_model(cfg, "cpu", torch.Generator().manual_seed(seed))
    return cfg, model


def _epoch(splits, traced: bool):
    cfg, model = _tiny()
    state = create_train_state(model, cfg, 1e-3, ema_decay=0.9)
    loader = QM9Loader(splits["train"], 8, INFO.max_n_nodes, seed=3)
    run = lambda: trainer.train_epoch(  # noqa: E731
        state, make_train_step(cfg, 0.9), loader, DistributionNodes(INFO.n_nodes),
        torch.Generator().manual_seed(1), 0, augment_noise=0.1, rng=np.random.default_rng(2),
        prefetch=2)[0]
    if not traced:
        return run(), sp.state_digest(state), loader
    with _profiler():
        losses = run()
    return losses, sp.state_digest(state), loader


def test_train_epoch_spans_each_step_and_each_wait(splits):
    losses, _, loader = _epoch(splits, traced=True)
    recs = spans.records()
    steps = [r for r in recs if r[0] == "train.step"]
    assert len(losses) == 3 and [r[1] for r in steps] == [0, 1, 2]
    assert all(r[2] is None for r in steps)
    for _, k, _, s0, e0 in steps:
        children = [r for r in recs if r[2] == "train.step" and r[1] == k]
        assert [r[0] for r in children] == STEP_CHILDREN
        assert all(s0 <= s <= e <= e0 for _, _, _, s, e in children)
    assert not any(r[0] == "train.grad_reduce" for r in recs)  # one rank: no group
    # One wait a batch, and the last one, which finds the loader's end.
    waits = [r for r in recs if r[0] == "train.data_wait"]
    assert [r[1] for r in waits] == [0, 1, 2, 3] and all(r[2] is None for r in waits)
    pairs = slots = 0
    for raw in QM9Loader(splits["train"], 8, INFO.max_n_nodes, seed=3):
        n = raw["node_mask"].reshape(len(raw["node_mask"]), -1).sum(1).astype(int)
        pairs += int(sum(int(v) ** 2 for v in n))
        slots += len(n) * INFO.max_n_nodes ** 2
    assert spans.counters() == {"train.pairs": pairs, "train.pair_slots": slots}
    assert len(loader) == 3


def test_spans_change_no_loss_or_weight(splits):
    plain, traced = _epoch(splits, traced=False), _epoch(splits, traced=True)
    assert plain[0] == traced[0] and plain[1] == traced[1]


SIZES = np.array([9, 20, 5, 12, 29, 17, 3, 22, 11])
BUCKETS = (8, 16, 24, 32)


def _sample(model, traced: bool):
    run = lambda: sampling.sample_bucketed(  # noqa: E731
        model, 11, INFO, SIZES, batch_size=2, buckets=BUCKETS)
    if not traced:
        return run()
    with _profiler():
        return run()


def test_sample_bucketed_spans_each_chunk_and_counts_its_pairs():
    _, model = _tiny()
    _sample(model, traced=True)
    recs = spans.records()
    (call,) = [r for r in recs if r[0] == "sample.call"]
    chunks = [r for r in recs if r[0] == "sample.chunk"]
    assert len(chunks) == sampling.n_chunks(SIZES, 2, BUCKETS)
    assert [r[1] for r in chunks] == [(call[1], i) for i in range(len(chunks))]
    parts = [r[0] for r in recs if r[2] == "sample.call"]
    assert parts == ["sample.setup"] + ["sample.chunk"] * len(chunks) + ["sample.fetch",
                                                                         "sample.assemble"]
    assert all(r[1] == call[1] for r in recs if r[0] in ("sample.setup", "sample.fetch",
                                                         "sample.assemble"))
    # By hand: buckets 8 (5, 3), 16 (9, 12, 11: a pair, then one), 24 (20,
    # 17, 22: a pair, then one), 32 (29); a chunk of one is not padded.
    slots = 2 * 8 ** 2 + (2 + 1) * 16 ** 2 + (2 + 1) * 24 ** 2 + 32 ** 2
    assert spans.counters() == {"sample.pairs": int((SIZES ** 2).sum()),
                                "sample.pair_slots": slots}


def test_spans_change_no_sampled_molecule():
    _, model = _tiny()
    plain, traced = _sample(model, traced=False), _sample(model, traced=True)
    assert all(np.array_equal(a, b) for a, b in zip(plain, traced))
