"""The readers of the program's spans and counters: each reads its value
from spans recorded under a CPU profiler, and nothing for another kind of
cell, a run without a trace, or a run without its spans."""

import sys

import pytest
import tiny  # noqa: F401
from torch.profiler import ProfilerActivity, profile

import geoldm_tpu_torch.utils
from geoldm_tpu_torch.utils import spans
from harness import core

TRACE = {"window_s": 1.0, "busy_s": 0.5, "kernel_count": 10}
MS = 1_000_000  # ns


class Clock:
    def __init__(self):
        self.now = 0

    def perf_counter_ns(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    spans.clear()
    c = Clock()
    monkeypatch.setattr(spans, "time", c)
    yield c
    spans.clear()


def _span(clock, name, ms, k=None):
    with spans.span(name, k):
        clock.now += ms * MS


def _train(clock):
    """Two steps: waits of 1 and 3 ms; steps of 40 and 60 ms, of which
    zero_grad, clip, optimizer and EMA 1+2+3+4 and 2+2+2+2 ms; pairs 300 of
    1000 slots, then 100 of 1000."""
    with profile(activities=[ProfilerActivity.CPU]):
        for k, (wait, parts, rest, pairs) in enumerate([(1, (1, 2, 3, 4), 30, 300),
                                                        (3, (2, 2, 2, 2), 52, 100)]):
            _span(clock, "train.data_wait", wait, k)
            spans.count("train.pairs", pairs)
            spans.count("train.pair_slots", 1000)
            with spans.span("train.step", k):
                _span(clock, "train.zero_grad", parts[0], k)
                _span(clock, "train.forward", rest // 2, k)
                _span(clock, "train.backward", rest - rest // 2, k)
                for name, ms in zip(("train.clip", "train.optimizer", "train.ema"), parts[1:]):
                    _span(clock, name, ms, k)


def _sample(clock):
    """Two calls: setup 5 and 7 ms, assemble 11 and 13 ms, chunks and fetch
    around them; pairs 630 of 1500 slots."""
    with profile(activities=[ProfilerActivity.CPU]):
        for call, (setup, assemble) in enumerate([(5, 11), (7, 13)]):
            with spans.span("sample.call", call):
                _span(clock, "sample.setup", setup, call)
                for i in range(3):
                    _span(clock, "sample.chunk", 100, (call, i))
                    spans.count("sample.pairs", 105)
                    spans.count("sample.pair_slots", 250)
                _span(clock, "sample.fetch", 500, call)
                _span(clock, "sample.assemble", assemble, call)


TRAIN = {"step_host_ms.train": (40 + 60) / 2, "optimizer_host_ms.train": (10 + 8) / 2,
         "data_wait_ms.train": (1 + 3) / 2, "pad_waste_share.train": 80.0}
SAMPLE = {"host_only_ms.sample": (5 + 11 + 7 + 13) / 2, "pad_waste_share.sample": 58.0}


@pytest.mark.parametrize("name", sorted(TRAIN) + sorted(SAMPLE))
def test_each_reader_reads_its_spans(clock, name):
    kind = "train" if name in TRAIN else "sample"
    (_train if kind == "train" else _sample)(clock)
    got = core.metric_reader(name)({"kind": kind, "trace": TRACE})
    assert got == pytest.approx({**TRAIN, **SAMPLE}[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(TRAIN) + sorted(SAMPLE))
def test_each_reader_reads_nothing_where_it_has_nothing(clock, name):
    read = core.metric_reader(name)
    kind, other = ("train", "sample") if name in TRAIN else ("sample", "train")
    assert read({"kind": kind, "trace": TRACE}) is None  # no spans
    _train(clock)
    _sample(clock)
    assert read({"kind": other, "trace": TRACE}) is None
    assert read({"kind": kind}) is None and read({"kind": kind, "trace": None}) is None
    assert read({"kind": kind, "trace": TRACE}) is not None


def test_the_readers_read_nothing_from_a_program_without_spans(clock, monkeypatch):
    """A program that predates ``utils.spans`` (the import fails)."""
    _train(clock)
    monkeypatch.delattr(geoldm_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "geoldm_tpu_torch.utils.spans", None)
    for name in TRAIN:
        assert core.metric_reader(name)({"kind": "train", "trace": TRACE}) is None
