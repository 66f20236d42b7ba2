"""The port's server coalesces concurrent unseeded requests as JAX's
``_Coalescer`` does (JAX's scripted scenario of tests/test_serve.py run
against the port's service), a request served alone replays from its echoed
seed, and the start-up warm-up dispatches once over every bucket, changes
no molecule and moves no counter."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.models import factory
from geoldm_tpu_torch.train import sampling as psampling
from geoldm_tpu_torch.utils.convert import save_reference_checkpoint

torch.set_num_threads(1)

INFO = get_dataset_info("qm9")
# The port's settings tuple: (n_steps, eta, method, clip_z, cfg_scale).
SETTINGS = (3, 1.0, "ddim", 0.0, 1.0)


def _request(base, path, body=None):
    if body is None:
        req = urllib.request.Request(base + path)
    else:
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_for(pred, timeout=60.0):
    t_end = time.time() + timeout
    while not pred():
        assert time.time() < t_end, "condition never became true"
        time.sleep(0.01)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("port_batching") / "ckpt"
    cfg = factory.make_latent_diffusion_config(INFO, nf=16, n_layers=1, diffusion_steps=4)
    save_reference_checkpoint(factory.build_model(cfg, "cpu", torch.Generator().manual_seed(0)),
                              str(path))
    return str(path)


@pytest.fixture(scope="module")
def server(model_dir):
    from geoldm_tpu_torch.cli import serve

    srv, service = serve.main(["--model_path", model_dir, "--port", "0", "--batch_max", "16",
                               "--compute_dtype", "float32", "--n_steps", "3", "--device", "cpu",
                               "--no_warmup"], serve_forever=False)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service
    srv.shutdown()
    srv.server_close()


class _Gate:
    """Wraps a service's ``_generate``: records each dispatch's size and
    holds the first one until ``release``."""

    def __init__(self, service, fail=False):
        self.service, self.fail = service, fail
        self.real = service._generate
        self.calls, self.gate = [], threading.Event()

    def __enter__(self):
        def held(sizes, *a, **kw):
            first = not self.calls
            self.calls.append(len(sizes))
            if first:
                assert self.gate.wait(timeout=60)
            if self.fail:
                raise RuntimeError("device fell over")
            return self.real(sizes, *a, **kw)

        self.service._generate = held
        return self

    def __exit__(self, *exc):
        self.service._generate = self.real


def test_coalescer_merges_the_queued_requests(server):
    """JAX's scenario (tests/test_serve.py:263-361): hold the first dispatch,
    queue 2 + 3 + 4, release: dispatches of 1 and 9, a group of 3, each
    request its own slice, ``dispatches`` up by 2; then a failed dispatch
    reaches every request of its group."""
    _, service = server
    dispatches = service.dispatches
    results = []

    def submit(n):
        out, seed, group = service._coalescer.submit(np.full(n, 5, dtype=np.int64), None,
                                                     100 + n, SETTINGS)
        results.append((n, out, seed, group))

    with _Gate(service) as g:
        first = threading.Thread(target=submit, args=(1,))
        first.start()
        _wait_for(lambda: len(g.calls) == 1)
        rest = [threading.Thread(target=submit, args=(n,)) for n in (2, 3, 4)]
        for t in rest:
            t.start()
        _wait_for(lambda: len(service._coalescer._pending) == 3)
        g.gate.set()
        for t in [first] + rest:
            t.join(timeout=120)
    assert g.calls == [1, 9]
    assert sorted(n for n, *_ in results) == [1, 2, 3, 4]
    for n, out, seed, group in results:
        one_hot, charges, x, node_mask = out
        assert len(x) == len(one_hot) == len(node_mask) == n
        assert (node_mask[:, :, 0].sum(1) == 5).all()
        # A group's seed is its first request's; a group of one is unbatched.
        assert (group, seed) == ((1, 101) if n == 1 else (3, 102))
    assert service.dispatches == dispatches + 2
    # The slices are the merged dispatch's rows in request order: rerun it.
    merged = service._generate(np.full(9, 5, dtype=np.int64), 102, *SETTINGS[:4], None,
                               SETTINGS[4])
    lo = 0
    for n in (2, 3, 4):
        got = next(out for m, out, *_ in results if m == n)
        np.testing.assert_array_equal(got[2], merged[2][lo:lo + n])
        lo += n

    errors = []

    def submit_err():
        try:
            service._coalescer.submit(np.full(2, 5, dtype=np.int64), None, 7, SETTINGS)
        except RuntimeError as e:
            errors.append(str(e))

    dispatches = service.dispatches
    with _Gate(service, fail=True) as g:
        ts = [threading.Thread(target=submit_err) for _ in range(3)]
        ts[0].start()
        _wait_for(lambda: len(g.calls) == 1)
        for t in ts[1:]:
            t.start()
        _wait_for(lambda: len(service._coalescer._pending) == 2)
        g.gate.set()
        for t in ts:
            t.join(timeout=60)
    assert errors == ["device fell over"] * 3 and g.calls == [2, 4]
    assert service.dispatches == dispatches


def test_concurrent_http_requests_coalesce(server):
    """Over HTTP: four unseeded requests while the first is held; the three
    that queued come back from one dispatch with ``"seed": null`` and
    ``"coalesced": 3``; the first echoes its seed; seeded requests bypass."""
    base, service = server
    before = service.metrics()
    replies = {}

    def post(i):
        replies[i] = _request(base, "/sample", {"sizes": [4 + i, 6]})

    with _Gate(service) as g:
        first = threading.Thread(target=post, args=(0,))
        first.start()
        _wait_for(lambda: len(g.calls) == 1)
        rest = [threading.Thread(target=post, args=(i,)) for i in (1, 2, 3)]
        for t in rest:
            t.start()
        _wait_for(lambda: len(service._coalescer._pending) == 3)
        g.gate.set()
        for t in [first] + rest:
            t.join(timeout=120)
    assert g.calls == [2, 6]
    assert all(code == 200 for code, _ in replies.values())
    assert isinstance(replies[0][1]["seed"], int) and "coalesced" not in replies[0][1]
    for i in (1, 2, 3):
        body = replies[i][1]
        assert body["seed"] is None and body["coalesced"] == 3
        assert [len(m) for m in body["molecules"]] == [4 + i, 6]
        for mol in body["molecules"]:
            for el, *xyz in mol:
                assert el in INFO["atom_decoder"] and np.all(np.isfinite(xyz))
    after = service.metrics()
    assert after["requests"] - before["requests"] == 4
    assert after["dispatches"] - before["dispatches"] == 2
    # A seeded request runs alone, even while others queue.
    code, seeded = _request(base, "/sample", {"sizes": [5], "seed": 3})
    assert code == 200 and seeded["seed"] == 3 and "coalesced" not in seeded


def test_solo_unseeded_response_replays_from_its_seed(server):
    base, _ = server
    code, a = _request(base, "/sample", {"n_samples": 3})
    assert code == 200 and isinstance(a["seed"], int) and "coalesced" not in a
    code, b = _request(base, "/sample", {"n_samples": 3, "seed": a["seed"]})
    assert code == 200 and b["seed"] == a["seed"]
    assert b["molecules"] == a["molecules"] and b["stable"] == a["stable"]


def test_warmup_covers_every_bucket_and_changes_nothing(model_dir, tmp_path, monkeypatch,
                                                       capsys):
    """The warm-up makes one dispatch with ``--batch_max`` molecules in every
    bucket, at 6 steps under the default bfloat16_mixed (the fewest whose
    f32 tail is not empty) and at 1 in float32; it moves no counter, and a
    seeded request after it returns the molecules a server without it
    returns."""
    from geoldm_tpu_torch.cli import serve

    seen = []
    real = psampling.sample_bucketed

    def spy(model, seed, info, sizes, **kw):
        seen.append((seed, np.asarray(sizes).copy(), kw))
        return real(model, seed, info, sizes, **kw)

    cfg = factory.make_latent_diffusion_config(INFO, nf=16, n_layers=1, diffusion_steps=10)
    save_reference_checkpoint(factory.build_model(cfg, "cpu", torch.Generator().manual_seed(1)),
                              str(tmp_path))
    argv = ["--model_path", str(tmp_path), "--port", "0", "--batch_max", "5", "--device", "cpu"]
    monkeypatch.setattr(psampling, "sample_bucketed", spy)
    srv, warm = serve.main(argv, serve_forever=False)
    srv.server_close()
    assert "warmed up 3 buckets in" in capsys.readouterr().out
    assert len(seen) == 1 and warm.warmup_seconds > 0
    seed, sizes, kw = seen[0]
    assert seed == 0 and kw["n_steps"] == 6 and kw["batch_size"] == 5
    assert kw["compute_dtype"] == "bfloat16_mixed"
    assert psampling.chunk_pads(sizes, 5, warm.buckets) == list(warm.buckets)
    assert np.bincount(sizes).tolist().count(5) == len(warm.buckets)
    metrics = {"requests": 0, "molecules": 0, "errors": 0, "dispatches": 0}
    assert warm.metrics() == metrics and warm._auto_seed == 0 and warm.latencies == []
    warm.warmup()
    assert warm.metrics() == metrics and warm._auto_seed == 0

    srv, cold = serve.main(argv + ["--no_warmup"], serve_forever=False)
    srv.server_close()
    assert len(seen) == 2 and cold.warmup_seconds is None
    f32 = serve.SamplerService(serve.parse_args(argv + ["--compute_dtype", "float32"]))
    assert f32.warmup_steps() == 1 and cold.warmup_steps() == 6
    # A checkpoint of fewer than 6 steps warms at all of them.
    short = serve.SamplerService(serve.parse_args(["--model_path", model_dir, "--device", "cpu"]))
    assert short.warmup_steps() == short.timesteps == 4
    req = {"sizes": [5, 11, 20, 29], "seed": 9}
    assert warm.sample(req)["molecules"] == cold.sample(req)["molecules"]


def test_coalescer_under_thread_pressure(model_dir):
    """More submitting threads than cores, a shortened switch interval and a
    dispatch that only tags rows: every request gets back exactly its own
    rows, in order, and ``dispatches`` counts each dispatch once."""
    import os
    import sys

    from geoldm_tpu_torch.cli import serve

    service = serve.SamplerService(serve.parse_args(["--model_path", model_dir, "--device",
                                                     "cpu", "--no_warmup"]))
    dispatched = []

    def tagging_generate(sizes, seed, *a, **kw):
        dispatched.append(len(sizes))
        rows = np.asarray(sizes, dtype=np.float32)[:, None, None]
        return rows, rows, rows, rows

    service._generate = tagging_generate
    n_threads = 4 * (os.cpu_count() or 1) + 8
    errors = []

    def client(i):
        try:
            for j in range(5):
                sizes = np.full(1 + (i + j) % 3, 1000 * i + j, dtype=np.int64)
                out, _, group = service._coalescer.submit(sizes, None, i, SETTINGS)
                assert all((a[:, 0, 0] == sizes).all() for a in out) and group >= 1
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert sum(dispatched) == sum(1 + (i + j) % 3 for i in range(n_threads) for j in range(5))
    assert service.dispatches == len(dispatched)
