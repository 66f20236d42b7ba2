"""The port's sampling server on the CPU over real HTTP, against a tiny
model written in the upstream checkpoint layout."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from geoldm_tpu_torch.data.datasets_config import get_dataset_info
from geoldm_tpu_torch.models import factory
from geoldm_tpu_torch.utils.convert import save_reference_checkpoint

torch.set_num_threads(1)

INFO = get_dataset_info("qm9")


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


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("port_serve") / "ckpt"
    cfg = factory.make_latent_diffusion_config(INFO, nf=16, n_layers=1, diffusion_steps=4)
    save_reference_checkpoint(factory.build_model(cfg, "cpu", torch.Generator().manual_seed(0)),
                              str(path))
    return str(path)


@pytest.fixture(scope="module")
def server(model_dir):
    from geoldm_tpu_torch.cli import serve

    srv, service = serve.main(["--model_path", model_dir, "--port", "0", "--batch_max", "8",
                               "--device", "cpu"], serve_forever=False)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service
    srv.shutdown()
    srv.server_close()


def test_health_and_metrics(server):
    base, _ = server
    code, body = _request(base, "/health")
    assert code == 200 and body["status"] == "ok"
    assert body["kind"] == "latent_diffusion" and body["device"] == "cpu"
    assert body["buckets"] == [16, 24, 32]
    code, body = _request(base, "/metrics")
    assert code == 200 and {"requests", "molecules", "errors", "dispatches"} <= set(body)


def test_seeded_request_replays_exactly(server):
    base, _ = server
    req = {"sizes": [5, 9, 20], "seed": 3}
    code, a = _request(base, "/sample", req)
    assert code == 200 and a["n"] == 3 and a["seed"] == 3
    assert [len(m) for m in a["molecules"]] == [5, 9, 20]
    assert a["sampler"]["protocol"] == "dense-T"
    for mol in a["molecules"]:
        for el, *xyz in mol:
            assert el in INFO["atom_decoder"] and np.all(np.isfinite(xyz))
    code, b = _request(base, "/sample", req)
    assert code == 200 and b["molecules"] == a["molecules"] and b["stable"] == a["stable"]


def test_unseeded_and_xyz_requests(server):
    base, _ = server
    code, a = _request(base, "/sample", {"n_samples": 2})
    code2, b = _request(base, "/sample", {"n_samples": 2, "format": "xyz"})
    assert code == code2 == 200 and a["seed"] != b["seed"]
    n_atoms = int(b["molecules"][0].split("\n")[0])
    assert len(b["molecules"][0].split("\n")) == n_atoms + 2
    # The echoed seed replays an unseeded response.
    code, c = _request(base, "/sample", {"n_samples": 2, "seed": a["seed"]})
    assert code == 200 and c["molecules"] == a["molecules"]


@pytest.mark.parametrize("body,fragment", [
    ({"sizes": [0]}, "sizes must be in [1, 29]"),
    ({"sizes": [30]}, "sizes must be in [1, 29]"),
    ({"sizes": []}, "non-empty"),
    ({"sizes": "abc"}, "list of ints"),
    ({"n_samples": 0}, "n_samples must be in"),
    ({"seed": "x"}, "seed must be an integer"),
    ({"sizes": [5], "n_steps": 10}, "n_steps must be in [1, 4]"),
    ({"sizes": [5], "sampler": "dpm3"}, "sampler must be"),
    ({"sizes": [5], "cfg_scale": 11.0}, "cfg_scale must be in [0.0, 10.0]"),
    ({"sizes": [5], "properties": {"alpha": 1.0}}, "unconditional"),
])
def test_invalid_requests_get_400(server, body, fragment):
    base, service = server
    errors = service.errors
    code, out = _request(base, "/sample", body)
    assert code == 400 and fragment in out["error"]
    assert service.errors == errors + 1


def test_non_float32_compute_dtype_raises(model_dir):
    """The bf16 names are served (bfloat16_mixed is the default); a name
    outside them raises."""
    from geoldm_tpu_torch.cli import serve

    assert serve.parse_args(["--model_path", model_dir]).compute_dtype == "bfloat16_mixed"
    with pytest.raises(ValueError, match="unknown compute dtype 'float16'"):
        serve.SamplerService(serve.parse_args(["--model_path", model_dir, "--device", "cpu",
                                               "--compute_dtype", "float16"]))
