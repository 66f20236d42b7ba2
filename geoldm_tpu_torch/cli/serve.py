"""Molecule generation server on the card (port of
``geoldm_tpu/cli/serve.py:169-580``).

Loads an upstream-layout checkpoint directory (``args.pickle`` +
``generative_model[_ema].npy``) of a generative model (latent diffusion or
the plain E(n) diffusion model, either noise schedule and dynamics; a VAE
is refused) and serves JSON over stdlib http.server.
``--dataset`` picks the size buckets and the largest request size: QM9
(16, 24, 32), GEOM-Drugs (32, 48, 64, 96, 136, 184) up to 181 atoms, or
(32, 48, 64, 96) up to 91 with ``--remove_h``. Chunks padded past 64 atoms
run the row-tiled kernels.

Endpoints:
  GET  /health   -> {"status": "ok", "model": ..., "buckets": [...], "device": ...}
  GET  /metrics  -> request/molecule counters + latency quantiles (JSON)
  POST /sample   -> {"n_samples": int} or {"sizes": [int, ...]}, optional
                    {"seed": int, "n_steps": int, "eta": float,
                     "sampler": "ddim"|"dpm2m", "clip_z": float,
                     "format": "xyz"|"json"}, and for a conditional
                    checkpoint {"properties": {name: value}, "cfg_scale": w}.
                    Returns molecules ("json": per-molecule [[element, x,
                    y, z], ...]; "xyz": xyz text blocks) with a stability
                    verdict each, and the sampler settings the request ran.

Conditional checkpoints (started with ``--datadir`` and ``--conditioning``):
``properties`` come in raw units and are normalized with the train split's
mean/MAD (second-half protocol, ``train.conditioning``); a request without
them draws them from the split's property-given-size distribution, and its
sizes from the split's histogram, up to the split's largest molecule.
``cfg_scale`` (classifier-free guidance, default ``--cfg_scale``) is
quantised to 0.25 and is 1 for an unconditional checkpoint.

``--compute_dtype`` (default ``bfloat16_mixed``, as JAX's server) sets the
precision: the bf16 names run the bf16 kernel variants, ``bfloat16_mixed``
the last 10 % of the steps and the final step in f32. ``n_steps`` selects
the few-step sampler (null or 0: the dense T steps); a request's value is
snapped to a fixed ladder (``_NSTEPS_LADDER``, T always a rung; ties snap
down) unless it is the server's own ``--n_steps``. ``clip_z`` is quantised
to 0.25. Device calls are serialised with a lock; request handling is
threaded so /health and /metrics answer during generation. (JAX's
coalescing of concurrent unseeded requests and its warm-up pass are not
ported: every request is its own dispatch.)

Usage: python -m geoldm_tpu_torch.cli.serve --model_path <checkpoint dir>
           [--dataset qm9|geom] [--port 8000] [--device cuda] [--n_steps 50]
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np
import torch

# Allowed per-request few-step settings (geoldm_tpu/cli/serve.py:43-50): a
# request's n_steps snaps to the nearest rung, which bounds the settings a
# client can ask for.
_NSTEPS_LADDER = (1, 2, 3, 5, 8, 10, 15, 20, 25, 35, 50, 75, 100,
                  150, 250, 375, 500, 750, 1000, 1500, 2000, 3000, 4000)


def snap_n_steps(n_steps: int, timesteps: int) -> int:
    """The ladder rung (or T) nearest ``n_steps``, ties to the lower."""
    return min((k for k in (*_NSTEPS_LADDER, timesteps) if k <= timesteps),
               key=lambda k: (abs(k - n_steps), k))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="geoldm-tpu-torch sampling server")
    p.add_argument("--model_path", type=str, required=True,
                   help="upstream checkpoint dir (args.pickle + generative_model[_ema].npy)")
    p.add_argument("--dataset", type=str, default="qm9")
    p.add_argument("--remove_h", action="store_true")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch_max", type=int, default=250,
                   help="max molecules per device dispatch; larger requests are chunked")
    p.add_argument("--compute_dtype", type=str, default="bfloat16_mixed",
                   help="float32, pallas, xla, bfloat16, bfloat16_pallas, bfloat16_full or "
                        "bfloat16_mixed")
    p.add_argument("--n_steps", type=int, default=None,
                   help="default few-step setting for requests that name none "
                        "(None: the dense T-step sampler)")
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--sampler", type=str, default="ddim", choices=["ddim", "dpm2m"])
    p.add_argument("--clip_z", type=float, default=0.0,
                   help="default per-step dynamic-range guard")
    p.add_argument("--datadir", type=str, default=None,
                   help="dataset dir (required for conditional checkpoints: the property "
                        "normalizers and the property-given-size distribution come from the "
                        "training split)")
    p.add_argument("--conditioning", nargs="+", default=[],
                   help="property names the checkpoint was conditioned on")
    p.add_argument("--cfg_scale", type=float, default=1.0,
                   help="default classifier-free guidance scale for conditional requests")
    p.add_argument("--use_ema", type=eval, default=True)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


class SamplerService:
    """Checkpoint + sampler + metrics. Thread-safe: generation runs under a
    device lock, bookkeeping under a metrics lock."""

    def __init__(self, args):
        from geoldm_tpu_torch.data.datasets_config import get_dataset_info
        from geoldm_tpu_torch.models.distributions import DistributionNodes
        from geoldm_tpu_torch.nn.core import resolve_compute
        from geoldm_tpu_torch.train import sampling as sampling_mod
        from geoldm_tpu_torch.train.conditioning import (
            load_conditional_protocol,
            property_channels,
        )
        from geoldm_tpu_torch.utils.buckets import covering_buckets
        from geoldm_tpu_torch.utils.convert import load_reference_checkpoint

        resolve_compute(args.compute_dtype)  # raises on an unknown name
        self._sampling = sampling_mod
        self.args = args
        self.model, self.model_cfg, _ = load_reference_checkpoint(
            args.model_path, args.device, args.use_ema)
        if self.model_cfg.kind == "vae":
            raise SystemExit(f"{args.model_path} holds a 'vae' model: this server samples "
                             "generative checkpoints (latent or plain diffusion)")
        self.device = next(self.model.parameters()).device
        self.timesteps = self.model_cfg.diffusion.timesteps
        self.dataset_info = get_dataset_info(args.dataset, args.remove_h)
        self.nodes_dist = DistributionNodes(self.dataset_info.n_nodes)
        self.buckets = covering_buckets(sampling_mod.default_buckets(self.dataset_info),
                                        self.dataset_info["max_n_nodes"])
        self.max_request_size = self.dataset_info["max_n_nodes"]
        # A conditional checkpoint: the normalizers, the property-given-size
        # distribution and the size histogram of its training split.
        n_props = property_channels(self.model_cfg)
        self.conditioning = list(args.conditioning)
        self.prop_norms = self.prop_dist = None
        if n_props > 0:
            if not (args.datadir and len(self.conditioning) == n_props):
                raise SystemExit(f"conditional checkpoint ({n_props} property channel(s)): pass "
                                 f"--datadir and --conditioning with exactly {n_props} "
                                 "property name(s)")
            if "qm9" not in args.dataset:
                raise SystemExit("conditional serving implements the QM9 second-half protocol "
                                 "only (--dataset qm9)")
            _, self.prop_norms, self.prop_dist, self.nodes_dist, self.max_request_size = (
                load_conditional_protocol(args.datadir, self.conditioning))
        self.device_lock = threading.Lock()
        self.metrics_lock = threading.Lock()
        self.requests = self.molecules = self.errors = self.dispatches = 0
        self._auto_seed = 0
        # Fresh entropy per process: unseeded requests draw new streams across
        # restarts (48 bits keep seed + counter inside int64).
        self._auto_seed_base = args.seed + int.from_bytes(os.urandom(6), "little")
        self.latencies = []
        self.started = time.time()

    def _generate(self, sizes, seed, n_steps, eta, method, clip_z, context=None, cfg_scale=1.0):
        with self.device_lock:
            return self._sampling.sample_bucketed(
                self.model, seed, self.dataset_info, np.asarray(sizes, dtype=np.int64),
                batch_size=self.args.batch_max, buckets=self.buckets, n_steps=n_steps, eta=eta,
                method=method, clip_z=clip_z, compute_dtype=self.args.compute_dtype,
                context=context, guidance_scale=cfg_scale)

    def sampler_settings(self, body: dict) -> tuple:
        """(n_steps, eta, method, clip_z, cfg_scale) of a request, validated
        and quantised as JAX's server does (geoldm_tpu/cli/serve.py:342-383):
        cfg_scale to 0.25, and 1 without a context (guidance is then a
        no-op)."""
        def num(name, default, lo, hi):
            try:
                v = float(body.get(name, default))
            except (TypeError, ValueError):
                raise ValueError(f"{name} must be a number") from None
            if not lo <= v <= hi:
                raise ValueError(f"{name} must be in [{lo}, {hi}]")
            return v

        n_steps = body.get("n_steps", self.args.n_steps)
        if n_steps in (None, 0):
            n_steps = None
        else:
            try:
                n_steps = int(n_steps)
            except (TypeError, ValueError):
                raise ValueError("n_steps must be an integer") from None
            T = self.timesteps
            if not 1 <= n_steps <= T:
                raise ValueError(f"n_steps must be in [1, {T}] (this checkpoint's timestep "
                                 "count; null/0 selects the dense sampler)")
            if n_steps != self.args.n_steps:
                n_steps = snap_n_steps(n_steps, T)
        eta = num("eta", self.args.eta, 0.0, 1.0)
        method = str(body.get("sampler", self.args.sampler))
        if method not in ("ddim", "dpm2m"):
            raise ValueError("sampler must be 'ddim' or 'dpm2m'")
        cfg_scale = round(num("cfg_scale", self.args.cfg_scale, 0.0, 10.0) * 4) / 4
        clip_z = round(num("clip_z", self.args.clip_z, 0.0, 1000.0) * 4) / 4
        if self.prop_dist is None:
            cfg_scale = 1.0
        return n_steps, eta, method, clip_z, cfg_scale

    def request_context(self, body: dict, sizes, seed: int):
        """(context rows [M, P] normalized, the properties to echo) of a
        request to a conditional checkpoint; (None, None) otherwise. Raw
        ``properties`` are normalized with the train split's mean/MAD; without
        them the rows are drawn from the split's distribution
        (geoldm_tpu/cli/serve.py:386-415)."""
        if self.prop_dist is None:
            if "properties" in body:
                raise ValueError("this checkpoint is unconditional — 'properties' is not "
                                 "accepted")
            return None, None
        if "properties" not in body:
            return (self.prop_dist.sample_batch(sizes, np.random.default_rng(seed)),
                    "sampled-from-data-distribution")
        props = body["properties"]
        if not isinstance(props, dict):
            raise ValueError(f"properties must be an object of "
                             f"{{{', '.join(self.conditioning)}}} -> value")
        cols = []
        for name in self.conditioning:
            if name not in props:
                raise ValueError(f"properties is missing {name!r}")
            try:
                v = float(props[name])
            except (TypeError, ValueError):
                raise ValueError(f"properties[{name!r}] must be a number") from None
            cols.append((v - self.prop_norms[name]["mean"]) / self.prop_norms[name]["mad"])
        return (np.tile(np.asarray(cols, dtype=np.float32), (len(sizes), 1)),
                {k: float(props[k]) for k in self.conditioning})

    def sample(self, body: dict) -> dict:
        """Handle one /sample request body; returns the response dict."""
        from geoldm_tpu_torch.evalsuite.analyze import check_stability

        t0 = time.time()
        if "seed" in body:
            try:
                seed = int(body["seed"])
            except (TypeError, ValueError):
                raise ValueError("seed must be an integer") from None
        else:
            # Unseeded requests must not repeat; the response echoes the
            # seed so any response can be replayed.
            with self.metrics_lock:
                self._auto_seed += 1
                seed = self._auto_seed_base + self._auto_seed

        n_steps, eta, method, clip_z, cfg_scale = self.sampler_settings(body)
        if "sizes" in body:
            try:
                sizes = np.asarray(body["sizes"], dtype=np.int64)
            except (TypeError, ValueError):
                raise ValueError("sizes must be a list of ints") from None
            if sizes.ndim != 1 or len(sizes) == 0:
                raise ValueError("sizes must be a non-empty list of ints")
            max_n = self.max_request_size
            if sizes.min() < 1 or sizes.max() > max_n:
                raise ValueError(f"sizes must be in [1, {max_n}]")
        else:
            try:
                n = int(body.get("n_samples", 1))
            except (TypeError, ValueError):
                raise ValueError("n_samples must be a number") from None
            if not 1 <= n <= 100_000:
                raise ValueError("n_samples must be in [1, 100000]")
            sizes = self.nodes_dist.sample(n, np.random.default_rng(seed))

        context, props_used = self.request_context(body, sizes, seed)
        one_hot, _, x, node_mask = self._generate(sizes, seed, n_steps, eta, method, clip_z,
                                                  context, cfg_scale)
        with self.metrics_lock:
            self.dispatches += 1

        decoder = self.dataset_info["atom_decoder"]
        fmt = body.get("format", "json")
        mols, stable = [], []
        for i in range(len(x)):
            n_i = int(node_mask[i, :, 0].sum())
            types = np.argmax(one_hot[i, :n_i], axis=1)
            stable.append(bool(check_stability(x[i, :n_i], types, self.dataset_info)[0]))
            if fmt == "xyz":
                lines = [f"{n_i}", ""]
                for a in range(n_i):
                    px, py, pz = x[i, a]
                    lines.append(f"{decoder[int(types[a])]} {px:.6f} {py:.6f} {pz:.6f}")
                mols.append("\n".join(lines))
            else:
                mols.append([[decoder[int(types[a])], float(x[i, a, 0]), float(x[i, a, 1]),
                              float(x[i, a, 2])] for a in range(n_i)])
        elapsed = time.time() - t0
        with self.metrics_lock:
            self.requests += 1
            self.molecules += len(mols)
            self.latencies = (self.latencies + [elapsed])[-1000:]
        return {
            "molecules": mols,
            "format": fmt,
            "stable": stable,
            "n": len(mols),
            "sampler": {"n_steps": n_steps, "eta": eta, "method": method, "clip_z": clip_z,
                        "compute_dtype": self.args.compute_dtype,
                        "protocol": "dense-T" if n_steps is None else f"fewstep-{n_steps}"},
            "seed": seed,
            "seconds": round(elapsed, 4),
            **({"properties": props_used, "cfg_scale": cfg_scale}
               if self.prop_dist is not None else {}),
        }

    def health(self) -> dict:
        device = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                  else "cpu")
        return {
            "status": "ok",
            "model": self.args.model_path,
            "kind": self.model_cfg.kind,
            "dataset": self.dataset_info["name"],
            "buckets": list(self.buckets),
            "device": device,
            "uptime_s": round(time.time() - self.started, 1),
        }

    def metrics(self) -> dict:
        with self.metrics_lock:
            lat = list(self.latencies)
            out = {"requests": self.requests, "molecules": self.molecules,
                   "errors": self.errors, "dispatches": self.dispatches}
        if lat:
            out["latency_s"] = {"p50": round(float(np.percentile(lat, 50)), 4),
                                "p95": round(float(np.percentile(lat, 95)), 4),
                                "max": round(max(lat), 4)}
        return out


def make_handler(service: SamplerService):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, service.health())
            elif self.path == "/metrics":
                self._send(200, service.metrics())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/sample":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("request body must be a JSON object")
                self._send(200, service.sample(body))
            except (ValueError, KeyError) as e:
                # Validation raises readable ValueErrors; anything else is a
                # server-side fault and gets a 500.
                with service.metrics_lock:
                    service.errors += 1
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the client must get a reply
                with service.metrics_lock:
                    service.errors += 1
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *log_args):  # quiet by default
            pass

    return Handler


def main(argv=None, *, serve_forever: bool = True):
    from http.server import ThreadingHTTPServer

    args = parse_args(argv)
    service = SamplerService(args)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    print(f"serving {args.model_path} on http://{args.host}:{server.server_address[1]} "
          f"(buckets {service.buckets}, device {service.health()['device']})")
    if serve_forever:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
    return server, service


if __name__ == "__main__":
    main()
