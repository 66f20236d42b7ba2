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
to 0.25. Device calls are serialised with a lock, each under the server's
device (``--device cuda:1`` works from any thread); request handling is
threaded so /health and /metrics answer during generation.

Before it listens the server warms up (``warmup``; ``--no_warmup`` skips
it): it builds and loads the kernel libraries, then makes one few-step
dispatch of ``--batch_max`` molecules in every bucket (1 step; 6 under
``bfloat16_mixed``, so its f32 tail runs too), which launches each kernel
route a request can reach and sizes the caching allocator for the largest
chunk, so the first request pays neither. Concurrent unseeded
requests are coalesced (``_Coalescer``, as JAX's server): while a dispatch
runs, new ones queue, and the worker merges every queued request with the
same sampler settings into one dispatch. A request served alone echoes its
seed, which replays it; a merged one answers ``"seed": null`` and
``"coalesced": k``. Seeded requests always run alone. ``dispatches`` in
/metrics counts device dispatches.

Usage: python -m geoldm_tpu_torch.cli.serve --model_path <checkpoint dir>
           [--dataset qm9|geom] [--port 8000] [--device cuda] [--n_steps 50]
           [--no_warmup]
"""

from __future__ import annotations

import argparse
import contextlib
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
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the start-up warm-up (the first request then builds the kernel "
                        "libraries)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


class _Coalescer:
    """Request batching for unseeded requests (``geoldm_tpu/cli/serve.py:86-166``).

    While the device runs one dispatch, arriving requests queue; the worker
    then merges every queued request whose sampler settings equal the first
    one's into one ``sample_bucketed`` dispatch and slices the outputs back
    per request, in order. No wait is added: an idle server dispatches at
    once, and a group of one runs exactly as the unbatched path (its seed
    replays it). A failed dispatch raises in every request of its group."""

    def __init__(self, service):
        self._service = service
        self._cond = threading.Condition()
        self._pending = []
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="geoldm-serve-batcher")
        self._thread.start()

    def submit(self, sizes, ctx, seed, settings):
        """Block until the dispatch holding this request is done -> ((one_hot,
        charges, x, node_mask) of its molecules, the dispatch's seed, the
        group's size). Raises the dispatch's exception if it failed."""
        item = {"sizes": sizes, "ctx": ctx, "seed": seed, "settings": settings,
                "event": threading.Event(), "result": None, "error": None,
                "dispatch_seed": None, "group": 0}
        with self._cond:
            self._pending.append(item)
            self._cond.notify()
        item["event"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"], item["dispatch_seed"], item["group"]

    def _run(self):
        while True:
            with self._cond:
                while not self._pending:
                    self._cond.wait()
                settings = self._pending[0]["settings"]
                group = [it for it in self._pending if it["settings"] == settings]
                self._pending = [it for it in self._pending if it["settings"] != settings]
            # The whole group body is guarded: an exception escaping this
            # worker would kill the only batcher thread and hang every
            # unseeded request; errors reach each request of the group.
            try:
                seed = group[0]["seed"]  # a group of one: the unbatched path
                sizes = np.concatenate([it["sizes"] for it in group])
                ctx = (np.concatenate([it["ctx"] for it in group])
                       if group[0]["ctx"] is not None else None)
                n_steps, eta, method, clip_z, cfg_scale = settings
                out = self._service._generate(sizes, seed, n_steps, eta, method, clip_z, ctx,
                                              cfg_scale)
                with self._service.metrics_lock:
                    self._service.dispatches += 1
                lo = 0
                for it in group:
                    hi = lo + len(it["sizes"])
                    it["result"] = tuple(a[lo:hi] for a in out)
                    it["dispatch_seed"] = seed
                    it["group"] = len(group)
                    lo = hi
            except Exception as e:  # noqa: BLE001 — delivered to each request
                for it in group:
                    it["error"] = e
            finally:
                for it in group:
                    it["event"].set()


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
        self.warmup_seconds = None
        self._coalescer = _Coalescer(self)

    def warmup_steps(self) -> int:
        """The warm-up's jump count: 1, or under a compute dtype with an f32
        tail (``bfloat16_mixed``) the fewest steps whose tail is not empty (6:
        round(0.1 * 6) = 1), so that the bf16 and the f32 variants both
        launch; at most the checkpoint's T."""
        from geoldm_tpu_torch.diffusion.vdm import mixed_tail_steps
        from geoldm_tpu_torch.nn.core import resolve_compute

        if not resolve_compute(self.args.compute_dtype).mixed_tail:
            return 1
        return next((k for k in range(1, self.timesteps + 1)
                     if mixed_tail_steps(self.args.compute_dtype, k) > 0), self.timesteps)

    def warmup(self) -> float:
        """Build and load the kernel libraries, then make one dispatch of
        ``--batch_max`` molecules in every bucket at seed 0 -> its seconds.
        This launches every kernel route a request can reach (#1 at pads up
        to 64, #3/#4 past them, each in the variants the compute dtype runs:
        ``warmup_steps`` jumps) and sizes the caching allocator for the
        largest chunk. JAX's server warms at its own ``n_steps``, because
        each setting compiles a program there; the port compiles nothing per
        setting, so a few steps do. No counter moves."""
        t0 = time.time()
        if self.device.type == "cuda":
            from geoldm_tpu_torch.ops import cuda_build

            cuda_build.build()
        sizes = np.concatenate([np.full(self.args.batch_max, min(b, self.max_request_size))
                                for b in self.buckets])
        ctx = (self.prop_dist.sample_batch(sizes, np.random.default_rng(0))
               if self.prop_dist is not None else None)
        self._generate(sizes, 0, self.warmup_steps(), self.args.eta, self.args.sampler,
                       self.args.clip_z, ctx, self.args.cfg_scale)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmup_seconds = time.time() - t0
        return self.warmup_seconds

    def _generate(self, sizes, seed, n_steps, eta, method, clip_z, context=None, cfg_scale=1.0):
        # A request's thread (or the coalescer's) starts on device 0: run on
        # the server's own.
        on_device = (torch.cuda.device(self.device) if self.device.type == "cuda"
                     else contextlib.nullcontext())
        with self.device_lock, on_device:
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
        group = 1
        if "seed" in body:
            # An explicit seed is the exact-replay contract: it runs alone.
            one_hot, _, x, node_mask = self._generate(sizes, seed, n_steps, eta, method, clip_z,
                                                      context, cfg_scale)
            with self.metrics_lock:
                self.dispatches += 1
        else:
            (one_hot, _, x, node_mask), seed, group = self._coalescer.submit(
                sizes, context, seed, (n_steps, eta, method, clip_z, cfg_scale))

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
            # A merged group's seed reproduces no single member's molecules
            # (the batch differs on replay): only a request served alone
            # echoes a replayable seed.
            "seed": seed if group == 1 else None,
            "seconds": round(elapsed, 4),
            **({"coalesced": group} if group > 1 else {}),
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
    if not args.no_warmup:
        dt = service.warmup()
        print(f"warmed up {len(service.buckets)} buckets in {dt:.1f}s", flush=True)
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
