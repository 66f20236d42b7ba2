"""One EGNN EquivariantBlock forward: the hand-written CUDA kernel and its
plain PyTorch version.

Port of the TPU kernel ``geoldm_tpu/ops/pallas_egnn.py:_make_kernel`` over
``_block_math`` (pallas_call at ``:447``). The kernel is
``csrc/egnn_block.cu``; its header says what bounds it on an H100 and how
the design tiles the edge work by row. ``block_forward`` launches it for
CUDA tensors and runs ``block_forward_plain`` only for tensors on the CPU.

The kernel is built from the checkout's source with ``nvcc`` for
``sm_90a`` at first use, into ``geoldm_tpu_torch/_build/`` (one library per
source hash, so an edited source rebuilds), and loaded with ``ctypes``.

``launches`` counts kernel calls: one per block forward on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from geoldm_tpu_torch.ops.distance import build_edge_mask, coord2diff, sin_embedding

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "egnn_block.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = 0
build_info: dict = {}  # filled on first load: library path, seconds, ptxas log

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the egnn_block kernel "
                       "is built from csrc/egnn_block.cu at first use")


def _build() -> Path:
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"egnn_block-{digest}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True,
                          log=log_path.read_text() if log_path.exists() else "")
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {SOURCE.name}:\n{proc.stderr}")
    log_path.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees a partial file
    build_info.update(path=str(lib_path), seconds=seconds, cached=False,
                      log=proc.stdout + proc.stderr)
    return lib_path


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.egnn_block_forward.argtypes = [p] * 11 + [i] * 9 + [f] * 3 + [p]
            lib.egnn_block_forward.restype = i
            lib.egnn_block_error_string.argtypes = [i]
            lib.egnn_block_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


MAX_NODES = 64  # csrc/egnn_block.cu:kMaxNodes, the shared-memory design's bound
MAX_HIDDEN = 512  # csrc/egnn_block.cu:kMaxHidden, one thread per hidden channel


def _block_weights(block) -> tuple:
    """(gcl weight lists, coord weight list) of an ``nn.egnn.EquivariantBlock``
    in the kernel's pointer order."""
    cfg = block.cfg
    gcls = []
    for j in range(cfg.inv_sublayers):
        g = getattr(block, f"gcl_{j}")
        att = (g.att_mlp[0].weight, g.att_mlp[0].bias) if cfg.attention else (None, None)
        gcls.append([g.edge_mlp[0].weight, g.edge_mlp[0].bias,
                     g.edge_mlp[2].weight, g.edge_mlp[2].bias, *att,
                     g.node_mlp[0].weight, g.node_mlp[0].bias,
                     g.node_mlp[2].weight, g.node_mlp[2].bias])
    cm = block.gcl_equiv.coord_mlp
    coord = [cm[0].weight, cm[0].bias, cm[2].weight, cm[2].bias, cm[4].weight]
    return gcls, coord


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"egnn_block: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"egnn_block: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"egnn_block: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"egnn_block: {name} must be contiguous")


def block_forward_cuda(block, h, x, x0, node_mask):
    """The CUDA kernel. h [B,N,H], x/x0 [B,N,3], node_mask [B,N,1] on one card
    -> (h_out [B,N,H], x_out [B,N,3])."""
    global launches
    cfg = block.cfg
    b, n, hidden = h.shape
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"block_forward_cuda needs CUDA tensors, got {dev}")
    if n > MAX_NODES:
        raise ValueError(
            f"egnn_block kernel holds at most {MAX_NODES} nodes per molecule "
            f"(one row's [N, H] edge tile in shared memory); got N={n}")
    if hidden % 32 or not 32 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"egnn_block kernel needs hidden_nf a multiple of 32 in "
                         f"[32, {MAX_HIDDEN}]; got {hidden}")
    if hidden != cfg.hidden_nf:
        raise ValueError(f"h has {hidden} features, block expects {cfg.hidden_nf}")
    e = cfg.edge_feat_nf
    _check("h", h, (b, n, hidden), dev)
    _check("x", x, (b, n, 3), dev)
    _check("x0", x0, (b, n, 3), dev)
    _check("node_mask", node_mask, (b, n, 1), dev)
    gcls, coord = _block_weights(block)
    for ws in gcls + [coord]:
        for w in ws:
            if w is not None:
                _check("weight", w, w.shape, dev)
    if gcls[0][0].shape != (hidden, 2 * hidden + e):
        raise ValueError(f"edge_mlp.0.weight has shape {tuple(gcls[0][0].shape)}, "
                         f"expected {(hidden, 2 * hidden + e)}")

    lib = library()
    h_out = torch.empty_like(h)
    x_out = torch.empty_like(x)
    proj = torch.empty((b * n, 2 * hidden), device=dev, dtype=torch.float32)
    agg = torch.empty((b * n, hidden), device=dev, dtype=torch.float32)
    tmp = torch.empty((b * n, hidden), device=dev, dtype=torch.float32)
    gcl_ptrs = (ctypes.c_void_p * (10 * len(gcls)))(
        *[w.data_ptr() if w is not None else None for ws in gcls for w in ws])
    coord_ptrs = (ctypes.c_void_p * 5)(*[w.data_ptr() for w in coord])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.egnn_block_forward(
            h.data_ptr(), x.data_ptr(), x0.data_ptr(), node_mask.data_ptr(),
            h_out.data_ptr(), x_out.data_ptr(), proj.data_ptr(), agg.data_ptr(),
            tmp.data_ptr(), gcl_ptrs, coord_ptrs,
            b, n, hidden, e, cfg.inv_sublayers, int(cfg.attention),
            int(cfg.sin_embedding), int(cfg.tanh),
            int(cfg.aggregation_method == "mean"),
            float(cfg.coords_range_layer), float(cfg.norm_constant),
            float(cfg.normalization_factor), stream)
    if rc != 0:
        raise RuntimeError(f"egnn_block kernel launch failed: "
                           f"{lib.egnn_block_error_string(rc).decode()} (cudaError {rc})")
    launches += 1
    return h_out, x_out


def block_forward_plain(block, h, x, x0, node_mask):
    """Plain PyTorch version of the kernel: the module's own forward with the
    edge mask and initial distance features derived as the kernel derives
    them (``pallas_egnn.py:_reference_block``)."""
    radial0, _ = coord2diff(x0)
    e0 = sin_embedding(radial0) if block.cfg.sin_embedding else radial0
    return block(h, x, e0, node_mask, build_edge_mask(node_mask))


def block_forward(block, h, x, x0, node_mask):
    """Kernel for tensors on the card; plain version for tensors on the CPU."""
    if h.is_cuda:
        return block_forward_cuda(block, h, x, x0, node_mask)
    if h.device.type == "cpu":
        return block_forward_plain(block, h, x, x0, node_mask)
    raise ValueError(f"egnn_block: unsupported device {h.device}")
