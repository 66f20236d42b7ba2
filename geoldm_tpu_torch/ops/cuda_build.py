"""Build and load the port's hand-written CUDA kernels.

Each source in ``geoldm_tpu_torch/csrc`` is compiled from the checkout with
``nvcc`` for ``sm_90a`` at first use, one ``nvcc`` per source, all started
together, into ``geoldm_tpu_torch/_build/`` (one shared library per source,
named by the hash of every source, header and flag), and loaded with
``ctypes``. Every library exposes a plain C interface; ``library(name)``
returns it with its functions' argument types set.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = {"egnn_block": CSRC / "egnn_block.cu", "egnn_block_bwd": CSRC / "egnn_block_bwd.cu",
           "egnn_block_lowp": CSRC / "egnn_block_lowp.cu",
           "egnn_block_bwd_lowp": CSRC / "egnn_block_bwd_lowp.cu",
           "egnn_tiled": CSRC / "egnn_tiled.cu", "egnn_tiled_bwd": CSRC / "egnn_tiled_bwd.cu",
           "egnn_sp": CSRC / "egnn_sp.cu", "fused_optim": CSRC / "fused_optim.cu"}
HEADERS = (CSRC / "egnn_common.cuh", CSRC / "egnn_bwd_common.cuh", CSRC / "egnn_tile.cuh",
           CSRC / "egnn_tc_gemm.cuh", CSRC / "egnn_block_tile.cuh", CSRC / "egnn_block_bwd.cuh",
           CSRC / "egnn_rows.cuh", CSRC / "egnn_rows_bwd.cuh")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t
_STR = ctypes.c_char_p
# library -> {function: (argtypes, restype)}
_SIGNATURES = {
    "egnn_block": {
        "egnn_block_forward": ([_P] * 12 + [_I] * 9 + [_F] * 3 + [_P], _I),
        "egnn_block_forward_bf16": ([_P] * 13 + [_I] * 9 + [_F] * 3 + [_P], _I),
        "egnn_block_error_string": ([_I], _STR),
    },
    "egnn_block_bwd": {
        "egnn_block_backward": ([_P] * 15 + [_I] * 9 + [_F] * 3 + [_P], _I),
        "egnn_block_backward_bf16": ([_P] * 15 + [_I] * 9 + [_F] * 3 + [_P], _I),
        "egnn_block_backward_scratch_floats": ([_I] * 7, _Z),
        "egnn_node_gemm": ([_P] * 11 + [_I] * 16 + [_Z, _P], _I),
        "egnn_node_gemm_plan": ([_I] * 4 + [_Z, _I, ctypes.POINTER(_I)], _I),
        "egnn_block_bwd_error_string": ([_I], _STR),
    },
    "egnn_block_lowp": {
        "egnn_block_forward_lowp": ([_P] * 13 + [_I] * 9 + [_F] * 3 + [_P], _I),
        "egnn_block_error_string": ([_I], _STR),
    },
    "egnn_block_bwd_lowp": {
        "egnn_block_backward_lowp": ([_P] * 15 + [_I] * 9 + [_F] * 3 + [_P], _I),
        "egnn_block_bwd_error_string": ([_I], _STR),
    },
    "egnn_tiled": {
        "egnn_gcl_rows": ([_P] * 10 + [_I] * 7 + [_F] * 2 + [_P], _I),
        "egnn_coord_rows": ([_P] * 7 + [_I] * 7 + [_F] * 3 + [_P], _I),
        "egnn_gcl_rows_bf16": ([_P] * 11 + [_I] * 7 + [_F] * 2 + [_P], _I),
        "egnn_coord_rows_bf16": ([_P] * 8 + [_I] * 7 + [_F] * 3 + [_P], _I),
        "egnn_tiled_error_string": ([_I], _STR),
    },
    "egnn_tiled_bwd": {
        "egnn_gcl_rows_backward": ([_P] * 12 + [_I] * 8 + [_F] * 2 + [_P], _I),
        "egnn_coord_rows_backward": ([_P] * 11 + [_I] * 8 + [_F] * 3 + [_P], _I),
        "egnn_gcl_rows_backward_bf16": ([_P] * 12 + [_I] * 8 + [_F] * 2 + [_P], _I),
        "egnn_coord_rows_backward_bf16": ([_P] * 11 + [_I] * 8 + [_F] * 3 + [_P], _I),
        "egnn_rows_backward_scratch_floats": ([_I] * 5, _Z),
        "egnn_wgrad_splits": ([_I, _I, ctypes.POINTER(_I)], _I),
        "egnn_tiled_bwd_error_string": ([_I], _STR),
    },
    "egnn_sp": {
        "egnn_sp_gcl_rows": ([_P] * 14 + [_I] * 10 + [_F] * 2 + [_P], _I),
        "egnn_sp_coord_rows": ([_P] * 11 + [_I] * 10 + [_F] * 3 + [_P], _I),
        "egnn_sp_gcl_rows_backward": ([_P] * 19 + [_I] * 11 + [_F] * 2 + [_P], _I),
        "egnn_sp_coord_rows_backward": ([_P] * 18 + [_I] * 11 + [_F] * 3 + [_P], _I),
        "egnn_sp_gcl_rows_bf16": ([_P] * 15 + [_I] * 10 + [_F] * 2 + [_P], _I),
        "egnn_sp_coord_rows_bf16": ([_P] * 12 + [_I] * 10 + [_F] * 3 + [_P], _I),
        "egnn_sp_gcl_rows_backward_bf16": ([_P] * 19 + [_I] * 11 + [_F] * 2 + [_P], _I),
        "egnn_sp_coord_rows_backward_bf16": ([_P] * 18 + [_I] * 11 + [_F] * 3 + [_P], _I),
        "egnn_sp_backward_scratch_floats": ([_I] * 6, _Z),
        "egnn_sp_error_string": ([_I], _STR),
    },
    "fused_optim": {
        "fused_optim_layout": ([ctypes.POINTER(_I)], _I),
        "fused_optim_norm": ([_P] * 2 + [_I] * 3 + [_P, _I, _P, _I, _P, _I, _P, _P], _I),
        "fused_optim_threshold": ([_P] * 3 + [_I] * 3 + [_P] * 3, _I),
        "fused_optim_update": ([_P] * 2 + [_I] * 3 + [_P, _I, _P] + [_F] * 9 + [_I, _P], _I),
        "fused_optim_error_string": ([_I], _STR),
    },
}

# Filled on the first load: wall seconds of the (parallel) build, whether it
# was cached, and per library its path and ptxas log.
build_info: dict = {}

_libs: dict = {}
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels "
                       "are built from geoldm_tpu_torch/csrc at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(list(SOURCES.values()) + list(HEADERS)):
        h.update(path.name.encode() + path.read_bytes())
    return h.hexdigest()[:16]


def _build_all() -> dict:
    """Build every missing library, one nvcc per source, all at once."""
    digest = _digest()
    paths = {name: BUILD_DIR / f"{name}-{digest}.so" for name in SOURCES}
    todo = [name for name, p in paths.items() if not p.exists()]
    t0 = time.perf_counter()
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed building {SOURCES[name].name}:\n{err}")
                continue
            paths[name].with_suffix(".log").write_text(out + err)
            os.replace(tmp, paths[name])  # atomic: a concurrent build never sees a partial file
        if failed:
            raise RuntimeError("\n".join(failed))
    build_info.update(seconds=time.perf_counter() - t0, cached=not todo, libs={
        name: {"path": str(p), "log": p.with_suffix(".log").read_text()
               if p.with_suffix(".log").exists() else ""} for name, p in paths.items()})
    return paths


def build() -> None:
    """Build (if needed) and load every kernel library of ``SOURCES``: a
    parent calls it once before it spawns ranks, so that they do not each
    run nvcc."""
    library(next(iter(SOURCES)))


def library(name: str) -> ctypes.CDLL:
    """Build (if needed) every kernel library and return ``name``'s."""
    with _lib_lock:
        if not _libs:
            paths = _build_all()
            for lib_name, fns in _SIGNATURES.items():
                lib = ctypes.CDLL(str(paths[lib_name]))
                for fn_name, (argtypes, restype) in fns.items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes, fn.restype = argtypes, restype
                _libs[lib_name] = lib
    return _libs[name]
