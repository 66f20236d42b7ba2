"""ctypes binding for the native C++ stability batch (the port's own binding
of ``native/stability.cpp``; the role of ``geoldm_tpu/evalsuite/native.py``).

This is host code, not a device kernel: generated molecules are scored on
the CPU. The source is built with ``g++`` at first use into
``geoldm_tpu_torch/_build/`` as ``stability-<hash>.so``, the hash taken over
the source and the flags (as ``ops.cuda_build`` names the kernel libraries),
so an edited source is rebuilt and a stale library is never loaded. When
``g++`` or the source is missing, ``available()`` is False and
``evalsuite.analyze`` runs the numpy path instead, and says so.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from geoldm_tpu_torch.evalsuite import bond_analyze as ba

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "stability.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
# Filled on the first load: the library's path and whether it was cached.
build_info: dict = {}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"stability-{h.hexdigest()[:16]}.so"


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    cxx = shutil.which("g++")
    if cxx is None or not SOURCE.exists():
        _build_failed = True
        return None
    path = library_path()
    cached = path.exists()
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            os.unlink(tmp)
            _build_failed = True
            return None
        os.replace(tmp, path)  # atomic: a concurrent build never sees a partial file
    lib = ctypes.CDLL(str(path))
    fn = lib.check_stability_batch
    fn.restype = None
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float),   # positions
        ctypes.POINTER(ctypes.c_int32),   # atom_types
        ctypes.POINTER(ctypes.c_int32),   # n_atoms
        ctypes.c_int64,                   # n_mols
        ctypes.c_int64,                   # max_n
        ctypes.POINTER(ctypes.c_double),  # thr1
        ctypes.POINTER(ctypes.c_double),  # thr2
        ctypes.POINTER(ctypes.c_double),  # thr3
        ctypes.c_int64,                   # s
        ctypes.POINTER(ctypes.c_int32),   # allowed
        ctypes.c_int64,                   # max_allowed
        ctypes.POINTER(ctypes.c_int32),   # out_stable_atoms
        ctypes.POINTER(ctypes.c_int32),   # out_total_atoms
        ctypes.POINTER(ctypes.c_int32),   # out_mol_stable
    ]
    build_info.update(path=str(path), cached=cached)
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            _lib = _build()
    return _lib


def available() -> bool:
    return get_lib() is not None


def _as_ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def check_stability_batch(positions: np.ndarray, atom_types: np.ndarray, n_atoms: np.ndarray,
                          dataset_info) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched stability check. positions [M, N, 3] (Angstrom, padded),
    atom_types [M, N] int, n_atoms [M] int ->
    (stable_atoms [M], total_atoms [M], mol_stable [M] bool)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native stability library is unavailable (g++ and {SOURCE} "
                           "are needed to build it)")
    decoder = tuple(dataset_info["atom_decoder"])
    thr1, thr2, thr3 = (np.ascontiguousarray(t, dtype=np.float64)
                        for t in ba.threshold_matrices(decoder))
    allowed = ba.allowed_bond_table(decoder)
    max_allowed = max(len(a) for a in allowed)
    allowed_arr = np.full((len(decoder), max_allowed), -1, dtype=np.int32)
    for i, vals in enumerate(allowed):
        allowed_arr[i, :len(vals)] = vals

    positions = np.ascontiguousarray(positions, dtype=np.float32)
    atom_types = np.ascontiguousarray(atom_types, dtype=np.int32)
    n_atoms = np.ascontiguousarray(n_atoms, dtype=np.int32)
    m = positions.shape[0]
    out_stable = np.zeros(m, dtype=np.int32)
    out_total = np.zeros(m, dtype=np.int32)
    out_mol = np.zeros(m, dtype=np.int32)
    lib.check_stability_batch(
        _as_ptr(positions, ctypes.c_float), _as_ptr(atom_types, ctypes.c_int32),
        _as_ptr(n_atoms, ctypes.c_int32), ctypes.c_int64(m), ctypes.c_int64(positions.shape[1]),
        _as_ptr(thr1, ctypes.c_double), _as_ptr(thr2, ctypes.c_double),
        _as_ptr(thr3, ctypes.c_double), ctypes.c_int64(len(decoder)),
        _as_ptr(allowed_arr, ctypes.c_int32), ctypes.c_int64(max_allowed),
        _as_ptr(out_stable, ctypes.c_int32), _as_ptr(out_total, ctypes.c_int32),
        _as_ptr(out_mol, ctypes.c_int32))
    return out_stable, out_total, out_mol.astype(bool)
