"""ctypes binding for the native C++ GEOM conformer extractor (the port's
own binding of ``native/geom_extract.cpp``; the role of
``geoldm_tpu/data/native_geom.py``).

Host code, not a device kernel. The streaming C++ parser never holds the
multi-gigabyte crude msgpack dump in memory, and writes what
``data.geom.extract_conformers`` (the Python path, and the reference for
its outputs) writes. The source is built with ``g++`` at first use into
``geoldm_tpu_torch/_build/`` as ``geom_extract-<hash>.so``, the hash taken
over the source and the flags, as ``evalsuite.native`` names its library.
When ``g++`` or the source is missing, ``available()`` is False.
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
from typing import Optional

from geoldm_tpu_torch.data.geom import conformer_files

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "geom_extract.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
# Filled on the first load: the library's path and whether it was cached.
build_info: dict = {}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"geom_extract-{h.hexdigest()[:16]}.so"


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
    fn = lib.geom_extract_conformers
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_char_p,                  # msgpack_path
        ctypes.c_char_p,                  # out_npy_path
        ctypes.c_char_p,                  # out_counts_path
        ctypes.c_char_p,                  # out_smiles_path
        ctypes.c_int64,                   # conformations
        ctypes.c_int32,                   # remove_h
        ctypes.POINTER(ctypes.c_int64),   # out_rows
        ctypes.POINTER(ctypes.c_int64),   # out_mols
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


def extract_conformers_native(data_dir: str, data_file: str = "drugs_crude.msgpack",
                              conformations: int = 30, remove_h: bool = False) -> str:
    """The C++ counterpart of ``geom.extract_conformers``: the same files
    (geom_drugs_[no_h_]{K}.npy, geom_drugs_n_{tag}.npy,
    geom_drugs_smiles.txt); returns the .npy path."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native GEOM extractor is unavailable (g++ and {SOURCE} are "
                           "needed to build it)")
    save_file, counts_file, smiles_file = conformer_files(data_dir, conformations, remove_h)
    src = os.path.join(data_dir, data_file)
    rows, mols = ctypes.c_int64(0), ctypes.c_int64(0)
    rc = lib.geom_extract_conformers(src.encode(), save_file.encode(), counts_file.encode(),
                                     smiles_file.encode(), ctypes.c_int64(conformations),
                                     ctypes.c_int32(1 if remove_h else 0), ctypes.byref(rows),
                                     ctypes.byref(mols))
    if rc != 0:
        raise RuntimeError(f"native geom extraction failed (code {rc}) on {src}")
    print(f"native extractor: {mols.value} conformers, {rows.value} atom rows")
    return save_file
