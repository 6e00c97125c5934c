"""The port's native host-postprocess extension: build, load, call.

Counterpart of ``oar_ocr_tpu/native/__init__.py:68-105``. The source is
the port's own copy, ``csrc/db_candidates.cpp`` (CPython module
``oar_torch_native``: ``db_candidates`` and ``finalize_quads``). At first
use it is compiled with ``c++`` into ``csrc/build/`` under a name keyed
by a hash of the source, the flags and the interpreter's ABI suffix. The
compiler writes a file of its own process and ``os.replace`` moves it
into place, so processes that build at once (test workers) never see a
half-written library, and an up-to-date library is loaded as it is.

This is host code: when the extension cannot be built or loaded, the
callers take the pure-Python path of ``processors/db_postprocess.py``
(cv2 contours). The two paths need not give the same candidates (on
``tests/test_torch_rec_options.py``'s inverted page the Python path
finds one region fewer); each equals the same path of the JAX package.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import pathlib
import subprocess
import sysconfig
import threading
from typing import List, Optional, Tuple

import numpy as np

from .utils.tracing import logger

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCE = CSRC / "db_candidates.cpp"
MODULE = "oar_torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_native = None
_tried = False


def library_path() -> pathlib.Path:
    """Where the built extension for this source and interpreter lives."""
    include = sysconfig.get_paths()["include"]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    digest = hashlib.sha256(" ".join((*CXX_FLAGS, include, suffix)).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"{MODULE}-{digest.hexdigest()[:16]}{suffix}"


def _build(so: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["c++", *CXX_FLAGS, f"-I{sysconfig.get_paths()['include']}",
         str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"c++ failed (exit {proc.returncode}): "
                           f"{(proc.stdout + proc.stderr)[-2000:]}")
    os.replace(tmp, so)


def _load():
    global _native, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                so = library_path()
                if not so.exists():
                    _build(so)
                spec = importlib.util.spec_from_file_location(MODULE, so)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                _native = mod
            except (OSError, RuntimeError, ImportError) as exc:
                # host fallback, see the module docstring
                logger.warning("native DB extension unavailable, using the "
                               "Python path: %s", exc)
        return _native


def available() -> bool:
    return _load() is not None


def db_candidates(packed: np.ndarray, height: int, width: int,
                  min_size: float, max_candidates: int
                  ) -> Optional[List[Tuple[np.ndarray, float]]]:
    """Packed (H, W/8) uint8 bitmap → [(quad (4,2), min_side)], or None
    when the extension is unavailable (the caller falls back)."""
    mod = _load()
    if mod is None:
        return None
    packed = np.ascontiguousarray(packed, np.uint8)
    out = mod.db_candidates(packed.tobytes(), int(height), int(width),
                            int(packed.shape[1]), float(min_size),
                            int(max_candidates))
    return [(np.array(t[:8], np.float32).reshape(4, 2), float(t[8]))
            for t in out]


def finalize_quads(minis: np.ndarray, unclip_ratio: float, min_size: float,
                   width_scale: float, height_scale: float,
                   dest_w: int, dest_h: int) -> Optional[np.ndarray]:
    """Batched score-independent finalize of (N, 4, 2) f32 mini-boxes
    (unclip → expand → re-min-area-rect → order → scale+round+clamp) →
    (N, 9) f32: 8 ordered coords + valid flag; None when the extension is
    unavailable."""
    mod = _load()
    if mod is None:
        return None
    minis = np.ascontiguousarray(minis, np.float32)
    n = int(minis.shape[0])
    out = mod.finalize_quads(minis.tobytes(), n, float(unclip_ratio),
                             float(min_size), float(width_scale),
                             float(height_scale), int(dest_w), int(dest_h))
    return np.frombuffer(out, np.float32).reshape(n, 9)
