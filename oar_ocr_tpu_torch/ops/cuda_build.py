"""Build the hand-written CUDA sources under ``csrc/`` with nvcc.

Each kernel source has a plain C interface and is compiled for sm_90a
into its own shared library, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). The library lands in ``csrc/build/`` under a
name keyed by a hash of the sources and flags, so a rerun with unchanged
sources loads the existing file instead of rebuilding. ``nvcc``'s output,
including ``-Xptxas -v``'s register and spill report, is kept beside it
as ``<library>.log``. Sources build independently, so :func:`build_all`
starts one nvcc per source at once.

A failed build raises: nothing falls back to a plain version.

Every binding registers itself in :data:`KERNELS`, so a CUDA graph's
capture can tell which launches it recorded (:class:`CapturedLaunches`):
a launch made while a stream is captured only records the kernel, and
it runs at each replay, so the counts follow what runs.

A launch runs under its tensors' device (``CudaKernel.launch(...,
device=)``): each library links its own static CUDA runtime, whose
``<<<…>>>`` launches and ``cudaGetDevice`` follow the host thread's
current context, which is card 0's unless something sets it. The
``torch.cuda.device`` guard makes the card of the tensors current for
the call, so a kernel on a ``cuda:1`` tensor launches on card 1 with
card 1's stream, and the state a library keeps per card (K2's raised
shared-memory limit, K3's SM count) is read for that card. The launches
are counted per card too (``launches_by_device``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from collections import Counter
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()


@dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: pathlib.Path
    log: pathlib.Path
    build_seconds: float      # 0.0 when an up-to-date library was reused


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); "
                       "the CUDA kernels are built from csrc/ at first use")


def build_library(name: str, sources: Sequence[str]) -> BuiltLibrary:
    """Compile ``sources`` (paths relative to ``csrc/``) into
    ``csrc/build/lib<name>-<hash>.so`` unless it exists, and load it."""
    srcs = [CSRC / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    log = so.with_suffix(".log")
    seconds = 0.0
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)],
                capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log.write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {name} (exit {proc.returncode}):"
                    f"\n{(proc.stdout + proc.stderr)[-4000:]}")
            os.replace(tmp, so)
    return BuiltLibrary(ctypes.CDLL(str(so)), so, log, seconds)


# every binding, in the order the modules made them
KERNELS: List["CudaKernel"] = []


class CudaKernel:
    """ctypes binding of one ``csrc/`` source whose plain C entry point
    returns the launch's ``cudaError_t``. Built at first use; ``launches``
    counts successful launches, ``launches_by_device`` the same by card
    index, and a failed launch raises."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name, self.source, self.symbol = name, source, symbol
        self.replaces = replaces
        self._argtypes = list(argtypes)
        self.launches = 0
        self.launches_by_device: Counter = Counter()
        self._built: Optional[BuiltLibrary] = None
        KERNELS.append(self)

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_device.clear()

    def build(self) -> BuiltLibrary:
        if self._built is None:
            built = build_library(self.name, [self.source])
            fn = getattr(built.lib, self.symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._built = built
        return self._built

    def launch(self, *args, device, what: str) -> None:
        """Call the entry point with ``device`` (a CUDA ``torch.device``
        with its index, the tensors') current; ``what`` describes the
        call for the error raised when the launch fails."""
        import torch

        fn = getattr(self.build().lib, self.symbol)
        with torch.cuda.device(device):
            rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed "
                               f"(cudaError {rc}, {what}, {device})")
        self.launches += 1
        self.launches_by_device[device.index] += 1


class CapturedLaunches:
    """The kernel launches one CUDA graph holds. Wrap the capture in
    :meth:`recording`: the launches the wrappers counted inside it were
    recorded into the graph, not run, so they are taken back from each
    kernel's count and kept; :meth:`replayed` adds them once per replay,
    when they run."""

    def __init__(self):
        self.counts: Dict[CudaKernel, int] = {}
        self.by_device: Dict[CudaKernel, Counter] = {}

    @contextmanager
    def recording(self) -> Iterator["CapturedLaunches"]:
        before = [(k.launches, Counter(k.launches_by_device))
                  for k in KERNELS]
        try:
            yield self
        finally:
            for k, (n, by_dev) in zip(KERNELS, before):
                if k.launches != n:
                    self.counts[k] = self.counts.get(k, 0) + k.launches - n
                    self.by_device.setdefault(k, Counter()).update(
                        k.launches_by_device - by_dev)
                    k.launches = n
                    k.launches_by_device = by_dev

    def replayed(self) -> None:
        for k, n in self.counts.items():
            k.launches += n
            k.launches_by_device.update(self.by_device.get(k, Counter()))


def build_all(kernels: Sequence[CudaKernel]) -> List[BuiltLibrary]:
    """Build every kernel at once, one nvcc process per source."""
    with ThreadPoolExecutor(max_workers=max(1, len(kernels))) as pool:
        return list(pool.map(lambda k: k.build(), kernels))
