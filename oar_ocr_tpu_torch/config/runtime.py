"""Static-shape bucket tables, the device mesh and the host parallelism
policy.

The port's copies from ``oar_ocr_tpu/config/runtime.py``, line for line:
``BucketTable`` and ``pow2_buckets`` (:23-62; ``core/batch.py`` and
``runtime/runtime.py`` use them) and ``ParallelPolicy`` (:225-239;
``utils/image.load_images``). ``MeshConfig`` (:85-127) keeps the JAX
axes, shape carving and ``ConfigError``s over a list of
``torch.device``s (``parallel/mesh.py``). ``RuntimeConfig`` keeps only
the mesh policy, ``use_mesh`` and ``mesh`` (:145-153), and their two env
overrides, ``OAR_TPU_MESH`` and ``OAR_TPU_TP`` (:212-213, 219-221); the
compute dtype and the device are ``Runtime``'s own arguments, the bucket
tables are in ``runtime/runtime.py``, and the remote link's switches are
not ported (ROADMAP item 11).
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

from ..errors import ConfigError
from .validation import Rule


@dataclass(frozen=True)
class BucketTable:
    """Sorted static-shape buckets with recompile-on-miss semantics.

    Every distinct padded shape is one compiled executable; the table bounds
    the compile count while limiting padding waste. Replaces the reference's
    per-batch ad-hoc pad-to-max (core/batch/mod.rs:215-453) and
    ``AspectRatioBucketing`` (processors/aspect_ratio_bucketing.rs:15-147).
    """

    sizes: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "sizes", tuple(sorted(set(int(s) for s in self.sizes))))
        if not self.sizes:
            raise ValueError("BucketTable needs at least one size")

    def bucket(self, value: int) -> int:
        """Smallest bucket >= value; the largest bucket if none fits."""
        for s in self.sizes:
            if value <= s:
                return s
        return self.sizes[-1]

    def bucket_index(self, value: int) -> int:
        for i, s in enumerate(self.sizes):
            if value <= s:
                return i
        return len(self.sizes) - 1


def pow2_buckets(lo: int, hi: int) -> BucketTable:
    """Power-of-two buckets in [lo, hi] (decoder_graph.rs:14 KV buckets)."""
    sizes = []
    s = lo
    while s < hi:
        sizes.append(s)
        s *= 2
    sizes.append(hi)
    return BucketTable(tuple(sizes))


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (``config/runtime.py:85-127``): the pipelines
    shard the page/crop batch axis over ``data``; ``n_model`` > 1 adds a
    trailing ``model`` axis of that size for the tensor parallelism of
    the VLM decoders (``parallel/tp.py``), the other devices forming the
    ``data`` axis. ``OAR_TPU_TP`` overrides ``n_model``."""

    axes: Tuple[str, ...] = ("data",)
    shape: Optional[Tuple[int, ...]] = None  # None → every device on axis 0
    n_model: int = 1

    def build(self, devices: Optional[Sequence] = None):
        """The mesh over ``devices`` (``torch.device``s, a device may
        repeat), by default every visible CUDA card
        (``parallel.mesh.visible_devices``)."""
        from ..parallel.mesh import Mesh, visible_devices

        devices = list(devices) if devices is not None else visible_devices()
        axes = self.axes
        if self.n_model > 1 and "model" not in axes:
            axes = axes + ("model",)
        shape = self.shape
        if shape is not None and len(shape) < len(axes):
            # an explicit shape was written against self.axes; carve the
            # appended model axis out of the leading (data) dimension
            if shape[0] % self.n_model:
                raise ConfigError(
                    "n_model must divide the explicit mesh shape's "
                    "data dimension", n_model=self.n_model, shape=shape)
            shape = ((shape[0] // self.n_model,) + tuple(shape[1:])
                     + (self.n_model,))
        if shape is None:
            if self.n_model > 1:
                if len(devices) % self.n_model:
                    raise ConfigError(
                        "n_model must divide the device count",
                        n_model=self.n_model, devices=len(devices))
                shape = ((len(devices) // self.n_model,)
                         + (1,) * (len(axes) - 2) + (self.n_model,))
            else:
                shape = (len(devices),) + (1,) * (len(axes) - 1)
        if math.prod(shape) != len(devices):
            # the JAX reshape of every device to the shape refuses it too
            raise ConfigError("the mesh shape must hold every device",
                              shape=tuple(shape), devices=len(devices))
        return Mesh.of(devices, shape, axes)


@dataclass(frozen=True)
class RuntimeConfig:
    """The mesh policy of a ``Runtime`` (``config/runtime.py:145-153``):
    ``use_mesh`` None builds a data-parallel mesh exactly when more than
    one CUDA card is visible; True/False force it. ``from_env`` applies
    ``OAR_TPU_MESH`` (any value but "0" or empty turns the mesh on) and
    ``OAR_TPU_TP`` (the mesh's ``n_model``)."""

    mesh: MeshConfig = field(default_factory=MeshConfig)
    use_mesh: Optional[bool] = None

    @staticmethod
    def from_env(base: "RuntimeConfig" | None = None) -> "RuntimeConfig":
        cfg = base or RuntimeConfig()
        updates = {}
        if os.environ.get("OAR_TPU_MESH") is not None:
            updates["use_mesh"] = os.environ["OAR_TPU_MESH"] not in ("0", "")
        if os.environ.get("OAR_TPU_TP"):
            updates["mesh"] = dataclasses.replace(
                cfg.mesh, n_model=int(os.environ["OAR_TPU_TP"]))
        return dataclasses.replace(cfg, **updates) if updates else cfg


@dataclass(frozen=True)
class ParallelPolicy:
    """Host-side parallelism thresholds (core/config/parallel.rs:11-27).

    The reference gates rayon by element counts; we gate the host thread pool
    used for image decode / geometry the same way.
    """

    min_elements: int = 1 << 20  # ~1 MiB of pixels before threading
    max_workers: int = 8

    RULES = {
        "min_elements": Rule(min=0),
        "max_workers": Rule(min=1, max=256),
    }
