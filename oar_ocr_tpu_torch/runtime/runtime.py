"""Runtime: the device, the dtype policy, bucket tables, transfers and
the device mesh.

Counterpart of ``oar_ocr_tpu/runtime/runtime.py`` and
``oar_ocr_tpu/config/runtime.py``. Kept: the device placement, the
compute dtype (``config/runtime.py:135,187``: bfloat16 by default, or
float32), ``put_pages`` (stack, pad and upload a uint8 NHWC page batch),
the bucket tables and the mesh (``runtime.py:72-85, 442-540``). Left
out, because they exist for the TPU's remote link: the link thread, the
bandwidth EMAs, the recovery probes (``runtime.py:158-430``) and the
config's kill switches.

The mesh (``parallel/mesh.py``): ``RuntimeConfig.use_mesh`` None builds
a data-parallel mesh exactly when more than one CUDA card is visible,
as the JAX Runtime does for real chips (``runtime.py:76-81``); True or
``OAR_TPU_MESH=1`` forces one over ``devices`` (every visible card by
default; a list that repeats a device gives several shards on it, as the
CPU tests' eight ``cpu`` devices do). ``MeshConfig.n_model`` /
``OAR_TPU_TP`` add the ``model`` axis of the VLM decoders' tensor
parallelism (``put_params_vl``). The primary device, ``device``, is the
mesh's first: uploads (``put``) land there, as do the outputs a stage
gathers. :meth:`Runtime.run_sharded` is the counterpart of
``shard_jit``: one call a ``data`` shard, each on its device with that
device's replica of the model, queued from the one host thread with no
sync between the devices.

The bucket tables are copied value for value from
``config/runtime.py:71-82``. They are not only a compile-count bound on
the TPU: they decide the padded shapes the models see, and the SE blocks
average over the whole padded map and SVTR attends over padded
timesteps, so the port pads to the same buckets to give the same numbers.

Device→host fetches start at dispatch time (:class:`HostFetch`): a
non-blocking copy into pinned memory plus a CUDA event on the tensor's
card, joined at collect — the counterpart of the JAX package's
``copy_to_host_async`` + link thread, so a collect waits only for the
work it reads, not for later batches queued behind it on the stream.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config.runtime import BucketTable, RuntimeConfig
from ..errors import ConfigError
from ..parallel.mesh import (Sharded, copy_to, on_device, replicate,
                             split_rows, visible_devices)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

DET_SIDE_BUCKETS = BucketTable((320, 640, 704, 960, 1280, 1600, 1920, 2560, 3200, 4000))
REC_WIDTH_BUCKETS = BucketTable((160, 320, 480, 640, 960, 1280, 1920, 2560, 3200))
REC_BATCH_BUCKETS = BucketTable((8, 16, 32, 64, 128))
DET_BATCH_BUCKETS = BucketTable((1, 2, 4, 8, 16))
REC_NATIVE_H_BUCKETS = BucketTable((32, 48, 96, 192))
REC_NATIVE_W_BUCKETS = BucketTable((160, 320, 640, 768, 960, 1280, 1920))


class HostFetch:
    """A device→host copy in flight; ``result()`` waits and returns numpy.
    A :class:`~oar_ocr_tpu_torch.parallel.mesh.Sharded` batch is fetched
    shard by shard, each from its own card, and joined on the host."""

    def __init__(self, tensor: Union[torch.Tensor, Sharded]):
        shards = (tensor.shards if isinstance(tensor, Sharded)
                  else [tensor])
        self._parts = []
        for t in shards:
            if t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(t.device))
            else:
                host, event = t, None
            self._parts.append((host, event))

    def result(self) -> np.ndarray:
        for _, event in self._parts:
            if event is not None:
                event.synchronize()
        if len(self._parts) == 1:
            return self._parts[0][0].numpy()
        return np.concatenate([h.numpy() for h, _ in self._parts], 0)


class Runtime:
    """Device placement, dtype policy and mesh for one pipeline.

    TF32 is turned off for the whole process when a Runtime is made. The
    JAX package computes the resize and warp products in f32 at
    ``Precision.HIGHEST`` (``det_device.py:77-84``, ``warp.py:276-306``)
    and its float32 policy runs convolutions in full f32; on Hopper, cuDNN
    convolutions default to TF32 (``torch.backends.cudnn.allow_tf32``), so
    both flags are set off here. A bfloat16 Runtime sets them too: its
    resize and warp products still run in float32.

    ``device`` defaults to the CUDA card. Without a visible card that
    raises ``ConfigError``: the CPU runs only when asked for by
    ``device="cpu"``, never as a silent fallback. ``cfg`` sets the mesh
    policy (``RuntimeConfig.from_env`` applies the env overrides) and
    ``devices`` the mesh's devices (default: every visible card for a
    CUDA ``device``, from a named card such as ``cuda:1`` on, and the one
    CPU for ``"cpu"``). A named device must lead the mesh, else
    ``ConfigError``.
    """

    def __init__(self, compute_dtype: str = "bfloat16",
                 device: torch.device | str = "cuda", *,
                 cfg: Optional[RuntimeConfig] = None,
                 devices: Optional[Sequence] = None):
        if compute_dtype not in _DTYPES:
            raise ConfigError("compute_dtype must be bfloat16 or float32",
                              compute_dtype=compute_dtype)
        self.compute_dtype = _DTYPES[compute_dtype]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise ConfigError("no CUDA device is visible; pass "
                              "device=\"cpu\" to run on the CPU",
                              device=str(self.device))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = RuntimeConfig.from_env(cfg)
        want = self.cfg.use_mesh
        if want is None:
            # auto-on for more than one real card only; a device list
            # that repeats a device must opt in
            want = (self.device.type == "cuda"
                    and torch.cuda.device_count() > 1)
        if devices is None:
            devices = (visible_devices() if self.device.type == "cuda"
                       else [self.device])
            if self.device.index is not None and self.device in devices:
                # a named card leads the mesh: the visible cards from it on
                k = devices.index(self.device)
                devices = devices[k:] + devices[:k]
        self.mesh = self.cfg.mesh.build(devices) if want else None
        self.n_data = int(self.mesh.shape["data"]) if self.mesh else 1
        self.n_model = (int(self.mesh.shape.get("model", 1))
                        if self.mesh else 1)
        if self.mesh is not None:
            first = self.mesh.data_devices[0]
            if self.device.index is not None and first != self.device:
                raise ConfigError("the mesh's first device must be the "
                                  "device named", device=str(self.device),
                                  first=str(first))
            self.device = first

    @property
    def is_accelerator(self) -> bool:
        return self.device.type != "cpu"

    @property
    def data_devices(self) -> List[torch.device]:
        """The ``data`` shards' devices; the primary device alone without
        a mesh."""
        return self.mesh.data_devices if self.mesh else [self.device]

    @property
    def model_devices(self) -> List[torch.device]:
        """The ``model`` shards' devices; the primary device alone
        without a mesh."""
        return self.mesh.model_devices if self.mesh else [self.device]

    def layout(self) -> str:
        """The device layout, for a log line."""
        if self.mesh is None:
            return f"one device ({self.device})"
        return (f"mesh {self.mesh.shape}: data "
                f"{[str(d) for d in self.data_devices]}, model "
                f"{[str(d) for d in self.model_devices]}")

    def put(self, array: np.ndarray) -> torch.Tensor:
        """Upload a host array to the runtime's (primary) device. On CUDA
        the copy goes through pinned memory without blocking the host, so
        it does not wait for work already queued on the stream. A stage
        that needs it on every ``data`` device replicates it
        (:meth:`replicated`)."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def put_pages(self, images: Sequence[np.ndarray],
                  target_hw: Tuple[int, int]) -> torch.Tensor:
        """Upload variable-size HWC uint8 pages as one zero-padded
        (B, H, W, 3) uint8 batch."""
        return self.put(stack_padded(images, target_hw))

    def replicated(self, tensor: torch.Tensor) -> list:
        """``tensor`` on every ``data`` device, one entry a shard
        (``runtime.py:442-451``: the page store is replicated, so every
        per-crop gather stays on its card); ``[tensor]`` without a mesh.
        A caller that reads one batch several times keeps the copies."""
        if self.mesh is None:
            return [tensor]
        return replicate(self.mesh, tensor)

    def put_params(self, module: torch.nn.Module) -> list:
        """A model on every ``data`` device (``runtime.py:453-458``): one
        replica a shard, the shards on one device sharing it; the model
        itself without a mesh."""
        if self.mesh is None:
            return [module]
        return replicate(self.mesh, module)

    def put_params_vl(self, module: torch.nn.Module) -> list:
        """A VL network's per-``model``-shard modules
        (``runtime.py:468-478``): under ``n_model`` > 1 the parameters
        are split by ``parallel/tp.py``'s name rules (column-parallel
        q/k/v, gate/up and lm_head; row-parallel o, down and out_proj)
        and each shard's module holds its slices on its device; else
        ``[module]``."""
        if self.mesh is not None and self.n_model > 1:
            from ..parallel.tp import partition_module

            return partition_module(module, self.mesh)
        return [module]

    def require_one_model_shard(self, what: str) -> None:
        """Raise ``ConfigError`` under ``n_model`` > 1 for a model whose
        tensor-parallel form is still to come (the JAX Runtime shards
        every VL tree it places; ROADMAP queues the rest)."""
        if self.n_model > 1:
            raise ConfigError(f"{what} has no tensor-parallel form yet; "
                              "the families' greedy generate has",
                              n_model=self.n_model)

    def round_batch(self, nb: int) -> int:
        """Round a batch bucket up to a multiple of the data-axis size so
        the leading axis shards evenly (``runtime.py:480-484``)."""
        n = self.n_data
        return nb if nb % n == 0 else ((nb + n - 1) // n) * n

    def pad_batch(self, *arrays):
        """Pad every array's leading axis to ``round_batch`` size by
        repeating row 0 (identity without a mesh). Returns the padded
        arrays; slice device outputs back with the original length."""
        n = arrays[0].shape[0]
        nb = self.round_batch(n)
        if nb == n:
            return arrays
        pad = nb - n
        return tuple(np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
                     for a in arrays)

    def run_sharded(self, fn: Callable, replicas: Sequence, batch: Sequence,
                    *, out_spec="data"):
        """``fn(replica, *batch_shard)`` once a ``data`` shard,
        each under its device with ``replicas`` (one a shard,
        :meth:`put_params` / :meth:`replicated`) — the counterpart of
        ``shard_jit`` (``runtime.py:501-540``). ``batch``: tensors or
        arrays whose leading axis (``round_batch``-ed) splits over the
        shards. ``out_spec``: "data" (a ``Sharded``, each shard
        where it was computed) or "replicated" (gathered on the primary
        device), or a tuple of those for a tuple of outputs. The shards
        are queued from this thread without a sync between the devices;
        without a mesh it is ``fn(replicas[0], *batch)``."""
        if self.mesh is None:
            return fn(replicas[0], *batch)
        devs = self.data_devices
        rows = split_rows(batch[0].shape[0], len(devs))
        outs = []
        for rep, dev, sl in zip(replicas, devs, rows):
            with on_device(dev):
                outs.append(fn(rep, *(copy_to(b[sl], dev) for b in batch)))
        single = not isinstance(outs[0], tuple)
        specs = (out_spec,) if isinstance(out_spec, str) else out_spec
        cols = [[o] if single else list(o) for o in outs]
        merged = []
        for i, spec in enumerate(specs):
            sharded = Sharded([c[i] for c in cols])
            merged.append(sharded if spec == "data"
                          else sharded.gather(self.device))
        return merged[0] if single else tuple(merged)


def stack_padded(images, target_hw: Tuple[int, int]) -> np.ndarray:
    """Stack variable-size HWC uint8 images into (N, H, W, C) zero-padded
    (``runtime/runtime.py:671``)."""
    n = len(images)
    h, w = target_hw
    c = images[0].shape[2] if images[0].ndim == 3 else 1
    out = np.zeros((n, h, w, c), dtype=np.uint8)
    for i, img in enumerate(images):
        ih, iw = img.shape[:2]
        out[i, :ih, :iw] = img if img.ndim == 3 else img[..., None]
    return out
