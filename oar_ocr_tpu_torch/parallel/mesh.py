"""Device mesh over ``torch.device``s, and the split, copy and gather of
batches and modules over it.

Counterpart of ``oar_ocr_tpu/parallel/mesh.py``. The JAX package's mesh
is one program that XLA partitions; here one host thread drives a list
of devices, as the JAX single controller does, and the partitioning is
explicit:

- a :class:`Mesh` is an array of ``torch.device``s with named axes,
  ``data`` first and ``model`` last (``build_mesh`` always makes both);
- :func:`shard_batch` splits a batch's leading axis over the ``data``
  devices into a :class:`Sharded` (JAX's ``data_sharding``);
- :func:`replicate` copies a tensor, an array or an ``nn.Module`` to
  every ``data`` device (JAX's ``replicated``): one copy a distinct
  device, shared by the shards that lie on it;
- :meth:`Sharded.gather` concatenates the shards on one device.

A device list may repeat a device: a list of eight ``cpu`` devices is
the CPU tests' counterpart of the JAX tests' eight virtual devices, and
``[cuda:0, cuda:0]`` puts two shards on one card. Such a list is only
ever given explicitly; the default is every visible CUDA card.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import ConfigError


def visible_devices() -> List[torch.device]:
    """Every visible CUDA card, in index order."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise ConfigError("no CUDA device is visible; give the mesh its "
                          "devices (e.g. [torch.device('cpu')] * 8)")
    return [torch.device("cuda", i) for i in range(n)]


def on_device(device: torch.device):
    """The device guard of ``device``: ``torch.cuda.device`` for a card,
    nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class Mesh:
    """An n-d array of ``torch.device``s with one name an axis."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ConfigError("one axis name a mesh dimension",
                              shape=devices.shape, axes=axis_names)
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @classmethod
    def of(cls, devices: Sequence, shape: Sequence[int],
           axes: Sequence[str]) -> "Mesh":
        """The leading prod(shape) of ``devices`` in ``shape``."""
        n = int(np.prod(shape))
        if n > len(devices) or n < 1:
            raise ConfigError("the mesh shape needs more devices than given",
                              shape=tuple(shape), devices=len(devices))
        arr = np.empty((n,), dtype=object)
        for i, d in enumerate(list(devices)[:n]):
            arr[i] = torch.device(d)
        return cls(arr.reshape(tuple(shape)), tuple(axes))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def _axis(self, name: str) -> List[torch.device]:
        """The devices along axis ``name`` at index 0 of every other."""
        if name not in self.axis_names:
            return [self.devices.flat[0]]
        a = self.axis_names.index(name)
        index = tuple(slice(None) if i == a else 0
                      for i in range(self.devices.ndim))
        return list(self.devices[index])

    @property
    def data_devices(self) -> List[torch.device]:
        """The ``data`` shards' devices, one a shard (at model index 0)."""
        return self._axis("data")

    @property
    def model_devices(self) -> List[torch.device]:
        """The ``model`` shards' devices (at data index 0)."""
        return self._axis("model")


def build_mesh(n_data: Optional[int] = None, n_model: int = 1,
               devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible CUDA
    card); ``n_data`` None takes every device that fits."""
    devs = list(devices) if devices is not None else visible_devices()
    if n_data is None:
        n_data = len(devs) // n_model
    return Mesh.of(devs, (n_data, n_model), ("data", "model"))


class Sharded:
    """A batch split along its leading axis: ``shards[i]`` on its own
    device, in batch order."""

    def __init__(self, shards: Sequence[torch.Tensor]):
        self.shards = list(shards)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (sum(s.shape[0] for s in self.shards),) + tuple(
            self.shards[0].shape[1:])

    def gather(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole batch on ``device`` (default: the first shard's).
        Copies between cards are queued on the streams, not waited for."""
        device = self.shards[0].device if device is None else device
        return torch.cat([s.to(device, non_blocking=True)
                          for s in self.shards], 0)


def split_rows(n: int, parts: int) -> List[slice]:
    """``parts`` equal slices of ``n`` rows (``n`` a multiple of
    ``parts``: ``Runtime.round_batch``)."""
    if n % parts:
        raise ConfigError("a sharded batch must divide evenly over the "
                          "data axis; round it with Runtime.round_batch",
                          batch=n, shards=parts)
    per = n // parts
    return [slice(i * per, (i + 1) * per) for i in range(parts)]


def to_device(x, device: torch.device):
    """A tensor or a numpy array on ``device``; a non-blocking copy (the
    host does not wait for queued work). Anything else passes as is."""
    if isinstance(x, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return x


def shard_batch(mesh: Mesh, array) -> Sharded:
    """A host or device batch split over ``data``: one shard a ``data``
    device, its rows copied there."""
    devs = mesh.data_devices
    return Sharded([to_device(array[s], d) for s, d in
                    zip(split_rows(array.shape[0], len(devs)), devs)])


def replicate(mesh: Mesh, value) -> list:
    """``value`` (a tensor, an array or an ``nn.Module``) on every
    ``data`` device: one entry a shard, one copy a distinct device (the
    shards on one device share it). A value already on a device is that
    device's copy."""
    devs = mesh.data_devices
    copies: Dict[torch.device, object] = {}
    for d in devs:
        if d not in copies:
            copies[d] = copy_to(value, d)
    return [copies[d] for d in devs]


def copy_to(value, device: torch.device):
    """``value`` on ``device``: a module is deep-copied unless it is
    there already, its parameters and buffers moved with it."""
    if isinstance(value, torch.nn.Module):
        here = next(iter(value.parameters()), None)
        if here is not None and here.device == device:
            return value
        return copy.deepcopy(value).to(device)
    return to_device(value, device)
