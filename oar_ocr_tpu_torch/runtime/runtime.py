"""Runtime: the device, the dtype policy, bucket tables and transfers.

Counterpart of ``oar_ocr_tpu/runtime/runtime.py`` and
``oar_ocr_tpu/config/runtime.py``. Kept: the device placement, the
compute dtype (``config/runtime.py:135,187``: bfloat16 by default, or
float32), ``put_pages`` (stack, pad and upload a uint8 NHWC page batch),
``round_batch`` and the bucket tables. Left out, because they exist for
the TPU's remote link or its mesh: the link thread, the bandwidth EMAs,
the recovery probes, sharded jits (``runtime.py:158-430``) and the
config's kill switches.

The bucket tables are copied value for value from
``config/runtime.py:71-82``. They are not only a compile-count bound on
the TPU: they decide the padded shapes the models see, and the SE blocks
average over the whole padded map and SVTR attends over padded
timesteps, so the port pads to the same buckets to give the same numbers.

Device→host fetches start at dispatch time (:class:`HostFetch`): a
non-blocking copy into pinned memory plus a CUDA event, joined at collect
— the counterpart of the JAX package's ``copy_to_host_async`` + link
thread, so a collect waits only for the work it reads, not for later
batches queued behind it on the stream.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..config.runtime import BucketTable
from ..errors import ConfigError

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

DET_SIDE_BUCKETS = BucketTable((320, 640, 704, 960, 1280, 1600, 1920, 2560, 3200, 4000))
REC_WIDTH_BUCKETS = BucketTable((160, 320, 480, 640, 960, 1280, 1920, 2560, 3200))
REC_BATCH_BUCKETS = BucketTable((8, 16, 32, 64, 128))
DET_BATCH_BUCKETS = BucketTable((1, 2, 4, 8, 16))
REC_NATIVE_H_BUCKETS = BucketTable((32, 48, 96, 192))
REC_NATIVE_W_BUCKETS = BucketTable((160, 320, 640, 768, 960, 1280, 1920))


class HostFetch:
    """A device→host copy in flight; ``result()`` waits and returns numpy."""

    def __init__(self, tensor: torch.Tensor):
        if tensor.device.type == "cuda":
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                     pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tensor
            self._event = None

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class Runtime:
    """Device placement and dtype policy for one pipeline.

    TF32 is turned off for the whole process when a Runtime is made. The
    JAX package computes the resize and warp products in f32 at
    ``Precision.HIGHEST`` (``det_device.py:77-84``, ``warp.py:276-306``)
    and its float32 policy runs convolutions in full f32; on Hopper, cuDNN
    convolutions default to TF32 (``torch.backends.cudnn.allow_tf32``), so
    both flags are set off here. A bfloat16 Runtime sets them too: its
    resize and warp products still run in float32.

    ``device`` defaults to the CUDA card. Without a visible card that
    raises ``ConfigError``: the CPU runs only when asked for by
    ``device="cpu"``, never as a silent fallback.
    """

    def __init__(self, compute_dtype: str = "bfloat16",
                 device: torch.device | str = "cuda"):
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

    @property
    def is_accelerator(self) -> bool:
        return self.device.type != "cpu"

    def put(self, array: np.ndarray) -> torch.Tensor:
        """Upload a host array to the runtime's device. On CUDA the copy
        goes through pinned memory without blocking the host, so it does
        not wait for work already queued on the stream."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def put_pages(self, images: Sequence[np.ndarray],
                  target_hw: Tuple[int, int]) -> torch.Tensor:
        """Upload variable-size HWC uint8 pages as one zero-padded
        (B, H, W, 3) uint8 batch."""
        return self.put(stack_padded(images, target_hw))

    def round_batch(self, nb: int) -> int:
        """Batch bucket rounding; identity on one device (the JAX package
        rounds up to its mesh's data-axis size)."""
        return nb


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
