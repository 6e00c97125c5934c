"""The data-parallel det+rec step over a device mesh.

Counterpart of ``oar_ocr_tpu/parallel/dp.py`` (``dp.py:26-62``): the
device half of the OCR pipeline — the det preprocess (projective sample
+ K1 normalize) → DBNet, and the crop warp (K1 inside) → SVTR → greedy
CTC — with the page and crop batches split over the mesh's ``data``
devices and one model replica a device. The JAX program's only
cross-device traffic is the gather of a crop whose page lies on another
shard; here every shard's device gathers the whole page batch first, so
a crop's page is always local (crops index pages globally).

It is the multi-device dry-run surface of the port, as the JAX step is
the JAX package's, and it is not what ``OAROCR.predict`` runs: the
pipeline shards ``DBDetector.step`` and the recognizer's dispatches
through ``Runtime.run_sharded``, and its det input goes through the
separable resize, where this step (as JAX's) samples the page with
``sample_transform``. Only the tests drive it, against the JAX step;
ROADMAP queues folding it into the pipeline's path or removing it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.ctc import ctc_greedy_decode
from ..ops.warp import NormSpec, sample_transform, warp_crops
from .mesh import Mesh, Sharded, on_device


def make_dp_ocr_step(mesh: Mesh, *, det_hw: Tuple[int, int], rec_w: int,
                     compute_dtype: torch.dtype = torch.bfloat16):
    """A step running det+rec on one page batch over ``mesh``.

    ``step(det_models, rec_models, pages_u8, det_mats, det_valid_w,
    det_valid_h, rec_mats, rec_img_idx, rec_valid_w)``: the models are
    one replica a ``data`` shard (``replicate(mesh, model)``: the JAX
    step's flax modules and their params are one here); the batches are
    :class:`Sharded` over ``data`` (``shard_batch``):

      pages_u8 (N, H, W, 3) uint8, det_mats (N, 3, 3), det_valid_w/h (N,);
      rec_mats (M, 3, 3), rec_img_idx (M,), rec_valid_w (M,) — the M
      crops index pages globally.

    → (det prob (N, det_h, det_w) float32, CTC indices, probabilities
    and keep (M, T)), each :class:`Sharded` over ``data``, as the JAX
    step's ``out_shardings``."""
    det_h, det_w = det_hw
    devs = mesh.data_devices

    @torch.no_grad()
    def step(det_models: Sequence, rec_models: Sequence, pages_u8: Sharded,
             det_mats: Sharded, det_valid_w: Sharded, det_valid_h: Sharded,
             rec_mats: Sharded, rec_img_idx: Sharded,
             rec_valid_w: Sharded):
        outs = []
        for i, d in enumerate(devs):
            with on_device(d):
                pages = pages_u8.shards[i]
                idx = torch.arange(pages.shape[0], device=d)
                x = sample_transform(
                    pages, det_mats.shards[i], idx, det_valid_w.shards[i],
                    det_valid_h.shards[i], out_h=det_h, out_w=det_w,
                    norm=NormSpec.imagenet_rgb(), out_dtype=compute_dtype,
                    caller="det")
                prob = det_models[i](x).float()
                tiles = warp_crops(pages_u8.gather(d), rec_mats.shards[i],
                                   rec_img_idx.shards[i],
                                   rec_valid_w.shards[i], out_h=48,
                                   out_w=rec_w, out_dtype=compute_dtype)
                raw = ctc_greedy_decode(rec_models[i](tiles))
                outs.append((prob, raw.indices, raw.probs, raw.keep))
        return tuple(Sharded([o[j] for o in outs]) for j in range(4))

    return step
