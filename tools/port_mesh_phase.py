#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 38, the mesh layer, alone.

Builds K1-K4, then runs ``chip_smoke.mesh_phase``: the OCR predict over a
data-parallel mesh of every visible card (two shards on the one card
where there is one) against one card, and GLM-OCR at published width
and depth at ``n_model`` = 2 (over two cards where there are two, else
two shards on one) against ``n_model`` = 1, with its gates, layouts,
launches per card, pages/s, ms/token and peak MiB; then K1 at the
shards' own inputs on every card of the mesh against its plain version.
It exits non-zero when a gate fails. On a machine with several cards
this is the phase's multi-card run (NCCL between the model shards, the
decode one CUDA graph over both cards), without the other phases of
``chip_smoke.py``, which needs only one card and pins every phase but
38 to one device.

Usage (from the repository root, on a machine with CUDA cards)::

    python3 tools/port_mesh_phase.py
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs
    from oar_ocr_tpu_torch.models.layers import init_state_dict
    from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer
    from oar_ocr_tpu_torch.ops.ctc import default_charset
    from oar_ocr_tpu_torch.ops.cuda_build import build_all
    from oar_ocr_tpu_torch.ops.flash_attention import KERNEL as K2
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL as K3
    from oar_ocr_tpu_torch.ops.fused_norm_rope import KERNEL_QK as K4
    from oar_ocr_tpu_torch.ops.normalize import KERNEL as K1
    from oar_ocr_tpu_torch.runtime.weights import load_jax_checkpoint

    if not torch.cuda.is_available():
        print("port_mesh_phase: no CUDA device visible", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(f"cards: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, count {torch.cuda.device_count()}")
    kernels = (K1, K2, K3, K4)
    build_all(kernels)
    det_state = load_jax_checkpoint(
        str(REPO / "assets" / "bench_det.safetensors"))
    rec_state = init_state_dict(
        SVTRRecognizer(2 + len(default_charset()), 0.95),
        torch.Generator().manual_seed(0))
    fitted = cs.fitted_recognizer(rec_state)
    out = cs.mesh_phase(card[0], kernels, det_state, fitted)
    k1 = {"cases": [], "max_abs_err": 0.0}
    cs.mesh_k1_checks(k1, [], out.pop("k1_cases"), card[0])
    print(json.dumps(out))
    print(f"port_mesh_phase: {time.perf_counter() - t0!r} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
