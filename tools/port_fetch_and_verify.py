#!/usr/bin/env python3
"""Upstream weights into the PyTorch port in one command: fetch, extract,
convert, predict.

The counterpart of ``tools/fetch_and_verify.py`` that imports only
``oar_ocr_tpu_torch``::

    python tools/port_fetch_and_verify.py --model pp-ocrv5_mobile_det \\
        --upstream-file det.onnx [--out-dir DIR] [--device cuda|cpu]

1. **fetch**: ``--upstream-file`` names a local upstream artifact (an
   ``.onnx`` or a ``.safetensors`` dump of official-name tensors); a file
   named like the registry's upstream artifact must match its pinned
   SHA-256. Without it, ``registry/models.fetch_upstream`` downloads the
   artifact, which needs ``OAR_TPU_ALLOW_DOWNLOAD=1`` and a network.
2. **extract**: the ONNX graph initializers (``runtime/onnx_extract.py``),
   written as a safetensors dump beside the artifact's temporary files.
3. **convert**: ``tools/port_convert_weights.py`` writes the registry
   artifact (default ``$OAR_TPU_HOME/models/<name>.safetensors``).
4. **predict**: ``OAROCRBuilder`` with the artifact in its slot (det or
   rec by task; seeded random weights in the other) runs
   ``OAROCR.predict`` on ``--image`` or a synthetic page, on the card
   unless ``--device cpu``. A recognizer takes ``--charset-file``, else
   its entry's dictionary when it is on disk, else placeholder symbols
   ``⟨i⟩`` for the vocabulary the artifact has. Other tasks stop after
   the conversion.

It prints one JSON verdict line (with each step's host milliseconds under
``ms``) and exits non-zero on a failure. The parity gate of the JAX tool
(golden dumps of the reference) waits for dumps in the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import List

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _step(name: str, detail: str = "") -> None:
    print(f"[port_fetch_and_verify] {name}{': ' + detail if detail else ''}",
          file=sys.stderr)


def placeholder_charset(n: int) -> List[str]:
    """``n`` placeholder dictionary entries ``⟨0⟩ … ⟨n-1⟩``."""
    return [f"⟨{i}⟩" for i in range(n)]


def synthetic_page() -> np.ndarray:
    """The JAX tool's smoke page (``fetch_and_verify.py:160-163``)."""
    rng = np.random.default_rng(0)
    img = np.full((320, 256, 3), 255, np.uint8)
    for r in range(4):
        img[40 + 60 * r: 66 + 60 * r, 30:210] = rng.integers(0, 60)
    return img


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True,
                    help="registry name (oar_ocr_tpu_torch.registry.models)")
    ap.add_argument("--upstream-file",
                    help="local upstream artifact (.onnx or a .safetensors "
                         "deploy dump); skips the download")
    ap.add_argument("--image", help="predict input image (a synthetic page "
                                    "when omitted)")
    ap.add_argument("--out-dir", help="converted-artifact directory "
                                      "(default $OAR_TPU_HOME/models)")
    ap.add_argument("--non-strict", action="store_true",
                    help="tolerate missing source tensors at conversion")
    ap.add_argument("--charset-file",
                    help="text recognition: the dictionary (sets the "
                         "vocabulary and decodes the texts)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from oar_ocr_tpu_torch.registry import models
    from oar_ocr_tpu_torch.runtime.weights import write_safetensors

    entry = models.MODEL_REGISTRY.get(args.model)
    if entry is None:
        print(f"unknown model {args.model!r}", file=sys.stderr)
        return 2
    verdict = {"model": args.model, "task": entry.task}
    ms = {}

    # --- 1. fetch (or accept a local stand-in) ---
    t0 = time.perf_counter()
    if args.upstream_file:
        src_path = args.upstream_file
        prov = models.upstream_provenance(entry)
        if prov and os.path.basename(src_path) == entry.source:
            actual = models.sha256_file(src_path)
            if actual != prov[0]:
                print(f"upstream checksum mismatch: expected {prov[0]}, "
                      f"got {actual}", file=sys.stderr)
                return 3
            verdict["sha256"] = "verified"
        else:
            verdict["sha256"] = "skipped (local stand-in)"
        _step("fetch", f"local {src_path}")
    else:
        src_path = models.fetch_upstream(entry.source)
        verdict["sha256"] = "verified"
        _step("fetch", src_path)
    verdict["upstream"] = src_path
    ms["fetch"] = (time.perf_counter() - t0) * 1e3

    # --- 2. extract the ONNX initializers when needed ---
    t0 = time.perf_counter()
    tmpdir = tempfile.mkdtemp(prefix="oar_port_fetch_")
    try:
        if src_path.endswith(".onnx"):
            from oar_ocr_tpu_torch.runtime.onnx_extract import \
                extract_initializers

            tensors = extract_initializers(src_path)
            source = os.path.join(tmpdir, "deploy_tensors.safetensors")
            write_safetensors(tensors, source)
            _step("extract", f"{len(tensors)} initializers")
        else:
            source = src_path
            _step("extract", "skipped (safetensors dump)")
        ms["extract"] = (time.perf_counter() - t0) * 1e3

        # --- 3. convert through port_convert_weights ---
        from tools import port_convert_weights as cw

        t0 = time.perf_counter()
        out_dir = args.out_dir or os.path.join(models.OAR_TPU_HOME,
                                               "models")
        cw_args = ["--model", args.model, "--source", source,
                   "--out-dir", out_dir]
        if args.non_strict:
            cw_args.append("--non-strict")
        if args.charset_file:
            cw_args += ["--charset-file", args.charset_file]
        rc = cw.main(cw_args)
        if rc != 0:
            print(f"conversion failed (exit {rc})", file=sys.stderr)
            return rc
        ms["convert"] = (time.perf_counter() - t0) * 1e3
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    artifact = os.path.join(out_dir, entry.filename)
    verdict["converted"] = artifact
    _step("convert", artifact)

    # --- 4. predict with the converted weights in their slot ---
    from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder
    from oar_ocr_tpu_torch.runtime.runtime import Runtime

    t0 = time.perf_counter()
    b = OAROCRBuilder("general").with_runtime(Runtime("float32",
                                                      device=args.device))
    if entry.task in ("text_detection", "seal_text_detection"):
        b = b.with_det_source(artifact)
    elif entry.task == "text_recognition":
        b = b.with_rec_source(artifact)
        charset = args.charset_file or (models.asset_path(entry.charset)
                                        if entry.charset else None)
        if charset:
            b = b.with_charset_file(charset)
            verdict["charset"] = charset
        else:
            n = cw.rec_vocab_size(args.model) - 2
            b = b.with_charset(placeholder_charset(n))
            verdict["charset"] = f"placeholder ({n} entries)"
    else:
        verdict["predict"] = ("skipped: the task is not an OAROCR slot; "
                              "conversion verified above")
        verdict["ms"] = ms
        verdict["verdict"] = "OK"
        print(json.dumps(verdict, ensure_ascii=False))
        return 0
    pipe = b.with_batch_sizes(image=1, region=16).build()

    if args.image:
        from oar_ocr_tpu_torch.utils.image import load_image

        img = load_image(args.image)
    else:
        img = synthetic_page()
    res = pipe.predict([img])[0]
    ms["predict"] = (time.perf_counter() - t0) * 1e3
    verdict["predict"] = {"regions": len(res.regions),
                          "texts": [r.text for r in res.regions][:5]}
    _step("predict", f"{len(res.regions)} regions")
    verdict["parity"] = ("not run: needs golden dumps of the reference, "
                         "which the repository does not hold")
    verdict["ms"] = ms
    verdict["verdict"] = "OK"
    print(json.dumps(verdict, ensure_ascii=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
