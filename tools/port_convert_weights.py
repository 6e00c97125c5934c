#!/usr/bin/env python3
"""Convert upstream deploy tensors into the registry's artifact, with the
PyTorch port alone.

The counterpart of ``tools/convert_weights.py`` that imports only
``oar_ocr_tpu_torch``: it takes a safetensors file of official-name
deploy tensors (PaddleOCR / PaddleClas / PaddleX names, e.g. the
initializers of an upstream ``.onnx``, ``runtime/onnx_extract.py``),
maps them into the port's state_dict through the family's official-name
map (``runtime/ppocr_maps.py``, strict both ways: a missing tensor or a
wrong shape raises ``ModelLoadError``, an unmapped one is reported), and
writes the artifact the registry resolves,
``$OAR_TPU_HOME/models/<name>.safetensors``. The artifact is the JAX
package's flat format ('/'-joined flax keys, flax layouts), with the
keys and the tensors ``tools/convert_weights.py`` writes from the same
source, so one ``$OAR_TPU_HOME`` serves both packages.

Usage::

    python tools/port_convert_weights.py --model pp-ocrv5_mobile_det \\
        --source det_tensors.safetensors [--out-dir DIR]
    python tools/port_convert_weights.py --model pp-ocrv5_mobile_det --describe

``--describe`` prints the expected source tensor names. The families are
those of ``tools/convert_weights.py:39-170``: text detection (mobile
PP-LCNetV3, server PP-HGNetV2), text recognition (the vocabulary from
the entry's dictionary, ``--charset-file`` or the known dictionary
sizes), the PP-LCNet classifiers, SLANet / SLANet_plus / SLANeXt,
PP-FormulaNet-S / -L, the layout detectors, UVDoc and the exact VL
stacks (MinerU 2.5 / -Pro, MinerU-Diffusion, GLM-OCR, OvisOCR2,
HPD-Parsing, MonkeyOCRv2: HF checkpoint names; no VL artifact of
PaddleOCR-VL or HunyuanOCR). The models are built on the ``meta`` device: only
their names, shapes and module types are read.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# Known dictionary entry counts (``tools/convert_weights.py:47-53``;
# vocab = blank + chars + space), used when the dictionary is not on disk.
KNOWN_DICT_LENS = {
    "ppocr_keys_v1.txt": 6623,
    "ppocrv5_dict.txt": 18383,
}


def rec_vocab_size(variant: str, charset_file: Optional[str] = None) -> int:
    """The CTC head's vocabulary: ``charset_file``, else the registry
    entry's dictionary on disk, else its known size
    (``convert_weights.py:56-72``)."""
    from oar_ocr_tpu_torch.ops.ctc import load_charset
    from oar_ocr_tpu_torch.registry.models import MODEL_REGISTRY, asset_path

    if charset_file:
        return 1 + len(load_charset(charset_file)) + 1
    entry = MODEL_REGISTRY.get(variant)
    charset = entry.charset if entry else None
    if charset:
        path = asset_path(charset)
        if path and os.path.exists(path):
            return 1 + len(load_charset(path)) + 1
        if charset in KNOWN_DICT_LENS:
            return 1 + KNOWN_DICT_LENS[charset] + 1
    print(f"warning: no charset info for {variant!r}; assuming the v1 "
          "6623-entry dictionary", file=sys.stderr)
    return 6625


def _build_db(variant: str, **_):
    from oar_ocr_tpu_torch.models.detection.db import DBNet

    return DBNet(backbone="hgnet" if "server" in variant else "lcnet")


def _build_rec(variant: str, charset_file: Optional[str] = None, **_):
    from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer

    return SVTRRecognizer(rec_vocab_size(variant, charset_file),
                          backbone="hgnet" if "server" in variant
                          else "lcnet")


def _build_cls(variant: str, **_):
    from oar_ocr_tpu_torch.models.classification.pp_lcnet_exact import \
        PPLCNetV1Cls

    # as convert_weights.py:84-94: every textline entry is the x0.25 one
    if "textline" in variant:
        return PPLCNetV1Cls(2, 0.25)
    if "table" in variant:
        return PPLCNetV1Cls(2, 1.0)
    return PPLCNetV1Cls(4, 1.0)


def _build_table_structure(variant: str, **_):
    if "slanext" in variant:
        from oar_ocr_tpu_torch.models.recognition.slanext_exact import \
            SLANeXtExact

        return SLANeXtExact()
    from oar_ocr_tpu_torch.models.recognition.slanet_exact import \
        SLANetExact

    return SLANetExact(loc_reg_num=4 if variant == "slanet" else 8)


def _build_formula(variant: str, **_):
    from oar_ocr_tpu_torch.models.recognition.pp_formulanet_exact import (
        PPFormulaNetConfig, PPFormulaNetModule)

    if "formulanet" not in variant:
        raise SystemExit(f"{variant}: only the PP-FormulaNet checkpoints "
                         "have an official-name map")
    if variant.endswith("-m"):
        raise SystemExit(f"{variant}: plus-M dims not pinned yet; "
                         "read them off the checkpoint and extend "
                         "PPFormulaNetConfig")
    cfg = PPFormulaNetConfig()
    return PPFormulaNetModule(cfg.large() if variant.endswith("-l") else cfg)


def _build_layout(variant: str, **_):
    from oar_ocr_tpu_torch.domain.layout import LAYOUT_VARIANTS
    from oar_ocr_tpu_torch.models.detection.picodet_exact import \
        PicoDetExact
    from oar_ocr_tpu_torch.models.detection.rtdetr import RTDETRExact

    v = LAYOUT_VARIANTS[variant]
    if v.net.startswith("rtdetr"):
        return RTDETRExact(num_classes=v.num_classes,
                           arch=v.net.split("-")[1])
    scale, neck_feat, head_convs = v.picodet_dims
    return PicoDetExact(num_classes=v.num_classes, scale=scale,
                        neck_feat=neck_feat, head_convs=head_convs)


def _build_vlm(variant: str, **_):
    """An exact VL stack's network (``vl/exact_models.ExactVLMNet``) at the
    published dims."""
    from oar_ocr_tpu_torch.vl.exact_models import (REGISTRY_FAMILIES,
                                                   ExactVLMNet, family_spec)

    family = REGISTRY_FAMILIES.get(variant)
    if family is None:
        raise SystemExit(_NO_VL_WRITER.format(variant))
    return ExactVLMNet(*family_spec(family))


_NO_VL_WRITER = ("{}: no converter writes an artifact of the PaddleOCR-VL "
                 "and HunyuanOCR checkpoints, neither this tool nor "
                 "tools/convert_weights.py")


def _build_uvdoc(variant: str, **_):
    from oar_ocr_tpu_torch.models.rectification.uvdoc_exact import \
        UVDocNetExact

    return UVDocNetExact(num_filter=32)


MODEL_BUILDERS = {
    "text_detection": _build_db,
    "seal_text_detection": _build_db,
    "text_recognition": _build_rec,
    "document_orientation": _build_cls,
    "textline_orientation": _build_cls,
    "table_classification": _build_cls,
    "table_structure_recognition": _build_table_structure,
    "formula_recognition": _build_formula,
    "layout_detection": _build_layout,
    "table_cell_detection": _build_layout,
    "document_rectification": _build_uvdoc,
    "vlm": _build_vlm,
}


def build_model_and_map(variant: str, *,
                        charset_file: Optional[str] = None):
    """(the port module on the ``meta`` device, its official-name map)
    for a registry entry."""
    import torch

    from oar_ocr_tpu_torch.registry.models import MODEL_REGISTRY
    from oar_ocr_tpu_torch.runtime import ppocr_maps

    entry = MODEL_REGISTRY[variant]
    builder = MODEL_BUILDERS.get(entry.task)
    if builder is None:
        raise SystemExit(f"no builder wired for task {entry.task!r}")
    with torch.device("meta"):
        model = builder(variant, charset_file=charset_file)
    if entry.task == "vlm":
        cm = ppocr_maps.build_vl_map(model, name=variant)
    elif entry.task == "formula_recognition":
        cm = ppocr_maps.build_formulanet_map(model, name=variant)
    else:
        cm = ppocr_maps.build_ppocr_map(model, name=variant)
    return model, cm


def convert(variant: str, source: Dict[str, np.ndarray], *,
            out_dir: Optional[str] = None, strict: bool = True,
            charset_file: Optional[str] = None) -> Tuple[str, list]:
    """Map ``source`` (official name → array) into ``variant``'s port
    model and write its artifact; returns (artifact path, the unused
    source names)."""
    from oar_ocr_tpu_torch.registry import models
    from oar_ocr_tpu_torch.runtime.ppocr_maps import (convert_official,
                                                      jax_flat_params)
    from oar_ocr_tpu_torch.runtime.weights import write_safetensors

    model, cm = build_model_and_map(variant, charset_file=charset_file)
    sd = convert_official(model, cm, source, strict=strict)
    out_dir = out_dir or os.path.join(models.OAR_TPU_HOME, "models")
    out_path = os.path.join(out_dir,
                            models.MODEL_REGISTRY[variant].filename)
    write_safetensors(jax_flat_params(model, sd), out_path)
    return out_path, cm.unused_sources(source)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True,
                    help="registry name (oar_ocr_tpu_torch.registry.models)")
    ap.add_argument("--source", help="safetensors of official-name deploy "
                                     "tensors")
    ap.add_argument("--out-dir", help="artifact directory (default "
                                      "$OAR_TPU_HOME/models)")
    ap.add_argument("--describe", action="store_true",
                    help="print the expected source tensor names")
    ap.add_argument("--non-strict", action="store_true",
                    help="tolerate missing source tensors")
    ap.add_argument("--charset-file",
                    help="text recognition: the dictionary that sets the "
                         "vocabulary (default: the entry's)")
    args = ap.parse_args(argv)

    from oar_ocr_tpu_torch.registry.models import (MODEL_REGISTRY,
                                                   sha256_file,
                                                   upstream_provenance)
    from oar_ocr_tpu_torch.runtime.weights import read_safetensors

    entry = MODEL_REGISTRY.get(args.model)
    if entry is None:
        print(f"unknown model {args.model!r}; known:", file=sys.stderr)
        for name in sorted(MODEL_REGISTRY):
            print(" ", name, file=sys.stderr)
        return 2
    if entry.task not in MODEL_BUILDERS:
        print(f"no builder wired for task {entry.task!r} yet",
              file=sys.stderr)
        return 2
    if entry.task == "vlm" and args.model.startswith(("paddleocr-vl",
                                                      "hunyuanocr")):
        print(_NO_VL_WRITER.format(args.model), file=sys.stderr)
        return 2
    if args.describe:
        _, cm = build_model_and_map(args.model,
                                    charset_file=args.charset_file)
        for _, source, _ in cm.rules:
            print(source)
        return 0
    if not args.source:
        ap.error("--source is required unless --describe")

    # the upstream artifact's pinned SHA-256 (convert_weights.py:451-463)
    prov = upstream_provenance(entry)
    if prov and entry.source and os.path.basename(args.source) == entry.source:
        actual = sha256_file(args.source)
        if actual != prov[0]:
            print(f"upstream checksum mismatch for {entry.source}: "
                  f"expected {prov[0]}, got {actual}", file=sys.stderr)
            return 3

    t0 = time.perf_counter()
    out_path, unused = convert(args.model, read_safetensors(args.source),
                               out_dir=args.out_dir,
                               strict=not args.non_strict,
                               charset_file=args.charset_file)
    if unused:
        print(f"note: {len(unused)} source tensors unused "
              f"(first: {unused[:5]})", file=sys.stderr)
    print(f"wrote {out_path} ({(time.perf_counter() - t0) * 1e3:.1f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
