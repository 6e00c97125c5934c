"""Command-line interface: ``python -m oar_ocr_tpu_torch.cli``.

Counterpart of ``oar_ocr_tpu/cli.py`` (:1-237), with its eight
subcommands and their arguments. ``ocr``, ``structure``, ``detect``,
``recognize``, ``layout``, ``vl`` and ``vlm`` run the port, on seeded
random weights as the JAX CLI's do (no checkpoint option there either);
``vlm`` takes any VL registry name (``mineru-2.5``, ``glm-ocr``,
``hpd-parsing-1b``, ``paddleocr-vl-0.9b``, ...). Each subcommand also
takes ``--device {cuda,cpu}`` (default ``cuda``), which stands in for the
JAX CLI's ``JAX_PLATFORMS``: without a card, ``cuda`` raises
``ConfigError`` as ``Runtime()`` does. ``bench`` needs the port's bench
(ROADMAP queue 1, item 5) and raises ``UnsupportedError``.

Each image prints one JSON line (markdown or HTML for ``structure`` when
asked), in the order of the paths.
"""

from __future__ import annotations

import argparse
import json
from typing import List


def _load_images(paths: List[str]):
    """Each path decoded to HWC uint8 RGB; the first that does not decode
    raises ``ImageLoadError`` (``cli.py:15-27``)."""
    from .utils.image import load_image

    return [load_image(p) for p in paths]


def _runtime(args):
    from .runtime.runtime import Runtime

    return Runtime(device=args.device)


def cmd_ocr(args):
    from .pipelines.ocr import OAROCRBuilder

    b = OAROCRBuilder(args.text_type).with_runtime(_runtime(args))
    if args.charset:
        b = b.with_charset_file(args.charset)
    if args.doc_orientation:
        b = b.with_doc_orientation()
    if args.rectify:
        b = b.with_doc_rectification()
    if args.textline_orientation:
        b = b.with_textline_orientation()
    if args.word_boxes:
        b = b.with_word_boxes()
    pipe = b.build()
    results = pipe.predict(_load_images(args.images))
    for path, res in zip(args.images, results):
        out = res.to_dict()
        out["source_path"] = path
        print(json.dumps(out, ensure_ascii=False))


def cmd_structure(args):
    from .pipelines.structure import OARStructureBuilder

    b = (OARStructureBuilder()
         .with_runtime(_runtime(args))
         .with_layout_variant(args.layout)
         .with_tables(not args.no_tables)
         .with_formulas(not args.no_formulas)
         .with_seals(not args.no_seals))
    pipe = b.build()
    results = pipe.predict(_load_images(args.images))
    for path, res in zip(args.images, results):
        res.source_path = path
        if args.format == "markdown":
            print(res.to_markdown())
        elif args.format == "html":
            print(res.to_html())
        else:
            print(json.dumps(res.to_json_value(), ensure_ascii=False))
        if args.output_dir:
            import os

            stem = os.path.splitext(os.path.basename(path))[0]
            res.save_results(args.output_dir, stem)


def cmd_detect(args):
    from .predictors.predictors import TextDetectionPredictor
    from .tasks.tasks import TextDetectionConfig

    p = TextDetectionPredictor(TextDetectionConfig(
        box_thresh=args.box_thresh, thresh=args.thresh),
        runtime=_runtime(args))
    for path, (boxes, scores) in zip(
            args.images, p.predict(_load_images(args.images))):
        print(json.dumps({
            "source_path": path,
            "boxes": [b.tolist() for b in boxes],
            "scores": scores,
        }))


def cmd_recognize(args):
    from .predictors.predictors import TextRecognitionPredictor
    from .tasks.tasks import TextRecognitionConfig

    p = TextRecognitionPredictor(TextRecognitionConfig(
        charset_path=args.charset), runtime=_runtime(args))
    for path, (text, conf) in zip(
            args.images, p.predict(_load_images(args.images))):
        print(json.dumps({"source_path": path, "text": text,
                          "confidence": conf}, ensure_ascii=False))


def cmd_layout(args):
    from .predictors.predictors import LayoutDetectionPredictor
    from .tasks.tasks import LayoutDetectionConfig

    p = LayoutDetectionPredictor(LayoutDetectionConfig(
        variant=args.variant, score_thresh=args.score_thresh),
        runtime=_runtime(args))
    for path, boxes in zip(args.images, p.predict(_load_images(args.images))):
        print(json.dumps({
            "source_path": path,
            "elements": [{"label": b.label, "score": b.score,
                          "box": b.box.tolist()} for b in boxes],
        }))


def cmd_vl(args):
    from .vl.model import PaddleOCRVL
    from .vl.paddleocr_vl import PaddleOCRVLConfig

    cfg = PaddleOCRVLConfig()
    if args.dev_tiny:
        cfg = cfg.tiny()
    vlm = PaddleOCRVL(cfg=cfg, runtime=_runtime(args))
    for path, res in zip(args.images, vlm.generate(
            _load_images(args.images), task=args.task,
            max_new_tokens=args.max_new_tokens)):
        print(json.dumps({"source_path": path, "text": res.text},
                         ensure_ascii=False))


def cmd_vlm(args):
    """Any VLM family by registry name, running its exact architecture
    (``vl/exact_models.exact_from_registry``, ``cli.py:134-153``)."""
    from .vl.exact_models import exact_from_registry
    from .vl.model import PaddleOCRVL

    model = exact_from_registry(args.model, tiny=args.dev_tiny,
                                runtime=_runtime(args))
    images = _load_images(args.images)
    if isinstance(model, PaddleOCRVL):
        # task-prompted interface (TASK_PROMPTS) instead of free text
        outs = model.generate(images, "ocr",
                              max_new_tokens=args.max_new_tokens)
    else:
        outs = model.generate(images, args.instruction,
                              max_new_tokens=args.max_new_tokens)
    texts = [o.text if hasattr(o, "text") else o for o in outs]
    for path, text in zip(args.images, texts):
        print(json.dumps({"source_path": path, "model": args.model,
                          "text": text}, ensure_ascii=False))


def cmd_bench(args):
    from .errors import UnsupportedError

    raise UnsupportedError("the port has no bench yet (ROADMAP queue 1, "
                           "item 5)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="oar_ocr_tpu_torch",
        description="Document OCR / layout analysis on a CUDA card "
                    "(PyTorch)")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="run on the CUDA card (default) or the CPU")
    sub = ap.add_subparsers(dest="command", required=True)

    def add(name, help):
        return sub.add_parser(name, help=help, parents=[common])

    p = add("ocr", "full det+rec OCR pipeline")
    p.add_argument("images", nargs="+")
    p.add_argument("--text-type", default="general",
                   choices=["general", "table", "seal"])
    p.add_argument("--charset")
    p.add_argument("--doc-orientation", action="store_true")
    p.add_argument("--rectify", action="store_true")
    p.add_argument("--textline-orientation", action="store_true")
    p.add_argument("--word-boxes", action="store_true")
    p.set_defaults(fn=cmd_ocr)

    p = add("structure", "document structure analysis")
    p.add_argument("images", nargs="+")
    p.add_argument("--layout", default="pp-doclayout_plus-l")
    p.add_argument("--format", default="markdown",
                   choices=["markdown", "html", "json"])
    p.add_argument("--output-dir")
    p.add_argument("--no-tables", action="store_true")
    p.add_argument("--no-formulas", action="store_true")
    p.add_argument("--no-seals", action="store_true")
    p.set_defaults(fn=cmd_structure)

    p = add("detect", "text detection only")
    p.add_argument("images", nargs="+")
    p.add_argument("--thresh", type=float, default=0.3)
    p.add_argument("--box-thresh", type=float, default=0.6)
    p.set_defaults(fn=cmd_detect)

    p = add("recognize", "recognize pre-cropped lines")
    p.add_argument("images", nargs="+")
    p.add_argument("--charset")
    p.set_defaults(fn=cmd_recognize)

    p = add("layout", "layout detection only")
    p.add_argument("images", nargs="+")
    p.add_argument("--variant", default="pp-doclayout_plus-l")
    p.add_argument("--score-thresh", type=float, default=0.5)
    p.set_defaults(fn=cmd_layout)

    p = add("vl", "vision-language document parsing")
    p.add_argument("images", nargs="+")
    p.add_argument("--task", default="ocr")
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--dev-tiny", action="store_true",
                   help="use the development-size model (no weights)")
    p.set_defaults(fn=cmd_vl)

    p = add("vlm", "any VLM family by registry name (exact architecture)")
    p.add_argument("model", help="registry name, e.g. mineru-2.5, "
                                 "glm-ocr, hunyuanocr-1.5")
    p.add_argument("images", nargs="+")
    p.add_argument("--instruction", default="OCR:")
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--dev-tiny", action="store_true",
                   help="use the development-size config (no weights)")
    p.set_defaults(fn=cmd_vlm)

    p = add("bench", "run the throughput benchmark (not ported)")
    p.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
