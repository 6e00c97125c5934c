#!/usr/bin/env python3
"""Drive the PyTorch port's det+rec main path once on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, cv2;
2. build every kernel of the path from ``oar_ocr_tpu_torch/csrc/`` with
   nvcc for sm_90a;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (float32 max abs error ≤ 1e-6, bfloat16 ≤ 1 ulp), with
   CUDA-event times of both (median of 30 runs);
4. the main path: ``OAROCRBuilder("general")`` in float32 with the trained
   ``assets/bench_det.safetensors`` detector and seeded random recognizer
   weights (CTC blank logit +4.0, as the JAX bench), three ``predict``
   calls on 16 synthetic 1280×960 pages; every call must return results
   with ≥ 10 regions per page on average and must launch every kernel;
5. the same port on the CPU against the card: the main path's own
   output on its first 8-page det batch, and an unbiased recognizer on
   2 pages; same region count, quad IoU ≥ 0.95, identical texts,
   confidence Δ ≤ 2e-2;
6. steady-state pages/s over the 16-page batch in float32 and bfloat16
   (bfloat16's agreement with float32 is printed, not gated).

The last two lines are the kernels' JSON record and the result JSON
``{"ok": true, "device": {...}}``. Without a CUDA card, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
N_PAGES, PAGE_H, PAGE_W, REGIONS_PER_PAGE = 16, 1280, 960, 20
REGION_DIMS = [(700, 28), (420, 26), (180, 24), (760, 34), (260, 22)]
TIMED_ITERS = 5


def make_pages(seed: int = 0):
    """The JAX bench's flat pages: 20 dark text blocks on white."""
    rng = np.random.default_rng(seed)
    pages = []
    for _ in range(N_PAGES):
        img = np.full((PAGE_H, PAGE_W, 3), 255, np.uint8)
        for r in range(REGIONS_PER_PAGE):
            w, h = REGION_DIMS[r % len(REGION_DIMS)]
            y = 40 + r * 60
            img[y : y + h, 60 : 60 + w] = rng.integers(0, 80)
        pages.append(img)
    return pages


def cuda_ms(fn, iters: int = 30) -> float:
    """Median milliseconds of ``fn()`` between CUDA events, after warmup."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(name, got, ref) -> float:
    """Gate one comparison; returns the max abs error."""
    import torch

    err = float((got.float() - ref.float()).abs().max())
    if got.dtype == torch.bfloat16:
        ulps = int((got.view(torch.int16).int()
                    - ref.view(torch.int16).int()).abs().max())
        ok = ulps <= 1
        detail = f"max {ulps} bf16 ulp"
    else:
        ok = err <= 1e-6
        detail = "gate 1e-6"
    print(f"  {name}: max_abs_err {err!r} ({detail})")
    if not ok or got.shape != ref.shape:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({detail}, shape {tuple(got.shape)})")
    return err


def kernel_phase(card: str) -> dict:
    """Phase 3: K1 against its plain version at the main path's shapes."""
    import torch

    from oar_ocr_tpu_torch.models.detection.detector import (
        DET_ALPHA, DET_BETA, DET_MEAN, DET_STD)
    from oar_ocr_tpu_torch.ops.det_device import _interp_weights, resample
    from oar_ocr_tpu_torch.ops.normalize import (normalize_images,
                                                 normalize_masked,
                                                 normalize_ref)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pages = torch.randint(0, 256, (8, PAGE_H, PAGE_W, 3), generator=gen,
                          dtype=torch.uint8, device=dev)
    # the det tile of those pages: 1280×960 → 960×704 (det_target_size)
    src_h = torch.full((8,), PAGE_H, dtype=torch.int32, device=dev)
    src_w = torch.full((8,), PAGE_W, dtype=torch.int32, device=dev)
    dst_h = torch.full((8,), 960, dtype=torch.int32, device=dev)
    dst_w = torch.full((8,), 704, dtype=torch.int32, device=dev)
    det_tile = resample(pages, _interp_weights(960, PAGE_H, src_h, dst_h),
                        _interp_weights(704, PAGE_W, src_w, dst_w))
    rec_tiles = torch.rand((64, 48, 320, 3), generator=gen,
                           device=dev) * 255.0
    rec_w = torch.randint(16, 321, (64,), generator=gen, dtype=torch.int32,
                          device=dev)
    rec_h = torch.full((64,), 48, dtype=torch.int32, device=dev)
    rec_a, rec_b = (2.0 / 255.0,) * 3, (-1.0,) * 3

    cases = []
    for out in (torch.float32, torch.bfloat16):
        tag = "f32" if out == torch.float32 else "bf16"
        cases.append((
            f"u8 {tuple(pages.shape)} -> {tag}",
            lambda out=out: normalize_images(pages, mean=DET_MEAN,
                                             std=DET_STD, out_dtype=out),
            lambda out=out: normalize_ref(pages, DET_ALPHA, DET_BETA,
                                          out_dtype=out)))
        cases.append((
            f"det masked {tuple(det_tile.shape)} pad 0 -> {tag}",
            lambda out=out: normalize_masked(det_tile, DET_ALPHA, DET_BETA,
                                             valid_h=dst_h, valid_w=dst_w,
                                             pad=0.0, out_dtype=out),
            lambda out=out: normalize_ref(det_tile, DET_ALPHA, DET_BETA,
                                          valid_h=dst_h, valid_w=dst_w,
                                          pad=0.0, out_dtype=out)))
        cases.append((
            f"rec masked {tuple(rec_tiles.shape)} swap_rb pad beta -> {tag}",
            lambda out=out: normalize_masked(rec_tiles, rec_a, rec_b,
                                             valid_h=rec_h, valid_w=rec_w,
                                             pad=rec_b, swap_rb=True,
                                             out_dtype=out),
            lambda out=out: normalize_ref(rec_tiles, rec_a, rec_b,
                                          valid_h=rec_h, valid_w=rec_w,
                                          pad=rec_b, swap_rb=True,
                                          out_dtype=out)))
    f32_errs, rows = [], []
    for name, kernel, plain in cases:
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = check_close(name, got, ref)
        if got.dtype == torch.float32:
            f32_errs.append(err)
        # plain, kernel, kernel, plain; each keeps the lower of its medians
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel),
                          cuda_ms(plain))
        k_ms, p_ms = min(k1, k2), min(p1, p2)
        rows.append({"case": name, "ms": k_ms, "plain_ms": p_ms})
        print(f"  {name}: kernel {k_ms!r} ms, plain {p_ms!r} ms  [{card}]")
    head = rows[0]
    return {"max_abs_err": max(f32_errs), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "cases": rows}


def build_pipeline(runtime, det_state, rec_state, batch=(8, 64)):
    from oar_ocr_tpu_torch.pipelines.ocr import OAROCRBuilder

    return (OAROCRBuilder("general").with_runtime(runtime)
            .with_det_params(det_state).with_rec_params(rec_state)
            .with_batch_sizes(image=batch[0], region=batch[1]).build())


def timed_pps(pipe, pages, card: str, label: str):
    times = []
    for _ in range(TIMED_ITERS):
        t0 = time.perf_counter()
        res = pipe.predict(pages)
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    print(f"throughput {label}: {len(pages) / p50!r} pages/s "
          f"(p50 {p50 * 1e3!r} ms per {len(pages)}-page predict, "
          f"iters_ms {[round(t * 1e3, 1) for t in times]}) [{card}]")
    return res, len(pages) / p50


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 2
    if not (REPO / "oar_ocr_tpu_torch").is_dir():
        print("chip_smoke: run it from the repository checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    # --- 1. the card ---
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    import cv2

    print(f"cv2 {cv2.__version__} imported")

    # --- 2. build ---
    from oar_ocr_tpu_torch.ops.normalize import KERNEL

    t0 = time.perf_counter()
    built = KERNEL.build()
    print(f"build: {KERNEL.source} -> {built.path.name} in "
          f"{time.perf_counter() - t0!r} s (nvcc {built.build_seconds!r} s)")
    for line in built.log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # --- 3. kernel vs plain ---
    print("kernel vs plain version:")
    k1 = kernel_phase(card)

    # --- 4. the main path ---
    from oar_ocr_tpu_torch.models.layers import init_state_dict
    from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer
    from oar_ocr_tpu_torch.ops.ctc import default_charset
    from oar_ocr_tpu_torch.runtime.runtime import Runtime
    from oar_ocr_tpu_torch.runtime.weights import load_jax_checkpoint
    from oar_ocr_tpu_torch.utils.parity import compare_results

    det_state = load_jax_checkpoint(
        str(REPO / "assets" / "bench_det.safetensors"))
    vocab = 2 + len(default_charset())
    rec_state = init_state_dict(SVTRRecognizer(vocab, 0.95),
                                torch.Generator().manual_seed(0))
    rec_state["head.ctc_head.fc.bias"][0] += 4.0   # blank wins most steps
    pages = make_pages(0)
    gpu_f32 = Runtime("float32", device="cuda")
    pipe = build_pipeline(gpu_f32, det_state, rec_state)

    KERNEL.launches = 0
    per_call, results = [], None
    for call in range(3):
        before = KERNEL.launches
        t0 = time.perf_counter()
        results = pipe.predict(pages)
        dt = time.perf_counter() - t0
        n_regions = sum(len(r.regions) for r in results)
        per_call.append(KERNEL.launches - before)
        print(f"predict {call}: {len(results)} results, {n_regions} regions "
              f"({n_regions / N_PAGES!r}/page), {dt * 1e3!r} ms, "
              f"normalize launches {per_call[-1]}")
        if len(results) != N_PAGES or n_regions / N_PAGES < 10:
            raise AssertionError(f"predict {call}: too few regions "
                                 f"({n_regions} on {len(results)} pages)")
        if per_call[-1] == 0:
            raise AssertionError(f"predict {call} launched no normalize "
                                 "kernel")
        if not all(np.isfinite(r.confidence) and np.isfinite(
                np.asarray(r.box, np.float32)).all()
                for res in results for r in res.regions):
            raise AssertionError("non-finite box or confidence")
    main_launches = KERNEL.launches
    texts = [r.text for res in results for r in res.regions]
    print(f"texts: {sum(1 for t in texts if t)} of {len(texts)} non-empty, "
          f"e.g. {texts[:4]}")

    # --- 5. the card against the CPU, same port. The main path's own
    # output on its first det batch (pages 0-7) is held against the CPU
    # on those pages at the same batch sizes, so the crops pool into the
    # same recognition chunks and buckets. The blank-biased recognizer
    # emits mostly empty texts (so does the JAX bench's), so a second
    # check on 2 pages runs the unbiased weights, whose texts are not
    # empty and make the text gate bite. ---
    rec_unbiased = init_state_dict(SVTRRecognizer(vocab, 0.95),
                                   torch.Generator().manual_seed(0))
    cpu_f32 = Runtime("float32", device="cpu")
    unbiased_gpu = build_pipeline(gpu_f32, det_state, rec_unbiased,
                                  batch=(2, 64)).predict(pages[:2])
    checks = [
        ("main path, blank-biased rec", results[:8],
         build_pipeline(cpu_f32, det_state, rec_state), pages[:8]),
        ("unbiased rec", unbiased_gpu,
         build_pipeline(cpu_f32, det_state, rec_unbiased, batch=(2, 64)),
         pages[:2])]
    for label, gpu_res, cpu_pipe, sub in checks:
        report = compare_results(gpu_res, cpu_pipe.predict(sub))
        n_text = sum(1 for r in gpu_res for x in r.regions if x.text)
        print(f"gpu vs cpu ({len(sub)} pages, float32, {label}, {n_text} "
              f"non-empty texts): {json.dumps(report)}")
        if not report["ok"]:
            raise AssertionError(f"card output disagrees with the CPU "
                                 f"output ({label})")

    # --- 6. throughput ---
    f32_res, f32_pps = timed_pps(pipe, pages, card, "float32")
    bf16_pipe = build_pipeline(Runtime("bfloat16", device="cuda"),
                               det_state, rec_state)
    bf16_pipe.predict(pages)                       # warm-up call
    bf16_res, bf16_pps = timed_pps(bf16_pipe, pages, card, "bfloat16")
    agree = compare_results(bf16_res, f32_res)
    print(f"bfloat16 vs float32 (16 pages, not gated): regions "
          f"{agree['regions']} vs {agree['ref_regions']}, mean IoU "
          f"{agree['mean_iou']!r}, text mismatches "
          f"{agree['text_mismatches']}")

    print(json.dumps({"kernels": [{
        "name": KERNEL.name, "route": "cuda",
        "source": f"oar_ocr_tpu_torch/csrc/{KERNEL.source}",
        "replaces": KERNEL.replaces, "launches": main_launches,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"]}]}))
    print(f"card: {card}; pages/s float32 {f32_pps!r}, bfloat16 "
          f"{bf16_pps!r}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
