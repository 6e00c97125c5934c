#!/usr/bin/env python3
"""Profile one of the PyTorch port's main paths on one CUDA card.

``--path ocr`` (the default) runs chip_smoke's OCR workload (16 synthetic
1280×960 pages, the trained bench detector, blank-biased random
recognizer) through ``OAROCR.predict``; ``--path vl`` runs chip_smoke's
VL request 1 (the page and its 448×448 crop, task "ocr", 32 new tokens)
through ``PaddleOCRVL.generate``, and ``--path hunyuan`` its HunyuanOCR
request (the page, "OCR:", 32 new tokens) through
``HunyuanOCRModel.generate``, both at full width with seeded random
weights; they decode as they serve, by replaying each (batch, KV
capacity) key's captured CUDA graph. Per compute dtype it reports:

- the host stage breakdown (``utils.tracing`` stage timers, median call);
- the device kernels by total device time (``torch.profiler``) and the
  device busy share of the profiled call (kernel time / wall time);
- for the VL paths, the decode steps alone, through the graph and
  through the eager step (``graph=False``): ``prefill_decode`` of the
  request at KV capacity 2048 with a short and a long run of new tokens
  (VL 32 and 128, HunyuanOCR 16 and 64), and from the difference the
  decode ms/token, its device time per token by kernel, its busy share
  and the host stalls on a full launch queue per token.

Usage (from the repository root, on a machine with a CUDA card)::

    python3 tools/port_profile.py [--path ocr|vl|hunyuan] [--out FILE]
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]


def profile(run, card: str, label: str):
    """Report lines for ``run()``: two warm-up calls, three timed calls
    with the stage timers, one profiled call."""
    import torch

    from oar_ocr_tpu_torch.utils.tracing import METRICS

    run()
    run()
    METRICS.reset()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    stages = METRICS.summary()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device kernels only: the aten ops' rows repeat their kernels'
    # time, and CUPTI's "Command Buffer Full" rows mark the host
    # stalling on a full launch queue, not device work
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != "Command Buffer Full"]
    dev_total_us = sum(e.self_device_time_total for e in kernels)
    lines = [f"== {label}: wall per call {sorted(walls)[1]!r} s "
             f"(unprofiled median of 3), profiled {wall!r} s, device "
             f"kernel time {dev_total_us / 1e6!r} s, busy share "
             f"{dev_total_us / 1e6 / wall!r} [{card}]",
             "host stages (count, total s, mean s; over 3 calls):"]
    for k, v in sorted(stages.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {k}: {v}")
    stalls = sum(e.count for e in events if e.key == "Command Buffer Full")
    lines.append(f"host stalls on a full launch queue: {stalls}")
    lines.append("device kernels (self device us, calls):")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]
    for e in top:
        if e.self_device_time_total:
            lines.append(f"  {e.self_device_time_total:12.1f} "
                         f"{e.count:6d}  {e.key[:100]}")
    return lines


def profiled(fn):
    """Device time (s) by kernel name and the "Command Buffer Full"
    stalls of one profiled call of ``fn``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = {e.key: e.self_device_time_total / 1e6 for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.key != "Command Buffer Full"}
    return dev, sum(e.count for e in events if e.key == "Command Buffer Full")


def decode_window(decode, short: int, long: int, card: str, label: str):
    """Report lines for the decode steps alone: ``decode(n, graph)`` runs
    prefill and ``n`` steps; the steps' share is the difference of a
    ``long`` and a ``short`` run (unprofiled walls, median of 3; device
    time and stalls from one profiled call each), through the graph and
    through the eager step."""
    lines = []
    for graph, how in ((True, "graph"), (False, "eager")):
        lines += _decode_window(lambda n: decode(n, graph), short, long,
                                card, f"{label}, {how} decode")
    return lines


def _decode_window(decode, short: int, long: int, card: str, label: str):
    import torch

    walls, devs, stalls = {}, {}, {}
    for n in (short, long):
        decode(n)
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(n)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        walls[n] = sorted(ts)[1]
        devs[n], stalls[n] = profiled(lambda n=n: decode(n))
    steps = long - short
    per_kernel = {k: t - devs[short].get(k, 0.0)
                  for k, t in devs[long].items()}
    wall, dev = walls[long] - walls[short], sum(per_kernel.values())
    lines = [f"decode steps {label} ({short} -> {long} new tokens): "
             f"{wall / steps * 1e3!r} ms/token wall, {dev / steps * 1e3!r} "
             f"ms/token device, busy share {dev / wall!r}, host stalls on a "
             f"full launch queue {(stalls[long] - stalls[short]) / steps!r} "
             f"per token [{card}]",
             "  device us per decode step by kernel:"]
    for k, t in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        lines.append(f"  {t / steps * 1e6:10.2f}  {k[:100]}")
    return lines


def ocr_runs(cs):
    import torch

    from oar_ocr_tpu_torch.models.layers import init_state_dict
    from oar_ocr_tpu_torch.models.recognition.svtr import SVTRRecognizer
    from oar_ocr_tpu_torch.ops.ctc import default_charset
    from oar_ocr_tpu_torch.runtime.runtime import Runtime
    from oar_ocr_tpu_torch.runtime.weights import load_jax_checkpoint

    det = load_jax_checkpoint(str(REPO / "assets" / "bench_det.safetensors"))
    rec = init_state_dict(SVTRRecognizer(2 + len(default_charset()), 0.95),
                          torch.Generator().manual_seed(0))
    rec["head.ctc_head.fc.bias"][0] += 4.0
    pages = cs.make_pages(0)
    for dtype in ("float32", "bfloat16"):
        pipe = cs.build_pipeline(Runtime(dtype, device="cuda"), det, rec)
        yield dtype, lambda pipe=pipe: pipe.predict(pages), None


def vl_runs(cs):
    import numpy as np

    from oar_ocr_tpu_torch.runtime.runtime import Runtime
    from oar_ocr_tpu_torch.vl import PaddleOCRVL

    page = cs.make_pages(0)[0]
    crop = np.ascontiguousarray(page[:448, :448])
    for dtype in ("bfloat16", "float32"):
        vlm = PaddleOCRVL(runtime=Runtime(dtype, device="cuda"), seed=0)
        rt = vlm.runtime
        batch = vlm.prepare_vision([page, crop], "ocr")
        prompts = vlm.build_prompts(batch, "ocr")
        embeds = vlm.fuse_embeds(prompts, vlm.encode_vision(batch))
        pos, vl = rt.put(prompts.positions), rt.put(prompts.valid_lengths)

        def decode(n, graph, vlm=vlm, embeds=embeds, pos=pos, vl=vl):
            return vlm.prefill_decode(embeds, pos, vl, max_new=n,
                                      capacity=2048, graph=graph)[0].cpu()

        yield (dtype, lambda vlm=vlm: vlm.generate(
            [page, crop], "ocr", max_new_tokens=32), (decode, 32, 128))
        del vlm, embeds, decode


def hunyuan_runs(cs):
    from oar_ocr_tpu_torch.runtime.runtime import Runtime
    from oar_ocr_tpu_torch.vl.hunyuan import HunyuanOCRModel

    page = cs.make_pages(0)[0]
    for dtype in ("bfloat16", "float32"):
        model = HunyuanOCRModel(runtime=Runtime(dtype, device="cuda"), seed=0)
        patches, gh, gw = model.prepare_image(page)
        ids, pids, _ = model.build_prompt(gh, gw, "OCR:")
        embeds = model.fuse_embeds(ids, model.encode_image(
            patches, model.position_rows(gh, gw), gh, gw))
        pids = model.runtime.put(pids)[:, None, :]

        def decode(n, graph, model=model, embeds=embeds, pids=pids):
            return model.prefill_decode(embeds, pids, max_new=n,
                                        capacity=2048,
                                        graph=graph)[0].cpu()

        yield (dtype, lambda model=model: model.generate(
            [page], "OCR:", max_new_tokens=32), (decode, 16, 64))
        del model, embeds, decode


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_profile: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("ocr", "vl", "hunyuan"),
                    default="ocr")
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    lines = [f"card: {card}"]
    runs = {"ocr": ocr_runs, "vl": vl_runs,
            "hunyuan": hunyuan_runs}[args.path](cs)
    for dtype, run, window in runs:
        label = f"{args.path} {dtype}"
        lines += profile(run, card, label)
        if window is not None:
            lines += decode_window(*window, card, label)
    text = "\n".join(lines)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
