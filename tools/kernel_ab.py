#!/usr/bin/env python3
"""Time one kernel's ``chip_smoke.py`` cases from two or more checkouts
on one card, in turns: base, change, change, base (with several changes
base, c1 .. cn, cn .. c1, base).

Each turn is a fresh process that imports ``chip_smoke.py`` and the port
from its checkout, builds the kernel from that checkout's sources, holds
every case to its gate (a case that fails it raises, naming the case)
and then takes the case's device time with ``chip_smoke.device_ms``: the
median of 20 calls, each between its own CUDA events after a 256 MB
write that empties the L2, all queued behind a ``torch.cuda._sleep``
spin, raising below the case's bound. Before the turns each checkout's
kernel is built, all at once, and its ptxas report (registers, shared
memory, spills) is printed; for K2 also each float32 instance's threads,
shared memory and CTAs per SM, found and declared, by instance name.
Cases are matched by name; a case only one side has is reported for that
side alone. ``--cases TREE`` takes every turn's cases from TREE's
``chip_smoke.py`` (each turn still imports the port from its own tree),
so a parent that lacks cases a change adds is timed on them too. Two
versions are compared only within one call of this script, on one card.

Usage (on a machine with a CUDA card; BASE is a checkout of the parent
commit, e.g. ``git archive`` unpacked into a git-ignored directory)::

    python3 tools/kernel_ab.py --kernel K2 --base BASE [--change .]
        [--change OTHER ...] [--cases TREE] [--only REGEX]
        [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# each kernel: chip_smoke's case functions (a tree without one skips it),
# the kernel's name in messages, and its binding (module, attribute) in
# the port
KERNELS = {
    "K1": (("k1_cases",), "normalize_kernel",
           ("oar_ocr_tpu_torch.ops.normalize", "KERNEL")),
    "K2": (("k2_cases", "exact_k2_cases", "family_k2_cases"), "flash_",
           ("oar_ocr_tpu_torch.ops.flash_attention", "KERNEL")),
    "K3": (("k3_cases",), "add_rmsnorm_kernel",
           ("oar_ocr_tpu_torch.ops.fused_norm_rope", "KERNEL")),
    "K4": (("k4_cases", "exact_k4_cases"), "qk_norm_rope_kernel",
           ("oar_ocr_tpu_torch.ops.fused_norm_rope", "KERNEL_QK")),
}
TURN_TIMEOUT_S = 1200


def import_tree(tree: str, cases=None):
    """``chip_smoke`` imported from checkout ``cases`` (default ``tree``),
    the port from checkout ``tree``."""
    import importlib.util

    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    sys.modules.pop("chip_smoke", None)
    path = pathlib.Path(cases or tree).resolve() / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = chip_smoke
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def kernel_cases(cs, kernel: str, only=None) -> list:
    """Every case of ``kernel`` in chip_smoke module ``cs``, those whose
    name matches the regular expression ``only`` if given."""
    makers = [getattr(cs, b) for b in KERNELS[kernel][0] if hasattr(cs, b)]
    cases = [c for make in makers for c in make()]
    return [c for c in cases if only is None or re.search(only, c[0])]


def time_cases(cs, cases, symbol: str) -> dict:
    """{case name: {"device_ms", "bound_ms"}}, each case's gate held
    before it is timed."""
    out = {}
    for name, kernel, _plain, reference, gate, work in cases:
        err, ok, detail = gate(kernel(), reference())
        if not ok:
            raise AssertionError(f"{name}: the kernel fails its gate "
                                 f"(max_abs_err {err!r}, {detail})")
        out[name] = {"device_ms": cs.device_ms(kernel, symbol,
                                               bound_ms=work["bound_ms"]),
                     "bound_ms": work["bound_ms"]}
    return out


def turn(tree: str, kernel: str, only=None, cases=None) -> dict:
    """One turn in this process: the cases of ``cases`` (default
    ``tree``) on ``tree``'s port, gated and timed."""
    cs = import_tree(tree, cases)
    return time_cases(cs, kernel_cases(cs, kernel, only), KERNELS[kernel][1])


def report(tree: str, kernel: str) -> dict:
    """Build ``tree``'s kernel and read its ptxas report; for K2 also each
    float32 instance's threads, shared memory and CTAs per SM (found by
    the occupancy calculator, and declared), by instance name (a library
    older than ``oar_flash_fma_name``: by head dim)."""
    import ctypes
    import importlib

    cs = import_tree(tree)
    module, attr = KERNELS[kernel][2]
    built = getattr(importlib.import_module(module), attr).build()
    out = {"library": built.path.name,
           "nvcc_s": built.build_seconds,
           "ptxas": {cs.demangle(f): r
                     for f, r in cs.ptxas_report(built.log).items()}}
    if kernel == "K2" and hasattr(built.lib, "oar_flash_fma_name"):
        fa = importlib.import_module(module)
        out["fma"] = {f.pop("name"): f for f in fa.fma_instances(built.lib)}
    elif kernel == "K2":
        out["fma"] = {}
        for d in (64, 72, 80, 128):
            vals = [ctypes.c_int() for _ in range(4)]
            rc = built.lib.oar_flash_fma_info(d, *map(ctypes.byref, vals))
            out["fma"][f"D = {d}"] = dict(
                zip(("threads", "smem_bytes", "ctas_per_sm",
                     "declared_ctas"), (x.value for x in vals)), rc=rc)
    return out


def turn_order(changes: int) -> list:
    """base, change 1 .. n, change n .. 1, base, by index into the trees
    (0 the base)."""
    ups = list(range(1, changes + 1))
    return [0, *ups, *reversed(ups), 0]


def summarize(trees: list, runs: list) -> list:
    """Per case: each tree's device times, the bound, and each change's
    median over the base's median."""
    names = list(dict.fromkeys(n for _, r in runs for n in r))
    rows = []
    for name in names:
        ms = [[r[name]["device_ms"] for t, r in runs if t == i and name in r]
              for i in range(len(trees))]
        bound = next(r[name]["bound_ms"] for _, r in runs if name in r)
        ratios = [statistics.median(m) / statistics.median(ms[0])
                  if m and ms[0] else None for m in ms[1:]]
        rows.append({"name": name, "bound_ms": bound, "device_ms": ms,
                     "change_over_base": ratios})
    return rows


def _child(args, tree: str, mode: str) -> dict:
    cmd = [sys.executable, __file__, "--kernel", args.kernel, "--base",
           args.base, mode, tree]
    if args.only:
        cmd += ["--only", args.only]
    if args.cases:
        cmd += ["--cases", args.cases]
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=TURN_TIMEOUT_S)
    if out.returncode != 0:
        raise RuntimeError(f"{mode} {tree} failed (exit {out.returncode}):"
                           f"\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(KERNELS), required=True)
    ap.add_argument("--base", required=True, help="checkout of the parent")
    ap.add_argument("--change", action="append",
                    help="checkout of a change (repeatable; default .)")
    ap.add_argument("--only", help="time only cases matching this regex")
    ap.add_argument("--cases", help="take every turn's cases from this "
                    "checkout's chip_smoke.py (default: each tree's own)")
    ap.add_argument("--out", help="also write the results here as JSON")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--report", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn(args.turn, args.kernel, args.only,
                              args.cases)))
        return 0
    if args.report:
        print(json.dumps(report(args.report, args.kernel)))
        return 0
    trees = [args.base, *(args.change or ["."])]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(max_workers=len(trees)) as pool:
        reports = list(pool.map(lambda t: _child(args, t, "--report"),
                                trees))
    for tree, rep in zip(trees, reports):
        print(f"{tree}: {rep['library']} (nvcc {rep['nvcc_s']!r} s)")
        for func, r in rep["ptxas"].items():
            print(f"  {func}: {r['registers']} registers, {r['spill']} "
                  f"bytes spilled")
        for name, f in rep.get("fma", {}).items():
            print(f"  flash_fma_kernel {name}: {f}")
    runs = [(i, _child(args, trees[i], "--turn"))
            for i in turn_order(len(trees) - 1)]
    rows = summarize(trees, runs)
    order = ", ".join("base" if i == 0 else f"change {i}"
                      for i in turn_order(len(trees) - 1))
    print(f"{args.kernel} device ms, base {trees[0]} vs "
          f"{', '.join(trees[1:])}; turns {order} [{card}]")
    for row in rows:
        print(f"  {row['name']}: bound {row['bound_ms']!r} ms")
        for tree, ms in zip(trees, row["device_ms"]):
            print(f"    {tree}: {ms!r}")
        print(f"    change/base {row['change_over_base']!r}")
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            {"card": card, "kernel": args.kernel, "trees": trees,
             "cases_from": args.cases,
             "turns": [i for i, _ in runs], "reports": reports,
             "cases": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
