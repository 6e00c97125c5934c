#!/usr/bin/env python3
"""Time one kernel's ``chip_smoke.py`` cases from two checkouts on one
card, in turns: base, change, change, base.

Each turn is a fresh process that imports ``chip_smoke.py`` and the port
from its checkout, builds the kernel from that checkout's sources and
takes every case's device time (``chip_smoke.device_ms``: the
``torch.profiler`` mean of 20 calls). Cases are matched by name; a case
only one side has is reported for that side alone. Two versions are
compared only within one call of this script, on one card.

Usage (on a machine with a CUDA card; BASE is a checkout of the parent
commit, e.g. ``git archive`` unpacked into a git-ignored directory)::

    python3 tools/kernel_ab.py --kernel K4 --base BASE [--change .]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

# chip_smoke's case builders and the profiler symbol of each kernel
CASES = {"K1": ("k1_cases", "normalize_kernel"),
         "K2": ("k2_cases", "flash_"),
         "K3": ("k3_cases", "add_rmsnorm_kernel"),
         "K4": ("k4_cases", "qk_norm_rope_kernel")}


def turn(tree: str, kernel: str) -> None:
    """One turn in this process: print {case name: device ms} as JSON."""
    root = pathlib.Path(tree).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    builder, symbol = CASES[kernel]
    print(json.dumps({name: cs.device_ms(fn, symbol)
                      for name, fn, *_ in getattr(cs, builder)()}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(CASES), required=True)
    ap.add_argument("--base", required=True, help="checkout of the parent")
    ap.add_argument("--change", default=".", help="checkout of the change")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        turn(args.turn, args.kernel)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    times = {"base": [], "change": []}
    for side in ("base", "change", "change", "base"):
        out = subprocess.run(
            [sys.executable, __file__, "--kernel", args.kernel, "--base",
             args.base, "--turn", getattr(args, side)],
            capture_output=True, text=True, check=True, timeout=1200)
        times[side].append(json.loads(out.stdout.strip().splitlines()[-1]))
    names = list(dict.fromkeys(n for runs in times.values() for r in runs
                               for n in r))
    print(f"{args.kernel} device ms, base {args.base} vs change "
          f"{args.change}, turns base, change, change, base [{card}]")
    for name in names:
        base = [r[name] for r in times["base"] if name in r]
        change = [r[name] for r in times["change"] if name in r]
        ratio = (statistics.median(change) / statistics.median(base)
                 if base and change else None)
        print(f"  {name}: base {base!r}, change {change!r}, "
              f"change/base {ratio!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
