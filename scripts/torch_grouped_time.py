#!/usr/bin/env python3
"""Time K13 (`grouped_gemm`) at chip_smoke.py's nine shapes in one or more
checkouts of this repository on one card.

    python3 scripts/torch_grouped_time.py [--trace] ROOT [ROOT ...]

Runs each root in a process of its own, in the order given (pass parent,
change, change, parent to A/B two trees; to time a variant of the kernel,
make it in a gitignored copy of the tree and pass that copy). Each builds
its own grouped_gemm library only and prints one JSON line: K13 at
chip_smoke.GROUPED_CASES (Mixtral's gate and down at M = 32, 512, 2,048,
4,096, and 512 rows in one group; the inputs drawn as chip_smoke's kernel
phase draws its K13 group's), each chip_smoke.Clock's median of 25 runs
(L2 flushed) beside
torch._grouped_mm on the same operands and the relative error against the
plain version. With --trace, instead, each shape's device time a call from
a torch.profiler trace of 10 calls (L2 warm), by kernel name.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import zlib
from pathlib import Path


def measure(root: str, trace: bool) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from mistralrs_tpu_torch.ops import grouped_gemm as gg
    from mistralrs_tpu_torch.ops import kernels

    if not Path(kernels.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"{kernels.__file__} is not under {root}")
    kernels.SOURCES = ("grouped_gemm",)
    kernels.build()
    dev = torch.device("cuda")
    clock = cs.Clock(dev)
    gen = torch.Generator(device=dev).manual_seed(zlib.crc32(b"grouped"))
    E = cs.MIXTRAL_EXPERTS
    weights, cases = {}, []
    for shape, K, N, tokens, one_group in cs.GROUPED_CASES:
        if (K, N) not in weights:
            weights[(K, N)] = torch.randn(E, K, N, device=dev, generator=gen,
                                          dtype=torch.bfloat16).mul_(K ** -0.5)
        M = 2 * tokens
        if one_group:
            sizes = torch.zeros(E, dtype=torch.int32, device=dev)
            sizes[2] = M
        else:
            sizes = cs.top2_group_sizes(gen, tokens, E, dev)
        lhs = torch.randn(M, K, device=dev, generator=gen, dtype=torch.bfloat16)
        cases.append((shape, lhs, weights[(K, N)], sizes))
    rows = {}
    for shape, lhs, rhs, sizes in cases:
        got = gg.grouped_matmul(lhs, rhs, sizes).float()
        want = gg.grouped_matmul_ref(lhs, rhs, sizes).float()
        rel = float((got - want).abs().max()) / float(want.abs().max())
        if trace:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    gg.grouped_matmul(lhs, rhs, sizes)
                torch.cuda.synchronize()
            rows[shape] = {e.key[:60]: e.self_device_time_total / 1e3 / e.count
                           for e in prof.key_averages() if "grouped_gemm" in e.key}
            continue
        lib, _ = cs.grouped_library(clock, lhs, rhs, sizes, want)
        rows[shape] = [clock.ms(lambda: gg.grouped_matmul(lhs, rhs, sizes)), lib, rel]
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "rows": rows}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args()
    if args.one:
        measure(args.roots[0], args.trace)
        return 0
    for root in args.roots:
        cmd = [sys.executable, __file__, "--one"] + (["--trace"] if args.trace else [])
        r = subprocess.run(cmd + [root],
                           capture_output=True, text=True)
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
