#!/usr/bin/env python3
"""Where a decode call of K1 (`q4k_q8_gemv`) and K2 (`q8_0_q8_gemv`) spends
its time, for one or more checkouts of this repository on one card.

    python3 scripts/torch_gemv_trace.py ROOT [ROOT ...]

For each root, in the order given (each in a process of its own, building
its own kernels), at Mistral-7B Q4_K_M's decode shapes (K1: fused q|k, o,
gate|up, down; K2 on rq8 weights: v, down, the padded lm_head) and 16 and 1
rows: chip_smoke.Clock's time of a call (median of 25, L2 flushed), and,
from a torch.profiler trace of 12 calls run the same way, the median
device time of each of the call's kernels (the activation quantize kernel,
the GEMV, a split-K pass where there is one) and of the span from the
first kernel's start to the last one's end. One JSON line a shape. To
compare variants of a kernel, make them in copies of the tree (in a
directory that .gitignore lists) and pass each copy as a root.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

K1_CASES = (("qk", 4096, 5120), ("o", 4096, 4096), ("gate|up", 4096, 28672),
            ("down", 14336, 4096))
K2_CASES = (("v", 4096, 1024), ("down rq8", 14336, 4096), ("lm_head", 4096, 32768))


def part_of(name: str) -> str | None:
    """Which part of a K1/K2 call a kernel is (None: not one of its)."""
    if "splitk_reduce" in name:
        return "reduce"
    if "quantize_acts" in name:
        return "quantize"
    if "q4k_q8_" in name or "q8_0_q8_" in name:
        return "gemv"
    return None


def trace(torch, flush, fn, calls: int = 12) -> dict:
    """Median device times (us) of a call's kernels, from a trace of calls
    each run as chip_smoke.Clock runs them (L2 flushed, the card kept busy)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            torch.cuda._sleep(500_000)
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if getattr(e.device_type, "name", "") == "CUDA"),
                    key=lambda e: e.time_range.start)
    per_call, cur = [], []
    for e in events:  # a call's kernels run between a flush and the next
        part = part_of(e.name)
        if part is None:
            if cur:
                per_call.append(cur)
                cur = []
            continue
        cur.append((part, e.time_range.start, e.time_range.end))
    if cur:
        per_call.append(cur)
    out: dict[str, list] = {}
    for c in per_call[1:]:
        for part, start, end in c:
            out.setdefault(part, []).append(end - start)
        out.setdefault("span", []).append(c[-1][2] - c[0][1])
    return {f"{k}_us": statistics.median(v) for k, v in out.items()}


def measure(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from mistralrs_tpu_torch.ops import kernels
    from mistralrs_tpu_torch.ops import quant_matmul as qm

    if not Path(kernels.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"{kernels.__file__} is not under {root}")
    kernels.build()
    dev = torch.device("cuda")
    clock = cs.Clock(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for nm, K, O in K1_CASES:
        qs = torch.randint(0, 256, (K // 2, O), dtype=torch.uint8, device=dev, generator=gen)
        scale = (torch.rand(K // 32, O, device=dev, generator=gen) * 0.004 + 0.001).bfloat16()
        minv = (torch.rand(K // 32, O, device=dev, generator=gen) * 0.002).bfloat16()
        for B in (16, 1):
            x = torch.randn(B, K, device=dev, generator=gen).bfloat16()
            fn = lambda: qm.q4k_q8_gemv(x, qs, scale, minv)  # noqa: E731
            print(json.dumps({"root": root, "shape": f"k1 {nm} B={B}", "ms": clock.ms(fn),
                              **trace(torch, clock.flush, fn)}), flush=True)
    for nm, K, O in K2_CASES:
        q = torch.randint(-127, 128, (K, O), dtype=torch.int8, device=dev, generator=gen)
        s = torch.rand(K // 32, O, device=dev, generator=gen) * 3e-4 + 1e-4
        for B in (16, 1):
            x = torch.randn(B, K, device=dev, generator=gen).bfloat16()
            fn = lambda: qm.q8_0_q8_gemv(x, q, s, 32)  # noqa: E731
            print(json.dumps({"root": root, "shape": f"k2 {nm} B={B}", "ms": clock.ms(fn),
                              **trace(torch, clock.flush, fn)}), flush=True)


def main() -> int:
    if sys.argv[1] == "--one":
        measure(sys.argv[2])
        return 0
    for root in sys.argv[1:]:
        r = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                           text=True)
        if r.returncode:
            print(r.stderr, file=sys.stderr)
            return r.returncode
        print(r.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
