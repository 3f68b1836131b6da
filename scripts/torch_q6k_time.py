#!/usr/bin/env python3
"""Time K3 (`q6k_q8_gemv`) and K4 (`q6k_bf16_gemv`) at 1-16 rows in one or
more checkouts of this repository on one card.

    python3 scripts/torch_q6k_time.py [--trace | --repeat N] ROOT [ROOT ...]

Runs each root in a process of its own, in the order given (pass parent,
change, change, parent to A/B two trees; to time a variant of a kernel, make
it in a gitignored copy of the tree and pass that copy). Each builds only
csrc/q6k_gemv.cu and prints one JSON line: both kernels at the Q5_K_M
path's Q6_K projections (v 4096->1024, down 14336->4096, lm_head
4096->32768; chunk span 512) at 1, 4 and 16 rows, each chip_smoke.Clock's
median of 25 runs (L2 flushed) beside the relative error against the
plain version. With --trace, instead, the device time a call of each
kernel a call launches (K3's quantize kernel and GEMV; K4's GEMV), from a
torch.profiler trace of 10 calls (L2 warm), at 16 rows. With --repeat N,
instead, each case is called N times (the L2 flushed and the card kept
busy before every other call, as chip_smoke.Clock does) and the line gives
the calls whose output differs in any bit from the first call's, beside
the first call's relative error against the plain version.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SHAPES = (("v", 4096, 1024), ("down", 14336, 4096), ("lm_head", 4096, 32768))
ROWS = (1, 4, 16)
G = 512


def measure(root: str, trace: bool, repeat: int = 0) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from mistralrs_tpu_torch.ops import kernels
    from mistralrs_tpu_torch.ops import quant_matmul as qm

    if not Path(kernels.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"{kernels.__file__} is not under {root}")
    kernels.SOURCES = ("q6k_gemv",)
    kernels.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    clock = cs.Clock(dev)
    out = {}
    for name, K, O in SHAPES:
        ql = torch.randint(0, 256, (K // 2, O), dtype=torch.uint8, device=dev, generator=gen)
        qh = torch.randint(0, 256, (K // 4, O), dtype=torch.uint8, device=dev, generator=gen)
        scale = (torch.rand(K // 16, O, device=dev, generator=gen) * 0.004 + 0.001).to(
            torch.bfloat16)
        for B in ((16,) if trace else ROWS):
            x = torch.randn(B, K, device=dev, generator=gen).to(torch.bfloat16)
            for kern, fn, plain in (("k3", qm.q6k_q8_gemv, qm.q6k_q8_gemv_plain),
                                    ("k4", qm.q6k_bf16_gemv, qm.q6k_bf16_gemv_plain)):
                call = lambda: fn(x, ql, qh, scale, G, out_dtype=torch.bfloat16)  # noqa: E731
                key = f"{kern} {name} B={B}"
                if trace:
                    out[key] = trace_call(torch, call)
                    continue
                got = fn(x, ql, qh, scale, G, out_dtype=torch.float32)
                want = plain(x, ql, qh, scale, G, torch.float32)
                rel = float((got - want).abs().max()) / float(want.abs().max())
                if repeat:
                    out[key] = [differing_calls(torch, clock, call, repeat), rel]
                else:
                    out[key] = [clock.ms(call), rel]
    return {"root": root, "device": torch.cuda.get_device_name(0), "rows": out}


def differing_calls(torch, clock, call, n: int) -> int:
    """How many of n calls differ in any bit from the first."""
    first = call()
    outs = []
    for i in range(n):
        if i % 2:
            clock.flush.zero_()
            torch.cuda._sleep(100_000)
        outs.append(call())
    torch.cuda.synchronize()
    return sum(not torch.equal(o, first) for o in outs)


def trace_call(torch, call, n: int = 10) -> dict:
    """{kernel name: device ms a call} over a trace of n calls."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / n for e in prof.key_averages()
            if getattr(e.device_type, "name", "") == "CUDA" and e.self_device_time_total > 0}


def main() -> int:
    args = sys.argv[1:]
    trace = "--trace" in args
    args = [a for a in args if a != "--trace"]
    repeat = 0
    if "--repeat" in args:
        i = args.index("--repeat")
        repeat = int(args[i + 1])
        del args[i:i + 2]
    if args and args[0] == "--one":
        print(json.dumps(measure(args[1], trace, repeat)), flush=True)
        return 0
    for root in args:
        cmd = ([sys.executable, __file__, "--one", root] + (["--trace"] if trace else [])
               + (["--repeat", str(repeat)] if repeat else []))
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
