#!/usr/bin/env python3
"""Time the rows instantiations of K9 (`q5k_q8_gemv`), K10 (`affine_gemv`),
K4 (`q6k_bf16_gemv`), K9b (`q5k_hbit_bf16_gemv`), K5 (`q4k_bf16_gemv`) and
K8 (`q8_0_bf16_gemv`) in one or more checkouts of this repository on one
card.

    python3 scripts/torch_rows_time.py [--trace] ROOT [ROOT ...]

Runs each root in a process of its own, in the order given (pass parent,
change, change, parent to A/B two trees; to time a variant of a kernel, make
it in a gitignored copy of the tree and pass that copy). Each builds its own
kernels and prints one JSON line: K9 at Mistral-7B's gate|up (4096->28672)
at 64 and 256 rows, K10 at Q2_K's gate|up (64 and 256 rows) and q|k
(4096->5120, 256), GPTQ-8 (group 128), HQQ-1 and HQQ-2 (group 64) and
GPTQ-4 (group 16) at gate|up, 256 rows, K4 at the Q6_K down (14336->4096)
and v (4096->1024), K9b and K5 at gate|up, all at 64 and 256 rows, K5 at
down (256), K8 on rq8's f32 scales at the lm_head (4096->32768, 64 and
256 rows), down (256) and v (17, 64 and 256) and on wire Q8_0's bf16 scales at the lm_head
(64), each time chip_smoke.Clock's median of 25 runs (L2 flushed) beside
the relative error against the plain version (but K9's). A tree whose
kernel has no rows instantiation times its older kernel at the same call.
With --trace, instead, the device time a call of each kernel a rows call
launches (the pre-pass, the GEMV and, with K splits, the split-K pass),
from a torch.profiler trace of 10 calls (L2 warm), of K10 at Q2_K's
gate|up (64 and 256 rows) and GPTQ-8's (256), K4 at down (256), K9b and
K5 at gate|up (64 and 256), K5 at down (256) and K8 at the lm_head (64
and 256) and v (256).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# (format, bits, group, name, K, O, rows)
K10_CASES = (("q2k", 2, 16, "gate|up", 4096, 28672, (64, 256)),
             ("q2k", 2, 16, "qk", 4096, 5120, (256,)),
             ("gptq8", 8, 128, "gate|up", 4096, 28672, (256,)),
             ("hqq1", 1, 64, "gate|up", 4096, 28672, (256,)),
             ("hqq2", 2, 64, "gate|up", 4096, 28672, (256,)),
             ("gptq4", 4, 16, "gate|up", 4096, 28672, (256,)))
TRACE_CASES = (("q2k", 2, 16, 4096, 28672, 256), ("q2k", 2, 16, 4096, 28672, 64),
               ("gptq8", 8, 128, 4096, 28672, 256))
# (name, K, O, rows): K4 at the Q6_K projections, K9b at gate|up
K4_CASES = (("down", 14336, 4096, (64, 256)), ("v", 4096, 1024, (64, 256)))
K9B_CASES = (("gate|up", 4096, 28672, (64, 256)),)
# (name, K, O, rows): K5 at gate|up and down; (name, K, O, f32 scales, rows): K8
K5_CASES = (("gate|up", 4096, 28672, (64, 256)), ("down", 14336, 4096, (256,)))
K8_CASES = (("lm_head", 4096, 32768, True, (64, 256)), ("down", 14336, 4096, True, (256,)),
            ("v", 4096, 1024, True, (17, 64, 256)), ("lm_head wire", 4096, 32768, False, (64,)))
K5_TRACE = (("gate|up", 4096, 28672, 64), ("gate|up", 4096, 28672, 256), ("down", 14336, 4096, 256))
K8_TRACE = (("lm_head", 4096, 32768, 64), ("lm_head", 4096, 32768, 256), ("v", 4096, 1024, 256))


def setup(root: str):
    sys.path.insert(0, root)
    import torch

    from mistralrs_tpu_torch.ops import kernels

    if not Path(kernels.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"{kernels.__file__} is not under {root}")
    kernels.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    def scales(*shape, lo=0.001, hi=0.005, dtype=torch.bfloat16):
        return (torch.rand(shape, device=dev, generator=gen) * (hi - lo) + lo).to(dtype)

    def acts(B, K):
        return torch.randn(B, K, device=dev, generator=gen).to(torch.bfloat16)

    return torch, dev, u8, scales, acts


def measure(root: str) -> dict:
    torch, dev, u8, scales, acts = setup(root)
    import chip_smoke as cs
    from mistralrs_tpu_torch.ops import quant_matmul as qm

    clock = cs.Clock(dev)
    out = {}
    K, O = 4096, 28672
    qs, qh = u8(K // 2, O), u8(K // 8, O)
    sc, mn = scales(K // 32, O), scales(K // 32, O, lo=0.0, hi=0.002)
    for B in (64, 256):
        x = acts(B, K)
        out[f"k9 gate|up B={B}"] = clock.ms(lambda: qm.q5k_q8_gemv(x, qs, qh, sc, mn))
    del qs, qh
    def timed(call, plain):
        got, want = call(torch.float32), plain()
        return [clock.ms(lambda: call(torch.bfloat16)),
                float((got - want).abs().max() / want.abs().max())]

    for fmt, bits, group, name, K, O, rows in K10_CASES:
        q, sc = u8(K * bits // 8, O), scales(K // group, O)
        zs = (1.5 * sc.float()).to(torch.bfloat16)
        for B in rows:
            x = acts(B, K)
            out[f"k10 {fmt} {name} B={B}"] = timed(
                lambda dt: qm.affine_gemv(x, q, sc, zs, bits, group, out_dtype=dt),
                lambda: qm.affine_gemv_plain(x, q, sc, zs, bits, group, torch.float32))
        del q
    for name, K, O, rows in K4_CASES:
        ql, qh, sc = u8(K // 2, O), u8(K // 4, O), scales(K // 16, O)
        G = 512
        for B in rows:
            x = acts(B, K)
            out[f"k4 {name} B={B}"] = timed(
                lambda dt: qm.q6k_bf16_gemv(x, ql, qh, sc, G, out_dtype=dt),
                lambda: qm.q6k_bf16_gemv_plain(x, ql, qh, sc, G, torch.float32))
    for name, K, O, rows in K9B_CASES:
        qh, sc = u8(K // 8, O), scales(K // 32, O)
        for B in rows:
            x = acts(B, K)
            out[f"k9b {name} B={B}"] = timed(
                lambda dt: qm.q5k_hbit_bf16_gemv(x, qh, sc, out_dtype=dt),
                lambda: qm.q5k_hbit_bf16_gemv_plain(x, qh, sc, torch.float32))
    for name, K, O, rows in K5_CASES:
        qs, sc, mn = u8(K // 2, O), scales(K // 32, O), scales(K // 32, O, lo=0.0, hi=0.002)
        for B in rows:
            x = acts(B, K)
            out[f"k5 {name} B={B}"] = timed(
                lambda dt: qm.q4k_bf16_gemv(x, qs, sc, mn, out_dtype=dt),
                lambda: qm.q4k_bf16_gemv_plain(x, qs, sc, mn, torch.float32))
        del qs
    for name, K, O, f32, rows in K8_CASES:
        q = u8(K, O).view(torch.int8)
        s = scales(K // 32, O, lo=1e-4, hi=4e-4, dtype=torch.float32 if f32 else torch.bfloat16)
        for B in rows:
            x = acts(B, K)
            out[f"k8 {name} B={B}"] = timed(
                lambda dt: qm.q8_0_bf16_gemv(x, q, s, out_dtype=dt),
                lambda: qm.q8_0_bf16_gemv_plain(x, q, s, torch.float32))
        del q
    return {"root": root, "device": torch.cuda.get_device_name(0), "rows": out}


def trace(root: str) -> dict:
    torch, dev, u8, scales, acts = setup(root)
    from torch.profiler import ProfilerActivity, profile

    from mistralrs_tpu_torch.ops import quant_matmul as qm

    def kernel_ms(call):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        return {e.key[:60]: e.self_device_time_total / 10 / 1e3 for e in prof.key_averages()
                if e.self_device_time_total > 0}

    out = {}
    for fmt, bits, group, K, O, B in TRACE_CASES:
        q, sc = u8(K * bits // 8, O), scales(K // group, O)
        zs = (1.5 * sc.float()).to(torch.bfloat16)
        x = acts(B, K)
        out[f"{fmt} gate|up B={B}"] = kernel_ms(lambda: qm.affine_gemv(x, q, sc, zs, bits, group))
    K, O = 14336, 4096
    ql, qh, sc, x = u8(K // 2, O), u8(K // 4, O), scales(K // 16, O), acts(256, K)
    out["k4 down B=256"] = kernel_ms(lambda: qm.q6k_bf16_gemv(x, ql, qh, sc, 512))
    K, O = 4096, 28672
    qh, sc = u8(K // 8, O), scales(K // 32, O)
    for B in (64, 256):
        x = acts(B, K)
        out[f"k9b gate|up B={B}"] = kernel_ms(lambda: qm.q5k_hbit_bf16_gemv(x, qh, sc))
    for name, K, O, B in K5_TRACE:
        qs, sc, mn = u8(K // 2, O), scales(K // 32, O), scales(K // 32, O, lo=0.0, hi=0.002)
        x = acts(B, K)
        out[f"k5 {name} B={B}"] = kernel_ms(lambda: qm.q4k_bf16_gemv(x, qs, sc, mn))
    for name, K, O, B in K8_TRACE:
        q, s = u8(K, O).view(torch.int8), scales(K // 32, O, lo=1e-4, hi=4e-4, dtype=torch.float32)
        x = acts(B, K)
        out[f"k8 {name} B={B}"] = kernel_ms(lambda: qm.q8_0_bf16_gemv(x, q, s))
    return {"root": root, "device": torch.cuda.get_device_name(0), "kernel_ms": out}


def main() -> int:
    args = sys.argv[1:]
    if args[0] == "--one":
        fn = trace if args[1] == "trace" else measure
        print(json.dumps(fn(args[2])), flush=True)
        return 0
    mode = "trace" if args[0] == "--trace" else "time"
    for root in args[1:] if mode == "trace" else args:
        r = subprocess.run([sys.executable, __file__, "--one", mode, root], capture_output=True,
                           text=True)
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
