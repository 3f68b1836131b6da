#!/usr/bin/env python3
"""Time the decode instantiations (1-16 rows) of K3 (`q6k_q8_gemv`), K4
(`q6k_bf16_gemv`), K8 (`q8_0_bf16_gemv`), K10 (`affine_gemv`), K5
(`q4k_bf16_gemv`) and K9 (`q5k_q8_gemv`), and the Q5_K x bf16 product at
1-16 rows (`q5k`: K9b's decode instantiation, through the dispatcher), in
one or more checkouts of this repository on one card.

    python3 scripts/torch_q6k_time.py [--trace | --repeat N] [--kernels k3,k4,k8,k10,k5,k9,q5k] ROOT [ROOT ...]

Runs each root in a process of its own, in the order given (pass parent,
change, change, parent to A/B two trees; to time a variant of a kernel, make
it in a gitignored copy of the tree and pass that copy). Each builds only
the sources of the kernels asked for (default: all six) and prints one
JSON line: K3 and K4 at the Q5_K_M path's Q6_K projections (v
4096->1024, down 14336->4096, lm_head 4096->32768; chunk span 512); K8 on
rq8's f32 scales at v, q|k (4096->5120), gate|up (4096->28672), down and
the lm_head, and on wire Q8_0's bf16 scales at the lm_head; K10 at Q2_K's
q|k and gate|up (group 16), GPTQ-8's down and gate|up (group 128), HQQ-1's
and HQQ-2's gate|up (group 64) and GPTQ-4's (group 16); K5 and K9 at the
Q5_K_M path's Q5_K projections (q|k 4096->5120, o 4096->4096, gate|up
4096->28672, down 14336->4096; K5 on the same qs, scale and minv), and
`q5k` there: quant_matmul.q5k_matmul with int8_act off, the whole Q5_K
product as the bf16 route serves it (one kernel since K9b's decode
instantiation; K5, K9b's 16-row kernel and the add before, so parent and
change time the same call), against the composite of K5's and K9b's plain
versions: each at 1, 4 and 16 rows, chip_smoke.Clock's median of 25 runs (L2 flushed) beside the
relative error against the plain version. The same calls and inputs run
in every tree, so a parent without a kernel's decode instantiation times
its older one. With --trace, instead, the device time a call of each
kernel a call launches (K3's and K9's quantize kernel and GEMV; K4's,
K5's, K8's and K10's GEMV, and before their decode instantiations the
quantize or sums kernel and the split-K pass), from a torch.profiler trace of 10 calls (L2 warm), at
16 rows. With --repeat N, instead, each case is called N times (the L2
flushed and the card kept busy before every other call, as
chip_smoke.Clock does) and the line gives the calls whose output differs
in any bit from the first call's, beside the first call's relative error
against the plain version.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SHAPES = (("v", 4096, 1024), ("down", 14336, 4096), ("lm_head", 4096, 32768))
ROWS = (1, 4, 16)
G = 512
# K8: (name, K, O, f32 scales); K10: (format, bits, group, name, K, O)
K8_SHAPES = (("v", 4096, 1024, True), ("qk", 4096, 5120, True), ("gate|up", 4096, 28672, True),
             ("down", 14336, 4096, True), ("lm_head", 4096, 32768, True),
             ("lm_head wire", 4096, 32768, False))
K10_SHAPES = (("q2k", 2, 16, "qk", 4096, 5120), ("q2k", 2, 16, "gate|up", 4096, 28672),
              ("gptq8", 8, 128, "down", 14336, 4096), ("gptq8", 8, 128, "gate|up", 4096, 28672),
              ("hqq1", 1, 64, "gate|up", 4096, 28672), ("hqq2", 2, 64, "gate|up", 4096, 28672),
              ("gptq4", 4, 16, "gate|up", 4096, 28672))
# K5 and K9: (name, K, O)
Q5K_SHAPES = (("qk", 4096, 5120), ("o", 4096, 4096), ("gate|up", 4096, 28672),
              ("down", 14336, 4096))
KERNELS = ("k3", "k4", "k8", "k10", "k5", "k9", "q5k")
# the sources each builds (those a tree has: a parent without the Q5_K bf16
# kernel's source builds K5's and K9b's)
SOURCES = {"k3": ("q6k_gemv",), "k4": ("q6k_gemv",), "k8": ("q8_0_bf16_gemv",),
           "k10": ("affine_gemv",), "k5": ("q4k_bf16_gemv",), "k9": ("q5k_q8_gemv",),
           "q5k": ("q4k_bf16_gemv", "q5k_hbit_bf16_gemv", "q5k_bf16_gemv")}


def cases(torch, qm, dev, gen, kernels):
    """(key, call, plain) of every case asked for, its inputs made in the
    same order in every tree."""
    def u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    def unif(*shape, lo, hi, dtype=torch.float32):
        return (torch.rand(shape, device=dev, generator=gen) * (hi - lo) + lo).to(dtype)

    bf16 = torch.bfloat16
    out = []
    if {"k3", "k4"} & set(kernels):
        for name, K, O in SHAPES:
            ql, qh, scale = u8(K // 2, O), u8(K // 4, O), unif(K // 16, O, lo=0.001, hi=0.005,
                                                               dtype=bf16)
            for B in ROWS:
                x = torch.randn(B, K, device=dev, generator=gen).to(bf16)
                for kern, fn, plain in (("k3", qm.q6k_q8_gemv, qm.q6k_q8_gemv_plain),
                                        ("k4", qm.q6k_bf16_gemv, qm.q6k_bf16_gemv_plain)):
                    if kern in kernels:
                        out.append((f"{kern} {name} B={B}",
                                    lambda dt, fn=fn, x=x, ql=ql, qh=qh, s=scale:
                                    fn(x, ql, qh, s, G, out_dtype=dt),
                                    lambda plain=plain, x=x, ql=ql, qh=qh, s=scale:
                                    plain(x, ql, qh, s, G, torch.float32)))
    if "k8" in kernels:
        for name, K, O, f32 in K8_SHAPES:
            q = unif(K, O, lo=-127.0, hi=128.0).floor().to(torch.int8)
            s = unif(K // 32, O, lo=1e-4, hi=4e-4, dtype=torch.float32 if f32 else bf16)
            for B in ROWS:
                x = torch.randn(B, K, device=dev, generator=gen).to(bf16)
                out.append((f"k8 {name} B={B}",
                            lambda dt, x=x, q=q, s=s: qm.q8_0_bf16_gemv(x, q, s, out_dtype=dt),
                            lambda x=x, q=q, s=s: qm.q8_0_bf16_gemv_plain(x, q, s, torch.float32)))
    if "k10" in kernels:
        for fmt, bits, group, name, K, O in K10_SHAPES:
            q = u8(K * bits // 8, O)
            scale = unif(K // group, O, lo=0.001, hi=0.005, dtype=bf16)
            zs = ((1.5 if fmt == "q2k" else 2 ** (bits - 1)) * scale.float()).to(bf16)
            for B in ROWS:
                x = torch.randn(B, K, device=dev, generator=gen).to(bf16)
                a = (x, q, scale, zs, bits, group)
                out.append((f"k10 {name} {fmt} B={B}",
                            lambda dt, a=a: qm.affine_gemv(*a, out_dtype=dt),
                            lambda a=a: qm.affine_gemv_plain(*a, torch.float32)))
    if {"k5", "k9", "q5k"} & set(kernels):
        from mistralrs_tpu_torch.quant.qlinear import Linear

        for name, K, O in Q5K_SHAPES:
            qs, qh = u8(K // 2, O), u8(K // 8, O)
            scale = unif(K // 32, O, lo=0.001, hi=0.005, dtype=bf16)
            minv = unif(K // 32, O, lo=0.0, hi=0.002, dtype=bf16)
            for B in ROWS:
                x = torch.randn(B, K, device=dev, generator=gen).to(bf16)
                if "k5" in kernels:
                    a = (x, qs, scale, minv)
                    out.append((f"k5 {name} B={B}",
                                lambda dt, a=a: qm.q4k_bf16_gemv(*a, out_dtype=dt),
                                lambda a=a: qm.q4k_bf16_gemv_plain(*a, torch.float32)))
                if "k9" in kernels:
                    a = (x, qs, qh, scale, minv)
                    out.append((f"k9 {name} B={B}",
                                lambda dt, a=a: qm.q5k_q8_gemv(*a, out_dtype=dt),
                                lambda a=a: qm.q5k_q8_gemv_plain(*a, torch.float32)))
                if "q5k" in kernels:
                    lin = Linear("gguf_q5k", (K, O), {"qs": qs, "qh": qh, "scale": scale,
                                                      "minv": minv}, int8_act=False)
                    out.append((f"q5k {name} B={B}",
                                # the route's out is x's dtype (bf16); its
                                # error against the f32 composite is bf16's
                                lambda dt, lin=lin, x=x: qm.q5k_matmul(lin, x).to(dt),
                                lambda x=x, qs=qs, qh=qh, s=scale, m=minv:
                                qm.q4k_bf16_gemv_plain(x, qs, s, m, torch.float32)
                                + 16.0 * qm.q5k_hbit_bf16_gemv_plain(x, qh, s, torch.float32)))
    return out


def measure(root: str, trace: bool, repeat: int = 0, kernels_asked=KERNELS) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from mistralrs_tpu_torch.ops import kernels
    from mistralrs_tpu_torch.ops import quant_matmul as qm

    if not Path(kernels.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"{kernels.__file__} is not under {root}")
    csrc = Path(kernels.CSRC)
    kernels.SOURCES = tuple(sorted({n for k in kernels_asked for n in SOURCES[k]
                                    if (csrc / f"{n}.cu").exists()}))
    kernels.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    clock = cs.Clock(dev)
    out = {}
    for key, fn, plain in cases(torch, qm, dev, gen, kernels_asked):
        call = lambda fn=fn: fn(torch.bfloat16)  # noqa: E731
        if trace:
            if key.endswith(" B=16"):
                out[key] = trace_call(torch, call)
            continue
        got = fn(torch.float32)
        want = plain()
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
    asked = KERNELS
    if "--kernels" in args:
        i = args.index("--kernels")
        asked = tuple(args[i + 1].split(","))
        del args[i:i + 2]
        if not set(asked) <= set(KERNELS):
            print(f"--kernels: pick from {','.join(KERNELS)}", file=sys.stderr)
            return 2
    if args and args[0] == "--one":
        print(json.dumps(measure(args[1], trace, repeat, asked)), flush=True)
        return 0
    for root in args:
        cmd = ([sys.executable, __file__, "--one", root] + (["--trace"] if trace else [])
               + (["--repeat", str(repeat)] if repeat else [])
               + ["--kernels", ",".join(asked)])
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
