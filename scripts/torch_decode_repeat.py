#!/usr/bin/env python3
"""Bit-equality of the decode GEMVs (K1-K5, K8-K10 at 1-16 rows)
or of the rows GEMVs (K1, K8, K10 at 256 rows) over many calls, in one or
more checkouts of this repository on one card.

    python3 scripts/torch_decode_repeat.py [--rows] N ROOT [ROOT ...]

Runs each root in a process of its own, in the order given (to probe a
variant of a kernel, make it in a gitignored copy of the tree and pass
that copy). Each builds the sources it calls and prints one JSON line: for
K4 at down (14336 -> 4096, clusters of 8 K splits) at 16 rows, N calls,
and at 9 rows, K4 at the lm_head (4096 -> 32768, one split), K3, K1, K2,
K8 (rq8), K10 (GPTQ-8, group 128), K5 and K9 (Q5_K arrays) at down, at 16
rows, N/3 calls each;
with --rows, instead, the rows instantiations (their ring, common.cuh's
mrt::Ring) of K1 and K8 at down and of K10 at Q2_K's gate|up (4096 ->
28672, a zs step a slice), at 256 rows, N calls each. The L2 is flushed
and the card kept busy before every other call, as chip_smoke.Clock does;
each case gives the count of calls whose bf16 output differs in any bit
from the first call's, beside the first f32 call's relative error against
the plain version and the indices of the first five that differ.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def measure(root: str, reps: int, rows: bool = False) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from mistralrs_tpu_torch.ops import kernels
    from mistralrs_tpu_torch.ops import quant_matmul as qm

    if not Path(kernels.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"{kernels.__file__} is not under {root}")
    kernels.SOURCES = ("q4k_q8_gemv", "q8_0_bf16_gemv", "affine_gemv") + (
        () if rows else ("q6k_gemv", "q8_0_q8_gemv", "q4k_bf16_gemv", "q5k_q8_gemv"))
    kernels.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    clock = cs.Clock(dev)

    def u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    def scales(*shape):
        return (torch.rand(shape, device=dev, generator=gen) * 0.004 + 0.001).to(torch.bfloat16)

    out = {}

    def run(name, fn, plain, n):
        got = fn(torch.float32)
        want = plain()
        rel = float((got - want).abs().max()) / float(want.abs().max())
        first = fn(torch.bfloat16)
        outs = []
        for i in range(n):
            if i % 2:
                clock.flush.zero_()
                torch.cuda._sleep(100_000)
            outs.append(fn(torch.bfloat16))
        torch.cuda.synchronize()
        bad = [i for i, o in enumerate(outs) if not torch.equal(o, first)]
        out[name] = [len(bad), rel, bad[:5]]

    if rows:
        K, O = 14336, 4096
        x = torch.randn(256, K, device=dev, generator=gen).to(torch.bfloat16)
        qs, s4, m4 = u8(K // 2, O), scales(K // 32, O), scales(K // 32, O)
        run("k1 rows down B=256", lambda dt: qm.q4k_q8_gemv(x, qs, s4, m4, out_dtype=dt),
            lambda: qm.q4k_q8_gemv_plain(x, qs, s4, m4, torch.float32), reps)
        q = torch.randint(-127, 128, (K, O), dtype=torch.int8, device=dev, generator=gen)
        s8 = torch.rand(K // 32, O, device=dev, generator=gen) * 3e-4 + 1e-4
        run("k8 rows down B=256", lambda dt: qm.q8_0_bf16_gemv(x, q, s8, out_dtype=dt),
            lambda: qm.q8_0_bf16_gemv_plain(x, q, s8, torch.float32), reps)
        K, O = 4096, 28672
        x = torch.randn(256, K, device=dev, generator=gen).to(torch.bfloat16)
        q2, s2 = u8(K // 4, O), scales(K // 16, O)
        z2 = (1.5 * s2.float()).to(torch.bfloat16)
        run("k10 rows gate|up q2k B=256",
            lambda dt: qm.affine_gemv(x, q2, s2, z2, 2, 16, out_dtype=dt),
            lambda: qm.affine_gemv_plain(x, q2, s2, z2, 2, 16, torch.float32), reps)
        return {"root": root, "device": torch.cuda.get_device_name(0), "rows": out}
    for nm, K, O in (("down", 14336, 4096), ("lm_head", 4096, 32768)):
        ql, qh, s6 = u8(K // 2, O), u8(K // 4, O), scales(K // 16, O)
        for B in ((16, 9) if nm == "down" else (16,)):
            x = torch.randn(B, K, device=dev, generator=gen).to(torch.bfloat16)
            run(f"k4 {nm} B={B}",
                lambda dt: qm.q6k_bf16_gemv(x, ql, qh, s6, 512, out_dtype=dt),
                lambda: qm.q6k_bf16_gemv_plain(x, ql, qh, s6, 512, torch.float32),
                reps if nm == "down" and B == 16 else reps // 3)
            if nm == "down" and B == 16:
                run(f"k3 {nm} B={B}",
                    lambda dt: qm.q6k_q8_gemv(x, ql, qh, s6, 512, out_dtype=dt),
                    lambda: qm.q6k_q8_gemv_plain(x, ql, qh, s6, 512, torch.float32), reps // 3)
    K, O = 14336, 4096
    x = torch.randn(16, K, device=dev, generator=gen).to(torch.bfloat16)
    qs, s4, m4 = u8(K // 2, O), scales(K // 32, O), scales(K // 32, O)
    run("k1 down B=16", lambda dt: qm.q4k_q8_gemv(x, qs, s4, m4, out_dtype=dt),
        lambda: qm.q4k_q8_gemv_plain(x, qs, s4, m4, torch.float32), reps // 3)
    q = torch.randint(-127, 128, (K, O), dtype=torch.int8, device=dev, generator=gen)
    s8 = torch.rand(K // 32, O, device=dev, generator=gen) * 3e-4 + 1e-4
    run("k2 down B=16", lambda dt: qm.q8_0_q8_gemv(x, q, s8, 32, out_dtype=dt),
        lambda: qm.q8_0_q8_gemv_plain(x, q, s8, 32, torch.float32), reps // 3)
    run("k8 down B=16", lambda dt: qm.q8_0_bf16_gemv(x, q, s8, out_dtype=dt),
        lambda: qm.q8_0_bf16_gemv_plain(x, q, s8, torch.float32), reps // 3)
    q8, s10 = u8(K, O), scales(K // 128, O)
    z10 = (128 * s10.float()).to(torch.bfloat16)
    run("k10 down gptq8 B=16", lambda dt: qm.affine_gemv(x, q8, s10, z10, 8, 128, out_dtype=dt),
        lambda: qm.affine_gemv_plain(x, q8, s10, z10, 8, 128, torch.float32), reps // 3)
    qh = u8(K // 8, O)
    run("k5 down B=16", lambda dt: qm.q4k_bf16_gemv(x, qs, s4, m4, out_dtype=dt),
        lambda: qm.q4k_bf16_gemv_plain(x, qs, s4, m4, torch.float32), reps // 3)
    run("k9 down B=16", lambda dt: qm.q5k_q8_gemv(x, qs, qh, s4, m4, out_dtype=dt),
        lambda: qm.q5k_q8_gemv_plain(x, qs, qh, s4, m4, torch.float32), reps // 3)
    return {"root": root, "device": torch.cuda.get_device_name(0), "rows": out}


def main() -> int:
    args = sys.argv[1:]
    rows = "--rows" in args
    args = [a for a in args if a != "--rows"]
    if args[0] == "--one":
        print(json.dumps(measure(args[1], int(args[2]), rows)), flush=True)
        return 0
    reps = int(args[0])
    for root in args[1:]:
        r = subprocess.run([sys.executable, __file__, "--one", root, str(reps)]
                           + (["--rows"] if rows else []), capture_output=True, text=True)
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
