#!/usr/bin/env python3
"""Time the int8-activation GEMVs K1 (`q4k_q8_gemv`) and K2 (`q8_0_q8_gemv`)
of two checkouts of this repository on one card, in turns.

    python3 scripts/torch_gemv_ab.py PARENT_ROOT CHANGE_ROOT

Runs each checkout in a process of its own, in the order parent, change,
change, parent. Each builds its own kernels (under its own csrc/_build)
and prints one JSON line: K1 at Mistral-7B's Q4_K projections (fused q|k,
o, gate|up, down) and K2 at its rq8 shapes (v, down, the padded lm_head;
f32 scales, group 32) at 1, 16, 64 and 256 rows, and K9 (`q5k_q8_gemv`,
which shares their activation quantize kernel) at K1's shapes at 1 and
16 rows, on random codes and scales made from one seed. Each time is
chip_smoke.Clock's median of 25 runs (L2 flushed), taken three times,
with `torch.matmul` on the dense bf16 weight at each row count beside
them. The shapes are the main path's (K1's fused q|k is 5120 wide: q and
k, v being Q6_K). To A/B a variant of a kernel, make it in a copy of the
tree and pass that copy as one of the two roots.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

K1_CASES = (("qk", 4096, 5120), ("o", 4096, 4096), ("gate|up", 4096, 28672),
            ("down", 14336, 4096))
K2_CASES = (("v", 4096, 1024), ("down rq8", 14336, 4096), ("lm_head", 4096, 32768))
ROWS = (1, 16, 64, 256)


def measure(root: str) -> dict:
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
    out = {"root": root}

    def times(fn):
        return [clock.ms(fn) for _ in range(3)]

    for nm, K, O in K1_CASES:
        qs = torch.randint(0, 256, (K // 2, O), dtype=torch.uint8, device=dev, generator=gen)
        scale = (torch.rand(K // 32, O, device=dev, generator=gen) * 0.004 + 0.001).bfloat16()
        minv = (torch.rand(K // 32, O, device=dev, generator=gen) * 0.002).bfloat16()
        w = qm.q4k_dequant_plain(qs, scale, minv, torch.bfloat16)
        for B in ROWS:
            x = torch.randn(B, K, device=dev, generator=gen).bfloat16()
            out[f"k1 {nm} B={B}"] = times(lambda: qm.q4k_q8_gemv(x, qs, scale, minv))
            out[f"matmul {nm} B={B}"] = times(lambda: torch.matmul(x, w))
        del w
    for nm, K, O in K2_CASES:
        q = torch.randint(-127, 128, (K, O), dtype=torch.int8, device=dev, generator=gen)
        s = torch.rand(K // 32, O, device=dev, generator=gen) * 3e-4 + 1e-4
        w = qm.q8_0_dequant_plain(q, s, 32, torch.bfloat16)
        for B in ROWS:
            x = torch.randn(B, K, device=dev, generator=gen).bfloat16()
            out[f"k2 {nm} B={B}"] = times(lambda: qm.q8_0_q8_gemv(x, q, s, 32))
            out[f"matmul {nm} B={B}"] = times(lambda: torch.matmul(x, w))
        del w
    # K9 (Q5_K x int8), which shares K1's and K2's activation quantize kernel
    for nm, K, O in K1_CASES:
        qs = torch.randint(0, 256, (K // 2, O), dtype=torch.uint8, device=dev, generator=gen)
        qh = torch.randint(0, 256, (K // 8, O), dtype=torch.uint8, device=dev, generator=gen)
        scale = (torch.rand(K // 32, O, device=dev, generator=gen) * 0.004 + 0.001).bfloat16()
        minv = (torch.rand(K // 32, O, device=dev, generator=gen) * 0.002).bfloat16()
        for B in (1, 16):
            x = torch.randn(B, K, device=dev, generator=gen).bfloat16()
            out[f"k9 {nm} B={B}"] = times(lambda: qm.q5k_q8_gemv(x, qs, qh, scale, minv))
    return out


def main() -> int:
    if sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    parent, change = sys.argv[1], sys.argv[2]
    for root in (parent, change, change, parent):
        r = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                           text=True)
        if r.returncode:
            print(r.stderr, file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
