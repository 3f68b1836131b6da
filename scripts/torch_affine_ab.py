#!/usr/bin/env python3
"""Time the plane-affine GEMV (K10, `affine_gemv`) of two checkouts of this
repository on one card, in turns.

    python3 scripts/torch_affine_ab.py PARENT_ROOT CHANGE_ROOT

Runs each checkout in a process of its own, in the order parent, change,
change, parent. Each builds its own kernels (under its own csrc/_build)
and prints one JSON line: K10 at chip_smoke.py's Q2_K shapes (fused q|k
4096->5120 and gate|up 4096->28672 at 1, 16, 64 and 256 rows) and at its
GPTQ-8 down and HQQ-1 gate|up cases at 16 rows, on random codes and
scales made from one seed. Each time is chip_smoke.Clock's median of 25
runs, taken three times.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# (format, bits, group, name, K, O, rows)
CASES = (("q2k", 2, 16, "qk", 4096, 5120, (1, 16, 64, 256)),
         ("q2k", 2, 16, "gate|up", 4096, 28672, (1, 16, 64, 256)),
         ("gptq8", 8, 128, "down", 14336, 4096, (16,)),
         ("hqq1", 1, 64, "gate|up", 4096, 28672, (16,)))


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
    for fmt, bits, group, nm, K, O, rows in CASES:
        q = torch.randint(0, 256, (K * bits // 8, O), dtype=torch.uint8, device=dev, generator=gen)
        scale = (torch.rand(K // group, O, device=dev, generator=gen) * 0.004 + 0.001).bfloat16()
        zs = (1.5 * scale.float()).bfloat16()
        for B in rows:
            x = torch.randn(B, K, device=dev, generator=gen).bfloat16()
            out[f"{nm} {fmt} B={B}"] = [
                clock.ms(lambda: qm.affine_gemv(x, q, scale, zs, bits, group)) for _ in range(3)]
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
