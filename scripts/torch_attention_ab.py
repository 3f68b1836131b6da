#!/usr/bin/env python3
"""Time the attention kernels of two checkouts of this repository on one
card, in turns.

    python3 scripts/torch_attention_ab.py PARENT_ROOT CHANGE_ROOT

Runs each checkout in a process of its own, in the order parent, change,
change, parent. Each builds its own kernels (under its own csrc/_build)
and prints one JSON line: K6 (`flash_prefill`) at B=4 T=512, B=16 T=256
and B=1 T=200, and, where the checkout has them, K6' and K7 at
chip_smoke.py's headline shapes (B=4 T=512 at a 4096-token context; B=16
at 4096). Each time is chip_smoke.Clock's median of 25 runs, taken three
times.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from mistralrs_tpu_torch.ops import flash_attention as fa
    from mistralrs_tpu_torch.ops import kernels

    if not Path(kernels.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"{kernels.__file__} is not under {root}")
    kernels.build()
    dev = torch.device("cuda")
    clock = cs.Clock(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"root": root}
    for B, T in ((4, 512), (16, 256), (1, 200)):
        q, k, v = (torch.randn(B, T, H, 128, device=dev, generator=gen).bfloat16()
                   for H in (32, 8, 8))
        out[f"flash_prefill B={B} T={T}"] = [
            clock.ms(lambda: fa.flash_prefill(q, k, v, 0.088)) for _ in range(3)]
    if hasattr(cs, "paged_inputs"):
        from mistralrs_tpu_torch.ops import paged_attention as pa

        sz = cs.Sizes()
        for name, B, T in (("flash_prefill_paged", 4, 512), ("paged_decode", 16, 1)):
            q, k, v, meta = cs.paged_inputs(sz, dev, gen, B, T, 4096, True)
            fn = pa.flash_prefill_continuation if T > 1 else pa.paged_decode_attention
            out[f"{name} B={B} kv=4096"] = [
                clock.ms(lambda: fn(q, k, v, meta, scale=0.088)) for _ in range(3)]
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
