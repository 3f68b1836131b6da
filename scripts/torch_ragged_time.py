#!/usr/bin/env python3
"""Time K12 (`ragged_attention`) at chip_smoke.py's RAGGED_CASES in one or
more checkouts of this repository on one card.

    python3 scripts/torch_ragged_time.py [--trace] ROOT [ROOT ...]

Runs each root in a process of its own, in the order given (pass parent,
change, change, parent to A/B two trees; to time a variant of the kernel,
make it in a gitignored copy of the tree and pass that copy). Each builds
its own ragged_attention library only and prints one JSON line: K12 at
every case of chip_smoke.RAGGED_CASES (decode and chunks; the inputs as
chip_smoke's kernel phase draws them, q 4x wider under a soft cap), each
[chip_smoke.Clock's median of 25 runs (L2 flushed), the relative error
against the plain version]. With --trace, instead, each case's device time
a call from a torch.profiler trace of 10 calls (L2 warm), by kernel name.
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
    from mistralrs_tpu_torch.ops import kernels
    from mistralrs_tpu_torch.ops import ragged_attention as ra

    if not Path(kernels.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"{kernels.__file__} is not under {root}")
    kernels.SOURCES = ("ragged_attention",)
    kernels.build()
    dev = torch.device("cuda")
    clock = cs.Clock(dev)
    gen = torch.Generator(device=dev).manual_seed(zlib.crc32(b"ragged"))
    rows = {}
    for shape, seqs, B, Hq, Hkv, D, window, cap in cs.RAGGED_CASES:
        q, *rest = cs.ragged_inputs(dev, gen, seqs, B, Hq, Hkv, D)
        if cap:
            q = (q.float() * 4).to(torch.bfloat16)
        max_q = max(ql for ql, _ in seqs) if len({ql for ql, _ in seqs}) == 1 else None
        kw = dict(scale=D ** -0.5, sliding_window=window, logits_softcap=cap)
        got = ra.ragged_attention(q, *rest, **kw, max_q_len=max_q).float()
        want = ra.ragged_attention_plain(q, *rest, **kw).float()
        rel = float((got - want).abs().max()) / float(want.abs().max())
        if trace:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    ra.ragged_attention(q, *rest, **kw, max_q_len=max_q)
                torch.cuda.synchronize()
            rows[shape] = {e.key[:60]: e.self_device_time_total / 1e3 / e.count
                           for e in prof.key_averages() if "ragged" in e.key}
            continue
        rows[shape] = [clock.ms(lambda: ra.ragged_attention(q, *rest, **kw, max_q_len=max_q)),
                       rel]
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
        r = subprocess.run(cmd + [root], capture_output=True, text=True)
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
