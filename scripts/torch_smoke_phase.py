#!/usr/bin/env python3
"""Run one phase of chip_smoke.py in one or more checkouts of this
repository on one card, in the order given.

    python3 scripts/torch_smoke_phase.py PHASE ROOT [ROOT ...]

PHASE names a phase function of the root's chip_smoke.py without its
`_phase` suffix (gemma2_ragged, long_context, slice, ...). Each root runs
in a process of its own (pass parent, change, change, parent to A/B two
trees), builds its own kernels, runs the phase at chip_smoke.Sizes() and
prints the phase's result as one JSON line with the root beside it
(serving phases: host-clock TTFT and decode tok/s, launches by kernel).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def measure(phase: str, root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from mistralrs_tpu_torch.ops import kernels

    if not Path(kernels.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"{kernels.__file__} is not under {root}")
    kernels.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = getattr(cs, f"{phase}_phase")(cs.Sizes(), torch.device("cuda"))
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), **out}), flush=True)


def main() -> int:
    if sys.argv[1] == "--one":
        measure(sys.argv[2], sys.argv[3])
        return 0
    phase, roots = sys.argv[1], sys.argv[2:]
    for root in roots:
        r = subprocess.run([sys.executable, __file__, "--one", phase, root], capture_output=True,
                           text=True)
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
