#!/usr/bin/env python3
"""chip_smoke.py's kernel phase of two checkouts of this repository on one
card, in turns: every kernel at the main paths' shapes, held against its
plain version and timed (chip_smoke.Clock: median of 25 runs, L2 flushed).

    python3 scripts/torch_kernel_phase_ab.py PARENT_ROOT CHANGE_ROOT

Runs each checkout's own chip_smoke.kernel_phase in a process of its own,
in the order parent, change, change, parent; each builds its own kernels
and prints one JSON line: {"root", "device", "rows": {"kernel shape": [ms,
library ms or null]}}.
A kernel row that fails its parity check fails the run.
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
    from mistralrs_tpu_torch.ops import kernels

    if not Path(kernels.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"{kernels.__file__} is not under {root}")
    kernels.build()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = cs.kernel_phase(cs.Sizes(), dev, cs.Clock(dev))
    rows = {f"{name} {r['shape']}": [r["ms"], r["library_ms"]] for name in cs.KERNEL_INFO
            for r in results.get(name, [])}
    return {"root": root, "device": torch.cuda.get_device_name(0), "rows": rows}


def main() -> int:
    if sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    parent, change = sys.argv[1], sys.argv[2]
    for root in (parent, change, change, parent):
        r = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                           text=True)
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
