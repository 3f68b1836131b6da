#!/usr/bin/env python3
"""How fast TMA streams a quantized weight's [rows, O] byte matrix on one
card, with no compute: the floor under K1's and K2's decode instantiations.

    python3 scripts/torch_tma_stream.py

Builds scripts/tma_stream.cu with nvcc (into mistralrs_tpu_torch/csrc/_build/,
which .gitignore lists) and times it with chip_smoke.Clock (median of 25
runs, L2 flushed) on three matrices of random bytes, Mistral-7B's gate|up
codes [2048, 28672] (Q4_K), the rq8 lm_head [4096, 32768] and the q|k codes
[2048, 5120], for box shapes of 128, 256 and 512 columns by 32 to 256 rows,
ring depths of 2 to 8 and K splits of 1 to 8 (column tiles x splits up to
600 blocks). One JSON line a case: microseconds and TB/s (rows x O over the
time).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# case -> (name, 128-column boxes side by side); the .cu's switch
CASES = {0: ("W128 R64 D4", 1), 1: ("W128 R128 D2", 1), 2: ("W128 R64 D8", 1),
         3: ("W256 R64 D4", 2), 4: ("W256 R32 D8", 2), 5: ("W512 R32 D4", 4),
         6: ("W128 R32 D8", 1), 7: ("W128 R256 D2", 1)}


def main() -> int:
    import torch

    import chip_smoke as cs
    from mistralrs_tpu_torch.ops import kernels

    out_dir = ROOT / "mistralrs_tpu_torch" / "csrc" / "_build" / "tma_stream"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libtma_stream.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib_path),
                    str(ROOT / "scripts" / "tma_stream.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.stream_run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    dev = torch.device("cuda")
    clock = cs.Clock(dev)
    sink = torch.zeros(4, dtype=torch.int32, device=dev)
    for rows, O in ((2048, 28672), (4096, 32768), (2048, 5120)):
        w = torch.randint(0, 255, (rows, O), dtype=torch.uint8, device=dev)
        for case, (name, boxes) in CASES.items():
            ctiles = O // (128 * boxes)
            for splits in (1, 2, 4, 8):
                if ctiles * splits > 600 or rows // splits < 256:
                    continue
                stream = torch.cuda.current_stream().cuda_stream

                def run():
                    err = lib.stream_run(case, w.data_ptr(), rows, O, splits, sink.data_ptr(),
                                         stream)
                    if err:
                        raise RuntimeError(f"stream_run: CUDA error {err}")

                ms = clock.ms(run)
                print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows, "O": O,
                                  "case": name, "splits": splits, "blocks": ctiles * splits,
                                  "us": ms * 1e3, "TBps": rows * O / ms / 1e9}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
