#!/usr/bin/env python3
"""Where the card-vs-CPU gap of a small GGUF model served with bf16
activations comes from: the packed GEMVs at 256 rows or the activations'
rounding.

    python3 scripts/torch_gguf_bf16_gap.py

The model of tests/test_torch_cuda.py::test_gguf_bf16_prefill_of_256_rows
_matches_the_cpu: a 2-layer GGUF at hidden 1024 (vocab 2048, 8 / 2 heads,
inter 2048) of random wire blocks in the Q4_K_M and the Q5_K_M rule,
loaded by load_gguf_model and served with int8_activations=False: a
256-token prefill, then 4 greedy decode steps fed the CPU's tokens
(chip_smoke._token_major_run). For each rule it serves the model on the
card twice, once with the prefill on K5's and K8's rows instantiations
(the route) and once on the dequant route (quant_matmul.MAX_KERNEL_ROWS at
16: q4k_dequant / q5k_dequant / q8_0_dequant + torch.matmul), and prints
one JSON line:
- `rows_vs_cpu`, `dequant_vs_cpu`, `rows_vs_dequant`: the largest
  difference of the prefill step's logits (and of every step's, `_all`)
  over the largest |logit| of the second run named;
- `k5_rows`, `k8_rows`, `k9b_rows`: every rows call of the first run held,
  on its own bf16 input, against its plain version (f32 out on both sides,
  the kernel phase's check): the largest |difference| over max |y| and the
  calls seen.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def run(mix: str, dev, folder: str | None = None) -> tuple[dict, dict, dict]:
    """(the JSON line's numbers, both sides' logits of the route's run, and
    its card launch counts) for one rule; the GGUF goes to `folder` (a new
    temporary one by default)."""
    import torch

    import chip_smoke
    from mistralrs_tpu_torch.ops import quant_matmul as qm
    from mistralrs_tpu_torch.pipeline.gguf import load_gguf_model

    sz = chip_smoke.Sizes(vocab=2048, hidden=1024, inter=2048, heads=8, kv_heads=2, layers=2)
    path = str(Path(folder or tempfile.mkdtemp()) / f"tiny-{mix}.gguf")
    chip_smoke.write_random_gguf(path, sz, 2, mix, seed=15)
    prompt = [int(t) for t in np.random.default_rng(16).integers(1, sz.vocab, 256)]

    def load(device, dt):
        cfg, params, _, _ = load_gguf_model(path, dtype=dt, device=device)
        return cfg, params

    seen = {"k5_rows": [], "k8_rows": [], "k9b_rows": []}
    k5, k8, k9b = qm.q4k_bf16_gemv, qm.q8_0_bf16_gemv, qm.q5k_hbit_bf16_gemv

    def held(name, kernel, plain):
        def call(x, *args, out_dtype=torch.bfloat16):
            if x.device.type == "cuda" and x.shape[0] > 16:
                got = kernel(x, *args, out_dtype=torch.float32)
                want = plain(x, *args, out_dtype=torch.float32)
                seen[name].append(float((got - want).abs().max() / want.abs().max()))
            return kernel(x, *args, out_dtype=out_dtype)
        return call

    qm.q4k_bf16_gemv = held("k5_rows", k5, qm.q4k_bf16_gemv_plain)
    qm.q8_0_bf16_gemv = held("k8_rows", k8, qm.q8_0_bf16_gemv_plain)
    qm.q5k_hbit_bf16_gemv = held("k9b_rows", k9b, qm.q5k_hbit_bf16_gemv_plain)
    try:
        runs, card = chip_smoke._token_major_run(None, load, dev, prompt, 32,
                                                 int8_activations=False)
    finally:
        qm.q4k_bf16_gemv, qm.q8_0_bf16_gemv, qm.q5k_hbit_bf16_gemv = k5, k8, k9b
    rows_launches = (card["q4k_bf16_gemv_rows"], card["q8_0_bf16_gemv_rows"])
    limit = qm.MAX_KERNEL_ROWS
    qm.MAX_KERNEL_ROWS = 16
    try:
        deq, card_deq = chip_smoke._token_major_run(None, load, dev, prompt, 32,
                                                    int8_activations=False)
    finally:
        qm.MAX_KERNEL_ROWS = limit
    if card_deq["q4k_bf16_gemv_rows"] or card_deq["q8_0_bf16_gemv_rows"]:
        raise AssertionError(f"the dequant run took a rows kernel: {card_deq}")

    def gap(a, b, steps=slice(0, 1)):
        return float(np.abs(a[steps] - b[steps]).max() / np.abs(b[steps]).max())

    cpu, rows, dq = runs["cpu"], runs[dev.type], deq[dev.type]
    return {"mix": mix, "device": torch.cuda.get_device_name(dev),
            "rows_launches": rows_launches,
            "rows_vs_cpu": gap(rows, cpu), "dequant_vs_cpu": gap(dq, cpu),
            "rows_vs_dequant": gap(rows, dq), "rows_vs_cpu_all": gap(rows, cpu, slice(None)),
            "dequant_vs_cpu_all": gap(dq, cpu, slice(None)),
            "rows_vs_dequant_all": gap(rows, dq, slice(None)),
            "cpu_max_logit": float(np.abs(cpu).max()),
            **{k: [max(v, default=None), len(v)] for k, v in seen.items()}}, runs, card


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for mix in ("Q4_K", "Q5_K"):
        print(json.dumps(run(mix, torch.device("cuda"))[0]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
