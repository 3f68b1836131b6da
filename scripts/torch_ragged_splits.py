#!/usr/bin/env python3
"""K12's decode instantiation at each split count, on one NVIDIA card.

    python3 scripts/torch_ragged_splits.py

For decode steps of the ragged backend (one query a sequence: Mistral-7B
widths at span 4096, Gemma-2-9B widths at spans 1024 and 8192 with its soft
cap, with every slot live or only a few), times K12
(ops/ragged_attention.py::ragged_attention, max_q_len 1) with the split
count forced to each of 1, 2, 4, 8, 16 and 32 and with the wrapper's own
grid (`_decode_grid`: the kernel picks the splits from the live sequences),
using chip_smoke.py's inputs and clock (CUDA events, median of 25 runs, L2
flushed), and checks each result against the plain version. Prints one
JSON line a shape and split count.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (name, live (q_len, kv_len) sequences, slots, Hq, Hkv, D, window, cap)
SHAPES = (
    ("mistral 16/16 kv=4096", ((1, 4096),) * 16, 16, 32, 8, 128, None, None),
    ("gemma2-9b 16/16 kv=1024", ((1, 1024),) * 16, 16, 16, 8, 256, None, 50.0),
    ("gemma2-9b 16/16 kv=4664", ((1, 4664),) * 16, 16, 16, 8, 256, None, 50.0),
    ("gemma2-9b 4/16 kv=4664", ((1, 4664),) * 4, 16, 16, 8, 256, None, 50.0),
    ("gemma2-9b 4/16 kv=4664 w=4096", ((1, 4664),) * 4, 16, 16, 8, 256, 4096, 50.0),
    ("gemma2-9b 1/16 kv=4664", ((1, 4664),), 16, 16, 8, 256, None, 50.0),
)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mistralrs_tpu_torch.ops import ragged_attention as ra

    dev = torch.device("cuda")
    clock = cs.Clock(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    name = torch.cuda.get_device_name(0)
    chosen = ra._decode_grid
    for shape, seqs, B, Hq, Hkv, D, window, cap in SHAPES:
        args = cs.ragged_inputs(dev, gen, seqs, B, Hq, Hkv, D)
        kw = dict(scale=D ** -0.5, sliding_window=window, logits_softcap=cap, max_q_len=1)
        want = ra.ragged_attention_plain(*args, scale=D ** -0.5, sliding_window=window,
                                         logits_softcap=cap).float()
        keys, _ = cs.ragged_work(seqs, window)
        bound = cs.bound(keys * Hkv * D * 4 + 2 * len(seqs) * Hq * D * 2, 0, cs.PEAK_BF16)[0]
        most, ctas = chosen(Hkv, args[3].shape[1] * 16, D, dev)
        auto = min(most, max(1, ctas // (len(seqs) * Hkv)))  # as the kernel picks
        for splits in (None, 1, 2, 4, 8, 16, 32):
            # a forced count: at most `splits` over as many CTAs as items
            ra._decode_grid = chosen if splits is None else (
                lambda *a, s=splits, n=len(seqs) * Hkv: (s, s * n))
            got = ra.ragged_attention(*args, **kw).float()
            rel = float((got - want).abs().max()) / float(want.abs().max())
            ms = clock.ms(lambda: ra.ragged_attention(*args, **kw))
            print(json.dumps({"device": name, "shape": shape, "splits": splits or auto,
                              "wrapper_choice": splits is None, "ms": ms, "bound_ms": bound,
                              "max_rel_err": rel}), flush=True)
            if rel > 1e-2:
                raise AssertionError(f"{shape} at {splits} splits: relative error {rel}")
        ra._decode_grid = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
