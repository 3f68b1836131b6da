#!/usr/bin/env python3
"""Time the attention kernels of two checkouts of this repository on one
card, in turns.

    python3 scripts/torch_attention_ab.py [--library] PARENT_ROOT CHANGE_ROOT

Runs each checkout in a process of its own, in the order parent, change,
change, parent. Each builds its own kernels (under its own csrc/_build)
and prints one JSON line: K6 (`flash_prefill`) at chip_smoke.py's first
chunks (B=4 T=512, B=16 T=256, B=1 T=200, B=4 T=256, B=1 T=512); where the
checkout has them, K6' at B=4 T=512 over a 4096-token context on both pool
layouts and over 2048 head-major, and at B=1 T=256 over 1000 on both
layouts; K7 at B=16 over 4096; K11 at every case of chip_smoke.SPLASH_CASES
(Gemma-2-9B's and -2B's first chunks with the soft cap 50, with and
without a window; a Mistral-width chunk clipped by a window, no cap); K12
at Mistral's 16-row decode over 4096 and at the chunk cases of
chip_smoke.RAGGED_CASES (Mistral's 4 x 512 over 4096, Gemma-2-9B's 4 x 512
over 4608 with the window and the cap, the mixed 3/4 step), with
chip_smoke's inputs (q 4x wider under a cap, 8x for K11). Each time is
chip_smoke.Clock's median of 25 runs, taken three times.

With --library, one more process in the change's checkout times the
library call of the capped cases, where PyTorch's fused attention has no
soft cap: torch.nn.attention.flex_attention compiled (torch.compile), with
the tanh cap as its score_mod and the causal and window mask as its block
mask, on [B, H, T, D] copies of the same inputs (GQA by enable_gqa): K11's
capped SPLASH_CASES, K7's Gemma-2-9B row (16 queries over 4096 keys, D
256, cap 50: chip_smoke.GEMMA2_DECODE_CASES[0], on the keys laid out
contiguous) and K12's capped Gemma-2-9B rows (16-row decode over 1024;
4 x 512 queries at the end of 4608 keys, window 4096). Its line names
each case `flex ...`, or says that this PyTorch has no flex_attention.
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

    def three(fn):
        return [clock.ms(fn) for _ in range(3)]

    for B, T in ((4, 512), (16, 256), (1, 200), (4, 256), (1, 512)):
        q, k, v = (torch.randn(B, T, H, 128, device=dev, generator=gen).bfloat16()
                   for H in (32, 8, 8))
        out[f"flash_prefill B={B} T={T}"] = three(lambda: fa.flash_prefill(q, k, v, 0.088))
    if not hasattr(cs, "paged_inputs"):
        return out
    from mistralrs_tpu_torch.ops import paged_attention as pa

    sz = cs.Sizes()
    for B, T, kv, hm in ((4, 512, 4096, True), (4, 512, 4096, False), (4, 512, 2048, True),
                         (1, 256, 1000, True), (1, 256, 1000, False)):
        q, k, v, meta = cs.paged_inputs(sz, dev, gen, B, T, kv, hm)
        name = f"flash_prefill_paged B={B} T={T} kv={kv} {'head' if hm else 'token'}_major"
        out[name] = three(lambda: pa.flash_prefill_continuation(q, k, v, meta, scale=0.088))
    q, k, v, meta = cs.paged_inputs(sz, dev, gen, 16, 1, 4096, True)
    out["paged_decode B=16 kv=4096"] = three(
        lambda: pa.paged_decode_attention(q, k, v, meta, scale=0.088))
    if hasattr(cs, "SPLASH_CASES"):
        from mistralrs_tpu_torch.ops import splash as sp

        for shape, B, T, Hq, Hkv, D, window, cap in cs.SPLASH_CASES:
            q = (torch.randn(B, T, Hq, D, device=dev, generator=gen) * (8 if cap else 1)).bfloat16()
            k, v = (torch.randn(B, T, Hkv, D, device=dev, generator=gen).bfloat16() for _ in "kv")
            kw = dict(scale=D ** -0.5, sliding_window=window, logits_softcap=cap)
            out[f"splash_prefill {shape}"] = three(lambda: sp.splash_prefill(q, k, v, **kw))
    if hasattr(cs, "RAGGED_CASES"):
        from mistralrs_tpu_torch.ops import ragged_attention as ra

        for shape, seqs, B, Hq, Hkv, D, window, cap in cs.RAGGED_CASES:
            if shape != cs.RAGGED_CASES[0][0] and max(ql for ql, _ in seqs) == 1:
                continue  # the decode cases but the headline
            q, *rest = cs.ragged_inputs(dev, gen, seqs, B, Hq, Hkv, D)
            if cap:
                q = (q.float() * 4).to(torch.bfloat16)
            max_q = max(ql for ql, _ in seqs) if len({ql for ql, _ in seqs}) == 1 else None
            kw = dict(scale=D ** -0.5, sliding_window=window, logits_softcap=cap, max_q_len=max_q)
            out[f"ragged_attention {shape}"] = three(
                lambda: ra.ragged_attention(q, *rest, **kw))
    return out


def flex_library(root: str) -> dict:
    """The capped cases' library call: compiled flex_attention with a tanh
    score_mod and the causal / window block mask (see the module's text)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda")
    out = {"root": root, "library": "flex_attention"}
    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    except ImportError as e:
        out["flex"] = f"not in this PyTorch ({torch.__version__}): {e}"
        return out
    clock = cs.Clock(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    flex = torch.compile(flex_attention, dynamic=False)

    def case(name, B, Tq, Tk, Hq, Hkv, D, window, cap, amp):
        """Queries at the last Tq of Tk positions, causal (and windowed)."""
        q = (torch.randn(B, Hq, Tq, D, device=dev, generator=gen) * amp).bfloat16()
        k, v = (torch.randn(B, Hkv, Tk, D, device=dev, generator=gen).bfloat16() for _ in "kv")
        off, win = Tk - Tq, window or Tk + 1

        def score_mod(score, b, h, qi, ki):
            return cap * torch.tanh(score / cap)

        def mask_mod(b, h, qi, ki):
            return (ki <= qi + off) & (ki > qi + off - win)

        mask = create_block_mask(mask_mod, B=None, H=None, Q_LEN=Tq, KV_LEN=Tk, device=dev)
        run = lambda: flex(q, k, v, score_mod=score_mod, block_mask=mask,  # noqa: E731
                           scale=D ** -0.5, enable_gqa=Hq != Hkv)
        run()
        out[f"flex {name}"] = [clock.ms(run) for _ in range(3)]

    for shape, B, T, Hq, Hkv, D, window, cap in cs.SPLASH_CASES:
        if cap:
            case(f"splash_prefill {shape}", B, T, T, Hq, Hkv, D, window, cap, 8.0)
    g = cs.GEMMA2
    B, kv = cs.GEMMA2_DECODE_CASES[0]
    case(f"paged_decode gemma2-9b B={B} kv={kv}", B, 1, kv, g.heads, g.kv_heads, g.head_dim,
         None, 50.0, 4.0)
    case("ragged_attention gemma2-9b B=16 kv=1024 decode", 16, 1, 1024, g.heads, g.kv_heads,
         g.head_dim, None, 50.0, 4.0)
    case("ragged_attention gemma2-9b 4x512 kv=4608 w=4096", 4, 512, 4608, g.heads, g.kv_heads,
         g.head_dim, 4096, 50.0, 4.0)
    return out


def main() -> int:
    if sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    if sys.argv[1] == "--flex":
        print(json.dumps(flex_library(sys.argv[2])), flush=True)
        return 0
    args = sys.argv[1:]
    library = "--library" in args
    parent, change = [a for a in args if a != "--library"]
    runs = [("--one", r) for r in (parent, change, change, parent)]
    for mode, root in runs + ([("--flex", change)] if library else []):
        r = subprocess.run([sys.executable, __file__, mode, root], capture_output=True,
                           text=True)
        if r.returncode:
            print(r.stderr[-6000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
