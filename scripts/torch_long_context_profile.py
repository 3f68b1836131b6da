#!/usr/bin/env python3
"""Where a long-context decode forward and a continuation prefill step of
the PyTorch port spend their time, on one NVIDIA card.

    python3 scripts/torch_long_context_profile.py [--layers 32] [--batch 16]
                                                  [--backend default|ragged]

Builds chip_smoke.py's Mistral-7B Q4_K_M random-weight model on head-major
pools (max_model_len 4096, 512-token chunks), or with `--backend ragged` on
the ragged backend's combined token-major pool, where the continuation
chunk and both decode contexts take K12 (its chunk and decode
instantiations) in place of K6', K7 and the gather. Sequences get block tables
and a context length directly, with no prompt prefilled first: their K/V
pages hold zeros, and attention's time does not depend on the values.
Traces, after an untraced warm-up call of each (a first use costs up to
~0.2 s of host time):
- one batched first-chunk prefill step of FEW x 512 tokens at positions
  0..511 (K6);
- one batched continuation prefill step of FEW x 512 tokens at positions
  3072..3583 (the last full chunk of a ~3,600-token prompt: K6' over a
  4096 span);
- `--batch` rows decoding at a 3,400-token context (span 4096: K7) and at
  a 1,900-token context (span 2048: gather + sdpa_head_major), each timed
  over 5 greedy multistep calls of 8 forwards with the host clock (median)
  and one traced call.
Prints scripts/torch_decode_profile.py's JSON lines: per phase the wall
time, the device's busy share and kernel launches, then the top device
kernels and host ops by time.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

FEW = 4  # rows of the traced continuation prefill step
CHUNK = 512


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--backend", choices=("default", "ragged"), default="default")
    # the model report() names (torch_decode_profile.py's options)
    ap.set_defaults(mix="q4km", int8_activations="on")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import Sizes, model_config, random_q4km_params
    from mistralrs_tpu_torch.engine.block_manager import BlockManager
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.engine.sequence import Sequence
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
    from torch_decode_profile import report

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sz = Sizes()
    cfg = model_config(sz, args.layers)
    params = random_q4km_params(sz, args.layers, dev, torch.Generator(device=dev).manual_seed(0),
                                torch.bfloat16)
    pc = PipelineConfig(page_size=16, num_pages=(args.batch + FEW) * 256 + 1,
                        max_seqs=args.batch, max_model_len=4096,
                        prefill_buckets=(16, 64, 256, CHUNK), decode_steps=8, device="cuda",
                        attn_backend=args.backend)
    pipe = TextPipeline(cfg, params, make_rope(cfg, 4096, device=dev), pc)
    del params
    bm = BlockManager(pc.num_pages, pc.page_size)
    name = torch.cuda.get_device_name(0)

    def seqs_at(n: int, ctx: int, tokens: int) -> list:
        """n sequences whose first ctx tokens are in the cache (pages for
        `tokens` tokens allocated)."""
        out = []
        for _ in range(n):
            s = Sequence([1 + i % 1000 for i in range(tokens)], SamplingParams(max_len=1000))
            bm.allocate(s)
            s.kv_len = s.prefill_done_tokens = ctx
            out.append(s)
        return out

    # first chunk: FEW rows, positions 0..511
    firsts = seqs_at(FEW, 0, CHUNK)
    first_items = [(s, s.tokens[:CHUNK]) for s in firsts]

    def first():
        pipe.run_prefill_chunks(first_items)
        torch.cuda.synchronize()
        for s in firsts:
            s.kv_len = s.prefill_done_tokens = 0

    first()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        first()
        wall = time.perf_counter() - t0
    report(f"prefill_first_{FEW}x{CHUNK}", name, args, prof, wall, {
        "prefill_ms": wall * 1e3, "rows": FEW, "start": 0})
    for s in firsts:
        bm.free_sequence(s)

    # continuation prefill: FEW rows, chunk 3072..3583
    start = 3072
    rows = seqs_at(FEW, start, start + CHUNK)
    items = [(s, s.tokens[start:start + CHUNK]) for s in rows]

    def prefill():
        pipe.run_prefill_chunks(items)
        torch.cuda.synchronize()
        for s in rows:
            s.kv_len = s.prefill_done_tokens = start

    prefill()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill()
        wall = time.perf_counter() - t0
    report(f"prefill_continuation_{FEW}x{CHUNK}", name, args, prof, wall, {
        "prefill_ms": wall * 1e3, "rows": FEW, "start": start, "span": 4096})

    for ctx in (3400, 1900):
        seqs = seqs_at(args.batch, ctx, ctx + pc.decode_steps)

        def call():
            pipe.run_decode_multi(seqs)  # ends in a device->host copy (synchronizes)
            for s in seqs:
                s.kv_len -= pc.decode_steps  # rewind: replay the same positions

        call()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
        step_ms = 1e3 * statistics.median(times) / pc.decode_steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            wall = time.perf_counter() - t0
        report(f"decode_ctx{ctx}", name, args, prof, wall, {
            "context": ctx, "span": pipe._table_width(seqs, pc.decode_steps) * pc.page_size,
            "forward_ms": step_ms, "forward_ms_all": [1e3 * t / pc.decode_steps for t in times],
            "tok_s": args.batch * 1e3 / step_ms, "forwards_traced": pc.decode_steps})
        for s in seqs:
            bm.free_sequence(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
