#!/usr/bin/env python3
"""Where a prefill and a decode step of the PyTorch port spend their time,
on one NVIDIA card.

    python3 scripts/torch_decode_profile.py [--layers N] [--batch 16]
                                            [--mix q4km|q5km|q2k|gemma2|mixtral]
                                            [--backend default|ragged]
                                            [--int8-activations on|off]

Builds a random-weight model of chip_smoke.py at its full depth unless
`--layers` says otherwise: Mistral-7B with `--mix q4km`
(the default) in the Q4_K_M mix with Q6_K requantized to int8 per 32,
`--mix q5km` in the Q5_K_M mix with Q6_K kept (rq8_group=None), `--mix
q2k` in llama.cpp's Q2_K mix (Q2_K q, k, gate, up on the plane-affine
GEMV; Q4_K v; Q3_K o, down and the Q6_K lm_head requantized to int8 per
32); Gemma-2-9B with `--mix gemma2` (every projection in Q4_K, the tied
bf16 embedding as the lm_head, 42 layers); Mixtral-8x7B with `--mix
mixtral` (dense bf16 experts through the grouped dispatch and its grouped
GEMM K13, Q4_K attention, router and lm_head; 24 layers, the most whose
experts fit the card). `--backend ragged` serves it on
the ragged attention backend (one combined K/V pool; the ragged paged
attention kernel K12 for continuation chunks and decode) instead of the
default routes (decode below span 4096 on the gather route).
`--int8-activations off` serves it with PipelineConfig(int8_activations=
False): the packed GEMVs keep x in bf16 (K5 for Q4_K, K5 + K9b for Q5_K,
K8 for int8 weights, K4 for Q6_K; for Q5_K up to 16 rows one kernel, K9b's
decode instantiation) where the default quantizes it to int8
(K1, K9, K2, K3). After a
warm-up that runs each step once untraced (a first use of a kernel or a
GEMM shape costs up to ~0.2 s of host time), traces one batched
first-chunk prefill engine step each of FEW 40-token prompts (a 64-token
bucket), FEW 200-token prompts (fewer than the `--batch` decode slots, as
when a few requests arrive) and `--batch` 200-token prompts, then times greedy multistep decode calls (8
forwards each, median of 5) with the host clock and traces one with
torch.profiler. A decode call is one replay of the decode loop's CUDA
graph (pipeline/graphs.py): its trace holds one `cudaGraphLaunch`
(`graph_launches`) where an eager loop made `launches`. Prints JSON lines: a summary per phase (wall time, the
device's busy share = sum of kernel times over the traced wall time,
kernel launches, and the device time of K13, K5, K8 and K9b and their
shares of it: kernels named grouped_gemm (and K13's two instantiations
apart, `k13_tiles_ms` above 32 rows a group and `k13_decode_ms` up to it:
grouped_gemm_tiles_kernel and grouped_gemm_decode_kernel), K5's decode
instantiation (`k5_ms`: plane_dec_kernel with Q4kFmt, one launch a call; in
a tree before it q4k_bf16_mma_kernel, whose call also ran the sums kernel
and a split-K pass, not counted here), K8's decode instantiation (`k8_ms`: plane_dec_kernel at 8 signed bits),
K9b's decode instantiation (`q5k_ms`: q5k_bf16_dec_kernel, the whole Q5_K
x bf16 product at 1-16 rows, one launch a call; in a tree before it K5's
decode instantiation, `k5_ms`, ran beside plane_bf16_mma_kernel<1,
`k9b_ms`, whose call also ran a split-K pass, then a multiply and an add,
none of them counted in `q5k_ms`), K11 (`k11_ms`: splash_prefill_kernel,
the first chunks of `--mix gemma2`); of K1's, K2's and K9's rows
instantiations, q4k_q8_rows_kernel, q8_0_q8_rows_kernel and
q5k_q8_rows_kernel, K9's decode q5k_q8_dec_kernel (`k9_ms`; in a tree
before it the 16-row q5k_q8_mma_kernel; the quantize kernel, and there the
split-K pass, not counted here), K10's (`k10_ms`:
plane_dec_kernel with the zs term, up to 16 rows, one launch a call; in a
tree before it plane_bf16_mma_kernel<2, whose call also ran the quantize
kernel and a split-K pass, named by that tree's copy of this script) and
plane_rows_kernel above;
and of plane_rows_kernel's other instantiations, K4's (Q6_K, `k4_rows_ms`:
the 4 x 40 step of `--mix q5km`, with int8 activations or without), K9b's
(one bit without the zs term, `k9b_rows_ms`), K5's (Q4_K's exact
two-part weight, `k5_rows_ms`) and K8's (signed 8-bit codes, `k8_rows_ms`),
the last three with `--int8-activations off`, beside the pre-pass
plane_prep_kernel of every rows call that has one (all but K8's); and of
K3's and K4's GEMVs up to 16 rows, `k3_ms` and `k4_ms`: kernels named
q6k_q8_* and q6k_bf16_* (q6k_q8_dec_kernel and q6k_bf16_dec_kernel; in a
tree before their decode design q6k_q8_mma_kernel and q6k_bf16_mma_kernel,
whose call also ran the quantize kernel and a split-K pass, not counted
here)), then the top device kernels and host ops by time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FEW = 4  # prompts in the traced prefill steps that fill a few of the slots


def _plane_fmt(key: str, kernel: str = "plane_rows_kernel"):
    """The template arguments BITS, SIGNED, ST, ZS (, KE) of a
    `kernel`<PlaneFmt<...>, ...> event's name (plane_rows_kernel or
    plane_dec_kernel), or None for another kernel (K4's rows kernel is
    plane_rows_kernel<Q6kFmt, BM>, K5's plane_rows_kernel<Q4kFmt<KE>, BM>)."""
    head = "PlaneFmt<"
    if f"{kernel}<" not in key or head not in key:
        return None
    return [a.strip() for a in key.split(head, 1)[1].split(">", 1)[0].split(",")]


# device time reported by kernel: a part of the kernel's name, or a test of it
NAMED_KERNELS = {"grouped_gemm": "grouped_gemm", "k13_tiles": "grouped_gemm_tiles_kernel",
                 "k13_decode": "grouped_gemm_decode_kernel",
                 "k5": lambda k: "q4k_bf16_mma" in k or ("plane_dec_kernel<" in k
                                                         and "Q4kFmt" in k),
                 "k8": lambda k: (_plane_fmt(k, "plane_dec_kernel") or [""] * 4)[:2] == [
                     "8", "true"],
                 "k9b": "plane_bf16_mma_kernel<1",
                 "q5k": "q5k_bf16_dec_kernel",
                 "k1_rows": "q4k_q8_rows_kernel", "k2_rows": "q8_0_q8_rows_kernel",
                 "k9": lambda k: "q5k_q8_mma_kernel" in k or "q5k_q8_dec_kernel" in k,
                 "k9_rows": "q5k_q8_rows_kernel",
                 "k10": lambda k: (_plane_fmt(k, "plane_dec_kernel") or [""] * 4)[3] == "true",
                 "k10_rows": lambda k: (_plane_fmt(k) or [""] * 4)[3] == "true",
                 "k3": "q6k_q8_", "k4": "q6k_bf16_",
                 "k4_rows": lambda k: "plane_rows_kernel<" in k and "Q6kFmt" in k,
                 "k9b_rows": lambda k: (_plane_fmt(k) or [""] * 4)[:4:3] == ["1", "false"],
                 "k5_rows": lambda k: "plane_rows_kernel<" in k and "Q4kFmt" in k,
                 "k8_rows": lambda k: (_plane_fmt(k) or [""] * 4)[:2] == ["8", "true"],
                 "plane_prep": "plane_prep_kernel",
                 "k6": "flash_prefill_kernel", "k6p": "flash_prefill_paged_kernel",
                 "k11": "splash_prefill_kernel",
                 "k12_chunk": "ragged_chunk", "k12_decode": "ragged_decode"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--mix", choices=("q4km", "q5km", "q2k", "gemma2", "mixtral"), default="q4km")
    ap.add_argument("--backend", choices=("default", "ragged"), default="default")
    ap.add_argument("--int8-activations", choices=("on", "off"), default="on")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import (GEMMA2, MIXTRAL, MIXTRAL_BF16_LAYERS, Sizes, gemma2_config,
                            mixtral_config, model_config, random_gemma2_params,
                            random_mixtral_params, random_q2k_params, random_q4km_params,
                            random_q5km_params)
    from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sz = {"gemma2": GEMMA2, "mixtral": MIXTRAL}.get(args.mix, Sizes())
    args.layers = args.layers or (MIXTRAL_BF16_LAYERS[0] if args.mix == "mixtral" else sz.layers)
    cfg = {"gemma2": gemma2_config, "mixtral": mixtral_config}.get(args.mix, model_config)(
        sz, args.layers)
    build = {"q4km": random_q4km_params, "q5km": random_q5km_params,
             "q2k": random_q2k_params, "gemma2": random_gemma2_params,
             "mixtral": random_mixtral_params}[args.mix]
    params = build(sz, args.layers, dev, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
    pc = PipelineConfig(page_size=16, num_pages=1024, max_seqs=args.batch, max_model_len=2048,
                        prefill_buckets=(64, 256), decode_steps=8, device="cuda",
                        rq8_group=None if args.mix == "q5km" else 32, attn_backend=args.backend,
                        int8_activations=args.int8_activations == "on")
    pipe = TextPipeline(cfg, params, make_rope(cfg, 2048, device=dev), pc)
    del params
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    rng = np.random.default_rng(1)
    name = torch.cuda.get_device_name(0)

    def add(n, max_len, plen=200):
        return [eng.add_request(GenerationRequest(
            [int(t) for t in rng.integers(1, sz.vocab, plen)], SamplingParams(max_len=max_len)))
            for _ in range(n)]

    def traced_prefill(n, max_len, plen=200):
        groups = add(n, max_len, plen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()  # one batched first-chunk prefill (ends in a device->host fetch)
            wall = time.perf_counter() - t0
        if any(s.state.value in ("waiting", "running_prefill") for g in groups for s in g.seqs):
            raise RuntimeError("the prefill took more than one engine step")
        report(f"prefill_{n}x{plen}", name, args, prof, wall, {
            "prefill_ms": wall * 1e3, "prompts": n, "prompt_tokens": plen * n})
        return groups

    for n, plen in ((args.batch, 200), (FEW, 40), (FEW, 200)):
        warm = add(n, 1, plen)
        while not all(g.all_done() for g in warm):
            eng.step()
    traced_prefill(FEW, 1, 40)  # max_len 1: done after its prefill step
    traced_prefill(FEW, 1)
    groups = traced_prefill(args.batch, 1000)
    seqs = [g.seqs[0] for g in groups]
    for s in seqs:  # reserve pages for the timed calls' KV writes
        eng.block_manager.append_slot(s, pc.decode_steps)

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
    report("decode", name, args, prof, wall, {
        "forward_ms": step_ms, "forward_ms_all": [1e3 * t / pc.decode_steps for t in times],
        "tok_s": args.batch * 1e3 / step_ms, "forwards_traced": pc.decode_steps})
    return 0


def report(phase, name, args, prof, wall, extra) -> None:
    ka = prof.key_averages()
    kernels = [e for e in ka if e.self_device_time_total > 0
               and getattr(e.device_type, "name", "") == "CUDA"]  # device-side events only
    dev_us = sum(e.self_device_time_total for e in kernels)
    # cudaLaunchKernel, and cudaLaunchKernelExC for the launches with attributes
    # (the clusters of K1's and K2's decode instantiations)
    launches = sum(e.count for e in ka if e.key.startswith("cudaLaunchKernel"))
    graph_launches = sum(e.count for e in ka if e.key.startswith("cudaGraphLaunch"))
    # fewer device kernel events than launches: the trace dropped some, and
    # device_busy_ms covers only the forwards it kept
    events = sum(e.count for e in kernels)
    named = {}
    for label, part in NAMED_KERNELS.items():
        hit = part if callable(part) else lambda k, _p=part: _p in k
        us = sum(e.self_device_time_total for e in kernels if hit(e.key))
        named[f"{label}_ms"] = us / 1e3
        named[f"{label}_share"] = us / max(dev_us, 1e-9)
    print(json.dumps({"phase": phase, "device": name, "mix": args.mix, "backend": args.backend,
                      "int8_activations": args.int8_activations, "layers": args.layers,
                      "batch": args.batch, **extra, "traced_wall_ms": wall * 1e3,
                      "device_busy_ms": dev_us / 1e3, "device_busy_share": dev_us / 1e6 / wall,
                      "launches": launches, "graph_launches": graph_launches,
                      "device_kernel_events": events, **named}))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(json.dumps({"phase": phase, "kernel": e.key[:90], "count": e.count,
                          "device_ms": e.self_device_time_total / 1e3}))
    for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(json.dumps({"phase": phase, "host_op": e.key[:90], "count": e.count,
                          "host_ms": e.self_cpu_time_total / 1e3}))


if __name__ == "__main__":
    sys.exit(main())
