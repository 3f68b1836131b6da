#!/usr/bin/env python3
"""Drive the PyTorch port (mistralrs_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py    # on a machine with one H100

Phases (each prints one JSON line; any failure raises, so the script exits
non-zero and never prints the final line):
1. device: needs torch.cuda.is_available(); prints the card's name and power
   limit as nvidia-smi gives them, and turns TF32 off for f32 matmuls.
2. build: compiles every kernel of the path (csrc/*.cu, one nvcc each, in
   parallel) and reports the seconds.
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes of a Mistral-7B Q4_K_M, Q5_K_M and Q2_K decode step (batch 16 and
   1; the plane-affine GEMV also in its GPTQ and HQQ layouts) and
   of prefill chunks of 64 and 256 rows (the most the GEMVs take), of first
   prefill chunks, of continuation chunks and decode steps over a paged
   context of up to 4096 tokens, and of the prefill route's dequantization; the
   splash prefill kernel (K11) at Gemma-2-9B's and Gemma-2-2B's first chunks
   (soft cap 50, with and without a window) and at a Mistral-width chunk
   clipped by a window; the block-table decode kernel (K7) also at
   Gemma-2-9B's head dim 256 with the soft cap; with the tolerance stated;
   then kernel, plain-version and library-call times (CUDA
   events, median of 25 runs, L2 flushed before each) beside the least time
   the card could take (bound); the Q6_K GEMVs K3 and K4 at 1, 4 and 16
   rows, with the kernels the card runs a call at 16 (K3 two, K4 one), and
   for K3 also the time of the int8 GEMV (K2) on the same weight
   requantized to int8 per 32 (rq8); the plane-affine GEMV K10 at 1, 4 and
   16 rows in every layout, and K8 at 1, 4 and 16 at v, q|k, gate|up, down
   and the lm_head, with the kernels the card runs a call at 16 (one each);
   K9 at 1, 4 and 16 rows (two a call at 16), K5 at q|k, o, gate|up and
   down at 1, 4 and 16 (one a call at 16) and K9b's decode instantiation
   (the whole Q5_K x bf16 product) at the same (one a call of the
   dispatcher at each).
   K1, K2 and K9 also at 64, 128 and 256 rows (K9 at 17 too), K10 at 64 and
   256 in every layout, K4 (the Q6_K bf16 GEMV) at 17, 64, 128 and 256: the
   rows instantiations.
4. slice: the 32-layer Mistral-7B Q4_K_M model with random packed weights
   (the value ranges of bench.py), fused and Q6_K->int8 requantized by the
   pipeline, serves 8 greedy requests through Engine/TextPipeline: ~200-token
   prompts (first chunk on the flash kernel) and ~40-token prompts (gather +
   sdpa). The launch counts are set to 0 just before and read just after.
   tests/test_torch_chip_smoke.py runs the model builders at a tiny size on
   the CPU. In every serving phase each multistep decode call is one
   replay of a CUDA graph of the decode loop (pipeline/graphs.py): the
   phase raises unless the replay counter moved and no call ran the eager
   loop, and its line gives the graphs captured, their capture seconds and
   their memory pool's size.
5. decode_graph: the same 32-layer model at 16 slots, 16 prefilled
   sequences, multistep calls of 8 steps on the same inputs: the eager
   loop against the graph replay, greedy and sampled (temperature 1.5,
   top-k 40) at one seed, tokens equal and packs bit-equal, a replay's
   launch counts equal to the eager loop's; another seed gives other
   tokens; wall ms a call and a forward, eager and graph in turns (medians
   of 5), device ms of a replay (CUDA events); then a greedy and a sampled
   wave of 16 requests (temperature 0.8, top-k 40, top-p 0.95, min-p 0.05)
   through Engine (decode tok/s, p50 TTFT), the sampled one on the sampled
   graph.
6. long_context: the same 32-layer model on head-major pools
   (max_model_len 4096, 512-token chunks, ~2,048 pages of KV) serves two
   waves through Engine/TextPipeline: 4 greedy requests of ~3,400-token
   prompts (7 chunks: K6 once, the paged continuation kernel K6' six
   times; decode at span 4096 on the block-table decode kernel K7), then 4
   of ~1,200 tokens (3 chunks; decode at span 2048 on gather +
   sdpa_head_major). The launch counts are set to 0 just before the first
   wave and read after each.
7. quant_mix: the 32-layer Mistral-7B in the Q5_K_M mix (Q5_K where Q4_K_M
   has Q4_K) with Q6_K kept as Q6_K (rq8_group=None) serves the slice
   phase's pattern through Engine/TextPipeline: 4 x 256-row first chunks
   (q5k_dequant / q6k_dequant + torch.matmul, flash prefill), 4 x 64-row
   chunks (the rows instantiations of K9 and K4), decode at batch 16 (K9's
   decode instantiation and K3). It raises unless K3, K4's rows instantiation,
   both instantiations of K9 and both dequant kernels launched and K1 and
   K2 did not.
8. q2k: the 32-layer Mistral-7B in llama.cpp's Q2_K mix (Q2_K q, k, gate,
   up; Q4_K v; Q3_K o and down packed into the Q6_K layout; Q6_K lm_head),
   Q3_K and Q6_K requantized to int8 per 32 by the pipeline, serves the
   slice phase's pattern: 4 x 256-row first chunks (affine_dequant /
   q4k_dequant / q8_0_dequant + torch.matmul, flash prefill), 4 x 64-row
   chunks (the plane-affine GEMV K10's rows instantiation, K1 and K2's)
   and decode at batch 16 (K10's decode instantiation, K1 and K2). It raises
   unless those kernels, both instantiations of K10 among them, launched
   and no Q5_K or Q6_K kernel did.
9. gemma2: Gemma-2-9B (config_from_hf on google/gemma-2-9b's config.json:
   42 layers, 16 heads / 8 kv heads of 256, logit soft caps 50 and 30,
   alternating windows of 4096, sandwich norms, gelu-tanh) with every
   projection in Q4_K (as ISQ Q4K loads it) and the tied bf16 embedding as
   the lm_head serves the slice phase's pattern: 4 x 256-row first chunks
   (q4k_dequant + torch.matmul, K11), 4 x 64-row chunks and decode at batch
   16 (K1, gather + the soft cap). It raises unless K11, K1 and q4k_dequant
   launched and K6 did not.
10. card_vs_cpu: a 2-layer full-width model with identical weights on the card
   (kernels, bf16) and on the CPU (plain versions, f32): one 256-token
   prefill and 4 decode steps, logits compared, in the Q4_K_M mix, in
   the Q5_K_M mix with Q6_K kept (with int8 activations, and without: K9b
   and K4 in both their instantiations and K5's rows one, the only served
   path of K4's 16-row one) and in the Q2_K mix; then on head-major
   pools a 512-token first chunk, a 512-token continuation chunk and 4
   decode steps at a table width of 256 pages (K6, K6', K7 on the card).
11. card_vs_cpu_gemma2: the same for a 2-layer Gemma-2-9B (one local and
   one global layer, the full vocabulary): a 256-token first chunk (K11)
   and 4 decode steps on token-major pools; on head-major pools a 512-token
   first chunk (K11), a 512-token continuation chunk (gather + the soft
   cap) and 4 decode steps at span 4096 (K7 with the soft cap at head dim
   256).
12. gemma2_ragged: Gemma-2-9B as in phase 9 on the ragged attention backend
   (one combined K/V pool, max_model_len 8192, 1,536 pages of 16 = 8.5 GB
   of KV) serves two waves: 4 greedy requests of ~4,600-token prompts (9
   chunks of 512: K11 on the first, the ragged paged attention kernel K12 on
   the rest, the window clipping on the local layers past position 4096; 64
   tokens each, decoded at span 8192 on K12), then 16 of ~200 tokens (K11,
   then decode at batch 16 on K12), 32 tokens each. It raises unless K12
   (both its chunk and its decode instantiation) and K11 launched and K6,
   K6' and K7 did not.
13. card_vs_cpu_ragged: the phase-10 comparison on the ragged backend, for
   2-layer Mistral-7B Q4_K_M (rq8) and Gemma-2-9B: a ~1,200-token prompt in
   a 512-token first chunk (K6 / K11), continuation chunks of 512 and 176
   (padded to 256: a ragged q_len) on K12's chunk instantiation, then 4
   decode steps on its decode one.
14. mixtral: Mixtral-8x7B (config_from_hf on mistralai/Mixtral-8x7B-v0.1's
   config.json) as ISQ Q4K loads the HF checkpoint: Q4_K attention, router
   and lm_head, dense bf16 experts (2.82 GB a layer, so 24 of its 32 layers;
   16 if the card's free memory is short), served in the slice phase's
   pattern through the grouped dropless dispatch: the grouped GEMM K13 at
   M = 2,048 (4 x 256-row first chunks, with K6) and 512 (4 x 64 rows) on
   its tiles instantiation, and <= 32 (decode; K1 for the router and the
   attention) on its decode one. It raises unless K13 (both
   instantiations), K6 and K1 launched.
15. mixtral_q4km: the same model from a GGUF in the Q4_K_M rule at all 32
   layers: Q4_K experts stacked [E, ...] (28 GB), Q4_K q, k, o, Q6_K attn_v
   and lm_head (rq8), the dense router; the same pattern through the
   every-expert branch, each expert on K1 up to 256 rows. It raises unless
   K1 served the experts and K13 did not launch.
16. card_vs_cpu_mixtral: phase 10's comparison for 1-layer Mixtral at full
   width, with dense bf16 experts (K13 on the card) and with packed Q4_K
   experts (K1).
17. gguf_bf16: Mistral-7B served from a GGUF file with bf16 activations:
   a 32-layer file in llama.cpp's Q5_K_M rule (random wire blocks, ~5 GB)
   written by the port's writer into a temporary directory, loaded by
   load_gguf_model and served through Engine/TextPipeline with
   PipelineConfig(int8_activations=False) in the slice phase's pattern:
   K9b's decode instantiation (the whole Q5_K product, one launch) for
   every Q5_K projection at decode, K5's and K9b's rows instantiations at
   17-256 rows, K8 for the requantized Q6_K ones up to 256 rows, the Q5_K
   and int8 dequant kernels above, K6. It raises unless both
   instantiations of K9b and K8, K5's rows one and K6 launched, and if K5's
   decode instantiation or an int8 GEMV (K1, K2, K3, K9) did;
   its line gives the write, read, embedding-dequant and load times apart.
18. card_vs_cpu_bf16: phase 10's comparison with int8_activations=False for
   2-layer full-width GGUF files in the Q4_K_M rule (K5, K8: K5's decode
   instantiation's served path) and the Q5_K_M rule (K5's rows, K9b, K8),
   each loaded by load_gguf_model on each side; and,
   as a control, the same files with int8 activations (K1, K9, K2).
19. hf_isq (run after gemma2): Gemma-2-9B from an HF checkpoint: an
   8-layer checkpoint at full width (random bf16 weights, HF's init std, in
   two safetensors shards written by write_safetensors, no package) in a
   temporary directory (its free space printed first), loaded by
   load_hf_model(path, isq="Q4K") (the Q4_K scale search on the host, the
   layers in the loader's threads), served in the slice phase's pattern
   (K11, q4k_dequant, K1 on graph replays); then pipe.re_isq("Q8_0") and
   two more waves (the first captures the decode graphs anew; K2 and
   q8_0_dequant). It raises unless every projection loaded as Q4_K with a
   bf16 embedding, K1, K11 and q4k_dequant launched, and after re_isq the
   kinds are Q8_0, the graphs were dropped and captured anew and K2
   launched; its line gives the write, header-read, load and ISQ seconds
   (a layer too), the checkpoint's GB and GB/s, and re_isq's seconds.
20. card_vs_cpu_isq: that checkpoint at 2 layers (the same seed, so the
   same first layers), loaded with ISQ Q4K on the card and on the CPU
   (every packed byte equal), phase 10's
   token-major comparison (K11, K1 on the card), and the ISQ model's logit
   error against the same checkpoint loaded dense.
21. speculative (run after decode_graph): the slice's 32-layer Mistral-7B
   Q4_K_M (rq8) at 16 slots serves waves of 16 requests (~256-token prompts,
   128 new tokens) through Engine: plain greedy on the decode graphs (the
   reference streams), SpeculativePipeline with draft A (the target's first
   8 layers, its weights shared, a KV pool of its own; gamma 4, 13 rounds a
   call) and with draft B (the target's own weights, the perfect draft),
   PromptLookupPipeline (gamma 3, 16 rounds; prompts a random 32-token
   segment repeated, with a plain wave on them as their reference), greedy on
   the speculative device loops (one graph replay a call), then a sampled
   wave (temperature 0.7, top-p 0.9; 32 new tokens) on draft A's pipeline,
   the host step with rejection sampling. Each engine first serves a short
   warm-up wave (the graphs of every width captured). It raises if a greedy
   stream differs from plain decoding other than at a near-tie (at the first
   differing token the shared prefix is rescored by the plain pipeline and
   the two tokens' logits must lie within 1% of that row's largest |logit|),
   if draft B accepts under 95% of its proposals, if a greedy wave ran an
   eager loop or a host step or no replay, or if a sampled token is outside
   the vocabulary or a request did not finish; its lines give each wave's
   decode tok/s, p50 TTFT, proposed and accepted tokens, replays, captures,
   capture seconds, K1's and K2's launches at both instantiations, and the
   launches one replay of each speculative graph adds.
22. long_kv (run after long_context): the 32-layer Mistral-7B Q4_K_M (rq8)
   at max_model_len 32768 on head-major pools, 512-token chunks, the pool
   sized to each run: (a) bf16 pools, 2 greedy requests of ~9,000-token
   prompts, 16 new tokens: K6 on the first chunk, K6' on chunks 2-8, the
   blockwise route (models/decoder.py, ops/paged_attention.py
   `blockwise_prefill_continuation`) on chunks 9-18 (spans 8192-16384),
   decode at span 16384 on K7 in the graphs; (b) kv_quant=True (int8
   pools), 2 of ~16,600 tokens, 24 new: chunks 2-8 gather and dequantize,
   chunks 9-33 blockwise, decode at span 32768 blockwise inside the decode
   graphs, K6' and K7 never; (c) Engine(preempt_mode="swap") with pages for
   ~5 of 8 greedy requests of ~600 tokens and 64 new: at least one swap
   out and in, no swapped sequence prefilled again, every stream equal to
   an uncontended engine's (or, as in the speculative phase, a near-tie
   at its first difference); (d) 1 layer at full width, a 4,600-token
   prompt (a first chunk of 4096 on K6, then a chunk of 504 at span 8192 on
   the blockwise route) on the card and on the CPU, bf16 and int8 pools:
   the last position's logits within 5% of the largest
   |logit|, and on the card the blockwise step against the gather route
   on the same step within the same rule. Its lines give each run's
   decode tok/s (decode steps that captured no graph), p50 TTFT, route
   counts (`blockwise_steps`, a graph replay adding its capture's), the
   pool's GB and tokens of capacity for bf16 and int8 pools at the card's
   free memory, the device ms of one layer's blockwise attention at each
   run's longest span (a CUDA graph of the call, replayed between CUDA
   events) and the wall ms of the run's last prefill step, the swap
   counts, and the phase's seconds.
The kernel phase also holds K5, K9b and K8 against their plain versions at
the gguf_bf16 path's shapes (K9b's rows instantiation at gate|up at 17, 64,
128 and 256 rows; q|k, o, down; K5 and K9b's decode instantiation at all
four at 1, 4 and 16 rows; K5's and K8's rows
instantiations at 17, 64 and 256 rows;
K8 also at v and the lm_head on rq8 and wire Q8_0 scales, its decode
instantiation at 1, 4 and 16 rows), K12 against its plain
version (decode at Mistral-7B's and Gemma-2-9B's widths, 4 x 512 continuation chunks, a mixed
batch of a decode row, a first chunk and a continuation with fewer live
sequences than slots), and K13 at Mixtral's gate and down for a decode
step, 4 x 64-, 4 x 256- and 4 x 512-row chunks, and all rows in one group.
Each phase before a Mixtral one frees its memory (its objects are deleted,
then gc.collect and torch.cuda.empty_cache).
Then the gemv_decode line (K1's and K2's batch-16 times summed over the
calls of one batch-16 Q4_K_M decode forward, beside the sum of their bounds,
and the kernels the card runs a call, from a torch.profiler trace), the
card's name and power limit again, the kernels line and, last, {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, bf16 and int8 op/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12

KERNEL_INFO = {
    "q4k_q8_gemv": ("mistralrs_tpu_torch/csrc/q4k_q8_gemv.cu",
                    "mistralrs_tpu/ops/quant_matmul.py:348"),
    "q8_0_q8_gemv": ("mistralrs_tpu_torch/csrc/q8_0_q8_gemv.cu",
                     "mistralrs_tpu/ops/quant_matmul.py:1245"),
    # the rows instantiations of the same two (17-256 rows), counted apart
    "q4k_q8_gemv_rows": ("mistralrs_tpu_torch/csrc/q4k_q8_gemv.cu",
                         "mistralrs_tpu/ops/quant_matmul.py:348"),
    "q8_0_q8_gemv_rows": ("mistralrs_tpu_torch/csrc/q8_0_q8_gemv.cu",
                          "mistralrs_tpu/ops/quant_matmul.py:1245"),
    "flash_prefill": ("mistralrs_tpu_torch/csrc/flash_prefill.cu",
                      "mistralrs_tpu/models/decoder.py:416"),
    "flash_prefill_paged": ("mistralrs_tpu_torch/csrc/flash_prefill_paged.cu",
                            "mistralrs_tpu/ops/paged_attention.py:431"),
    "paged_decode": ("mistralrs_tpu_torch/csrc/paged_decode.cu",
                     "mistralrs_tpu/ops/paged_attention.py:351"),
    # not TPU kernels: the dequantization XLA fuses on the JAX prefill route
    "q4k_dequant": ("mistralrs_tpu_torch/csrc/q4k_q8_gemv.cu",
                    "mistralrs_tpu/quant/gguf_linear.py:454"),
    "q8_0_dequant": ("mistralrs_tpu_torch/csrc/q8_0_q8_gemv.cu",
                     "mistralrs_tpu/quant/gguf_linear.py:525"),
    # K3 (1-16 rows only) and K4's decode instantiation (1-16 rows): one
    # source, the cluster decode kernels q6k_q8_dec_kernel (two launches a
    # call: the quantize kernel, then the GEMV) and q6k_bf16_dec_kernel (one)
    "q6k_q8_gemv": ("mistralrs_tpu_torch/csrc/q6k_gemv.cu",
                    "mistralrs_tpu/ops/quant_matmul.py:954"),
    "q6k_bf16_gemv": ("mistralrs_tpu_torch/csrc/q6k_gemv.cu",
                      "mistralrs_tpu/ops/quant_matmul.py:896"),
    # K4's and K9b's rows instantiations (17-256 rows), counted apart
    "q6k_bf16_gemv_rows": ("mistralrs_tpu_torch/csrc/q6k_gemv.cu",
                           "mistralrs_tpu/ops/quant_matmul.py:896"),
    # K9's decode instantiation (1-16 rows): q5k_q8_dec_kernel, two launches
    # a call (the quantize kernel, then the GEMV)
    "q5k_q8_gemv": ("mistralrs_tpu_torch/csrc/q5k_q8_gemv.cu",
                    "mistralrs_tpu/ops/quant_matmul.py:757"),
    # K9's and K10's rows instantiations (17-256 rows), counted apart
    "q5k_q8_gemv_rows": ("mistralrs_tpu_torch/csrc/q5k_q8_gemv.cu",
                         "mistralrs_tpu/ops/quant_matmul.py:757"),
    "q6k_dequant": ("mistralrs_tpu_torch/csrc/q6k_gemv.cu",
                    "mistralrs_tpu/quant/gguf_linear.py:469"),
    "q5k_dequant": ("mistralrs_tpu_torch/csrc/q5k_q8_gemv.cu",
                    "mistralrs_tpu/quant/gguf_linear.py:498"),
    # K10's, K8's and K5's decode instantiations (1-16 rows): one template,
    # plane_dec_kernel (csrc/plane_gemv.cuh), one launch a call
    "affine_gemv": ("mistralrs_tpu_torch/csrc/affine_gemv.cu",
                    "mistralrs_tpu/ops/quant_matmul.py:533"),
    "affine_gemv_rows": ("mistralrs_tpu_torch/csrc/affine_gemv.cu",
                         "mistralrs_tpu/ops/quant_matmul.py:533"),
    "affine_dequant": ("mistralrs_tpu_torch/csrc/affine_gemv.cu",
                       "mistralrs_tpu/quant/gguf_linear.py:515"),
    "splash_prefill": ("mistralrs_tpu_torch/csrc/splash_prefill.cu",
                       "mistralrs_tpu/ops/splash.py:59"),
    "ragged_attention": ("mistralrs_tpu_torch/csrc/ragged_attention.cu",
                         "mistralrs_tpu/ops/ragged_attention.py:162"),
    "grouped_gemm": ("mistralrs_tpu_torch/csrc/grouped_gemm.cu",
                     "mistralrs_tpu/ops/grouped_gemm.py:60"),
    "q4k_bf16_gemv": ("mistralrs_tpu_torch/csrc/q4k_bf16_gemv.cu",
                      "mistralrs_tpu/ops/quant_matmul.py:67"),
    "q8_0_bf16_gemv": ("mistralrs_tpu_torch/csrc/q8_0_bf16_gemv.cu",
                       "mistralrs_tpu/ops/quant_matmul.py:1197"),
    # K9b's decode instantiation (1-16 rows): the whole Q5_K x bf16 product
    # (_q4k_kernel's and _q5k_hbit_kernel's sums and JAX's add), one launch
    "q5k_bf16_gemv": ("mistralrs_tpu_torch/csrc/q5k_bf16_gemv.cu",
                      "mistralrs_tpu/ops/quant_matmul.py:658"),
    "q5k_hbit_bf16_gemv_rows": ("mistralrs_tpu_torch/csrc/q5k_hbit_bf16_gemv.cu",
                                "mistralrs_tpu/ops/quant_matmul.py:658"),
    # K5's and K8's rows instantiations (17-256 rows), counted apart
    "q4k_bf16_gemv_rows": ("mistralrs_tpu_torch/csrc/q4k_bf16_gemv.cu",
                           "mistralrs_tpu/ops/quant_matmul.py:67"),
    "q8_0_bf16_gemv_rows": ("mistralrs_tpu_torch/csrc/q8_0_bf16_gemv.cu",
                            "mistralrs_tpu/ops/quant_matmul.py:1197"),
}
# the shape whose numbers stand in the kernels line
HEADLINE = {"q4k_q8_gemv": "gate|up B=16", "q8_0_q8_gemv": "lm_head B=16",
            "q4k_q8_gemv_rows": "gate|up B=256", "q8_0_q8_gemv_rows": "lm_head B=256",
            "flash_prefill": "B=4 T=512", "flash_prefill_paged": "B=4 T=512 kv=4096 head_major",
            "paged_decode": "B=16 kv=4096 head_major", "q4k_dequant": "gate|up",
            "q8_0_dequant": "down rq8", "q6k_q8_gemv": "lm_head B=16",
            "q6k_bf16_gemv": "down B=16", "q6k_bf16_gemv_rows": "down B=256",
            "q5k_q8_gemv": "gate|up B=16", "q6k_dequant": "down",
            "q5k_dequant": "gate|up", "affine_gemv": "gate|up q2k B=16",
            "q5k_q8_gemv_rows": "gate|up B=256", "affine_gemv_rows": "gate|up q2k B=256",
            "affine_dequant": "gate|up q2k", "splash_prefill": "gemma2-9b B=4 T=512",
            "ragged_attention": "mistral B=16 kv=4096 decode", "grouped_gemm": "gate M=32 decode",
            "q4k_bf16_gemv": "gate|up B=16", "q8_0_bf16_gemv": "lm_head B=16",
            "q5k_bf16_gemv": "gate|up B=16", "q5k_hbit_bf16_gemv_rows": "gate|up B=256",
            "q4k_bf16_gemv_rows": "gate|up B=256", "q8_0_bf16_gemv_rows": "lm_head B=256"}
# the kernels each serving phase's path adds (long_context also runs the
# slice path's, quant_mix also flash_prefill, q2k also the slice path's,
# gemma2 also q4k_q8_gemv and q4k_dequant, and paged_decode in
# card_vs_cpu_gemma2; gemma2_ragged also splash_prefill; mixtral also
# flash_prefill and q4k_q8_gemv; gguf_bf16 also flash_prefill and the
# Q5_K and int8 dequant kernels); K4's 16-row instantiation is served only
# where Q6_K is kept with bf16 activations, in card_vs_cpu's run of that
# mix (with int8 activations K3 takes every Q6_K shape at up to 16 rows);
# K5's decode instantiation only by a Q4_K_M model with bf16 activations,
# card_vs_cpu_bf16's Q4_K_M run (the Q5_K_M rule has no Q4_K tensor, and
# K9b's decode instantiation takes its Q5_K ones at 1-16 rows); the line's
# launches of each kernel come from the phase of its path
PATH_KERNELS = {
    "slice": ("q4k_q8_gemv", "q8_0_q8_gemv", "q4k_q8_gemv_rows", "q8_0_q8_gemv_rows",
              "flash_prefill", "q4k_dequant", "q8_0_dequant"),
    "long_context": ("flash_prefill_paged", "paged_decode"),
    "quant_mix": ("q6k_q8_gemv", "q6k_bf16_gemv_rows", "q5k_q8_gemv", "q5k_q8_gemv_rows",
                  "q6k_dequant", "q5k_dequant"),
    "q2k": ("affine_gemv", "affine_gemv_rows", "affine_dequant"),
    "gemma2": ("splash_prefill",),
    "gemma2_ragged": ("ragged_attention",),
    "mixtral": ("grouped_gemm",),
    "gguf_bf16": ("q5k_bf16_gemv", "q8_0_bf16_gemv", "q5k_hbit_bf16_gemv_rows",
                  "q4k_bf16_gemv_rows", "q8_0_bf16_gemv_rows"),
    "card_vs_cpu_q5km_bf16": ("q6k_bf16_gemv",),
    "card_vs_cpu_bf16_q4km": ("q4k_bf16_gemv",),
}
# each kernel's launch counter: (module under mistralrs_tpu_torch.ops, name)
COUNTERS = {
    "q4k_q8_gemv": ("quant_matmul", "q4k_q8_gemv_launches"),
    "q8_0_q8_gemv": ("quant_matmul", "q8_0_q8_gemv_launches"),
    "q4k_q8_gemv_rows": ("quant_matmul", "q4k_q8_gemv_rows_launches"),
    "q8_0_q8_gemv_rows": ("quant_matmul", "q8_0_q8_gemv_rows_launches"),
    "flash_prefill": ("flash_attention", "flash_prefill_launches"),
    "flash_prefill_paged": ("paged_attention", "flash_prefill_paged_launches"),
    "paged_decode": ("paged_attention", "paged_decode_launches"),
    "q4k_dequant": ("quant_matmul", "q4k_dequant_launches"),
    "q8_0_dequant": ("quant_matmul", "q8_0_dequant_launches"),
    "q6k_q8_gemv": ("quant_matmul", "q6k_q8_gemv_launches"),
    "q6k_bf16_gemv": ("quant_matmul", "q6k_bf16_gemv_launches"),
    "q6k_bf16_gemv_rows": ("quant_matmul", "q6k_bf16_gemv_rows_launches"),
    "q5k_q8_gemv": ("quant_matmul", "q5k_q8_gemv_launches"),
    "q6k_dequant": ("quant_matmul", "q6k_dequant_launches"),
    "q5k_dequant": ("quant_matmul", "q5k_dequant_launches"),
    "affine_gemv": ("quant_matmul", "affine_gemv_launches"),
    "q5k_q8_gemv_rows": ("quant_matmul", "q5k_q8_gemv_rows_launches"),
    "affine_gemv_rows": ("quant_matmul", "affine_gemv_rows_launches"),
    "affine_dequant": ("quant_matmul", "affine_dequant_launches"),
    "splash_prefill": ("splash", "splash_prefill_launches"),
    "ragged_attention": ("ragged_attention", "ragged_attention_launches"),
    "grouped_gemm": ("grouped_gemm", "grouped_gemm_launches"),
    "q4k_bf16_gemv": ("quant_matmul", "q4k_bf16_gemv_launches"),
    "q8_0_bf16_gemv": ("quant_matmul", "q8_0_bf16_gemv_launches"),
    "q5k_bf16_gemv": ("quant_matmul", "q5k_bf16_gemv_launches"),
    "q5k_hbit_bf16_gemv_rows": ("quant_matmul", "q5k_hbit_bf16_gemv_rows_launches"),
    "q4k_bf16_gemv_rows": ("quant_matmul", "q4k_bf16_gemv_rows_launches"),
    "q8_0_bf16_gemv_rows": ("quant_matmul", "q8_0_bf16_gemv_rows_launches"),
}


# counters of one instantiation of a kernel among the kernel's launches
# (K13's tiles instantiation, the rest of its launches the decode one; K12's
# chunk instantiation, the rest its decode one), reset and read with
# COUNTERS
INSTANCE_COUNTERS = {"grouped_gemm_tiles": ("grouped_gemm", "grouped_gemm_tiles_launches"),
                     "ragged_chunk": ("ragged_attention", "ragged_chunk_launches")}
# the device loops' graph counters (pipeline/graphs.py, pipeline/text.py,
# pipeline/speculative.py), reset and read with COUNTERS: decode and
# speculative graphs captured and replayed, calls that ran as an eager loop
# instead, and host-driven speculative steps
GRAPH_COUNTERS = {"decode_graph_captures": ("pipeline.graphs", "decode_graph_captures"),
                  "decode_graph_replays": ("pipeline.graphs", "decode_graph_replays"),
                  "decode_eager_loops": ("pipeline.text", "decode_eager_loops"),
                  "spec_graph_captures": ("pipeline.graphs", "spec_graph_captures"),
                  "spec_graph_replays": ("pipeline.graphs", "spec_graph_replays"),
                  "spec_eager_loops": ("pipeline.speculative", "spec_eager_loops"),
                  "spec_host_steps": ("pipeline.speculative", "spec_host_steps")}
# forwards that took the decoder's blockwise route (models/decoder.py)
ROUTE_COUNTERS = {"blockwise_steps": ("models.decoder", "blockwise_steps")}
ALL_COUNTERS = {**COUNTERS, **INSTANCE_COUNTERS, **GRAPH_COUNTERS, **ROUTE_COUNTERS}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _counter(name):
    import importlib

    mod, attr = ALL_COUNTERS[name]
    pkg = "mistralrs_tpu_torch" if "." in mod else "mistralrs_tpu_torch.ops"
    return importlib.import_module(f"{pkg}.{mod}"), attr


def reset_counts() -> None:
    for name in ALL_COUNTERS:
        mod, attr = _counter(name)
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(*_counter(name)) for name in ALL_COUNTERS}


def k1_k2_launches(counts: dict) -> tuple[int, int]:
    """K1's and K2's launches, both instantiations of each."""
    return (counts["q4k_q8_gemv"] + counts["q4k_q8_gemv_rows"],
            counts["q8_0_q8_gemv"] + counts["q8_0_q8_gemv_rows"])


@dataclasses.dataclass
class Sizes:
    """Mistral-7B widths and depth, and the slice's request sizes."""

    vocab: int = 32000
    hidden: int = 4096
    inter: int = 14336
    heads: int = 32
    kv_heads: int = 8
    head_dim: int = 128
    layers: int = 32
    long_prompt: int = 200
    short_prompt: int = 40
    max_len: int = 32
    # K6 parity/timing cases (B, T, Hq, Hkv): the kernel table's 4 x 512, a
    # ragged 200, the slice's batched first chunk of 4 x 256, 16 x 256, and
    # one prompt's first 512-token chunk
    flash_cases: tuple = ((4, 512, 32, 8), (1, 200, 32, 8), (4, 256, 32, 8), (16, 256, 32, 8),
                          (1, 512, 32, 8))
    # K6' cases (B, T, kv_len, head_major): a prompt's last 512-token chunk
    # at 4096 (the headline) and the same token-major, a ragged 256-row
    # chunk on both layouts, and 512-token chunks at a 2048-token context
    paged_prefill_cases: tuple = ((4, 512, 4096, True), (1, 256, 1000, True),
                                  (1, 256, 1000, False), (4, 512, 4096, False),
                                  (4, 512, 2048, True))
    # K7 cases (B, kv_len): the headline, a ragged batch, one row, and batch
    # 16 at the spans the gather route serves (1k, 2k) beside it
    paged_decode_cases: tuple = ((16, 4096), (4, 3456), (1, 4096), (16, 1024), (16, 2048))
    # long_context phase: prompt sizes of the two waves, tokens per request,
    # KV pages (~4.3 GB at full depth)
    long_prompt_ctx: int = 3400
    short_prompt_ctx: int = 1200
    max_len_ctx: int = 64
    pages_ctx: int = 2048


# Gemma-2-9B's widths and depth (google/gemma-2-9b config.json)
GEMMA2 = Sizes(vocab=256000, hidden=3584, inter=14336, heads=16, kv_heads=8, head_dim=256,
               layers=42)
# K11 cases (shape, B, T, Hq, Hkv, D, window, soft cap): Gemma-2-9B's first
# chunks (4 x 512, the headline; its local layers' window of 4096, which
# does not clip; a window of 128, which does; the gemma2 phase's 4 x 256),
# Gemma-2-2B's head widths, and a Mistral-width chunk clipped by a window
# without a cap (the other case _use_splash_prefill takes)
SPLASH_CASES = (("gemma2-9b B=4 T=512", 4, 512, 16, 8, 256, None, 50.0),
                ("gemma2-9b B=4 T=512 w=4096", 4, 512, 16, 8, 256, 4096, 50.0),
                ("gemma2-9b B=4 T=512 w=128", 4, 512, 16, 8, 256, 128, 50.0),
                ("gemma2-9b B=4 T=256", 4, 256, 16, 8, 256, None, 50.0),
                ("gemma2-2b B=4 T=512", 4, 512, 8, 4, 256, None, 50.0),
                ("mistral B=1 T=512 w=128", 1, 512, 32, 8, 128, 128, None))
# K7 at Gemma-2-9B's widths with the soft cap 50 (B, kv_len)
GEMMA2_DECODE_CASES = ((16, 4096), (16, 1024), (1, 4096))


# ------------------------------------------------------------- model


def use_more_bits(i: int, n: int) -> bool:
    """llama.cpp use_more_bits(): the ffn_down layers Q4_K_M puts in Q6_K."""
    return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2


def random_q4km_params(sz: Sizes, n_layers: int, device, gen, fdt):
    """Random packed weights in the device layouts with the Q4_K_M type mix
    (attn_v, lm_head and the use_more_bits ffn_down in Q6_K, the rest Q4_K),
    value ranges as bench.py: scales U[0.001, 0.005), mins U[0, 0.002)."""
    return _random_mix_params(sz, n_layers, device, gen, fdt, "gguf_q4k")


def random_q5km_params(sz: Sizes, n_layers: int, device, gen, fdt):
    """The same with the Q5_K_M type mix: Q5_K where Q4_K_M has Q4_K (llama.cpp
    takes both mixes through the same branches of llama_tensor_get_type)."""
    return _random_mix_params(sz, n_layers, device, gen, fdt, "gguf_q5k")


def random_q2k_params(sz: Sizes, n_layers: int, device, gen, fdt):
    """The same with llama.cpp's Q2_K mix for Mistral (llama_tensor_get_type,
    LLAMA_FTYPE_MOSTLY_Q2_K, n_gqa = 4): q, k, gate, up in Q2_K (2-bit codes
    uniform, scale U[0.001, 0.005), minv = 1.5 * scale, so each weight's
    mean is near zero and 32 layers stay finite); v in Q4_K; o and down in
    Q3_K, packed into the Q6_K layout as q3 + 28 (codes 28..35, as pack_q3k
    writes them); the lm_head in Q6_K."""
    return _random_mix_params(sz, n_layers, device, gen, fdt, "gguf_q2k")


def _rand_u8(gen, device, *shape):
    import torch

    return torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=gen)


def _rand_unif(gen, device, fdt, lo, hi, *shape):
    import torch

    return (torch.rand(shape, device=device, generator=gen) * (hi - lo) + lo).to(fdt)


def _rand_q4k(gen, device, fdt, i: int, o: int, kind: str = "gguf_q4k"):
    """A random Q4_K (or, with its high bits, Q5_K) Linear [i -> o]: codes
    uniform, scales U[0.001, 0.005), mins U[0, 0.002)."""
    from mistralrs_tpu_torch.quant.qlinear import Linear

    data = {"qs": _rand_u8(gen, device, i // 2, o),
            "scale": _rand_unif(gen, device, fdt, 0.001, 0.005, i // 32, o),
            "minv": _rand_unif(gen, device, fdt, 0.0, 0.002, i // 32, o)}
    if kind == "gguf_q5k":
        data["qh"] = _rand_u8(gen, device, i // 8, o)
    return Linear(kind, (i, o), data)


def _rand_q6k(gen, device, fdt, i: int, o: int, q3k: bool = False):
    """A random Q6_K Linear [i -> o] (codes uniform, so each weight's mean
    is near zero; scales U[0.001, 0.005)), or with q3k Q3_K codes packed
    into the Q6_K layout."""
    import torch

    from mistralrs_tpu_torch.quant.gguf_linear import q6k_chunk_size, q6k_perm
    from mistralrs_tpu_torch.quant.qlinear import Linear

    G = q6k_chunk_size(i)
    perm = torch.from_numpy(q6k_perm(i, G)).to(device)
    if q3k:
        # codes q3 + 28 of the four spans of each packed position (the
        # layout of _q6k_natural: ql rows of spans 0|2 then 1|3 per chunk,
        # high bits of span j at bits 2j of qh)
        c = 28 + torch.randint(0, 8, (4, i // (4 * G), G, o), dtype=torch.uint8,
                               device=device, generator=gen)
        lo, hi = c & 0xF, c >> 4
        ql = torch.stack([lo[0] | (lo[2] << 4), lo[1] | (lo[3] << 4)], dim=1)
        qh = hi[0] | (hi[1] << 2) | (hi[2] << 4) | (hi[3] << 6)
        ql, qh = ql.reshape(i // 2, o), qh.reshape(i // 4, o)
    else:
        ql, qh = _rand_u8(gen, device, i // 2, o), _rand_u8(gen, device, i // 4, o)
    return Linear("gguf_q6k", (i, o), {"ql": ql, "qh": qh,
                                       "scale": _rand_unif(gen, device, fdt, 0.001, 0.005,
                                                           i // 16, o),
                                       "perm": perm, "inv_perm": torch.argsort(perm)}, meta=G)


def _random_mix_params(sz: Sizes, n_layers: int, device, gen, fdt, base: str):
    import torch

    from mistralrs_tpu_torch.models.decoder import DecoderParams
    from mistralrs_tpu_torch.quant.qlinear import Linear

    def u8(*shape):
        return _rand_u8(gen, device, *shape)

    def unif(lo, hi, *shape):
        return _rand_unif(gen, device, fdt, lo, hi, *shape)

    def q4k(i, o, kind=base):
        return _rand_q4k(gen, device, fdt, i, o, kind)

    def q6k(i, o, q3k=False):
        return _rand_q6k(gen, device, fdt, i, o, q3k)

    def q2k(i, o):
        scale = unif(0.001, 0.005, i // 16, o)
        return Linear("gguf_q2k", (i, o), {"q": u8(i // 4, o), "scale": scale,
                                           "minv": (1.5 * scale.float()).to(fdt)})

    H, I, D = sz.hidden, sz.inter, sz.head_dim
    ones = torch.ones(H, dtype=fdt, device=device)
    layers = []
    for i in range(n_layers):
        if base == "gguf_q2k":
            attn = {"q": q2k(H, sz.heads * D), "k": q2k(H, sz.kv_heads * D),
                    "v": q4k(H, sz.kv_heads * D, "gguf_q4k"), "o": q6k(sz.heads * D, H, True)}
            mlp = {"gate": q2k(H, I), "up": q2k(H, I), "down": q6k(I, H, True)}
        else:
            attn = {"q": q4k(H, sz.heads * D), "k": q4k(H, sz.kv_heads * D),
                    "v": q6k(H, sz.kv_heads * D), "o": q4k(sz.heads * D, H)}
            mlp = {"gate": q4k(H, I), "up": q4k(H, I),
                   "down": (q6k if use_more_bits(i, sz.layers) else q4k)(I, H)}
        layers.append({"attn": attn, "mlp": mlp, "input_norm": {"w": ones},
                       "post_attn_norm": {"w": ones}})
    return DecoderParams(embed=unif(0.001, 0.005, sz.vocab, H), layers=layers,
                         final_norm={"w": ones}, lm_head=q6k(H, sz.vocab))


def random_gemma2_params(sz: Sizes, n_layers: int, device, gen, fdt):
    """Random packed weights of Gemma-2 as the JAX package serves an HF
    checkpoint loaded with ISQ Q4K (every projection in Q4_K, the lm_head
    the tied embedding): Q4_K q, k, v, o, gate, up and down in bench.py's
    value ranges; the bf16 embedding U[0.001, 0.005); norm weights 0, which
    the (1 + w) form makes 1."""
    import torch

    from mistralrs_tpu_torch.models.decoder import DecoderParams

    def q4k(i, o):
        return _rand_q4k(gen, device, fdt, i, o)

    H, I, D = sz.hidden, sz.inter, sz.head_dim
    zeros = torch.zeros(H, dtype=fdt, device=device)
    norms = ("input_norm", "post_attn_norm", "pre_mlp_norm", "post_mlp_norm")
    layers = [{"attn": {"q": q4k(H, sz.heads * D), "k": q4k(H, sz.kv_heads * D),
                        "v": q4k(H, sz.kv_heads * D), "o": q4k(sz.heads * D, H)},
               "mlp": {"gate": q4k(H, I), "up": q4k(H, I), "down": q4k(I, H)},
               **{n: {"w": zeros} for n in norms}} for _ in range(n_layers)]
    return DecoderParams(embed=_rand_unif(gen, device, fdt, 0.001, 0.005, sz.vocab, H),
                         layers=layers, final_norm={"w": zeros}, lm_head=None)


# Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1 config.json): Mistral-7B's
# attention widths and vocabulary, 8 experts of intermediate 14336, 2 a token
MIXTRAL = Sizes()
MIXTRAL_EXPERTS = 8
# the bf16-expert model's depth: its experts hold 2.82 GB a layer (90 GB over
# 32 layers), so 24 layers (68 GB) fit one 80 GB card; 16 if the card's free
# memory is short of MIXTRAL_BF16_NEED_GB
MIXTRAL_BF16_LAYERS = (24, 16)
MIXTRAL_BF16_NEED_GB = 74.0


def _rand_q4k_centered(gen, device, fdt, i: int, o: int, stack: tuple = ()):
    """A random Q4_K Linear [i -> o], its tensors stacked on leading axes
    `stack` (the experts' [E, ...]): codes uniform, scales U[0.001, 0.005),
    minv = 7.5 * scale, so each weight's mean is zero."""
    from mistralrs_tpu_torch.quant.qlinear import Linear

    scale = _rand_unif(gen, device, fdt, 0.001, 0.005, *stack, i // 32, o)
    return Linear("gguf_q4k", (i, o), {"qs": _rand_u8(gen, device, *stack, i // 2, o),
                                       "scale": scale, "minv": (7.5 * scale.float()).to(fdt)})


def _q4k_from_values(w, fdt):
    """A float weight [i, o] (i % 32 == 0) in the port's Q4_K layout, by a
    plain per-32 affine rounding (scale = (max - min) / 15, minv = -min):
    the layout ISQ Q4K loads a weight into, without its scale search."""
    import torch

    from mistralrs_tpu_torch.quant.qlinear import Linear

    i, o = w.shape
    wb = w.float().reshape(i // 32, 32, o)
    lo, hi = wb.amin(dim=1), wb.amax(dim=1)
    scale = ((hi - lo) / 15).clamp_min(1e-12)
    q = torch.round((wb - lo[:, None]) / scale[:, None]).clamp(0, 15).to(torch.uint8).reshape(i, o)
    return Linear("gguf_q4k", (i, o), {"qs": q[: i // 2] | (q[i // 2:] << 4),
                                       "scale": scale.to(fdt), "minv": (-lo).to(fdt)})


def random_mixtral_params(sz: Sizes, n_layers: int, device, gen, fdt, packed: bool = False,
                          experts: int = MIXTRAL_EXPERTS):
    """Random weights of Mixtral at sz's widths. Every weight has mean zero:
    a common mode in the hidden state would send every token to the same
    two experts. Token v's embedding row is c u_a + (c / 2) u_b plus
    N(0, 0.5^2) noise (c = 2 sqrt(H)), with u_e a random unit direction of
    expert e and (a, b) a random pair of experts of v; the router's column e
    is 2.3 u_e / sqrt(H). So each token's two experts lead its router logits
    by ~1 and ~2 over the others' ~0.03 (in rms_norm(h) units), layer after
    layer: every expert is routed tokens, with a margin far above bf16 and
    int8 rounding, which the card-vs-CPU check needs (a token routed to
    another expert on one side moves its logits by far more than rounding
    does). Norm weights 1.
    - packed=False: the HF checkpoint as ISQ Q4K loads it: Q4_K attention,
      router and lm_head; dense experts gate/up [E, H, I], down [E, I, H]
      drawn N(0, 1/in) in fdt.
    - packed=True: a GGUF in the Q4_K_M rule: Q4_K q, k, o and the experts'
      gate, up and down stacked [E, ...]; Q6_K attn_v and lm_head; the
      router dense (GGUF keeps ffn_gate_inp in F32)."""
    import torch

    from mistralrs_tpu_torch.models.decoder import DecoderParams
    from mistralrs_tpu_torch.quant.qlinear import Linear, make_dense

    H, I, D, E = sz.hidden, sz.inter, sz.head_dim, experts
    u = torch.randn(E, H, device=device, generator=gen)
    u = u / u.norm(dim=1, keepdim=True)
    a = torch.randint(0, E, (sz.vocab,), device=device, generator=gen)
    b = (a + torch.randint(1, E, (sz.vocab,), device=device, generator=gen)) % E
    c = 2 * H ** 0.5
    embed = c * u[a] + (c / 2) * u[b] + 0.5 * torch.randn(sz.vocab, H, device=device, generator=gen)
    router_w = (u.T * (2.3 / H ** 0.5)).contiguous()  # [H, E]

    def q4k(i, o, stack=()):
        return _rand_q4k_centered(gen, device, fdt, i, o, stack)

    def normal(*shape):
        w = torch.randn(shape, device=device, generator=gen, dtype=fdt)
        return Linear("dense", (shape[1], shape[2]), {"w": w.mul_(shape[1] ** -0.5)})

    ones = torch.ones(H, dtype=fdt, device=device)
    layers = []
    for _ in range(n_layers):
        if packed:
            v = _rand_q6k(gen, device, fdt, H, sz.kv_heads * D)
            mlp = {"router": make_dense(router_w.to(fdt)),
                   "experts": {"gate": q4k(H, I, (E,)), "up": q4k(H, I, (E,)),
                               "down": q4k(I, H, (E,))}}
        else:
            v = q4k(H, sz.kv_heads * D)
            mlp = {"router": _q4k_from_values(router_w, fdt),
                   "experts": {"gate": normal(E, H, I), "up": normal(E, H, I),
                               "down": normal(E, I, H)}}
        layers.append({"attn": {"q": q4k(H, sz.heads * D), "k": q4k(H, sz.kv_heads * D), "v": v,
                                "o": q4k(sz.heads * D, H)},
                       "mlp": mlp, "input_norm": {"w": ones}, "post_attn_norm": {"w": ones}})
    head = _rand_q6k(gen, device, fdt, H, sz.vocab) if packed else q4k(H, sz.vocab)
    return DecoderParams(embed=embed.to(fdt), layers=layers, final_norm={"w": ones}, lm_head=head)


def mixtral_config(sz: Sizes, n_layers: int, experts: int = MIXTRAL_EXPERTS):
    """config_from_hf on mistralai/Mixtral-8x7B-v0.1's config.json, at the
    widths of `sz`, `experts` experts and n_layers layers."""
    from mistralrs_tpu_torch.models.config import config_from_hf

    return config_from_hf({
        "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
        "vocab_size": sz.vocab, "hidden_size": sz.hidden, "intermediate_size": sz.inter,
        "num_hidden_layers": n_layers, "num_attention_heads": sz.heads,
        "num_key_value_heads": sz.kv_heads, "num_local_experts": experts,
        "num_experts_per_tok": 2, "hidden_act": "silu", "rms_norm_eps": 1e-5,
        "rope_theta": 1e6, "max_position_embeddings": 32768, "sliding_window": None,
        "tie_word_embeddings": False})


def model_config(sz: Sizes, n_layers: int):
    from mistralrs_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="mistral", vocab_size=sz.vocab, hidden_size=sz.hidden,
                       intermediate_size=sz.inter, num_layers=n_layers, num_heads=sz.heads,
                       num_kv_heads=sz.kv_heads, head_dim=sz.head_dim,
                       max_position_embeddings=4096, rope_theta=1e6)


def gemma2_hf_config(sz: Sizes, n_layers: int) -> dict:
    """google/gemma-2-9b's config.json at the widths of `sz` and n_layers
    layers (HF's keys; initializer_range is HF's default)."""
    return {
        "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
        "vocab_size": sz.vocab, "hidden_size": sz.hidden, "intermediate_size": sz.inter,
        "num_hidden_layers": n_layers, "num_attention_heads": sz.heads,
        "num_key_value_heads": sz.kv_heads, "head_dim": sz.head_dim,
        "query_pre_attn_scalar": 256, "sliding_window": 4096,
        "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
        "hidden_activation": "gelu_pytorch_tanh", "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
        "max_position_embeddings": 8192, "tie_word_embeddings": True,
        "initializer_range": 0.02, "torch_dtype": "bfloat16"}


def gemma2_config(sz: Sizes, n_layers: int):
    """config_from_hf on google/gemma-2-9b's config.json, at the widths of
    `sz` and n_layers layers."""
    from mistralrs_tpu_torch.models.config import config_from_hf

    return config_from_hf(gemma2_hf_config(sz, n_layers))


# ------------------------------------------------------------- GGUF files

# each random wire block's f16 scale fields (Q4_K and Q5_K: d and dmin at
# bytes 0:4, times 6-bit sc and mn up to 63; Q6_K: d at bytes 208:210, times
# int8 sc down to -128): ranges that keep the effective per-sub-block scale
# |d*sc| within bench.py's U[0.001, 0.005) and the min dmin*mn within its
# U[0, 0.002)
WIRE_SCALES = {"Q4_K": ((0, 0.001 / 63, 0.005 / 63), (2, 0.0, 0.002 / 63)),
               "Q5_K": ((0, 0.001 / 63, 0.005 / 63), (2, 0.0, 0.002 / 63)),
               "Q6_K": ((208, 0.001 / 128, 0.005 / 128),)}


def random_wire(rng, gtype: str, n: int) -> np.ndarray:
    """n weights of GGUF type gtype ("Q4_K", "Q5_K" or "Q6_K") as random
    wire blocks: random bytes (codes, 6-bit or int8 sub-scales, high bits),
    with each block's f16 d / dmin drawn from WIRE_SCALES, so every value is
    finite. uint8 [n / 256 * block bytes]."""
    from mistralrs_tpu_torch.gguf.reader import GGML_BLOCK_INFO, GGMLType

    be, bb = GGML_BLOCK_INFO[GGMLType[gtype]]
    b = rng.integers(0, 256, (n // be, bb), dtype=np.uint8)
    for off, lo, hi in WIRE_SCALES[gtype]:
        d = (rng.random(n // be, dtype=np.float32) * (hi - lo) + lo).astype(np.float16)
        b[:, off:off + 2] = d.view(np.uint8).reshape(-1, 2)
    return b.reshape(-1)


def gguf_mix(base: str, i: int, n_layers: int) -> dict[str, str]:
    """llama.cpp's Q4_K_M (base "Q4_K") or Q5_K_M (base "Q5_K") rule for
    Mistral-7B's layer i (llama_tensor_get_type): the base type for attn_q,
    attn_k, attn_output, ffn_gate, ffn_up and most ffn_down; Q6_K for
    attn_v and the use_more_bits ffn_down."""
    return {"attn_q": base, "attn_k": base, "attn_v": "Q6_K", "attn_output": base,
            "ffn_gate": base, "ffn_up": base,
            "ffn_down": "Q6_K" if use_more_bits(i, n_layers) else base}


def write_random_gguf(path: str, sz: Sizes, n_layers: int, base: str, seed: int) -> int:
    """A Mistral-7B GGUF at sz's widths and n_layers layers, as llama.cpp
    lays one out ("llama" architecture; Mistral-7B-Instruct-v0.2's rope base
    1e6 and context 32768), in gguf_mix(base): the token embedding in the
    base type, the output in Q6_K, F32 norms of ones, every quantized tensor
    random_wire blocks. Written by the port's writer; returns its bytes."""
    from mistralrs_tpu_torch.gguf.reader import GGMLType
    from mistralrs_tpu_torch.gguf.writer import write_gguf

    rng = np.random.default_rng(seed)
    H, I, D = sz.hidden, sz.inter, sz.head_dim

    def q(gtype, out_f, in_f):
        return (GGMLType[gtype], (out_f, in_f), random_wire(rng, gtype, out_f * in_f))

    ones = (GGMLType.F32, (H,), np.ones(H, np.float32))
    tensors = {"token_embd.weight": q(base, sz.vocab, H), "output_norm.weight": ones,
               "output.weight": q("Q6_K", sz.vocab, H)}
    shapes = {"attn_q": (sz.heads * D, H), "attn_k": (sz.kv_heads * D, H),
              "attn_v": (sz.kv_heads * D, H), "attn_output": (H, sz.heads * D),
              "ffn_gate": (I, H), "ffn_up": (I, H), "ffn_down": (H, I)}
    for i in range(n_layers):
        tensors[f"blk.{i}.attn_norm.weight"] = ones
        tensors[f"blk.{i}.ffn_norm.weight"] = ones
        for name, gtype in gguf_mix(base, i, n_layers).items():
            tensors[f"blk.{i}.{name}.weight"] = q(gtype, *shapes[name])
    md = {"general.architecture": "llama", "general.name": "random Mistral-7B",
          "llama.block_count": n_layers, "llama.embedding_length": H,
          "llama.feed_forward_length": I, "llama.attention.head_count": sz.heads,
          "llama.attention.head_count_kv": sz.kv_heads, "llama.rope.dimension_count": D,
          "llama.attention.layer_norm_rms_epsilon": 1e-5, "llama.rope.freq_base": 1e6,
          "llama.context_length": 32768, "llama.vocab_size": sz.vocab}
    write_gguf(path, md, tensors)
    return sum(t[2].nbytes for t in tensors.values())


# ------------------------------------------------------------- HF checkpoints

# safetensors dtype names of the arrays write_safetensors takes (BF16 as
# its uint16 bits)
ST_DTYPES = {"BF16": np.uint16, "F16": np.float16, "F32": np.float32, "I32": np.int32}


def write_safetensors(path: str, tensors: dict) -> int:
    """A safetensors file (the format's own layout, no package): name ->
    (dtype name, shape, array or a function that returns it), each array of
    ST_DTYPES[dtype name] (BF16 as uint16 bits) and the given shape, written
    one after another in the order given. Returns the data's bytes."""
    header, off = {}, 0
    for name, (dt, shape, _) in tensors.items():
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(ST_DTYPES[dt]).itemsize
        header[name] = {"dtype": dt, "shape": list(shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for name, (dt, shape, arr) in tensors.items():
            a = np.ascontiguousarray(arr() if callable(arr) else arr)
            if a.dtype != ST_DTYPES[dt] or a.shape != tuple(shape):
                raise ValueError(f"{name}: {a.dtype} {a.shape}, not {dt} {tuple(shape)}")
            f.write(a.data)
    return off


def write_gemma2_hf(path: str, sz: Sizes, n_layers: int, seed: int, device) -> int:
    """A Gemma-2 HF checkpoint at sz's widths and n_layers layers in `path`:
    config.json (gemma2_hf_config) and two safetensors shards (the
    embedding and the first half of the layers; the rest and the final
    norm). Weights are bf16 draws of N(0, 0.02^2) (HF's init std) from a
    torch generator seeded with `seed` on `device`; norm weights are HF's
    zeros. The tied embedding is the lm_head. Returns the shards' data
    bytes."""
    import torch

    H, I, D = sz.hidden, sz.inter, sz.head_dim
    cfg = gemma2_hf_config(sz, n_layers)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        def draw():
            w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * 0.02
            return w.to(torch.bfloat16).view(torch.int16).cpu().numpy().view(np.uint16)
        return ("BF16", shape, draw)

    zeros = ("BF16", (H,), np.zeros(H, np.uint16))
    shapes = {"self_attn.q_proj": (sz.heads * D, H), "self_attn.k_proj": (sz.kv_heads * D, H),
              "self_attn.v_proj": (sz.kv_heads * D, H), "self_attn.o_proj": (H, sz.heads * D),
              "mlp.gate_proj": (I, H), "mlp.up_proj": (I, H), "mlp.down_proj": (H, I)}
    norms = ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
             "post_feedforward_layernorm")
    shards = ({"model.embed_tokens.weight": normal(sz.vocab, H)}, {})
    for i in range(n_layers):
        shard = shards[0 if i < n_layers // 2 else 1]
        for name, shape in shapes.items():
            shard[f"model.layers.{i}.{name}.weight"] = normal(*shape)
        for name in norms:
            shard[f"model.layers.{i}.{name}.weight"] = zeros
    shards[1]["model.norm.weight"] = zeros
    return sum(write_safetensors(os.path.join(path, f"model-{k + 1:05d}-of-00002.safetensors"),
                                 shard) for k, shard in enumerate(shards))


# ------------------------------------------------------------- timing


class Clock:
    """Median kernel time: CUDA events around each run on the card, after a
    256 MB memset that flushes the 50 MB L2 (decode finds weights cold) and
    a ~0.3 ms device-side spin that keeps the card busy while the host
    enqueues the timed call, so host time never lands between the events."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device=device)

    def ms(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(25):
            self.flush.zero_()
            torch.cuda._sleep(500_000)  # clock cycles
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


# the row counts K1 and K2 are timed at: the decode kernel at 16 and 1, the
# rows instantiation at 64, 128 and 256
GEMV_ROWS = (16, 1, 64, 128, 256)
# the calls of K1 and K2 in one batch-16 decode forward of the 32-layer
# Mistral-7B Q4_K_M (rq8): K1 at q|k, o and gate|up in every layer and at
# down in the 16 layers use_more_bits leaves in Q4_K; K2 at v in every
# layer, at the other 16 downs and at the lm_head
DECODE_CALLS = {"q4k_q8_gemv": {"qk": 32, "o": 32, "gate|up": 32, "down": 16},
                "q8_0_q8_gemv": {"v": 32, "down rq8": 16, "lm_head": 1}}


def bound(bytes_moved: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernels_a_call(fn, calls: int = 8, tries: int = 6) -> float:
    """The kernels the card runs for one call of fn: kernel events of a
    torch.profiler trace of `calls` calls, over `calls`. A trace can drop
    events, and then counts fewer (2 of 8 calls' one kernel, 14 of 8 calls'
    two), or none at all in a long process; so traces are taken until two
    give the same count above 0, which is returned, and after `tries`
    traces that never agree the largest count is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if getattr(e.device_type, "name", "") == "CUDA" and e.self_device_time_total > 0)
        if n and n in seen:
            return n / calls
        seen.append(n)
    return max(seen) / calls


def gemv_decode_line(results: dict, per_call: dict) -> dict:
    """K1's and K2's times at B=16 summed over the calls of one batch-16
    decode forward (DECODE_CALLS), beside the sum of their bounds, and the
    kernels a call (per_call: shape -> kernels the card ran a call)."""
    out = {"phase": "gemv_decode", "forward_calls": 0, "forward_ms": 0.0,
           "forward_bound_ms": 0.0, "shapes": {}}
    for name, calls in DECODE_CALLS.items():
        for shape, n in calls.items():
            row = next(r for r in results[name] if r["shape"] == f"{shape} B=16")
            out["shapes"][f"{name} {shape}"] = {
                "calls": n, "ms": row["ms"], "bound_ms": row["bound_ms"],
                "library_ms": row["library_ms"], "kernels_a_call": per_call[shape]}
            out["forward_calls"] += n
            out["forward_ms"] += n * row["ms"]
            out["forward_bound_ms"] += n * row["bound_ms"]
    out["kernels_a_call"] = max(per_call.values())
    return out


# ------------------------------------------------------------- phase 3


def kernel_phase(sz: Sizes, device, clock: Clock) -> dict:
    """Parity and timing of K1, K2, K4, K9, K10, K5, K8 and K9b (both
    instantiations of each; K9b's decode one the whole Q5_K product), K3,
    K6, the dequant kernels, K6', K7, K11, K12 and K13 at the main paths'
    shapes."""
    import torch
    import torch.nn.functional as F

    from mistralrs_tpu_torch.ops import flash_attention as fa
    from mistralrs_tpu_torch.ops import quant_matmul as qm
    from mistralrs_tpu_torch.quant.gguf_linear import dequant_q4k_weights, dequant_q8_0_gs_weights
    from mistralrs_tpu_torch.quant.qlinear import Linear

    H, I, D = sz.hidden, sz.inter, sz.head_dim
    fdt = torch.bfloat16
    results: dict[str, list] = {k: [] for k in KERNEL_INFO}

    def inputs(group: str):
        """A generator of the group's own, seeded from its name, and rand on
        it: the rows timed for one group never move another group's inputs."""
        g = torch.Generator(device=device).manual_seed(zlib.crc32(group.encode()))

        def rand(*shape, lo=0.0, hi=1.0, dtype=torch.float32):
            return (torch.rand(shape, device=device, generator=g) * (hi - lo) + lo).to(dtype)
        return g, rand

    def record(name, shape_name, err, rel, tol, ms, plain_ms, lib_ms, bnd, **extra):
        row = {"phase": "kernel", "name": name, "shape": shape_name, "max_abs_err": err,
               "max_rel_err": rel, "tol_rel": tol, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bnd[0], "bound_by": bnd[1], **extra}
        emit(row)
        if rel > tol:
            raise AssertionError(f"{name} {shape_name}: relative error {rel} > {tol}")
        results[name].append(row)

    per_call: dict[str, float] = {}  # decode shape -> kernels the card runs a call
    # K1: every Q4_K projection of a decode step (fused q|k, o, gate|up, down)
    gen, rand = inputs("q4k_q8")
    q4k_shapes = [("qk", H, (sz.heads + sz.kv_heads) * D), ("o", sz.heads * D, H),
                  ("gate|up", H, 2 * I), ("down", I, H)]
    for B in GEMV_ROWS:
        for nm, K, O in q4k_shapes:
            qs = torch.randint(0, 256, (K // 2, O), dtype=torch.uint8, device=device, generator=gen)
            scale = rand(K // 32, O, lo=0.001, hi=0.005, dtype=fdt)
            minv = rand(K // 32, O, lo=0.0, hi=0.002, dtype=fdt)
            x = (torch.randn(B, K, device=device, generator=gen)).to(fdt)
            got = qm.q4k_q8_gemv(x, qs, scale, minv, out_dtype=torch.float32)
            want = qm.q4k_q8_gemv_plain(x, qs, scale, minv, torch.float32)
            err = float((got - want).abs().max())
            rel = err / max(float(want.abs().max()), 1e-30)
            w = dequant_q4k_weights(Linear("gguf_q4k", (K, O), {"qs": qs, "scale": scale,
                                                                "minv": minv}), fdt).T.contiguous()
            ms = clock.ms(lambda: qm.q4k_q8_gemv(x, qs, scale, minv, out_dtype=fdt))
            plain = clock.ms(lambda: qm.q4k_q8_gemv_plain(x, qs, scale, minv, fdt))
            lib = clock.ms(lambda: torch.matmul(x, w))
            nbytes = B * K * 2 + (K // 2) * O + 2 * (K // 32) * O * 2 + B * O * 2
            # the same int8 codes and exact int dots on both sides; only the
            # f32 order of the scaled sums differs
            record("q4k_q8_gemv" if B <= 16 else "q4k_q8_gemv_rows", f"{nm} B={B}", err, rel,
                   1e-5, ms, plain, lib, bound(nbytes, 2 * B * K * O, PEAK_INT8))
            if B == 16:
                per_call[nm] = kernels_a_call(lambda: qm.q4k_q8_gemv(x, qs, scale, minv))
            if B == 16:
                # the prefill route's dequantization of the same weight: the
                # kernel rounds as the plain version's bf16 ops do (exact)
                want_w = qm.q4k_dequant_plain(qs, scale, minv, torch.bfloat16)
                got_w = qm.q4k_dequant(qs, scale, minv, torch.bfloat16)
                derr = float((got_w.float() - want_w.float()).abs().max())
                record("q4k_dequant", nm, derr, derr / float(want_w.float().abs().max()), 0.0,
                       clock.ms(lambda: qm.q4k_dequant(qs, scale, minv, torch.bfloat16)),
                       clock.ms(lambda: qm.q4k_dequant_plain(qs, scale, minv, torch.bfloat16)),
                       None, bound((K // 2) * O + 2 * (K // 32) * O * 2 + K * O * 2,
                                   2 * K * O, PEAK_BF16))
                del want_w, got_w
            del w

    # K2: attn_v and the use_more_bits ffn_down after rq8 (f32 scales, gs 32),
    # and the padded lm_head
    vocab_pad = -(-sz.vocab // 2048) * 2048
    q8_shapes = [("v", H, sz.kv_heads * D), ("down rq8", I, H), ("lm_head", H, vocab_pad)]
    gs = 32
    gen, rand = inputs("q8_0_q8")
    for B in GEMV_ROWS:
        for nm, K, O in q8_shapes:
            q = torch.randint(-127, 128, (K, O), dtype=torch.int8, device=device, generator=gen)
            s = rand(K // gs, O, lo=1e-4, hi=4e-4)
            x = (torch.randn(B, K, device=device, generator=gen)).to(fdt)
            got = qm.q8_0_q8_gemv(x, q, s, gs, out_dtype=torch.float32)
            want = qm.q8_0_q8_gemv_plain(x, q, s, gs, torch.float32)
            err = float((got - want).abs().max())
            rel = err / max(float(want.abs().max()), 1e-30)
            w = dequant_q8_0_gs_weights(Linear("gguf_q8_0", (K, O), {"q": q, "scale": s}, meta=gs),
                                        fdt).T.contiguous()
            ms = clock.ms(lambda: qm.q8_0_q8_gemv(x, q, s, gs, out_dtype=fdt))
            plain = clock.ms(lambda: qm.q8_0_q8_gemv_plain(x, q, s, gs, fdt))
            lib = clock.ms(lambda: torch.matmul(x, w))
            nbytes = B * K * 2 + K * O + (K // gs) * O * 4 + B * O * 2
            record("q8_0_q8_gemv" if B <= 16 else "q8_0_q8_gemv_rows", f"{nm} B={B}", err, rel,
                   1e-5, ms, plain, lib, bound(nbytes, 2 * B * K * O, PEAK_INT8))
            if B == 16:
                per_call[nm] = kernels_a_call(lambda: qm.q8_0_q8_gemv(x, q, s, gs))
            if B == 16:
                want_w = qm.q8_0_dequant_plain(q, s, gs, torch.bfloat16)
                got_w = qm.q8_0_dequant(q, s, gs, torch.bfloat16)
                derr = float((got_w.float() - want_w.float()).abs().max())
                record("q8_0_dequant", nm, derr, derr / float(want_w.float().abs().max()), 0.0,
                       clock.ms(lambda: qm.q8_0_dequant(q, s, gs, torch.bfloat16)),
                       clock.ms(lambda: qm.q8_0_dequant_plain(q, s, gs, torch.bfloat16)),
                       None, bound(K * O + (K // gs) * O * 4 + K * O * 2, K * O, PEAK_BF16))
                del want_w, got_w
            del w

    results["gemv_decode"] = gemv_decode_line(results, per_call)
    q56k_kernels(sz, device, clock, *inputs("q56k"), record)
    affine_kernels(sz, device, clock, *inputs("affine"), record)
    bf16_kernels(sz, device, clock, *inputs("bf16"), record)
    k5_kernels(sz, device, clock, *inputs("k5"), record)
    q5k_bf16_kernels(sz, device, clock, *inputs("q5k_bf16"), record)
    bf16_rows_kernels(sz, device, clock, inputs("k5_rows"), inputs("k8_rows"), record)

    # K6: first prefill chunks
    gen, _ = inputs("flash")
    for B, T, Hq, Hkv in sz.flash_cases:
        qf = torch.randn(B, T, Hq, D, device=device, generator=gen).to(fdt)
        kf = torch.randn(B, T, Hkv, D, device=device, generator=gen).to(fdt)
        vf = torch.randn(B, T, Hkv, D, device=device, generator=gen).to(fdt)
        scale = D ** -0.5
        got = fa.flash_prefill(qf, kf, vf, scale).float()
        want = fa.flash_prefill_plain(qf, kf, vf, scale).float()
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        rep = Hq // Hkv
        qt = qf.transpose(1, 2).contiguous()
        kt = kf.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
        vt = vf.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
        ms = clock.ms(lambda: fa.flash_prefill(qf, kf, vf, scale))
        plain = clock.ms(lambda: fa.flash_prefill_plain(qf, kf, vf, scale))
        lib = clock.ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                              scale=scale))
        nbytes = B * T * (2 * Hq + 2 * Hkv) * D * 2
        flops = B * Hq * 4 * D * T * (T + 1) / 2  # causal: q.k and p.v per kept pair
        # bf16 in and out on both sides (one rounding of the f32 result
        # each); the kernel also rounds P to bf16 for its P.V product
        record("flash_prefill", f"B={B} T={T}", err, rel, 1e-2, ms, plain, lib,
               bound(nbytes, flops, PEAK_BF16))

    paged_kernels(sz, device, clock, inputs("paged")[0], record)
    gemma2_kernels(device, clock, inputs("gemma2")[0], record)
    ragged_kernels(device, clock, inputs("ragged")[0], record)
    grouped_kernels(device, clock, inputs("grouped")[0], record)
    return results


# the row counts K9, K4 and K9b are timed at: K9's decode instantiation at
# 16, 4 and 1, the rows instantiation at 17, 64, 128 and 256 (K9b's high-bit
# kernel runs at those only: its decode instantiation, the whole Q5_K
# product, in q5k_bf16_kernels); K3 at its decode row counts, K4 at those
# and its rows ones
K9_ROWS = (16, 4, 1, 17, 64, 128, 256)
K9B_ROWS = (17, 64, 128, 256)
K3_ROWS = (16, 4, 1)
K4_ROWS = (16, 4, 1, 17, 64, 128, 256)


def q6k_kernels_a_call(name: str, most: int, B: int, fn) -> dict:
    """At 16 rows, the kernels the card runs for one call of a decode
    instantiation ({"kernels_a_call": n}; {} at other row counts); raises
    past `most` (K3: the quantize kernel and the GEMV; K4, K8, K10: the
    GEMV alone), which a split-K pass or a pre-pass would break."""
    if B != 16:
        return {}
    n = kernels_a_call(fn)
    if n > most:
        raise AssertionError(f"{name} B=16: {n} kernels a call, at most {most}")
    return {"kernels_a_call": n}


def q56k_kernels(sz: Sizes, device, clock: Clock, gen, rand, record) -> None:
    """Parity and timing of K3, K4 (both instantiations), K9 and the Q5_K /
    Q6_K dequant kernels at the shapes of the Q5_K_M path (random packed
    weights, bench.py's value ranges). library = torch.matmul on the
    dequantized bf16 weight.
    Each K3 row also times K2 on the same weight requantized to int8 per 32
    (rq8, the layout the Q4_K_M path serves Q6_K in). At 16 rows K3's, K4's
    and K9's rows carry the kernels the card runs a call (a torch.profiler
    trace): more than two for K3 and K9 or one for K4 (a split-K pass)
    raises."""
    import torch

    from mistralrs_tpu_torch.ops import quant_matmul as qm
    from mistralrs_tpu_torch.quant.gguf_linear import q6k_chunk_size, requant_q6k_to_q8
    from mistralrs_tpu_torch.quant.qlinear import Linear

    H, I, D = sz.hidden, sz.inter, sz.head_dim
    fdt = torch.bfloat16
    vocab_pad = -(-sz.vocab // 2048) * 2048

    def u8(*shape):
        return rand(*shape, lo=0.0, hi=256.0).to(torch.uint8)

    def compare(got, want):
        err = float((got.float() - want.float()).abs().max())
        return err, err / max(float(want.float().abs().max()), 1e-30)

    # Q6_K: attn_v, the use_more_bits ffn_down, the lm_head
    for nm, K, O in [("v", H, sz.kv_heads * D), ("down", I, H), ("lm_head", H, vocab_pad)]:
        G = q6k_chunk_size(K)
        ql, qh = u8(K // 2, O), u8(K // 4, O)
        scale = rand(K // 16, O, lo=0.001, hi=0.005, dtype=fdt)
        w_bytes = K // 2 * O + K // 4 * O + K // 16 * O * 2
        w = qm.q6k_dequant(ql, qh, scale, G, fdt)
        want_w = qm.q6k_dequant_plain(ql, qh, scale, G, fdt)
        err, rel = compare(w, want_w)
        del want_w
        # bit-equal: one f32 multiply rounded to bf16 on both sides
        record("q6k_dequant", nm, err, rel, 0.0, clock.ms(lambda: qm.q6k_dequant(ql, qh, scale, G, fdt)),
               clock.ms(lambda: qm.q6k_dequant_plain(ql, qh, scale, G, fdt)), None,
               bound(w_bytes + K * O * 2, K * O, PEAK_BF16))
        rq8 = requant_q6k_to_q8(Linear("gguf_q6k", (K, O), {"ql": ql, "qh": qh, "scale": scale},
                                       meta=G), gs=32)
        for B in K3_ROWS:
            x = torch.randn(B, K, device=device, generator=gen).to(fdt)
            err, rel = compare(qm.q6k_q8_gemv(x, ql, qh, scale, G, out_dtype=torch.float32),
                               qm.q6k_q8_gemv_plain(x, ql, qh, scale, G, torch.float32))
            nbytes = B * K * 2 + w_bytes + B * O * 2
            per_call = q6k_kernels_a_call(
                "q6k_q8_gemv", 2, B, lambda: qm.q6k_q8_gemv(x, ql, qh, scale, G, out_dtype=fdt))
            # the same int8 codes and exact per-16 int dots on both sides;
            # only the f32 order of the scaled sums differs
            record("q6k_q8_gemv", f"{nm} B={B}", err, rel, 1e-5,
                   clock.ms(lambda: qm.q6k_q8_gemv(x, ql, qh, scale, G, out_dtype=fdt)),
                   clock.ms(lambda: qm.q6k_q8_gemv_plain(x, ql, qh, scale, G, fdt)),
                   clock.ms(lambda: torch.matmul(x, w)), bound(nbytes, 2 * B * K * O, PEAK_INT8),
                   rq8_k2_ms=clock.ms(lambda: qm.q8_0_q8_gemv(x, rq8.data["q"], rq8.data["scale"],
                                                              32, out_dtype=fdt)),
                   **per_call)
        del rq8
        for B in K4_ROWS:
            x = torch.randn(B, K, device=device, generator=gen).to(fdt)
            err, rel = compare(qm.q6k_bf16_gemv(x, ql, qh, scale, G, out_dtype=torch.float32),
                               qm.q6k_bf16_gemv_plain(x, ql, qh, scale, G, torch.float32))
            nbytes = B * K * 2 + w_bytes + B * O * 2
            per_call = q6k_kernels_a_call(
                "q6k_bf16_gemv", 1, B, lambda: qm.q6k_bf16_gemv(x, ql, qh, scale, G, out_dtype=fdt))
            # the same bf16(q * s16) weights on both sides; f32 sums of bf16
            # products in another order
            record("q6k_bf16_gemv" if B <= 16 else "q6k_bf16_gemv_rows", f"{nm} B={B}", err, rel,
                   1e-4,
                   clock.ms(lambda: qm.q6k_bf16_gemv(x, ql, qh, scale, G, out_dtype=fdt)),
                   clock.ms(lambda: qm.q6k_bf16_gemv_plain(x, ql, qh, scale, G, fdt)),
                   clock.ms(lambda: torch.matmul(x, w)), bound(nbytes, 2 * B * K * O, PEAK_BF16),
                   **per_call)
        del w, ql, qh, scale

    # Q5_K: fused q|k, o, fused gate|up, the other ffn_down
    for nm, K, O in [("qk", H, (sz.heads + sz.kv_heads) * D), ("o", sz.heads * D, H),
                     ("gate|up", H, 2 * I), ("down", I, H)]:
        qs, qh = u8(K // 2, O), u8(K // 8, O)
        scale = rand(K // 32, O, lo=0.001, hi=0.005, dtype=fdt)
        minv = rand(K // 32, O, lo=0.0, hi=0.002, dtype=fdt)
        w_bytes = K // 2 * O + K // 8 * O + 2 * (K // 32) * O * 2
        w = qm.q5k_dequant(qs, qh, scale, minv, fdt)
        want_w = qm.q5k_dequant_plain(qs, qh, scale, minv, fdt)
        err, rel = compare(w, want_w)
        del want_w
        # bit-equal: the plain version's two bf16 roundings
        record("q5k_dequant", nm, err, rel, 0.0,
               clock.ms(lambda: qm.q5k_dequant(qs, qh, scale, minv, fdt)),
               clock.ms(lambda: qm.q5k_dequant_plain(qs, qh, scale, minv, fdt)), None,
               bound(w_bytes + K * O * 2, 2 * K * O, PEAK_BF16))
        for B in K9_ROWS:
            x = torch.randn(B, K, device=device, generator=gen).to(fdt)
            err, rel = compare(qm.q5k_q8_gemv(x, qs, qh, scale, minv, out_dtype=torch.float32),
                               qm.q5k_q8_gemv_plain(x, qs, qh, scale, minv, torch.float32))
            nbytes = B * K * 2 + w_bytes + B * O * 2
            per_call = q6k_kernels_a_call(
                "q5k_q8_gemv", 2, B, lambda: qm.q5k_q8_gemv(x, qs, qh, scale, minv, out_dtype=fdt))
            # exact int dots over the 5-bit codes on both sides
            record("q5k_q8_gemv" if B <= 16 else "q5k_q8_gemv_rows", f"{nm} B={B}", err, rel, 1e-5,
                   clock.ms(lambda: qm.q5k_q8_gemv(x, qs, qh, scale, minv, out_dtype=fdt)),
                   clock.ms(lambda: qm.q5k_q8_gemv_plain(x, qs, qh, scale, minv, fdt)),
                   clock.ms(lambda: torch.matmul(x, w)), bound(nbytes, 2 * B * K * O, PEAK_INT8),
                   **per_call)
        del w, qs, qh, scale, minv


def affine_kernels(sz: Sizes, device, clock: Clock, gen, rand, record) -> None:
    """Parity and timing of K10 and its dequant kernel: GGUF Q2_K (bits 2,
    group 16) at the Q2_K path's fused q|k and gate|up; GPTQ-8 (group 128,
    the rows of an act-order checkpoint sorted at load; x is gathered
    before the kernel) at down and gate|up; HQQ-1 and HQQ-2 (group 64) and
    GPTQ-4 at group 16 (which does not map onto Q4_K) at gate|up; each at
    1, 4 and 16 rows (the decode instantiation; at 16 rows with the kernels
    the card runs a call, which raises past one) and 64 and 256 (the rows
    instantiation, counted as affine_gemv_rows). Random codes, scale
    U[0.001, 0.005), zs = 1.5 * scale (Q2_K's minv) or 2^(bits-1) * scale
    (a mid-range zero point). library = torch.matmul on the dequantized
    bf16 weight."""
    import torch

    from mistralrs_tpu_torch.ops import quant_matmul as qm

    H, I, D = sz.hidden, sz.inter, sz.head_dim
    fdt = torch.bfloat16

    def compare(got, want):
        err = float((got.float() - want.float()).abs().max())
        return err, err / max(float(want.float().abs().max()), 1e-30)

    rows = (1, 4, 16, 64, 256)
    cases = [("q2k", 2, 16, "qk", H, (sz.heads + sz.kv_heads) * D),
             ("q2k", 2, 16, "gate|up", H, 2 * I),
             ("gptq8", 8, 128, "down", I, H), ("gptq8", 8, 128, "gate|up", H, 2 * I),
             ("hqq1", 1, 64, "gate|up", H, 2 * I), ("hqq2", 2, 64, "gate|up", H, 2 * I),
             ("gptq4", 4, 16, "gate|up", H, 2 * I)]
    for fmt, bits, group, nm, K, O in cases:
        q = rand(K * bits // 8, O, lo=0.0, hi=256.0).to(torch.uint8)
        scale = rand(K // group, O, lo=0.001, hi=0.005, dtype=fdt)
        zs = ((1.5 if fmt == "q2k" else 2 ** (bits - 1)) * scale.float()).to(fdt)
        w_bytes = K * bits // 8 * O + 2 * (K // group) * O * 2
        w = qm.affine_dequant(q, scale, zs, bits, group, fdt)
        if fmt == "q2k" and nm == "gate|up" or fmt == "gptq8" and nm == "down":
            want_w = qm.affine_dequant_plain(q, scale, zs, bits, group, fdt)
            err, rel = compare(w, want_w)
            del want_w
            # bit-equal: the plain version's two bf16 roundings
            record("affine_dequant", f"{nm} {fmt}", err, rel, 0.0,
                   clock.ms(lambda: qm.affine_dequant(q, scale, zs, bits, group, fdt)),
                   clock.ms(lambda: qm.affine_dequant_plain(q, scale, zs, bits, group, fdt)), None,
                   bound(w_bytes + K * O * 2, 2 * K * O, PEAK_BF16))
        for B in rows:
            x = torch.randn(B, K, device=device, generator=gen).to(fdt)
            err, rel = compare(qm.affine_gemv(x, q, scale, zs, bits, group, out_dtype=torch.float32),
                               qm.affine_gemv_plain(x, q, scale, zs, bits, group, torch.float32))
            nbytes = w_bytes + B * K * 2 + B * O * 2
            per_call = q6k_kernels_a_call(
                "affine_gemv", 1, B,
                lambda: qm.affine_gemv(x, q, scale, zs, bits, group, out_dtype=fdt))
            # the same bf16(q * scale) weights on both sides; f32 sums of
            # bf16 products in another order, the zs term over x in f32
            record("affine_gemv" if B <= 16 else "affine_gemv_rows", f"{nm} {fmt} B={B}", err,
                   rel, 1e-4,
                   clock.ms(lambda: qm.affine_gemv(x, q, scale, zs, bits, group, out_dtype=fdt)),
                   clock.ms(lambda: qm.affine_gemv_plain(x, q, scale, zs, bits, group, fdt)),
                   clock.ms(lambda: torch.matmul(x, w)), bound(nbytes, 2 * B * K * O, PEAK_BF16),
                   **per_call)
        del w, q, scale, zs


def bf16_kernels(sz: Sizes, device, clock: Clock, gen, rand, record) -> None:
    """Parity and timing of K8's decode instantiation and K9b's rows
    instantiation, GEMVs of int8_activations=False, at the shapes of the
    gguf_bf16 path (K5's and K9b's decode instantiations: k5_kernels,
    q5k_bf16_kernels): K9b's high-bit kernel at gate|up at 17, 64, 128 and
    256 rows, at q|k, o and down at 17, 64 and 256 (its K splits: one at
    gate|up, several at the others; `splits` on each row, and the phase
    raises unless both were compared); K8 on rq8 weights (f32 scales per 32) at v, q|k,
    gate|up, down and the lm_head (32768 columns), and on wire Q8_0 (bf16
    scales) at the lm_head, each at 1, 4 and 16 rows (at 16 with the
    kernels the card runs a call, which raises past one). Random codes,
    scale U[0.001, 0.005), minv U[0, 0.002) (int8: U[1e-4, 4e-4)). library
    = torch.matmul on the dequantized bf16 weight; int8_ms = the int8
    route's kernel (K1, K9, K2) on the same weight and x; K9b's rows also
    time the whole Q5_K bf16 route (K5, K9b and the add: route_ms)."""
    import torch

    from mistralrs_tpu_torch.ops import kernels
    from mistralrs_tpu_torch.ops import quant_matmul as qm
    from mistralrs_tpu_torch.quant.qlinear import Linear

    H, I, D = sz.hidden, sz.inter, sz.head_dim
    fdt = torch.bfloat16
    vocab_pad = -(-sz.vocab // 2048) * 2048

    def compare(got, want):
        err = float((got.float() - want.float()).abs().max())
        return err, err / max(float(want.float().abs().max()), 1e-30)

    sms = kernels.sm_count(device)
    # (shape, K, O, K9b's rows)
    shapes = [("gate|up", H, 2 * I, K9B_ROWS),
              ("qk", H, (sz.heads + sz.kv_heads) * D, (17, 64, 256)),
              ("o", sz.heads * D, H, (17, 64, 256)),
              ("down", I, H, (17, 64, 256))]
    splits = set()  # K splits of the rows instantiation compared
    for nm, K, O, k9b_rows in shapes:
        qs = rand(K // 2, O, lo=0.0, hi=256.0).to(torch.uint8)
        qh = rand(K // 8, O, lo=0.0, hi=256.0).to(torch.uint8)
        scale = rand(K // 32, O, lo=0.001, hi=0.005, dtype=fdt)
        minv = rand(K // 32, O, lo=0.0, hi=0.002, dtype=fdt)
        wh = qm.affine_dequant(qh, scale, torch.zeros_like(scale), 1, 32, fdt)
        q5 = Linear("gguf_q5k", (K, O), {"qs": qs, "qh": qh, "scale": scale, "minv": minv},
                    int8_act=False)
        for B in k9b_rows:
            x = torch.randn(B, K, device=device, generator=gen).to(fdt)
            # the same bf16(scale) * bit weights on both sides (exact)
            err, rel = compare(qm.q5k_hbit_bf16_gemv(x, qh, scale, out_dtype=torch.float32),
                               qm.q5k_hbit_bf16_gemv_plain(x, qh, scale, torch.float32))
            ks = qm.q5k_hbit_bf16_plan(B, K, O, sms).ksplit
            splits.add(ks)
            record("q5k_hbit_bf16_gemv_rows", f"{nm} B={B}", err, rel, 1e-4,
                   clock.ms(lambda: qm.q5k_hbit_bf16_gemv(x, qh, scale, out_dtype=fdt)),
                   clock.ms(lambda: qm.q5k_hbit_bf16_gemv_plain(x, qh, scale, fdt)),
                   clock.ms(lambda: torch.matmul(x, wh)),
                   bound(B * K * 2 + K // 8 * O + (K // 32) * O * 2 + B * O * 2,
                         2 * B * K * O, PEAK_BF16),
                   splits=ks, route_ms=clock.ms(lambda: qm.q5k_matmul(q5, x)),
                   int8_ms=clock.ms(lambda: qm.q5k_q8_gemv(x, qs, qh, scale, minv,
                                                           out_dtype=fdt)))
        del qs, qh, scale, minv, wh, q5
    if not (1 in splits and max(splits) > 1):
        raise AssertionError(f"q5k_hbit_bf16_gemv_rows: compared at K splits {sorted(splits)}, "
                             "not at one and at several")

    # (shape, K, O, scale dtype): rq8's f32 scales, wire Q8_0's bf16
    q8_shapes = [("v", H, sz.kv_heads * D, torch.float32),
                 ("qk", H, (sz.heads + sz.kv_heads) * D, torch.float32),
                 ("gate|up", H, 2 * I, torch.float32),
                 ("down", I, H, torch.float32),
                 ("lm_head", H, vocab_pad, torch.float32),
                 ("lm_head wire", H, vocab_pad, fdt)]
    for nm, K, O, sdt in q8_shapes:
        q = rand(K, O, lo=-127.0, hi=128.0).floor().to(torch.int8)
        s = rand(K // 32, O, lo=1e-4, hi=4e-4, dtype=sdt)
        w8 = qm.q8_0_dequant(q, s, 32, fdt)
        for B in (1, 4, 16):
            x = torch.randn(B, K, device=device, generator=gen).to(fdt)
            # the same bf16(q * bf16(s)) weights on both sides
            err, rel = compare(qm.q8_0_bf16_gemv(x, q, s, out_dtype=torch.float32),
                               qm.q8_0_bf16_gemv_plain(x, q, s, torch.float32))
            per_call = q6k_kernels_a_call("q8_0_bf16_gemv", 1, B,
                                          lambda: qm.q8_0_bf16_gemv(x, q, s, out_dtype=fdt))
            record("q8_0_bf16_gemv", f"{nm} B={B}", err, rel, 1e-4,
                   clock.ms(lambda: qm.q8_0_bf16_gemv(x, q, s, out_dtype=fdt)),
                   clock.ms(lambda: qm.q8_0_bf16_gemv_plain(x, q, s, fdt)),
                   clock.ms(lambda: torch.matmul(x, w8)),
                   bound(B * K * 2 + K * O + (K // 32) * O * s.element_size() + B * O * 2,
                         2 * B * K * O, PEAK_BF16),
                   int8_ms=clock.ms(lambda: qm.q8_0_q8_gemv(x, q, s, 32, out_dtype=fdt)),
                   **per_call)
        del q, s, w8


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at |v| (2^(floor(log2 |v|) - 7))."""
    return 2.0 ** (np.floor(np.log2(abs(v))) - 7)


def q5k_bf16_kernels(sz: Sizes, device, clock: Clock, gen, rand, record) -> None:
    """Parity and timing of K9b's decode instantiation (q5k_bf16_gemv: the
    whole Q5_K x bf16 product at 1-16 rows, one launch a call) at every
    Q5_K projection of the gguf_bf16 path (q|k, o, gate|up, down) at 1, 4
    and 16 rows: the f32 out within 1e-5 of max |y| of the plain version's
    (the same bf16 x, exact nibbles and bits; f32 sums in another order)
    and the bf16 out (JAX's roundings, bf16(bf16(y4) + 16 * bf16(yh))) within
    one bf16 ulp of max |y| (`bf16_err` in ulps); at every row count the
    kernels the card runs for one call of the dispatcher (q5k_matmul with
    int8_act off), which raises unless it is one. Random codes, scale
    U[0.001, 0.005), minv U[0, 0.002). library = torch.matmul on the
    dequantized bf16 Q5_K weight; int8_ms = K9 on the same weight and x;
    route_ms = the dispatcher's call."""
    import torch

    from mistralrs_tpu_torch.ops import quant_matmul as qm
    from mistralrs_tpu_torch.quant.qlinear import Linear

    H, I, D = sz.hidden, sz.inter, sz.head_dim
    fdt = torch.bfloat16
    for nm, K, O in [("qk", H, (sz.heads + sz.kv_heads) * D), ("o", sz.heads * D, H),
                     ("gate|up", H, 2 * I), ("down", I, H)]:
        qs = rand(K // 2, O, lo=0.0, hi=256.0).to(torch.uint8)
        qh = rand(K // 8, O, lo=0.0, hi=256.0).to(torch.uint8)
        scale = rand(K // 32, O, lo=0.001, hi=0.005, dtype=fdt)
        minv = rand(K // 32, O, lo=0.0, hi=0.002, dtype=fdt)
        w5 = qm.q5k_dequant(qs, qh, scale, minv, fdt)
        q5 = Linear("gguf_q5k", (K, O), {"qs": qs, "qh": qh, "scale": scale, "minv": minv},
                    int8_act=False)
        w_bytes = K // 2 * O + K // 8 * O + 2 * (K // 32) * O * 2
        for B in (1, 4, 16):
            x = torch.randn(B, K, device=device, generator=gen).to(fdt)
            got = qm.q5k_bf16_gemv(x, qs, qh, scale, minv, out_dtype=torch.float32)
            want = qm.q5k_bf16_gemv_plain(x, qs, qh, scale, minv, torch.float32)
            err = float((got - want).abs().max())
            top = max(float(want.abs().max()), 1e-30)
            got16 = qm.q5k_bf16_gemv(x, qs, qh, scale, minv, out_dtype=fdt).float()
            want16 = qm.q5k_bf16_gemv_plain(x, qs, qh, scale, minv, fdt).float()
            ulps = float((got16 - want16).abs().max()) / bf16_ulp(top)
            if ulps > 1.0:
                raise AssertionError(f"q5k_bf16_gemv {nm} B={B}: bf16 out {ulps} ulps of max |y|")
            n = kernels_a_call(lambda: qm.q5k_matmul(q5, x))
            if n != 1:
                raise AssertionError(f"q5k_matmul {nm} B={B}: {n} kernels a call, not one")
            record("q5k_bf16_gemv", f"{nm} B={B}", err, err / top, 1e-5,
                   clock.ms(lambda: qm.q5k_bf16_gemv(x, qs, qh, scale, minv, out_dtype=fdt)),
                   clock.ms(lambda: qm.q5k_bf16_gemv_plain(x, qs, qh, scale, minv, fdt)),
                   clock.ms(lambda: torch.matmul(x, w5)),
                   bound(B * K * 2 + w_bytes + B * O * 2, 2 * B * K * O, PEAK_BF16),
                   bf16_err=ulps, kernels_a_call=n,
                   route_ms=clock.ms(lambda: qm.q5k_matmul(q5, x)),
                   int8_ms=clock.ms(lambda: qm.q5k_q8_gemv(x, qs, qh, scale, minv,
                                                           out_dtype=fdt)))
        del qs, qh, scale, minv, w5, q5


def k5_kernels(sz: Sizes, device, clock: Clock, gen, rand, record) -> None:
    """Parity and timing of K5's decode instantiation (q4k_bf16_gemv at 1-16
    rows: plane_dec_kernel with Q4kFmt, one launch a call) at every Q5_K /
    Q4_K projection of the gguf_bf16 path (q|k, o, gate|up, down), at 1, 4
    and 16 rows, at 16 with the kernels the card runs a call (more than
    one, a sums kernel or a split-K pass, raises). Random codes, scale
    U[0.001, 0.005), minv U[0, 0.002). library = torch.matmul on the
    dequantized bf16 weight; int8_ms = K1 on the same weight and x."""
    import torch

    from mistralrs_tpu_torch.ops import quant_matmul as qm

    H, I, D = sz.hidden, sz.inter, sz.head_dim
    fdt = torch.bfloat16
    for nm, K, O in [("qk", H, (sz.heads + sz.kv_heads) * D), ("o", sz.heads * D, H),
                     ("gate|up", H, 2 * I), ("down", I, H)]:
        qs = rand(K // 2, O, lo=0.0, hi=256.0).to(torch.uint8)
        scale = rand(K // 32, O, lo=0.001, hi=0.005, dtype=fdt)
        minv = rand(K // 32, O, lo=0.0, hi=0.002, dtype=fdt)
        w4 = qm.q4k_dequant(qs, scale, minv, fdt)
        for B in (1, 4, 16):
            x = torch.randn(B, K, device=device, generator=gen).to(fdt)
            got = qm.q4k_bf16_gemv(x, qs, scale, minv, out_dtype=torch.float32)
            want = qm.q4k_bf16_gemv_plain(x, qs, scale, minv, torch.float32)
            err = float((got - want).abs().max())
            per_call = q6k_kernels_a_call("q4k_bf16_gemv", 1, B,
                                          lambda: qm.q4k_bf16_gemv(x, qs, scale, minv))
            # the same bf16 x and exact nibbles on both sides; f32 sums of
            # bf16 products in another order, the scale on each sub-block's sum
            record("q4k_bf16_gemv", f"{nm} B={B}", err, err / max(float(want.abs().max()), 1e-30),
                   1e-4, clock.ms(lambda: qm.q4k_bf16_gemv(x, qs, scale, minv, out_dtype=fdt)),
                   clock.ms(lambda: qm.q4k_bf16_gemv_plain(x, qs, scale, minv, fdt)),
                   clock.ms(lambda: torch.matmul(x, w4)),
                   bound(B * K * 2 + K // 2 * O + 2 * (K // 32) * O * 2 + B * O * 2,
                         2 * B * K * O, PEAK_BF16),
                   int8_ms=clock.ms(lambda: qm.q4k_q8_gemv(x, qs, scale, minv, out_dtype=fdt)),
                   **per_call)
        del qs, scale, minv, w4


# the row counts K5's and K8's rows instantiations are compared and timed at
BF16_ROWS_B = (17, 64, 256)


def bf16_rows_kernels(sz: Sizes, device, clock: Clock, k5_inputs, k8_inputs, record) -> None:
    """Parity and timing of K5's and K8's rows instantiations, each on a
    generator of its own (k5_inputs, k8_inputs: (gen, rand)): K5 at the
    Q4_K / Q5_K projections (gate|up, q|k, o, down) at 17, 64 and 256
    rows; K8 on rq8 weights (f32 scales) at v, the use_more_bits down and
    the lm_head at 17, 64 and 256 rows, and on wire Q8_0 (bf16 scales) at
    the lm_head at 64. `splits` on each row; the phase raises unless each
    kernel was compared at one K split and at several. Value ranges, library
    and int8_ms as bf16_kernels'; bound = 2*B*K*O bf16 operations (the
    function's: K5's rows kernel does twice that on the tensor cores, its
    weight's hi and lo parts)."""
    import torch

    from mistralrs_tpu_torch.ops import kernels
    from mistralrs_tpu_torch.ops import quant_matmul as qm

    H, I, D = sz.hidden, sz.inter, sz.head_dim
    fdt = torch.bfloat16
    vocab_pad = -(-sz.vocab // 2048) * 2048
    sms = kernels.sm_count(device)

    def compare(got, want):
        err = float((got.float() - want.float()).abs().max())
        return err, err / max(float(want.float().abs().max()), 1e-30)

    def check_splits(name, splits):
        if not (1 in splits and max(splits) > 1):
            raise AssertionError(f"{name}: compared at K splits {sorted(splits)}, "
                                 "not at one and at several")

    gen, rand = k5_inputs
    splits = set()
    for nm, K, O in [("gate|up", H, 2 * I), ("qk", H, (sz.heads + sz.kv_heads) * D),
                     ("o", sz.heads * D, H), ("down", I, H)]:
        qs = rand(K // 2, O, lo=0.0, hi=256.0).to(torch.uint8)
        scale = rand(K // 32, O, lo=0.001, hi=0.005, dtype=fdt)
        minv = rand(K // 32, O, lo=0.0, hi=0.002, dtype=fdt)
        w4 = qm.q4k_dequant(qs, scale, minv, fdt)
        for B in BF16_ROWS_B:
            x = torch.randn(B, K, device=device, generator=gen).to(fdt)
            ks = qm.q4k_bf16_plan(B, K, O, sms).ksplit
            splits.add(ks)
            # the same bf16 x, exact nibbles and exact q * s on both sides;
            # f32 sums of exact products in another order
            err, rel = compare(qm.q4k_bf16_gemv(x, qs, scale, minv, out_dtype=torch.float32),
                               qm.q4k_bf16_gemv_plain(x, qs, scale, minv, torch.float32))
            record("q4k_bf16_gemv_rows", f"{nm} B={B}", err, rel, 1e-4,
                   clock.ms(lambda: qm.q4k_bf16_gemv(x, qs, scale, minv, out_dtype=fdt)),
                   clock.ms(lambda: qm.q4k_bf16_gemv_plain(x, qs, scale, minv, fdt)),
                   clock.ms(lambda: torch.matmul(x, w4)),
                   bound(B * K * 2 + K // 2 * O + 2 * (K // 32) * O * 2 + B * O * 2,
                         2 * B * K * O, PEAK_BF16),
                   splits=ks,
                   int8_ms=clock.ms(lambda: qm.q4k_q8_gemv(x, qs, scale, minv, out_dtype=fdt)))
        del qs, scale, minv, w4
    check_splits("q4k_bf16_gemv_rows", splits)

    gen, rand = k8_inputs
    splits = set()
    for nm, K, O, rows, sdt in [("v", H, sz.kv_heads * D, BF16_ROWS_B, torch.float32),
                                ("down", I, H, BF16_ROWS_B, torch.float32),
                                ("lm_head", H, vocab_pad, BF16_ROWS_B, torch.float32),
                                ("lm_head wire", H, vocab_pad, (64,), fdt)]:
        q = rand(K, O, lo=-127.0, hi=128.0).floor().to(torch.int8)
        s = rand(K // 32, O, lo=1e-4, hi=4e-4, dtype=sdt)
        w8 = qm.q8_0_dequant(q, s, 32, fdt)
        for B in rows:
            x = torch.randn(B, K, device=device, generator=gen).to(fdt)
            ks = qm.q8_0_bf16_plan(B, K, O, sdt == torch.float32, sms).ksplit
            splits.add(ks)
            # the same bf16(q * bf16(s)) weights on both sides
            err, rel = compare(qm.q8_0_bf16_gemv(x, q, s, out_dtype=torch.float32),
                               qm.q8_0_bf16_gemv_plain(x, q, s, torch.float32))
            record("q8_0_bf16_gemv_rows", f"{nm} B={B}", err, rel, 1e-4,
                   clock.ms(lambda: qm.q8_0_bf16_gemv(x, q, s, out_dtype=fdt)),
                   clock.ms(lambda: qm.q8_0_bf16_gemv_plain(x, q, s, fdt)),
                   clock.ms(lambda: torch.matmul(x, w8)),
                   bound(B * K * 2 + K * O + (K // 32) * O * s.element_size() + B * O * 2,
                         2 * B * K * O, PEAK_BF16),
                   splits=ks,
                   int8_ms=clock.ms(lambda: qm.q8_0_q8_gemv(x, q, s, 32, out_dtype=fdt)))
        del q, s, w8
    check_splits("q8_0_bf16_gemv_rows", splits)


def paged_inputs(sz: Sizes, device, gen, B: int, T: int, kv_len: int, head_major: bool):
    """q [B, T, Hq, D] and one layer's K/V pools of random bf16, every row's
    context kv_len long on shuffled pages (page 0 unused), the block table
    as wide as the pipeline makes it (a power of two of pages), and the
    step's meta."""
    import torch

    from mistralrs_tpu_torch.ops.paged_attention import PagedAttnMeta

    page, fdt = 16, torch.bfloat16
    MP = 4
    while MP * page < kv_len:
        MP *= 2
    P = 1 + B * MP
    H, D = sz.kv_heads, sz.head_dim
    shape = (H, P, page, D) if head_major else (P, page, H, D)
    k = torch.randn(shape, device=device, generator=gen).to(fdt)
    v = torch.randn(shape, device=device, generator=gen).to(fdt)
    perm = torch.randperm(P - 1, device=device, generator=gen)
    tables = (1 + perm).reshape(B, MP)
    q = torch.randn(B, T, sz.heads, D, device=device, generator=gen).to(fdt)
    zeros = torch.zeros(B, T, dtype=torch.int64, device=device)
    meta = PagedAttnMeta(positions=zeros, slot_mapping=zeros, block_tables=tables,
                         kv_lens=torch.full((B,), kv_len, dtype=torch.int64, device=device),
                         active=torch.ones(B, device=device), head_major=head_major)
    return q, k, v, meta


def paged_kernels(sz: Sizes, device, clock: Clock, gen, record) -> None:
    """Parity and timing of K6' and K7 at the long-context path's shapes.
    library = F.scaled_dot_product_attention with a boolean mask on the
    gathered context, repeated per query head; for K7 also the decoder's
    own gather route (gather_paged_kv + sdpa_head_major), which serves
    spans below 4096."""
    import torch
    import torch.nn.functional as F

    from mistralrs_tpu_torch.ops import paged_attention as pa
    from mistralrs_tpu_torch.ops.attention import NEG_INF, sdpa_head_major

    Hq, H, D = sz.heads, sz.kv_heads, sz.head_dim
    rep = Hq // H
    scale = D ** -0.5

    def library_inputs(q, k, v, meta):
        """[B, Hq, T|S, D] query and repeated context, and the [B, 1, T, S]
        boolean mask (causal and length) of the same function."""
        B, T = q.shape[:2]
        kc, vc = pa.gather_paged_kv(k, v, meta.block_tables, head_major=meta.head_major)
        if meta.head_major:  # [H, B, S, D]
            kc, vc = kc.transpose(0, 1), vc.transpose(0, 1)
        else:  # [B, S, H, D]
            kc, vc = kc.transpose(1, 2), vc.transpose(1, 2)
        S = kc.shape[2]
        kr = kc.repeat_interleave(rep, dim=1).contiguous()
        vr = vc.repeat_interleave(rep, dim=1).contiguous()
        q_ids = torch.arange(T, device=device)[None, :] + (meta.kv_lens - T)[:, None]
        kv_ids = torch.arange(S, device=device)
        keep = (kv_ids[None, None, :] <= q_ids[:, :, None]) & \
            (kv_ids[None, None, :] < meta.kv_lens[:, None, None])
        return q.transpose(1, 2).contiguous(), kr, vr, keep[:, None]

    def compare(got, want):
        err = float((got.float() - want.float()).abs().max())
        return err, err / max(float(want.float().abs().max()), 1e-30)

    for B, T, kv_len, hm in sz.paged_prefill_cases:
        q, k, v, meta = paged_inputs(sz, device, gen, B, T, kv_len, hm)
        err, rel = compare(pa.flash_prefill_continuation(q, k, v, meta, scale=scale),
                           pa.flash_prefill_continuation_plain(q, k, v, meta, scale=scale))
        ms = clock.ms(lambda: pa.flash_prefill_continuation(q, k, v, meta, scale=scale))
        plain = clock.ms(lambda: pa.flash_prefill_continuation_plain(q, k, v, meta, scale=scale))
        qt, kr, vr, keep = library_inputs(q, k, v, meta)
        lib = clock.ms(lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=keep,
                                                              scale=scale))
        del qt, kr, vr, keep
        # q and out once, each row's kv_len keys and values once; query i
        # sees kv_len - T + i + 1 keys, q.k and p.v 2 * D flops each
        nbytes = 2 * B * T * Hq * D * 2 + B * kv_len * H * D * 2 * 2
        keys = T * (kv_len - T) + T * (T + 1) // 2
        # bf16 in and out on both sides; the kernel rounds P to bf16 (as K6)
        record("flash_prefill_paged", f"B={B} T={T} kv={kv_len} "
               f"{'head_major' if hm else 'token_major'}", err, rel, 1e-2, ms, plain, lib,
               bound(nbytes, B * 4 * Hq * D * keys, PEAK_BF16))
        del q, k, v, meta

    for B, kv_len in sz.paged_decode_cases:
        q, k, v, meta = paged_inputs(sz, device, gen, B, 1, kv_len, True)
        err, rel = compare(pa.paged_decode_attention(q, k, v, meta, scale=scale),
                           pa.paged_decode_attention_plain(q, k, v, meta, scale=scale))
        ms = clock.ms(lambda: pa.paged_decode_attention(q, k, v, meta, scale=scale))
        plain = clock.ms(lambda: pa.paged_decode_attention_plain(q, k, v, meta, scale=scale))
        S = meta.block_tables.shape[1] * 16
        bias = torch.where(torch.arange(S, device=device)[None] < meta.kv_lens[:, None], 0.0,
                           NEG_INF)[:, None, None, :]

        def gather_route():
            kc, vc = pa.gather_paged_kv(k, v, meta.block_tables, head_major=True)
            return sdpa_head_major(q, kc, vc, scale=scale, mask=bias)

        gather_ms = clock.ms(gather_route)
        qt, kr, vr, keep = library_inputs(q, k, v, meta)
        lib = clock.ms(lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=keep,
                                                              scale=scale))
        del qt, kr, vr, keep
        nbytes = B * kv_len * H * D * 2 * 2 + 2 * B * Hq * D * 2
        record("paged_decode", f"B={B} kv={kv_len} head_major", err, rel, 1e-2, ms, plain, lib,
               bound(nbytes, B * 4 * Hq * D * kv_len, PEAK_BF16), gather_route_ms=gather_ms)
        del q, k, v, meta


def kept_pairs(T: int, window: int | None) -> int:
    """(query, key) pairs a causal first chunk of T keeps, with a window w
    keeping keys t - (w - 1) .. t."""
    if window is None or window >= T:
        return T * (T + 1) // 2
    return window * (window + 1) // 2 + (T - window) * window


def gemma2_kernels(device, clock: Clock, gen, record) -> None:
    """Parity and timing of K11 at SPLASH_CASES and of K7 at Gemma-2-9B's
    widths with the soft cap 50 (GEMMA2_DECODE_CASES). q is drawn 8 times
    wider than k and v (4 times for K7), so that the scaled logits reach the
    cap's bend. library = F.scaled_dot_product_attention with the same
    boolean mask where there is no cap; with a cap no PyTorch call computes
    the function (None). For K7 also the decoder's own gather route with
    the cap (gather_paged_kv + sdpa_head_major), which serves spans below
    4096."""
    import torch
    import torch.nn.functional as F

    from mistralrs_tpu_torch.ops import paged_attention as pa
    from mistralrs_tpu_torch.ops import splash as sp
    from mistralrs_tpu_torch.ops.attention import NEG_INF, sdpa_head_major

    fdt = torch.bfloat16

    def compare(got, want):
        err = float((got.float() - want.float()).abs().max())
        return err, err / max(float(want.float().abs().max()), 1e-30)

    for shape, B, T, Hq, Hkv, D, window, cap in SPLASH_CASES:
        amp = 8.0 if cap else 1.0
        q = (torch.randn(B, T, Hq, D, device=device, generator=gen) * amp).to(fdt)
        k = torch.randn(B, T, Hkv, D, device=device, generator=gen).to(fdt)
        v = torch.randn(B, T, Hkv, D, device=device, generator=gen).to(fdt)
        scale = 256 ** -0.5 if D == 256 else D ** -0.5
        kw = dict(scale=scale, sliding_window=window, logits_softcap=cap)
        err, rel = compare(sp.splash_prefill(q, k, v, **kw), sp.splash_prefill_plain(q, k, v, **kw))
        ms = clock.ms(lambda: sp.splash_prefill(q, k, v, **kw))
        plain = clock.ms(lambda: sp.splash_prefill_plain(q, k, v, **kw))
        lib = None
        if cap is None:
            rep = Hq // Hkv
            t = torch.arange(T, device=device)
            keep = (t[None, :] <= t[:, None]) & (t[None, :] > t[:, None] - (window or T + 1))
            qt = q.transpose(1, 2).contiguous()
            kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
            vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
            lib = clock.ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep,
                                                                  scale=scale))
            del qt, kt, vt
        nbytes = B * T * (2 * Hq + 2 * Hkv) * D * 2
        # q.k and p.v, 2 * D flops each, per kept pair of every query head
        flops = 4 * B * Hq * D * kept_pairs(T, window)
        # as K6: bf16 in and out, P rounded to bf16 in the kernel; tanhf
        # against torch.tanh
        record("splash_prefill", shape, err, rel, 1e-2, ms, plain, lib,
               bound(nbytes, flops, PEAK_BF16))
        del q, k, v

    sz = GEMMA2
    Hq, H, D = sz.heads, sz.kv_heads, sz.head_dim
    scale, cap = 256 ** -0.5, 50.0
    for B, kv_len in GEMMA2_DECODE_CASES:
        q, k, v, meta = paged_inputs(sz, device, gen, B, 1, kv_len, True)
        q = (q.float() * 4).to(fdt)
        kw = dict(scale=scale, logits_softcap=cap)
        err, rel = compare(pa.paged_decode_attention(q, k, v, meta, **kw),
                           pa.paged_decode_attention_plain(q, k, v, meta, **kw))
        ms = clock.ms(lambda: pa.paged_decode_attention(q, k, v, meta, **kw))
        plain = clock.ms(lambda: pa.paged_decode_attention_plain(q, k, v, meta, **kw))
        S = meta.block_tables.shape[1] * 16
        bias = torch.where(torch.arange(S, device=device)[None] < meta.kv_lens[:, None], 0.0,
                           NEG_INF)[:, None, None, :]

        def gather_route():
            kc, vc = pa.gather_paged_kv(k, v, meta.block_tables, head_major=True)
            return sdpa_head_major(q, kc, vc, mask=bias, **kw)

        nbytes = B * kv_len * H * D * 2 * 2 + 2 * B * Hq * D * 2
        record("paged_decode", f"gemma2-9b B={B} kv={kv_len} head_major", err, rel, 1e-2, ms,
               plain, None, bound(nbytes, B * 4 * Hq * D * kv_len, PEAK_BF16),
               gather_route_ms=clock.ms(gather_route))
        del q, k, v, meta


# K12 cases (shape, live (q_len, kv_len) of each sequence, slots B, Hq, Hkv,
# D, window, soft cap): Mistral-7B decode at batch 16 and span 4096 (the
# headline, K7's headline shape); Gemma-2-9B decode at batch 16 and span
# 1024 (the gather route's shape in the gemma2 phase); the gemma2_ragged
# phase's decode of 4 live rows in 16 slots at ~4,664 tokens on a global
# layer and on a local one (window 4096); Mistral-7B's 4 x 512 continuation
# at 4096 (K6''s headline shape); Gemma-2-9B's 4 x 512 continuation at 4608
# with the window clipping; a mixed batch of a decode row, a first chunk and
# a ragged continuation in 4 slots
RAGGED_CASES = (
    ("mistral B=16 kv=4096 decode", ((1, 4096),) * 16, 16, 32, 8, 128, None, None),
    ("gemma2-9b B=16 kv=1024 decode", ((1, 1024),) * 16, 16, 16, 8, 256, None, 50.0),
    ("gemma2-9b 4/16 kv=4664 decode", ((1, 4664),) * 4, 16, 16, 8, 256, None, 50.0),
    ("gemma2-9b 4/16 kv=4664 decode w=4096", ((1, 4664),) * 4, 16, 16, 8, 256, 4096, 50.0),
    ("mistral 4x512 kv=4096", ((512, 4096),) * 4, 4, 32, 8, 128, None, None),
    ("gemma2-9b 4x512 kv=4608 w=4096", ((512, 4608),) * 4, 4, 16, 8, 256, 4096, 50.0),
    ("gemma2-9b mixed 3/4", ((1, 3000), (256, 256), (176, 1200)), 4, 16, 8, 256, 4096, 50.0),
)


def ragged_inputs(device, gen, seqs, B: int, Hq: int, Hkv: int, D: int, page: int = 16):
    """K12's arguments for live sequences `seqs` ((q_len, kv_len) each) in B
    slots (the rest padding: no queries, kv_len 1): packed bf16 queries
    [N, Hq, D], a combined pool of random bf16 with every sequence's context
    on shuffled pages (page 0 unused), block tables as wide as the pipeline
    makes them (a power of two of pages), and int32 kv_lens, cu_q_lens and
    num_seqs."""
    import torch

    W = 4
    while W * page < max(kv for _, kv in seqs):
        W *= 2
    P = 1 + B * W
    pool = torch.randn(P, page, 2 * Hkv, D, device=device, generator=gen).to(torch.bfloat16)
    tables = (1 + torch.randperm(P - 1, device=device, generator=gen)).reshape(B, W)
    q_lens = [ql for ql, _ in seqs] + [0] * (B - len(seqs))
    kv_lens = [kv for _, kv in seqs] + [1] * (B - len(seqs))
    q = torch.randn(sum(q_lens), Hq, D, device=device, generator=gen).to(torch.bfloat16)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    cu = np.concatenate([[0], np.cumsum(q_lens)]).tolist()
    return (q, pool, i32(kv_lens), tables.to(torch.int32), i32(cu), i32([len(seqs)]))


def ragged_work(seqs, window: int | None) -> tuple[int, int]:
    """(keys each sequence must read, summed; (query, key) pairs kept,
    summed) of K12 on sequences (q_len, kv_len): query j sits at kv_len -
    q_len + j and keeps the keys up to its own inside the window."""
    keys = pairs = 0
    for q_len, kv_len in seqs:
        first = kv_len - q_len
        keys += kv_len - (max(0, first - window + 1) if window else 0)
        pos = np.arange(first, kv_len)
        pairs += int(np.minimum(pos + 1, window or kv_len + 1).sum())
    return keys, pairs


def ragged_kernels(device, clock: Clock, gen, record) -> None:
    """Parity and timing of K12 at RAGGED_CASES against its plain version
    (per sequence, f32 scores). q is drawn 4 times wider than the pool
    where there is a cap, so that the scaled logits reach its bend. bound:
    each sequence's keys inside its window read once (K and V), q and out
    once, 4 * D flops per kept pair of every query head. library =
    F.scaled_dot_product_attention with a boolean mask (causal and length)
    on the gathered context, repeated per query head, where the rows are
    uniform and there is no cap; else compiled flex_attention
    (ragged_flex)."""
    import torch
    import torch.nn.functional as F

    from mistralrs_tpu_torch.ops import paged_attention as pa
    from mistralrs_tpu_torch.ops import ragged_attention as ra

    for shape, seqs, B, Hq, Hkv, D, window, cap in RAGGED_CASES:
        q, pool, kv_lens, tables, cu, num_seqs = ragged_inputs(device, gen, seqs, B, Hq, Hkv, D)
        if cap:
            q = (q.float() * 4).to(torch.bfloat16)
        max_q = max(ql for ql, _ in seqs) if len({ql for ql, _ in seqs}) == 1 else None
        scale = D ** -0.5
        kw = dict(scale=scale, sliding_window=window, logits_softcap=cap)
        args = (q, pool, kv_lens, tables, cu, num_seqs)
        got = ra.ragged_attention(*args, **kw, max_q_len=max_q).float()
        want = ra.ragged_attention_plain(*args, **kw).float()
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        ms = clock.ms(lambda: ra.ragged_attention(*args, **kw, max_q_len=max_q))
        plain = clock.ms(lambda: ra.ragged_attention_plain(*args, **kw))
        lib = None
        if cap is None and window is None and max_q is not None and len(seqs) == B:
            T, kv_len = seqs[0]
            kc, vc = pa.gather_paged_kv(*ra.split_combined(pool), tables)  # [B, S, Hkv, D]
            kr = kc.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1).contiguous()
            vr = vc.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1).contiguous()
            S = kr.shape[2]
            q_ids = torch.arange(T, device=device)[:, None] + (kv_len - T)
            kv_ids = torch.arange(S, device=device)[None, :]
            keep = ((kv_ids <= q_ids) & (kv_ids < kv_len))[None, None]
            qt = q.reshape(B, T, Hq, D).transpose(1, 2).contiguous()
            lib = clock.ms(lambda: F.scaled_dot_product_attention(qt, kr, vr, attn_mask=keep,
                                                                  scale=scale))
            del kc, vc, kr, vr, qt
            extra = {"library": "sdpa"}
        else:
            lib, lib_err = ragged_flex(clock, q, pool, tables, seqs, Hq, Hkv, D, scale, window,
                                       cap, want)
            extra = {"library": "flex_attention", "library_max_rel_err": lib_err}
        keys, pairs = ragged_work(seqs, window)
        nbytes = keys * Hkv * D * 2 * 2 + 2 * q.shape[0] * Hq * D * 2
        # as K6'/K7: bf16 in and out, P rounded to bf16 in the kernel, f32
        # sums in another order (the decode splits combined); tanhf against
        # torch.tanh
        record("ragged_attention", shape, err, rel, 1e-2, ms, plain, lib,
               bound(nbytes, 4 * Hq * D * pairs, PEAK_BF16), **extra)
        del q, pool, got, want


def ragged_flex(clock: Clock, q, pool, tables, seqs, Hq: int, Hkv: int, D: int, scale: float,
                window, cap, want) -> tuple[float, float]:
    """(ms, relative error against K12's plain version `want`) of compiled
    flex_attention computing K12's function on the same inputs in one call:
    the live sequences' contexts gathered from the pool ([n, Hkv, S, D],
    outside the timed call), the queries padded to the longest q_len, the
    soft cap as score_mod, each sequence's length, causality and window as
    mask_mod (a padding query keeps no key), GQA by enable_gqa."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    from mistralrs_tpu_torch.ops import paged_attention as pa
    from mistralrs_tpu_torch.ops import ragged_attention as ra

    n, dev = len(seqs), q.device
    kc, vc = pa.gather_paged_kv(*ra.split_combined(pool), tables[:n])  # [n, S, Hkv, D]
    k, v = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    S, Tq = k.shape[2], max(ql for ql, _ in seqs)
    qp = torch.zeros(n, Tq, Hq, D, dtype=q.dtype, device=dev)
    starts = np.concatenate([[0], np.cumsum([ql for ql, _ in seqs])])
    for i, (ql, _) in enumerate(seqs):
        qp[i, :ql] = q[starts[i]:starts[i] + ql]
    qp = qp.transpose(1, 2).contiguous()
    q_lens = torch.tensor([ql for ql, _ in seqs], device=dev)
    first = torch.tensor([kv - ql for ql, kv in seqs], device=dev)
    win = window or S + 1

    def mask_mod(b, h, qi, ki):
        pos = first[b] + qi
        return (qi < q_lens[b]) & (ki <= pos) & (ki > pos - win)

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    mask = create_block_mask(mask_mod, B=n, H=None, Q_LEN=Tq, KV_LEN=S, device=dev)
    flex = torch.compile(flex_attention, dynamic=False)

    def run():
        return flex(qp, k, v, score_mod=score_mod if cap else None, block_mask=mask, scale=scale,
                    enable_gqa=Hq != Hkv)

    out = run().transpose(1, 2)  # [n, Tq, Hq, D]
    got = torch.cat([out[i, :ql] for i, (ql, _) in enumerate(seqs)]).float()
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    ms = clock.ms(run)
    del kc, vc, k, v, qp, out, got
    return ms, err


# K13 cases (shape, K, N, tokens, all in one group): Mixtral-8x7B's gate (K
# 4096 -> N 14336; up has its shape) and down (K 14336 -> N 4096) at a decode
# step of 16 tokens (32 pairs; the headline), the 4 x 64-row and 4 x 256-row
# first chunks of the mixtral phase and 4 x 512 (M 512, 2,048 and 4,096),
# each token routed to 2 distinct random experts of 8; and 256 tokens' 512
# pairs all in one group
GROUPED_CASES = tuple(
    (f"{nm} M={2 * tokens} {tag}", K, N, tokens, False)
    for tokens, tag in ((16, "decode"), (256, "4x64"), (1024, "4x256"), (2048, "4x512"))
    for nm, K, N in (("gate", 4096, 14336), ("down", 14336, 4096))
) + (("gate M=512 one group", 4096, 14336, 256, True),)


def top2_group_sizes(gen, tokens: int, experts: int, device):
    """int32 [experts] group sizes of `tokens` tokens each routed to two
    distinct random experts."""
    import torch

    a = torch.randint(0, experts, (tokens,), device=device, generator=gen)
    b = (a + torch.randint(1, experts, (tokens,), device=device, generator=gen)) % experts
    return torch.bincount(torch.cat([a, b]), minlength=experts).to(torch.int32)


def grouped_library(clock: Clock, lhs, rhs, sizes, want) -> tuple:
    """(ms of torch._grouped_mm on the same operands, with the group ends as
    offsets, or None where this torch lacks it for them or it disagrees
    with the plain version `want`; ms of a torch.matmul per non-empty group
    on sizes read on the host)."""
    import torch

    ends = torch.cumsum(sizes, 0, dtype=torch.int32)
    bounds = [0] + ends.tolist()
    lib = None
    fn = getattr(torch, "_grouped_mm", None)
    # rhs as it is ([G, K, N], N contiguous), then a column-major copy
    for col_major in ((False, True) if fn else ()):
        b = rhs.transpose(1, 2).contiguous().transpose(1, 2) if col_major else rhs
        try:
            out = fn(lhs, b, offs=ends, out_dtype=torch.bfloat16).float()
        except (RuntimeError, TypeError, ValueError):  # not for this layout or card
            continue
        if float((out - want).abs().max()) <= 1e-2 * float(want.abs().max()):
            lib = clock.ms(lambda: fn(lhs, b, offs=ends, out_dtype=torch.bfloat16))
            break

    def loop():
        for g in range(len(bounds) - 1):
            if bounds[g + 1] > bounds[g]:
                torch.matmul(lhs[bounds[g]:bounds[g + 1]], rhs[g])

    return lib, clock.ms(loop)


def grouped_kernels(device, clock: Clock, gen, record) -> None:
    """Parity and timing of K13 at GROUPED_CASES against its plain version
    (a per-group f32 product, sizes read on the host), random bf16 lhs and
    weights N(0, 1/K). bound: every non-empty group's weights, lhs and out
    once; 2 M K N flops. library: torch._grouped_mm (grouped_library), and
    the per-group torch.matmul loop beside it. Each row names the plan's
    instantiation, column tile and stages."""
    import torch

    from mistralrs_tpu_torch.ops import grouped_gemm as gg
    from mistralrs_tpu_torch.ops import kernels

    E = MIXTRAL_EXPERTS
    weights = {}
    for shape, K, N, tokens, one_group in GROUPED_CASES:
        if (K, N) not in weights:
            weights[(K, N)] = torch.randn(E, K, N, device=device, generator=gen,
                                          dtype=torch.bfloat16).mul_(K ** -0.5)
        rhs = weights[(K, N)]
        M = 2 * tokens
        if one_group:
            sizes = torch.zeros(E, dtype=torch.int32, device=device)
            sizes[2] = M
        else:
            sizes = top2_group_sizes(gen, tokens, E, device)
        lhs = torch.randn(M, K, device=device, generator=gen, dtype=torch.bfloat16)
        got = gg.grouped_matmul(lhs, rhs, sizes).float()
        want = gg.grouped_matmul_ref(lhs, rhs, sizes).float()
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        lib, loop_ms = grouped_library(clock, lhs, rhs, sizes, want)
        nbytes = int((sizes > 0).sum()) * K * N * 2 + M * K * 2 + M * N * 2
        plan = gg.grouped_gemm_plan(M, K, N, E, kernels.sm_count(device))
        # bf16 out on both sides, rounded once from f32 sums in another order
        record("grouped_gemm", shape, err, rel, 1e-2,
               clock.ms(lambda: gg.grouped_matmul(lhs, rhs, sizes)),
               clock.ms(lambda: gg.grouped_matmul_ref(lhs, rhs, sizes)), lib,
               bound(nbytes, 2 * M * K * N, PEAK_BF16), group_sizes=sizes.tolist(),
               matmul_loop_ms=loop_ms, plan={"kind": plan.kind, "bn": plan.bn,
                                             "stages": plan.stages, "grid": plan.grid[0]})
        del lhs, got, want
    del weights


# ------------------------------------------------------------- phases 4, 5


def add_requests(eng, rng, vocab: int, n_req: int, plen: int, max_len: int,
                 sampling: dict | None = None) -> list:
    """n_req requests of random prompts of plen +- 8 tokens, greedy or with
    the SamplingParams fields in `sampling`."""
    from mistralrs_tpu_torch.engine.engine import GenerationRequest
    from mistralrs_tpu_torch.engine.sampler import SamplingParams

    out = []
    for _ in range(n_req):
        n = int(plen + rng.integers(-8, 9))
        out.append(eng.add_request(GenerationRequest(
            [int(t) for t in rng.integers(1, vocab, n)],
            SamplingParams(max_len=max_len, **(sampling or {})))))
    return out


def step_until(eng, groups: list, done, decode: dict) -> None:
    """Step the engine until done(); steps in which no request of `groups`
    prefills add their generated tokens and seconds to `decode`."""
    seqs = [s for g in groups for s in g.seqs]
    while not done():
        prefill = any(s.state.value in ("waiting", "running_prefill") for s in seqs)
        before = sum(s.num_generated for s in seqs)
        t = time.perf_counter()
        eng.step()
        dt = time.perf_counter() - t
        if not prefill:
            decode["tokens"] += sum(s.num_generated for s in seqs) - before
            decode["seconds"] += dt


def check_served(groups: list, vocab: int, max_len: int, pipe) -> int:
    """Every request generated max_len valid token ids and the last step's
    logits are finite; returns the number of generated tokens."""
    seqs = [s for g in groups for s in g.seqs]
    toks = [t for s in seqs for t in s.generated_tokens]
    if not all(0 <= t < vocab for t in toks):
        raise AssertionError("a generated token is outside the vocabulary")
    if any(s.num_generated != max_len or s.stop_reason.value != "length" for s in seqs):
        raise AssertionError("a request did not generate max_len tokens")
    if not np.isfinite(pipe.last_greedy_pack).all():
        raise AssertionError("non-finite logits")
    return len(toks)


def check_launched(counts: dict, names) -> None:
    for name in names:
        if counts[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")


def check_graphed(counts: dict, pipe) -> dict:
    """Every multistep decode call of a serving run was a graph replay: the
    replay counter moved and no call ran the eager loop. Returns the
    pipeline's graph figures for the phase's line."""
    if counts["decode_graph_replays"] < 1 or counts["decode_eager_loops"]:
        raise AssertionError(f"the decode loop did not run as graph replays: {counts}")
    return {"graphs": len(pipe.graphs.graphs), "capture_s": pipe.graphs.capture_s,
            "pool_mb": pipe.graphs.pool_bytes() / 2**20}


def ttft_ms(groups: list) -> float:
    return 1e3 * statistics.median(s.prompt_timestamp - s.timestamp for g in groups
                                   for s in g.seqs)


def _linears(part: dict, prefix: str = ""):
    """(name, Linear) of every Linear in a layer's attn or mlp dict, an MoE
    mlp's experts included ("experts.gate", ...)."""
    for name, node in part.items():
        if isinstance(node, dict):
            yield from _linears(node, f"{prefix}{name}.")
        else:
            yield prefix + name, node


def params_kinds(params) -> list[str]:
    """The Linear kinds of the projections and the lm_head (if it is not the
    tied embedding), sorted."""
    head = params.lm_head
    return sorted({lin.kind for lp in params.layers for part in ("attn", "mlp")
                   for _, lin in _linears(lp[part])}
                  | ({head.kind} if head is not None else set()))


def served_kinds(pipe) -> list[str]:
    return params_kinds(pipe.params)


def short_context_phase(sz: Sizes, device, phase: str, params_fn, rq8_group,
                        config_fn=model_config, **extra) -> dict:
    """The model at sz's depth with random weights from params_fn, served
    by serve_short_context. Returns the phase's line (with `extra` in it)."""
    import torch

    from mistralrs_tpu_torch.models.loader import make_rope

    fdt = torch.bfloat16
    cfg = config_fn(sz, sz.layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = params_fn(sz, sz.layers, device, gen, fdt)
    return serve_short_context(sz, device, phase, cfg, params, make_rope(cfg, 2048, device=device),
                               t0, rq8_group=rq8_group, **extra)


def serve_short_context(sz: Sizes, device, phase: str, cfg, params, rope, t0: float,
                        rq8_group, int8_activations: bool = True, after=None, **extra) -> dict:
    """The model served at max_model_len 2048 (token-major pools, buckets
    64/256): 4 greedy requests of ~200-token prompts (one 4 x 256 first
    chunk), then 4 of ~40 tokens (4 x 64 rows), max_len tokens each, after
    a warm-up with the same pattern. Returns the phase's line (with `extra`
    in it; setup_s counts from t0); the launch counts are set to 0 just
    before the measured run and read just after it. `after(pipe, serve)`,
    if given, runs after the measured run (serve(max_len, decode) serves
    the pattern once more) and returns more entries for the line."""
    import torch

    from mistralrs_tpu_torch.engine.engine import Engine
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    pc = PipelineConfig(page_size=16, num_pages=512, max_seqs=16, max_model_len=2048,
                        prefill_buckets=(64, 256), decode_steps=8, dtype=torch.bfloat16,
                        device=str(device), rq8_group=rq8_group,
                        int8_activations=int8_activations)
    pipe = TextPipeline(cfg, params, rope, pc)
    del params  # the pipeline holds the fused (and requantized) copy
    kinds = served_kinds(pipe)
    q6k_kinds = sorted({f"{part}.{name}" for lp in pipe.params.layers for part in ("attn", "mlp")
                        for name, lin in _linears(lp[part]) if lin.kind == "gguf_q6k"}
                       | ({"lm_head"} if getattr(pipe.params.lm_head, "kind", None) == "gguf_q6k"
                          else set()))
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    rng = np.random.default_rng(1)

    def serve(max_len: int, decode: dict) -> list:
        """4 long prompts, then 4 short ones once the long have prefilled."""
        groups = add_requests(eng, rng, sz.vocab, 4, sz.long_prompt, max_len)
        # first chunk of 4 x 256 rows -> flash prefill
        step_until(eng, groups, lambda: all(s.state.value not in ("waiting", "running_prefill")
                                            for g in groups for s in g.seqs), decode)
        # chunk of 4 x 64 rows -> gather + sdpa
        groups += add_requests(eng, rng, sz.vocab, 4, sz.short_prompt, max_len)
        step_until(eng, groups, lambda: all(g.all_done() for g in groups), decode)
        return groups

    # warm-up: the same pattern, so the run measures a warm server (first
    # use of a kernel or a GEMM shape costs up to ~0.2 s of host time, and
    # each block-table width's decode graphs are captured on first use)
    serve(sz.max_len, {"tokens": 0, "seconds": 0.0})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    reset_counts()
    decode = {"tokens": 0, "seconds": 0.0}
    t_run = time.perf_counter()
    groups = serve(sz.max_len, decode)
    run_s = time.perf_counter() - t_run
    counts = read_counts()
    n_toks = check_served(groups, sz.vocab, sz.max_len, pipe)
    graphs = check_graphed(counts, pipe)

    out = {"phase": phase, "layers": sz.layers, "kinds": kinds, "q6k_kinds": q6k_kinds,
           "rq8_group": rq8_group, "int8_activations": int8_activations, "requests": len(groups),
           "generated_tokens": n_toks, "decode_tok_s": decode["tokens"] / decode["seconds"],
           "decode_tokens": decode["tokens"], "decode_s": decode["seconds"],
           "p50_ttft_ms": ttft_ms(groups), "p50_ttft_ms_long": ttft_ms(groups[:4]),
           "p50_ttft_ms_short": ttft_ms(groups[4:]), "run_s": run_s, "setup_s": setup_s,
           "launches": counts, "decode_steps_per_call": pc.decode_steps, "max_seqs": pc.max_seqs,
           **graphs, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **extra}
    if after is not None:
        out.update(after(pipe, serve))
    emit(out)
    del eng, pipe
    return out


def slice_phase(sz: Sizes, device) -> dict:
    """Q4_K_M with Q6_K requantized to int8 per 32 (K1, K2, K6, the dequant
    kernels)."""
    out = short_context_phase(sz, device, "slice", random_q4km_params, 32)
    check_launched(out["launches"], PATH_KERNELS["slice"])
    return out


# the decode_graph phase's sampled calls (temperature, top-k, top-p,
# min-p) and its sampled wave's SamplingParams
HOT = (1.5, 40, 1.0, 0.0)
WAVE_SAMPLING = {"temperature": 0.8, "top_k": 40, "top_p": 0.95, "min_p": 0.05}
# calls of each kind the phase times (after a warm-up), in turns
GRAPH_TIMED_CALLS = 5


def decode_graph_phase(sz: Sizes, device) -> dict:
    """The slice's 32-layer Mistral-7B Q4_K_M (rq8) at 16 slots, 16
    sequences of ~200-token prompts prefilled in one 16 x 256 chunk, then
    multistep calls on the same inputs (each rewinds kv_len): the eager
    loop (run_decode_multi_eager) against the graph replay
    (run_decode_multi), greedy and sampled at one seed, tokens equal and
    packs bit-equal, the launch counts of a replay equal to an eager loop's;
    two seeds at temperature 1.5, top-k 40 give other tokens. Then wall ms
    a call, eager and graph in turns, and the device ms of a replay from
    CUDA events; then a greedy and a sampled wave of 16 requests (WAVE_SAMPLING)
    through Engine, with the graphs' count, capture seconds and pool size."""
    import torch

    from mistralrs_tpu_torch.engine.block_manager import BlockManager
    from mistralrs_tpu_torch.engine.engine import Engine
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.engine.sequence import Sequence
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    fdt = torch.bfloat16
    cfg = model_config(sz, sz.layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = random_q4km_params(sz, sz.layers, device, gen, fdt)
    pc = PipelineConfig(page_size=16, num_pages=512, max_seqs=16, max_model_len=2048,
                        prefill_buckets=(64, 256), decode_steps=8, dtype=fdt, device=str(device))
    pipe = TextPipeline(cfg, params, make_rope(cfg, 2048, device=device), pc)
    del params
    T, B = pc.decode_steps, pc.max_seqs
    rng = np.random.default_rng(11)
    bm = BlockManager(pc.num_pages, pc.page_size)
    seqs = []
    for _ in range(B):
        n = int(sz.long_prompt + rng.integers(-8, 9))
        seq = Sequence([int(t) for t in rng.integers(1, sz.vocab, n)],
                       SamplingParams(max_len=sz.max_len), max_model_len=pc.max_model_len)
        bm.allocate(seq)
        seqs.append(seq)
    pipe.run_prefill_chunks([(s, list(s.tokens)) for s in seqs])
    first = pipe.last_greedy_pack[0]
    for seq, tok in zip(seqs, first):
        seq.tokens.append(int(tok))
        bm.append_slot(seq, T)
    setup_s = time.perf_counter() - t0

    def call(fn, sampling=None):
        """One multistep call on the fixed inputs; returns (pack, wall ms)."""
        t = time.perf_counter()
        pack = fn(seqs, sampling)
        ms = 1e3 * (time.perf_counter() - t)
        for seq in seqs:
            seq.kv_len -= T
        return pack, ms

    hot = [[v] * B for v in HOT]
    out = {"phase": "decode_graph", "layers": sz.layers, "max_seqs": B, "decode_steps": T,
           "setup_s": setup_s}
    reset_counts()
    for kind, sampling, other in (("greedy", None, None), ("sampled", (*hot, 1234), (*hot, 4321))):
        eager, _ = call(pipe.run_decode_multi_eager, sampling)
        captures = read_counts()["decode_graph_captures"]
        graph, first_ms = call(pipe.run_decode_multi, sampling)  # captures the key's graph
        if read_counts()["decode_graph_captures"] != captures + 1:
            raise AssertionError(f"the first {kind} call did not capture a graph")
        before = read_counts()
        again, _ = call(pipe.run_decode_multi, sampling)
        replay = read_counts()
        call(pipe.run_decode_multi_eager, sampling)
        loop = read_counts()
        d_replay = {k: replay[k] - before[k] for k in COUNTERS}
        d_eager = {k: loop[k] - replay[k] for k in COUNTERS}
        if d_replay != d_eager or not any(d_replay.values()):
            raise AssertionError(f"a replay counted other launches than the eager loop: "
                                 f"{d_replay} vs {d_eager}")
        for name, pack in (("first call", graph), ("replay", again)):
            if not np.array_equal(pack[0], eager[0]):
                raise AssertionError(f"{kind} {name}: the graph's tokens differ from the eager "
                                     f"loop's")
            if not np.array_equal(pack, eager):
                raise AssertionError(f"{kind} {name}: the graph's pack is not bit-equal to the "
                                     f"eager loop's")
        if not np.isfinite(eager).all() or not ((eager[0] >= 0) & (eager[0] < sz.vocab)).all():
            raise AssertionError(f"{kind}: a non-finite pack or a token outside the vocabulary")
        line = {"tokens_equal": True, "pack_bit_equal": True, "capture_call_ms": first_ms,
                "replay_launches": sum(d_replay.values())}
        if other is not None:
            diff, _ = call(pipe.run_decode_multi, other)
            changed = int((diff[0] != eager[0]).sum())
            if not changed:
                raise AssertionError("two seeds at temperature 1.5, top-k 40 gave the same tokens")
            line["tokens_changed_by_another_seed"] = changed
        # wall ms a call, eager and graph in turns, after the calls above
        walls = {"eager": [], "graph": []}
        for _ in range(GRAPH_TIMED_CALLS):
            for name, fn in (("eager", pipe.run_decode_multi_eager),
                             ("graph", pipe.run_decode_multi)):
                walls[name].append(call(fn, sampling)[1])
        # device ms of a replay: CUDA events around it (the host filled the
        # buffers before the first event)
        key = pipe._fill_loop(seqs, sampling)
        events = []
        for _ in range(GRAPH_TIMED_CALLS):
            s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s_ev.record()
            pipe.graphs.replay(key, pipe._decode_loop)
            e_ev.record()
            events.append((s_ev, e_ev))
        torch.cuda.synchronize()
        dev_ms = statistics.median(s_ev.elapsed_time(e_ev) for s_ev, e_ev in events)
        for name, ms in walls.items():
            line[f"{name}_call_ms"] = statistics.median(ms)
            line[f"{name}_forward_ms"] = statistics.median(ms) / T
            line[f"{name}_call_ms_all"] = ms
        line["graph_device_call_ms"] = dev_ms
        line["graph_device_forward_ms"] = dev_ms / T
        out[kind] = line
    counts = read_counts()
    if counts["decode_eager_loops"] != 2 * (2 + GRAPH_TIMED_CALLS):
        raise AssertionError(f"eager loops ran outside the A/B: {counts}")

    # a greedy and a sampled wave through the engine, after a warm-up of both
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    sampled_calls = []
    run_multi = pipe.run_decode_multi

    def spy(seqs, sampling=None):
        sampled_calls.append(sampling is not None)
        return run_multi(seqs, sampling)

    pipe.run_decode_multi = spy
    waves = [(B, sz.long_prompt, sz.max_len)] * 2
    kinds = [None, WAVE_SAMPLING]
    serve_waves(eng, rng, sz.vocab, [(n, p, 1 + T) for n, p, _ in waves], sampling=kinds)
    torch.cuda.synchronize()
    reset_counts()
    sampled_calls.clear()
    wave_counts = []
    served = serve_waves(eng, rng, sz.vocab, waves, sampling=kinds,
                         after_wave=lambda i: wave_counts.append(len(sampled_calls)))
    counts = read_counts()
    for (groups, dec), kind in zip(served, ("greedy", "sampled")):
        check_served(groups, sz.vocab, sz.max_len, pipe)
        out[f"wave_{kind}"] = {"decode_tok_s": dec["tokens"] / dec["seconds"],
                               "decode_tokens": dec["tokens"], "decode_s": dec["seconds"],
                               "p50_ttft_ms": ttft_ms(groups)}
    greedy_calls, sampled_wave = sampled_calls[:wave_counts[0]], sampled_calls[wave_counts[0]:]
    if any(greedy_calls) or not sampled_wave or not all(sampled_wave):
        raise AssertionError(f"the waves did not take the greedy and the sampled loop: "
                             f"{sampled_calls}")
    out["wave_sampling"] = WAVE_SAMPLING
    out["wave_launches"] = counts
    out.update(check_graphed(counts, pipe))
    out["graph_keys"] = sorted(f"{w} {'sampled' if smp else 'greedy'}"
                               for w, smp in pipe.graphs.graphs)
    check_launched(counts, ("q4k_q8_gemv", "q8_0_q8_gemv"))
    emit(out)
    del eng, pipe
    return out


# the speculative phase: draft A's depth, each pipeline's gamma and rounds
# a call (the root bench.py's model-draft and prompt-lookup arms), the
# waves' prompt and new tokens, the prompt-lookup segment, the sampled
# wave's new tokens and SamplingParams, and the near-tie rule's share of
# a row's largest |logit|
SPEC_DRAFT_LAYERS = 8
SPEC_GAMMA, SPEC_ROUNDS = 4, 13
PLD_GAMMA, PLD_ROUNDS = 3, 16
SPEC_PROMPT, SPEC_NEW = 256, 128
PLD_SEGMENT = 32
SPEC_SAMPLED_NEW = 32
SPEC_SAMPLING = {"temperature": 0.7, "top_p": 0.9}
NEAR_TIE = 0.01


def draft_prefix(target, n_layers: int):
    """A draft pipeline made of the target pipeline's first n_layers: its
    fused, requantized params shared (no new weight memory; the pipeline's
    fusion and requant leave them as they are), a KV pool of its own of the
    same page geometry."""
    from mistralrs_tpu_torch.pipeline.text import TextPipeline

    cfg = dataclasses.replace(target.cfg, num_layers=n_layers)
    params = dataclasses.replace(target.params, layers=target.params.layers[:n_layers])
    return TextPipeline(cfg, params, target.rope, target.pc)


def spec_prompts(rng, vocab: int, n: int, plen: int, segment: int | None = None) -> list:
    """n prompts of plen +- 8 tokens: random, or a random `segment`-token
    segment repeated (so n-gram matches exist)."""
    out = []
    for _ in range(n):
        m = int(plen + rng.integers(-8, 9))
        if segment is None:
            out.append([int(t) for t in rng.integers(1, vocab, m)])
        else:
            seg = [int(t) for t in rng.integers(1, vocab, segment)]
            out.append((seg * (m // segment + 1))[:m])
    return out


def serve_prompts(eng, prompts, max_len: int, sampling: dict | None = None):
    """Every prompt as one request served to its end: (groups, decode
    tokens and seconds, wall seconds). A decode step is one that prefilled
    nothing: the scheduler alternates decode steps with prefill steps, and a
    model-draft pipeline prefills one sequence a step, so its requests start
    decoding while later ones still wait."""
    from mistralrs_tpu_torch.engine.engine import GenerationRequest
    from mistralrs_tpu_torch.engine.sampler import SamplingParams

    groups = [eng.add_request(GenerationRequest(list(p), SamplingParams(max_len=max_len,
                                                                         **(sampling or {}))))
              for p in prompts]
    seqs = [g.seqs[0] for g in groups]
    decode = {"tokens": 0, "seconds": 0.0, "steps": 0}
    t0 = time.perf_counter()
    while not all(g.all_done() for g in groups):
        done, made = (sum(s.prefill_done_tokens for s in seqs),
                      sum(s.num_generated for s in seqs))
        t = time.perf_counter()
        eng.step()
        dt = time.perf_counter() - t
        if sum(s.prefill_done_tokens for s in seqs) == done:
            decode["tokens"] += sum(s.num_generated for s in seqs) - made
            decode["seconds"] += dt
            decode["steps"] += 1
    decode["wall_s"] = time.perf_counter() - t0
    return groups, decode


def near_ties(pipe, prompts, ref: list, got: list) -> list:
    """Where a greedy stream differs from the plain one: at the first
    differing token, the shared prefix rescored by the plain pipeline (one
    sequence prefilled in 256-token chunks; the full logits of its last
    row); raises unless the two tokens' logits lie within NEAR_TIE of that
    row's largest |logit|. Returns one entry per differing stream."""
    from mistralrs_tpu_torch.engine.block_manager import BlockManager
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.engine.sequence import Sequence

    out = []
    for i, (p, a, b) in enumerate(zip(prompts, ref, got)):
        if a == b:
            continue
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            raise AssertionError(f"request {i}: streams of {len(a)} and {len(b)} tokens")
        seq = Sequence(list(p) + a[:j], SamplingParams(max_len=1),
                       max_model_len=pipe.pc.max_model_len)
        bm = BlockManager(pipe.pc.num_pages, pipe.pc.page_size)
        bm.allocate(seq)
        chunk = pipe.pc.prefill_buckets[-1]
        for start in range(0, len(seq.tokens), chunk):
            logits = pipe.run_prefill_chunk(seq, seq.tokens[start:start + chunk])
        gap = abs(float(logits[a[j]]) - float(logits[b[j]])) / float(np.abs(logits).max())
        entry = {"request": i, "position": j, "plain": a[j], "spec": b[j], "rel_gap": gap}
        if gap > NEAR_TIE:
            raise AssertionError(f"a greedy stream differs from plain decoding where it is not a "
                                 f"near-tie: {entry}")
        out.append(entry)
    return out


def spec_wave_line(groups, dec, counts: dict, pipe) -> dict:
    """A wave's figures: decode tok/s, p50 TTFT, proposed / accepted, the
    loop's counters and K1's and K2's launches at both instantiations."""
    seqs = [s for g in groups for s in g.seqs]
    proposed = sum(s.spec_proposed for s in seqs)
    accepted = sum(s.spec_accepted for s in seqs)
    line = {"decode_tok_s": dec["tokens"] / dec["seconds"], "decode_tokens": dec["tokens"],
            "decode_s": dec["seconds"], "decode_steps": dec["steps"], "wall_s": dec["wall_s"],
            "p50_ttft_ms": ttft_ms(groups),
            "proposed": proposed, "accepted": accepted,
            "accept_rate": accepted / proposed if proposed else None,
            **{k: counts[k] for k in GRAPH_COUNTERS},
            **{k: counts[k] for k in ("q4k_q8_gemv", "q4k_q8_gemv_rows", "q8_0_q8_gemv",
                                      "q8_0_q8_gemv_rows")}}
    graphs = getattr(pipe, "graphs", None)
    if graphs is not None and getattr(pipe, "is_speculative", False):
        line["capture_s"] = graphs.capture_s
        # the launches one replay of each graph adds (the loop's kernels)
        line["replay_launches"] = {f"{k[0]} {k[1]}": {n: d for (_, n), d in delta.items()}
                                   for k, (_, _, delta) in graphs.graphs.items()}
    return line


# calls of each pipeline the phase times at a full batch (after one more)
SPEC_TIMED_CALLS = 3


def full_batch_calls(pipe, prompts) -> dict:
    """The loop's own speed at a full batch: one sequence a prompt, each
    prefilled alone in chunks of the largest bucket through `pipe` (the target, or a speculative
    pipeline, which prefills its draft too) with its first token appended,
    then SPEC_TIMED_CALLS + 1 decode calls on the same inputs (the target's
    run_decode_multi, kv_len rewound after each; or run_spec_multi, which
    advances nothing), the first untimed: median wall and device ms a call
    (CUDA events around it), the tokens a call emits (decode_steps a row;
    the rounds' emitted counts summed) and their rate over the wall time."""
    import torch

    from mistralrs_tpu_torch.engine.block_manager import BlockManager
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.engine.sequence import Sequence

    spec = getattr(pipe, "is_speculative", False)
    pc = pipe.pc
    bm = BlockManager(pc.num_pages, pc.page_size)
    seqs = []
    for p in prompts:
        seq = Sequence(list(p), SamplingParams(max_len=SPEC_NEW), max_model_len=pc.max_model_len)
        bm.allocate(seq)
        for start in range(0, len(p), pc.prefill_buckets[-1]):
            pack = pipe.run_prefill_chunk(seq, list(p[start:start + pc.prefill_buckets[-1]]),
                                          greedy=True)
        seq.tokens.append(int(pack[0]))
        bm.append_slot(seq, pipe.spec_rounds * (pipe.gamma + 1) if spec else pc.decode_steps)
        seqs.append(seq)
    walls, devs = [], []
    for i in range(SPEC_TIMED_CALLS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t = time.perf_counter()
        ev[0].record()
        pack = pipe.run_spec_multi(seqs) if spec else pipe.run_decode_multi(seqs)
        ev[1].record()
        torch.cuda.synchronize()
        if i:
            walls.append(1e3 * (time.perf_counter() - t))
            devs.append(ev[0].elapsed_time(ev[1]))
        if not spec:
            for seq in seqs:
                seq.kv_len -= pc.decode_steps
    tokens = (int(pack[:, :, 2 * (pipe.gamma + 1)].sum()) if spec
              else pc.decode_steps * len(seqs))
    wall = statistics.median(walls)
    return {"rows": len(seqs), "call_wall_ms": wall, "call_device_ms": statistics.median(devs),
            "tokens_a_call": tokens, "tok_s": tokens / wall * 1e3}


def speculative_phase(sz: Sizes, device) -> dict:
    """Speculative decoding at full width (module docstring, phase 21):
    plain greedy, draft A, draft B and prompt lookup greedy on the device
    loops, then a sampled wave on draft A's host step."""
    import torch

    from mistralrs_tpu_torch.engine.engine import Engine
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.pipeline.speculative import PromptLookupPipeline, SpeculativePipeline
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    fdt = torch.bfloat16
    cfg = model_config(sz, sz.layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = random_q4km_params(sz, sz.layers, device, gen, fdt)
    pc = PipelineConfig(page_size=16, num_pages=1024, max_seqs=16, max_model_len=2048,
                        prefill_buckets=(64, 256), decode_steps=8, dtype=fdt, device=str(device))
    target = TextPipeline(cfg, params, make_rope(cfg, pc.max_model_len, device=device), pc)
    del params
    draft_a = draft_prefix(target, SPEC_DRAFT_LAYERS)
    draft_b = draft_prefix(target, sz.layers)
    pipes = {"plain": target,
             "draft_a": SpeculativePipeline(target, draft_a, SPEC_GAMMA, SPEC_ROUNDS),
             "draft_b": SpeculativePipeline(target, draft_b, SPEC_GAMMA, SPEC_ROUNDS),
             "pld": PromptLookupPipeline(target, PLD_GAMMA, spec_rounds=PLD_ROUNDS)}
    rng = np.random.default_rng(23)
    B = pc.max_seqs
    prompts = spec_prompts(rng, sz.vocab, B, SPEC_PROMPT)
    pld_prompts = spec_prompts(rng, sz.vocab, B, SPEC_PROMPT, PLD_SEGMENT)
    out = {"phase": "speculative", "layers": sz.layers, "draft_a_layers": SPEC_DRAFT_LAYERS,
           "gamma": SPEC_GAMMA, "rounds": SPEC_ROUNDS, "pld_gamma": PLD_GAMMA,
           "pld_rounds": PLD_ROUNDS, "requests": B, "new_tokens": SPEC_NEW,
           "sampled_new_tokens": SPEC_SAMPLED_NEW, "sampling": SPEC_SAMPLING,
           "setup_s": time.perf_counter() - t0}
    engines = {name: Engine(p, eos_token_ids=set(), prefix_cache=False)
               for name, p in pipes.items()}
    # (wave, engine, prompts, new tokens, sampling)
    waves = (("plain", "plain", prompts, SPEC_NEW, None),
             ("plain_pld", "plain", pld_prompts, SPEC_NEW, None),
             ("draft_a", "draft_a", prompts, SPEC_NEW, None),
             ("draft_b", "draft_b", prompts, SPEC_NEW, None),
             ("pld", "pld", pld_prompts, SPEC_NEW, None),
             ("sampled", "draft_a", prompts, SPEC_SAMPLED_NEW, SPEC_SAMPLING))
    streams = {}
    warm = set()
    for wave, name, wave_prompts, new, sampling in waves:
        eng = engines[name]
        if (name, sampling is None) not in warm:
            # warm-up requests of the wave's shortest and longest prompts
            # capture the graphs of every block-table width the wave reaches
            t = time.perf_counter()
            serve_prompts(eng, [min(wave_prompts, key=len), max(wave_prompts, key=len)],
                          24 if sampling is None else 2, sampling)
            torch.cuda.synchronize()
            out[f"warmup_s_{wave}"] = time.perf_counter() - t
            warm.add((name, sampling is None))
        reset_counts()
        groups, dec = serve_prompts(eng, wave_prompts, new, sampling)
        counts = read_counts()
        seqs = [s for g in groups for s in g.seqs]
        if any(s.num_generated != new or s.stop_reason.value != "length" for s in seqs):
            raise AssertionError(f"{wave}: a request did not finish with {new} tokens")
        if not all(0 <= t < sz.vocab for s in seqs for t in s.generated_tokens):
            raise AssertionError(f"{wave}: a generated token is outside the vocabulary")
        line = spec_wave_line(groups, dec, counts, pipes[name])
        streams[wave] = [s.generated_tokens for s in seqs]
        if name == "plain":
            if counts["decode_graph_replays"] < 1 or counts["decode_eager_loops"]:
                raise AssertionError(f"{wave}: the decode loop did not run as graph replays")
        elif sampling is None:
            if (counts["spec_graph_replays"] < 1 or counts["spec_eager_loops"]
                    or counts["spec_host_steps"]):
                raise AssertionError(f"{wave}: the speculative loop did not run as graph replays "
                                     f"only: {counts}")
            # K1 and K2 inside the loop's graphs: the verify's rows
            # instantiations, and a model draft's 16-row feeds the decode ones
            need = ["q4k_q8_gemv_rows", "q8_0_q8_gemv_rows"]
            if name != "pld":
                need += ["q4k_q8_gemv", "q8_0_q8_gemv"]
            if not all(any(d.get(f"{n}_launches") for d in line["replay_launches"].values())
                       for n in need):
                raise AssertionError(f"{wave}: K1 or K2 missing from the loop's graphs: "
                                     f"{line['replay_launches']}")
            ref = "plain_pld" if name == "pld" else "plain"
            line["near_ties"] = near_ties(target, wave_prompts, streams[ref], streams[wave])
            line["streams_equal"] = sum(a == b for a, b in zip(streams[ref], streams[wave]))
        elif counts["spec_host_steps"] < 1:
            raise AssertionError(f"{wave}: the sampled wave took no host step")
        out[wave] = line
    # the loops' own speed at 16 rows, away from the engine's scheduling
    out["full_batch"] = {name: full_batch_calls(p, pld_prompts if name == "pld" else prompts)
                         for name, p in pipes.items()}
    if out["draft_b"]["accept_rate"] < 0.95:
        raise AssertionError(f"draft B (the target itself) accepted {out['draft_b']['accept_rate']}"
                             " of its proposals, under 0.95")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(out)
    del engines, pipes, target, draft_a, draft_b
    free_card_memory()
    return out


def quant_mix_phase(sz: Sizes, device) -> dict:
    """Q5_K_M with Q6_K kept as Q6_K: K9 (both instantiations), K3, K4's
    rows instantiation and the Q5_K / Q6_K dequant kernels, and neither K1
    nor K2."""
    out = short_context_phase(sz, device, "quant_mix", random_q5km_params, None)
    check_launched(out["launches"], PATH_KERNELS["quant_mix"] + ("flash_prefill",))
    if any(k1_k2_launches(out["launches"])):
        raise AssertionError(f"the Q5_K_M path launched K1 or K2: {out['launches']}")
    return out


# what the Q2_K pipeline serves: Q2_K, Q4_K, and int8 per 32 for Q3_K/Q6_K
Q2K_KINDS = ["gguf_q2k", "gguf_q4k", "gguf_q8_0"]


def q2k_phase(sz: Sizes, device) -> dict:
    """llama.cpp's Q2_K mix with Q3_K and Q6_K requantized to int8 per 32
    (the default rq8): K10 for q|k and gate|up up to 256 rows (its rows
    instantiation above 16) and affine_dequant above, K1 for v, K2 for o,
    down and the lm_head; no Q5_K or Q6_K kernel."""
    out = short_context_phase(sz, device, "q2k", random_q2k_params, 32)
    if out["kinds"] != Q2K_KINDS:
        raise AssertionError(f"the Q2_K pipeline serves other kinds: {out['kinds']}")
    check_launched(out["launches"], PATH_KERNELS["q2k"] + PATH_KERNELS["slice"])
    if any(out["launches"][n] for n in PATH_KERNELS["quant_mix"]):
        raise AssertionError(f"the Q2_K path launched a Q5_K or Q6_K kernel: {out['launches']}")
    return out


# what the Gemma-2 pipeline serves: Q4_K projections (the lm_head is the
# tied bf16 embedding)
GEMMA2_KINDS = ["gguf_q4k"]


def gemma2_phase(sz: Sizes, device) -> dict:
    """Gemma-2-9B at full width and depth, every projection Q4_K: K11 for
    the 4 x 256-row first chunks (q4k_dequant + torch.matmul for their
    projections), K1 for the 4 x 64-row chunks and decode (gather + the
    soft cap for their attention); never K6."""
    out = short_context_phase(GEMMA2, device, "gemma2", random_gemma2_params, 32, gemma2_config)
    if out["kinds"] != GEMMA2_KINDS:
        raise AssertionError(f"the Gemma-2 pipeline serves other kinds: {out['kinds']}")
    check_launched(out["launches"], PATH_KERNELS["gemma2"] + ("q4k_q8_gemv", "q4k_dequant"))
    if out["launches"]["flash_prefill"]:
        raise AssertionError(f"the Gemma-2 path launched the flash kernel K6: {out['launches']}")
    return out


# the hf_isq phase's depth (of Gemma-2-9B's 42 layers): ~3.2 GB of bf16
# layers beside the 1.8 GB tied embedding, about gguf_bf16's 5.1 GB file
HF_ISQ_LAYERS = 8
# the seed of the phases' checkpoints: the first layers of every depth are
# the same draws, so card_vs_cpu_isq's 2 layers are hf_isq's first 2
HF_ISQ_SEED = 21


def hf_isq_phase(sz: Sizes, device) -> dict:
    """Gemma-2-9B from an HF checkpoint with in-situ quantization: a
    HF_ISQ_LAYERS-layer checkpoint at full width (write_gemma2_hf, random
    bf16 weights, two safetensors shards) written into a temporary
    directory, loaded by load_hf_model(path, isq="Q4K") (the projections
    quantized on the host by the Q4_K scale search, in the loader's
    threads), served in the slice phase's pattern (K11 for the 4 x 256-row
    first chunks, q4k_dequant + torch.matmul for their projections, K1 for
    the 4 x 64 rows and decode, on graph replays); then pipe.re_isq("Q8_0")
    and two more waves of the pattern: one that captures the decode graphs
    anew (K2 and q8_0_dequant in place of K1 and q4k_dequant), one timed.
    It raises unless every projection loaded as gguf_q4k with the embedding
    bf16, K1, K11 and q4k_dequant launched, and after re_isq the kinds are
    gguf_q8_0, the graphs were dropped and captured anew, and K2 launched.
    The line gives the write, header-read (TensorSource alone), load
    (load_hf_model) and ISQ (the load but its header read: the layers
    quantized, packed and copied to the card in LOAD_THREADS threads, the
    embedding beside them) seconds, ISQ seconds a layer, the checkpoint's
    GB and GB/s, and re_isq's seconds and its waves' figures."""
    import tempfile

    import torch

    from mistralrs_tpu_torch.models.loader import LOAD_THREADS, TensorSource, load_hf_model

    g = dataclasses.replace(GEMMA2, layers=HF_ISQ_LAYERS)
    free_card_memory()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="gemma2-9b-hf-") as tmp:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        emit({"phase": "hf_isq_tmp", "tmp_free_gb": free_gb})
        t0 = time.perf_counter()
        nbytes = write_gemma2_hf(tmp, g, g.layers, seed=HF_ISQ_SEED, device=device)
        write_s = time.perf_counter() - t0
        t = time.perf_counter()
        TensorSource.from_safetensors_dir(tmp)
        header_s = time.perf_counter() - t
        t = time.perf_counter()
        cfg, params, rope = load_hf_model(tmp, isq="Q4K", device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    kinds = params_kinds(params)
    if kinds != GEMMA2_KINDS or params.embed.dtype != torch.bfloat16 or params.lm_head is not None:
        raise AssertionError(f"ISQ Q4K loaded {kinds}, an embedding in {params.embed.dtype}, "
                             f"an lm_head {params.lm_head is not None}")
    if (cfg.num_layers, cfg.hidden_size, cfg.vocab_size) != (g.layers, g.hidden, g.vocab):
        raise AssertionError(f"the checkpoint's config is not the written one: {cfg}")

    def re_isq_waves(pipe, serve) -> dict:
        t = time.perf_counter()
        pipe.re_isq("Q8_0")
        torch.cuda.synchronize()
        re_isq_s = time.perf_counter() - t
        kinds = served_kinds(pipe)
        if kinds != ["gguf_q8_0"] or pipe.graphs.graphs:
            raise AssertionError(f"re_isq left kinds {kinds} and {len(pipe.graphs.graphs)} graphs")
        reset_counts()
        serve(g.max_len, {"tokens": 0, "seconds": 0.0})
        first = read_counts()
        if first["decode_graph_captures"] < 1:
            raise AssertionError(f"no decode graph was captured after re_isq: {first}")
        check_graphed(first, pipe)
        reset_counts()
        decode = {"tokens": 0, "seconds": 0.0}
        groups = serve(g.max_len, decode)
        n = read_counts()
        check_served(groups, g.vocab, g.max_len, pipe)
        check_launched(n, ("q8_0_q8_gemv", "q8_0_q8_gemv_rows", "q8_0_dequant", "splash_prefill"))
        if any(n[k] for k in ("q4k_q8_gemv", "q4k_q8_gemv_rows", "q4k_dequant")):
            raise AssertionError(f"a Q4_K kernel launched after re_isq: {n}")
        return {"re_isq_s": re_isq_s, "re_isq_kinds": kinds,
                "re_isq_captures": first["decode_graph_captures"], **check_graphed(n, pipe),
                "re_isq_decode_tok_s": decode["tokens"] / decode["seconds"],
                "re_isq_p50_ttft_ms": ttft_ms(groups), "re_isq_launches": n}

    out = serve_short_context(
        g, device, "hf_isq", cfg, params, rope, t0, rq8_group=32, after=re_isq_waves,
        tmp_free_gb=free_gb, checkpoint_gb=nbytes / 1e9, write_s=write_s, header_s=header_s,
        load_s=load_s, load_gb_s=nbytes / 1e9 / load_s, isq_s=load_s - header_s,
        isq_s_per_layer=(load_s - header_s) / g.layers, load_threads=LOAD_THREADS,
        loaded_kinds=kinds)
    del params
    check_launched(out["launches"], ("q4k_q8_gemv", "q4k_q8_gemv_rows", "splash_prefill",
                                     "q4k_dequant"))
    if out["launches"]["flash_prefill"]:
        raise AssertionError(f"the Gemma-2 path launched the flash kernel K6: {out['launches']}")
    return out


def card_vs_cpu_isq_phase(sz: Sizes, device) -> list[dict]:
    """hf_isq's checkpoint at 2 layers (write_gemma2_hf with its seed: the
    same embedding and first 2 layers), loaded with ISQ Q4K on the card and
    on the CPU (bf16 both: every packed byte, scale and min must be equal;
    the CPU side then computes in f32): a 256-token first chunk (K11 on the
    card) and 4 decode steps (K1), logits within 5% of each step's largest
    |logit|; and the ISQ model's error against the same checkpoint loaded
    dense (on the card, fed the same tokens)."""
    import tempfile

    import torch

    from mistralrs_tpu_torch.models.loader import load_hf_model

    n_layers = 2
    with tempfile.TemporaryDirectory(prefix="gemma2-9b-hf-2l-") as tmp:
        write_gemma2_hf(tmp, GEMMA2, n_layers, seed=HF_ISQ_SEED, device=device)
        t = time.perf_counter()
        cfg, card, _ = load_hf_model(tmp, isq="Q4K", device=device)
        torch.cuda.synchronize()
        card_load_s = time.perf_counter() - t
        t = time.perf_counter()
        _, cpu, _ = load_hf_model(tmp, isq="Q4K", device="cpu")
        cpu_load_s = time.perf_counter() - t
        dense = load_hf_model(tmp, device=device)[1]
    compared = 0
    for lc, lg in zip(card.layers, cpu.layers):
        for part in ("attn", "mlp"):
            for (name, a), (_, b) in zip(_linears(lc[part]), _linears(lg[part])):
                if not a.kind == b.kind == "gguf_q4k" or a.data.keys() != b.data.keys():
                    raise AssertionError(f"{part}.{name}: {a.kind} on the card, {b.kind} on the CPU")
                for k in a.data:
                    if not torch.equal(a.data[k].cpu(), b.data[k]):
                        raise AssertionError(f"{part}.{name}.{k} differs between card and CPU")
                    compared += b.data[k].numel() * b.data[k].element_size()
    if not torch.equal(card.embed.cpu(), cpu.embed):
        raise AssertionError("the embedding differs between card and CPU")

    def weights(dev, dt):
        return cfg, (card if dev.type == "cuda" else _moved_params(cpu, dev, dt))

    prompt = [int(x) for x in np.random.default_rng(23).integers(1, cfg.vocab_size, 256)]
    runs, n = _token_major_run(None, weights, device, prompt, 32)
    want = {"splash_prefill": n_layers, "flash_prefill": 0}
    if any(n[k] != v for k, v in want.items()) or not n["q4k_q8_gemv"]:
        raise AssertionError(f"the ISQ check took other routes on the card: {n}")
    del cpu
    forced = [int(np.argmax(x)) for x in runs["cpu"][:4]]
    ref = _token_major_run(None, lambda dev, dt: (cfg, dense), device, prompt, 32,
                           sides=((device, torch.bfloat16),), forced=forced)[0][device.type]
    got = runs[device.type]
    scale = np.abs(ref).max(axis=1, keepdims=True)
    return [_compare_sides(
        "card_vs_cpu_isq", runs, device, n_layers, vocab=cfg.vocab_size,
        packed_bytes_equal=compared, card_load_s=card_load_s, cpu_load_s=cpu_load_s,
        isq_vs_dense_max_rel_err=float((np.abs(got - ref) / scale).max()),
        isq_vs_dense_rel_rms_err=float(np.sqrt(((got - ref) ** 2).mean())
                                       / np.sqrt((ref ** 2).mean())),
        isq_vs_dense_argmax_agree=int((got.argmax(1) == ref.argmax(1)).sum()),
        launches={k: n[k] for k in ("splash_prefill", "q4k_q8_gemv")})]


# the int8 route's GEMVs, which no layer of an int8_activations=False
# pipeline may launch
INT8_GEMVS = ("q4k_q8_gemv", "q8_0_q8_gemv", "q6k_q8_gemv", "q5k_q8_gemv")
# their launch counters (K1, K2 and K9 have a second instantiation each)
INT8_COUNTERS = INT8_GEMVS + ("q4k_q8_gemv_rows", "q8_0_q8_gemv_rows", "q5k_q8_gemv_rows")


def gguf_bf16_phase(sz: Sizes, device) -> dict:
    """Mistral-7B in the Q5_K_M rule from a GGUF file at full width:
    written by the port's writer (random wire blocks) into a temporary
    directory, loaded by load_gguf_model, served with int8_activations=False
    at the default rq8_group=32 in the slice phase's pattern: K9b's decode
    instantiation (the whole Q5_K product in one kernel) for every Q5_K
    projection at decode, K5's and K9b's rows instantiations on the 4 x
    64-row step, K8 for the requantized Q6_K ones (attn_v, the
    use_more_bits ffn_down, the lm_head) up to 256 rows, the Q5_K and int8
    dequant kernels above, K6 for the first chunks. It raises unless those
    launched, and if an int8 GEMV or K5's decode instantiation did (the
    Q5_K_M rule has no Q4_K tensor; K9b has no high-bit kernel at 1-16
    rows, its wrapper raises there). The line gives the
    write, read (the header), load (load_gguf_model) and pack (the load
    but its header read: the layers packed and copied to the card in
    load_gguf_model's threads, the embedding dequantized beside them) times,
    and the embedding's dequantization timed alone."""
    import os
    import tempfile

    import torch

    from mistralrs_tpu_torch.gguf.reader import GGUFFile
    from mistralrs_tpu_torch.pipeline.gguf import load_gguf_model

    free_card_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mistral-7b-q5_k_m.gguf")
        nbytes = write_random_gguf(path, sz, sz.layers, "Q5_K", seed=12)
        write_s = time.perf_counter() - t0
        t = time.perf_counter()
        g = GGUFFile(path)
        read_s = time.perf_counter() - t
        t = time.perf_counter()
        g.tensor_f32("token_embd.weight")
        embed_s = time.perf_counter() - t
        del g
        t = time.perf_counter()
        cfg, params, rope, tokenizer = load_gguf_model(path, dtype=torch.bfloat16, device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    if (cfg.num_layers, cfg.hidden_size, cfg.vocab_size) != (sz.layers, sz.hidden, sz.vocab):
        raise AssertionError(f"the file's config is not the written one: {cfg}")
    out = serve_short_context(
        sz, device, "gguf_bf16", cfg, params, rope, t0, rq8_group=32, int8_activations=False,
        file_gb=nbytes / 1e9, write_s=write_s, read_s=read_s,
        embed_dequant_s=embed_s, load_s=load_s, pack_s=load_s - read_s,
        tokenizer=tokenizer)
    del params
    n = out["launches"]
    check_launched(n, PATH_KERNELS["gguf_bf16"] + ("flash_prefill", "q5k_dequant", "q8_0_dequant"))
    if any(n[k] for k in INT8_COUNTERS):
        raise AssertionError(f"int8_activations=False launched an int8 GEMV: {n}")
    if n["q4k_bf16_gemv"]:
        raise AssertionError(f"a Q5_K_M decode step launched K5's decode instantiation: {n}")
    return out


def free_card_memory() -> float:
    """Drop what earlier phases left (cycles, the caching allocator's free
    blocks); returns the card's free memory in GB."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0] / 1e9


# what the bf16-expert Mixtral pipeline serves: Q4_K attention, router and
# lm_head (ISQ Q4K), dense bf16 experts
MIXTRAL_KINDS = ["dense", "gguf_q4k"]
# and the GGUF Q4_K_M one: Q4_K q, k, o and experts, int8 per 32 for the Q6_K
# attn_v and lm_head, the dense router
MIXTRAL_Q4KM_KINDS = ["dense", "gguf_q4k", "gguf_q8_0"]


def mixtral_phase(sz: Sizes, device) -> dict:
    """Mixtral-8x7B with dense bf16 experts at 24 of its 32 layers (16 if
    the card's free memory is short): the slice pattern through the grouped
    dropless dispatch, K13 at M = 2,048 (the 4 x 256-row first chunk, with
    K6), M = 512 (4 x 64 rows) and M <= 32 (decode; K1 for the router and
    the attention)."""
    free_gb = free_card_memory()
    layers = MIXTRAL_BF16_LAYERS[0] if free_gb >= MIXTRAL_BF16_NEED_GB else MIXTRAL_BF16_LAYERS[1]
    out = short_context_phase(
        dataclasses.replace(MIXTRAL, layers=layers), device, "mixtral", random_mixtral_params, 32,
        mixtral_config, layers_of=32, free_gb_before=free_gb,
        depth_cut=f"{layers} of 32 layers: the bf16 experts hold 2.82 GB a layer")
    if out["kinds"] != MIXTRAL_KINDS:
        raise AssertionError(f"the Mixtral pipeline serves other kinds: {out['kinds']}")
    check_launched(out["launches"], PATH_KERNELS["mixtral"] + ("flash_prefill", "q4k_q8_gemv"))
    n = out["launches"]
    # K13's both instantiations: tiles on the first chunks, decode on the rest
    if not 0 < n["grouped_gemm_tiles"] < n["grouped_gemm"]:
        raise AssertionError(f"K13 did not run both its instantiations: {n}")
    return out


def mixtral_q4km_phase(sz: Sizes, device) -> dict:
    """Mixtral-8x7B from a GGUF in the Q4_K_M rule at all 32 layers (28 GB
    of packed experts): the slice pattern through the packed every-expert
    branch, each expert's gate, up and down on K1 up to 256 rows and on
    q4k_dequant + torch.matmul above. K1 serves 26 GEMVs a layer (q|k, o
    and 8 x 3 experts) for K2's one (attn_v) in each forward at most 256
    rows, so it must have launched at least 24 x layers for each K2 launch
    a forward makes (layers + 1, the lm_head's); K13 never launches."""
    free_card_memory()
    out = short_context_phase(MIXTRAL, device, "mixtral_q4km",
                              lambda *a: random_mixtral_params(*a, packed=True), 32,
                              mixtral_config)
    if out["kinds"] != MIXTRAL_Q4KM_KINDS:
        raise AssertionError(f"the Mixtral Q4_K_M pipeline serves other kinds: {out['kinds']}")
    n = out["launches"]
    check_launched(n, ("q4k_q8_gemv", "q8_0_q8_gemv", "q4k_dequant", "flash_prefill"))
    k1, k2 = k1_k2_launches(n)
    small_forwards = k2 // (MIXTRAL.layers + 1)
    if k1 < 24 * MIXTRAL.layers * small_forwards or n["grouped_gemm"]:
        raise AssertionError(f"the packed experts did not run on K1 alone: {n}")
    return out


def long_context_phase(sz: Sizes, device) -> dict:
    """The 32-layer model on head-major pools at max_model_len 4096 serves
    a wave of ~3,400-token prompts (decode at span 4096: K7), then a wave of
    ~1,200-token prompts (decode at span 2048: gather + sdpa_head_major);
    their continuation chunks run K6'."""
    import torch

    from mistralrs_tpu_torch.engine.engine import Engine
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    fdt = torch.bfloat16
    cfg = model_config(sz, sz.layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = random_q4km_params(sz, sz.layers, device, gen, fdt)
    pc = PipelineConfig(page_size=16, num_pages=sz.pages_ctx, max_seqs=16, max_model_len=4096,
                        prefill_buckets=(16, 64, 256, 512), decode_steps=8, dtype=fdt,
                        device=str(device))
    pipe = TextPipeline(cfg, params, make_rope(cfg, 4096, device=device), pc)
    del params
    if not pipe.head_major:
        raise AssertionError("max_model_len 4096 did not select head-major pools")
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    rng = np.random.default_rng(2)
    waves = ((4, sz.long_prompt_ctx, sz.max_len_ctx), (4, sz.short_prompt_ctx, sz.max_len_ctx))
    # warm-up: both waves, one multistep decode call each
    serve_waves(eng, rng, sz.vocab, [(n, plen, 1 + pc.decode_steps) for n, plen, _ in waves])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    wave_counts = []
    t_run = time.perf_counter()
    served = serve_waves(eng, rng, sz.vocab, waves,
                         after_wave=lambda i: wave_counts.append(read_counts()))
    run_s = time.perf_counter() - t_run
    counts, counts_long = read_counts(), wave_counts[0]
    n_toks = check_served([g for groups, _ in served for g in groups], sz.vocab, sz.max_len_ctx,
                          pipe)
    # long prompts: no step of 17-256 rows, so no rows instantiation
    check_launched(counts, tuple(n for n in PATH_KERNELS["slice"] if not n.endswith("_rows"))
                   + PATH_KERNELS["long_context"])
    if counts["paged_decode"] != counts_long["paged_decode"]:
        raise AssertionError("decode at span 2048 launched the block-table decode kernel")
    graphs = check_graphed(counts, pipe)

    out = {"phase": "long_context", "layers": sz.layers, "requests": 8, "generated_tokens": n_toks,
           **wave_metrics(served), "run_s": run_s, "setup_s": setup_s, "launches": counts,
           "launches_long_wave": counts_long, **graphs, "kv_pages": pc.num_pages,
           "kv_gb": 2 * pipe.cache.k.numel() * pipe.cache.k.element_size() / 1e9,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    del eng, pipe
    return out


# the long_kv phase: the context length, each serving run's (requests,
# prompt tokens, new tokens), the prompts' worth of pages the swap run's
# pool holds, and the card-vs-CPU prompt (a first chunk of 4096, then a
# blockwise one)
LONG_KV_LEN = 32768
LONG_KV_BF16 = (2, 9000, 16)
LONG_KV_INT8 = (2, 16600, 24)
LONG_KV_SWAP = (8, 600, 64)
SWAP_ROOM = 5
LONG_KV_CHECK = 4600


def pages_for(n_req: int, plen: int, new: int, page: int = 16, lookahead: int = 8) -> int:
    """KV pages for n_req requests of at most plen + 8 prompt tokens and
    `new` generated ones with the decode loop's lookahead, plus the garbage
    page and the block manager's 1% watermark."""
    n = n_req * -(-(plen + 8 + new + lookahead) // page) + 1
    return n + n // 50 + 2


def long_kv_pipeline(cfg, params, rope, device, num_pages: int, max_seqs: int,
                     kv_quant: bool = False, max_model_len: int = LONG_KV_LEN):
    """A TextPipeline at max_model_len (head-major pools from 4096 on),
    512-token chunks, 8 decode steps a call, bf16 on the card and f32 on
    the CPU; int8 pools with kv_quant."""
    import torch

    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    pc = PipelineConfig(page_size=16, num_pages=num_pages, max_seqs=max_seqs,
                        max_model_len=max_model_len, prefill_buckets=(16, 64, 256, 512),
                        decode_steps=8, kv_quant=kv_quant, device=str(device),
                        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32)
    return TextPipeline(cfg, params, rope, pc)


def pool_bytes(cache) -> int:
    """Bytes of every page-indexed tensor of a KV cache (an int8 pool's
    scales included)."""
    from mistralrs_tpu_torch.ops.paged_attention import _pool_leaves

    return sum(t.numel() * t.element_size() for t in _pool_leaves(cache).values())


def serve_timed(eng, prompts, max_len: int):
    """Greedy-serve every prompt to its end, synchronizing after each step:
    (groups, figures) with the decode tokens and seconds of the steps that
    prefilled nothing and captured no decode graph, the steps that captured
    one, and the prefill steps with the wall ms of the last."""
    import torch

    from mistralrs_tpu_torch.engine.engine import GenerationRequest
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.pipeline import graphs

    card = eng.pipeline.device.type == "cuda"
    groups = [eng.add_request(GenerationRequest(list(p), SamplingParams(max_len=max_len)))
              for p in prompts]
    seqs = [g.seqs[0] for g in groups]
    fig = {"tokens": 0, "seconds": 0.0, "capture_steps": 0, "prefill_steps": 0,
           "last_prefill_ms": None}
    while not all(g.all_done() for g in groups):
        done, made = sum(s.prefill_done_tokens for s in seqs), sum(s.num_generated for s in seqs)
        caps = graphs.decode_graph_captures
        t = time.perf_counter()
        eng.step()
        if card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if sum(s.prefill_done_tokens for s in seqs) != done:
            fig["prefill_steps"] += 1
            fig["last_prefill_ms"] = 1e3 * dt
        elif graphs.decode_graph_captures != caps:
            fig["capture_steps"] += 1
        else:
            fig["tokens"] += sum(s.num_generated for s in seqs) - made
            fig["seconds"] += dt
    return groups, fig


def blockwise_layer(clock, pipe, B: int, span: int) -> dict:
    """One layer's blockwise attention for a B x 512 chunk at `span` (every
    key live) over layer 0 of the pipeline's pools (random pages): its
    device ms (a CUDA graph of the call, replayed between the clock's
    events, so host launch time does not count) and its largest error
    against the gather route's f32 sdpa on the same pages, relative to the
    largest |out|; raises past 1e-2 (the output's bf16 rounding)."""
    import torch

    from mistralrs_tpu_torch.ops.attention import NEG_INF, sdpa_head_major
    from mistralrs_tpu_torch.ops.paged_attention import (
        PagedAttnMeta,
        blockwise_prefill_continuation,
        gather_paged_kv,
        gather_paged_kv_q,
    )

    cfg, cache, dev = pipe.cfg, pipe.cache, pipe.device
    gen = torch.Generator(device=dev).manual_seed(3)
    tables = torch.randint(1, cache.num_pages, (B, span // 16), generator=gen, device=dev)
    meta = PagedAttnMeta(positions=None, slot_mapping=None, block_tables=tables,
                         kv_lens=torch.full((B,), span, device=dev), active=None,
                         head_major=True)
    q = torch.randn(B, 512, cfg.num_heads, cfg.head_dim, generator=gen, device=dev,
                    dtype=pipe.pc.dtype)
    if cache.quantized:
        ck, cv = (cache.k[0], cache.k_scale[0]), (cache.v[0], cache.v_scale[0])
        k, v = gather_paged_kv_q(ck, cv, tables, head_major=True, dtype=q.dtype)
    else:
        ck, cv = cache.k[0], cache.v[0]
        k, v = gather_paged_kv(ck, cv, tables, head_major=True)
    scale = cfg.head_dim ** -0.5
    out = blockwise_prefill_continuation(q, ck, cv, meta, scale=scale).float()
    q_pos = torch.arange(span - 512, span, device=dev)[:, None]
    bias = torch.where(torch.arange(span, device=dev)[None] <= q_pos, 0.0, NEG_INF)[None, None]
    want = sdpa_head_major(q.float(), k, v, scale=scale, mask=bias)
    err = float((out - want).abs().max() / want.abs().max())
    del k, v, want, bias
    if not err <= 1e-2:
        raise AssertionError(f"blockwise attention differs from the gather route: {err}")

    def call():
        return blockwise_prefill_continuation(q, ck, cv, meta, scale=scale)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    ms = clock.ms(graph.replay)
    del graph
    return {"span": span, "rows": B, "ms": ms, "max_rel_err_vs_gather": err}


def long_kv_serve(eng, rng, vocab: int, run: tuple, tag: str) -> dict:
    """One serving run of the long_kv phase, (requests, prompt tokens, new
    tokens): its counts set to 0 just before and read just after; returns
    its line's figures."""
    n, plen, new = run
    prompts = spec_prompts(rng, vocab, n, plen)
    reset_counts()
    t0 = time.perf_counter()
    groups, fig = serve_timed(eng, prompts, new)
    run_s = time.perf_counter() - t0
    counts = read_counts()
    pipe = eng.pipeline
    n_toks = check_served(groups, vocab, new, pipe)
    return {"run": tag, "requests": n, "prompt_tokens": [len(p) for p in prompts],
            "generated_tokens": n_toks,
            "decode_tok_s": fig["tokens"] / fig["seconds"] if fig["seconds"] else None,
            "decode_tokens": fig["tokens"], "decode_s": fig["seconds"],
            "capture_steps": fig["capture_steps"], "prefill_steps": fig["prefill_steps"],
            "last_prefill_ms": fig["last_prefill_ms"], "p50_ttft_ms": ttft_ms(groups),
            "run_s": run_s, "launches": counts, "kv_quant": pipe.pc.kv_quant,
            "head_major": pipe.head_major,
            "decode_span": 16 * pipe._width_for_tokens(max(len(p) for p in prompts) + 8),
            "kv_pages": pipe.pc.num_pages, "kv_gb": pool_bytes(pipe.cache) / 1e9,
            "graphs": len(pipe.graphs.graphs) if pipe.graphs is not None else 0,
            "capture_s": pipe.graphs.capture_s if pipe.graphs is not None else 0.0,
            "chunks": -(-max(len(p) for p in prompts) // 512)}


def blockwise_expected(line: dict) -> int:
    """The forwards a long_kv serving run should take on the blockwise route:
    its prefill chunks past span 4096 (all but the first 8), and the 8
    forwards of every decode call at a span past _BLOCKWISE_DECODE_SPAN on a
    pool K7 does not take (int8, or token-major)."""
    from mistralrs_tpu_torch.models import decoder

    c = line["launches"]
    calls = c["decode_graph_replays"] + c["decode_graph_captures"] + c["decode_eager_loops"]
    decode = (line["decode_span"] > decoder._BLOCKWISE_DECODE_SPAN
              and (line["kv_quant"] or not line["head_major"]))
    return max(line["chunks"] - 8, 0) + (8 * calls if decode else 0)


def check_long_routes(line: dict, n_layers: int) -> None:
    """The card's routes in a long_kv serving run: K6 on the first chunk; on
    bf16 pools K6' on chunks 2-8 and K7 at decode; on int8 pools neither;
    blockwise_expected's forwards on the blockwise route; every decode call
    a graph replay."""
    c = line["launches"]
    if line["kv_quant"]:
        if c["flash_prefill_paged"] or c["paged_decode"]:
            raise AssertionError(f"an int8 pool took K6' or K7: {c}")
    elif c["flash_prefill_paged"] != 7 * n_layers or not c["paged_decode"]:
        raise AssertionError(f"bf16 chunks 2-8 did not take K6', or decode not K7: {c}")
    if not c["flash_prefill"] or c["blockwise_steps"] != blockwise_expected(line):
        raise AssertionError(f"the run took other routes than K6 and {blockwise_expected(line)} "
                             f"blockwise forwards: {c}")
    if c["decode_graph_replays"] < 1 or c["decode_eager_loops"]:
        raise AssertionError(f"the decode loop did not run as graph replays: {c}")


def swap_run(cfg, params, rope, device, rng, vocab: int, run: tuple = LONG_KV_SWAP,
             room: int = SWAP_ROOM, max_model_len: int = LONG_KV_LEN) -> dict:
    """The swap run: `run`'s greedy requests through an uncontended engine,
    then through Engine(preempt_mode="swap") whose pool holds the prompts of
    `room` of them; raises unless a sequence was swapped out and in, its
    live pages read back bit-equal through its new block table after each
    swap-in, no swapped sequence was prefilled again, and every stream
    equals the uncontended one's or differs first at a near-tie. (On random
    weights the streams depend little on the context, so the page check is
    what shows the context came back.)"""
    import torch

    from mistralrs_tpu_torch.engine.engine import Engine
    from mistralrs_tpu_torch.ops.paged_attention import _pool_leaves

    n, plen, new = run
    prompts = spec_prompts(rng, vocab, n, plen)
    roomy = long_kv_pipeline(cfg, params, rope, device, pages_for(n, plen, new), n,
                             max_model_len=max_model_len)
    ref_groups, _ = serve_timed(Engine(roomy, eos_token_ids=set(), prefix_cache=False),
                                prompts, new)
    ref = [g.seqs[0].generated_tokens for g in ref_groups]

    pages = room * -(-(plen + 8) // 16) + 4
    pipe = long_kv_pipeline(cfg, params, rope, device, pages, n, max_model_len=max_model_len)
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False, preempt_mode="swap")
    swapped, prefilled_again, count = set(), [], {"out": 0, "in": 0}
    swapper, swap_in = eng.scheduler.swapper, eng._swap_in_seq
    saved = {}  # id(seq) -> its live pages' contents at swap-out, every leaf

    def live(seq):
        pages = seq.block_table[:-(-seq.kv_len // 16)]
        return [leaf.index_select(pipe.cache.page_axis, torch.tensor(pages, device=leaf.device))
                for leaf in _pool_leaves(pipe.cache).values()]

    def swap_out(seq):
        count["out"] += 1
        swapped.add(id(seq))
        saved[id(seq)] = live(seq)
        swapper(seq)

    def restore(seq):
        count["in"] += 1
        swap_in(seq)
        # the restored context, read through the sequence's new pages
        if not all(torch.equal(a, b) for a, b in zip(live(seq), saved.pop(id(seq)))):
            raise AssertionError("a swapped-in sequence's pages differ from those swapped out")

    eng.scheduler.swapper, eng._swap_in_seq = swap_out, restore
    one, batch = pipe.run_prefill_chunk, pipe.run_prefill_chunks

    def seen(seqs):
        prefilled_again.extend(id(s) for s in seqs if id(s) in swapped)

    pipe.run_prefill_chunk = lambda seq, *a, **k: (seen([seq]), one(seq, *a, **k))[1]
    pipe.run_prefill_chunks = lambda items: (seen([s for s, _ in items]), batch(items))[1]
    reset_counts()
    t0 = time.perf_counter()
    groups, fig = serve_timed(eng, prompts, new)
    run_s = time.perf_counter() - t0
    counts = read_counts()
    n_toks = check_served(groups, vocab, new, pipe)
    got = [g.seqs[0].generated_tokens for g in groups]
    if not count["out"] or not count["in"]:
        raise AssertionError(f"no sequence was swapped out and in: {count}")
    if prefilled_again:
        raise AssertionError(f"{len(prefilled_again)} prefills of swapped sequences")
    ties = near_ties(roomy, prompts, ref, got)
    line = {"run": "swap", "requests": n, "prompt_tokens": [len(p) for p in prompts],
            "generated_tokens": n_toks, "kv_pages": pages,
            "kv_pages_uncontended": roomy.pc.num_pages,
            "swap_outs": count["out"], "swap_ins": count["in"],
            "streams_equal": sum(a == b for a, b in zip(ref, got)), "near_ties": ties,
            "decode_tok_s": fig["tokens"] / fig["seconds"] if fig["seconds"] else None,
            "decode_tokens": fig["tokens"], "decode_s": fig["seconds"],
            "capture_steps": fig["capture_steps"], "p50_ttft_ms": ttft_ms(groups), "run_s": run_s,
            "launches": counts, "free_pages_after": eng.block_manager.num_free}
    if eng.block_manager.num_free != pages - 1:
        raise AssertionError(f"pages were lost: {line}")
    return line


def long_kv_check_runs(cfg, weights, device, prompt, kv_quant: bool):
    """The card-vs-CPU run of the long_kv phase: a one-sequence pipeline on
    each side (max_model_len 8192) prefills the prompt's first 4096 tokens
    as one first chunk, then the rest as a chunk at span 8192, past 4096,
    so on the blockwise route; returns ({side: last position's logits [1,
    V]}, the card's logits of the same last step on the gather route, the
    card's counts over the two chunks)."""
    from mistralrs_tpu_torch.engine.block_manager import BlockManager
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.engine.sequence import Sequence
    from mistralrs_tpu_torch.models import decoder

    runs, counts, gather = {}, None, None
    for dev, dt in _sides(device):
        pipe = _side_pipeline(cfg, weights, dev, dt, page_size=16,
                              num_pages=pages_for(1, len(prompt), 0), max_model_len=8192,
                              prefill_buckets=(512, 4096), kv_quant=kv_quant)
        bm = BlockManager(pipe.pc.num_pages, pipe.pc.page_size)
        seq = Sequence(list(prompt), SamplingParams(max_len=1), max_model_len=8192)
        bm.allocate(seq)
        reset_counts()
        pipe.run_prefill_chunk(seq, seq.tokens[:4096])
        last = pipe.run_prefill_chunk(seq, seq.tokens[4096:], advance_state=False)
        runs[dev.type] = last[None].astype(np.float64)
        if dev.type == device.type:
            counts = read_counts()
            # the same last step again on the gather route (the JAX test's switch)
            blockwise = decoder._use_blockwise_continuation
            decoder._use_blockwise_continuation = lambda *a: False
            try:
                gather = pipe.run_prefill_chunk(seq, seq.tokens[4096:], advance_state=False)
            finally:
                decoder._use_blockwise_continuation = blockwise
            gather = gather[None].astype(np.float64)
        del pipe
    return runs, gather, counts


def long_kv_check(sz: Sizes, device, prompt=None) -> list[dict]:
    """Run (d) of the long_kv phase: 1 layer at sz's widths, the card against
    the CPU on bf16 and int8 pools (_compare_sides), and the card's blockwise
    step against its gather route by the same rule."""
    import torch

    cfg = model_config(sz, 1)
    gen = torch.Generator().manual_seed(7)
    weights = random_q4km_params(sz, 1, torch.device("cpu"), gen, torch.bfloat16)
    if prompt is None:
        prompt = [int(t) for t in np.random.default_rng(8).integers(1, sz.vocab, LONG_KV_CHECK)]
    outs = []
    for kv_quant in (False, True):
        runs, gather, c = long_kv_check_runs(cfg, weights, device, prompt, kv_quant)
        if c["blockwise_steps"] != 1 or c["flash_prefill_paged"] or c["paged_decode"]:
            raise AssertionError(f"the check's chunks took other routes: {c}")
        tag = "int8" if kv_quant else "bf16"
        outs.append(_compare_sides(f"long_kv_card_vs_cpu_{tag}", runs, device, 1,
                                   launches={k: c[k] for k in ("flash_prefill",
                                                               "blockwise_steps")}))
        got = runs[device.type]
        rel = float((np.abs(got - gather) / np.abs(gather).max(axis=1, keepdims=True)).max())
        line = {"phase": f"long_kv_blockwise_vs_gather_{tag}", "max_rel_err": rel,
                "tol_rel": 5e-2, "finite": bool(np.isfinite(got).all())}
        emit(line)
        if not line["finite"] or rel > line["tol_rel"]:
            raise AssertionError(f"the blockwise route and the gather route differ: {line}")
        outs.append(line)
    return outs


def long_kv_phase(sz: Sizes, device) -> dict:
    """Long contexts and KV capacity on the 32-layer Mistral-7B Q4_K_M: the
    bf16 and int8 serving runs, the swap run and the card-vs-CPU check (the
    module docstring, phase 22)."""
    import torch

    from mistralrs_tpu_torch.engine.engine import Engine
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.utils.memory import PagedCacheConfig, calculate_num_pages

    t_phase = time.perf_counter()
    free_card_memory()
    cfg = model_config(sz, sz.layers)
    gen = torch.Generator(device=device).manual_seed(0)
    params = random_q4km_params(sz, sz.layers, device, gen, torch.bfloat16)
    rope = make_rope(cfg, LONG_KV_LEN, device=device)
    rng = np.random.default_rng(11)
    clock = Clock(device)
    lines = {}

    # (a) bf16 pools
    n, plen, new = LONG_KV_BF16
    pipe = long_kv_pipeline(cfg, params, rope, device, pages_for(n, plen, new), n)
    params = pipe.params  # fused and requantized; the later pipelines share them
    # the pool's capacity in 90% of the card's free memory with the weights
    # resident (as num_pages=None sizes it), for bf16 and int8 pools
    free = free_card_memory() * 1e9 + pool_bytes(pipe.cache)
    capacity = {"free_gb": free / 1e9, "budget_gb": 0.9 * free / 1e9}
    for tag, nbytes in (("bf16", 2), ("int8", 1 + 4 / cfg.head_dim)):
        pages = calculate_num_pages(PagedCacheConfig(mem_bytes=int(0.9 * free), page_size=16),
                                    cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                                    dtype_bytes=nbytes, device=device)
        capacity[tag] = {"pages": pages, "tokens": 16 * pages,
                         "gb": pages * 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim
                         * 16 * nbytes / 1e9}
    if capacity["int8"]["tokens"] < 1.9 * capacity["bf16"]["tokens"]:
        raise AssertionError(f"int8 pools do not hold ~2x the tokens: {capacity}")
    emit({"phase": "long_kv_capacity", **capacity})
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    line = long_kv_serve(eng, rng, sz.vocab, LONG_KV_BF16, "bf16")
    check_long_routes(line, sz.layers)
    line["blockwise_layer"] = blockwise_layer(clock, pipe, n, 16384)
    lines["bf16"] = line
    emit({"phase": "long_kv_run", **line})
    del eng, pipe
    free_card_memory()

    # (b) int8 pools
    n, plen, new = LONG_KV_INT8
    pipe = long_kv_pipeline(cfg, params, rope, device, pages_for(n, plen, new), n, kv_quant=True)
    if not pipe.cache.quantized or pipe.cache.k.dtype != torch.int8:
        raise AssertionError("kv_quant=True did not build int8 pools")
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    line = long_kv_serve(eng, rng, sz.vocab, LONG_KV_INT8, "int8")
    check_long_routes(line, sz.layers)
    line["blockwise_layer"] = blockwise_layer(clock, pipe, n, LONG_KV_LEN)
    lines["int8"] = line
    emit({"phase": "long_kv_run", **line})
    del eng, pipe
    free_card_memory()

    # (c) swap preemption
    lines["swap"] = swap_run(cfg, params, rope, device, rng, sz.vocab)
    emit({"phase": "long_kv_run", **lines["swap"]})
    del params
    free_card_memory()

    # (d) the card against the CPU
    checks = long_kv_check(sz, device)
    out = {"phase": "long_kv", "layers": sz.layers, "max_model_len": LONG_KV_LEN,
           "capacity": capacity,
           **{f"{k}_{tag}": v[k] for tag, v in lines.items()
              for k in ("decode_tok_s", "p50_ttft_ms", "run_s")},
           "blockwise_layer_bf16": lines["bf16"]["blockwise_layer"],
           "blockwise_layer_int8": lines["int8"]["blockwise_layer"],
           "last_prefill_ms_int8": lines["int8"]["last_prefill_ms"],
           "blockwise_steps": {t: lines[t]["launches"]["blockwise_steps"]
                               for t in ("bf16", "int8")},
           "swap_outs": lines["swap"]["swap_outs"], "swap_ins": lines["swap"]["swap_ins"],
           "check_max_rel_err": {c["phase"]: c["max_rel_err"] for c in checks},
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


# the gemma2_ragged phase: prompt sizes and tokens of its two waves, and the
# pool (1,536 pages of 16 tokens at 344 KB a token: 8.5 GB)
RAGGED_WAVES = ((4, 4600, 64), (16, 200, 32))
RAGGED_PAGES = 1536


def gemma2_ragged_pipeline(sz: Sizes, n_layers: int, device, pages: int = RAGGED_PAGES):
    """Gemma-2-9B (gemma2_config, random_gemma2_params) at sz's widths and
    n_layers layers on the ragged attention backend: one combined K/V pool,
    max_model_len 8192, 16 slots, 512-token chunks."""
    import torch

    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    fdt = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = gemma2_config(sz, n_layers)
    gen = torch.Generator(device=device).manual_seed(0)
    params = random_gemma2_params(sz, n_layers, device, gen, fdt)
    pc = PipelineConfig(attn_backend="ragged", max_model_len=8192, page_size=16, num_pages=pages,
                        max_seqs=16, prefill_buckets=(16, 64, 256, 512), decode_steps=8,
                        dtype=fdt, device=str(device))
    return TextPipeline(cfg, params, make_rope(cfg, 8192, device=device), pc)


def serve_waves(eng, rng, vocab: int, waves, after_wave=None, sampling=None) -> list:
    """Each wave (requests, prompt tokens, tokens each) served to its end
    before the next, greedy or with the SamplingParams fields of
    sampling[i] (None: greedy); returns (groups, decode tokens and seconds)
    per wave, calling after_wave(i) after wave i."""
    out = []
    for i, (n, plen, max_len) in enumerate(waves):
        decode = {"tokens": 0, "seconds": 0.0}
        groups = add_requests(eng, rng, vocab, n, plen, max_len,
                              None if sampling is None else sampling[i])
        step_until(eng, groups, lambda: all(g.all_done() for g in groups), decode)
        out.append((groups, decode))
        if after_wave is not None:
            after_wave(i)
    return out


def wave_metrics(served) -> dict:
    """Decode tok/s, decode tokens and seconds, p50 TTFT and prompt tokens of
    a long wave and a short one, as serve_waves returns them."""
    out = {}
    for tag, (groups, dec) in zip(("long", "short"), served):
        out.update({f"decode_tok_s_{tag}": dec["tokens"] / dec["seconds"],
                    f"decode_tokens_{tag}": dec["tokens"], f"decode_s_{tag}": dec["seconds"],
                    f"p50_ttft_ms_{tag}": ttft_ms(groups),
                    f"prompt_tokens_{tag}": sum(len(s.prompt_tokens)
                                                for g in groups for s in g.seqs)})
    return out


def gemma2_ragged_phase(sz: Sizes, device) -> dict:
    """Gemma-2-9B at full width and depth on the ragged backend: K11 on
    first chunks, K12 on every continuation chunk and decode step; never
    K6, K6' or K7."""
    import torch

    from mistralrs_tpu_torch.engine.engine import Engine

    sz = GEMMA2
    t0 = time.perf_counter()
    pipe = gemma2_ragged_pipeline(sz, sz.layers, device)
    if not pipe.kv_combined or pipe.head_major:
        raise AssertionError("attn_backend='ragged' did not build one token-major combined pool")
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    rng = np.random.default_rng(5)
    # warm-up: both waves, one multistep decode call each
    serve_waves(eng, rng, sz.vocab, [(n, plen, 1 + pipe.pc.decode_steps)
                                     for n, plen, _ in RAGGED_WAVES])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    wave_counts = []
    t_run = time.perf_counter()
    waves = serve_waves(eng, rng, sz.vocab, RAGGED_WAVES,
                        after_wave=lambda i: wave_counts.append(read_counts()))
    run_s = time.perf_counter() - t_run
    counts = read_counts()
    n_toks = sum(check_served(g, sz.vocab, max_len, pipe)
                 for (g, _), (_, _, max_len) in zip(waves, RAGGED_WAVES))
    check_launched(counts, PATH_KERNELS["gemma2_ragged"] + ("splash_prefill", "q4k_q8_gemv"))
    for name in ("flash_prefill", "flash_prefill_paged", "paged_decode"):
        if counts[name]:
            raise AssertionError(f"the ragged backend launched {name}: {counts}")
    # K12's both instantiations: chunks on the continuation chunks, decode
    # on the decode steps
    if not 0 < counts["ragged_chunk"] < counts["ragged_attention"]:
        raise AssertionError(f"K12 did not run both its instantiations: {counts}")
    graphs = check_graphed(counts, pipe)
    out = {"phase": "gemma2_ragged", "layers": sz.layers,
           "requests": sum(n for n, _, _ in RAGGED_WAVES), "generated_tokens": n_toks,
           **wave_metrics(waves), "run_s": run_s, "setup_s": setup_s, "launches": counts,
           "launches_long_wave": wave_counts[0], **graphs, "kv_pages": pipe.pc.num_pages,
           "kv_gb": pipe.cache.k.numel() * pipe.cache.k.element_size() / 1e9,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    del eng, pipe
    return out


# ------------------------------------------------------------- phase 6


def _moved(node, dev, dt):
    """A parameter tree on `dev`, its float tensors in `dt`."""
    from mistralrs_tpu_torch.quant.qlinear import Linear

    if node is None:
        return None
    if isinstance(node, Linear):
        return dataclasses.replace(node, data=_moved(node.data, dev, dt))
    if isinstance(node, dict):
        return {k: _moved(v, dev, dt) for k, v in node.items()}
    if isinstance(node, list):
        return [_moved(v, dev, dt) for v in node]
    return node.to(dev, dt) if node.is_floating_point() else node.to(dev)


def _moved_params(p, dev, dt):
    """DecoderParams on `dev`, their float tensors in `dt`."""
    return dataclasses.replace(p, embed=_moved(p.embed, dev, dt), layers=_moved(p.layers, dev, dt),
                               final_norm=_moved(p.final_norm, dev, dt),
                               lm_head=_moved(p.lm_head, dev, dt))


def _side_pipeline(cfg, weights, dev, dt, **kw):
    """A one-sequence pipeline on one side over a copy of `weights`, or, when
    `weights` is a loader (dev, dt) -> (config, params), over what it
    loads there."""
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    if callable(weights):
        cfg, params = weights(dev, dt)
    else:
        params = _moved_params(weights, dev, dt)
    pc = PipelineConfig(max_seqs=1, dtype=dt, device=str(dev), **kw)
    return TextPipeline(cfg, params, make_rope(cfg, pc.max_model_len, device=dev), pc)


def _compare_sides(phase, runs, device, n_layers, **extra) -> dict:
    """The card's logits against the CPU's, step by step, relative to each
    step's largest |logit|."""
    ref, got = runs["cpu"], runs[device.type]
    scale = np.abs(ref).max(axis=1, keepdims=True)
    rel = float((np.abs(got - ref) / scale).max())
    rms = float(np.sqrt(((got - ref) ** 2).mean()) / np.sqrt((ref ** 2).mean()))
    # bf16 activations (2^-8 relative each) and the int8 requantization
    # of activations that differ in their last bits, over 2 layers
    tol = 5e-2
    out = {"phase": phase, "layers": n_layers, "steps": len(ref), "max_rel_err": rel,
           "rel_rms_err": rms, "tol_rel": tol, "finite": bool(np.isfinite(got).all()),
           "argmax_agree": int((ref.argmax(1) == got.argmax(1)).sum()), **extra}
    emit(out)
    if not np.isfinite(got).all() or rel > tol:
        raise AssertionError(f"card and CPU logits differ: {out}")
    return out


def _sides(device):
    """(device, working dtype) of the CPU side, then the card's."""
    import torch

    return ((torch.device("cpu"), torch.float32), (device, torch.bfloat16))


def _token_major_run(cfg, weights, device, prompt, rq8, sides=None, forced=None,
                     **kw) -> tuple[dict, dict]:
    """Logits and launch counts of each side (`sides`, default CPU then card)
    for a 256-token prefill and 4 decode steps (token-major pools), all fed
    the first side's argmax or the tokens `forced`; kw goes to the
    PipelineConfig of every side."""
    from mistralrs_tpu_torch.engine.block_manager import BlockManager
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.engine.sequence import Sequence

    runs, counts = {}, {}
    for dev, dt in sides or _sides(device):
        pipe = _side_pipeline(cfg, weights, dev, dt, page_size=16, num_pages=32,
                              max_model_len=512, prefill_buckets=(256,), rq8_group=rq8, **kw)
        bm = BlockManager(pipe.pc.num_pages, pipe.pc.page_size)
        seq = Sequence(prompt, SamplingParams(max_len=8), max_model_len=512)
        bm.allocate(seq)
        reset_counts()
        logits = [pipe.run_prefill_chunk(seq, prompt)]
        for step in range(4):
            tok = int(np.argmax(logits[-1])) if forced is None else forced[step]
            seq.tokens.append(tok)
            bm.append_slot(seq, 1)
            logits.append(pipe.run_decode([seq])[0])
        if forced is None:  # the first (CPU) run picks the tokens every run feeds
            forced = [int(np.argmax(x)) for x in logits[:4]]
        counts[dev.type] = read_counts()
        runs[dev.type] = np.stack(logits).astype(np.float64)
        del pipe
    return runs, counts[device.type]


def _head_major_run(cfg, weights, device, prompt) -> tuple[dict, dict]:
    """Logits and launch counts of each side on head-major pools: a
    512-token first chunk, a 512-token continuation chunk and 4 decode
    steps, with host arrays straight into the pipeline's step, so the
    tables can be 256 pages wide (span 4096) at a 1,024-token context."""
    page, MP = 16, 256
    table = np.arange(1, MP + 1, dtype=np.int64)[None]
    runs, forced, counts = {}, None, {}
    for dev, dt in _sides(device):
        pipe = _side_pipeline(cfg, weights, dev, dt, page_size=page, num_pages=MP + 1,
                              max_model_len=4096, prefill_buckets=(512,))
        reset_counts()
        logits = []
        steps = [(0, 512), (512, 512)] + [(1024 + j, 1) for j in range(4)]
        for i, (start, T) in enumerate(steps):
            if T > 1:
                ids = prompt[None, start:start + T]
            else:  # the CPU run's argmax, fed to both runs
                tok = int(np.argmax(logits[-1])) if forced is None else forced[i - 2]
                ids = np.asarray([[tok]])
            pos = np.arange(start, start + T)[None]
            slots = table[0][pos // page] * page + pos % page
            out = pipe._run(ids, pos, slots, table, np.asarray([start + T]),
                            np.ones(1, np.float32), np.asarray([T - 1]), first_chunk=start == 0)
            logits.append(out[0].float().cpu().numpy())
        if forced is None:
            forced = [int(np.argmax(x)) for x in logits[1:5]]
        counts[dev.type] = read_counts()
        runs[dev.type] = np.stack(logits).astype(np.float64)
        del pipe
    return runs, counts[device.type]


def card_vs_cpu_phase(sz: Sizes, device) -> list[dict]:
    """Same port code and identical weights on the card (kernels, bf16) and
    the CPU (plain versions, f32): a 256-token prefill and 4 decode steps on
    token-major pools, in the Q4_K_M mix (rq8), in the Q5_K_M mix with
    Q6_K kept (on the card K9 and K4 at 256 rows, then K9 and K3), in the
    same with int8_activations=False (K5, K9b and K4 at 256 rows, then at
    1: the rows and the decode instantiations of K4 and K9b, the latter the
    whole Q5_K product; no int8 GEMV)
    and in the Q2_K mix (rq8; K10, K1 and K2 at every step); then, on
    head-major pools, a 512-token first chunk (K6), a 512-token continuation
    chunk (K6') and 4 decode steps (K7) with tables 256 pages wide."""
    import torch

    n_layers = 2
    cfg = model_config(sz, n_layers)
    gen = torch.Generator().manual_seed(5)
    # weights made once on the CPU; float values rounded to bf16 so that
    # both sides hold the same numbers
    base = random_q4km_params(sz, n_layers, torch.device("cpu"), gen, torch.bfloat16)
    base_q5km = random_q5km_params(sz, n_layers, torch.device("cpu"), gen, torch.bfloat16)
    base_q2k = random_q2k_params(sz, n_layers, torch.device("cpu"), gen, torch.bfloat16)

    prompt = [int(t) for t in np.random.default_rng(3).integers(1, sz.vocab, 256)]
    outs = []
    q5km_bf16 = ("q6k_bf16_gemv", "q6k_bf16_gemv_rows", "q5k_bf16_gemv", "q4k_bf16_gemv_rows",
                 "q5k_hbit_bf16_gemv_rows")
    for phase, weights, rq8, int8, names in (
            ("card_vs_cpu", base, 32, True, ("q4k_q8_gemv", "q8_0_q8_gemv", "q4k_q8_gemv_rows",
                                             "q8_0_q8_gemv_rows")),
            ("card_vs_cpu_q5km", base_q5km, None, True,
             ("q6k_q8_gemv", "q6k_bf16_gemv_rows", "q5k_q8_gemv")),
            ("card_vs_cpu_q5km_bf16", base_q5km, None, False, q5km_bf16),
            ("card_vs_cpu_q2k", base_q2k, 32, True, ("affine_gemv", "q4k_q8_gemv", "q8_0_q8_gemv"))):
        runs, card = _token_major_run(cfg, weights, device, prompt, rq8, int8_activations=int8)
        check_launched(card, names)
        if not int8 and any(card[k] for k in INT8_COUNTERS):
            raise AssertionError(f"int8_activations=False launched an int8 GEMV: {card}")
        outs.append(_compare_sides(phase, runs, device, n_layers,
                                   launches={n: card[n] for n in names}))

    # long context
    prompt = np.random.default_rng(4).integers(1, sz.vocab, 1024)
    runs, card = _head_major_run(cfg, base, device, prompt)
    want = {"flash_prefill": n_layers, "flash_prefill_paged": n_layers,
            "paged_decode": 4 * n_layers}
    if any(card[n] != k for n, k in want.items()):
        raise AssertionError(f"the long-context check took other routes on the card: {card}")
    outs.append(_compare_sides("card_vs_cpu_long", runs, device, n_layers,
                               launches={n: card[n] for n in want}))
    return outs


def card_vs_cpu_bf16_phase(sz: Sizes, device) -> list[dict]:
    """The card against the CPU with int8_activations=False: a 2-layer
    Mistral-7B GGUF at full width in the Q4_K_M rule (K5 alone, K8 for
    the requantized Q6_K: K5's decode instantiation's served path) and one
    in the Q5_K_M rule (K5 + K9b's rows instantiations at 256 rows, K9b's
    decode one, the whole Q5_K product, at decode; K8), written by the
    port's writer and loaded by load_gguf_model on each side (bf16 on the
    card, f32 on the CPU): a 256-token prefill and 4 decode steps on
    token-major pools, rq8_group=32. No int8 GEMV may launch, nor K5's
    decode instantiation in the Q5_K_M run. As a control, the same files
    with int8_activations=True (K1, K9, K2): what the int8 rounding adds on
    the same weights."""
    import os
    import tempfile

    from mistralrs_tpu_torch.pipeline.gguf import load_gguf_model

    n_layers = 2
    prompt = [int(t) for t in np.random.default_rng(13).integers(1, sz.vocab, 256)]
    bf16 = ("q4k_bf16_gemv", "q5k_bf16_gemv", "q8_0_bf16_gemv")
    outs = []
    for mix, base, names, absent in (
            ("q4km", "Q4_K", ("q4k_bf16_gemv", "q8_0_bf16_gemv"), ("q5k_bf16_gemv",)),
            ("q5km", "Q5_K", ("q5k_bf16_gemv", "q8_0_bf16_gemv"), ("q4k_bf16_gemv",))):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"mistral-2l-{base}.gguf")
            write_random_gguf(path, sz, n_layers, base, seed=14)

            def load(dev, dt):
                cfg, params, _, _ = load_gguf_model(path, dtype=dt, device=dev)
                return cfg, params

            for int8 in (False, True):
                runs, card = _token_major_run(None, load, device, prompt, 32,
                                              int8_activations=int8)
                want, never = ((("q4k_q8_gemv" if mix == "q4km" else "q5k_q8_gemv",
                                 "q8_0_q8_gemv"), bf16) if int8 else
                               (names, INT8_COUNTERS + absent))
                check_launched(card, want)
                if any(card[k] for k in never):
                    raise AssertionError(f"int8_activations={int8} took the other route: {card}")
                outs.append(_compare_sides(f"card_vs_cpu_{'int8' if int8 else 'bf16'}_{mix}",
                                           runs, device, n_layers,
                                           launches={k: card[k] for k in want}))
    return outs


def card_vs_cpu_gemma2_phase(sz: Sizes, device) -> list[dict]:
    """The same comparison for a 2-layer Gemma-2-9B at full width and the
    full vocabulary (layer 0 local, layer 1 global; the f32 tied embedding
    is 3.7 GB of host memory): on token-major pools a 256-token first chunk
    (K11 on the card) and 4 decode steps (K1, gather + the soft cap); on
    head-major pools a 512-token first chunk (K11), a 512-token continuation
    chunk (gather + the soft cap: K6' rejects it) and 4 decode steps at span
    4096 (K7 with the soft cap at head dim 256)."""
    import torch

    n_layers = 2
    sz = GEMMA2
    cfg = gemma2_config(sz, n_layers)
    gen = torch.Generator().manual_seed(6)
    base = random_gemma2_params(sz, n_layers, torch.device("cpu"), gen, torch.bfloat16)
    prompt = [int(t) for t in np.random.default_rng(3).integers(1, sz.vocab, 256)]
    runs, card = _token_major_run(cfg, base, device, prompt, 32)
    want = {"splash_prefill": n_layers, "flash_prefill": 0}
    if any(card[n] != k for n, k in want.items()) or not card["q4k_q8_gemv"]:
        raise AssertionError(f"the Gemma-2 check took other routes on the card: {card}")
    outs = [_compare_sides("card_vs_cpu_gemma2", runs, device, n_layers, vocab=sz.vocab,
                           launches={n: card[n] for n in ("splash_prefill", "q4k_q8_gemv")})]
    prompt = np.random.default_rng(4).integers(1, sz.vocab, 1024)
    runs, card = _head_major_run(cfg, base, device, prompt)
    want = {"splash_prefill": n_layers, "paged_decode": 4 * n_layers, "flash_prefill": 0,
            "flash_prefill_paged": 0}
    if any(card[n] != k for n, k in want.items()):
        raise AssertionError(f"the Gemma-2 long-context check took other routes: {card}")
    outs.append(_compare_sides("card_vs_cpu_gemma2_long", runs, device, n_layers,
                               vocab=sz.vocab, launches={n: card[n] for n in want}))
    return outs


def _ragged_run(cfg, weights, device, prompt, rq8) -> tuple[dict, dict]:
    """Logits and launch counts of each side on the ragged backend: a
    ~1,200-token prompt in chunks of 512, 512 and the rest (padded to 256),
    then 4 decode steps, both fed the CPU run's argmax."""
    from mistralrs_tpu_torch.engine.block_manager import BlockManager
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.engine.sequence import Sequence

    runs, forced, counts = {}, None, {}
    for dev, dt in _sides(device):
        pipe = _side_pipeline(cfg, weights, dev, dt, page_size=16, num_pages=96,
                              max_model_len=2048, prefill_buckets=(256, 512), rq8_group=rq8,
                              attn_backend="ragged")
        bm = BlockManager(pipe.pc.num_pages, pipe.pc.page_size)
        seq = Sequence(prompt, SamplingParams(max_len=8), max_model_len=2048)
        bm.allocate(seq)
        reset_counts()
        logits, start = [], 0
        for n in (512, 512, len(prompt) - 1024):
            logits.append(pipe.run_prefill_chunk(seq, prompt[start:start + n]))
            start += n
        for step in range(4):
            tok = int(np.argmax(logits[-1])) if forced is None else forced[step]
            seq.tokens.append(tok)
            bm.append_slot(seq, 1)
            logits.append(pipe.run_decode([seq])[0])
        if forced is None:
            forced = [int(np.argmax(x)) for x in logits[2:6]]
        counts[dev.type] = read_counts()
        runs[dev.type] = np.stack(logits).astype(np.float64)
        del pipe
    return runs, counts[device.type]


# the ragged card_vs_cpu prompt: a 512 first chunk, a 512 continuation and
# a ragged 176 padded to 256
RAGGED_PROMPT = 1200


def card_vs_cpu_ragged_phase(sz: Sizes, device) -> list[dict]:
    """The card against the CPU on the ragged backend, 2 layers at full
    width: Mistral-7B Q4_K_M (rq8; K6 on the first chunk) and Gemma-2-9B
    (the full vocabulary; K11 on the first chunk); K12 on both continuation
    chunks and the 4 decode steps (its plain version on the CPU)."""
    import torch

    n_layers = 2
    outs = []
    for phase, size, build, cfg_fn, rq8, first in (
            ("card_vs_cpu_ragged", sz, random_q4km_params, model_config, 32, "flash_prefill"),
            ("card_vs_cpu_ragged_gemma2", GEMMA2, random_gemma2_params, gemma2_config, 32,
             "splash_prefill")):
        cfg = cfg_fn(size, n_layers)
        weights = build(size, n_layers, torch.device("cpu"), torch.Generator().manual_seed(8),
                        torch.bfloat16)
        prompt = [int(t) for t in np.random.default_rng(9).integers(1, size.vocab, RAGGED_PROMPT)]
        runs, card = _ragged_run(cfg, weights, device, prompt, rq8)
        # K12: chunks on the two continuation chunks, decode on the 4 steps
        want = {first: n_layers, "ragged_attention": 6 * n_layers, "ragged_chunk": 2 * n_layers,
                "flash_prefill_paged": 0, "paged_decode": 0}
        if any(card[n] != k for n, k in want.items()):
            raise AssertionError(f"the ragged check took other routes on the card: {card}")
        outs.append(_compare_sides(phase, runs, device, n_layers, vocab=size.vocab,
                                   launches={n: card[n] for n in want}))
        del weights
    return outs


def card_vs_cpu_mixtral_phase(sz: Sizes, device) -> list[dict]:
    """The card against the CPU for 1-layer Mixtral-8x7B at full width
    (token-major pools, rq8): a 256-token prefill and 4 decode steps with
    dense bf16 experts (the grouped dispatch: K13 for gate, up and down in
    every step, K6 on the prefill) and with packed Q4_K experts (K1 for
    every expert, K13 never). The weights are made on the card and copied
    to the CPU (f32 there: 5.6 GB for the dense experts). One layer, not
    two: the CPU side's f32 experts take most of the run's time."""
    import torch

    n_layers = 1
    cfg = mixtral_config(MIXTRAL, n_layers)
    prompt = [int(t) for t in np.random.default_rng(10).integers(1, MIXTRAL.vocab, 256)]
    outs = []
    for phase, packed in (("card_vs_cpu_mixtral", False), ("card_vs_cpu_mixtral_q4km", True)):
        free_card_memory()
        weights = random_mixtral_params(MIXTRAL, n_layers, device,
                                        torch.Generator(device=device).manual_seed(11),
                                        torch.bfloat16, packed=packed)
        runs, card = _token_major_run(cfg, weights, device, prompt, 32)
        del weights
        k13 = 0 if packed else 3 * n_layers * 5
        if card["grouped_gemm"] != k13 or card["flash_prefill"] != n_layers or \
                k1_k2_launches(card)[0] < (24 * n_layers * 5 if packed else 1):
            raise AssertionError(f"the Mixtral check took other routes on the card: {card}")
        outs.append(_compare_sides(phase, runs, device, n_layers, launches={
            n: card[n] for n in ("grouped_gemm", "flash_prefill", "q4k_q8_gemv")}))
    return outs


# ------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    from mistralrs_tpu_torch.ops import kernels

    sz = Sizes()
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    t0 = time.perf_counter()
    kernels.build()
    regs = {n: [int(x.split()[0]) for x in kernels.build_log(n).split("Used ")[1:]]
            for n in kernels.SOURCES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "max_registers": {n: max(r) if r else None for n, r in regs.items()}})

    seconds = {}
    t0 = time.perf_counter()
    results = kernel_phase(sz, device, Clock(device))
    seconds["kernels"] = time.perf_counter() - t0
    for name, fn in (("slice", slice_phase), ("decode_graph", decode_graph_phase),
                     ("speculative", speculative_phase),
                     ("long_context", long_context_phase), ("long_kv", long_kv_phase),
                     ("quant_mix", quant_mix_phase), ("q2k", q2k_phase),
                     ("gguf_bf16", gguf_bf16_phase),
                     ("gemma2", gemma2_phase), ("hf_isq", hf_isq_phase),
                     ("card_vs_cpu_isq", card_vs_cpu_isq_phase),
                     ("gemma2_ragged", gemma2_ragged_phase),
                     ("mixtral", mixtral_phase), ("mixtral_q4km", mixtral_q4km_phase),
                     ("card_vs_cpu", card_vs_cpu_phase),
                     ("card_vs_cpu_bf16", card_vs_cpu_bf16_phase),
                     ("card_vs_cpu_gemma2", card_vs_cpu_gemma2_phase),
                     ("card_vs_cpu_ragged", card_vs_cpu_ragged_phase),
                     ("card_vs_cpu_mixtral", card_vs_cpu_mixtral_phase)):
        t0 = time.perf_counter()
        results[name] = fn(sz, device)
        seconds[name] = time.perf_counter() - t0
    emit({"phase": "seconds", **seconds})
    # the paths inside a phase of several runs (card_vs_cpu's bf16 Q5_K_M run,
    # card_vs_cpu_bf16's Q4_K_M run)
    results.update({o["phase"]: o for phase in ("card_vs_cpu", "card_vs_cpu_bf16")
                    for o in results[phase] if o["phase"] in PATH_KERNELS})

    line = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rows = results[name]
        head = next(r for r in rows if r["shape"] == HEADLINE[name])
        # each kernel's launches in the run of the path it belongs to
        path = next(p for p, names in PATH_KERNELS.items() if name in names)
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": results[path]["launches"][name], "launches_path": path,
                     "max_abs_err": max(r["max_abs_err"] for r in rows),
                     "shape": head["shape"], "ms": head["ms"], "plain_ms": head["plain_ms"],
                     "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                     "library_ms": head["library_ms"]})
    emit(results["gemv_decode"])
    print(smi, flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
