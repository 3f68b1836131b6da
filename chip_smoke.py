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
   shapes of a Mistral-7B Q4_K_M decode step (batch 16 and 1) and of a
   prefill chunk of 256 rows (the most the GEMVs take), of first
   prefill chunks and of the prefill route's dequantization, with the
   tolerance stated; then kernel, plain-version and library-call times (CUDA
   events, median of 25 runs, L2 flushed before each) beside the least time
   the card could take (bound).
4. slice: the 32-layer Mistral-7B Q4_K_M model with random packed weights
   (the value ranges of bench.py), fused and Q6_K->int8 requantized by the
   pipeline, serves 8 greedy requests through Engine/TextPipeline: ~200-token
   prompts (first chunk on the flash kernel) and ~40-token prompts (gather +
   sdpa). The launch counts are set to 0 just before and read just after.
   tests/test_torch_chip_smoke.py runs the model builders at a tiny size on
   the CPU.
5. card_vs_cpu: a 2-layer full-width model with identical weights on the card
   (kernels, bf16) and on the CPU (plain versions, f32): one 256-token
   prefill and 4 decode steps, logits compared.
Then the kernels line and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

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
    "flash_prefill": ("mistralrs_tpu_torch/csrc/flash_prefill.cu",
                      "mistralrs_tpu/models/decoder.py:416"),
    # not TPU kernels: the dequantization XLA fuses on the JAX prefill route
    "q4k_dequant": ("mistralrs_tpu_torch/csrc/q4k_q8_gemv.cu",
                    "mistralrs_tpu/quant/gguf_linear.py:454"),
    "q8_0_dequant": ("mistralrs_tpu_torch/csrc/q8_0_q8_gemv.cu",
                     "mistralrs_tpu/quant/gguf_linear.py:525"),
}
# the shape whose numbers stand in the kernels line
HEADLINE = {"q4k_q8_gemv": "gate|up B=16", "q8_0_q8_gemv": "lm_head B=16",
            "flash_prefill": "B=4 T=512", "q4k_dequant": "gate|up",
            "q8_0_dequant": "down rq8"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    # ragged 200, the slice's batched first chunk of 4 x 256, and 16 x 256
    flash_cases: tuple = ((4, 512, 32, 8), (1, 200, 32, 8), (4, 256, 32, 8), (16, 256, 32, 8))


# ------------------------------------------------------------- model


def use_more_bits(i: int, n: int) -> bool:
    """llama.cpp use_more_bits(): the ffn_down layers Q4_K_M puts in Q6_K."""
    return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2


def random_q4km_params(sz: Sizes, n_layers: int, device, gen, fdt):
    """Random packed weights in the device layouts with the Q4_K_M type mix
    (attn_v, lm_head and the use_more_bits ffn_down in Q6_K, the rest Q4_K),
    value ranges as bench.py: scales U[0.001, 0.005), mins U[0, 0.002)."""
    import torch

    from mistralrs_tpu_torch.models.decoder import DecoderParams
    from mistralrs_tpu_torch.quant.gguf_linear import q6k_chunk_size, q6k_perm
    from mistralrs_tpu_torch.quant.qlinear import Linear

    def u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=gen)

    def unif(lo, hi, *shape):
        return (torch.rand(shape, device=device, generator=gen) * (hi - lo) + lo).to(fdt)

    def q4k(i, o):
        return Linear("gguf_q4k", (i, o), {"qs": u8(i // 2, o), "scale": unif(0.001, 0.005, i // 32, o),
                                           "minv": unif(0.0, 0.002, i // 32, o)})

    def q6k(i, o):
        G = q6k_chunk_size(i)
        perm = torch.from_numpy(q6k_perm(i, G)).to(device)
        return Linear("gguf_q6k", (i, o), {"ql": u8(i // 2, o), "qh": u8(i // 4, o),
                                           "scale": unif(0.001, 0.005, i // 16, o),
                                           "perm": perm, "inv_perm": torch.argsort(perm)}, meta=G)

    H, I, D = sz.hidden, sz.inter, sz.head_dim
    ones = torch.ones(H, dtype=fdt, device=device)
    layers = []
    for i in range(n_layers):
        layers.append({
            "attn": {"q": q4k(H, sz.heads * D), "k": q4k(H, sz.kv_heads * D),
                     "v": q6k(H, sz.kv_heads * D), "o": q4k(sz.heads * D, H)},
            "mlp": {"gate": q4k(H, I), "up": q4k(H, I),
                    "down": (q6k if use_more_bits(i, sz.layers) else q4k)(I, H)},
            "input_norm": {"w": ones}, "post_attn_norm": {"w": ones},
        })
    return DecoderParams(embed=unif(0.001, 0.005, sz.vocab, H), layers=layers,
                         final_norm={"w": ones}, lm_head=q6k(H, sz.vocab))


def model_config(sz: Sizes, n_layers: int):
    from mistralrs_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="mistral", vocab_size=sz.vocab, hidden_size=sz.hidden,
                       intermediate_size=sz.inter, num_layers=n_layers, num_heads=sz.heads,
                       num_kv_heads=sz.kv_heads, head_dim=sz.head_dim,
                       max_position_embeddings=4096, rope_theta=1e6)


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


def bound(bytes_moved: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------- phase 3


def kernel_phase(sz: Sizes, device, clock: Clock) -> dict:
    """Parity and timing of K1, K2, K6 at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from mistralrs_tpu_torch.ops import flash_attention as fa
    from mistralrs_tpu_torch.ops import quant_matmul as qm
    from mistralrs_tpu_torch.quant.gguf_linear import dequant_q4k_weights, dequant_q8_0_gs_weights
    from mistralrs_tpu_torch.quant.qlinear import Linear

    gen = torch.Generator(device=device).manual_seed(7)
    H, I, D = sz.hidden, sz.inter, sz.head_dim
    fdt = torch.bfloat16
    results: dict[str, list] = {k: [] for k in KERNEL_INFO}

    def rand(*shape, lo=0.0, hi=1.0, dtype=torch.float32):
        return (torch.rand(shape, device=device, generator=gen) * (hi - lo) + lo).to(dtype)

    def record(name, shape_name, err, rel, tol, ms, plain_ms, lib_ms, bnd):
        row = {"phase": "kernel", "name": name, "shape": shape_name, "max_abs_err": err,
               "max_rel_err": rel, "tol_rel": tol, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
        emit(row)
        if rel > tol:
            raise AssertionError(f"{name} {shape_name}: relative error {rel} > {tol}")
        results[name].append(row)

    # K1: every Q4_K projection of a decode step (fused q|k, o, gate|up, down)
    q4k_shapes = [("qk", H, (sz.heads + sz.kv_heads) * D), ("o", sz.heads * D, H),
                  ("gate|up", H, 2 * I), ("down", I, H)]
    for B in (16, 1, 256):
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
            record("q4k_q8_gemv", f"{nm} B={B}", err, rel, 1e-5, ms, plain, lib,
                   bound(nbytes, 2 * B * K * O, PEAK_INT8))
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
    for B in (16, 1, 256):
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
            record("q8_0_q8_gemv", f"{nm} B={B}", err, rel, 1e-5, ms, plain, lib,
                   bound(nbytes, 2 * B * K * O, PEAK_INT8))
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

    # K6: first prefill chunks
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
    return results


# ------------------------------------------------------------- phase 4


def slice_phase(sz: Sizes, device) -> dict:
    import torch

    from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.ops import flash_attention as fa
    from mistralrs_tpu_torch.ops import quant_matmul as qm
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    fdt = torch.bfloat16
    cfg = model_config(sz, sz.layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = random_q4km_params(sz, sz.layers, device, gen, fdt)
    pc = PipelineConfig(page_size=16, num_pages=512, max_seqs=16, max_model_len=2048,
                        prefill_buckets=(64, 256), decode_steps=8, dtype=fdt,
                        device=str(device))
    pipe = TextPipeline(cfg, params, make_rope(cfg, 2048, device=device), pc)
    del params  # the pipeline holds the fused, requantized copy
    kinds = sorted({lin.kind for lp in pipe.params.layers for part in ("attn", "mlp")
                    for lin in lp[part].values()} | {pipe.params.lm_head.kind})
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    rng = np.random.default_rng(1)

    def serve(max_len: int, decode: dict) -> list:
        """4 long prompts, then 4 short ones once the long have prefilled;
        decode-only steps add their tokens and seconds to `decode`."""
        groups = []

        def seqs():
            return [s for g in groups for s in g.seqs]

        def run_until(done):
            while not done():
                prefill = any(s.state.value in ("waiting", "running_prefill") for s in seqs())
                before = sum(s.num_generated for s in seqs())
                t = time.perf_counter()
                eng.step()
                dt = time.perf_counter() - t
                if not prefill:
                    decode["tokens"] += sum(s.num_generated for s in seqs()) - before
                    decode["seconds"] += dt

        def add(n_req, plen):
            for _ in range(n_req):
                n = int(plen + rng.integers(-8, 9))
                groups.append(eng.add_request(GenerationRequest(
                    [int(t) for t in rng.integers(1, sz.vocab, n)], SamplingParams(max_len=max_len))))

        add(4, sz.long_prompt)  # first chunk of 4 x 256 rows -> flash prefill
        run_until(lambda: all(s.state.value not in ("waiting", "running_prefill") for s in seqs()))
        add(4, sz.short_prompt)  # chunk of 4 x 64 rows -> gather + sdpa
        run_until(lambda: all(g.all_done() for g in groups))
        return groups

    # warm-up: the same pattern, so the run measures a warm server (first
    # use of a kernel or a GEMM shape costs up to ~0.2 s of host time)
    serve(2, {"tokens": 0, "seconds": 0.0})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    qm.q4k_q8_gemv_launches = qm.q8_0_q8_gemv_launches = fa.flash_prefill_launches = 0
    qm.q4k_dequant_launches = qm.q8_0_dequant_launches = 0
    decode = {"tokens": 0, "seconds": 0.0}
    t_run = time.perf_counter()
    groups = serve(sz.max_len, decode)
    run_s = time.perf_counter() - t_run
    counts = {"q4k_q8_gemv": qm.q4k_q8_gemv_launches, "q8_0_q8_gemv": qm.q8_0_q8_gemv_launches,
              "flash_prefill": fa.flash_prefill_launches,
              "q4k_dequant": qm.q4k_dequant_launches, "q8_0_dequant": qm.q8_0_dequant_launches}

    seqs = [s for g in groups for s in g.seqs]
    toks = [t for s in seqs for t in s.generated_tokens]
    if not all(0 <= t < sz.vocab for t in toks):
        raise AssertionError("a generated token is outside the vocabulary")
    if any(s.num_generated != sz.max_len or s.stop_reason.value != "length" for s in seqs):
        raise AssertionError("a request did not generate max_len tokens")
    if not np.isfinite(pipe.last_greedy_pack).all():
        raise AssertionError("non-finite logits")
    for name, n in counts.items():
        if n < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    def ttft_ms(gs):
        return 1e3 * statistics.median(s.prompt_timestamp - s.timestamp for g in gs for s in g.seqs)

    out = {"phase": "slice", "layers": sz.layers, "kinds": kinds, "requests": len(groups),
           "generated_tokens": len(toks), "decode_tok_s": decode["tokens"] / decode["seconds"],
           "decode_tokens": decode["tokens"], "decode_s": decode["seconds"],
           "p50_ttft_ms": ttft_ms(groups), "p50_ttft_ms_long": ttft_ms(groups[:4]),
           "p50_ttft_ms_short": ttft_ms(groups[4:]), "run_s": run_s, "setup_s": setup_s,
           "launches": counts, "decode_steps_per_call": pc.decode_steps, "max_seqs": pc.max_seqs,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    del eng, pipe
    return out


# ------------------------------------------------------------- phase 5


def card_vs_cpu_phase(sz: Sizes, device) -> dict:
    """Same port code and identical weights on the card (kernels, bf16) and
    the CPU (plain versions, f32)."""
    import dataclasses

    import torch

    from mistralrs_tpu_torch.engine.block_manager import BlockManager
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.engine.sequence import Sequence
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
    from mistralrs_tpu_torch.quant.qlinear import Linear

    n_layers = 2
    cfg = model_config(sz, n_layers)
    gen = torch.Generator().manual_seed(5)
    # weights made once on the CPU; float values rounded to bf16 so that
    # both sides hold the same numbers
    base = random_q4km_params(sz, n_layers, torch.device("cpu"), gen, torch.bfloat16)

    def moved(node, dev, dt):
        if isinstance(node, Linear):
            return dataclasses.replace(node, data=moved(node.data, dev, dt))
        if isinstance(node, dict):
            return {k: moved(v, dev, dt) for k, v in node.items()}
        if isinstance(node, list):
            return [moved(v, dev, dt) for v in node]
        return node.to(dev, dt) if node.is_floating_point() else node.to(dev)

    prompt = [int(t) for t in np.random.default_rng(3).integers(1, sz.vocab, 256)]
    runs = {}
    forced = None
    for dev, dt in ((torch.device("cpu"), torch.float32), (device, torch.bfloat16)):
        params = dataclasses.replace(base, embed=moved(base.embed, dev, dt),
                                     layers=moved(base.layers, dev, dt),
                                     final_norm=moved(base.final_norm, dev, dt),
                                     lm_head=moved(base.lm_head, dev, dt))
        pc = PipelineConfig(page_size=16, num_pages=32, max_seqs=1, max_model_len=512,
                            prefill_buckets=(256,), dtype=dt, device=str(dev))
        pipe = TextPipeline(cfg, params, make_rope(cfg, 512, device=dev), pc)
        bm = BlockManager(pc.num_pages, pc.page_size)
        seq = Sequence(prompt, SamplingParams(max_len=8), max_model_len=512)
        bm.allocate(seq)
        logits = [pipe.run_prefill_chunk(seq, prompt)]
        for step in range(4):
            tok = int(np.argmax(logits[-1])) if forced is None else forced[step]
            seq.tokens.append(tok)
            bm.append_slot(seq, 1)
            logits.append(pipe.run_decode([seq])[0])
        if forced is None:  # the CPU run picks the tokens both runs feed
            forced = [int(np.argmax(x)) for x in logits[:4]]
        runs[dev.type] = np.stack(logits).astype(np.float64)
        del pipe, params
    ref, got = runs["cpu"], runs[device.type]
    scale = np.abs(ref).max(axis=1, keepdims=True)
    rel = float((np.abs(got - ref) / scale).max())
    rms = float(np.sqrt(((got - ref) ** 2).mean()) / np.sqrt((ref ** 2).mean()))
    # bf16 activations (2^-8 relative each) and the int8 requantization of
    # activations that differ in their last bits, over 2 layers
    tol = 5e-2
    out = {"phase": "card_vs_cpu", "layers": n_layers, "steps": len(ref), "max_rel_err": rel,
           "rel_rms_err": rms, "tol_rel": tol, "finite": bool(np.isfinite(got).all()),
           "argmax_agree": int((ref.argmax(1) == got.argmax(1)).sum())}
    emit(out)
    if not np.isfinite(got).all() or rel > tol:
        raise AssertionError(f"card and CPU logits differ: {out}")
    return out


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

    results = kernel_phase(sz, device, Clock(device))
    sl = slice_phase(sz, device)
    card_vs_cpu_phase(sz, device)

    line = []
    for name, (source, replaces) in KERNEL_INFO.items():
        rows = results[name]
        head = next(r for r in rows if r["shape"] == HEADLINE[name])
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": sl["launches"][name],
                     "max_abs_err": max(r["max_abs_err"] for r in rows),
                     "shape": head["shape"], "ms": head["ms"], "plain_ms": head["plain_ms"],
                     "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                     "library_ms": head["library_ms"]})
    print(smi, flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
