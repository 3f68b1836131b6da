"""chip_smoke.py's model builders at a tiny size on the CPU, and its refusal
to run without a CUDA card.

The card run builds the same Q4_K_M-, Q5_K_M- and Q2_K-mix models at full
Mistral-7B width; here the builders run at hidden 512 so a fault in them
shows before a card is asked for. The served model must reach the pipeline
as the mix it claims to be: Q4_K (or Q5_K) everywhere but attn_v, the
use_more_bits ffn_down layers and the lm_head, which are Q6_K: the Q4_K_M
pipeline requantizes them to int8 per 32, the Q5_K_M one keeps them. The
Q2_K mix has Q2_K q, k, gate and up, Q4_K v, Q3_K o and down (in the Q6_K
layout) and a Q6_K lm_head, the last three requantized to int8 per 32.

The Gemma-2 and ragged-backend builders' tests are in
test_torch_chip_smoke_gemma2.py, Mixtral's in test_torch_chip_smoke_mixtral.py,
the GGUF files' and the bf16 kernel groups' in test_torch_chip_smoke_gguf.py:
test workers run the four files side by side.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke_tiny import TINY
from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
from torch_port_model import one_thread  # noqa: F401 (a fixture)


def _params(n_layers):
    gen = torch.Generator().manual_seed(0)
    return chip_smoke.random_q4km_params(TINY, n_layers, torch.device("cpu"), gen, torch.float32)


@pytest.mark.parametrize("i", range(8))
def test_builder_puts_the_q4km_mix_in_each_layer(i):
    layer = _params(8).layers[i]
    kinds = {k: lin.kind for part in ("attn", "mlp") for k, lin in layer[part].items()}
    down = "gguf_q6k" if chip_smoke.use_more_bits(i, 8) else "gguf_q4k"
    assert kinds == {"q": "gguf_q4k", "k": "gguf_q4k", "v": "gguf_q6k", "o": "gguf_q4k",
                     "gate": "gguf_q4k", "up": "gguf_q4k", "down": down}
    q = layer["attn"]["q"]
    assert q.shape == (512, 4 * 128) and q.data["qs"].shape == (256, 512)
    assert float(q.data["scale"].min()) >= 0.001 and float(q.data["scale"].max()) < 0.005


def test_builder_model_serves_through_the_engine():
    """Two layers of the tiny model, fused and requantized by the pipeline,
    serve a long and a short prompt with the plain versions."""
    cfg = chip_smoke.model_config(TINY, 2)
    pc = PipelineConfig(page_size=16, num_pages=64, max_seqs=4, max_model_len=512,
                        prefill_buckets=(64, 256), decode_steps=4, dtype=torch.float32,
                        device="cpu")
    pipe = TextPipeline(cfg, _params(2), make_rope(cfg, 512, device="cpu"), pc)
    layer = pipe.params.layers[0]
    assert set(layer["attn"]) == {"qk", "v", "o"} and set(layer["mlp"]) == {"gateup", "down"}
    assert layer["attn"]["v"].kind == "gguf_q8_0" and pipe.params.lm_head.kind == "gguf_q8_0"
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    rng = np.random.default_rng(1)
    groups = [eng.add_request(GenerationRequest([int(t) for t in rng.integers(1, TINY.vocab, n)],
                                                SamplingParams(max_len=6)))
              for n in (150, 40)]
    while not all(g.all_done() for g in groups):
        eng.step()
    for g in groups:
        (seq,) = g.seqs
        assert seq.num_generated == 6
        assert all(0 <= t < TINY.vocab for t in seq.generated_tokens)
    assert np.isfinite(pipe.last_greedy_pack).all()


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("head_major", [True, False])
def test_paged_inputs_give_each_row_its_own_pages(head_major):
    """The K6'/K7 inputs of the kernel phase: tables as wide as the pipeline
    makes them (a power of two of pages covering kv_len), distinct pages,
    page 0 unused, pools of the layout asked for."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, meta = chip_smoke.paged_inputs(TINY, torch.device("cpu"), gen, 3, 2, 1000, head_major)
    B, MP = meta.block_tables.shape
    assert (B, MP) == (3, 64) and q.shape == (3, 2, TINY.heads, TINY.head_dim)
    pages = meta.block_tables.flatten()
    assert len(set(pages.tolist())) == B * MP and int(pages.min()) == 1
    P = 1 + B * MP
    want = (TINY.kv_heads, P, 16, 128) if head_major else (P, 16, TINY.kv_heads, 128)
    assert tuple(k.shape) == tuple(v.shape) == want and meta.head_major == head_major
    assert meta.kv_lens.tolist() == [1000] * 3


@pytest.mark.parametrize("i", range(8))
def test_builder_puts_the_q5km_mix_in_each_layer(i):
    gen = torch.Generator().manual_seed(0)
    layer = chip_smoke.random_q5km_params(TINY, 8, torch.device("cpu"), gen,
                                          torch.float32).layers[i]
    kinds = {k: lin.kind for part in ("attn", "mlp") for k, lin in layer[part].items()}
    down = "gguf_q6k" if chip_smoke.use_more_bits(i, 8) else "gguf_q5k"
    assert kinds == {"q": "gguf_q5k", "k": "gguf_q5k", "v": "gguf_q6k", "o": "gguf_q5k",
                     "gate": "gguf_q5k", "up": "gguf_q5k", "down": down}
    q = layer["attn"]["q"]
    assert q.data["qs"].shape == (256, 512) and q.data["qh"].shape == (64, 512)
    assert q.data["qh"].dtype == torch.uint8


def test_q5km_builder_model_serves_with_q6k_kept():
    """The quant_mix phase's model at a tiny size: two layers, Q6_K kept
    (rq8_group=None), a 150- and a 40-token prompt through the plain K3, K4
    and K9."""
    from mistralrs_tpu_torch.ops import quant_matmul as qm

    cfg = chip_smoke.model_config(TINY, 2)
    pc = PipelineConfig(page_size=16, num_pages=64, max_seqs=4, max_model_len=512,
                        prefill_buckets=(64, 256), decode_steps=4, dtype=torch.float32,
                        device="cpu", rq8_group=None)
    gen = torch.Generator().manual_seed(0)
    params = chip_smoke.random_q5km_params(TINY, 2, torch.device("cpu"), gen, torch.float32)
    pipe = TextPipeline(cfg, params, make_rope(cfg, 512, device="cpu"), pc)
    layer = pipe.params.layers[0]
    assert layer["attn"]["qk"].kind == layer["mlp"]["gateup"].kind == "gguf_q5k"
    assert layer["attn"]["v"].kind == pipe.params.lm_head.kind == "gguf_q6k"
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    rng = np.random.default_rng(1)
    groups = [eng.add_request(GenerationRequest([int(t) for t in rng.integers(1, TINY.vocab, n)],
                                                SamplingParams(max_len=6)))
              for n in (150, 40)]
    while not all(g.all_done() for g in groups):
        eng.step()
    assert all(g.seqs[0].num_generated == 6 for g in groups)
    assert np.isfinite(pipe.last_greedy_pack).all()
    # the plain versions ran: no launch was counted on the CPU
    assert qm.q5k_q8_gemv_launches == qm.q5k_q8_gemv_rows_launches == qm.q6k_q8_gemv_launches == 0


def _q2k_params(n_layers):
    gen = torch.Generator().manual_seed(0)
    return chip_smoke.random_q2k_params(TINY, n_layers, torch.device("cpu"), gen, torch.float32)


@pytest.mark.parametrize("i", range(4))
def test_builder_puts_the_q2k_mix_in_each_layer(i):
    layer = _q2k_params(4).layers[i]
    kinds = {k: lin.kind for part in ("attn", "mlp") for k, lin in layer[part].items()}
    assert kinds == {"q": "gguf_q2k", "k": "gguf_q2k", "v": "gguf_q4k", "o": "gguf_q6k",
                     "gate": "gguf_q2k", "up": "gguf_q2k", "down": "gguf_q6k"}
    q = layer["attn"]["q"]
    assert q.data["q"].shape == (128, 512) and q.data["q"].dtype == torch.uint8
    assert q.data["scale"].shape == q.data["minv"].shape == (32, 512)
    assert float(q.data["scale"].min()) >= 0.001 and float(q.data["scale"].max()) < 0.005
    torch.testing.assert_close(q.data["minv"], 1.5 * q.data["scale"])


@pytest.mark.parametrize("name", ["o", "down"])
def test_q2k_builder_writes_q3k_codes_into_the_q6k_layout(name):
    """o and down hold Q3_K codes as pack_q3k writes them: q3 + 28, so every
    6-bit code read back in element order lies in 28..35, and all 8 occur."""
    from mistralrs_tpu_torch.ops.quant_matmul import _q6k_natural

    layer = _q2k_params(1).layers[0]
    lin = layer["attn" if name == "o" else "mlp"][name]
    q, s16 = _q6k_natural(lin.data["ql"], lin.data["qh"], lin.data["scale"], lin.meta)
    assert q.shape == (lin.shape[0], lin.shape[1]) and s16.shape == (lin.shape[0] // 16, lin.shape[1])
    assert sorted(torch.unique(q).tolist()) == list(range(28, 36))


def test_q2k_builder_model_serves_through_k10(monkeypatch):
    """The q2k phase's model at a tiny size: two layers, fused and
    requantized by the pipeline into the kinds the phase checks; a 150- and
    a 40-token prompt through the plain versions: q|k and gate|up on the
    dequant route for the batched 2 x 256-row first chunk, on K10 at decode
    (2 sequences in 4 slots)."""
    from mistralrs_tpu_torch.ops import quant_matmul as qm

    cfg = chip_smoke.model_config(TINY, 2)
    pc = PipelineConfig(page_size=16, num_pages=64, max_seqs=4, max_model_len=512,
                        prefill_buckets=(64, 256), decode_steps=4, dtype=torch.float32,
                        device="cpu")
    pipe = TextPipeline(cfg, _q2k_params(2), make_rope(cfg, 512, device="cpu"), pc)
    assert chip_smoke.served_kinds(pipe) == chip_smoke.Q2K_KINDS
    layer = pipe.params.layers[0]
    assert set(layer["attn"]) == {"qk", "v", "o"} and set(layer["mlp"]) == {"gateup", "down"}
    assert layer["attn"]["qk"].kind == layer["mlp"]["gateup"].kind == "gguf_q2k"
    assert layer["mlp"]["gateup"].data["q"].shape == (128, 2048)
    seen = {"k10": set(), "dequant": 0}

    def k10(x, *args, **kw):
        seen["k10"].add(x.shape[0])
        return plain_k10(x, *args, **kw)

    def dequant(*args, **kw):
        seen["dequant"] += 1
        return plain_dequant(*args, **kw)

    plain_k10, plain_dequant = qm.affine_gemv_plain, qm.affine_dequant_plain
    monkeypatch.setattr(qm, "affine_gemv_plain", k10)
    monkeypatch.setattr(qm, "affine_dequant_plain", dequant)
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    rng = np.random.default_rng(1)
    groups = [eng.add_request(GenerationRequest([int(t) for t in rng.integers(1, TINY.vocab, n)],
                                                SamplingParams(max_len=6)))
              for n in (150, 40)]
    while not all(g.all_done() for g in groups):
        eng.step()
    assert all(g.seqs[0].num_generated == 6 for g in groups)
    assert np.isfinite(pipe.last_greedy_pack).all()
    assert seen == {"k10": {4}, "dequant": 2 * 2}  # q|k and gate|up of 2 layers


def test_q5km_bf16_card_vs_cpu_run_takes_k4_and_k9b(monkeypatch):
    """card_vs_cpu's Q5_K_M run with Q6_K kept and int8_activations=False at
    a tiny size, the CPU standing in for both sides: the 256-token prefill
    and the 4 decode steps take K4 at 256 rows and at 1 (the rows and the
    16-row instantiations on the card), K9b's rows instantiation (the
    high-bit term, beside K5's) at 256 and its decode instantiation (the
    whole Q5_K product, q5k_bf16_gemv) at 1, and no int8 GEMV (the
    wrappers counted, each taking its plain version here)."""
    from mistralrs_tpu_torch.ops import quant_matmul as qm

    rows = {}
    for name in ("q6k_bf16_gemv", "q5k_bf16_gemv", "q5k_hbit_bf16_gemv",
                 "q4k_bf16_gemv") + chip_smoke.INT8_GEMVS:
        fn = getattr(qm, name)
        monkeypatch.setattr(qm, name,
                            lambda x, *a, _n=name, _f=fn, **k: rows.setdefault(_n, set()).add(
                                x.shape[0]) or _f(x, *a, **k))
    gen = torch.Generator().manual_seed(5)
    weights = chip_smoke.random_q5km_params(TINY, 2, torch.device("cpu"), gen, torch.bfloat16)
    prompt = [int(t) for t in np.random.default_rng(3).integers(1, TINY.vocab, 256)]
    runs, _ = chip_smoke._token_major_run(chip_smoke.model_config(TINY, 2), weights,
                                          torch.device("cpu"), prompt, None,
                                          int8_activations=False)
    assert runs["cpu"].shape == (5, TINY.vocab) and np.isfinite(runs["cpu"]).all()
    assert rows == {"q6k_bf16_gemv": {256, 1}, "q5k_bf16_gemv": {1}, "q5k_hbit_bf16_gemv": {256},
                    "q4k_bf16_gemv": {256}}, rows


def test_every_kernel_belongs_to_one_path():
    names = [n for path in chip_smoke.PATH_KERNELS.values() for n in path]
    assert sorted(names) == sorted(chip_smoke.KERNEL_INFO) == sorted(chip_smoke.COUNTERS)
    assert set(chip_smoke.HEADLINE) == set(chip_smoke.KERNEL_INFO)


def test_waves_serve_greedy_then_sampled_requests_on_the_device_loop(monkeypatch, one_thread):
    """The decode_graph phase's waves at a tiny size: a greedy wave, then a
    sampled one (WAVE_SAMPLING), each decode call of the second on the
    sampled loop (run_decode_multi with the sampling arguments), of the
    first on the greedy one. (The GEMVs dequantize: the CPU runs that
    route fastest.)"""
    from mistralrs_tpu_torch.ops import quant_matmul as qm

    monkeypatch.setattr(qm, "MAX_KERNEL_ROWS", -1)
    cfg = chip_smoke.model_config(TINY, 2)
    pc = PipelineConfig(page_size=16, num_pages=64, max_seqs=4, max_model_len=512,
                        prefill_buckets=(64,), decode_steps=4, dtype=torch.float32, device="cpu")
    pipe = TextPipeline(cfg, _params(2), make_rope(cfg, 512, device="cpu"), pc)
    calls = []
    run = pipe.run_decode_multi
    pipe.run_decode_multi = lambda seqs, sampling=None: calls.append(sampling) or run(seqs,
                                                                                     sampling)
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    waves = [(3, 30, 6), (3, 30, 6)]
    at = []
    served = chip_smoke.serve_waves(eng, np.random.default_rng(4), TINY.vocab, waves,
                                    after_wave=lambda i: at.append(len(calls)),
                                    sampling=[None, chip_smoke.WAVE_SAMPLING])
    for groups, _ in served:
        assert chip_smoke.check_served(groups, TINY.vocab, 6, pipe) == 3 * 6
    sp = served[1][0][0].seqs[0].sampling
    assert (sp.temperature, sp.top_k, sp.top_p, sp.min_p) == (0.8, 40, 0.95, 0.05)
    assert calls[:at[0]] and all(c is None for c in calls[:at[0]])
    sampled = calls[at[0]:]
    assert sampled and all(c[:4] == ([0.8] * 3, [40] * 3, [0.95] * 3, [0.05] * 3)
                           for c in sampled)


# ------------------------------------------------------------- long_kv


@pytest.mark.parametrize("kv_quant", [False, True])
def test_long_kv_serving_run_counts_its_blockwise_forwards(kv_quant, monkeypatch, one_thread):
    """long_kv_serve at a tiny width (1 layer) on head-major pools
    (max_model_len 8192): a request of ~4,700 tokens (10 chunks, the last 2
    past span 4096) and 9 new tokens; with the decode threshold at 4096 the
    int8 pools decode (span 8192) on the blockwise route too, and the bf16
    ones on K7's. The decoder's blockwise counter matches blockwise_expected."""
    from mistralrs_tpu_torch.models import decoder
    from mistralrs_tpu_torch.ops import quant_matmul as qm

    monkeypatch.setattr(qm, "MAX_KERNEL_ROWS", -1)
    monkeypatch.setattr(decoder, "_BLOCKWISE_DECODE_SPAN", 4096)
    cfg = chip_smoke.model_config(TINY, 1)
    run = (1, 4700, 9)
    pipe = chip_smoke.long_kv_pipeline(cfg, _params(1), make_rope(cfg, 8192, device="cpu"),
                                       torch.device("cpu"), chip_smoke.pages_for(*run), 1,
                                       kv_quant=kv_quant, max_model_len=8192)
    assert pipe.cache.quantized == kv_quant and pipe.head_major
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    line = chip_smoke.long_kv_serve(eng, np.random.default_rng(1), TINY.vocab, run, "tiny")
    assert (line["chunks"], line["decode_span"], line["generated_tokens"]) == (10, 8192, 9)
    calls = line["launches"]["decode_eager_loops"]
    assert calls >= 1
    assert line["launches"]["blockwise_steps"] == chip_smoke.blockwise_expected(line) == (
        2 + 8 * calls if kv_quant else 2)
    assert line["kv_gb"] == chip_smoke.pool_bytes(pipe.cache) / 1e9 > 0


def test_swap_run_swaps_and_keeps_every_stream(monkeypatch, one_thread):
    """swap_run at a tiny width (1 layer): 8 requests of ~60 tokens, 24 new, a pool for
    the prompts of 5: sequences swap out and back in, none is prefilled
    again, the streams equal the uncontended engine's, every page comes
    back (swap_run raises otherwise)."""
    from mistralrs_tpu_torch.ops import quant_matmul as qm

    monkeypatch.setattr(qm, "MAX_KERNEL_ROWS", -1)
    cfg = chip_smoke.model_config(TINY, 1)
    line = chip_smoke.swap_run(cfg, _params(1), make_rope(cfg, 512, device="cpu"),
                               torch.device("cpu"), np.random.default_rng(2), TINY.vocab,
                               run=(8, 60, 24), max_model_len=512)
    assert line["swap_outs"] >= 1 and line["swap_ins"] >= 1
    assert line["streams_equal"] == 8 and not line["near_ties"]


def test_long_kv_check_runs_at_a_tiny_size(monkeypatch, one_thread):
    """long_kv_check_runs on int8 pools with the CPU standing in for both
    sides (f32, then bf16): a 4,600-token prompt, a first chunk of 4096,
    then one blockwise chunk; the blockwise step's logits equal the gather
    route's on the same step within 1e-2 of the largest |logit|."""
    from mistralrs_tpu_torch.ops import quant_matmul as qm

    monkeypatch.setattr(qm, "MAX_KERNEL_ROWS", -1)
    cfg = chip_smoke.model_config(TINY, 1)
    weights = chip_smoke.random_q4km_params(TINY, 1, torch.device("cpu"),
                                            torch.Generator().manual_seed(7), torch.bfloat16)
    prompt = [int(t) for t in np.random.default_rng(8).integers(1, TINY.vocab,
                                                                chip_smoke.LONG_KV_CHECK)]
    runs, gather, counts = chip_smoke.long_kv_check_runs(cfg, weights, torch.device("cpu"),
                                                         prompt, kv_quant=True)
    got = runs["cpu"]
    assert got.shape == gather.shape == (1, TINY.vocab) and np.isfinite(got).all()
    assert counts["blockwise_steps"] == 1
    assert np.abs(got - gather).max() <= 1e-2 * np.abs(gather).max()


def test_pages_for_holds_the_run():
    assert chip_smoke.pages_for(1, 100, 0) == 1 + -(-(100 + 16) // 16) + 0 + 2
    n, plen, new = chip_smoke.LONG_KV_INT8
    pages = chip_smoke.pages_for(n, plen, new)
    assert pages > n * (plen + 8 + new + 8) / 16 + 1
    assert 16 * chip_smoke.LONG_KV_LEN // 16 >= plen + new + 8
