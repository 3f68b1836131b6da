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
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

TINY = chip_smoke.Sizes(vocab=1920, hidden=512, inter=1024, heads=4, kv_heads=2, layers=8)


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


TINY_GEMMA2 = chip_smoke.Sizes(vocab=512, hidden=256, inter=512, heads=4, kv_heads=2, head_dim=256,
                               layers=4)


def test_gemma2_config_has_the_published_widths():
    cfg = chip_smoke.gemma2_config(chip_smoke.GEMMA2, 42)
    assert (cfg.arch, cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (
        "gemma2", 256000, 3584, 14336, 42, 16, 8, 256)
    assert (cfg.attn_logit_softcap, cfg.final_logit_softcap, cfg.sliding_window) == (50.0, 30.0,
                                                                                    4096)
    assert cfg.query_scale == 1 / 16 and cfg.act == "gelu_pytorch_tanh"
    assert cfg.block_style == "sandwich" and cfg.tie_word_embeddings


def test_gemma2_builder_makes_q4k_projections_and_a_tied_head():
    gen = torch.Generator().manual_seed(0)
    p = chip_smoke.random_gemma2_params(TINY_GEMMA2, 2, torch.device("cpu"), gen, torch.float32)
    assert p.lm_head is None and tuple(p.embed.shape) == (512, 256)
    layer = p.layers[0]
    assert {k: (lin.kind, lin.shape) for k, lin in layer["attn"].items()} == {
        "q": ("gguf_q4k", (256, 1024)), "k": ("gguf_q4k", (256, 512)),
        "v": ("gguf_q4k", (256, 512)), "o": ("gguf_q4k", (1024, 256))}
    assert {lin.kind for lin in layer["mlp"].values()} == {"gguf_q4k"}
    for n in ("input_norm", "post_attn_norm", "pre_mlp_norm", "post_mlp_norm"):
        assert not bool(layer[n]["w"].any())  # 0: the (1 + w) form makes 1


def test_gemma2_builder_model_serves_through_the_engine(monkeypatch):
    """The gemma2 phase's model at a tiny size: 4 layers, a 150- and a
    40-token prompt through the plain versions: the batched 2 x 256-row
    first chunk on the dequant route and K11 (windowed on the local
    layers), the rest on K1 and the gather route."""
    from mistralrs_tpu_torch.ops import quant_matmul as qm
    from mistralrs_tpu_torch.ops import splash as sp

    cfg = chip_smoke.gemma2_config(TINY_GEMMA2, 4)
    pc = PipelineConfig(page_size=16, num_pages=64, max_seqs=4, max_model_len=512,
                        prefill_buckets=(64, 256), decode_steps=4, dtype=torch.float32,
                        device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = chip_smoke.random_gemma2_params(TINY_GEMMA2, 4, torch.device("cpu"), gen,
                                             torch.float32)
    pipe = TextPipeline(cfg, params, make_rope(cfg, 512, device="cpu"), pc)
    assert chip_smoke.served_kinds(pipe) == chip_smoke.GEMMA2_KINDS
    assert set(pipe.params.layers[0]["attn"]) == {"qkv", "o"}
    seen = {"windows": [], "k1": 0, "dequant": 0}

    def splash(*args, **kw):
        seen["windows"].append(kw["sliding_window"])
        return plain_splash(*args, **kw)

    def k1(*args, **kw):
        seen["k1"] += 1
        return plain_k1(*args, **kw)

    def dequant(*args, **kw):
        seen["dequant"] += 1
        return plain_dequant(*args, **kw)

    plain_splash, plain_k1, plain_dequant = (sp.splash_prefill_plain, qm.q4k_q8_gemv_plain,
                                             qm.q4k_dequant_plain)
    monkeypatch.setattr(sp, "splash_prefill_plain", splash)
    monkeypatch.setattr(qm, "q4k_q8_gemv_plain", k1)
    monkeypatch.setattr(qm, "q4k_dequant_plain", dequant)
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    rng = np.random.default_rng(1)
    groups = [eng.add_request(GenerationRequest([int(t) for t in rng.integers(1, 512, n)],
                                                SamplingParams(max_len=6)))
              for n in (150, 40)]
    while not all(g.all_done() for g in groups):
        eng.step()
    assert all(g.seqs[0].num_generated == 6 for g in groups)
    assert np.isfinite(pipe.last_greedy_pack).all()
    assert seen["windows"] == [4096, None, 4096, None]
    assert seen["dequant"] == 4 * 4 and seen["k1"] > 0  # qkv, o, gateup, down of 4 layers


@pytest.mark.parametrize("T,window,pairs", [(4, None, 10), (4, 4, 10), (4, 2, 7),
                                            (512, 128, 128 * 129 // 2 + 384 * 128)])
def test_kept_pairs_counts_the_mask(T, window, pairs):
    assert chip_smoke.kept_pairs(T, window) == pairs
    t = torch.arange(T)
    keep = (t[None, :] <= t[:, None]) & (t[None, :] > t[:, None] - (window or T + 1))
    assert int(keep.sum()) == pairs


def test_gemma2_ragged_builder_serves_through_k12():
    """The gemma2_ragged phase's pipeline at a tiny size: 4 layers on one
    combined pool; 2 prompts of ~600 tokens (a 512-row first chunk on K11,
    a continuation on K12) and 4 of ~40 (K11), decoded on K12, all through
    the plain versions; never K6, K6', K7 or the gather route."""
    from mistralrs_tpu_torch.models import decoder as td
    from mistralrs_tpu_torch.ops import flash_attention as fa
    from mistralrs_tpu_torch.ops import paged_attention as pa
    from mistralrs_tpu_torch.ops import ragged_attention as ra
    from mistralrs_tpu_torch.ops import splash as sp

    pipe = chip_smoke.gemma2_ragged_pipeline(TINY_GEMMA2, 4, torch.device("cpu"), pages=128)
    assert pipe.kv_combined and not pipe.head_major and pipe.cache.v is None
    assert tuple(pipe.cache.k.shape) == (4, 128, 16, 2 * 2, 256)
    calls = {"ragged": 0, "splash": 0, "other": 0}

    def count(key, fn):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    patches = [(ra, "ragged_attention_plain", "ragged"), (sp, "splash_prefill_plain", "splash"),
               (fa, "flash_prefill_plain", "other"), (td, "sdpa", "other"),
               (pa, "flash_prefill_continuation_plain", "other"),
               (pa, "paged_decode_attention_plain", "other")]
    mp = pytest.MonkeyPatch()
    try:
        for mod, name, key in patches:
            mp.setattr(mod, name, count(key, getattr(mod, name)))
        eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
        waves = chip_smoke.serve_waves(eng, np.random.default_rng(5), TINY_GEMMA2.vocab,
                                       [(2, 600, 3), (4, 40, 3)])
    finally:
        mp.undo()
    for (groups, _), (n, _, max_len) in zip(waves, [(2, 600, 3), (4, 40, 3)]):
        assert len(groups) == n
        assert chip_smoke.check_served(groups, TINY_GEMMA2.vocab, max_len, pipe) == n * max_len
    assert calls["ragged"] > 0 and calls["splash"] > 0 and calls["other"] == 0
    m = chip_smoke.wave_metrics(waves)
    assert m["decode_tok_s_long"] > 0 and m["decode_tok_s_short"] > 0
    assert m["prompt_tokens_long"] == sum(len(s.prompt_tokens) for g in waves[0][0]
                                          for s in g.seqs)


@pytest.mark.parametrize("gemma2", [False, True])
def test_ragged_card_vs_cpu_runs_at_a_tiny_size(gemma2):
    """_ragged_run's chunks (512, 512, 176 padded to 256) and 4 decode
    steps through the plain versions, with the CPU standing in for both
    sides (f32, then bf16)."""
    size = TINY_GEMMA2 if gemma2 else TINY
    cfg = (chip_smoke.gemma2_config if gemma2 else chip_smoke.model_config)(size, 2)
    build = chip_smoke.random_gemma2_params if gemma2 else chip_smoke.random_q4km_params
    weights = build(size, 2, torch.device("cpu"), torch.Generator().manual_seed(8), torch.bfloat16)
    prompt = [int(t) for t in np.random.default_rng(9).integers(1, size.vocab,
                                                                 chip_smoke.RAGGED_PROMPT)]
    runs, counts = chip_smoke._ragged_run(cfg, weights, torch.device("cpu"), prompt, 32)
    assert runs["cpu"].shape == (7, size.vocab) and np.isfinite(runs["cpu"]).all()
    assert counts["ragged_attention"] == 0  # no launch on the CPU


@pytest.mark.parametrize("seqs,window", [(((1, 40),) * 3, None), (((8, 20), (1, 30)), 16),
                                         (((64, 64), (17, 100), (1, 7)), 32)])
def test_ragged_work_counts_the_mask(seqs, window):
    """The K12 bound's keys and kept pairs against the plain version's mask,
    on ragged_inputs' packed arguments."""
    from mistralrs_tpu_torch.ops import ragged_attention as ra

    keys, pairs = chip_smoke.ragged_work(seqs, window)
    q, pool, kv_lens, tables, cu, num_seqs = chip_smoke.ragged_inputs(
        torch.device("cpu"), torch.Generator().manual_seed(0), seqs, 4, 4, 2, 128)
    assert q.shape == (sum(ql for ql, _ in seqs), 4, 128) and tables.shape[0] == 4
    assert cu.tolist()[-1] == q.shape[0] and num_seqs.tolist() == [len(seqs)]
    assert len(set(tables.flatten().tolist())) == tables.numel() and int(tables.min()) == 1
    out = ra.ragged_attention(q, pool, kv_lens, tables, cu, num_seqs, scale=0.1,
                              sliding_window=window)
    assert out.shape == q.shape and bool(torch.isfinite(out.float()).all())
    want_keys = want_pairs = 0
    for q_len, kv_len in seqs:
        pos = torch.arange(kv_len - q_len, kv_len)[:, None]
        k = torch.arange(kv_len)[None, :]
        keep = (k <= pos) & (k > pos - (window or kv_len + 1))
        want_pairs += int(keep.sum())
        want_keys += int(keep.any(0).sum()) if window else kv_len
    assert (keys, pairs) == (want_keys, want_pairs)


# Mixtral at hidden 512 (4 heads of 128 over 2 kv heads), intermediate 1024,
# Mixtral-8x7B's 8 experts with 2 a token
TINY_MIXTRAL = chip_smoke.Sizes(vocab=1920, hidden=512, inter=1024, heads=4, kv_heads=2, layers=2)


def test_mixtral_config_has_the_published_widths():
    cfg = chip_smoke.mixtral_config(chip_smoke.MIXTRAL, 32)
    assert (cfg.arch, cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (
        "mixtral", 32000, 4096, 14336, 32, 32, 8, 128)
    assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.rope_theta) == (8, 2, 1e6)
    assert cfg.sliding_window is None and cfg.is_moe and not cfg.moe_grouped


def _mixtral_params(packed, n_layers=2):
    gen = torch.Generator().manual_seed(0)
    return chip_smoke.random_mixtral_params(TINY_MIXTRAL, n_layers, torch.device("cpu"), gen,
                                            torch.float32, packed=packed)


@pytest.mark.parametrize("packed", [False, True])
def test_mixtral_builder_layout(packed):
    p = _mixtral_params(packed)
    layer = p.layers[0]
    ex = layer["mlp"]["experts"]
    if packed:  # GGUF Q4_K_M rule: Q4_K experts stacked [E, ...], dense router, Q6_K v/head
        assert {k: ex[k].kind for k in ex} == dict.fromkeys(("gate", "up", "down"), "gguf_q4k")
        assert ex["gate"].data["qs"].shape == (8, 256, 1024)
        assert ex["down"].data["scale"].shape == (8, 32, 512)
        assert layer["mlp"]["router"].kind == "dense"
        assert layer["attn"]["v"].kind == p.lm_head.kind == "gguf_q6k"
        torch.testing.assert_close(ex["up"].data["minv"], 7.5 * ex["up"].data["scale"])
    else:  # HF + ISQ Q4K: Q4_K attention, router and head, dense experts
        assert [ex[k].data["w"].shape for k in ("gate", "up", "down")] == [
            (8, 512, 1024), (8, 512, 1024), (8, 1024, 512)]
        assert abs(float(ex["gate"].data["w"].std()) - 512 ** -0.5) < 0.01 * 512 ** -0.5
        assert layer["mlp"]["router"].kind == layer["attn"]["v"].kind == "gguf_q4k"
        assert p.lm_head.kind == "gguf_q4k" and layer["mlp"]["router"].shape == (512, 8)


@pytest.mark.parametrize("packed", [False, True])
def test_mixtral_builder_routes_every_token_with_a_margin(packed):
    """Each token's embedding picks its two experts with a wide margin (the
    card-vs-CPU check relies on it), and the tokens spread over all 8."""
    from mistralrs_tpu_torch.models.decoder import _route
    from mistralrs_tpu_torch.ops import layers as L

    p = _mixtral_params(packed, n_layers=1)
    cfg = chip_smoke.mixtral_config(TINY_MIXTRAL, 1)
    x = L.rms_norm(p.embed, torch.ones(512), cfg.norm_eps)
    w, ids = _route(cfg, p.layers[0]["mlp"], x)
    logits = torch.sort(x @ _dense_router(p.layers[0]["mlp"]["router"]), dim=-1,
                        descending=True).values
    assert float((logits[:, 1] - logits[:, 2]).min()) > 0.5
    assert float(w[:, 0].min()) > 0.6 and float(w[:, 1].min()) > 0.15
    assert torch.bincount(ids.flatten(), minlength=8).min() > 1920 * 2 / 8 * 0.8


def _dense_router(lin):
    from mistralrs_tpu_torch.quant.gguf_linear import dequant_q4k_weights

    return lin.data["w"] if lin.kind == "dense" else dequant_q4k_weights(lin, torch.float32).T


@pytest.mark.parametrize("packed", [False, True])
def test_mixtral_builder_model_serves_through_the_engine(packed, monkeypatch):
    """The mixtral (dense experts: the grouped dispatch, K13's plain
    version, 3 calls a layer and forward) and mixtral_q4km (packed experts:
    K1's plain version for every expert at decode) phases' models at a tiny
    size, 2 layers, a 150- and a 40-token prompt."""
    from mistralrs_tpu_torch.ops import grouped_gemm as gg
    from mistralrs_tpu_torch.ops import quant_matmul as qm

    cfg = chip_smoke.mixtral_config(TINY_MIXTRAL, 2)
    pc = PipelineConfig(page_size=16, num_pages=64, max_seqs=4, max_model_len=512,
                        prefill_buckets=(64, 256), decode_steps=4, dtype=torch.float32,
                        device="cpu")
    pipe = TextPipeline(cfg, _mixtral_params(packed), make_rope(cfg, 512, device="cpu"), pc)
    assert pipe.cfg.moe_grouped
    want = chip_smoke.MIXTRAL_Q4KM_KINDS if packed else chip_smoke.MIXTRAL_KINDS
    assert chip_smoke.served_kinds(pipe) == want
    seen = {"k13": 0, "k1_rows": set()}

    def k13(*args):
        seen["k13"] += 1
        return plain_k13(*args)

    def k1(x, *args):
        seen["k1_rows"].add(x.shape[0])
        return plain_k1(x, *args)

    plain_k13, plain_k1 = gg.grouped_matmul_ref, qm.q4k_q8_gemv_plain
    monkeypatch.setattr(gg, "grouped_matmul_ref", k13)
    monkeypatch.setattr(qm, "q4k_q8_gemv_plain", k1)
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    rng = np.random.default_rng(1)
    groups = [eng.add_request(GenerationRequest([int(t) for t in rng.integers(1, 1920, n)],
                                                SamplingParams(max_len=6)))
              for n in (150, 40)]
    while not all(g.all_done() for g in groups):
        eng.step()
    assert all(g.seqs[0].num_generated == 6 for g in groups)
    assert np.isfinite(pipe.last_greedy_pack).all()
    # one 2 x 256-row first chunk (dequant + matmul for Q4_K), then 2 decode
    # calls of 4 forwards in 4 slots (K1)
    assert seen["k13"] == (0 if packed else 3 * 2 * (1 + 8))
    # (and the dense model's Q4_K lm_head on the prefill's 2 last rows)
    assert seen["k1_rows"] == ({4} if packed else {2, 4})


@pytest.mark.parametrize("packed", [False, True])
def test_mixtral_card_vs_cpu_runs_at_a_tiny_size(packed):
    cfg = chip_smoke.mixtral_config(TINY_MIXTRAL, 2)
    weights = _mixtral_params(packed)
    prompt = [int(t) for t in np.random.default_rng(10).integers(1, 1920, 256)]
    runs, counts = chip_smoke._token_major_run(cfg, weights, torch.device("cpu"), prompt, 32)
    assert runs["cpu"].shape == (5, 1920) and np.isfinite(runs["cpu"]).all()
    assert counts["grouped_gemm"] == 0  # no launch on the CPU


def test_grouped_cases_route_two_distinct_experts_a_token():
    gen = torch.Generator().manual_seed(0)
    for _, K, N, tokens, one in chip_smoke.GROUPED_CASES:
        assert K * N == 4096 * 14336
        sizes = chip_smoke.top2_group_sizes(gen, tokens, 8, torch.device("cpu"))
        assert sizes.dtype == torch.int32 and int(sizes.sum()) == 2 * tokens
        assert int(sizes.max()) <= tokens  # an expert takes a token once
    names = [c[0] for c in chip_smoke.GROUPED_CASES]
    assert chip_smoke.HEADLINE["grouped_gemm"] in names and len(set(names)) == len(names)


# ------------------------------------------------------------- GGUF files


@pytest.fixture(scope="module")
def tiny_q5km_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gguf") / "q5km.gguf")
    nbytes = chip_smoke.write_random_gguf(path, TINY, 8, "Q5_K", seed=12)
    return path, nbytes


def test_random_gguf_has_the_q5km_mix_and_reads_back(tiny_q5km_gguf):
    """The random-wire builder at a tiny size: the port's reader finds the
    Q5_K_M rule's types (Q6_K attn_v, use_more_bits ffn_down and output,
    Q5_K elsewhere, F32 norms), every tensor dequantizes to finite values,
    and the packed scales and mins stay in bench.py's ranges."""
    from mistralrs_tpu_torch.gguf.reader import GGMLType, GGUFFile
    from mistralrs_tpu_torch.quant.gguf_linear import linear_from_gguf

    path, nbytes = tiny_q5km_gguf
    g = GGUFFile(path)
    assert g.architecture == "llama" and g.metadata["llama.block_count"] == 8
    assert sum(ti.byte_size for ti in g.tensors.values()) == nbytes
    assert len(g.tensors) == 3 + 9 * 8
    assert g.tensors["token_embd.weight"].ggml_type == GGMLType.Q5_K
    assert g.tensors["output.weight"].ggml_type == GGMLType.Q6_K
    for i in range(8):
        types = {n: g.tensors[f"blk.{i}.{n}.weight"].ggml_type.name
                 for n in chip_smoke.gguf_mix("Q5_K", i, 8)}
        assert types == chip_smoke.gguf_mix("Q5_K", i, 8)
        assert types["attn_v"] == "Q6_K" and types["attn_q"] == "Q5_K"
        assert types["ffn_down"] == ("Q6_K" if chip_smoke.use_more_bits(i, 8) else "Q5_K")
        assert g.tensors[f"blk.{i}.attn_norm.weight"].ggml_type == GGMLType.F32
    assert g.tensors["blk.0.attn_k.weight"].shape == (TINY.kv_heads * TINY.head_dim, TINY.hidden)
    for name in g.tensors:
        assert np.isfinite(g.tensor_f32(name)).all(), name
    ti, raw = g.raw_tensor("blk.0.ffn_gate.weight")
    lin = linear_from_gguf(raw, ti.ggml_type, ti.shape, torch.float32, "cpu")
    assert float(lin.data["scale"].max()) < 0.005 and float(lin.data["minv"].max()) < 0.002
    ti, raw = g.raw_tensor("output.weight")
    lin = linear_from_gguf(raw, ti.ggml_type, ti.shape, torch.float32, "cpu")
    assert float(lin.data["scale"].abs().max()) < 0.005


def test_random_gguf_serves_on_the_bf16_route(tiny_q5km_gguf, monkeypatch):
    """The gguf_bf16 phase's pipeline at a tiny size on the CPU: the file
    loaded by load_gguf_model and served with int8_activations=False at
    rq8_group=32 takes K9b's decode instantiation (the whole Q5_K product)
    at 1-16 rows, K5 and K9b's high-bit kernel only above 16 (here the
    prefill takes the dequant route), and K8, never an int8 GEMV (the
    wrappers counted by their rows, each taking its plain version here)."""
    from mistralrs_tpu_torch.ops import quant_matmul as qm
    from mistralrs_tpu_torch.pipeline.gguf import load_gguf_model

    calls = {}
    for name in ("q5k_bf16_gemv", "q4k_bf16_gemv", "q5k_hbit_bf16_gemv",
                 "q8_0_bf16_gemv") + chip_smoke.INT8_GEMVS:
        fn = getattr(qm, name)
        monkeypatch.setattr(qm, name,
                            lambda x, *a, _n=name, _f=fn, **k: calls.setdefault(_n, set()).add(
                                x.shape[0]) or _f(x, *a, **k))
    cfg, params, rope, _ = load_gguf_model(tiny_q5km_gguf[0], dtype=torch.float32, device="cpu")
    pc = PipelineConfig(page_size=16, num_pages=64, max_seqs=4, max_model_len=512,
                        prefill_buckets=(64, 256), decode_steps=4, dtype=torch.float32,
                        device="cpu", int8_activations=False)
    pipe = TextPipeline(dataclasses.replace(cfg, num_layers=2), dataclasses.replace(
        params, layers=params.layers[:2]), rope, pc)
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    rng = np.random.default_rng(1)
    groups = [eng.add_request(GenerationRequest([int(t) for t in rng.integers(1, TINY.vocab, n)],
                                                SamplingParams(max_len=6)))
              for n in (150, 40)]
    while not all(g.all_done() for g in groups):
        eng.step()
    assert all(g.seqs[0].num_generated == 6 for g in groups)
    assert np.isfinite(pipe.last_greedy_pack).all()
    assert {"q5k_bf16_gemv", "q8_0_bf16_gemv"} <= set(calls) <= {
        "q5k_bf16_gemv", "q4k_bf16_gemv", "q5k_hbit_bf16_gemv", "q8_0_bf16_gemv"}, calls
    assert max(calls["q5k_bf16_gemv"]) <= 16, calls
    assert calls.get("q4k_bf16_gemv") == calls.get("q5k_hbit_bf16_gemv"), calls
    assert min(calls.get("q4k_bf16_gemv", {17})) > 16, calls


def test_bf16_card_vs_cpu_loads_each_side_from_the_file(tiny_q5km_gguf):
    """card_vs_cpu_bf16's run with the CPU standing in for both sides:
    load_gguf_model on each side, a 256-token prefill and 4 decode steps."""
    from mistralrs_tpu_torch.pipeline.gguf import load_gguf_model

    def load(dev, dt):
        cfg, params, _, _ = load_gguf_model(tiny_q5km_gguf[0], dtype=dt, device=dev)
        return dataclasses.replace(cfg, num_layers=2), dataclasses.replace(
            params, layers=params.layers[:2])

    prompt = [int(t) for t in np.random.default_rng(13).integers(1, TINY.vocab, 256)]
    runs, counts = chip_smoke._token_major_run(None, load, torch.device("cpu"), prompt, 32,
                                               int8_activations=False)
    assert runs["cpu"].shape == (5, TINY.vocab) and np.isfinite(runs["cpu"]).all()
    assert counts["q4k_bf16_gemv"] == 0  # no launch on the CPU


class _CallOnce:
    """A stand-in for chip_smoke.Clock on the CPU: runs fn once, times nothing."""

    def ms(self, fn) -> float:
        fn()
        return 0.0


@pytest.mark.parametrize("sms,want_splits", [(32, {1, 2, 4}), (132, {2, 4})])
def test_bf16_kernels_hold_k9b_rows_at_every_gguf_bf16_shape(monkeypatch, sms, want_splits):
    """bf16_kernels at a tiny size on the CPU (the plain versions on both
    sides): K9b's rows instantiation is compared at gate|up, q|k, o and
    down, each row carries the plan's K split, and the phase raises unless
    one split and several were both compared."""
    from mistralrs_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "sm_count", lambda device: sms)
    # a profiler trace of the card's kernels a call needs the card: one here
    monkeypatch.setattr(chip_smoke, "kernels_a_call", lambda fn, calls=8: 1.0)
    rows = []
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, lo=0.0, hi=1.0, dtype=torch.float32):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dtype)

    def record(name, shape_name, err, rel, tol, *_, **extra):
        assert rel <= tol, (name, shape_name, rel)
        rows.append((name, shape_name, extra.get("splits")))

    run = lambda: chip_smoke.bf16_kernels(TINY, torch.device("cpu"), _CallOnce(), gen, rand, record)
    if 1 not in want_splits:  # every shape split: the phase must refuse
        with pytest.raises(AssertionError, match="not at one and at several"):
            run()
        return
    run()
    k9b = {(shape, ks) for name, shape, ks in rows if name == "q5k_hbit_bf16_gemv_rows"}
    assert {shape.split(" B=")[0] for shape, _ in k9b} == {"gate|up", "qk", "o", "down"}
    assert {shape for shape, _ in k9b} >= {f"{nm} B={B}" for nm in ("qk", "o", "down")
                                           for B in (17, 64, 256)}
    assert {ks for _, ks in k9b} == want_splits
    # K8's decode instantiation only up to 16 rows; K5's in k5_kernels
    assert not [r for r in rows if r[0] == "q4k_bf16_gemv"]
    assert not [r for r in rows if r[0] == "q8_0_bf16_gemv" and not r[1].endswith(
        ("B=1", "B=4", "B=16"))]
    assert {r[1] for r in rows if r[0] == "q8_0_bf16_gemv"} == {
        f"{nm} B={B}" for nm in ("v", "qk", "gate|up", "down", "lm_head", "lm_head wire")
        for B in (1, 4, 16)}


def test_k5_kernels_hold_the_decode_instantiation_at_every_projection(monkeypatch):
    """k5_kernels at a tiny size on the CPU (the plain versions on both
    sides): K5 at q|k, o, gate|up and down at 1, 4 and 16 rows, at 16 with
    the kernels the card runs a call (a stub here: the trace needs the
    card), which raise past one."""
    calls = []
    monkeypatch.setattr(chip_smoke, "kernels_a_call", lambda fn, calls_=8: calls.append(fn) or 1.0)
    rows = []
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, lo=0.0, hi=1.0, dtype=torch.float32):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dtype)

    def record(name, shape_name, err, rel, tol, *_, **extra):
        assert name == "q4k_bf16_gemv" and rel <= tol == 1e-4, (name, shape_name, rel)
        rows.append((shape_name, extra.get("kernels_a_call"), "int8_ms" in extra))

    chip_smoke.k5_kernels(TINY, torch.device("cpu"), _CallOnce(), gen, rand, record)
    assert [r[0] for r in rows] == [f"{nm} B={B}" for nm in ("qk", "o", "gate|up", "down")
                                    for B in (1, 4, 16)]
    assert [r[1] for r in rows if r[1] is not None] == [1.0] * 4 and len(calls) == 4
    assert all(r[2] for r in rows)
    monkeypatch.setattr(chip_smoke, "kernels_a_call", lambda fn, calls_=8: 3.0)
    with pytest.raises(AssertionError, match="q4k_bf16_gemv B=16: 3.0 kernels a call"):
        chip_smoke.k5_kernels(TINY, torch.device("cpu"), _CallOnce(), gen, rand, record)


# hidden 2048: K5's rows instantiation splits K at zs slices of 512
# elements, so o and down (K 512) take one split; 32 column tiles of the
# lm_head fill 32 SMs
WIDE = chip_smoke.Sizes(vocab=3968, hidden=2048, inter=512, heads=4, kv_heads=2, layers=2)


@pytest.mark.parametrize("sms", [32, 4])
def test_bf16_rows_kernels_hold_k5_and_k8_rows(monkeypatch, sms):
    """bf16_rows_kernels at a small size on the CPU (the plain versions on
    both sides, 17 and 64 rows): K5's rows instantiation at gate|up, q|k, o
    and down, K8's at v, down and the lm_head on f32 scales and at the
    lm_head on bf16 ones, each row with the plan's K split; with few SMs
    no K5 shape splits K, and the phase refuses."""
    from mistralrs_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "sm_count", lambda device: sms)
    monkeypatch.setattr(chip_smoke, "BF16_ROWS_B", (17, 64))
    rows = []

    def inputs(seed):
        gen = torch.Generator().manual_seed(seed)

        def rand(*shape, lo=0.0, hi=1.0, dtype=torch.float32):
            return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dtype)
        return gen, rand

    def record(name, shape_name, err, rel, tol, *_, **extra):
        assert rel <= tol, (name, shape_name, rel)
        rows.append((name, shape_name, extra["splits"]))

    run = lambda: chip_smoke.bf16_rows_kernels(WIDE, torch.device("cpu"), _CallOnce(),
                                               inputs(1), inputs(2), record)
    if sms == 4:
        with pytest.raises(AssertionError, match="q4k_bf16_gemv_rows: compared at K splits"):
            run()
        return
    run()
    k5 = {(shape, ks) for name, shape, ks in rows if name == "q4k_bf16_gemv_rows"}
    k8 = {(shape, ks) for name, shape, ks in rows if name == "q8_0_bf16_gemv_rows"}
    assert {shape for shape, _ in k5} == {f"{nm} B={B}" for nm in ("gate|up", "qk", "o", "down")
                                          for B in (17, 64)}
    assert {shape for shape, _ in k8} == {f"{nm} B={B}" for nm in ("v", "down", "lm_head")
                                          for B in (17, 64)} | {"lm_head wire B=64"}
    k5_splits, k8_splits = {ks for _, ks in k5}, {ks for _, ks in k8}
    assert 1 in k5_splits and max(k5_splits) > 1 and 1 in k8_splits and max(k8_splits) > 1


def test_gguf_bf16_path_holds_the_three_kernels():
    assert chip_smoke.PATH_KERNELS["gguf_bf16"] == (
        "q5k_bf16_gemv", "q8_0_bf16_gemv", "q5k_hbit_bf16_gemv_rows", "q4k_bf16_gemv_rows",
        "q8_0_bf16_gemv_rows")
    # 20 kernels, K1, K2, K9, K10, K4, K9b, K5 and K8 counted in two
    # instantiations each
    assert len(chip_smoke.KERNEL_INFO) == 28
    # K4's 16-row instantiation: only where Q6_K is kept with bf16 activations
    assert chip_smoke.PATH_KERNELS["card_vs_cpu_q5km_bf16"] == ("q6k_bf16_gemv",)
    # K5's decode instantiation: only a Q4_K_M model with bf16 activations
    assert chip_smoke.PATH_KERNELS["card_vs_cpu_bf16_q4km"] == ("q4k_bf16_gemv",)
    for name, path in (("q4k_q8_gemv", "slice"), ("q8_0_q8_gemv", "slice"),
                       ("q5k_q8_gemv", "quant_mix"), ("affine_gemv", "q2k"),
                       ("q6k_bf16_gemv", "quant_mix"), ("q4k_bf16_gemv", "gguf_bf16"),
                       ("q8_0_bf16_gemv", "gguf_bf16")):
        assert chip_smoke.KERNEL_INFO[f"{name}_rows"] == chip_smoke.KERNEL_INFO[name]
        assert f"{name}_rows" in chip_smoke.PATH_KERNELS[path]
    # K9b: the decode instantiation (the whole Q5_K product) and the rows one
    # (the high-bit term) in two sources, for the same TPU kernel
    assert chip_smoke.KERNEL_INFO["q5k_bf16_gemv"][1] == \
        chip_smoke.KERNEL_INFO["q5k_hbit_bf16_gemv_rows"][1]
    for name in chip_smoke.PATH_KERNELS["gguf_bf16"]:
        source, replaces = chip_smoke.KERNEL_INFO[name]
        assert source.startswith("mistralrs_tpu_torch/csrc/") and replaces.startswith(
            "mistralrs_tpu/ops/quant_matmul.py:")
