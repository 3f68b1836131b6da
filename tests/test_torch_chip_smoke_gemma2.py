"""chip_smoke.py's Gemma-2 and ragged-backend builders at a tiny size on the
CPU: the gemma2 and gemma2_ragged phases' models served through the engine
on the plain versions, the ragged card-vs-CPU run, and the masks the
kernel phase's bounds count."""

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke_tiny import TINY
from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline


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
