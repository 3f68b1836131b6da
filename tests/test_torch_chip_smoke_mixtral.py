"""chip_smoke.py's Mixtral builders at a tiny size on the CPU: the published
widths, the layouts of the bf16-expert and the GGUF Q4_K_M models, the
routing margins, both models served through the engine on the plain
versions, their card-vs-CPU run (the CPU standing in for both sides), and
the grouped GEMM cases of the kernel phase."""

import numpy as np
import pytest
import torch

import chip_smoke
from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline


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


def test_speculative_phase_builders_at_a_tiny_size(monkeypatch):
    """The speculative phase's draft A (draft_prefix: the target pipeline's
    first layers, its weight tensors shared, a pool of its own of the same
    geometry) and its prompts at a tiny size, 2 layers and a 1-layer
    draft: a greedy request through SpeculativePipeline on the device loop
    equals plain decoding, and near_ties finds no difference then and
    raises at a token that is far from a tie. One torch thread and the
    dequant route (tiny ops slow by up to 100x on a loaded machine)."""
    from chip_smoke_tiny import TINY
    from mistralrs_tpu_torch.ops import quant_matmul as qm
    from mistralrs_tpu_torch.pipeline.speculative import SpeculativePipeline

    monkeypatch.setattr(qm, "MAX_KERNEL_ROWS", -1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _speculative_builders(TINY, SpeculativePipeline)
    finally:
        torch.set_num_threads(threads)


def _speculative_builders(TINY, SpeculativePipeline):
    cfg = chip_smoke.model_config(TINY, 2)
    gen = torch.Generator().manual_seed(0)
    params = chip_smoke.random_q4km_params(TINY, 2, torch.device("cpu"), gen, torch.float32)
    pc = PipelineConfig(page_size=16, num_pages=48, max_seqs=2, max_model_len=512,
                        prefill_buckets=(64, 256), decode_steps=4, dtype=torch.float32,
                        device="cpu")
    target = TextPipeline(cfg, params, make_rope(cfg, 512, device="cpu"), pc)
    draft = chip_smoke.draft_prefix(target, 1)
    assert draft.cfg.num_layers == 1 and draft.cache.k.shape[0] == 1
    assert draft.cache.k.shape[1:] == target.cache.k.shape[1:] and draft.pc is target.pc
    for got, want in zip(draft.params.layers, target.params.layers[:1]):
        assert got["attn"]["qk"].data["qs"].data_ptr() == want["attn"]["qk"].data["qs"].data_ptr()
        assert got["mlp"]["gateup"].data["qs"].data_ptr() == \
            want["mlp"]["gateup"].data["qs"].data_ptr()
    assert draft.params.lm_head.data["q"].data_ptr() == target.params.lm_head.data["q"].data_ptr()
    rng = np.random.default_rng(2)
    (prompt,) = chip_smoke.spec_prompts(rng, TINY.vocab, 1, 40)
    (rep,) = chip_smoke.spec_prompts(rng, TINY.vocab, 1, 40, segment=8)
    assert 32 <= len(rep) <= 48 and all(t == rep[i % 8] for i, t in enumerate(rep))
    plain, _ = chip_smoke.serve_prompts(Engine(target, eos_token_ids=set(), prefix_cache=False),
                                        [prompt], 9)
    spec = Engine(SpeculativePipeline(target, draft, gamma=2, spec_rounds=2),
                  eos_token_ids=set(), prefix_cache=False)
    groups, dec = chip_smoke.serve_prompts(spec, [prompt], 9)
    a, b = plain[0].seqs[0].generated_tokens, groups[0].seqs[0].generated_tokens
    assert a == b and dec["tokens"] > 0 and groups[0].seqs[0].spec_proposed > 0
    assert chip_smoke.near_ties(target, [prompt], [a], [b]) == []
    far = list(a)
    far[3] = (a[3] + 1) % TINY.vocab
    with pytest.raises(AssertionError, match="not a near-tie"):
        chip_smoke.near_ties(target, [prompt], [a], [far])
