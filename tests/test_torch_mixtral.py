"""The port's Mixtral serving path against the JAX package's, on the CPU in
f32.

(a) `config_from_hf` on mistralai/Mixtral-8x7B-v0.1's published config.json
    values equals the JAX translator's on every field the port holds.
(b) A tiny seeded transformers.MixtralForCausalLM (tests/torch_port_model.py
    jax_mixtral_params: 3 layers, 4 experts, top-2), loaded by the JAX HF
    loader dense and with ISQ Q4K (router and attention Q4_K, experts
    dense), carried across with params_from_reference and served through
    both Engine(TextPipeline(...)): the port takes the grouped dispatch
    (K13's plain version) where JAX takes lax.ragged_dot. Logits within
    1e-5 of the largest |logit|, greedy tokens equal and logprobs within
    1e-5, with the int8 GEMV routes off. (With them on, K1's int8 rounding
    of the router's input moves near-tied router logits across each other,
    so a token can take another expert than in JAX: the block-level check
    with a dense router is in tests/test_torch_grouped_gemm.py.)
(c) A tiny GGUF Mixtral written by the JAX writer in a Q4_K_M-like mix
    (stacked ffn_*_exps experts and attn_q/k/output in Q4_K, attn_v and
    output in Q6_K, an F32 router), loaded by the JAX GGUF loader and served
    by both engines with Q6_K requantized to int8 per 32 (rq8_group=32;
    JAX with MISTRALRS_Q6K_RQ8=32): the packed every-expert branch, tokens
    equal, logprobs within 1e-5 with the GEMV routes off.
(d) The same file with its down experts in Q6_K: JAX's rq8 fails on the
    stacked expert group, and the port raises NotImplementedError for
    rq8_group=32; with rq8 off (JAX's CPU default, the port's
    rq8_group=None) both serve it, and the port's loader carries the
    shared permutation tables of each layer's expert stack.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.engine.engine import Engine as JEngine
from mistralrs_tpu.engine.engine import GenerationRequest as JRequest
from mistralrs_tpu.engine.sampler import SamplingParams as JSampling
from mistralrs_tpu.gguf.reader import GGMLType
from mistralrs_tpu.gguf.writer import write_gguf
from mistralrs_tpu.models import decoder as jd
from mistralrs_tpu.models.config import config_from_hf as jconfig_from_hf
from mistralrs_tpu.models.loader import make_rope as jmake_rope
from mistralrs_tpu.ops import paged_attention as jpa
from mistralrs_tpu.pipeline.gguf import load_gguf_model
from mistralrs_tpu.pipeline.text import PipelineConfig as JPipelineConfig
from mistralrs_tpu.pipeline.text import TextPipeline as JTextPipeline
from mistralrs_tpu.quant import fuse as jfuse
from mistralrs_tpu.quant import kquants
from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.models import decoder as td
from mistralrs_tpu_torch.models.config import config_from_hf
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.ops import grouped_gemm as tgg
from mistralrs_tpu_torch.ops import paged_attention as tpa
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
from mistralrs_tpu_torch.quant import fuse as tfuse
from torch_port_model import PAGE, jax_mixtral_params, port_config, port_params

EXACT_RTOL = 1e-5
LEN = 512

# mistralai/Mixtral-8x7B-v0.1 config.json
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"], "attention_dropout": 0.0, "bos_token_id": 1,
    "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 32768, "model_type": "mixtral",
    "num_attention_heads": 32, "num_experts_per_tok": 2, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "num_local_experts": 8, "output_router_logits": False,
    "rms_norm_eps": 1e-05, "rope_theta": 1000000.0, "router_aux_loss_coef": 0.02,
    "sliding_window": None, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "use_cache": True, "vocab_size": 32000}


def test_config_from_hf_matches_jax_on_mixtral_8x7b():
    got = config_from_hf(MIXTRAL_8X7B)
    want = jconfig_from_hf(MIXTRAL_8X7B)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.is_moe and (got.num_experts, got.num_experts_per_tok) == (8, 2)
    assert not got.moe_grouped and got.sliding_window is None and got.head_dim == 128
    # the model_type alias
    assert config_from_hf(dict(MIXTRAL_8X7B, architectures=[])) == got


@pytest.fixture(scope="module")
def hf_model():
    jcfg, jdense, jq4k = jax_mixtral_params(seed=0)
    return jcfg, {"dense": jdense, "q4k": jq4k}


def _forward_steps(jcfg, jparams, steps, tparams=None):
    """Logits of both packages (fused params, as the pipelines serve them)
    for (start, real tokens, padded width) steps over one sequence on pages
    1..20 (token-major); decode steps feed the JAX argmax."""
    tcfg = dataclasses.replace(port_config(jcfg), moe_grouped=True)
    jcfg = dataclasses.replace(jcfg, moe_grouped=True)
    jp = jfuse.fuse_decoder_params(jparams)
    tp = tfuse.fuse_decoder_params(tparams or port_params(jparams))
    jrope, trope = jmake_rope(jcfg, LEN), make_rope(tcfg, LEN, device="cpu")
    L, H, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    jc = jpa.PagedKVCache.create(L, 21, PAGE, H, D, jnp.float32)
    tc = tpa.PagedKVCache.create(L, 21, PAGE, H, D, torch.float32, device="cpu")
    table = np.arange(1, 21, dtype=np.int64)[None]
    prompt = np.random.default_rng(1).integers(1, jcfg.vocab_size, 300)
    out = []
    for start, n, T in steps:
        ids = np.zeros((1, T), np.int64)
        pos = np.zeros((1, T), np.int64)
        p = np.arange(start, start + n)
        ids[0, :n] = prompt[start:start + n] if T > 1 else [int(out[-1][0].argmax())]
        pos[0, :n] = p
        slots = np.zeros((1, T), np.int64)
        slots[0, :n] = table[0][p // PAGE] * PAGE + p % PAGE
        kw = dict(positions=pos, slot_mapping=slots, block_tables=table,
                  kv_lens=np.array([start + T], np.int64), active=np.ones(1, np.float32))
        jm = jpa.PagedAttnMeta(**{k: jnp.asarray(v) for k, v in kw.items()},
                               first_chunk=start == 0)
        tm = tpa.PagedAttnMeta(**{k: torch.from_numpy(v) for k, v in kw.items()},
                               first_chunk=start == 0)
        h, jc = jd.decoder_forward(jp, jcfg, jrope, jnp.asarray(ids, jnp.int32), jc, jm)
        jl = np.asarray(jd.compute_logits(jp, jcfg, h[:, n - 1]))[0]
        th, _ = td.decoder_forward(tp, tcfg, trope, torch.from_numpy(ids), tc, tm)
        out.append((jl, td.compute_logits(tp, tcfg, th[:, n - 1])[0].numpy()))
    return out


STEPS = [(0, 128, 128), (128, 40, 64), (168, 1, 1), (169, 1, 1)]


@pytest.mark.parametrize("kind", ["dense", "q4k"])
def test_forward_exact_with_the_gemv_routes_off(hf_model, kind, monkeypatch):
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)
    calls = []
    monkeypatch.setattr(tgg, "grouped_matmul_ref",
                        lambda *a, f=tgg.grouped_matmul_ref: calls.append(1) or f(*a))
    jcfg, params = hf_model
    for jl, tl in _forward_steps(jcfg, params[kind], STEPS):
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        assert np.abs(tl - jl).max() <= EXACT_RTOL * np.abs(jl).max()
    assert len(calls) == 3 * jcfg.num_layers * len(STEPS)  # gate, up, down a layer


def test_isq_layout_carries_across(hf_model):
    """ISQ Q4K: Q4_K router [H, E] (padded to 16 outputs by the fusion) and
    attention; the experts dense [E, H, I] / [E, I, H], unfused."""
    jcfg, params = hf_model
    tp = tfuse.fuse_decoder_params(port_params(params["q4k"]))
    E, H, I = jcfg.num_experts, jcfg.hidden_size, jcfg.intermediate_size
    for lp in tp.layers:
        assert set(lp["mlp"]) == {"router", "experts"}
        assert lp["mlp"]["router"].kind == "gguf_q4k" and lp["mlp"]["router"].shape == (H, 16)
        ex = lp["mlp"]["experts"]
        assert [ex[k].data["w"].shape for k in ("gate", "up", "down")] == \
            [(E, H, I), (E, H, I), (E, I, H)]
        assert set(lp["attn"]) == {"qkv", "o"} and lp["attn"]["qkv"].kind == "gguf_q4k"


def _serve(jcfg, jparams, tparams, prompts, max_len=8, rq8=None):
    """Greedy sequences of the JAX Engine and the port's over the same
    params; rq8 = the Q6_K requant group on both sides (None: off)."""
    kw = dict(page_size=PAGE, num_pages=64, max_seqs=4, max_model_len=LEN,
              prefill_buckets=(64, 128), decode_steps=4)
    jeng = JEngine(JTextPipeline(jcfg, jparams, jmake_rope(jcfg, LEN),
                                 JPipelineConfig(**kw, dtype=jnp.float32)),
                   eos_token_ids=set(), prefix_cache=False)
    tcfg = port_config(jcfg)
    tpipe = TextPipeline(tcfg, tparams, make_rope(tcfg, LEN, device="cpu"),
                         PipelineConfig(**kw, dtype=torch.float32, device="cpu", rq8_group=rq8))
    assert tpipe.cfg.moe_grouped and jeng.pipeline.cfg.moe_grouped
    teng = Engine(tpipe, eos_token_ids=set(), prefix_cache=False)
    runs = []
    for eng, req, sp in ((jeng, JRequest, JSampling), (teng, GenerationRequest, SamplingParams)):
        groups = [eng.add_request(req(list(p), sp(max_len=max_len))) for p in prompts]
        while not all(g.all_done() for g in groups):
            eng.step()
        runs.append([g.seqs[0] for g in groups])
    return runs


def _check_same_generation(runs, max_len=8):
    for js, ts in zip(*runs):
        assert len(ts.generated_tokens) == max_len
        assert ts.generated_tokens == js.generated_tokens
        jv = np.array([lp.logprob for lp in js.logprobs])
        tv = np.array([lp.logprob for lp in ts.logprobs])
        assert np.abs(tv - jv).max() <= EXACT_RTOL * max(1.0, np.abs(jv).max())


def _prompts(vocab, seed=2):
    rng = np.random.default_rng(seed)
    # 150 tokens: a 128-token first chunk then 22; 40 and 100 ride along
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in (150, 40, 100)]


@pytest.mark.parametrize("kind", ["dense", "q4k"])
def test_engine_greedy_tokens_match_jax(hf_model, kind, monkeypatch):
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)
    jcfg, params = hf_model
    runs = _serve(jcfg, params[kind], port_params(params[kind]), _prompts(jcfg.vocab_size))
    _check_same_generation(runs)


# ------------------------------------------------------------- GGUF

GH, GI, GL, GHEADS, GKV, GV, GE = 256, 512, 2, 4, 2, 384, 4
GD = GH // GHEADS


def _write_mixtral_gguf(path, down_type=GGMLType.Q4_K, seed=14):
    """A tiny Mixtral GGUF as llama.cpp lays one out (general.architecture
    llama with expert_count): stacked ffn_{gate,up,down}_exps [E, out, in]
    quantized per expert, Q4_K attention with a Q6_K attn_v, a Q6_K output,
    an F32 router (ffn_gate_inp) and norms, a Q8_0 token embedding."""
    rng = np.random.default_rng(seed)

    def t(*shape, std=0.05):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def q(w, gt):
        if w.ndim == 3:
            raw = np.concatenate([kquants.quantize(w[e], gt).ravel() for e in range(w.shape[0])])
        else:
            raw = kquants.quantize(w, gt)
        return (gt, w.shape, raw)

    ones = np.ones(GH, np.float32)
    tensors = {"token_embd.weight": q(t(GV, GH, std=1.0), GGMLType.Q8_0),
               "output_norm.weight": (GGMLType.F32, (GH,), ones),
               "output.weight": q(t(GV, GH, std=0.1), GGMLType.Q6_K)}
    for i in range(GL):
        p = f"blk.{i}"
        tensors.update({
            f"{p}.attn_q.weight": q(t(GHEADS * GD, GH), GGMLType.Q4_K),
            f"{p}.attn_k.weight": q(t(GKV * GD, GH), GGMLType.Q4_K),
            f"{p}.attn_v.weight": q(t(GKV * GD, GH), GGMLType.Q6_K),
            f"{p}.attn_output.weight": q(t(GH, GHEADS * GD), GGMLType.Q4_K),
            f"{p}.ffn_gate_inp.weight": (GGMLType.F32, (GE, GH), t(GE, GH, std=0.2)),
            f"{p}.ffn_gate_exps.weight": q(t(GE, GI, GH), GGMLType.Q4_K),
            f"{p}.ffn_up_exps.weight": q(t(GE, GI, GH), GGMLType.Q4_K),
            f"{p}.ffn_down_exps.weight": q(t(GE, GH, GI), down_type),
            f"{p}.attn_norm.weight": (GGMLType.F32, (GH,), ones),
            f"{p}.ffn_norm.weight": (GGMLType.F32, (GH,), ones)})
    md = {"general.architecture": "llama", "llama.block_count": GL,
          "llama.embedding_length": GH, "llama.feed_forward_length": GI,
          "llama.attention.head_count": GHEADS, "llama.attention.head_count_kv": GKV,
          "llama.attention.layer_norm_rms_epsilon": 1e-5, "llama.rope.freq_base": 1e6,
          "llama.context_length": LEN, "llama.vocab_size": GV,
          "llama.expert_count": GE, "llama.expert_used_count": 2}
    write_gguf(str(path), md, tensors)


@pytest.fixture(scope="module")
def gguf_q4k(tmp_path_factory):
    path = tmp_path_factory.mktemp("mixtral") / "q4k.gguf"
    _write_mixtral_gguf(path)
    jcfg, jparams, _, _ = load_gguf_model(str(path), dtype=jnp.float32)
    return jcfg, jparams


def test_gguf_experts_carry_across_stacked(gguf_q4k):
    jcfg, jparams = gguf_q4k
    assert jcfg.arch == "mixtral" and jcfg.num_experts == GE
    tp = port_params(jparams)
    for lp in tp.layers:
        ex = lp["mlp"]["experts"]
        assert {k: ex[k].kind for k in ex} == {"gate": "gguf_q4k", "up": "gguf_q4k",
                                               "down": "gguf_q4k"}
        assert ex["gate"].data["qs"].shape == (GE, GH // 2, GI)
        assert ex["down"].data["scale"].shape == (GE, GI // 32, GH)
        assert lp["mlp"]["router"].kind == "dense"
        assert lp["mlp"]["router"].data["w"].shape == (GH, GE)


def test_gguf_engine_greedy_tokens_match_jax_rq8(gguf_q4k, monkeypatch):
    """Q6_K attn_v and output requantized to int8 per 32 on both sides; the
    packed experts through the every-expert branch."""
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)
    monkeypatch.setenv("MISTRALRS_Q6K_RQ8", "32")
    jcfg, jparams = gguf_q4k
    runs = _serve(jcfg, jparams, port_params(jparams), _prompts(GV, seed=3), rq8=32)
    _check_same_generation(runs)


@pytest.fixture(scope="module")
def gguf_q6k_down(tmp_path_factory):
    path = tmp_path_factory.mktemp("mixtral") / "q6k_down.gguf"
    _write_mixtral_gguf(path, down_type=GGMLType.Q6_K, seed=15)
    jcfg, jparams, _, _ = load_gguf_model(str(path), dtype=jnp.float32)
    return jcfg, jparams


def test_q6k_expert_stack_rq8_fails_in_both_packages(gguf_q6k_down, monkeypatch):
    jcfg, jparams = gguf_q6k_down
    monkeypatch.setenv("MISTRALRS_Q6K_RQ8", "32")
    with pytest.raises(ValueError):  # requant_q6k_to_q8 cannot unpack [L, E, in/2, out]
        JTextPipeline(jcfg, jparams, jmake_rope(jcfg, LEN),
                      JPipelineConfig(page_size=PAGE, num_pages=8, max_seqs=1,
                                      max_model_len=LEN, dtype=jnp.float32))
    tcfg = port_config(jcfg)
    with pytest.raises(NotImplementedError, match="rq8_group=None"):
        TextPipeline(tcfg, port_params(jparams), make_rope(tcfg, LEN, device="cpu"),
                     PipelineConfig(page_size=PAGE, num_pages=8, max_seqs=1, max_model_len=LEN,
                                    dtype=torch.float32, device="cpu", rq8_group=32))


def test_q6k_expert_stack_served_without_rq8(gguf_q6k_down, monkeypatch):
    """rq8 off on both sides; each layer's Q6_K down experts keep one
    permutation table [in] (a layer group stacks it [L, in] beside the
    [L, E, ...] codes, and params_from_reference takes index i of both)."""
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)
    monkeypatch.delenv("MISTRALRS_Q6K_RQ8", raising=False)
    jcfg, jparams = gguf_q6k_down
    tp = port_params(jparams)
    (group,), (n,) = jparams.layer_groups, jparams.group_sizes
    jdown = group["mlp"]["experts"]["down"]
    assert n == GL and np.asarray(jdown.data["ql"]).shape == (GL, GE, GI // 2, GH)
    for i, lp in enumerate(tp.layers):
        down = lp["mlp"]["experts"]["down"]
        assert down.kind == "gguf_q6k" and down.data["ql"].shape == (GE, GI // 2, GH)
        assert down.data["perm"].shape == (GI,)
        np.testing.assert_array_equal(down.data["perm"].numpy(), np.asarray(jdown.data["perm"])[i])
        np.testing.assert_array_equal(down.data["ql"].numpy(), np.asarray(jdown.data["ql"])[i])
    runs = _serve(jcfg, jparams, tp, _prompts(GV, seed=4), rq8=None)
    _check_same_generation(runs)
