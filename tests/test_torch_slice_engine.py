"""The port's Engine against the JAX Engine on the tiny Q4_K_M-mix model of
tests/torch_port_model.py: greedy tokens and their logits for 3 requests
served together (batched first-chunk prefill, a continuation chunk, greedy
multistep decode), the device sampling paths it serves (the top-K pack,
the sampled multistep loop) and what it refuses.

Tolerance: SLICE_RTOL of tests/torch_port_model.py (int8 activation
rounding; measured at most 1.03% of a step's largest |logit|, allowed 3%).
Every step's top-2 margin in the JAX model is checked to exceed twice that,
so a near-tie cannot flip a token.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.engine.engine import Engine as JEngine
from mistralrs_tpu.engine.engine import GenerationRequest as JRequest
from mistralrs_tpu.engine.sampler import SamplingParams as JSampling
from mistralrs_tpu.models import decoder as jd
from mistralrs_tpu.models.loader import make_rope as jmake_rope
from mistralrs_tpu.ops import paged_attention as jpa
from mistralrs_tpu.pipeline.text import PipelineConfig as JPipelineConfig
from mistralrs_tpu.pipeline.text import TextPipeline as JTextPipeline
from mistralrs_tpu.quant import fuse as jfuse
from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
from torch_port_model import (  # noqa: F401 (one_thread is a fixture)
    PAGE, SLICE_RTOL, jax_q4km_params, one_thread, port_config, port_params)


@pytest.fixture(scope="module")
def model():
    jcfg, jraw = jax_q4km_params(seed=0)
    jp = jfuse.requant_q6k_params(jfuse.fuse_decoder_params(jraw), gs=32)
    return jcfg, jraw, jp, port_config(jcfg)


def _port_engine(model):
    _, jraw, _, tcfg = model
    pc = PipelineConfig(page_size=PAGE, num_pages=64, max_seqs=4, max_model_len=512,
                        prefill_buckets=(64, 128), decode_steps=4, dtype=torch.float32,
                        device="cpu")
    return Engine(TextPipeline(tcfg, port_params(jraw), make_rope(tcfg, 512, device="cpu"), pc),
                  eos_token_ids=set(), prefix_cache=False)


def _prompts(vocab):
    rng = np.random.default_rng(2)
    # 150 tokens: a 128-token first chunk (flash) then a 22-token chunk
    # (gather + sdpa); 40 and 100 tokens ride in the same first batch
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in (150, 40, 100)]


def test_engine_greedy_tokens_match_jax(model, monkeypatch):
    jcfg, jraw, jp, _ = model
    prompts = _prompts(jcfg.vocab_size)
    max_len = 8
    monkeypatch.setenv("MISTRALRS_Q6K_RQ8", "32")
    jeng = JEngine(JTextPipeline(jcfg, jraw, jmake_rope(jcfg, 512), JPipelineConfig(
        page_size=PAGE, num_pages=64, max_seqs=4, max_model_len=512,
        prefill_buckets=(64, 128), decode_steps=4, dtype=jnp.float32)),
        eos_token_ids=set(), prefix_cache=False)
    teng = _port_engine(model)
    runs = []
    for eng, req, sp in ((jeng, JRequest, JSampling), (teng, GenerationRequest, SamplingParams)):
        groups = [eng.add_request(req(list(p), sp(max_len=max_len))) for p in prompts]
        while not all(g.all_done() for g in groups):
            eng.step()
        runs.append([g.seqs[0] for g in groups])
    jrope = jmake_rope(jcfg, 512)
    for js, ts, prompt in zip(*runs, prompts):
        assert ts.generated_tokens == js.generated_tokens
        assert len(ts.generated_tokens) == max_len
        # the JAX model's logits at every position, in one teacher-forced pass
        toks = np.asarray(js.tokens[:-1])[None]
        T = toks.shape[1]
        table = np.arange(1, 1 + -(-T // PAGE), dtype=np.int32)[None]
        pos = np.arange(T)
        meta = jpa.PagedAttnMeta(
            positions=jnp.asarray(pos[None], jnp.int32),
            slot_mapping=jnp.asarray((table[0][pos // PAGE] * PAGE + pos % PAGE)[None], jnp.int32),
            block_tables=jnp.asarray(table), kv_lens=jnp.asarray([T], jnp.int32),
            active=jnp.ones((1,), jnp.float32), first_chunk=True)
        cache = jpa.PagedKVCache.create(jcfg.num_layers, table.shape[1] + 1, PAGE,
                                        jcfg.num_kv_heads, jcfg.head_dim, jnp.float32)
        h, _ = jd.decoder_forward(jp, jcfg, jrope, jnp.asarray(toks, jnp.int32), cache, meta)
        logits = np.asarray(jd.compute_logits(jp, jcfg, h[0, len(prompt) - 1:]))  # [max_len, V]
        top2 = np.sort(logits, axis=1)[:, -2:]
        scale = np.abs(logits).max(axis=1)
        # no near-tie: every step's margin is twice the int8 tolerance
        assert (top2[:, 1] - top2[:, 0] > 2 * SLICE_RTOL * scale).all()
        assert list(logits.argmax(axis=1)) == js.generated_tokens
        # the greedy logprob is the chosen token's raw logit on both sides
        jv = np.array([lp.logprob for lp in js.logprobs])
        tv = np.array([lp.logprob for lp in ts.logprobs])
        assert (np.abs(tv - jv) <= SLICE_RTOL * scale).all()


def _spied(eng, name):
    """Record the keyword / sampling argument of every call of a pipeline
    method."""
    calls = []
    orig = getattr(eng.pipeline, name)

    def spy(seqs, *args, **kw):
        calls.append((args, kw))
        return orig(seqs, *args, **kw)

    setattr(eng.pipeline, name, spy)
    return calls


def test_port_engine_serves_sampled_requests_on_the_host(model, one_thread):
    """A sampled request with its own seed (which the device loop's shared
    seed cannot serve), batched with a greedy one: the host draws from the
    device top-K pack of each step (run_decode mode "topk")."""
    eng = _port_engine(model)
    topk = _spied(eng, "run_decode")
    prompts = _prompts(model[0].vocab_size)
    sampled = eng.add_request(GenerationRequest(prompts[1], SamplingParams(
        max_len=5, temperature=0.8, top_k=20, seed=3)))
    greedy = eng.add_request(GenerationRequest(prompts[2], SamplingParams(max_len=5)))
    while not (sampled.all_done() and greedy.all_done()):
        eng.step()
    for g in (sampled, greedy):
        seq = g.seqs[0]
        assert len(seq.generated_tokens) == 5 and seq.stop_reason.value == "length"
        assert all(0 <= t < model[0].vocab_size for t in seq.generated_tokens)
    assert topk and all(kw.get("mode") == "topk" for _, kw in topk)


def test_port_engine_serves_sampled_multistep(model, monkeypatch, one_thread):
    """Sampled requests the device loop can serve (temperature, an explicit
    top-k <= TOPK_PACK, top-p, min-p; no own seed), batched with a greedy
    one: every decode call is run_decode_multi with the sampling arguments,
    the greedy row as (1.0, 1, 1.0, 0.0). (The GEMVs dequantize: the
    route, not the int8 rounding, is under test.)"""
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)
    eng = _port_engine(model)
    multi = _spied(eng, "run_decode_multi")
    prompts = _prompts(model[0].vocab_size)
    # two prompts of one first prefill batch, so they decode together
    groups = [eng.add_request(GenerationRequest(prompts[1], SamplingParams(
                  max_len=9, temperature=0.8, top_k=40, top_p=0.95, min_p=0.05))),
              eng.add_request(GenerationRequest(prompts[2], SamplingParams(max_len=9)))]
    while not all(g.all_done() for g in groups):
        eng.step()
    for g in groups:
        seq = g.seqs[0]
        assert len(seq.generated_tokens) == 9 and seq.stop_reason.value == "length"
        assert all(0 <= t < model[0].vocab_size for t in seq.generated_tokens)
    assert multi and all(args and args[0] is not None for args, _ in multi)
    temps, top_ks, top_ps, min_ps, seed = multi[0][0][0]
    assert (temps, top_ks, top_ps, min_ps) == ([0.8, 1.0], [40, 1], [0.95, 1.0], [0.05, 0.0])
    assert isinstance(seed, int)


def test_port_engine_serves_the_topk_pack_and_sampled_multistep(model):
    pipe = _port_engine(model).pipeline
    assert pipe.supports_topk_pack and pipe.supports_sampled_multistep


def test_port_engine_refuses_what_is_not_ported(model):
    eng = _port_engine(model)

    class Constraint:
        kind = "regex"

    with pytest.raises(NotImplementedError):
        eng.add_request(GenerationRequest([1, 2, 3], constraint=Constraint()))
    # KV swap is ported: swap mode hands the scheduler the engine's swapper
    swap = Engine(eng.pipeline, eos_token_ids=set(), prefix_cache=False, preempt_mode="swap")
    assert swap.scheduler.preempt_mode == "swap" and swap.scheduler.swapper == swap._swap_out_seq
