"""Long-context serving of the port against the JAX package, on the tiny
Q4_K_M-mix model of tests/torch_port_model.py with max_model_len 4096, so
both packages build head-major pools by default, and 512-token chunks.

(a) decoder_forward + compute_logits on a 512-token first chunk, a ragged
    continuation chunk (400 tokens padded to 512) and two decode steps, all
    with tables 256 pages wide (span 4096): the port routes them to K6, K6'
    and K7 (their plain versions on the CPU), JAX on the CPU to gather +
    sdpa_head_major, which is the same function.
(b) Greedy tokens of the port's Engine against the JAX Engine for a
    ~2,100-token prompt (5 chunks; decode at span 4096, K7's route) and a
    ~700-token prompt (a 256-row continuation chunk on K6'); and the
    pipelines' logits for a batched prefill that mixes a row starting at 0
    with a continuation row (so not a first-chunk step: K6' serves both), as
    a prefix-cache hit beside a fresh prompt gives it.
(c) Which route each step took, counted at the plain versions, including
    both sides of the span-4096 edge of the block-table width.

Tolerances as tests/test_torch_slice.py measured them: 1e-5 of the largest
|logit| with the int8 GEMV route off (only f32 summation orders differ),
SLICE_RTOL (int8 activation rounding) with it on; the engine comparison
checks every step's top-2 margin against twice SLICE_RTOL, as
tests/test_torch_slice_engine.py does.
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
from mistralrs_tpu_torch.engine.sequence import Sequence
from mistralrs_tpu_torch.models import decoder as td
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.ops import flash_attention as tfa
from mistralrs_tpu_torch.ops import paged_attention as tpa
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
from mistralrs_tpu_torch.quant import fuse as tfuse
from torch_port_model import PAGE, SLICE_RTOL, jax_q4km_params, port_config, port_params

EXACT_RTOL = 1e-5
LEN = 4096
BUCKETS = (16, 64, 256, 512)
PIPE = dict(page_size=PAGE, num_pages=200, max_seqs=4, max_model_len=LEN,
            prefill_buckets=BUCKETS, decode_steps=4)


@pytest.fixture(scope="module")
def model():
    jcfg, jraw = jax_q4km_params(seed=0, max_position_embeddings=LEN)
    tcfg = port_config(jcfg)
    tp = tfuse.requant_q6k_params(tfuse.fuse_decoder_params(port_params(jraw)), gs=32)
    jp = jfuse.requant_q6k_params(jfuse.fuse_decoder_params(jraw), gs=32)
    return jcfg, jraw, jp, tcfg, tp


@pytest.fixture
def routes(monkeypatch):
    """Counts of the plain versions each attention route ends in."""
    class Counts(dict):
        pass

    counts = Counts(flash=0, continuation=0, decode=0, gather=0)
    counts.kv_lens = []  # (T, kv_lens) of each K6' call

    def counted(route, fn):
        def wrapped(*args, **kw):
            counts[route] += 1
            if route == "continuation":
                counts.kv_lens.append((args[0].shape[1], args[3].kv_lens.tolist()))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tfa, "flash_prefill_plain", counted("flash", tfa.flash_prefill_plain))
    monkeypatch.setattr(tpa, "flash_prefill_continuation_plain",
                        counted("continuation", tpa.flash_prefill_continuation_plain))
    monkeypatch.setattr(tpa, "paged_decode_attention_plain",
                        counted("decode", tpa.paged_decode_attention_plain))
    monkeypatch.setattr(td, "sdpa_head_major", counted("gather", td.sdpa_head_major))
    return counts


def _forward_steps(model):
    """Logits of both packages for each step, and the port's route of it."""
    jcfg, _, jp, tcfg, tp = model
    jrope, trope = jmake_rope(jcfg, LEN), make_rope(tcfg, LEN, device="cpu")
    L, H, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    MP = LEN // PAGE
    jc = jpa.PagedKVCache.create(L, MP + 1, PAGE, H, D, jnp.float32, head_major=True)
    tc = tpa.PagedKVCache.create(L, MP + 1, PAGE, H, D, torch.float32, device="cpu",
                                 head_major=True)
    table = np.arange(1, MP + 1, dtype=np.int32)[None]
    rng = np.random.default_rng(1)
    prompt = rng.integers(1, jcfg.vocab_size, 912)
    # (first position, real tokens, padded width): the continuation chunk is
    # padded from 400 to 512 rows, so kv_lens = start + 512 as the pipeline
    # sets it and the padding writes go to page 0; decode steps feed the
    # JAX argmax
    steps = [(0, 512, 512), (512, 400, 512), (912, 1, 1), (913, 1, 1)]
    out = []
    for start, n, T in steps:
        ids = np.zeros((1, T), np.int64)
        pos = np.zeros((1, T), np.int64)
        slots = np.zeros((1, T), np.int64)
        p = np.arange(start, start + n)
        ids[0, :n] = prompt[start:start + n] if T > 1 else [int(out[-1][1].argmax())]
        pos[0, :n] = p
        slots[0, :n] = table[0][p // PAGE] * PAGE + p % PAGE
        kw = dict(positions=pos, slot_mapping=slots, block_tables=table,
                  kv_lens=np.array([start + T], np.int64), active=np.ones(1, np.float32))
        jm = jpa.PagedAttnMeta(**{k: jnp.asarray(v) for k, v in kw.items()},
                               first_chunk=start == 0, head_major=True)
        tm = tpa.PagedAttnMeta(**{k: torch.from_numpy(v) for k, v in kw.items()},
                               first_chunk=start == 0, head_major=True)
        h, jc = jd.decoder_forward(jp, jcfg, jrope, jnp.asarray(ids, jnp.int32), jc, jm)
        jl = np.asarray(jd.compute_logits(jp, jcfg, h[:, n - 1]))[0]
        th, _ = td.decoder_forward(tp, tcfg, trope, torch.from_numpy(ids), tc, tm)
        tl = td.compute_logits(tp, tcfg, th[:, n - 1])[0].numpy()
        out.append((td._attention_route(tcfg, T, tm, MP * PAGE), jl, tl))
    return out


def test_forward_exact_without_int8_route(model, monkeypatch, routes):
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)  # every GEMV dequantizes
    steps = _forward_steps(model)
    assert [r for r, _, _ in steps] == ["flash", "continuation", "decode", "decode"]
    for _, jl, tl in steps:
        assert np.abs(tl - jl).max() <= EXACT_RTOL * np.abs(jl).max()
    L = model[0].num_layers
    assert routes == {"flash": L, "continuation": L, "decode": 2 * L, "gather": 0}


def test_forward_int8_route_within_q8_tolerance(model):
    for _, jl, tl in _forward_steps(model):
        assert np.abs(tl - jl).max() <= SLICE_RTOL * np.abs(jl).max()
        assert tl.argmax() == jl.argmax()


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in (2100, 700)]


def test_engine_greedy_tokens_match_jax(model, monkeypatch, routes):
    jcfg, jraw, jp, tcfg, _ = model
    prompts = _prompts(jcfg.vocab_size)
    max_len = 8
    monkeypatch.setenv("MISTRALRS_Q6K_RQ8", "32")
    jpipe = JTextPipeline(jcfg, jraw, jmake_rope(jcfg, LEN),
                          JPipelineConfig(dtype=jnp.float32, **PIPE))
    tpipe = TextPipeline(tcfg, port_params(jraw), make_rope(tcfg, LEN, device="cpu"),
                         PipelineConfig(dtype=torch.float32, device="cpu", **PIPE))
    assert jpipe.head_major and tpipe.head_major and tpipe.cache.head_major
    runs = []
    for eng, req, sp in ((JEngine(jpipe, eos_token_ids=set(), prefix_cache=False), JRequest,
                          JSampling),
                         (Engine(tpipe, eos_token_ids=set(), prefix_cache=False),
                          GenerationRequest, SamplingParams)):
        groups = [eng.add_request(req(list(p), sp(max_len=max_len))) for p in prompts]
        while not all(g.all_done() for g in groups):
            eng.step()
        runs.append([g.seqs[0] for g in groups])
    # every route of the slice was taken: the first chunks on K6, the 700
    # prompt's 188-token chunk (a 512-row batch with the long prompt) on
    # K6', the long prompt's 52-token last chunk and the short prompt's
    # lone decode (span 1024) on the gather route, and decode of the long
    # prompt (span 4096) on K7
    assert all(n > 0 for n in routes.values()), routes

    jrope = jmake_rope(jcfg, LEN)
    for js, ts, prompt in zip(*runs, prompts):
        assert len(js.generated_tokens) == max_len
        assert ts.generated_tokens == js.generated_tokens
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
        logits = np.asarray(jd.compute_logits(jp, jcfg, h[0, len(prompt) - 1:]))
        top2 = np.sort(logits, axis=1)[:, -2:]
        scale = np.abs(logits).max(axis=1)
        # no near-tie: every step's margin is twice the int8 tolerance
        assert (top2[:, 1] - top2[:, 0] > 2 * SLICE_RTOL * scale).all()
        assert list(logits.argmax(axis=1)) == js.generated_tokens
        jv = np.array([lp.logprob for lp in js.logprobs])
        tv = np.array([lp.logprob for lp in ts.logprobs])
        assert (np.abs(tv - jv) <= SLICE_RTOL * scale).all()


def test_mixed_prefill_batch_matches_jax(model, monkeypatch, routes):
    from mistralrs_tpu.engine.sequence import Sequence as JSequence

    jcfg, jraw, _, tcfg, _ = model
    monkeypatch.setenv("MISTRALRS_Q6K_RQ8", "32")
    jpipe = JTextPipeline(jcfg, jraw, jmake_rope(jcfg, LEN),
                          JPipelineConfig(dtype=jnp.float32, **PIPE))
    tpipe = TextPipeline(tcfg, port_params(jraw), make_rope(tcfg, LEN, device="cpu"),
                         PipelineConfig(dtype=torch.float32, device="cpu", **PIPE))
    rng = np.random.default_rng(4)
    long_p, short_p = ([int(t) for t in rng.integers(1, jcfg.vocab_size, n)] for n in (1024, 300))
    logits = []
    for pipe, seq_cls, sp in ((jpipe, JSequence, JSampling), (tpipe, Sequence, SamplingParams)):
        a, b = seq_cls(long_p, sp(max_len=1)), seq_cls(short_p, sp(max_len=1))
        a.block_table, b.block_table = list(range(1, 65)), list(range(65, 85))
        pipe.run_prefill_chunks([(a, long_p[:512])])
        # a continues at 512 while b starts at 0: one 2 x 512 step
        pipe.run_prefill_chunks([(a, long_p[512:]), (b, short_p)])
        assert (a.prefill_done_tokens, b.prefill_done_tokens) == (1024, 300)
        logits.append(np.stack([np.asarray(pipe.fetch_full_logits_row(i)) for i in (0, 1)]))
    assert routes.kv_lens and all(c == (512, [1024, 512]) for c in routes.kv_lens)
    jl, tl = logits
    scale = np.abs(jl).max(axis=1)
    assert (np.abs(tl - jl).max(axis=1) <= SLICE_RTOL * scale).all()
    assert (tl.argmax(axis=1) == jl.argmax(axis=1)).all()


@pytest.mark.parametrize("kv_len,route", [(2047, "gather"), (2048, "decode")])
def test_decode_route_at_the_span_edge(model, routes, kv_len, route):
    """A decode step writes position kv_len, so the table must cover kv_len
    + 1 tokens: 2,048 fit 128 pages (span 2048, the gather route), 2,049
    need 256 (span 4096, K7)."""
    _, jraw, _, tcfg, _ = model
    pipe = TextPipeline(tcfg, port_params(jraw), make_rope(tcfg, LEN, device="cpu"),
                        PipelineConfig(dtype=torch.float32, device="cpu", **PIPE))
    seq = Sequence([1 + i % 97 for i in range(kv_len + 1)], SamplingParams(max_len=1))
    seq.block_table = list(range(1, 2 + kv_len // PAGE))
    seq.kv_len = seq.prefill_done_tokens = kv_len
    assert pipe._table_width([seq], 1) * PAGE == (4096 if route == "decode" else 2048)
    logits = pipe.run_decode([seq])
    assert logits.shape == (1, tcfg.vocab_size) and np.isfinite(logits).all()
    assert {r: n for r, n in routes.items() if n} == {route: tcfg.num_layers}
