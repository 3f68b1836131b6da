"""The port's decoder and engine against the JAX package on a tiny Gemma-2
(tests/torch_port_model.py jax_gemma2_params): 4 layers, so two local
(window 48) and two global; sandwich norms, gelu-tanh, an embedding scale,
logit soft caps 50 and 30, head dim 64; loaded dense in f32 or with every
projection ISQ'd to Q4_K, the tied embedding as the lm_head.

(a) decoder_forward + compute_logits, GEMV routes off (every projection
    dequantizes, as the JAX CPU path does): a 128-token first chunk (the
    port takes K11's plain version, windowed on the even layers; JAX on the
    CPU the masked gather + sdpa), a 128-row continuation chunk (gather:
    K6' rejects the soft cap), decode steps, and a 64-token first chunk;
    on head-major pools a 512-token first chunk, a 512-token continuation
    chunk and decode at span 4096 (K7's plain version with the soft cap).
    1e-5 of the largest |logit|: only f32 summation orders differ.
(b) Greedy tokens of the port's Engine (Q4_K through K1's plain version)
    against the JAX Engine, and their logprobs within Q8_RTOL; every step's
    top-2 margin in the JAX model is checked to exceed twice that.
(c) Which route each step took, counted at the plain versions.

Q8_RTOL: the int8 activation rounding of K1 moves this model's logits more
than the Mistral-mix model's (its weights are drawn wide, so that the caps
bite, and its attention is sharp): measured at most 4.8% of a step's
largest |logit| over 7 steps (rms 8.5% of the logits' rms), with every
argmax kept; the tests allow 10%.
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
from mistralrs_tpu_torch.models import decoder as td
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.ops import flash_attention as tfa
from mistralrs_tpu_torch.ops import paged_attention as tpa
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.ops import splash as tsp
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
from mistralrs_tpu_torch.quant import fuse as tfuse
from torch_port_model import PAGE, jax_gemma2_params, port_config, port_params

EXACT_RTOL = 1e-5
Q8_RTOL = 0.1
LEN = 4096


@pytest.fixture(scope="module")
def model():
    jcfg, jq4k, jdense = jax_gemma2_params(seed=0)
    return jcfg, {"q4k": jq4k, "dense": jdense}, port_config(jcfg)


@pytest.fixture
def routes(monkeypatch):
    """Counts of the plain versions each attention route ends in, and the
    windows the splash route was given."""
    class Counts(dict):
        pass

    counts = Counts(flash=0, splash=0, continuation=0, decode=0, gather=0)
    counts.windows = []

    def counted(route, fn):
        def wrapped(*args, **kw):
            counts[route] += 1
            if route == "splash":
                counts.windows.append(kw["sliding_window"])
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tfa, "flash_prefill_plain", counted("flash", tfa.flash_prefill_plain))
    monkeypatch.setattr(tsp, "splash_prefill_plain", counted("splash", tsp.splash_prefill_plain))
    monkeypatch.setattr(tpa, "flash_prefill_continuation_plain",
                        counted("continuation", tpa.flash_prefill_continuation_plain))
    monkeypatch.setattr(tpa, "paged_decode_attention_plain",
                        counted("decode", tpa.paged_decode_attention_plain))
    monkeypatch.setattr(td, "sdpa", counted("gather", td.sdpa))
    monkeypatch.setattr(td, "sdpa_head_major", counted("gather", td.sdpa_head_major))
    return counts


def _both(model, kind, window=None):
    """Both packages' configs (with another sliding window, if given) and
    fused params."""
    import dataclasses

    jcfg, params, tcfg = model
    if window is not None:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        tcfg = dataclasses.replace(tcfg, sliding_window=window)
    jp = jfuse.fuse_decoder_params(params[kind])
    tp = tfuse.fuse_decoder_params(port_params(params[kind]))
    return jcfg, jp, tcfg, tp


def _forward_steps(model, kind, steps, head_major, window=None):
    """Logits of both packages and the port's route for each (start, real
    tokens, padded width) step over one sequence on pages 1.. of a table
    LEN / PAGE pages wide (head-major) or 20 pages wide (token-major);
    decode steps feed the JAX argmax."""
    jcfg, jp, tcfg, tp = _both(model, kind, window)
    jrope, trope = jmake_rope(jcfg, LEN), make_rope(tcfg, LEN, device="cpu")
    L, H, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    MP = LEN // PAGE if head_major else 20
    jc = jpa.PagedKVCache.create(L, MP + 1, PAGE, H, D, jnp.float32, head_major=head_major)
    tc = tpa.PagedKVCache.create(L, MP + 1, PAGE, H, D, torch.float32, device="cpu",
                                 head_major=head_major)
    table = np.arange(1, MP + 1, dtype=np.int64)[None]
    prompt = np.random.default_rng(1).integers(1, jcfg.vocab_size, 2048)
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
                               first_chunk=start == 0, head_major=head_major)
        tm = tpa.PagedAttnMeta(**{k: torch.from_numpy(v) for k, v in kw.items()},
                               first_chunk=start == 0, head_major=head_major)
        h, jc = jd.decoder_forward(jp, jcfg, jrope, jnp.asarray(ids, jnp.int32), jc, jm)
        jl = np.asarray(jd.compute_logits(jp, jcfg, h[:, n - 1]))[0]
        th, _ = td.decoder_forward(tp, tcfg, trope, torch.from_numpy(ids), tc, tm)
        tl = td.compute_logits(tp, tcfg, th[:, n - 1])[0].numpy()
        out.append((td._attention_route(tcfg, T, tm, MP * PAGE), jl, tl))
    return out


def _check_exact(steps):
    for _, jl, tl in steps:
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        assert np.abs(tl - jl).max() <= EXACT_RTOL * np.abs(jl).max()


def test_the_caps_and_windows_bite(model):
    """Each Gemma-2 feature moves the tiny model's logits by far more than
    the tolerance, so the comparisons below see it."""
    import dataclasses

    jcfg, params, _ = model
    jp = jfuse.fuse_decoder_params(params["dense"])
    jrope = jmake_rope(jcfg, 512)
    T = 64
    table = np.arange(1, 5, dtype=np.int32)[None]
    ids = np.random.default_rng(1).integers(1, jcfg.vocab_size, (1, T))
    pos = np.arange(T)
    meta = jpa.PagedAttnMeta(
        positions=jnp.asarray(pos[None], jnp.int32),
        slot_mapping=jnp.asarray((table[0][pos // PAGE] * PAGE + pos % PAGE)[None], jnp.int32),
        block_tables=jnp.asarray(table), kv_lens=jnp.asarray([T], jnp.int32),
        active=jnp.ones((1,), jnp.float32), first_chunk=True)

    def logits(cfg):
        cache = jpa.PagedKVCache.create(cfg.num_layers, 5, PAGE, cfg.num_kv_heads, cfg.head_dim,
                                        jnp.float32)
        h, _ = jd.decoder_forward(jp, cfg, jrope, jnp.asarray(ids, jnp.int32), cache, meta)
        return np.asarray(jd.compute_logits(jp, cfg, h[0]))

    base = logits(jcfg)
    for change in (dict(attn_logit_softcap=None), dict(final_logit_softcap=None),
                   dict(sliding_window_pattern="none")):
        other = logits(dataclasses.replace(jcfg, **change))
        assert np.abs(other - base).max() > 100 * EXACT_RTOL * np.abs(base).max(), change


@pytest.mark.parametrize("kind", ["dense", "q4k"])
def test_forward_exact_token_major(model, kind, monkeypatch, routes):
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)  # every GEMV dequantizes
    steps = _forward_steps(model, kind, [(0, 128, 128), (128, 100, 128), (228, 1, 1),
                                         (229, 1, 1)], head_major=False)
    assert [r for r, _, _ in steps] == ["splash", "gather", "gather", "gather"]
    _check_exact(steps)
    L = model[0].num_layers
    assert dict(routes) == {"flash": 0, "splash": L, "continuation": 0, "decode": 0,
                            "gather": 3 * L}
    # windowed on the even (local) layers only
    assert routes.windows == [48, None, 48, None]


def test_forward_exact_first_chunk_of_64(model, monkeypatch, routes):
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)
    steps = _forward_steps(model, "q4k", [(0, 40, 64), (40, 1, 1)], head_major=False)
    assert [r for r, _, _ in steps] == ["gather", "gather"]
    _check_exact(steps)
    assert routes["splash"] == 0


@pytest.mark.parametrize("window,decode", [(4096, "decode"), (48, "gather")])
def test_forward_exact_head_major_span_4096(model, monkeypatch, routes, window, decode):
    """Gemma-2-9B's window of 4096 holds a span of 4096, so decode there
    takes K7 (soft cap included); the tiny model's 48 clips it, so decode
    gathers. Either way the first chunk takes K11 (for its soft cap) and the
    continuation chunk gathers (K6' rejects the soft cap)."""
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)
    steps = _forward_steps(model, "q4k", [(0, 512, 512), (512, 400, 512), (912, 1, 1),
                                          (913, 1, 1)], head_major=True, window=window)
    assert [r for r, _, _ in steps] == ["splash", "gather", decode, decode]
    _check_exact(steps)
    L = model[0].num_layers
    k7 = 2 * L if decode == "decode" else 0
    assert dict(routes) == {"flash": 0, "splash": L, "continuation": 0, "decode": k7,
                            "gather": 3 * L - k7}
    assert routes.windows == [window, None] * (L // 2)


def test_forward_through_k1_within_q8_tolerance(model):
    for _, jl, tl in _forward_steps(model, "q4k", [(0, 128, 128), (128, 1, 1), (129, 1, 1)],
                                    head_major=False):
        assert 0 < np.abs(tl - jl).max() <= Q8_RTOL * np.abs(jl).max()
        assert tl.argmax() == jl.argmax()


def test_fusion_and_pipeline_keep_the_tied_head(model):
    """q|k|v (three Q4_K linears) and gate|up fuse; the lm_head stays None
    through fusion, out-padding and the Q6_K requant, so the logits come
    from the tied embedding and the final soft cap bounds them."""
    jcfg, params, tcfg = model
    pipe = TextPipeline(tcfg, port_params(params["q4k"]), make_rope(tcfg, 512, device="cpu"),
                        PipelineConfig(page_size=PAGE, num_pages=32, max_seqs=2,
                                       max_model_len=512, prefill_buckets=(64, 128),
                                       dtype=torch.float32, device="cpu"))
    assert pipe.params.lm_head is None and not pipe.head_major
    for lp in pipe.params.layers:
        assert set(lp["attn"]) == {"qkv", "o"} and set(lp["mlp"]) == {"gateup", "down"}
        assert lp["attn"]["qkv"].kind == lp["mlp"]["gateup"].kind == "gguf_q4k"
        assert lp["attn"]["qkv"].shape == (256, (4 + 2 + 2) * 64)
        assert {"pre_mlp_norm", "post_mlp_norm"} <= set(lp)
    from mistralrs_tpu_torch.engine.sequence import Sequence

    seq = Sequence(list(range(1, 101)), SamplingParams(max_len=1))
    seq.block_table = list(range(1, 8))
    logits = pipe.run_prefill_chunk(seq, seq.tokens)
    assert logits.shape == (jcfg.vocab_size,) and np.abs(logits).max() < 30.0


def test_engine_greedy_tokens_match_jax(model, routes):
    jcfg, params, tcfg = model
    rng = np.random.default_rng(2)
    # 150 tokens: a 128-token first chunk (splash, batched with the others'
    # first chunks), then a 22-token chunk; 40 and 100 tokens ride along
    prompts = [[int(t) for t in rng.integers(1, jcfg.vocab_size, n)] for n in (150, 40, 100)]
    max_len = 8
    kw = dict(page_size=PAGE, num_pages=64, max_seqs=4, max_model_len=512,
              prefill_buckets=(64, 128), decode_steps=4)
    jeng = JEngine(JTextPipeline(jcfg, params["q4k"], jmake_rope(jcfg, 512),
                                 JPipelineConfig(**kw, dtype=jnp.float32)),
                   eos_token_ids=set(), prefix_cache=False)
    teng = Engine(TextPipeline(tcfg, port_params(params["q4k"]),
                               make_rope(tcfg, 512, device="cpu"),
                               PipelineConfig(**kw, dtype=torch.float32, device="cpu")),
                  eos_token_ids=set(), prefix_cache=False)
    runs = []
    for eng, req, sp in ((jeng, JRequest, JSampling), (teng, GenerationRequest, SamplingParams)):
        groups = [eng.add_request(req(list(p), sp(max_len=max_len))) for p in prompts]
        while not all(g.all_done() for g in groups):
            eng.step()
        runs.append([g.seqs[0] for g in groups])
    assert routes["splash"] > 0 and routes["gather"] > 0

    jp = jfuse.fuse_decoder_params(params["q4k"])
    jrope = jmake_rope(jcfg, 512)
    for js, ts, prompt in zip(*runs, prompts):
        assert len(ts.generated_tokens) == max_len
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
        assert (top2[:, 1] - top2[:, 0] > 2 * Q8_RTOL * scale).all()
        assert list(logits.argmax(axis=1)) == js.generated_tokens
        jv = np.array([lp.logprob for lp in js.logprobs])
        tv = np.array([lp.logprob for lp in ts.logprobs])
        assert (np.abs(tv - jv) <= Q8_RTOL * scale).all()
