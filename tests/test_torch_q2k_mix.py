"""The port against the JAX package on a tiny model in llama.cpp's Q2_K mix:
decoder logits, the route each projection takes, and greedy engine tokens.

The model (tests/torch_port_model.py jax_q2k_params) is 3 layers wide as
512: q, k, gate, up in Q2_K; v in Q4_K; o and down in Q3_K (packed into the
Q6_K layout); the lm_head in Q6_K. Both packages fuse q|k and gate|up, pad
the lm_head and requantize the Q6_K-layout tensors to int8 per 32 (rq8;
JAX through MISTRALRS_Q6K_RQ8=32), so the port serves q|k and gate|up on
K10, v on K1, o, down and the lm_head on K2. The JAX package's CPU path
dequantizes every projection (exact f32).

Tolerances:
- with the GEMV routes off (MAX_KERNEL_ROWS = -1, every projection
  dequantizes) only f32 summation orders differ: 1e-6 of the largest logit;
- through the plain K10 (f32 here: exact products), K1 and K2 the int8
  activation rounding of K1 and K2 adds up over the layers: SLICE_RTOL (3%)
  of the largest logit, as for the Q4_K_M model.
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
from mistralrs_tpu_torch.ops import paged_attention as tpa
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
from mistralrs_tpu_torch.quant import fuse as tfuse
from torch_port_model import PAGE, SLICE_RTOL, jax_q2k_params, port_config, port_params

EXACT_RTOL = 1e-6


@pytest.fixture(scope="module")
def model():
    jcfg, jraw = jax_q2k_params(seed=0)
    tcfg = port_config(jcfg)
    tp = tfuse.requant_q6k_params(tfuse.fuse_decoder_params(port_params(jraw)), gs=32)
    jp = jfuse.requant_q6k_params(jfuse.fuse_decoder_params(jraw), gs=32)
    return jcfg, jraw, jp, tcfg, tp


@pytest.fixture
def routes(monkeypatch):
    """Which plain kernel each projection went through: (rows, in, out)."""
    seen = {"k10": [], "k1": [], "k2": []}

    def counted(route, fn, out_arg):
        def wrapped(x, *args, **kw):
            seen[route].append((x.shape[0], x.shape[1], args[out_arg].shape[1]))
            return fn(x, *args, **kw)
        return wrapped

    monkeypatch.setattr(tqm, "affine_gemv_plain", counted("k10", tqm.affine_gemv_plain, 0))
    monkeypatch.setattr(tqm, "q4k_q8_gemv_plain", counted("k1", tqm.q4k_q8_gemv_plain, 0))
    monkeypatch.setattr(tqm, "q8_0_q8_gemv_plain", counted("k2", tqm.q8_0_q8_gemv_plain, 0))
    return seen


def _forward_steps(model, n_decode):
    """Logits of both packages for a 128-token first chunk, then n_decode
    greedy steps (both fed the JAX argmax)."""
    jcfg, _, jp, tcfg, tp = model
    jrope, trope = jmake_rope(jcfg, 512), make_rope(tcfg, 512, device="cpu")
    L, H, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    jc = jpa.PagedKVCache.create(L, 16, PAGE, H, D, jnp.float32)
    tc = tpa.PagedKVCache.create(L, 16, PAGE, H, D, torch.float32, device="cpu")
    T = 128
    table = np.arange(1, 11, dtype=np.int32)[None]
    tok = np.random.default_rng(1).integers(1, jcfg.vocab_size, (1, T))
    out = []
    for step in range(1 + n_decode):
        pos = np.arange(T) if step == 0 else np.array([T + step - 1])
        kw = dict(positions=pos[None].astype(np.int32),
                  slot_mapping=(table[0][pos // PAGE] * PAGE + pos % PAGE)[None].astype(np.int32),
                  block_tables=table, kv_lens=np.array([pos[-1] + 1], np.int32),
                  active=np.ones(1, np.float32))
        jm = jpa.PagedAttnMeta(**{k: jnp.asarray(v) for k, v in kw.items()}, first_chunk=step == 0)
        tm = tpa.PagedAttnMeta(**{k: torch.from_numpy(v) for k, v in kw.items()},
                               first_chunk=step == 0)
        h, jc = jd.decoder_forward(jp, jcfg, jrope, jnp.asarray(tok, jnp.int32), jc, jm)
        jl = np.asarray(jd.compute_logits(jp, jcfg, h[:, -1]))[0]
        th, _ = td.decoder_forward(tp, tcfg, trope, torch.from_numpy(tok), tc, tm)
        tl = td.compute_logits(tp, tcfg, th[:, -1])[0].numpy()
        out.append((jl, tl))
        tok = np.array([[int(jl.argmax())]])
    return out


def test_fused_params_in_the_q2k_mix(model):
    _, _, jp, _, tp = model
    for lp in tp.layers:
        assert set(lp["attn"]) == {"qk", "v", "o"} and set(lp["mlp"]) == {"gateup", "down"}
        kinds = {k: lin.kind for part in ("attn", "mlp") for k, lin in lp[part].items()}
        assert kinds == {"qk": "gguf_q2k", "v": "gguf_q4k", "o": "gguf_q8_0",
                         "gateup": "gguf_q2k", "down": "gguf_q8_0"}
        assert lp["mlp"]["gateup"].shape == (512, 2048)
        assert tuple(lp["mlp"]["gateup"].data["q"].shape) == (128, 2048)
    assert tp.lm_head.kind == "gguf_q8_0" and tp.lm_head.shape == (512, 2048)
    jqk = jp.layer_groups[0]["attn"]["qk"]
    np.testing.assert_array_equal(tp.layers[0]["attn"]["qk"].data["q"].numpy(),
                                  np.asarray(jqk.data["q"])[0])


def test_forward_exact_without_kernel_routes(model, monkeypatch, routes):
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)  # every GEMV dequantizes
    for jl, tl in _forward_steps(model, n_decode=2):
        assert tl.shape == jl.shape == (model[0].vocab_size,)
        assert np.abs(tl - jl).max() <= EXACT_RTOL * np.abs(jl).max()
    assert routes == {"k10": [], "k1": [], "k2": []}


def test_forward_through_k10_k1_k2_within_q8_tolerance(model, routes):
    steps = _forward_steps(model, n_decode=3)
    for jl, tl in steps:
        err = np.abs(tl - jl).max()
        assert 0 < err <= SLICE_RTOL * np.abs(jl).max()
        assert tl.argmax() == jl.argmax()
    # the 128-row first chunk and each decode row: K10 for q|k (512 -> 768)
    # and gate|up (512 -> 2048), K1 for v, K2 for o, down and the lm_head
    # (the lm_head on the last row only)
    L = model[0].num_layers
    assert sorted(set(routes["k10"])) == [(1, 512, 768), (1, 512, 2048), (128, 512, 768),
                                          (128, 512, 2048)]
    assert len(routes["k10"]) == 4 * 2 * L
    assert sorted(set(routes["k1"])) == [(1, 512, 256), (128, 512, 256)]
    assert len(routes["k1"]) == 4 * L
    assert sorted(set(routes["k2"])) == [(1, 512, 512), (1, 512, 2048), (1, 1024, 512),
                                         (128, 512, 512), (128, 1024, 512)]
    assert len(routes["k2"]) == 4 * (2 * L + 1)


def test_k10_route_alone_is_exact_in_f32(model, monkeypatch, routes):
    """With only K1 and K2 off (their int8 rounding), the plain K10 in f32
    agrees with JAX's dequantized product to the sum-order tolerance."""
    monkeypatch.setattr(tqm, "q4k_matmul", lambda lin, x: _dequant_matmul(lin, x))
    monkeypatch.setattr(tqm, "q8_0_matmul", lambda lin, x: _dequant_matmul(lin, x))
    for jl, tl in _forward_steps(model, n_decode=2):
        assert np.abs(tl - jl).max() <= 1e-5 * np.abs(jl).max()
    assert routes["k10"] and routes["k1"] == routes["k2"] == []


def _dequant_matmul(lin, x):
    from mistralrs_tpu_torch.quant.gguf_linear import _ref_forward

    return _ref_forward(lin, x)


def test_engine_greedy_tokens_match_jax(model, monkeypatch):
    """rq8 on both sides. 3 requests: a 150-token prompt (a 128-token first
    chunk, then 22 tokens), 40 and 100 tokens, 8 greedy tokens each."""
    jcfg, jraw, _, tcfg, _ = model
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, jcfg.vocab_size, n)] for n in (150, 40, 100)]
    max_len = 8
    monkeypatch.setenv("MISTRALRS_Q6K_RQ8", "32")
    kw = dict(page_size=PAGE, num_pages=64, max_seqs=4, max_model_len=512,
              prefill_buckets=(64, 128), decode_steps=4)
    jeng = JEngine(JTextPipeline(jcfg, jraw, jmake_rope(jcfg, 512),
                                 JPipelineConfig(**kw, dtype=jnp.float32)),
                   eos_token_ids=set(), prefix_cache=False)
    tpipe = TextPipeline(tcfg, port_params(jraw), make_rope(tcfg, 512, device="cpu"),
                         PipelineConfig(**kw, dtype=torch.float32, device="cpu"))
    assert tpipe.params.layers[0]["mlp"]["gateup"].kind == "gguf_q2k"
    teng = Engine(tpipe, eos_token_ids=set(), prefix_cache=False)
    runs = []
    for eng, req, sp in ((jeng, JRequest, JSampling), (teng, GenerationRequest, SamplingParams)):
        groups = [eng.add_request(req(list(p), sp(max_len=max_len))) for p in prompts]
        while not all(g.all_done() for g in groups):
            eng.step()
        runs.append([g.seqs[0] for g in groups])
    for js, ts in zip(*runs):
        assert len(ts.generated_tokens) == max_len
        assert ts.generated_tokens == js.generated_tokens
        jv = np.array([lp.logprob for lp in js.logprobs])
        tv = np.array([lp.logprob for lp in ts.logprobs])
        assert (np.abs(tv - jv) <= SLICE_RTOL * np.abs(jv).max()).all()
