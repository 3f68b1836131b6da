"""The port against the JAX package on a tiny Q5_K_M-mix model with its Q6_K
tensors kept as Q6_K (no rq8): decoder logits, the GEMV routes each
projection takes, and greedy engine tokens.

The model (tests/torch_port_model.py jax_q5km_params) is 3 layers wide as
512: q, k, o, gate, up and most ffn_down in Q5_K; v, the use_more_bits
ffn_down and the lm_head in Q6_K. At in = 512 a Q6_K tensor has chunk span
G = 128, so v and the lm_head take K4 at every row count; the Q6_K
ffn_down (in 1024, G = 256) takes K3 at decode. The JAX package's CPU path
dequantizes every projection (exact f32).

Tolerances:
- with the GEMV routes off (MAX_KERNEL_ROWS = -1, every projection
  dequantizes) only f32 summation orders differ: 1e-6 of the largest logit;
- through the plain K3, K4 and K9 the int8 activation rounding of K3 and
  K9 adds up over the layers: SLICE_RTOL (3%) of the largest logit, as for
  the Q4_K_M model.
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
from torch_port_model import (PAGE, SLICE_RTOL, jax_q5km_params, port_config, port_params,
                              use_more_bits)

EXACT_RTOL = 1e-6


@pytest.fixture(scope="module")
def model():
    jcfg, jraw = jax_q5km_params(seed=0)
    tcfg = port_config(jcfg)
    tp = tfuse.fuse_decoder_params(port_params(jraw))
    jp = jfuse.fuse_decoder_params(jraw)
    return jcfg, jraw, jp, tcfg, tp


@pytest.fixture
def routes(monkeypatch):
    """Which plain kernel each projection went through: (in, out) shapes."""
    seen = {"k3": [], "k4": [], "k9": []}

    def counted(route, fn):
        def wrapped(x, *args, **kw):
            seen[route].append((x.shape[0], x.shape[1], args[0].shape[1]))
            return fn(x, *args, **kw)
        return wrapped

    monkeypatch.setattr(tqm, "q6k_q8_gemv_plain", counted("k3", tqm.q6k_q8_gemv_plain))
    monkeypatch.setattr(tqm, "q6k_bf16_gemv_plain", counted("k4", tqm.q6k_bf16_gemv_plain))
    monkeypatch.setattr(tqm, "q5k_q8_gemv_plain", counted("k9", tqm.q5k_q8_gemv_plain))
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


def test_fused_params_keep_q6k_and_fuse_q5k(model):
    _, _, _, _, tp = model
    L = len(tp.layers)
    for i, lp in enumerate(tp.layers):
        assert set(lp["attn"]) == {"qk", "v", "o"} and set(lp["mlp"]) == {"gateup", "down"}
        assert lp["attn"]["qk"].kind == lp["mlp"]["gateup"].kind == "gguf_q5k"
        assert lp["attn"]["v"].kind == "gguf_q6k" and lp["attn"]["v"].meta == 128
        down = lp["mlp"]["down"]
        assert down.kind == ("gguf_q6k" if use_more_bits(i, L) else "gguf_q5k")
    assert tp.lm_head.kind == "gguf_q6k" and tp.lm_head.shape == (512, 2048)


def test_forward_exact_without_kernel_routes(model, monkeypatch, routes):
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)  # every GEMV dequantizes
    for jl, tl in _forward_steps(model, n_decode=2):
        assert tl.shape == jl.shape == (model[0].vocab_size,)
        assert np.abs(tl - jl).max() <= EXACT_RTOL * np.abs(jl).max()
    assert routes == {"k3": [], "k4": [], "k9": []}


def test_forward_through_k3_k4_k9_within_q8_tolerance(model, routes):
    steps = _forward_steps(model, n_decode=3)
    for jl, tl in steps:
        err = np.abs(tl - jl).max()
        assert 0 < err <= SLICE_RTOL * np.abs(jl).max()
        assert tl.argmax() == jl.argmax()
    # the 128-row first chunk and each decode row: K9 for q|k, o, gate|up
    # and the Q5_K downs; K4 for v (128 rows and 1), the lm_head (1 row each
    # step) and the Q6_K down of the first chunk; K3 only for the in-1024
    # Q6_K down at decode
    L = model[0].num_layers
    n_q6_down = sum(use_more_bits(i, L) for i in range(L))
    assert sorted(set(routes["k3"])) == [(1, 1024, 512)]
    assert len(routes["k3"]) == 3 * n_q6_down
    assert sorted(set(routes["k4"])) == [(1, 512, 256), (1, 512, 2048), (128, 512, 256),
                                         (128, 1024, 512)]
    assert len(routes["k9"]) == 4 * (3 * L + (L - n_q6_down)) and routes["k9"]
    down_rows = {r for r, k, _ in routes["k9"] if k == 1024}
    assert down_rows == {1, 128}


def test_engine_greedy_tokens_match_jax(model, monkeypatch):
    """rq8_group=None on the port, MISTRALRS_Q6K_RQ8=0 on JAX: Q6_K served as
    Q6_K on both sides. 3 requests: a 150-token prompt (a 128-token first
    chunk, then 22 tokens), 40 and 100 tokens, 8 greedy tokens each."""
    jcfg, jraw, _, tcfg, _ = model
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, jcfg.vocab_size, n)] for n in (150, 40, 100)]
    max_len = 8
    monkeypatch.setenv("MISTRALRS_Q6K_RQ8", "0")
    kw = dict(page_size=PAGE, num_pages=64, max_seqs=4, max_model_len=512,
              prefill_buckets=(64, 128), decode_steps=4)
    jeng = JEngine(JTextPipeline(jcfg, jraw, jmake_rope(jcfg, 512),
                                 JPipelineConfig(**kw, dtype=jnp.float32)),
                   eos_token_ids=set(), prefix_cache=False)
    tpipe = TextPipeline(tcfg, port_params(jraw), make_rope(tcfg, 512, device="cpu"),
                         PipelineConfig(**kw, dtype=torch.float32, rq8_group=None, device="cpu"))
    assert tpipe.params.lm_head.kind == "gguf_q6k"
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


def test_loader_carries_q5k_across(model):
    """params_from_reference keeps qs/qh as uint8 bytes and gives scale/minv
    the working dtype."""
    from mistralrs_tpu_torch.models.loader import params_from_reference
    import jax

    _, jraw, _, _, _ = model
    tp = params_from_reference(jax.tree.map(np.asarray, jraw), device="cpu", dtype=torch.bfloat16)
    q = tp.layers[0]["attn"]["q"]
    assert q.kind == "gguf_q5k"
    assert q.data["qs"].dtype == q.data["qh"].dtype == torch.uint8
    assert q.data["scale"].dtype == q.data["minv"].dtype == torch.bfloat16
    assert tuple(q.data["qh"].shape) == (512 // 8, 512)
    jq = jraw.layer_groups[0]["attn"]["q"]
    np.testing.assert_array_equal(q.data["qh"].numpy(), np.asarray(jq.data["qh"])[0])
