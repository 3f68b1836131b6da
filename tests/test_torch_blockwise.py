"""The blockwise long-span attention route of the port against the JAX
package's, on the CPU.

(a) blockwise_prefill_continuation on small pools (page 4, 16-token key
    blocks, so a span of 5-7 blocks, the last one partial): f32 and int8
    pools in both layouts, a sliding window (JAX with its layer gate on
    and off, the port with the window and with None), a logit soft cap,
    and decode rows; within 1e-5 of the largest |out| of JAX's.
(b) The route: continuation chunks past span 4096 and decode past
    _BLOCKWISE_DECODE_SPAN take "blockwise"; an int8 pool never takes K6'
    or K7; first chunks keep K6.
(c) decoder_forward + compute_logits of one 128-token continuation chunk
    at span 4,608 on the tiny Q4_K_M-mix model of tests/torch_port_model.py
    (1 layer)
    (head-major pools holding a seeded context; f32 and int8): the port's
    "blockwise" step against JAX's, within 1e-5 of the largest |logit|
    (the GEMVs on their dequant route, MAX_KERNEL_ROWS = -1).
(d) With _BLOCKWISE_DECODE_SPAN lowered to 128 in both packages (JAX
    tests/test_engine.py::test_blockwise_decode_route_matches_gather), the
    port's engine decodes on the blockwise route and its greedy tokens
    equal its gather route's and JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.engine.engine import Engine as JEngine
from mistralrs_tpu.engine.sampler import SamplingParams as JSampling
from mistralrs_tpu.models import decoder as jd
from mistralrs_tpu.models.loader import make_rope as jmake_rope
from mistralrs_tpu.ops import paged_attention as jpa
from mistralrs_tpu.pipeline.text import PipelineConfig as JPipelineConfig
from mistralrs_tpu.pipeline.text import TextPipeline as JTextPipeline
from mistralrs_tpu_torch.engine.engine import Engine
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.models import decoder as td
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.ops import paged_attention as tpa
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
from torch_port_model import jax_q4km_params, one_thread, port_config, port_params  # noqa: F401

RTOL = 1e-5

# ------------------------------------------------------------- the op

PAGE, HQ, HKV, D, BLOCK = 4, 4, 2, 16, 16


def _pools(rng, P, head_major, quant):
    """(JAX per-layer pools, the port's) holding the same random context:
    f32 [.., D] arrays, or int8 payloads with f32 scales as (payload,
    scale) pairs."""
    shape = (HKV, P, PAGE, D) if head_major else (P, PAGE, HKV, D)
    if not quant:
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        return (jnp.asarray(k), jnp.asarray(v)), (torch.from_numpy(k), torch.from_numpy(v))
    arrs = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
    scales = [(rng.random(shape[:-1]) * 0.02 + 1e-3).astype(np.float32) for _ in range(2)]
    jax_side = tuple((jnp.asarray(a), jnp.asarray(s)) for a, s in zip(arrs, scales))
    port_side = tuple((torch.from_numpy(a), torch.from_numpy(s)) for a, s in zip(arrs, scales))
    return jax_side, port_side


# (case, query rows, the context's kv_lens, block-table width, window,
#  JAX's layer gate, soft cap): a span of 92 or 112 tokens, 5.75 or 7
#  blocks of 16
OP_CASES = [
    ("chunk window", 8, (90, 61), 23, 24, None, None),
    ("chunk window off cap", 8, (90, 77), 23, 24, False, 5.0),
    ("decode window on cap", 1, (85, 33), 28, 40, True, 3.0),
]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("head_major", [False, True])
@pytest.mark.parametrize("case", [c[0] for c in OP_CASES])
def test_blockwise_op_matches_jax(case, head_major, quant):
    _, T, kv_lens, MP, window, gate, cap = next(c for c in OP_CASES if c[0] == case)
    rng = np.random.default_rng(11)
    B, P = len(kv_lens), 2 * MP + 2
    (jk, jv), (tk, tv) = _pools(rng, P, head_major, quant)
    tables = np.stack([rng.permutation(np.arange(1, P))[:MP] for _ in range(B)])
    q = rng.standard_normal((B, T, HQ, D)).astype(np.float32)
    scale = D ** -0.5
    jmeta = jpa.PagedAttnMeta(positions=None, slot_mapping=None,
                              block_tables=jnp.asarray(tables, jnp.int32),
                              kv_lens=jnp.asarray(kv_lens, jnp.int32), active=None,
                              head_major=head_major)
    want = np.asarray(jpa.blockwise_prefill_continuation(
        jnp.asarray(q), jk, jv, jmeta, scale=scale, sliding_window=window,
        window_gate=None if gate is None else jnp.asarray(gate), logits_softcap=cap,
        kv_block=BLOCK))
    tmeta = tpa.PagedAttnMeta(positions=None, slot_mapping=None,
                              block_tables=torch.from_numpy(tables),
                              kv_lens=torch.tensor(kv_lens), active=None, head_major=head_major)
    got = tpa.blockwise_prefill_continuation(
        torch.from_numpy(q), tk, tv, tmeta, scale=scale,
        # the port's decoder passes no window on a layer whose gate is off
        sliding_window=None if gate is False else window, logits_softcap=cap,
        kv_block=BLOCK).numpy()
    assert got.shape == (B, T, HQ, D)
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


# ------------------------------------------------------------- the route


@pytest.mark.parametrize("T,first,span,kv_dtype,route", [
    (512, False, 8192, torch.bfloat16, "blockwise"),
    (512, False, 4096, torch.bfloat16, "continuation"),
    (512, False, 4096, torch.int8, "gather"),
    (512, False, 4608, torch.int8, "blockwise"),
    (512, True, 8192, torch.int8, "flash"),
    (1, False, 16384, torch.int8, "gather"),
    (1, False, 32768, torch.int8, "blockwise"),
    (1, False, 32768, torch.bfloat16, "decode"),
])
def test_route_past_the_spans(T, first, span, kv_dtype, route):
    cfg = td.ModelConfig(arch="mistral", vocab_size=64, hidden_size=512, intermediate_size=1024,
                         num_layers=1, num_heads=4, num_kv_heads=2, head_dim=128)
    meta = tpa.PagedAttnMeta(None, None, None, None, None, first_chunk=first, head_major=True)
    for dev in ("cpu", "cuda"):
        assert td._attention_route(cfg, T, meta, span, device_type=dev, dtype=torch.bfloat16,
                                   kv_dtype=kv_dtype) == route


# ------------------------------------------------------------- the decoder step

CTX, T_CHUNK, SPAN = 4480, 128, 4608


@pytest.fixture(scope="module")
def model():
    """The tiny model (1 layer) in each package, unfused, Q6_K kept."""
    jcfg, jraw = jax_q4km_params(seed=2, num_layers=1, max_position_embeddings=8192)
    return jcfg, jraw, port_config(jcfg), port_params(jraw)


@pytest.mark.parametrize("quant", [False, True])
def test_decoder_step_at_span_4608_matches_jax(model, monkeypatch, quant):
    jcfg, jp, tcfg, tp = model
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)
    rng = np.random.default_rng(8)
    L, H, Dh = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    MP = SPAN // 16
    P = MP + 1
    shape = (L, H, P, 16, Dh)
    if quant:
        leaves = {n: rng.integers(-127, 128, shape).astype(np.int8) for n in ("k", "v")}
        leaves.update({n: (rng.random(shape[:-1]) * 0.02).astype(np.float32)
                       for n in ("k_scale", "v_scale")})
    else:
        leaves = {n: (rng.standard_normal(shape) * 0.5).astype(np.float32) for n in ("k", "v")}
    jcache = jpa.PagedKVCache(**{n: jnp.asarray(a) for n, a in leaves.items()}, head_major=True)
    tcache = tpa.PagedKVCache(**{n: torch.from_numpy(a.copy()) for n, a in leaves.items()},
                              head_major=True)
    table = rng.permutation(np.arange(1, P))[None]
    pos = np.arange(CTX, CTX + T_CHUNK)[None]
    ids = rng.integers(1, jcfg.vocab_size, (1, T_CHUNK))
    slots = table[0][pos // 16] * 16 + pos % 16
    kv_lens = np.asarray([CTX + T_CHUNK])
    jmeta = jpa.PagedAttnMeta(positions=jnp.asarray(pos, jnp.int32),
                              slot_mapping=jnp.asarray(slots, jnp.int32),
                              block_tables=jnp.asarray(table, jnp.int32),
                              kv_lens=jnp.asarray(kv_lens, jnp.int32),
                              active=jnp.ones((1,), jnp.float32), head_major=True)
    h, _ = jd.decoder_forward(jp, jcfg, jmake_rope(jcfg, 8192), jnp.asarray(ids, jnp.int32),
                              jcache, jmeta)
    want = np.asarray(jd.compute_logits(jp, jcfg, h[0]))
    tmeta = tpa.PagedAttnMeta(positions=torch.from_numpy(pos), slot_mapping=torch.from_numpy(slots),
                              block_tables=torch.from_numpy(table),
                              kv_lens=torch.from_numpy(kv_lens), active=torch.ones(1),
                              head_major=True)
    steps = td.blockwise_steps
    th, _ = td.decoder_forward(tp, tcfg, make_rope(tcfg, 8192, device="cpu"),
                               torch.from_numpy(ids), tcache, tmeta)
    assert td.blockwise_steps == steps + 1
    got = td.compute_logits(tp, tcfg, th[0]).numpy()
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


# ------------------------------------------------------------- the engine


def test_blockwise_decode_route_matches_gather_and_jax(model, monkeypatch, one_thread):
    """A 300-token prompt on token-major pools (max_model_len 768), 6 greedy
    tokens: with the decode threshold at 128 the decode steps (span 512)
    take the blockwise route; the tokens equal the gather route's (the
    threshold left at 16,384) and JAX's with its threshold lowered too."""
    jcfg, jraw, tcfg, _ = model
    monkeypatch.setenv("MISTRALRS_Q6K_RQ8", "32")
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)
    kw = dict(page_size=16, num_pages=48, max_seqs=1, max_model_len=768, prefill_buckets=(256,))
    prompt = [int(t) for t in np.random.default_rng(52).integers(1, jcfg.vocab_size, 300)]

    def port_tokens():
        pipe = TextPipeline(tcfg, port_params(jraw), make_rope(tcfg, 768, device="cpu"),
                            PipelineConfig(dtype=torch.float32, device="cpu", **kw))
        assert not pipe.head_major
        return Engine(pipe, eos_token_ids=set()).generate(prompt, SamplingParams(max_len=6))[0]

    steps = td.blockwise_steps
    want = port_tokens()
    assert td.blockwise_steps == steps
    monkeypatch.setattr(td, "_BLOCKWISE_DECODE_SPAN", 128)
    got = port_tokens()
    assert td.blockwise_steps > steps
    monkeypatch.setattr(jd, "_BLOCKWISE_DECODE_SPAN", 128)
    jpipe = JTextPipeline(jcfg, jraw, jmake_rope(jcfg, 768),
                          JPipelineConfig(dtype=jnp.float32, **kw))
    jtoks = JEngine(jpipe, eos_token_ids=set()).generate(prompt, JSampling(max_len=6))[0]
    assert len(got) == 6 and got == want == jtoks


def test_kv_quant_on_the_ragged_backend_serves_the_default_routes(model, caplog):
    """As in JAX: attn_backend="ragged" with kv_quant warns and builds int8
    pools of the default layout, not the combined one."""
    _, _, tcfg, tp = model
    pc = PipelineConfig(attn_backend="ragged", kv_quant=True, num_pages=8, max_seqs=1,
                        max_model_len=512, dtype=torch.float32, device="cpu")
    with caplog.at_level("WARNING"):
        pipe = TextPipeline(tcfg, dataclasses.replace(tp), make_rope(tcfg, 512, device="cpu"), pc)
    assert "incompatible with kv_quant" in caplog.text
    assert not pipe.kv_combined and pipe.cache.quantized and not pipe.cache.combined
