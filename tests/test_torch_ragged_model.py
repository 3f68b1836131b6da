"""The port's ragged attention backend (`PipelineConfig(attn_backend="ragged")`)
against the JAX package's, through both TextPipelines on the CPU in f32.

Models: the tiny Q4_K_M-mix Mistral and the tiny Gemma-2 (ISQ Q4K; window
48 on its even layers, soft caps 50 / 30) of tests/torch_port_model.py. A
300-token prompt goes in as a 128-token first chunk (the port's K6 or K11
on the chunk's own K/V), a 128-token continuation chunk and a 44-token one
padded to 64 (a ragged q_len; K12's plain version on the port's combined
pool), then 3 decode steps at 4 slots (K12 with 3 padding rows). JAX on the
CPU serves the same combined pool through split views and the masked
gather. With the int8 GEMV routes off (every projection dequantizes, as
the JAX CPU path does), the logits agree within 1e-5 of the largest
|logit|: only f32 summation orders differ. The Gemma-2 prompt is longer
than its window, so the window clips.

Also: which plain versions the steps ran (K6', K7 and the gather route
never on a combined pool), greedy engine tokens equal to the port's default
backend, COW page copies and the page count on a combined pool.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.engine.sampler import SamplingParams as JSampling
from mistralrs_tpu.engine.sequence import Sequence as JSequence
from mistralrs_tpu.models.loader import make_rope as jmake_rope
from mistralrs_tpu.pipeline.text import PipelineConfig as JPipelineConfig
from mistralrs_tpu.pipeline.text import TextPipeline as JTextPipeline
from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.engine.sequence import Sequence
from mistralrs_tpu_torch.models import decoder as td
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.ops import flash_attention as tfa
from mistralrs_tpu_torch.ops import paged_attention as tpa
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.ops import ragged_attention as tra
from mistralrs_tpu_torch.ops import splash as tsp
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
from torch_port_model import (PAGE, jax_gemma2_params, jax_q4km_params, port_config,
                              port_params)

EXACT_RTOL = 1e-5
LEN = 1024
PIPE = dict(page_size=PAGE, num_pages=64, max_seqs=4, max_model_len=LEN,
            prefill_buckets=(64, 128), decode_steps=4)
CHUNKS = (128, 128, 44)
DECODES = 3


@pytest.fixture(scope="module", params=["mistral", "gemma2"])
def model(request):
    if request.param == "mistral":
        jcfg, jparams = jax_q4km_params(seed=0)
    else:
        jcfg, jparams, _ = jax_gemma2_params(seed=0)
    return request.param, jcfg, jparams, port_config(jcfg)


@pytest.fixture
def routes(monkeypatch):
    """Calls of the plain version each attention route ends in."""
    counts = dict(flash=0, splash=0, ragged=0, continuation=0, decode=0, gather=0)
    windows = []

    def counted(route, fn):
        def wrapped(*args, **kw):
            counts[route] += 1
            if route == "ragged":
                windows.append(kw["sliding_window"])
            return fn(*args, **kw)
        return wrapped

    for mod, name, route in ((tfa, "flash_prefill_plain", "flash"),
                             (tsp, "splash_prefill_plain", "splash"),
                             (tra, "ragged_attention_plain", "ragged"),
                             (tpa, "flash_prefill_continuation_plain", "continuation"),
                             (tpa, "paged_decode_attention_plain", "decode"),
                             (td, "sdpa", "gather"), (td, "sdpa_head_major", "gather")):
        monkeypatch.setattr(mod, name, counted(route, getattr(mod, name)))
    return counts, windows


def _pipelines(jcfg, jparams, tcfg, **kw):
    jpipe = JTextPipeline(jcfg, jparams, jmake_rope(jcfg, LEN),
                          JPipelineConfig(**PIPE, dtype=jnp.float32, attn_backend="ragged"))
    # Q6_K kept as Q6_K, as the JAX package keeps it on the CPU
    tpipe = TextPipeline(tcfg, port_params(jparams), make_rope(tcfg, LEN, device="cpu"),
                         PipelineConfig(**PIPE, dtype=torch.float32, device="cpu",
                                        rq8_group=None, **kw))
    return jpipe, tpipe


def test_pipelines_match_jax(model, monkeypatch, routes):
    name, jcfg, jparams, tcfg = model
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)  # every projection dequantizes
    jpipe, tpipe = _pipelines(jcfg, jparams, tcfg, attn_backend="ragged")
    assert jpipe.kv_combined and tpipe.kv_combined and not tpipe.head_major
    assert tpipe.cache.combined and tpipe.cache.k.shape == (
        tcfg.num_layers, PIPE["num_pages"], PAGE, 2 * tcfg.num_kv_heads, tcfg.head_dim)
    prompt = [int(t) for t in np.random.default_rng(1).integers(1, jcfg.vocab_size, sum(CHUNKS))]
    seqs = [JSequence(list(prompt), JSampling(max_len=8)), Sequence(list(prompt),
                                                                  SamplingParams(max_len=8))]
    for s in seqs:
        s.block_table = list(range(1, 1 + -(-(len(prompt) + DECODES) // PAGE)))
    steps = []
    start = 0
    for n in CHUNKS:
        chunk = prompt[start:start + n]
        steps.append((jpipe.run_prefill_chunk(seqs[0], chunk),
                      tpipe.run_prefill_chunk(seqs[1], chunk)))
        start += n
    for _ in range(DECODES):
        tok = int(steps[-1][0].argmax())
        for s in seqs:
            s.tokens.append(tok)
        steps.append((jpipe.run_decode(seqs[:1])[0], tpipe.run_decode(seqs[1:])[0]))
    for jl, tl in steps:
        assert tl.shape == jl.shape == (jcfg.vocab_size,) and np.isfinite(tl).all()
        assert np.abs(tl - jl).max() <= EXACT_RTOL * np.abs(jl).max()

    counts, windows = routes
    L = tcfg.num_layers
    first = "splash" if name == "gemma2" else "flash"
    ragged_steps = len(CHUNKS) - 1 + DECODES
    want = dict(flash=0, splash=0, continuation=0, decode=0, gather=0, ragged=ragged_steps * L)
    want[first] = L
    assert counts == want
    if name == "gemma2":  # the window (48) clips the span on the local layers only
        assert windows == [48, None] * (L // 2) * ragged_steps
    else:
        assert windows == [None] * L * ragged_steps


def test_the_window_moves_the_logits(model, monkeypatch):
    """A window of 48 (Gemma-2's own on its even layers; on every layer of
    the Mistral model, whose tables then start at the window's base page)
    moves a continuation chunk's logits by far more than the tolerance, so
    the comparison above sees the window that the ragged route passes."""
    import dataclasses

    name, jcfg, jparams, tcfg = model
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)
    windowed = tcfg if name == "gemma2" else dataclasses.replace(
        tcfg, sliding_window=48, sliding_window_pattern="all")
    prompt = [int(t) for t in np.random.default_rng(1).integers(1, jcfg.vocab_size, 256)]
    out = []
    for cfg in (windowed, dataclasses.replace(tcfg, sliding_window=None,
                                              sliding_window_pattern="none")):
        pipe = TextPipeline(cfg, port_params(jparams), make_rope(cfg, LEN, device="cpu"),
                            PipelineConfig(**PIPE, dtype=torch.float32, device="cpu",
                                           rq8_group=None, attn_backend="ragged"))
        seq = Sequence(list(prompt), SamplingParams(max_len=1))
        seq.block_table = list(range(1, 17))
        pipe.run_prefill_chunk(seq, prompt[:128])
        out.append(pipe.run_prefill_chunk(seq, prompt[128:]))
    assert np.isfinite(out[0]).all()
    assert np.abs(out[0] - out[1]).max() > 100 * EXACT_RTOL * np.abs(out[0]).max()


def test_engine_tokens_match_the_default_backend(model):
    """Greedy tokens of the port's Engine (Q4_K through K1's plain version)
    on the ragged backend equal those on the default one: 150-, 40- and
    100-token prompts batched in 4 slots, 8 tokens each."""
    _, jcfg, jparams, tcfg = model
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, jcfg.vocab_size, n)] for n in (150, 40, 100)]
    runs = []
    for backend in ("ragged", None):
        pipe = TextPipeline(tcfg, port_params(jparams), make_rope(tcfg, LEN, device="cpu"),
                            PipelineConfig(**PIPE, dtype=torch.float32, device="cpu",
                                           attn_backend=backend))
        eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
        groups = [eng.add_request(GenerationRequest(list(p), SamplingParams(max_len=8)))
                  for p in prompts]
        while not all(g.all_done() for g in groups):
            eng.step()
        runs.append([g.seqs[0].generated_tokens for g in groups])
    assert all(len(t) == 8 for t in runs[0]) and runs[0] == runs[1]


def test_copy_pages_on_a_combined_pool():
    rng = np.random.default_rng(4)
    cache = tpa.PagedKVCache.create(2, 6, 2, 2, 8, dtype=torch.float32, device="cpu",
                                    combined=True)
    assert cache.combined and cache.v is None
    assert (cache.page_size, cache.num_pages, cache.page_axis) == (2, 6, 1)
    cache.k.copy_(torch.from_numpy(rng.standard_normal(tuple(cache.k.shape)).astype(np.float32)))
    before = cache.k.clone()
    out = tpa.copy_pages(cache, [1, 4], [4, 5])  # overlapping: page 4 is copied before written
    assert out is cache
    torch.testing.assert_close(cache.k[:, 4], before[:, 1], rtol=0, atol=0)
    torch.testing.assert_close(cache.k[:, 5], before[:, 4], rtol=0, atol=0)
    torch.testing.assert_close(cache.k[:, :4], before[:, :4], rtol=0, atol=0)
    with pytest.raises(ValueError):
        tpa.PagedKVCache.create(1, 4, 2, 2, 8, device="cpu", head_major=True, combined=True)


def test_the_page_count_and_bytes_do_not_change():
    """calculate_num_pages sizes the pool by bytes a token, the same for one
    combined pool as for a K and a V pool; the combined pool is token-major
    even where the default would be head-major."""
    jcfg, jparams = jax_q4km_params(seed=0)
    tcfg = port_config(jcfg)
    pipes = {}
    for backend in ("ragged", "default"):
        pc = PipelineConfig(page_size=PAGE, num_pages=None, kv_mem_bytes=3 << 20, max_seqs=4,
                            max_model_len=4096, dtype=torch.float32, device="cpu",
                            attn_backend=backend)
        pipes[backend] = TextPipeline(tcfg, port_params(jparams),
                                      make_rope(tcfg, 4096, device="cpu"), pc)
    ragged, default = pipes["ragged"], pipes["default"]
    assert ragged.pc.num_pages == default.pc.num_pages > 2
    assert default.head_major and not ragged.head_major
    assert ragged.cache.k.numel() == default.cache.k.numel() + default.cache.v.numel()


def test_another_backend_name_raises():
    jcfg, jparams = jax_q4km_params(seed=0)
    tcfg = port_config(jcfg)
    with pytest.raises(ValueError):
        TextPipeline(tcfg, port_params(jparams), make_rope(tcfg, 512, device="cpu"),
                     PipelineConfig(device="cpu", attn_backend="flashinfer"))
