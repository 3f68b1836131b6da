"""The port's Engine against the JAX Engine on two paths of the serving loop
that tests/test_torch_slice_engine.py does not reach: a sliding-window model
(window-relative block tables, pages behind the window handed back) and
the prefix cache (a later request attaching cached pages of an earlier one).

Same tiny Q4_K_M-mix model family and tolerance as test_torch_slice_engine
(SLICE_RTOL of tests/torch_port_model.py: int8 activation rounding); the
bigram lm_head keeps every step's top-2 margin far above it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.engine.engine import Engine as JEngine
from mistralrs_tpu.engine.engine import GenerationRequest as JRequest
from mistralrs_tpu.engine.sampler import SamplingParams as JSampling
from mistralrs_tpu.models.loader import make_rope as jmake_rope
from mistralrs_tpu.pipeline.text import PipelineConfig as JPipelineConfig
from mistralrs_tpu.pipeline.text import TextPipeline as JTextPipeline
from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
from torch_port_model import PAGE, SLICE_RTOL, jax_q4km_params, port_config, port_params


def _engines(jcfg, jraw, monkeypatch, prefix_cache):
    monkeypatch.setenv("MISTRALRS_Q6K_RQ8", "32")
    kw = dict(page_size=PAGE, num_pages=96, max_seqs=4, max_model_len=512,
              prefill_buckets=(64, 128), decode_steps=4)
    jeng = JEngine(JTextPipeline(jcfg, jraw, jmake_rope(jcfg, 512),
                                 JPipelineConfig(dtype=jnp.float32, **kw)),
                   eos_token_ids=set(), prefix_cache=prefix_cache)
    tcfg = port_config(jcfg)
    teng = Engine(TextPipeline(tcfg, port_params(jraw), make_rope(tcfg, 512, device="cpu"),
                               PipelineConfig(dtype=torch.float32, device="cpu", **kw)),
                  eos_token_ids=set(), prefix_cache=prefix_cache)
    return jeng, teng


def _serve(eng, req, sp, prompts, max_len, together=True):
    """Greedy-serve prompts (all at once, or one after another); returns
    each request's (generated tokens, their raw logits)."""
    out = []
    waves = [prompts] if together else [[p] for p in prompts]
    for wave in waves:
        groups = [eng.add_request(req(list(p), sp(max_len=max_len))) for p in wave]
        while not all(g.all_done() for g in groups):
            eng.step()
        out += [(g.seqs[0].generated_tokens, np.array([lp.logprob for lp in g.seqs[0].logprobs]))
                for g in groups]
    return out


def _same(jruns, truns, max_len):
    for (jt, jv), (tt, tv) in zip(jruns, truns):
        assert len(tt) == max_len
        assert tt == jt
        assert np.abs(tv - jv).max() <= SLICE_RTOL * np.abs(jv).max()


def test_sliding_window_engine_matches_jax(monkeypatch):
    """Window 48 < context: decode slices the tables from the window base
    and the engine releases the pages behind it; the 128-token first chunk
    is longer than the window, so it takes gather + windowed sdpa, not flash."""
    jcfg, jraw = jax_q4km_params(seed=3, num_layers=2, sliding_window=48,
                                 sliding_window_pattern="all")
    jeng, teng = _engines(jcfg, jraw, monkeypatch, prefix_cache=False)
    released = []
    release = teng.block_manager.release_prefix
    teng.block_manager.release_prefix = lambda seq, n: (released.append(n), release(seq, n))
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, jcfg.vocab_size, n)] for n in (128, 70)]
    max_len = 12
    _same(_serve(jeng, JRequest, JSampling, prompts, max_len),
          _serve(teng, GenerationRequest, SamplingParams, prompts, max_len), max_len)
    assert released and max(released) >= 5  # pages behind the window went back


@pytest.mark.parametrize("shared", [64, 72])
def test_prefix_cache_engine_matches_jax(monkeypatch, shared):
    """Two requests served one after the other share a prompt prefix: the
    second attaches the first's cached full pages (4 of 16 tokens in both
    cases; with 72 shared tokens the half page past them is recomputed) and
    prefills only the rest."""
    jcfg, jraw = jax_q4km_params(seed=4, num_layers=2)
    jeng, teng = _engines(jcfg, jraw, monkeypatch, prefix_cache=True)
    rng = np.random.default_rng(shared)
    prefix = [int(t) for t in rng.integers(1, jcfg.vocab_size, shared)]
    prompts = [prefix + [int(t) for t in rng.integers(1, jcfg.vocab_size, n)] for n in (20, 9)]
    max_len = 8
    _same(_serve(jeng, JRequest, JSampling, prompts, max_len, together=False),
          _serve(teng, GenerationRequest, SamplingParams, prompts, max_len, together=False),
          max_len)
    assert teng.prefix_cacher.hits >= 1 and jeng.prefix_cacher.hits >= 1
