"""The port's decoder against the JAX package on a tiny Q4_K_M-mix model:
decoder_forward + compute_logits for a first chunk of 128 tokens (the port
takes its flash prefill path, JAX the gather + sdpa path), then decode steps
over the paged cache. tests/test_torch_slice_engine.py holds the engine-level
comparison on the same model.

The model (tests/torch_port_model.py) is 3 layers wide as 512, with 4 query
and 2 kv heads of 128. Both packages fuse q|k and gate|up, pad the lm_head
and requantize Q6_K to int8 per 32 (JAX through MISTRALRS_Q6K_RQ8=32).

Tolerances:
- with the int8 GEMV route off (every projection dequantizes, as the JAX
  CPU path does) the port must agree to 1e-5 of the largest logit: only f32
  summation orders differ;
- with it on, the port quantizes activations to int8 per 32 values
  (|dx| <= max|x_block|/254 per element, in every projection of every
  layer). Measured on this model: at most 1.03% of the step's largest
  |logit| over 5 steps; the test allows SLICE_RTOL = 3%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.models import decoder as jd
from mistralrs_tpu.models.loader import make_rope as jmake_rope
from mistralrs_tpu.ops import paged_attention as jpa
from mistralrs_tpu.quant import fuse as jfuse
from mistralrs_tpu_torch.models import decoder as td
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.ops import flash_attention as tfa
from mistralrs_tpu_torch.ops import paged_attention as tpa
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.quant import fuse as tfuse
from torch_port_model import PAGE, SLICE_RTOL, jax_q4km_params, port_config, port_params

EXACT_RTOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg, jraw = jax_q4km_params(seed=0)
    tcfg = port_config(jcfg)
    tp = tfuse.requant_q6k_params(tfuse.fuse_decoder_params(port_params(jraw)), gs=32)
    jp = jfuse.requant_q6k_params(jfuse.fuse_decoder_params(jraw), gs=32)
    return jcfg, jraw, jp, tcfg, tp


def _forward_steps(model, n_decode=4):
    """Logits of both packages for a 128-token first chunk then n_decode
    greedy steps (both fed the JAX argmax). Returns [(jax, port)] per step."""
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


def test_forward_exact_without_int8_route(model, monkeypatch):
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)  # every GEMV dequantizes
    before = tfa.flash_prefill_launches
    for jl, tl in _forward_steps(model, n_decode=2):
        assert tl.shape == jl.shape == (model[0].vocab_size,)
        assert np.abs(tl - jl).max() <= EXACT_RTOL * np.abs(jl).max()
    assert tfa.flash_prefill_launches == before  # plain version on the CPU


def test_forward_int8_route_within_q8_tolerance(model):
    for jl, tl in _forward_steps(model, n_decode=4):
        err = np.abs(tl - jl).max()
        assert 0 < err <= SLICE_RTOL * np.abs(jl).max()
        assert tl.argmax() == jl.argmax()
