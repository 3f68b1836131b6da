"""Gemma-2's pieces in the port against the JAX package, f32 on the CPU.

- `config_from_hf` on Gemma-2-9B's published config.json (google/gemma-2-9b)
  gives the JAX translator's values in every field the port has.
- `rms_norm` with Gemma's (1 + w) offset, `gelu_tanh`, `softcap`, and
  `sdpa` / `sdpa_head_major` with a logit soft cap: 1e-6 of the largest
  |output| (f32, the same ops in another library).
- The paged reference and K7's plain version with a soft cap at head dim
  256 against JAX `paged_attention_reference` (1e-5) and against JAX
  `paged_decode_attention`, the library Pallas paged attention kernel in
  interpret mode (1e-2, as tests/test_torch_paged_kernels.py allows it).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mistralrs_tpu.models.config import config_from_hf as jconfig_from_hf
from mistralrs_tpu.ops import attention as jattn
from mistralrs_tpu.ops import layers as jlayers
from mistralrs_tpu.ops import paged_attention as jpa
from mistralrs_tpu_torch.models.config import ModelConfig, config_from_hf
from mistralrs_tpu_torch.ops import attention as tattn
from mistralrs_tpu_torch.ops import layers as tlayers
from mistralrs_tpu_torch.ops import paged_attention as tpa

OPS = 1e-6
TIGHT = 1e-5
LIBRARY_K7 = 1e-2

# google/gemma-2-9b config.json
GEMMA2_9B = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
    "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "head_dim": 256, "hidden_act": "gelu_pytorch_tanh", "hidden_activation": "gelu_pytorch_tanh",
    "hidden_size": 3584, "intermediate_size": 14336, "max_position_embeddings": 8192,
    "num_attention_heads": 16, "num_hidden_layers": 42, "num_key_value_heads": 8,
    "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-06, "rope_theta": 10000.0,
    "sliding_window": 4096, "vocab_size": 256000, "tie_word_embeddings": True,
}


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize("by", ["architectures", "model_type"])
def test_config_from_hf_matches_jax(by):
    hf = dict(GEMMA2_9B)
    if by == "model_type":
        del hf["architectures"]
    cfg, jcfg = config_from_hf(hf), jconfig_from_hf(hf)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.arch == "gemma2" and cfg.block_style == "sandwich" and cfg.norm_offset == 1.0
    assert cfg.query_scale == 1 / 16 and cfg.embed_scale == 3584 ** 0.5
    assert (cfg.attn_logit_softcap, cfg.final_logit_softcap) == (50.0, 30.0)


def test_hidden_activation_alone_names_the_activation():
    hf = {k: v for k, v in GEMMA2_9B.items() if k not in ("hidden_act", "architectures")}
    hf["hidden_activation"] = "gelu_tanh"
    assert config_from_hf(hf).act == jconfig_from_hf(hf).act == "gelu_tanh"


def test_alternating_windows_match_jax():
    cfg, jcfg = config_from_hf(GEMMA2_9B), jconfig_from_hf(GEMMA2_9B)
    flags = [cfg.layer_uses_sliding_window(i) for i in range(42)]
    assert flags == [jcfg.layer_uses_sliding_window(i) for i in range(42)]
    assert flags[:4] == [True, False, True, False]


def _rng_arrays(seed, *shapes, amp=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * amp).astype(np.float32) for s in shapes]


def test_rms_norm_with_offset_matches_jax():
    x, w = _rng_arrays(0, (3, 5, 64), (64,))
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(0.1 * w), 1e-6, offset=1.0)
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(0.1 * w), 1e-6, offset=1.0)
    _close(got.numpy(), want, OPS)


@pytest.mark.parametrize("name", ["gelu_new", "gelu_tanh", "gelu_pytorch_tanh"])
def test_gelu_tanh_matches_jax(name):
    (x,) = _rng_arrays(1, (4, 257), amp=4.0)
    want = jlayers.ACTIVATIONS[name](jnp.asarray(x))
    got = tlayers.ACTIVATIONS[name](torch.from_numpy(x))
    _close(got.numpy(), want, OPS)


def test_softcap_matches_jax():
    (x,) = _rng_arrays(2, (8, 100), amp=60.0)
    _close(tlayers.softcap(torch.from_numpy(x), 30.0).numpy(),
           jlayers.softcap(jnp.asarray(x), 30.0), OPS)


@pytest.mark.parametrize("head_major", [False, True])
def test_sdpa_with_softcap_matches_jax(head_major):
    B, T, S, Hq, Hkv, D = 2, 5, 24, 4, 2, 32
    q, k, v = _rng_arrays(3, (B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))
    offs = np.array([S - T, 7], np.int32)
    mask = np.array(jattn.causal_mask_bias(T, S, q_offsets=jnp.asarray(offs), sliding_window=9))
    # a cap of 5 bends scores of this size (Gemma-2's 50 bends scores of
    # ~50); larger inputs make the softmax's own f32 noise reach 1e-6
    if head_major:  # the context as the head-major gather gives it
        k, v = k.transpose(2, 0, 1, 3).copy(), v.transpose(2, 0, 1, 3).copy()
    jf, tf = (jattn.sdpa_head_major, tattn.sdpa_head_major) if head_major else (jattn.sdpa,
                                                                                 tattn.sdpa)
    want = jf(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.25, mask=jnp.asarray(mask),
              logits_softcap=5.0)
    got = tf(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=0.25,
             mask=torch.from_numpy(mask), logits_softcap=5.0)
    _close(got.numpy(), want, OPS)
    # the cap changes the result at these magnitudes
    uncapped = tf(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=0.25,
                  mask=torch.from_numpy(mask))
    assert np.abs(uncapped.numpy() - np.asarray(want)).max() > 1e-3


D, PAGE = 256, 16


def _paged_case(kv_lens, Hq, Hkv, MP, seed, head_major=True, T=1):
    rng = np.random.default_rng(seed)
    B = len(kv_lens)
    P = 1 + B * MP
    shape = (Hkv, P, PAGE, D) if head_major else (P, PAGE, Hkv, D)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    q = (rng.standard_normal((B, T, Hq, D)) * 4).astype(np.float32)
    kw = dict(positions=np.zeros((B, T), np.int32), slot_mapping=np.zeros((B, T), np.int32),
              block_tables=(1 + rng.permutation(P - 1)).reshape(B, MP).astype(np.int32),
              kv_lens=np.asarray(kv_lens, np.int32), active=np.ones(B, np.float32))
    jm = jpa.PagedAttnMeta(**{n: jnp.asarray(a) for n, a in kw.items()}, head_major=head_major)
    tm = tpa.PagedAttnMeta(**{n: torch.from_numpy(a) for n, a in kw.items()},
                           head_major=head_major)
    return ((jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm),
            (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tm))


@pytest.mark.parametrize("head_major", [True, False])
@pytest.mark.parametrize("T,kv_lens,window", [(1, (200, 77, 500), None), (1, (300, 1), 64),
                                              (64, (300, 64), 100)])
def test_reference_with_softcap_matches_jax(head_major, T, kv_lens, window):
    j, t = _paged_case(kv_lens, 16, 8, MP=32, seed=T + len(kv_lens), head_major=head_major, T=T)
    want = jpa.paged_attention_reference(*j, scale=D ** -0.5, sliding_window=window,
                                         logits_softcap=50.0)
    got = tpa.paged_attention_reference(*t, scale=D ** -0.5, sliding_window=window,
                                        logits_softcap=50.0)
    _close(got.numpy(), want, TIGHT)


@pytest.mark.parametrize("kv_lens,Hq,Hkv", [((200, 77), 16, 8), ((511, 1, 16), 8, 4)])
def test_decode_plain_with_softcap_matches_jax_paged_kernel(kv_lens, Hq, Hkv):
    j, t = _paged_case(kv_lens, Hq, Hkv, MP=32, seed=Hq + len(kv_lens))
    with pltpu.force_tpu_interpret_mode():
        want = jpa.paged_decode_attention(*j, scale=D ** -0.5, logits_softcap=50.0)
    before = tpa.paged_decode_launches
    got = tpa.paged_decode_attention(*t, scale=D ** -0.5, logits_softcap=50.0)
    assert tpa.paged_decode_launches == before  # the plain version on the CPU
    _close(got.numpy(), want, LIBRARY_K7)
    ref = jpa.paged_attention_reference(*j, scale=D ** -0.5, logits_softcap=50.0)
    _close(got.numpy(), ref, TIGHT)


def test_decode_wrapper_checks_the_soft_cap():
    _, t = _paged_case((40,), 4, 2, MP=4, seed=0)
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(*t, scale=0.1, logits_softcap=0.0)


@pytest.mark.parametrize("over", [dict(mem_bytes=6 << 30), dict(context_len=4096),
                                  dict(mem_bytes=1 << 20)])
def test_pool_sizing_at_gemma2_widths_matches_jax(over):
    """calculate_num_pages at Gemma-2-9B's 42 layers of 8 kv heads of 256:
    344 KB of bf16 K and V a token, 5.5 MB a page of 16."""
    from mistralrs_tpu.utils import memory as jmem
    from mistralrs_tpu_torch.utils import memory as tmem

    kw = dict(num_layers=42, num_kv_heads=8, head_dim=256, dtype_bytes=2, max_seqs=16)
    got = tmem.calculate_num_pages(tmem.PagedCacheConfig(**over), **kw, device="cpu")
    want = jmem.calculate_num_pages(jmem.PagedCacheConfig(**over), **kw)
    assert got == want
    if "mem_bytes" in over:
        assert got == max(over["mem_bytes"] // (2 * 42 * 8 * 256 * 16 * 2), 2)
