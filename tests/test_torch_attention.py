"""Port vs JAX package: flash prefill (K6's plain version), sdpa, norms, rope,
and the paged KV cache ops. Everything in f32 on the CPU.

Attention outputs are f32 softmax-weighted sums computed in another order
on each side (einsum vs the blockwise flash kernel), so they are held to
1e-5 relative to their largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention

from mistralrs_tpu.ops import attention as jattn
from mistralrs_tpu.ops import layers as jlayers
from mistralrs_tpu.ops import paged_attention as jpa
from mistralrs_tpu.ops import rope as jrope
from mistralrs_tpu_torch.ops import attention as tattn
from mistralrs_tpu_torch.ops import flash_attention as tfa
from mistralrs_tpu_torch.ops import layers as tlayers
from mistralrs_tpu_torch.ops import paged_attention as tpa
from mistralrs_tpu_torch.ops import rope as trope

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _qkv(B, T, Hq, Hkv, D=128, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, T, H, D)).astype(np.float32) for H in (Hq, Hkv, Hkv))


@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (8, 2)])
def test_flash_plain_matches_pallas_flash_attention(Hq, Hkv):
    """Against the library Pallas kernel, in interpret mode, with K/V
    repeated per query head as decoder.py does before calling it."""
    B, T = 1, 256
    q, k, v = _qkv(B, T, Hq, Hkv, seed=Hq)
    rep = Hq // Hkv
    scale = 128 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = flash_attention(
            jnp.asarray(q).transpose(0, 2, 1, 3),
            jnp.repeat(jnp.asarray(k), rep, axis=2).transpose(0, 2, 1, 3),
            jnp.repeat(jnp.asarray(v), rep, axis=2).transpose(0, 2, 1, 3),
            causal=True, sm_scale=scale).transpose(0, 2, 1, 3)
    got = tfa.flash_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    _close(got.numpy(), want)


@pytest.mark.parametrize("T,Hq,Hkv", [(200, 4, 2), (77, 8, 2), (128, 4, 4)])
def test_flash_plain_matches_sdpa_with_causal_bias(T, Hq, Hkv):
    """Against JAX sdpa + causal_mask_bias, including a T that is not a
    multiple of 128."""
    q, k, v = _qkv(2, T, Hq, Hkv, seed=T)
    scale = 0.1
    want = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
                      mask=jattn.causal_mask_bias(T, T))
    got = tfa.flash_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    _close(got.numpy(), want)


def test_sdpa_and_causal_bias_match():
    q, k, v = _qkv(2, 5, 4, 2, seed=1)
    offs = np.array([3, 0], np.int32)
    jb = jattn.causal_mask_bias(5, 8, q_offsets=jnp.asarray(offs), sliding_window=4)
    tb = tattn.causal_mask_bias(5, 8, q_offsets=torch.from_numpy(offs), sliding_window=4)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    kk, vv = _qkv(2, 8, 2, 2, seed=2)[1:]
    want = jattn.sdpa(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv), scale=0.2, mask=jb)
    got = tattn.sdpa(torch.from_numpy(q), torch.from_numpy(kk), torch.from_numpy(vv), scale=0.2,
                     mask=tb)
    _close(got.numpy(), want)


def test_rms_norm_matches():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 7, 512)).astype(np.float32)
    w = rng.standard_normal(512).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    _close(got.numpy(), want)


def test_silu_and_swiglu_match():
    rng = np.random.default_rng(4)
    g, u = (rng.standard_normal((5, 96)).astype(np.float32) * 4 for _ in range(2))
    _close(tlayers.silu(torch.from_numpy(g)).numpy(), jlayers.silu(jnp.asarray(g)))
    _close(tlayers.swiglu(torch.from_numpy(g), torch.from_numpy(u)).numpy(),
           jlayers.swiglu(jnp.asarray(g), jnp.asarray(u)))


@pytest.mark.parametrize("theta,scaling", [(1e6, None), (1e4, {"type": "linear", "factor": 2.0})])
def test_rope_table_and_apply_match(theta, scaling):
    jt = jrope.compute_rope_table(128, 512, theta=theta, rope_scaling=scaling)
    tt = trope.compute_rope_table(128, 512, theta=theta, rope_scaling=scaling, device="cpu")
    np.testing.assert_array_equal(tt.cos.numpy(), np.asarray(jt.cos))
    np.testing.assert_array_equal(tt.sin.numpy(), np.asarray(jt.sin))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 4, 128)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5], [100, 101, 102, 103, 104, 511]], np.int32)
    jc, js = jt.gather(jnp.asarray(pos))
    tc, ts = tt.gather(torch.from_numpy(pos).long())
    want = jrope.apply_rope(jnp.asarray(x), jc, js, 128)
    got = trope.apply_rope(torch.from_numpy(x), tc, ts, 128)
    _close(got.numpy(), want, rtol=1e-6)


def test_rope_scalings_not_ported_raise():
    with pytest.raises(NotImplementedError):
        trope.compute_rope_table(128, 64, rope_scaling={"rope_type": "llama3"}, device="cpu")


# ------------------------------------------------------------- paged cache

L_, P_, PAGE, HKV, D = 2, 8, 4, 2, 128


def _pools(seed=5):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L_, P_, PAGE, HKV, D)).astype(np.float32)
    v = rng.standard_normal((L_, P_, PAGE, HKV, D)).astype(np.float32)
    jc = jpa.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v))
    tc = tpa.PagedKVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()))
    return jc, tc


def _slots():
    # row 0: positions 0..5 on pages [3, 5]; row 1: 3 real tokens on page 2
    # then padding into the garbage page 0
    return np.array([[12, 13, 14, 15, 20, 21], [8, 9, 10, 0, 0, 0]], np.int32)


def test_write_and_gather_paged_kv_match():
    jc, tc = _pools()
    rng = np.random.default_rng(6)
    nk = rng.standard_normal((2, 6, HKV, D)).astype(np.float32)
    nv = rng.standard_normal((2, 6, HKV, D)).astype(np.float32)
    slots = _slots()
    jk, jv = jpa.write_paged_kv(jc.k[1], jc.v[1], jnp.asarray(nk), jnp.asarray(nv),
                                jnp.asarray(slots))
    tpa.write_paged_kv(tc.k[1], tc.v[1], torch.from_numpy(nk), torch.from_numpy(nv),
                       torch.from_numpy(slots))  # in place
    # page 0 is garbage (several padding writes race for one slot)
    np.testing.assert_array_equal(tc.k[1, 1:].numpy(), np.asarray(jk)[1:])
    np.testing.assert_array_equal(tc.v[1, 1:].numpy(), np.asarray(jv)[1:])
    tables = np.array([[3, 5, 0], [2, 0, 0]], np.int32)
    jg = jpa.gather_paged_kv(jk, jv, jnp.asarray(tables))
    tg = tpa.gather_paged_kv(tc.k[1], tc.v[1], torch.from_numpy(tables))
    for a, b in zip(jg, tg):
        assert b.shape == (2, 3 * PAGE, HKV, D)
        np.testing.assert_array_equal(b.numpy()[0], np.asarray(a)[0])


def test_paged_attention_reference_matches():
    jc, tc = _pools(7)
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 2, 4, D)).astype(np.float32)
    tables = np.array([[3, 5, 6], [2, 1, 0]], np.int32)
    kv_lens = np.array([9, 6], np.int32)
    kw = dict(positions=np.array([[7, 8], [4, 5]], np.int32),
              slot_mapping=np.zeros((2, 2), np.int32), block_tables=tables, kv_lens=kv_lens,
              active=np.ones(2, np.float32))
    jm = jpa.PagedAttnMeta(**{k: jnp.asarray(v) for k, v in kw.items()})
    tm = tpa.PagedAttnMeta(**{k: torch.from_numpy(v) for k, v in kw.items()})
    want = jpa.paged_attention_reference(jnp.asarray(q), jc.k[0], jc.v[0], jm, scale=0.1)
    got = tpa.paged_attention_reference(torch.from_numpy(q), tc.k[0], tc.v[0], tm, scale=0.1)
    _close(got.numpy(), want)


def test_copy_pages_matches():
    jc, tc = _pools(9)
    src, dst = [1, 4, 2], [6, 2, 7]  # page 2 is both read and overwritten
    want = jpa.copy_pages(jc, src, dst)
    got = tpa.copy_pages(tc, src, dst)
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
