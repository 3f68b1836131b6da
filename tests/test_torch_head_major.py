"""Port vs JAX package: the paged KV cache in both pool layouts (head-major
[L, Hkv, P, page, D] and token-major [L, P, page, Hkv, D]) and
`sdpa_head_major`. Everything in f32 on the CPU.

Cache writes, gathers and page copies move values without arithmetic, so
they must agree exactly (page 0, the garbage page several padding writes
race for, excepted). Attention outputs are f32 softmax-weighted sums whose
summation order differs between the einsums of the two frameworks: they are
held to 1e-5 of their largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.ops import attention as jattn
from mistralrs_tpu.ops import paged_attention as jpa
from mistralrs_tpu_torch.ops import attention as tattn
from mistralrs_tpu_torch.ops import paged_attention as tpa

RTOL = 1e-5
L_, P_, PAGE, HKV, D = 2, 9, 4, 2, 128
LAYOUTS = [pytest.param(True, id="head_major"), pytest.param(False, id="token_major")]


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _pools(head_major, seed):
    rng = np.random.default_rng(seed)
    shape = (L_, HKV, P_, PAGE, D) if head_major else (L_, P_, PAGE, HKV, D)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    jc = jpa.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v), head_major=head_major)
    tc = tpa.PagedKVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
                          head_major=head_major)
    return jc, tc


def _real_pages(x, head_major):
    """Every page but the garbage page 0, in either layout, as numpy."""
    x = np.asarray(x)
    return x[:, 1:] if head_major else x[1:]


@pytest.mark.parametrize("head_major", LAYOUTS)
def test_create_matches_layout(head_major):
    jc = jpa.PagedKVCache.create(3, 7, 16, 2, 128, jnp.float32, head_major=head_major)
    tc = tpa.PagedKVCache.create(3, 7, 16, 2, 128, torch.float32, device="cpu",
                                 head_major=head_major)
    assert tuple(tc.k.shape) == jc.k.shape and tuple(tc.v.shape) == jc.v.shape
    assert (tc.page_size, tc.num_pages, tc.page_axis) == (jc.page_size, jc.num_pages,
                                                           jc.page_axis)
    assert tc.head_major == head_major and not bool(tc.k.any())


@pytest.mark.parametrize("head_major", LAYOUTS)
def test_write_paged_kv_matches(head_major):
    jc, tc = _pools(head_major, 5)
    rng = np.random.default_rng(6)
    nk = rng.standard_normal((2, 6, HKV, D)).astype(np.float32)
    nv = rng.standard_normal((2, 6, HKV, D)).astype(np.float32)
    # row 0: positions 0..5 on pages [3, 5]; row 1: 3 real tokens on page 2,
    # then padding into the garbage page 0
    slots = np.array([[12, 13, 14, 15, 20, 21], [8, 9, 10, 0, 0, 0]], np.int32)
    jk, jv = jpa.write_paged_kv(jc.k[1], jc.v[1], jnp.asarray(nk), jnp.asarray(nv),
                                jnp.asarray(slots), head_major=head_major)
    tpa.write_paged_kv(tc.k[1], tc.v[1], torch.from_numpy(nk), torch.from_numpy(nv),
                       torch.from_numpy(slots), head_major=head_major)  # in place
    np.testing.assert_array_equal(_real_pages(tc.k[1].numpy(), head_major),
                                  _real_pages(jk, head_major))
    np.testing.assert_array_equal(_real_pages(tc.v[1].numpy(), head_major),
                                  _real_pages(jv, head_major))
    np.testing.assert_array_equal(tc.k[0].numpy(), np.asarray(jc.k[0]))  # other layer untouched


@pytest.mark.parametrize("head_major", LAYOUTS)
def test_gather_paged_kv_matches(head_major):
    jc, tc = _pools(head_major, 7)
    tables = np.array([[3, 5, 0], [2, 8, 1]], np.int32)
    jg = jpa.gather_paged_kv(jc.k[0], jc.v[0], jnp.asarray(tables), head_major=head_major)
    tg = tpa.gather_paged_kv(tc.k[0], tc.v[0], torch.from_numpy(tables), head_major=head_major)
    want_shape = (HKV, 2, 3 * PAGE, D) if head_major else (2, 3 * PAGE, HKV, D)
    for a, b in zip(jg, tg):
        assert tuple(b.shape) == want_shape
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("head_major", LAYOUTS)
@pytest.mark.parametrize("window", [None, 5])
def test_paged_attention_reference_matches(head_major, window):
    jc, tc = _pools(head_major, 8)
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 3, 4, D)).astype(np.float32)
    kw = dict(positions=np.array([[7, 8, 9], [3, 4, 5]], np.int32),
              slot_mapping=np.zeros((2, 3), np.int32),
              block_tables=np.array([[3, 5, 6], [2, 1, 0]], np.int32),
              kv_lens=np.array([10, 6], np.int32), active=np.ones(2, np.float32))
    jm = jpa.PagedAttnMeta(**{k: jnp.asarray(v) for k, v in kw.items()}, head_major=head_major)
    tm = tpa.PagedAttnMeta(**{k: torch.from_numpy(v) for k, v in kw.items()},
                           head_major=head_major)
    want = jpa.paged_attention_reference(jnp.asarray(q), jc.k[0], jc.v[0], jm, scale=0.1,
                                         sliding_window=window)
    got = tpa.paged_attention_reference(torch.from_numpy(q), tc.k[0], tc.v[0], tm, scale=0.1,
                                        sliding_window=window)
    _close(got.numpy(), want)


@pytest.mark.parametrize("head_major", LAYOUTS)
def test_copy_pages_matches(head_major):
    jc, tc = _pools(head_major, 10)
    src, dst = [1, 4, 2], [6, 2, 7]  # page 2 is both read and overwritten
    want = jpa.copy_pages(jc, src, dst)
    got = tpa.copy_pages(tc, src, dst)
    assert got is tc  # in place
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))


@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (4, 2), (8, 2)])
@pytest.mark.parametrize("T", [1, 5])
def test_sdpa_head_major_matches(Hq, Hkv, T):
    rng = np.random.default_rng(Hq * 10 + T)
    B, S = 2, 24
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((Hkv, B, S, D)).astype(np.float32)
    v = rng.standard_normal((Hkv, B, S, D)).astype(np.float32)
    offs = np.array([S - T, 7], np.int32)
    mask = jattn.causal_mask_bias(T, S, q_offsets=jnp.asarray(offs))
    want = jattn.sdpa_head_major(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.09,
                                 mask=mask)
    got = tattn.sdpa_head_major(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                scale=0.09, mask=torch.from_numpy(np.array(mask)))
    _close(got.numpy(), want)
    # the same function as sdpa on the token-major view of the context
    tok = tattn.sdpa(torch.from_numpy(q), torch.from_numpy(k).permute(1, 2, 0, 3),
                     torch.from_numpy(v).permute(1, 2, 0, 3), scale=0.09,
                     mask=torch.from_numpy(np.array(mask)))
    _close(got.numpy(), tok.numpy())
