"""The plain versions of the paged attention kernels K6'
(`flash_prefill_continuation`) and K7 (`paged_decode_attention`) against the
JAX package, f32 on the CPU, where the port's wrappers take them.

- K6' against JAX `flash_prefill_continuation`, which runs the library
  Pallas flash kernel over a right-aligned span, here in interpret mode:
  1e-5 of the largest |output| (f32 sums in another order; measured ~1.4e-6
  absolute at these shapes).
- K7 against JAX `paged_decode_attention`, the library Pallas paged
  attention kernel in interpret mode: that kernel agrees with the JAX
  package's own `paged_attention_reference` only to ~2.3e-3 absolute at a
  largest |output| of ~0.53 on these inputs, so the comparison allows 1e-2
  of the largest |output|.
- Both against JAX `paged_attention_reference` at 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mistralrs_tpu.ops import paged_attention as jpa
from mistralrs_tpu_torch.ops import paged_attention as tpa

D, PAGE = 128, 16
TIGHT = 1e-5
LIBRARY_K7 = 1e-2
LAYOUTS = [pytest.param(True, id="head_major"), pytest.param(False, id="token_major")]


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _case(head_major, T, kv_lens, Hq, Hkv, MP, seed):
    """(JAX inputs, port inputs): q [B,T,Hq,D], one layer's pools with
    shuffled pages (page 0 unused) and metas whose tables are MP pages wide."""
    rng = np.random.default_rng(seed)
    B = len(kv_lens)
    P = 1 + B * MP
    shape = (Hkv, P, PAGE, D) if head_major else (P, PAGE, Hkv, D)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    kw = dict(positions=np.zeros((B, T), np.int32), slot_mapping=np.zeros((B, T), np.int32),
              block_tables=(1 + rng.permutation(P - 1)).reshape(B, MP).astype(np.int32),
              kv_lens=np.asarray(kv_lens, np.int32), active=np.ones(B, np.float32))
    jm = jpa.PagedAttnMeta(**{n: jnp.asarray(a) for n, a in kw.items()}, head_major=head_major)
    tm = tpa.PagedAttnMeta(**{n: torch.from_numpy(a) for n, a in kw.items()},
                           head_major=head_major)
    j = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm)
    t = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tm)
    return j, t


# kv_lens end mid-page; the last row's kv_len equals T, so it starts at 0 (a
# batch that mixes a first chunk with a continuation chunk); the tables span
# 256 and 512 positions (the last case's 384 rows are three of the kernel's
# 128-row query tiles)
CONT = [(128, (200, 140, 128), 16), (256, (450, 301, 256), 32), (384, (500, 421, 384), 32)]


@pytest.mark.parametrize("head_major", LAYOUTS)
@pytest.mark.parametrize("T,kv_lens,MP", CONT)
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (8, 2)])
def test_continuation_plain_matches_jax_flash_kernel(head_major, T, kv_lens, MP, Hq, Hkv):
    j, t = _case(head_major, T, kv_lens, Hq, Hkv, MP=MP, seed=T + Hq)
    with pltpu.force_tpu_interpret_mode():
        want = jpa.flash_prefill_continuation(*j, scale=D ** -0.5)
    got = tpa.flash_prefill_continuation(*t, scale=D ** -0.5)
    _close(got.numpy(), want, TIGHT)


@pytest.mark.parametrize("kv_lens", [(200, 77), (511, 1, 16)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (8, 2)])
def test_decode_plain_matches_jax_paged_kernel(kv_lens, Hq, Hkv):
    j, t = _case(True, 1, kv_lens, Hq, Hkv, MP=32, seed=Hq + len(kv_lens))
    with pltpu.force_tpu_interpret_mode():
        want = jpa.paged_decode_attention(*j, scale=D ** -0.5)
    got = tpa.paged_decode_attention(*t, scale=D ** -0.5)
    _close(got.numpy(), want, LIBRARY_K7)


@pytest.mark.parametrize("head_major", LAYOUTS)
@pytest.mark.parametrize("kind", ["continuation", "decode"])
def test_plain_versions_match_reference(head_major, kind):
    T, kv_lens = (256, (300, 256, 1000)) if kind == "continuation" else (1, (1, 333, 1000))
    j, t = _case(head_major, T, kv_lens, 8, 2, MP=64, seed=3)
    want = jpa.paged_attention_reference(*j, scale=0.07)
    fn = tpa.flash_prefill_continuation if kind == "continuation" else tpa.paged_decode_attention
    before = (tpa.flash_prefill_paged_launches, tpa.paged_decode_launches)
    _close(fn(*t, scale=0.07).numpy(), want, TIGHT)
    # CPU tensors take the plain version: no kernel launch is counted
    assert (tpa.flash_prefill_paged_launches, tpa.paged_decode_launches) == before


def test_decode_plain_row_with_no_context_is_zero():
    _, (q, k, v, m) = _case(True, 1, (40, 0), 4, 2, MP=4, seed=4)
    out = tpa.paged_decode_attention(q, k, v, m, scale=0.1)
    assert not bool(out[1].any()) and bool(out[0].any())


def test_wrappers_check_shapes_on_any_device():
    _, (q, k, v, m) = _case(True, 1, (40, 9), 4, 2, MP=4, seed=5)
    with pytest.raises(ValueError):  # two query tokens for the decode kernel
        tpa.paged_decode_attention(torch.cat([q, q], 1), k, v, m, scale=0.1)
    with pytest.raises(ValueError):  # 3 query heads over 2 kv heads
        tpa.flash_prefill_continuation(q[:, :, :3], k, v, m, scale=0.1)
    with pytest.raises(ValueError):  # the full [L, ...] pools, not one layer's
        tpa.paged_decode_attention(q, k[None], v[None], m, scale=0.1)
    with pytest.raises(ValueError):  # kv_lens of another batch
        tpa.paged_decode_attention(q[:1], k, v, m, scale=0.1)
