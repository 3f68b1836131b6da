"""The port's ragged attention backend (mistralrs_tpu_torch/ops/ragged_attention.py)
against the JAX package's, op by op, on the CPU in f32.

- `ragged_attention` (K12's plain version on the CPU) against the TPU
  library's own reference `ref_ragged_paged_attention` on the JAX test's
  mixed batch (a decode row, a first chunk and a continuation: q_lens
  1 / 8 / 4 over kv_lens 20 / 8 / 30), with and without a window of 16 and
  a soft cap of 30, at head dims 128 and 256 (GQA ratios 4 and 2): within
  2e-5 (f32 sums in another order).
- The adapters (`write_combined_kv`, `split_combined`, `combine_kv`,
  `flatten_queries`, `pack_ragged_meta`) equal to the JAX functions
  exactly.
- `ragged_attention_padded` against JAX's, whose kernel call is replaced in
  the test by the reference (nothing in the JAX package changes), on a
  padded continuation chunk beside a first chunk and a padding row, and on
  a decode step with padding rows: within 2e-5, padding rows zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.ragged_paged_attention import ref_ragged_paged_attention

from mistralrs_tpu.ops import paged_attention as jpa
from mistralrs_tpu.ops import ragged_attention as jra
from mistralrs_tpu_torch.ops import paged_attention as tpa
from mistralrs_tpu_torch.ops import ragged_attention as tra

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _mixed_batch(Hq, Hkv, D, page=4, P=64, seed=7):
    """The JAX test's mixed batch: a combined pool [P, page, 2*Hkv, D], the
    packed queries, kv_lens, tables, cu_q_lens and num_seqs (numpy)."""
    rng = np.random.default_rng(seed)
    q_lens, kv_lens = [1, 8, 4], [20, 8, 30]
    B = len(q_lens)
    W = max(-(-kv // page) for kv in kv_lens)
    tables = np.zeros((B, W), np.int32)
    nxt = 1
    for i, kv in enumerate(kv_lens):
        n = -(-kv // page)
        tables[i, :n] = np.arange(nxt, nxt + n)
        nxt += n
    pool = rng.standard_normal((P, page, 2 * Hkv, D)).astype(np.float32)
    q = rng.standard_normal((sum(q_lens), Hq, D)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    return q, pool, np.asarray(kv_lens, np.int32), tables, cu, np.asarray([B], np.int32)


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("Hq,Hkv,D", [(8, 2, 128), (4, 2, 256)])
def test_ragged_attention_matches_the_tpu_reference(window, cap, Hq, Hkv, D):
    q, pool, kv_lens, tables, cu, num_seqs = _mixed_batch(Hq, Hkv, D)
    # scores wide enough for the cap to bite
    q = q * 3.0
    scale = D ** -0.5
    want = np.asarray(ref_ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(kv_lens), jnp.asarray(tables),
        jnp.asarray(cu), jnp.asarray(num_seqs), sm_scale=scale, sliding_window=window,
        soft_cap=cap))
    before = tra.ragged_attention_launches
    got = tra.ragged_attention(_t(q), _t(pool), _t(kv_lens), _t(tables), _t(cu), _t(num_seqs),
                               scale=scale, sliding_window=window, logits_softcap=cap).numpy()
    assert tra.ragged_attention_launches == before  # the plain version ran
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_the_window_and_the_cap_move_the_output():
    """Each option changes the reference's output by far more than TOL, so
    the comparison above sees it."""
    q, pool, kv_lens, tables, cu, num_seqs = _mixed_batch(8, 2, 128)
    args = [_t(a) for a in (q * 3.0, pool, kv_lens, tables, cu, num_seqs)]
    base = tra.ragged_attention(*args, scale=128 ** -0.5).numpy()
    for kw in (dict(sliding_window=16), dict(logits_softcap=30.0)):
        other = tra.ragged_attention(*args, scale=128 ** -0.5, **kw).numpy()
        assert np.abs(other - base).max() > 100 * TOL, kw


def test_rows_past_num_seqs_are_zero_on_the_cpu():
    q, pool, kv_lens, tables, cu, _ = _mixed_batch(8, 2, 128)
    got = tra.ragged_attention(_t(q), _t(pool), _t(kv_lens), _t(tables), _t(cu),
                               _t(np.asarray([2], np.int32)), scale=0.1).numpy()
    assert not got[cu[2]:].any() and got[:cu[2]].any()


def test_write_split_and_combine_match_jax_exactly():
    rng = np.random.default_rng(3)
    P, page, H, D, B, T = 6, 4, 2, 8, 2, 5
    k = rng.standard_normal((B, T, H, D)).astype(np.float32)
    v = rng.standard_normal((B, T, H, D)).astype(np.float32)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    pos = np.tile(np.arange(T), (B, 1))
    slots = tables[np.arange(B)[:, None], pos // page] * page + pos % page
    slots[1, 3:] = 0  # padding tokens into page 0
    start = rng.standard_normal((P, page, 2 * H, D)).astype(np.float32)
    want = np.asarray(jra.write_combined_kv(jnp.asarray(start), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(slots)))
    pool = _t(start.copy())
    # several padding tokens share slot 0; which lands there does not matter
    got = tra.write_combined_kv(pool, _t(k), _t(v), _t(slots)).numpy()
    keep = np.ones((P * page,), bool)
    keep[0] = False
    np.testing.assert_array_equal(got.reshape(P * page, -1)[keep],
                                  want.reshape(P * page, -1)[keep])
    for jv, tv in zip(jra.split_combined(jnp.asarray(want)), tra.split_combined(_t(want))):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    k_hm = rng.standard_normal((H, P, page, D)).astype(np.float32)
    v_hm = rng.standard_normal((H, P, page, D)).astype(np.float32)
    np.testing.assert_array_equal(tra.combine_kv(_t(k_hm), _t(v_hm)).numpy(),
                                  np.asarray(jra.combine_kv(jnp.asarray(k_hm), jnp.asarray(v_hm))))


@pytest.mark.parametrize("q_lens", [[1, 4, 2], [0, 3, 4], [4, 0, 0], [0, 0, 0]])
def test_flatten_queries_matches_jax_exactly(q_lens):
    q = np.random.default_rng(1).standard_normal((3, 4, 2, 8)).astype(np.float32)
    jf, jcu = jra.flatten_queries(jnp.asarray(q), jnp.asarray(q_lens, jnp.int32))
    tf, tcu = tra.flatten_queries(_t(q), torch.tensor(q_lens, dtype=torch.int32))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tcu.numpy(), np.asarray(jcu))
    assert tcu.dtype == torch.int32


def _padded_step(rng, B, T, Hkv, D, page, P, rows):
    """A padded step over a combined pool already holding each row's
    context and this step's K/V: rows = [(start, n)] of the live rows (the
    rest padding). Returns (numpy meta fields, pool)."""
    W = 8
    tables = np.zeros((B, W), np.int32)
    slots = np.zeros((B, T), np.int32)
    positions = np.zeros((B, T), np.int32)
    kv_lens = np.ones((B,), np.int32)
    active = np.zeros((B,), np.float32)
    pool = rng.standard_normal((P, page, 2 * Hkv, D)).astype(np.float32)
    nxt = 1
    for i, (start, n) in enumerate(rows):
        tables[i] = np.arange(nxt, nxt + W)
        nxt += W
        pos = np.arange(start, start + n)
        slots[i, :n] = tables[i, pos // page] * page + pos % page
        positions[i, :n] = pos
        kv_lens[i] = start + T  # the padded-width convention
        active[i] = 1.0
    meta = dict(positions=positions, slot_mapping=slots, block_tables=tables, kv_lens=kv_lens,
                active=active)
    return meta, pool


# (B, T, live rows (start, real tokens)): a continuation of 5 tokens padded
# to 8 after 12 cached ones beside a first chunk of 8 and a padding row;
# a decode step of 2 live rows among 4
STEPS = [(3, 8, [(12, 5), (0, 8)]), (4, 1, [(20, 1), (7, 1)])]


@pytest.mark.parametrize("B,T,rows", STEPS)
@pytest.mark.parametrize("window,cap", [(None, None), (6, 30.0)])
def test_pack_and_padded_match_jax(monkeypatch, B, T, rows, window, cap):
    Hq, Hkv, D, page, P = 4, 2, 16, 4, 32
    rng = np.random.default_rng(B + T)
    meta_np, pool = _padded_step(rng, B, T, Hkv, D, page, P, rows)
    q = (rng.standard_normal((B, T, Hq, D)) * 3.0).astype(np.float32)
    jmeta = jpa.PagedAttnMeta(**{k: jnp.asarray(v) for k, v in meta_np.items()})
    tmeta = tpa.PagedAttnMeta(**{k: _t(v) for k, v in meta_np.items()})

    jpack = jra.pack_ragged_meta(jnp.asarray(q), jmeta, page)
    tpack = tra.pack_ragged_meta(_t(q), tmeta, page)
    for jv, tv in zip(jpack, tpack):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tpack[2].dtype == tpack[1].dtype == torch.int32

    def reference_call(q_flat, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *, scale,
                       sliding_window=None, logits_softcap=None):
        return ref_ragged_paged_attention(q_flat, kv_pages, kv_lens, page_indices, cu_q_lens,
                                          num_seqs, sm_scale=scale,
                                          sliding_window=sliding_window, soft_cap=logits_softcap)

    monkeypatch.setattr(jra, "ragged_attention", reference_call)
    kw = dict(scale=D ** -0.5, sliding_window=window, logits_softcap=cap)
    want = np.asarray(jra.ragged_attention_padded(jnp.asarray(q), jnp.asarray(pool), jmeta, **kw))
    got = tra.ragged_attention_padded(_t(q), _t(pool), tmeta, **kw).numpy()
    assert got.shape == (B, T, Hq, D)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for i, (_, n) in enumerate(rows):  # real rows attended, padding zero
        assert np.abs(got[i, :n]).max() > 0.1 and not got[i, n:].any()
    assert not got[len(rows):].any()
    # the plan that the decoder builds once a step gives the same result
    plan = tra.ragged_plan(tmeta, T, page)
    again = tra.ragged_attention_padded(_t(q), _t(pool), tmeta, plan=plan, **kw).numpy()
    np.testing.assert_array_equal(again, got)


def test_the_padded_width_convention_is_unwound():
    """kv_lens = start + T for a chunk of n < T real tokens: the kernel's
    kv_len is start + n, or the real queries would shift up by T - n and
    attend unwritten slots."""
    meta_np, _ = _padded_step(np.random.default_rng(0), 3, 8, 2, 16, 4, 32, [(12, 5), (0, 8)])
    plan = tra.ragged_plan(tpa.PagedAttnMeta(**{k: _t(v) for k, v in meta_np.items()}), 8, 4)
    assert plan.q_lens.tolist() == [5, 8, 0] and plan.kv_lens.tolist() == [17, 8, 1]
    assert plan.cu_q_lens.tolist() == [0, 5, 13, 13] and plan.num_seqs.tolist() == [2]


def test_wrapper_raises_on_shapes_that_do_not_match():
    q, pool, kv_lens, tables, cu, num_seqs = (_t(a) for a in _mixed_batch(8, 2, 128))
    with pytest.raises(ValueError):  # query heads not a multiple of the kv heads
        tra.ragged_attention(q[:, :7].contiguous(), pool, kv_lens, tables, cu, num_seqs, scale=1.0)
    with pytest.raises(ValueError):  # cu_q_lens of another batch
        tra.ragged_attention(q, pool, kv_lens, tables, cu[:-1], num_seqs, scale=1.0)
    with pytest.raises(ValueError):  # a zero soft cap
        tra.ragged_attention(q, pool, kv_lens, tables, cu, num_seqs, scale=1.0,
                             logits_softcap=0.0)
