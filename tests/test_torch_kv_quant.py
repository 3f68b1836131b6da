"""The port's int8 KV cache (PipelineConfig.kv_quant) and KV swap
preemption against the JAX package's, on the CPU.

(a) write_paged_kv_q / gather_paged_kv_q: payloads and scales bit-equal to
    JAX's in both pool layouts (a row of zeros takes the 1e-8 scale floor,
    a row with exact halves shows round-half-to-even), the dequantized
    context bit-equal in f32 and bf16, and the round trip within
    rowmax / 254 of each value (half a quantization step).
(b) copy_pages carries an int8 pool's scales, and swap_out_pages /
    swap_in_pages restore every leaf bit for bit, in place.
(c) Greedy engines with kv_quant=True on the tiny Q4_K_M-mix model of
    tests/torch_port_model.py (1 layer): the port's tokens equal JAX's,
    with the prefix cache (and without it, the port's); swap preemption (preempt_mode="swap")
    gives the streams of an uncontended run and of JAX's swap engine, with
    no prefill of a swapped sequence after its swap.

Tolerances: bit equality where stated; the engine runs use the dequant
route of every GEMV in the port (MAX_KERNEL_ROWS = -1, as JAX computes on
the CPU), so their raw logits differ only by f32 summation order, and by
an int8 rounding of K/V that the order flips: 1e-4 of each step's
largest |logit|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.engine.engine import Engine as JEngine
from mistralrs_tpu.engine.engine import GenerationRequest as JRequest
from mistralrs_tpu.engine.sampler import SamplingParams as JSampling
from mistralrs_tpu.engine.sequence import SequenceState as JState
from mistralrs_tpu.models.loader import make_rope as jmake_rope
from mistralrs_tpu.ops import paged_attention as jpa
from mistralrs_tpu.pipeline.text import PipelineConfig as JPipelineConfig
from mistralrs_tpu.pipeline.text import TextPipeline as JTextPipeline
from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.engine.sequence import SequenceState
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.ops import paged_attention as tpa
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
from torch_port_model import jax_q4km_params, one_thread, port_config, port_params  # noqa: F401

LOGIT_RTOL = 1e-4

# ------------------------------------------------------------- the ops

L_, P_, PAGE_, H_, D_, B_, T_ = 2, 8, 4, 2, 16, 2, 6


def _new_kv(seed):
    """K/V rows [B, T, H, D] of unlike ranges, one all zeros and one made of
    exact halves of its scale (max 127, so s = 1)."""
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((B_, T_, H_, D_)) * 3.0).astype(np.float32)
    v = (rng.standard_normal((B_, T_, H_, D_)) * 0.1).astype(np.float32)
    k[0, 1, 0] = 0.0
    k[1, 2, 1, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    k[1, 2, 1, 6:] = 0.25
    return k, v


def _slots(tables):
    pos = np.tile(np.arange(T_), (B_, 1))
    return tables[np.arange(B_)[:, None], pos // PAGE_] * PAGE_ + pos % PAGE_


def _written(head_major, seed=3):
    """(JAX's layer-0 pools, the port's cache) after each wrote the same rows."""
    k, v = _new_kv(seed)
    tables = np.array([[1, 2], [3, 4]], np.int64)
    slots = _slots(tables)
    jc = jpa.PagedKVCache.create(L_, P_, PAGE_, H_, D_, head_major=head_major, quant=True)
    jck, jcv = jpa.write_paged_kv_q((jc.k[0], jc.k_scale[0]), (jc.v[0], jc.v_scale[0]),
                                    jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots),
                                    head_major=head_major)
    tc = tpa.PagedKVCache.create(L_, P_, PAGE_, H_, D_, device="cpu", head_major=head_major,
                                 quant=True)
    assert tc.quantized and tc.k.dtype == torch.int8 and tc.k_scale.dtype == torch.float32
    tpa.write_paged_kv_q((tc.k[0], tc.k_scale[0]), (tc.v[0], tc.v_scale[0]),
                         torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(slots),
                         head_major=head_major)
    return (jck, jcv), tc, tables, (k, v)


@pytest.mark.parametrize("head_major", [False, True])
def test_write_and_gather_are_bit_equal_to_jax(head_major):
    (jck, jcv), tc, tables, _ = _written(head_major)
    for (jp, js), tp, ts in ((jck, tc.k[0], tc.k_scale[0]), (jcv, tc.v[0], tc.v_scale[0])):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    # the floor and round-half-to-even, on the port's side
    hm_idx = (lambda h, slot: (h, slot // PAGE_, slot % PAGE_)) if head_major else (
        lambda h, slot: (slot // PAGE_, slot % PAGE_, h))
    slots = _slots(tables)
    assert float(tc.k_scale[0][hm_idx(0, slots[0, 1])]) == np.float32(1e-8)
    row = tc.k[0][hm_idx(1, slots[1, 2])]
    assert row[:6].tolist() == [127, 2, -4, 0, 0, 2]
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jk, jv = jpa.gather_paged_kv_q(jck, jcv, jnp.asarray(tables), head_major=head_major,
                                       dtype=jdt)
        tk, tv = tpa.gather_paged_kv_q((tc.k[0], tc.k_scale[0]), (tc.v[0], tc.v_scale[0]),
                                       torch.from_numpy(tables), head_major=head_major, dtype=dt)
        assert tk.dtype == dt
        for got, want in ((tk, jk), (tv, jv)):
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("head_major", [False, True])
def test_round_trip_is_within_half_a_step(head_major):
    _, tc, tables, (k, v) = _written(head_major, seed=7)
    gk, gv = tpa.gather_paged_kv_q((tc.k[0], tc.k_scale[0]), (tc.v[0], tc.v_scale[0]),
                                   torch.from_numpy(tables), head_major=head_major,
                                   dtype=torch.float32)
    if head_major:  # [H, B, S, D] -> [B, S, H, D]
        gk, gv = gk.permute(1, 2, 0, 3), gv.permute(1, 2, 0, 3)
    for got, want in ((gk, k), (gv, v)):
        tol = np.abs(want).max(axis=-1, keepdims=True) / 254 + 1e-6
        err = np.abs(got.numpy()[:, :T_] - want)
        assert (err <= tol * 1.01).all()


def test_page_ops_carry_the_scales():
    """A COW copy moves payload and scales; a swap out, the pages zeroed,
    and a swap in restores all four leaves bit for bit, in place."""
    _, tc, _, _ = _written(False, seed=5)
    ptrs = [t.data_ptr() for t in (tc.k, tc.v, tc.k_scale, tc.v_scale)]
    tpa.copy_pages(tc, [1], [5])
    for leaf in (tc.k, tc.v, tc.k_scale, tc.v_scale):
        assert torch.equal(leaf[:, 5], leaf[:, 1])
    assert tc.k_scale[:, 5].abs().max() > 0
    want = [t.clone() for t in (tc.k, tc.v, tc.k_scale, tc.v_scale)]
    host = tpa.swap_out_pages(tc, [1, 3])
    assert len(host) == 4 and all(h.device.type == "cpu" and h.shape[1] == 2 for h in host)
    for leaf in (tc.k, tc.v, tc.k_scale, tc.v_scale):
        leaf[:, [1, 3]] = 0
    assert tpa.swap_in_pages(tc, host, [1, 3]) is tc
    for got, w in zip((tc.k, tc.v, tc.k_scale, tc.v_scale), want):
        assert torch.equal(got, w)
    assert [t.data_ptr() for t in (tc.k, tc.v, tc.k_scale, tc.v_scale)] == ptrs
    with pytest.raises(ValueError):
        tpa.PagedKVCache.create(1, 4, 4, 2, 16, device="cpu", combined=True, quant=True)


# ------------------------------------------------------------- engines


@pytest.fixture(scope="module")
def model():
    return jax_q4km_params(seed=4, num_layers=1)


def _engines(model, monkeypatch, **kw):
    """(JAX engine, port engine) over the same weights; kw goes to both
    pipeline configs, or to Engine (prefix_cache, preempt_mode)."""
    jcfg, jraw = model
    monkeypatch.setenv("MISTRALRS_Q6K_RQ8", "32")
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)
    eng_kw = {k: kw.pop(k) for k in ("prefix_cache", "preempt_mode") if k in kw}
    pipe = dict(page_size=16, num_pages=96, max_seqs=4, max_model_len=512,
                prefill_buckets=(64, 128), decode_steps=4)
    pipe.update(kw)
    L = pipe["max_model_len"]
    jeng = JEngine(JTextPipeline(jcfg, jraw, jmake_rope(jcfg, L),
                                 JPipelineConfig(dtype=jnp.float32, **pipe)),
                   eos_token_ids=set(), **eng_kw)
    tcfg = port_config(jcfg)
    teng = Engine(TextPipeline(tcfg, port_params(jraw), make_rope(tcfg, L, device="cpu"),
                               PipelineConfig(dtype=torch.float32, device="cpu", **pipe)),
                  eos_token_ids=set(), **eng_kw)
    return jeng, teng


def _serve(eng, req, sp, prompts, max_len, together=True):
    """(generated tokens, their raw logits) of each greedy request."""
    out = []
    for wave in [prompts] if together else [[p] for p in prompts]:
        groups = [eng.add_request(req(list(p), sp(max_len=max_len))) for p in wave]
        while not all(g.all_done() for g in groups):
            eng.step()
        out += [(g.seqs[0].generated_tokens, np.array([lp.logprob for lp in g.seqs[0].logprobs]))
                for g in groups]
    return out


def _same(want, got, max_len):
    for (wt, wv), (gt, gv) in zip(want, got):
        assert len(gt) == max_len and gt == wt
        assert np.abs(gv - wv).max() <= LOGIT_RTOL * np.abs(wv).max()


def test_int8_kv_engine_matches_jax(model, monkeypatch, one_thread):
    """Two requests that share a 64-token prefix, served one after the other
    on head-major int8 pools (max_model_len 4096) with the prefix cache on,
    so the second attaches the first's int8 pages: the port's tokens equal
    JAX's, and a port engine without the prefix cache gives them too."""
    # 64-token chunks: no first chunk on the flash route, which the port
    # takes over the chunk's own K/V as JAX does on the TPU, where JAX on
    # the CPU attends the dequantized pool
    kw = dict(kv_quant=True, max_model_len=4096, prefill_buckets=(64,))
    jeng, teng = _engines(model, monkeypatch, prefix_cache=True, **kw)
    assert teng.pipeline.cache.quantized and teng.pipeline.head_major
    rng = np.random.default_rng(6)
    shared = [int(t) for t in rng.integers(1, model[0].vocab_size, 64)]
    prompts = [shared + [int(t) for t in rng.integers(1, model[0].vocab_size, n)]
               for n in (40, 9)]
    hits = []
    match = teng.prefix_cacher.match
    teng.prefix_cacher.match = lambda toks: (lambda r: (hits.append(r[0]), r)[1])(match(toks))
    max_len = 10
    want = _serve(jeng, JRequest, JSampling, prompts, max_len, together=False)
    _same(want, _serve(teng, GenerationRequest, SamplingParams, prompts, max_len, together=False),
          max_len)
    assert max(hits) >= 64
    cold = _engines(model, monkeypatch, prefix_cache=False, **kw)[1]
    _same(want, _serve(cold, GenerationRequest, SamplingParams, prompts, max_len, together=False),
          max_len)


def test_swap_preemption_restores_kv_exactly(model, monkeypatch, one_thread):
    """JAX tests/test_engine.py::test_swap_preemption_restores_kv_exactly on
    both engines: 3 requests in 15 usable pages of 4 tokens force swap
    preemption; the port reads each swapped-in sequence's context back
    bit-equal through its new pages; every stream equals an uncontended
    run's and JAX's swap engine's, no swapped sequence is prefilled again,
    and every page comes back to the pool."""
    rng = np.random.default_rng(103)
    prompts = [[int(t) for t in rng.integers(3, 120, n)] for n in (16, 14, 12)]
    lens = (24, 20, 16)
    kw = dict(page_size=4, max_seqs=3, max_model_len=128, prefill_buckets=(16,), decode_steps=1,
              prefix_cache=False)
    _, roomy = _engines(model, monkeypatch, num_pages=96, **kw)
    want = [roomy.generate(list(p), SamplingParams(max_len=n))[0] for p, n in zip(prompts, lens)]
    jeng, teng = _engines(model, monkeypatch, num_pages=16, preempt_mode="swap", **kw)
    # the port's restored context, read through each swapped-in sequence's
    # new pages, bit-equal to what it held at swap-out
    saved, restored = {}, []
    swapper, swap_in = teng.scheduler.swapper, teng._swap_in_seq

    def live(seq):
        cache = teng.pipeline.cache
        pages = torch.tensor(seq.block_table[:-(-seq.kv_len // 4)])
        return [leaf.index_select(cache.page_axis, pages) for leaf in (cache.k, cache.v)]

    def swap_out(seq):
        saved[id(seq)] = live(seq)
        swapper(seq)

    def restore(seq):
        swap_in(seq)
        restored.append(all(torch.equal(a, b) for a, b in zip(live(seq), saved.pop(id(seq)))))

    teng.scheduler.swapper, teng._swap_in_seq = swap_out, restore
    runs = []
    for eng, req, sp, swapped_state in (
            (teng, GenerationRequest, SamplingParams, SequenceState.SWAPPED_OUT),
            (jeng, JRequest, JSampling, JState.SWAPPED_OUT)):
        prefilled = []
        one, batch = eng.pipeline.run_prefill_chunk, eng.pipeline.run_prefill_chunks
        eng.pipeline.run_prefill_chunk = lambda seq, *a, **k: (prefilled.append(seq),
                                                               one(seq, *a, **k))[1]
        eng.pipeline.run_prefill_chunks = lambda items: (prefilled.extend(s for s, _ in items),
                                                         batch(items))[1]
        groups = [eng.add_request(req(list(p), sp(max_len=n))) for p, n in zip(prompts, lens)]
        seqs = [g.seqs[0] for g in groups]
        swapped = {}  # seq index -> prefill calls when it was first seen swapped
        for _ in range(2000):
            if not eng.has_work:
                break
            eng.step()
            for i, s in enumerate(seqs):
                if s.state == swapped_state:
                    swapped.setdefault(i, len(prefilled))
        assert not eng.has_work and swapped, "no swap preemption happened"
        for i, at in swapped.items():
            assert seqs[i] not in prefilled[at:], "a swapped sequence was prefilled again"
        assert eng.block_manager.num_free == 15
        runs.append([s.generated_tokens for s in seqs])
    assert restored and all(restored)
    assert runs[0] == want and runs[1] == want
