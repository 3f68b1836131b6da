"""The port's device decode loop against the JAX package on the tiny
Q4_K_M-mix model of tests/torch_port_model.py: the top-K sampling pack of
one decode step, the sampled branch's truncation against the host Sampler,
the draw's frequencies, and the sampled multistep loop.

Tolerances:
- the top-K pack (port GEMVs dequantizing, as the JAX CPU path does, so
  only f32 summation orders differ): ids equal, values and the max within
  1e-5 of the step's largest |tempered logit|, the normalizer z within 1e-5
  relative; the top 65 tempered logits of every row are checked to be
  further apart than twice the largest difference measured, so no near-tie
  can reorder the ids;
- kept probabilities against the host Sampler's (numpy f32 on the same
  logits): the same kept set, probabilities within 1e-6;
- the draw: a chi-square test of 16,384 draws at a fixed seed, p > 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import chip_smoke
from mistralrs_tpu.engine.block_manager import BlockManager as JBlockManager
from mistralrs_tpu.engine.sampler import SamplingParams as JSampling
from mistralrs_tpu.engine.sequence import Sequence as JSequence
from mistralrs_tpu.models.loader import make_rope as jmake_rope
from mistralrs_tpu.pipeline.text import PipelineConfig as JPipelineConfig
from mistralrs_tpu.pipeline.text import TextPipeline as JTextPipeline
from mistralrs_tpu_torch.engine.block_manager import BlockManager
from mistralrs_tpu_torch.engine.sampler import Sampler, SamplingParams
from mistralrs_tpu_torch.engine.sequence import Sequence
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.pipeline import text
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
from torch_port_model import (  # noqa: F401 (one_thread is a fixture)
    PAGE, jax_q4km_params, one_thread, port_config, port_params)

K = text.TOPK_PACK
PACK_RTOL = 1e-5
PIPE = dict(page_size=PAGE, num_pages=32, max_seqs=4, max_model_len=512, prefill_buckets=(64,),
            decode_steps=4)


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """Every test here runs many tiny ops (torch_port_model.one_thread)."""


@pytest.fixture(scope="module")
def model():
    jcfg, jraw = jax_q4km_params(seed=0)
    return jcfg, jraw, port_config(jcfg)


@pytest.fixture(scope="module")
def jax_pipe(model):
    """One JAX pipeline for the file (its jitted steps compile once): Q6_K
    requantized to int8 per 32 as the port does, one token a decode call
    (the greedy tokens do not depend on it)."""
    jcfg, jraw, _ = model
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MISTRALRS_Q6K_RQ8", "32")
        return JTextPipeline(jcfg, jraw, jmake_rope(jcfg, 512),
                             JPipelineConfig(**{**PIPE, "decode_steps": 1}, dtype=jnp.float32))


@pytest.fixture
def exact(monkeypatch):
    """Every port GEMV dequantizes (as the JAX CPU path does): only f32
    summation orders differ, and the CPU runs it fastest."""
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)


def _port_pipe(model, **over):
    _, jraw, tcfg = model
    pc = PipelineConfig(**{**PIPE, **over}, dtype=torch.float32, device="cpu")
    return TextPipeline(tcfg, port_params(jraw), make_rope(tcfg, 512, device="cpu"), pc)


def _prefilled(pipe, Seq, SP, BM, prompts, temps, next_tokens=None,
               reserve=PIPE["decode_steps"]):
    """Sequences of `prompts` (<= 64 tokens) at `temps`, prefilled in one
    batch, each with one more token (next_tokens, or its prefill argmax)
    and KV slots for `reserve` more tokens."""
    bm = BM(PIPE["num_pages"], PAGE)
    seqs = [Seq(list(p), SP(max_len=16, temperature=t), max_model_len=512)
            for p, t in zip(prompts, temps)]
    for seq in seqs:
        bm.allocate(seq)
    pipe.run_prefill_chunks([(seq, list(seq.tokens)) for seq in seqs])
    nxt = next_tokens or [int(t) for t in np.asarray(pipe.last_greedy_pack)[0, :len(seqs)]]
    for seq, tok in zip(seqs, nxt):
        seq.tokens.append(tok)
        bm.append_slot(seq, reserve)
    return seqs, nxt


def _prompts(vocab, lens=(40, 23, 57)):
    rng = np.random.default_rng(7)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lens]


def test_topk_decode_pack_matches_jax(model, jax_pipe, exact):
    """run_decode(mode="topk") of both packages on the same prefilled
    sequences, one at the default temperature (None -> 1)."""
    jcfg = model[0]
    temps = (0.7, None, 1.3)
    prompts = _prompts(jcfg.vocab_size)
    jpipe = jax_pipe
    jseqs, nxt = _prefilled(jpipe, JSequence, JSampling, JBlockManager, prompts, temps)
    jtv, jti, jm, jz = jpipe.run_decode(jseqs, mode="topk")
    tpipe = _port_pipe(model)
    tseqs, _ = _prefilled(tpipe, Sequence, SamplingParams, BlockManager, prompts, temps, nxt)
    ttv, tti, tm, tz = tpipe.run_decode(tseqs, mode="topk")
    assert ttv.shape == (3, K) and tti.dtype == np.int32 and [s.kv_len for s in tseqs] == \
        [s.kv_len for s in jseqs]
    t = np.asarray([x or 1.0 for x in temps], np.float32)[:, None]
    y = -np.sort(-np.asarray(jpipe.last_logits)[:3] / t, axis=1)[:, :K + 1]
    tol = PACK_RTOL * np.abs(y).max(axis=1, keepdims=True)
    assert (np.abs(ttv - jtv) <= tol).all()
    # no near-tie among any row's top 65 tempered logits: the values, not
    # the two packages' rounding, decide the ids' order
    assert (y[:, :-1] - y[:, 1:] > 2 * np.abs(ttv - jtv).max()).all()
    np.testing.assert_array_equal(tti, jti)
    assert (np.abs(tm - jm) <= tol[:, 0]).all()
    assert (np.abs(tz / jz - 1) <= PACK_RTOL).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_pack_puts_the_lower_index_first_on_a_tie(seed):
    """Crafted ties (values on a coarse grid, so many logits are equal):
    the pack's ids and values against jax.lax.top_k, which the JAX step
    fn runs, on the same tempered logits."""
    rng = np.random.default_rng(seed)
    logits = rng.integers(0, 12, (3, 500)).astype(np.float32) * 0.5
    logits[1, 100:400] = 9.0  # a tie that straddles the 64th place
    temps = np.asarray([1.0, 0.5, 2.0], np.float32)
    got = text.topk_pack(torch.from_numpy(logits), torch.from_numpy(temps)).numpy()
    y = jnp.asarray(logits) / jnp.asarray(temps)[:, None]
    tv, ti = jax.lax.top_k(y, K)
    np.testing.assert_array_equal(got[:, K:2 * K], np.asarray(ti))
    np.testing.assert_array_equal(got[:, :K], np.asarray(tv))
    assert (np.diff(got[:, K:2 * K], axis=1)[np.diff(got[:, :K], axis=1) == 0] > 0).all()
    np.testing.assert_allclose(got[:, 2 * K], np.asarray(jnp.max(y, axis=-1)))
    np.testing.assert_allclose(got[:, 2 * K + 1],
                               np.asarray(jnp.sum(jnp.exp(y - y.max(-1, keepdims=True)), -1)),
                               rtol=1e-6)


# (temperature, top_k, top_p, min_p) of each row: top-k alone, top-p, min-p
# inside top-p, and greedy rows as the loop carries them (1, 1)
SAMPLE_CASES = {
    "top_k": [(0.8, 40, 1.0, 0.0), (1.5, 5, 1.0, 0.0), (1.0, 64, 1.0, 0.0)],
    "top_p": [(0.9, 50, 0.6, 0.0), (1.3, 64, 0.3, 0.0), (0.7, 20, 0.9, 0.0)],
    "min_p": [(0.9, 50, 0.95, 0.05), (1.3, 64, 0.8, 0.2), (1.0, 30, 0.999, 0.5)],
    "greedy": [(1.0, 1, 1.0, 0.0), (1.0, 1, 1.0, 0.0), (1.0, 1, 1.0, 0.0)],
}


def _logits(n, V=2000, seed=3):
    return (np.random.default_rng(seed).standard_normal((n, V)) * 3.0).astype(np.float32)


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_keep_matches_the_host_sampler(case):
    """The kept set and kept/total of sample_keep against Sampler.probs
    (the reference pipeline of engine/sampler.py) on the same logits."""
    rows = SAMPLE_CASES[case]
    logits = _logits(len(rows))
    temps, top_ks, top_ps, min_ps = (torch.tensor(c) for c in zip(*rows))
    ti, kept, keep = text.sample_keep(torch.from_numpy(logits), temps.float(), top_ks,
                                      top_ps.float(), min_ps.float())
    for i, (t, k, p, mp) in enumerate(rows):
        want = Sampler(SamplingParams(temperature=t, top_k=k, top_p=p, min_p=mp)).probs(
            logits[i], [])
        got = np.zeros_like(want)
        got[ti[i].numpy()] = (kept[i] / kept[i].sum()).numpy()
        assert set(np.flatnonzero(want)) == set(ti[i][keep[i]].tolist())
        assert np.abs(got - want).max() <= 1e-6
    if case == "greedy":
        assert (ti[:, 0].numpy() == logits.argmax(axis=1)).all() and int(keep.sum()) == 3


def test_draw_frequencies_match_the_kept_probabilities():
    """16,384 draws of one row (4,096 rows a step, 4 steps of the counter
    hash at seed 11): each candidate's count against 16,384 kept/total."""
    B, steps = 4096, 4
    logits = torch.from_numpy(np.repeat(_logits(1, V=300, seed=5) * 0.5, B, axis=0))
    args = (torch.full((B,), 0.9), torch.full((B,), 20), torch.full((B,), 0.9),
            torch.full((B,), 0.02))
    ti, kept, _ = text.sample_keep(logits[:1], *(a[:1] for a in args))
    want = (kept[0] / kept[0].sum()).double().numpy()
    seed = torch.tensor(11)
    toks = torch.cat([text.sample_step(logits, *args, text.decode_uniforms(seed, t, B))[0]
                      for t in range(steps)])
    counts = np.asarray([(toks == tok).sum().item() for tok in ti[0].tolist()])
    assert counts.sum() == B * steps  # nothing drawn outside the candidates
    live = want > 0
    assert (counts[~live] == 0).all() and live.sum() >= 5
    expect = want[live] / want[live].sum() * counts.sum()
    assert scipy.stats.chisquare(counts[live], expect).pvalue > 1e-3


def test_uniforms_depend_on_seed_and_step_only():
    u = text.decode_uniforms(torch.tensor(5), 2, 16)
    assert u.shape == (16, K) and u.dtype == torch.float32
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert torch.equal(u, text.decode_uniforms(torch.tensor([5]), 2, 16))
    assert not torch.equal(u, text.decode_uniforms(torch.tensor(6), 2, 16))
    assert not torch.equal(u, text.decode_uniforms(torch.tensor(5), 3, 16))
    # a negative or wide seed folds to its low 32 bits
    assert torch.equal(text.decode_uniforms(torch.tensor(-1), 0, 2),
                       text.decode_uniforms(torch.tensor(2**32 - 1), 0, 2))


def test_sampled_loop_at_top_k_1_or_low_temperature_gives_jax_greedy_tokens(model, jax_pipe,
                                                                           exact):
    """As tests/test_engine.py checks for JAX: the sampled multistep loop at
    top-k 1 (temperature 1.5), and at temperature 1e-3 with top-k 50,
    generates the JAX pipeline's greedy tokens (its one-token decode steps
    fed back, as its engine runs them)."""
    prompts = _prompts(model[0].vocab_size, (30, 45))
    T, calls = PIPE["decode_steps"], 3
    jseqs, want = _prefilled(jax_pipe, JSequence, JSampling, JBlockManager, prompts, (None,) * 2,
                             reserve=T * calls)
    want = [[t] for t in want]
    for _ in range(T * calls - 1):
        pack = np.asarray(jax_pipe.run_decode(jseqs, greedy=True))
        for seq, w, tok in zip(jseqs, want, pack[0]):
            w.append(int(tok))
            seq.tokens.append(int(tok))
    pipe = _port_pipe(model)
    for temp, k in ((1.5, 1), (1e-3, 50)):
        seqs, got = _prefilled(pipe, Sequence, SamplingParams, BlockManager, prompts, (None,) * 2,
                               [w[0] for w in want], reserve=T * calls)
        got = [[t] for t in got]
        for _ in range(calls):
            pack = pipe.run_decode_multi(seqs, ([temp] * 2, [k] * 2, [1.0] * 2, [0.0] * 2, 5))
            for i, seq in enumerate(seqs):
                seq.tokens += [int(t) for t in pack[0, :, i]]
                got[i] += [int(t) for t in pack[0, :, i]]
        assert [g[:T * calls] for g in got] == want


def _rewound(pipe, seqs, sampling):
    pack = pipe.run_decode_multi(seqs, sampling)
    for seq in seqs:
        seq.kv_len -= pipe.pc.decode_steps
    return pack


def _flat_pipe():
    """chip_smoke's random Q4_K_M model at a tiny size: its next-token
    distributions are flat enough that sampling at temperature 1.5 leaves
    the argmax (the bigram head of torch_port_model decides every token
    with a wide margin)."""
    sz = chip_smoke.Sizes(vocab=1920, hidden=512, inter=1024, heads=4, kv_heads=2, layers=2)
    cfg = chip_smoke.model_config(sz, 2)
    params = chip_smoke.random_q4km_params(sz, 2, torch.device("cpu"),
                                           torch.Generator().manual_seed(0), torch.float32)
    pc = PipelineConfig(**PIPE, dtype=torch.float32, device="cpu")
    return TextPipeline(cfg, params, make_rope(cfg, 512, device="cpu"), pc)


def test_same_seed_same_tokens_and_hot_sampling_leaves_greedy(exact):
    """Calls on the same inputs: the same seed gives the same pack, greedy
    rows ride along as their argmax, and at temperature 1.5, top-k 40 the
    tokens differ from greedy and between seeds."""
    pipe = _flat_pipe()
    seqs, _ = _prefilled(pipe, Sequence, SamplingParams, BlockManager,
                         _prompts(pipe.cfg.vocab_size), (None,) * 3)
    greedy = _rewound(pipe, seqs, None)
    hot = ([1.5] * 3, [40] * 3, [1.0] * 3, [0.0] * 3)
    a = _rewound(pipe, seqs, hot + (7,))
    assert a.shape == greedy.shape == (3, PIPE["decode_steps"], 3)
    np.testing.assert_array_equal(a, _rewound(pipe, seqs, hot + (7,)))
    b = _rewound(pipe, seqs, hot + (8,))
    assert not np.array_equal(a[0], b[0])
    assert not np.array_equal(a[0], greedy[0])
    # the sampled pack: token, raw logit, log10 kept probability (<= 0)
    assert (a[2] <= 0).all() and np.isfinite(a).all()
    # a greedy row (1.0, 1, 1.0, 0.0) in a sampled call: its argmax tokens
    # and logits, wherever the other rows' draws take them
    mixed = _rewound(pipe, seqs, ([1.0, 1.5, 1.5], [1, 40, 40], [1.0] * 3, [0.0] * 3, 7))
    np.testing.assert_array_equal(mixed[:2, :, 0], greedy[:2, :, 0])
    np.testing.assert_array_equal(mixed[:, :, 1:], a[:, :, 1:])


def test_eager_method_runs_the_same_loop(model, exact):
    pipe = _port_pipe(model)
    seqs, _ = _prefilled(pipe, Sequence, SamplingParams, BlockManager,
                         _prompts(model[0].vocab_size, (20, 33)), (None, None))
    before = text.decode_eager_loops
    samp = ([0.8, 1.2], [40, 10], [0.95, 1.0], [0.05, 0.0], 3)
    a = _rewound(pipe, seqs, samp)
    b = pipe.run_decode_multi_eager(seqs, samp)
    np.testing.assert_array_equal(a, b)
    assert [s.kv_len for s in seqs] == [20 + 4, 33 + 4]
    assert text.decode_eager_loops == before + 2  # the CPU has no graphs
    assert pipe.graphs is None
