"""Speculative decoding in the port (mistralrs_tpu_torch/pipeline/speculative.py
and TextPipeline.run_span) against the JAX package, and its engines against
the port's plain greedy engine, on the tiny Q4_K_M-mix model of
tests/torch_port_model.py (3 layers) with 1-layer drafts.

The tiny model's "bigram" lm_head decides each next token by the last one,
so a draft built the same way agrees with the target everywhere; the
drafts here have the embedding rows of a seeded half of the vocabulary
shuffled (`_imperfect`), so they propose wrongly after those tokens and
the target rejects. Prompt-lookup prompts repeat a segment of the target's
own greedy chain with one token of the first copy changed, so n-gram
proposals are accepted along the segment and rejected at the change and
where the chain leaves the segment.

Tolerances: against JAX, with every port GEMV dequantizing as the JAX CPU
path does (only f32 summation orders differ), logits within 1e-5 of the
row's largest |logit|, token ids, counts and draft_kv_len exactly; the
host n-gram proposal, the device one and the rejection sampler exactly;
the port's speculative engines against its plain greedy engine (f32 on
the CPU): token streams exactly equal.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.engine.block_manager import BlockManager as JBlockManager
from mistralrs_tpu.engine.sampler import SamplingParams as JSampling
from mistralrs_tpu.engine.sequence import Sequence as JSequence
from mistralrs_tpu.models.loader import make_rope as jmake_rope
from mistralrs_tpu.pipeline.speculative import PromptLookupPipeline as JPromptLookup
from mistralrs_tpu.pipeline.speculative import SpeculativePipeline as JSpeculative
from mistralrs_tpu.pipeline.text import PipelineConfig as JPipelineConfig
from mistralrs_tpu.pipeline.text import TextPipeline as JTextPipeline
from mistralrs_tpu_torch.engine.block_manager import BlockManager
from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.engine.sequence import Sequence
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.pipeline import speculative as spec
from mistralrs_tpu_torch.pipeline.speculative import PromptLookupPipeline, SpeculativePipeline
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
from torch_port_model import (  # noqa: F401 (one_thread is a fixture)
    PAGE, jax_q4km_params, one_thread, port_config, port_params)

LOGIT_RTOL = 1e-5
PIPE = dict(page_size=PAGE, num_pages=48, max_seqs=2, max_model_len=512,
            prefill_buckets=(16, 64), decode_steps=4)
# a window model: every layer windowed at 32 tokens (two pages)
WINDOW = dict(sliding_window=32, sliding_window_pattern="all")


@pytest.fixture(autouse=True)
def _setup(one_thread, monkeypatch):
    """Tiny ops on one torch thread (torch_port_model.one_thread); every
    port GEMV dequantizes, as the JAX CPU path does."""
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)


def _imperfect(jcfg, jraw, seed: int):
    """The JAX params with the embedding rows of a seeded half of the
    vocabulary shuffled among themselves."""
    rng = np.random.default_rng(seed)
    V = jcfg.vocab_size
    rows = rng.permutation(V)[: V // 2]
    perm = np.arange(V)
    perm[rows] = rng.permutation(rows)
    return dataclasses.replace(jraw, embed=jraw.embed[jnp.asarray(perm)])


class Model:
    """A target and its 1-layer imperfect draft, in both packages."""

    def __init__(self, seed: int, **over):
        self.jcfg, self.jraw = jax_q4km_params(seed=seed, **over)
        dcfg, draw = jax_q4km_params(seed=seed + 1, num_layers=1, **over)
        self.jdcfg, self.jdraw = dcfg, _imperfect(dcfg, draw, seed + 2)
        self.cfg, self.dcfg = port_config(self.jcfg), port_config(self.jdcfg)
        self.params, self.dparams = port_params(self.jraw), port_params(self.jdraw)
        self.rope = make_rope(self.cfg, 512, device="cpu")
        self.plain: dict = {}

    def pipe(self, draft: bool = False, perfect: bool = False) -> TextPipeline:
        """A port pipeline of the target (or the draft, or a second copy of
        the target as a perfect draft) with its own KV pool."""
        pc = PipelineConfig(**PIPE, dtype=torch.float32, device="cpu")
        if draft and not perfect:
            return TextPipeline(self.dcfg, self.dparams, self.rope, pc)
        return TextPipeline(self.cfg, self.params, self.rope, pc)

    def spec_engine(self, kind: str, gamma: int, rounds: int, perfect: bool = False,
                    eos=frozenset()) -> Engine:
        if kind == "draft":
            pipe = SpeculativePipeline(self.pipe(), self.pipe(True, perfect), gamma=gamma,
                                       spec_rounds=rounds)
        else:
            pipe = PromptLookupPipeline(self.pipe(), gamma=gamma, spec_rounds=rounds)
        return Engine(pipe, eos_token_ids=set(eos), prefix_cache=False)

    def greedy(self, prompt: list[int], max_len: int) -> list[int]:
        """The port's plain greedy engine on the prompt (cached)."""
        key = (tuple(prompt), max_len)
        if key not in self.plain:
            eng = Engine(self.pipe(), eos_token_ids=set(), prefix_cache=False)
            self.plain[key] = eng.generate(list(prompt), SamplingParams(max_len=max_len))[0]
        return self.plain[key]

    def chain_prompt(self, start: int, seg: int = 10, head: int = 6) -> list[int]:
        """A segment of the target's greedy chain from token `start` with
        its token head + 1 changed, then its first `head` tokens again."""
        chain = [start] + self.greedy([start], seg - 1)
        first = list(chain)
        first[head + 1] = (chain[head + 1] + 1) % self.cfg.vocab_size
        return first + chain[:head]


@pytest.fixture(scope="module")
def model():
    return Model(0)


@pytest.fixture(scope="module")
def window_model():
    return Model(4, **WINDOW)


def _prompts(model, kind: str, n: int = 2) -> list[list[int]]:
    """n prompts: random tokens for the model draft, repeated chain
    segments for prompt lookup."""
    rng = np.random.default_rng(5)
    if kind == "pld":
        return [model.chain_prompt(int(t)) for t in rng.integers(1, model.cfg.vocab_size, n)]
    return [[int(t) for t in rng.integers(1, model.cfg.vocab_size, m)] for m in (11, 23)[:n]]


def _serve(eng: Engine, prompts, max_len: int):
    groups = [eng.add_request(GenerationRequest(list(p), SamplingParams(max_len=max_len)))
              for p in prompts]
    while not all(g.all_done() for g in groups):
        eng.step()
    return [g.seqs[0] for g in groups]


MODES = {"host": 1, "device": 3}  # spec_rounds: 1 = the host step only


def _counts():
    return spec.spec_host_steps, spec.spec_eager_loops


def _check_mode(mode: str, before, eng: Engine) -> None:
    """The engine took the path of `mode`: host steps only, or device loops
    only (eager on the CPU)."""
    host, loops = (a - b for a, b in zip(_counts(), before))
    assert (host > 0 and loops == 0) if mode == "host" else (loops > 0 and host == 0), \
        (mode, host, loops)
    assert eng.spec_rounds == MODES[mode]


# ---------------------------------------------------------------- the engines


@pytest.mark.parametrize("gamma", [1, 2, 4])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["draft", "pld"])
def test_greedy_speculative_matches_plain(model, kind, mode, gamma):
    """Two concurrent greedy requests: each stream equals the plain greedy
    engine's, some proposals are accepted and some rejected."""
    prompts = _prompts(model, kind)
    before = _counts()
    eng = model.spec_engine(kind, gamma, MODES[mode])
    seqs = _serve(eng, prompts, 16)
    for seq, p in zip(seqs, prompts):
        assert seq.generated_tokens == model.greedy(p, 16)
    _check_mode(mode, before, eng)
    proposed = sum(s.spec_proposed for s in seqs)
    accepted = sum(s.spec_accepted for s in seqs)
    assert 0 < accepted < proposed, (accepted, proposed)


@pytest.mark.parametrize("mode", list(MODES))
def test_perfect_draft_accepts_everything(model, mode):
    """The target's own weights as the draft: every proposal is accepted,
    the stream equals plain greedy decoding, and draft_kv_len stays behind
    the tokens."""
    prompt = _prompts(model, "draft", 1)[0]
    before = _counts()
    eng = model.spec_engine("draft", 3, MODES[mode], perfect=True)
    (seq,) = _serve(eng, [prompt], 20)
    assert seq.generated_tokens == model.greedy(prompt, 20)
    assert seq.spec_proposed > 0 and seq.spec_accepted == seq.spec_proposed
    assert seq.draft_kv_len <= len(seq.tokens) - 1
    _check_mode(mode, before, eng)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["draft", "pld"])
def test_max_len_and_eos_inside_a_span(model, kind, mode):
    """Stop conditions cut a round short: exactly max_len tokens, and an
    EOS inside an accepted span ends the stream exactly there."""
    prompt = _prompts(model, kind, 1)[0]
    ref = model.greedy(prompt, 12)
    got, _ = model.spec_engine(kind, 4, MODES[mode]).generate(prompt, SamplingParams(max_len=7))
    assert got == ref[:7]
    eos = ref[4]
    eng = model.spec_engine(kind, 4, MODES[mode], eos={eos})
    got, _ = eng.generate(prompt, SamplingParams(max_len=12))
    assert got == ref[: ref.index(eos) + 1]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["draft", "pld"])
def test_window_model_past_its_boundary(window_model, kind, mode):
    """A model windowed at 32 tokens generating well past the window: the
    window-relative tables, kv_lens and positions keep greedy identity."""
    prompt = _prompts(window_model, kind, 1)[0]
    eng = window_model.spec_engine(kind, 3, MODES[mode])
    (seq,) = _serve(eng, [prompt], 40)
    assert seq.generated_tokens == window_model.greedy(prompt, 40)
    assert eng.pipeline.target._window_base_pages(seq.kv_len) > 0


@pytest.mark.parametrize("kind", ["draft", "pld"])
def test_device_loop_across_width_buckets(model, kind):
    """The block-table width grows from 4 to 8 pages mid-request: the loop
    runs at two keys (two buffer sets) and keeps greedy identity."""
    prompt = _prompts(model, kind, 1)[0]
    eng = model.spec_engine(kind, 4, 3)
    (seq,) = _serve(eng, [prompt], 56)
    assert seq.generated_tokens == model.greedy(prompt, 56)
    assert sorted(w for _, w in eng.pipeline._bufs) == [4, 8]


@pytest.mark.parametrize("kind", ["draft", "pld"])
def test_sampled_speculative_takes_the_host_step(model, kind):
    """A sampled request (temperature 0.8, top-p 0.95) takes the host step
    with rejection sampling even where the device loop is on: max_len
    valid tokens, the same tokens again at the same request seed."""
    prompt = _prompts(model, kind, 1)[0]
    sp = SamplingParams(max_len=12, temperature=0.8, top_p=0.95, seed=424)
    before = _counts()
    outs = [model.spec_engine(kind, 3, 3).generate(list(prompt), sp)[0] for _ in range(2)]
    assert len(outs[0]) == 12 and all(0 <= t < model.cfg.vocab_size for t in outs[0])
    assert outs[0] == outs[1]
    _check_mode("host", before, Engine(PromptLookupPipeline(model.pipe(), spec_rounds=1)))


def test_pipelines_refuse_other_page_geometry(model):
    other = TextPipeline(model.dcfg, model.dparams, model.rope,
                         PipelineConfig(**{**PIPE, "num_pages": 32}, dtype=torch.float32,
                                        device="cpu"))
    with pytest.raises(ValueError, match="page"):
        SpeculativePipeline(model.pipe(), other)


# ---------------------------------------------------------- against JAX


@pytest.fixture(scope="module")
def jax_pipes(model):
    """The JAX target and draft pipelines (jitted steps compile once), Q6_K
    requantized to int8 per 32 as the port does."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MISTRALRS_Q6K_RQ8", "32")
        pc = JPipelineConfig(**PIPE, dtype=jnp.float32)
        return (JTextPipeline(model.jcfg, model.jraw, jmake_rope(model.jcfg, 512), pc),
                JTextPipeline(model.jdcfg, model.jdraw, jmake_rope(model.jdcfg, 512), pc))


def _prefilled(Seq, SP, BM, run_prefill, prompts, nxt=None, reserve=16):
    """Sequences of `prompts` prefilled one by one through run_prefill(seq,
    chunk) (the greedy pack back), each with one more token (nxt, or its
    prefill argmax) and KV slots for `reserve` more."""
    bm = BM(PIPE["num_pages"], PAGE)
    seqs, toks = [], []
    for i, p in enumerate(prompts):
        seq = Seq(list(p), SP(max_len=64), max_model_len=512)
        bm.allocate(seq)
        pack = run_prefill(seq, list(p))
        tok = nxt[i] if nxt else int(pack[0])
        seq.tokens.append(tok)
        bm.append_slot(seq, reserve)
        seqs.append(seq)
        toks.append(tok)
    return seqs, toks


def _close(got, want):
    tol = LOGIT_RTOL * np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def test_run_span_verify_matches_jax(model, jax_pipes):
    """run_span over two rows of different starts at width 5: the logits at
    every fed position and the greedy pack (all_positions), and each row's
    last-position pack (the draft's form), against JAX's."""
    jt, _ = jax_pipes
    prompts = _prompts(model, "draft")
    jseqs, nxt = _prefilled(JSequence, JSampling, JBlockManager,
                            lambda s, c: jt.run_prefill_chunk(s, c, greedy=True), prompts)
    tp = model.pipe()
    tseqs, _ = _prefilled(Sequence, SamplingParams, BlockManager,
                          lambda s, c: tp.run_prefill_chunk(s, c, greedy=True), prompts, nxt)
    rng = np.random.default_rng(3)
    spans = [[s.tokens[-1]] + [int(t) for t in rng.integers(1, model.cfg.vocab_size, m)]
             for s, m in zip(jseqs, (4, 2))]

    def rows(pipe, seqs):
        return [(sp, s.kv_len, pipe._tables_row(s)) for sp, s in zip(spans, seqs)]

    want = jt.run_span(rows(jt, jseqs), 5, all_positions=True)
    got = model_pipe_run = tp.run_span(rows(tp, tseqs), 5, all_positions=True)
    assert got.shape == (2, 5, model.cfg.vocab_size)
    for i, sp in enumerate(spans):
        _close(model_pipe_run[i, : len(sp)], want[i, : len(sp)])
    wpack = jt.run_span(rows(jt, jseqs), 5, all_positions=True, greedy=True)
    gpack = tp.run_span(rows(tp, tseqs), 5, all_positions=True, greedy=True)
    for i, sp in enumerate(spans):
        np.testing.assert_array_equal(gpack[0, i, : len(sp)], wpack[0, i, : len(sp)])
        _close(gpack[1, i, : len(sp)], wpack[1, i, : len(sp)])
    np.testing.assert_array_equal(tp.run_span(rows(tp, tseqs), 5, greedy=True)[0],
                                  jt.run_span(rows(jt, jseqs), 5, greedy=True)[0])
    assert [s.kv_len for s in tseqs] == [s.kv_len for s in jseqs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_propose_matches_jax(seed):
    """_propose of both packages on random histories over a 4-token
    alphabet (many matches), every length and gi, and on no-match ones."""
    rng = np.random.default_rng(seed)
    got, want = object.__new__(PromptLookupPipeline), object.__new__(JPromptLookup)
    for p in (got, want):
        p.ngram_max, p.ngram_min = 3, 1
    for L in (1, 2, 3, 5, 9, 17, 40):
        toks = [int(t) for t in rng.integers(0, 4, L)]
        for gi in (1, 3, 4):
            assert got._propose(toks, gi) == want._propose(toks, gi)
    assert got._propose([1, 2, 3], 2) == want._propose([1, 2, 3], 2) == []


def _jax_device_propose(jt, C: int, gamma: int):
    """The `propose` closure of the JAX prompt-lookup loop (a history of C
    tokens, n-grams of 1-3)."""
    p = object.__new__(JPromptLookup)
    p.target, p.gamma, p.spec_rounds, p.hist_cap = jt, gamma, 2, C
    p.ngram_min, p.ngram_max = 1, 3
    return inspect.getclosurevars(p._build_spec_multi_fn().__wrapped__).nonlocals["propose"]


@pytest.mark.parametrize("seed", [0, 1])
def test_device_propose_matches_jax(jax_pipes, seed):
    """The device propose of both packages on random [8, 64] histories
    over a 3-token alphabet, with lengths 0, 1, 2, short, long and the
    whole history (clipped indices)."""
    C, g = 64, 4
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 3, (8, C))
    hl = np.asarray([0, 1, 2, 5, 17, 40, 63, 64])
    props, nprop = _jax_device_propose(jax_pipes[0], C, g)(jnp.asarray(hist, jnp.int32),
                                                           jnp.asarray(hl, jnp.int32))
    tprops, tnprop = spec.propose(torch.from_numpy(hist), torch.from_numpy(hl), g, 1, 3)
    np.testing.assert_array_equal(tnprop.numpy(), np.asarray(nprop))
    np.testing.assert_array_equal(tprops.numpy(), np.asarray(props))
    assert (tnprop.numpy() > 0).sum() >= 4 and tnprop.numpy()[0] == 0


# (SamplingParams fields, draft distributions: "q" sampled drafts, None
# point masses) of the rejection-sampler cases
REJECT_CASES = {
    "sampled_draft": (dict(temperature=0.8, top_k=20), "q"),
    "point_draft": (dict(temperature=1.2, top_p=0.9), None),
    "greedy_target": (dict(), None),
    "min_p": (dict(temperature=0.9, top_p=0.95, min_p=0.05), "q"),
}


@pytest.mark.parametrize("case", list(REJECT_CASES))
def test_reject_sample_matches_jax(case):
    """_reject_sample of both packages on the same logits, proposals, draft
    distributions and numpy Generator seed: the same emitted tokens and
    logprobs and the same accepted count, over 40 seeds."""
    fields, qkind = REJECT_CASES[case]
    V, g = 64, 4
    rng = np.random.default_rng(9)
    for seed in range(40):
        logits = (rng.standard_normal((g + 1, V)) * 2.0).astype(np.float32)
        qd = [None] * g
        if qkind == "q":
            qd = [np.random.default_rng(seed + j).dirichlet(np.full(V, 0.3)) for j in range(g)]
        props = [int(np.argmax(logits[j])) if seed % 3 == 0 else int(rng.integers(V))
                 for j in range(g)]
        ctx = [int(t) for t in rng.integers(V, size=6)]
        jseq = JSequence(list(ctx), JSampling(max_len=64, **fields))
        tseq = Sequence(list(ctx), SamplingParams(max_len=64, **fields))
        want = JSpeculative._reject_sample(None, jseq, logits, props, qd, g,
                                           np.random.default_rng(seed))
        got = SpeculativePipeline._reject_sample(None, tseq, logits, props, qd, g,
                                                 np.random.default_rng(seed))
        assert got[1] == want[1]
        assert [(lp.token, lp.logprob) for lp in got[0]] == \
            [(lp.token, lp.logprob) for lp in want[0]]


@pytest.mark.parametrize("kind", ["draft", "pld"])
def test_spec_multi_pack_matches_jax(model, jax_pipes, kind):
    """run_spec_multi_eager of the port against JAX's run_spec_multi (3
    rounds at gamma 3) on two prefilled sequences, the second with the
    draft two tokens behind: token ids, counts, the proposed / gamma
    column and draft_kv_len exactly, logits within 1e-5."""
    jt, jd = jax_pipes
    R, g = 3, 3
    prompts = _prompts(model, kind)
    if kind == "draft":
        jspec = JSpeculative(jt, jd, gamma=g, spec_rounds=R)
        tspec = SpeculativePipeline(model.pipe(), model.pipe(True), gamma=g, spec_rounds=R)
    else:
        jspec = JPromptLookup(jt, gamma=g, spec_rounds=R, hist_cap=64)
        tspec = PromptLookupPipeline(model.pipe(), gamma=g, spec_rounds=R, hist_cap=64)
    jseqs, nxt = _prefilled(JSequence, JSampling, JBlockManager,
                            lambda s, c: jspec.run_prefill_chunk(s, c, greedy=True), prompts,
                            reserve=R * (g + 1))
    tseqs, _ = _prefilled(Sequence, SamplingParams, BlockManager,
                          lambda s, c: tspec.run_prefill_chunk(s, c, greedy=True), prompts, nxt,
                          reserve=R * (g + 1))
    for s in (jseqs[1], tseqs[1]):
        s.draft_kv_len = len(s.tokens) - 2
    want = jspec.run_spec_multi(jseqs)
    loops = spec.spec_eager_loops
    got = tspec.run_spec_multi_eager(tseqs)
    assert spec.spec_eager_loops == loops + 1
    W = g + 1
    assert got.shape == want.shape == (R, 2, 2 * W + (3 if kind == "draft" else 2))
    np.testing.assert_array_equal(got[:, :, :W], want[:, :, :W])
    np.testing.assert_array_equal(got[:, :, 2 * W :], want[:, :, 2 * W :])
    _close(got[:, :, W : 2 * W], want[:, :, W : 2 * W])
    counts = got[:, :, 2 * W]
    assert counts.min() >= 1 and counts.max() <= W and (counts < W).any()
