"""The slice as a whole: a GGUF file served end to end by the JAX package and
by the port, on the CPU in f32.

A tiny Mistral GGUF (tests/torch_port_model.py write_tiny_gguf: Q4_K,
Q5_K, Q6_K and Q8_0 projections, fused and not, a Q6_K output and a Q8_0
embedding), written by the JAX writer from the JAX quantizers, goes through
the JAX package's load_gguf_model -> TextPipeline -> Engine (off the TPU
every GGUF projection dequantizes and takes one dot) and through the port's
load_gguf_model(device="cpu", dtype=torch.float32) ->
TextPipeline(int8_activations=False) -> Engine (the plain versions of K5,
K9b, K8 and K4). Q6_K stays Q6_K on both sides (the JAX package's CPU
default, rq8_group=None here), or is requantized to int8 per 32 on both
(MISTRALRS_Q6K_RQ8=32, rq8_group=32; K8 then serves it). The two differ
only in f32 rounding (K5 applies the scale on the accumulator, JAX on the
weight), so greedy tokens are equal, and logits are within 1e-5 of the
largest |logit|.

A tiny Mixtral GGUF with packed Q4_K / Q5_K / Q8_0 experts: the activation
route survives `_expert_slice` (no int8 plain version runs), and the
tokens equal JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.engine.engine import Engine as JEngine
from mistralrs_tpu.engine.engine import GenerationRequest as JRequest
from mistralrs_tpu.engine.sampler import SamplingParams as JSampling
from mistralrs_tpu.gguf.reader import GGMLType
from mistralrs_tpu.models import decoder as jd
from mistralrs_tpu.ops import paged_attention as jpa
from mistralrs_tpu.pipeline.gguf import load_gguf_model as jload_gguf_model
from mistralrs_tpu.pipeline.text import PipelineConfig as JPipelineConfig
from mistralrs_tpu.pipeline.text import TextPipeline as JTextPipeline
from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.models import decoder as td
from mistralrs_tpu_torch.ops import paged_attention as tpa
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.pipeline.gguf import load_gguf_model
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
from mistralrs_tpu_torch.quant import gguf_linear as tgl
from mistralrs_tpu_torch.quant.qlinear import Linear
from torch_port_model import PAGE, TINY_GGUF, write_tiny_gguf

EXACT_RTOL = 1e-5
LEN = 512
INT8_PLAIN = ("q4k_q8_gemv_plain", "q8_0_q8_gemv_plain", "q5k_q8_gemv_plain",
              "q6k_q8_gemv_plain")
BF16_PLAIN = ("q4k_bf16_gemv_plain", "q8_0_bf16_gemv_plain", "q5k_hbit_bf16_gemv_plain",
              "q6k_bf16_gemv_plain")
# the Mixtral's experts: Q4_K gate, Q5_K up, Q8_0 down
MOE_MIX = tuple({"attn_q": GGMLType.Q4_K, "attn_k": GGMLType.Q4_K, "attn_v": GGMLType.Q8_0,
                 "attn_output": GGMLType.Q4_K, "ffn_gate": GGMLType.Q4_K,
                 "ffn_up": GGMLType.Q5_K, "ffn_down": GGMLType.Q8_0} for _ in range(2))


@pytest.fixture
def calls(monkeypatch):
    """Calls of each GEMV's plain version."""
    counts = {name: 0 for name in INT8_PLAIN + BF16_PLAIN}

    def counted(name, fn):
        def wrapped(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return wrapped

    for name in counts:
        monkeypatch.setattr(tqm, name, counted(name, getattr(tqm, name)))
    return counts


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    paths = {"mistral": d / "mistral.gguf", "mixtral": d / "mixtral.gguf"}
    write_tiny_gguf(paths["mistral"], seed=7)
    write_tiny_gguf(paths["mixtral"], seed=8, mix=MOE_MIX, experts=4)
    return paths


def _pipelines(path, rq8, monkeypatch):
    """(JAX TextPipeline, port TextPipeline) of one GGUF file."""
    monkeypatch.setenv("MISTRALRS_Q6K_RQ8", str(rq8 or 0))
    kw = dict(page_size=PAGE, num_pages=64, max_seqs=4, max_model_len=LEN,
              prefill_buckets=(64, 128), decode_steps=4)
    jcfg, jparams, jrope, _ = jload_gguf_model(str(path), dtype=jnp.float32)
    jpipe = JTextPipeline(jcfg, jparams, jrope, JPipelineConfig(**kw, dtype=jnp.float32))
    cfg, params, rope, tok = load_gguf_model(str(path), dtype=torch.float32, device="cpu")
    assert tok is None
    tpipe = TextPipeline(cfg, params, rope, PipelineConfig(
        **kw, dtype=torch.float32, device="cpu", rq8_group=rq8, int8_activations=False))
    return jpipe, tpipe


def _serve(jpipe, tpipe, prompts, max_len=8):
    runs = []
    for pipe, eng_cls, req, sp in ((jpipe, JEngine, JRequest, JSampling),
                                   (tpipe, Engine, GenerationRequest, SamplingParams)):
        eng = eng_cls(pipe, eos_token_ids=set(), prefix_cache=False)
        groups = [eng.add_request(req(list(p), sp(max_len=max_len))) for p in prompts]
        while not all(g.all_done() for g in groups):
            eng.step()
        runs.append([g.seqs[0] for g in groups])
    for js, ts in zip(*runs):
        assert len(ts.generated_tokens) == max_len
        assert ts.generated_tokens == js.generated_tokens
        jv = np.array([lp.logprob for lp in js.logprobs])
        tv = np.array([lp.logprob for lp in ts.logprobs])
        assert np.abs(tv - jv).max() <= EXACT_RTOL * max(1.0, np.abs(jv).max())


def _prompts(seed=2):
    rng = np.random.default_rng(seed)
    # 150 tokens: a 128-token first chunk then 22; 40 and 100 ride along
    return [[int(t) for t in rng.integers(1, TINY_GGUF["vocab"], n)] for n in (150, 40, 100)]


def _linears(params):
    for lp in params.layers:
        for part in ("attn", "mlp"):
            for node in lp[part].values():
                if isinstance(node, Linear):
                    yield node
                elif isinstance(node, dict):
                    yield from node.values()
    yield params.lm_head


@pytest.mark.parametrize("rq8", [None, 32])
def test_engine_greedy_tokens_match_jax(files, rq8, monkeypatch, calls):
    jpipe, tpipe = _pipelines(files["mistral"], rq8, monkeypatch)
    kinds = {lin.kind for lin in _linears(tpipe.params)}
    assert kinds == ({"gguf_q4k", "gguf_q5k", "gguf_q8_0"} | ({"gguf_q6k"} if rq8 is None
                                                              else set()))
    assert all(not lin.int8_act for lin in _linears(tpipe.params))
    _serve(jpipe, tpipe, _prompts())
    assert not any(calls[n] for n in INT8_PLAIN), calls
    want = {"q4k_bf16_gemv_plain", "q8_0_bf16_gemv_plain", "q5k_hbit_bf16_gemv_plain"}
    if rq8 is None:
        want.add("q6k_bf16_gemv_plain")
    assert {n for n in BF16_PLAIN if calls[n]} == want


def _forward_steps(jpipe, tpipe, steps):
    """Logits of both pipelines' params for (start, real tokens, padded
    width) steps over one sequence on pages 1..20 (token-major); decode
    steps feed the JAX argmax."""
    jcfg, tcfg = jpipe.cfg, tpipe.cfg
    L, H, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    jc = jpa.PagedKVCache.create(L, 21, PAGE, H, D, jnp.float32)
    tc = tpa.PagedKVCache.create(L, 21, PAGE, H, D, torch.float32, device="cpu")
    table = np.arange(1, 21, dtype=np.int64)[None]
    prompt = np.random.default_rng(1).integers(1, jcfg.vocab_size, 300)
    out = []
    for start, n, T in steps:
        ids = np.zeros((1, T), np.int64)
        pos = np.zeros((1, T), np.int64)
        p = np.arange(start, start + n)
        ids[0, :n] = prompt[start:start + n] if T > 1 else [int(out[-1][0].argmax())]
        pos[0, :n] = p
        slots = np.zeros((1, T), np.int64)
        slots[0, :n] = table[0][p // PAGE] * PAGE + p % PAGE
        kw = dict(positions=pos, slot_mapping=slots, block_tables=table,
                  kv_lens=np.array([start + T], np.int64), active=np.ones(1, np.float32))
        jm = jpa.PagedAttnMeta(**{k: jnp.asarray(v) for k, v in kw.items()},
                               first_chunk=start == 0)
        tm = tpa.PagedAttnMeta(**{k: torch.from_numpy(v) for k, v in kw.items()},
                               first_chunk=start == 0)
        h, jc = jd.decoder_forward(jpipe.params, jcfg, jpipe.rope, jnp.asarray(ids, jnp.int32),
                                   jc, jm)
        jl = np.asarray(jd.compute_logits(jpipe.params, jcfg, h[:, n - 1]))[0]
        th, _ = td.decoder_forward(tpipe.params, tcfg, tpipe.rope, torch.from_numpy(ids), tc, tm)
        out.append((jl, td.compute_logits(tpipe.params, tcfg, th[:, n - 1])[0].numpy()))
    return out


@pytest.mark.parametrize("rq8", [None, 32])
def test_logits_match_jax(files, rq8, monkeypatch, calls):
    """A 128-token first chunk, a 40-token chunk (64 rows) and two decode
    steps, every projection on a bf16 GEMV (at most 256 rows), through the
    params as each pipeline serves them (fused, and requantized with rq8)."""
    jpipe, tpipe = _pipelines(files["mistral"], rq8, monkeypatch)
    for jl, tl in _forward_steps(jpipe, tpipe, [(0, 128, 128), (128, 40, 64), (168, 1, 1),
                                                (169, 1, 1)]):
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        assert np.abs(tl - jl).max() <= EXACT_RTOL * np.abs(jl).max()
    assert not any(calls[n] for n in INT8_PLAIN), calls


def test_int8_route_differs_from_the_bf16_route(files, monkeypatch):
    """The same file with int8_activations on (the default) takes the int8
    GEMVs, whose activation rounding moves the logits by far more than the
    bf16 route's f32 rounding."""
    _, tpipe = _pipelines(files["mistral"], None, monkeypatch)
    cfg, params, rope, _ = load_gguf_model(str(files["mistral"]), dtype=torch.float32,
                                           device="cpu")
    int8 = TextPipeline(cfg, params, rope, dataclasses.replace(tpipe.pc, int8_activations=True))
    assert all(lin.int8_act for lin in _linears(int8.params))
    # the caller's params keep their default: the pipeline set the route on copies
    assert all(lin.int8_act for lin in _linears(params))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 512)).astype(np.float32))
    lin8 = int8.params.layers[0]["attn"]["qk"]
    lin16 = tpipe.params.layers[0]["attn"]["qk"]
    w = tgl.dequant_q4k_weights(lin16, torch.float32)
    exact = x @ w.T
    err8 = float((tqm.q4k_matmul(lin8, x) - exact).abs().max())
    err16 = float((tqm.q4k_matmul(lin16, x) - exact).abs().max())
    assert err16 <= EXACT_RTOL * float(exact.abs().max()) < err8


def test_mixtral_experts_keep_the_bf16_route(files, monkeypatch, calls):
    """Packed experts are sliced from their [E, ...] stacks every forward
    (models/decoder._expert_slice): the slice keeps int8_act off."""
    jpipe, tpipe = _pipelines(files["mixtral"], 32, monkeypatch)
    ex = tpipe.params.layers[0]["mlp"]["experts"]
    assert [ex[k].kind for k in ("gate", "up", "down")] == ["gguf_q4k", "gguf_q5k", "gguf_q8_0"]
    assert not td._expert_slice(ex["gate"], 1).int8_act
    _serve(jpipe, tpipe, _prompts(seed=4))
    assert not any(calls[n] for n in INT8_PLAIN), calls
    assert calls["q4k_bf16_gemv_plain"] and calls["q5k_hbit_bf16_gemv_plain"]
    assert calls["q8_0_bf16_gemv_plain"]
