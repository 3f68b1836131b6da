"""In-situ quantization in the port against the JAX package.

(a) quant/kquants.quantize: the wire bytes of every ISQ type are equal to
    the JAX package's, on rows of normal draws and on the edge rows (zero,
    constant, all negative, tiny, huge).
(b) quant/isq.py: parse_isq, Topology, quantizable (tests/test_isq.py's
    cases).
(c) models/loader.params_from_source on tiny seeded Llama, Gemma-2 and
    Mixtral state dicts (tests/torch_port_model.hf_state_dict) equals the
    JAX package's params_from_source carried across by
    params_from_reference, leaf for leaf and bit for bit: dense, ISQ Q4K,
    Q6K, Q8_0 and HQQ4, a two-range topology, and the shapes where the JAX
    packers fall back to a dense weight.
(d) The ISQ Q4K model served: the port's first-chunk logits within 1e-5 of
    the JAX pipeline's, greedy Engine tokens equal (every projection on
    the dequant route, quant_matmul.MAX_KERNEL_ROWS = -1, as the JAX CPU
    path computes).
(e) TextPipeline.re_isq("Q8_0"): every Linear byte-equal to JAX's re_isq
    of the same model (for Mixtral, whose dense experts JAX's re_isq cannot
    take, to JAX's requantization of each other Linear), and the engine
    serves on with JAX's tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.engine.engine import Engine as JEngine
from mistralrs_tpu.engine.engine import GenerationRequest as JRequest
from mistralrs_tpu.engine.sampler import SamplingParams as JSampling
from mistralrs_tpu.gguf.reader import GGMLType as JGGMLType
from mistralrs_tpu.models.config import config_from_hf as jconfig_from_hf
from mistralrs_tpu.models.loader import TensorSource as JTensorSource
from mistralrs_tpu.models.loader import make_rope as jmake_rope
from mistralrs_tpu.models.loader import params_from_source as jparams_from_source
from mistralrs_tpu.pipeline.text import PipelineConfig as JPipelineConfig
from mistralrs_tpu.pipeline.text import TextPipeline as JTextPipeline
from mistralrs_tpu.quant import kquants as jkq
from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.gguf.reader import GGMLType
from mistralrs_tpu_torch.models.config import config_from_hf
from mistralrs_tpu_torch.models.loader import (TensorSource, make_rope, params_from_reference,
                                                params_from_source)
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline
from mistralrs_tpu_torch.quant import kquants as tkq
from mistralrs_tpu_torch.quant.hqq import HqqType
from mistralrs_tpu_torch.quant.isq import SUPPORTED_ISQ, Topology, parse_isq, quantizable
from torch_port_model import (  # noqa: F401 (one_thread is a fixture)
    assert_params_equal, flat_params, hf_state_dict, one_thread)

LOGIT_RTOL = 1e-5


# ------------------------------------------------------------- (a) quantizers


def _rows(n: int) -> np.ndarray:
    """12 rows of n f32 values: normal draws at three scales, and the edge
    rows: zeros, a constant, a negative constant, all negative, one spike
    among zeros, tiny (f16 scales underflow), huge, alternating signs."""
    rng = np.random.default_rng(7)
    r = [rng.standard_normal(n), 0.02 * rng.standard_normal(n), 50.0 * rng.standard_normal(n),
         np.zeros(n), np.full(n, 0.37), np.full(n, -1.5), -np.abs(rng.standard_normal(n)) - 0.1,
         np.where(np.arange(n) == 5, 3.0, 0.0), 1e-9 * rng.standard_normal(n),
         1e4 * rng.standard_normal(n), np.where(np.arange(n) % 2, 1.0, -1.0),
         rng.uniform(0.0, 1.0, n)]
    return np.stack(r).astype(np.float32)


@pytest.mark.parametrize("gtype", sorted(SUPPORTED_ISQ, key=int), ids=lambda g: g.name)
def test_quantize_is_byte_equal_to_jax(gtype):
    x = _rows(512)
    got = tkq.quantize(x, gtype)
    want = jkq.quantize(x, JGGMLType(int(gtype)))
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # and the port's dequantizer reads them back as the JAX one does
    np.testing.assert_array_equal(tkq.dequantize(got, gtype, x.shape),
                                  jkq.dequantize(want, JGGMLType(int(gtype)), x.shape))


def test_quantize_refuses_a_type_without_a_quantizer():
    with pytest.raises(NotImplementedError, match="Q8_K"):
        tkq.quantize(np.zeros((1, 256), np.float32), GGMLType.Q8_K)


# ------------------------------------------------------------- (b) names, topology


def test_parse_isq():
    assert parse_isq("Q4K") == GGMLType.Q4_K
    assert parse_isq("q8_0") == GGMLType.Q8_0
    assert parse_isq("Q3K") == GGMLType.Q3_K == parse_isq("Q3_K")
    assert parse_isq("hqq4") == HqqType(4)
    with pytest.raises(ValueError, match="unknown ISQ"):
        parse_isq("Q17K")
    with pytest.raises(ValueError, match="no quantizer"):
        parse_isq("Q8K")  # Q8_K is an intermediate format, not an ISQ target
    with pytest.raises(ValueError, match="HQQ bits"):
        parse_isq("HQQ5")


def test_topology_yaml():
    t = Topology.from_yaml_str("0-2:\n  isq: Q4K\n2-4:\n  isq: Q8_0\n", num_layers=4)
    assert t.isq_for_layer(0, None) == GGMLType.Q4_K
    assert t.isq_for_layer(3, None) == GGMLType.Q8_0
    # the default fills unspecified layers; a range without isq stays dense
    t2 = Topology.from_yaml_str("1-2:\n  isq: Q8_0\n3:\n  {}\n")
    assert t2.isq_for_layer(0, GGMLType.Q4_K) == GGMLType.Q4_K
    assert t2.isq_for_layer(1, GGMLType.Q4_K) == GGMLType.Q8_0
    assert t2.isq_for_layer(3, GGMLType.Q4_K) is None
    with pytest.raises(ValueError, match="num_layers"):
        Topology.from_yaml_str("0-5:\n  isq: Q4K\n", num_layers=4)
    with pytest.raises(ValueError, match="inverted"):
        Topology.from_yaml_str("3-1:\n  isq: Q4K\n")


def test_quantizable():
    assert quantizable((64, 256), GGMLType.Q4_K) and not quantizable((64, 288), GGMLType.Q4_K)
    assert quantizable((64, 288), GGMLType.Q8_0) and not quantizable((64, 280), GGMLType.Q8_0)
    assert quantizable((8, 128), HqqType(4)) and not quantizable((8, 96), HqqType(4))
    assert not quantizable((4, 64, 256), GGMLType.Q4_K)


# ------------------------------------------------------------- (c) loaded params


def _both(arch, isq=None, topology=None, **over):
    """(JAX params carried across, the port's params) from one tiny state
    dict, f32 on the CPU."""
    hf, sd = hf_state_dict(arch, **over)
    jtopo = None if topology is None else _jax_topology(topology)
    jp = jparams_from_source(jconfig_from_hf(hf), JTensorSource.from_dict(sd), dtype=jnp.float32,
                             isq=isq, topology=jtopo)
    want = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.float32)
    topo = None if topology is None else Topology.from_yaml_str(topology)
    got = params_from_source(config_from_hf(hf), TensorSource.from_dict(sd), dtype=torch.float32,
                             isq=isq, topology=topo, device="cpu")
    return got, want


def _jax_topology(text):
    from mistralrs_tpu.quant.isq import Topology as JTopology

    return JTopology.from_yaml_str(text)


def _kinds(p) -> set[str]:
    return {v for k, v in flat_params(p).items() if k.endswith(":kind")}


@pytest.mark.parametrize("isq", [None, "Q4K", "Q6K", "Q8_0", "HQQ4"])
@pytest.mark.parametrize("arch", ["llama", "gemma2", "mixtral"])
def test_params_from_source_equals_jax(arch, isq):
    got, want = _both(arch, isq)
    assert_params_equal(got, want)
    kinds = _kinds(got)
    if isq is None:
        assert kinds == {"dense"}
    else:
        assert kinds - {"dense"}, kinds  # something was packed
        # ISQ leaves only Mixtral's expert stacks dense
        assert ("dense" in kinds) == (arch == "mixtral"), kinds


@pytest.mark.parametrize("arch", ["llama", "gemma2", "mixtral"])
def test_two_range_topology_equals_jax(arch):
    got, want = _both(arch, "Q8_0", "0:\n  isq: Q4K\n1:\n  isq: Q6K\n")
    assert_params_equal(got, want)
    assert got.layers[0]["attn"]["q"].kind == "gguf_q4k"
    assert got.layers[1]["attn"]["q"].kind == "gguf_q6k"
    if got.lm_head is not None:  # the lm_head takes isq, not the topology
        assert got.lm_head.kind == "gguf_q8_0"


@pytest.mark.parametrize("isq", ["Q4_0", "Q5_0", "Q4K"])
def test_dense_fallback_shapes_equal_jax(isq):
    """An intermediate of 288: ffn_down's in is a multiple of 32 but not of
    64 (Q4_0's packer) or 256 (Q5_0's packer, Q4_K's blocks): JAX keeps it
    dense, and so does the port; the other projections pack."""
    got, want = _both("llama", isq, intermediate_size=288)
    assert_params_equal(got, want)
    for lp in got.layers:
        assert lp["mlp"]["down"].kind == "dense"
        assert lp["mlp"]["gate"].kind == lp["attn"]["o"].kind != "dense"


# ------------------------------------------------------------- (d, e) served


@pytest.fixture
def dequant_route(monkeypatch):
    """Every projection dequantizes, as the JAX CPU path does."""
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)


KW = dict(page_size=16, num_pages=32, max_seqs=2, max_model_len=256, prefill_buckets=(64,),
          decode_steps=4)


def _pipelines(arch, isq="Q4K"):
    hf, sd = hf_state_dict(arch)
    jcfg, tcfg = jconfig_from_hf(hf), config_from_hf(hf)
    jp = jparams_from_source(jcfg, JTensorSource.from_dict(sd), dtype=jnp.float32, isq=isq)
    tp = params_from_source(tcfg, TensorSource.from_dict(sd), dtype=torch.float32, isq=isq,
                            device="cpu")
    jpipe = JTextPipeline(jcfg, jp, jmake_rope(jcfg, 256), JPipelineConfig(**KW, dtype=jnp.float32))
    tpipe = TextPipeline(tcfg, tp, make_rope(tcfg, 256, device="cpu"),
                         PipelineConfig(**KW, dtype=torch.float32, device="cpu"))
    return jpipe, tpipe


def _greedy(eng, req, sp, prompts, max_len=6):
    groups = [eng.add_request(req(list(p), sp(max_len=max_len))) for p in prompts]
    while not all(g.all_done() for g in groups):
        eng.step()
    return [g.seqs[0].generated_tokens for g in groups]


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in (40, 23)]


def test_isq_model_serves_as_jax(dequant_route, one_thread):
    jpipe, tpipe = _pipelines("llama")
    prompt = _prompts(tpipe.cfg.vocab_size)[0]
    from mistralrs_tpu.engine.sequence import Sequence as JSequence
    from mistralrs_tpu_torch.engine.sequence import Sequence

    logits = []
    for pipe, seq_cls, sp in ((jpipe, JSequence, JSampling), (tpipe, Sequence, SamplingParams)):
        seq = seq_cls(list(prompt), sp(max_len=1))
        seq.block_table = list(range(1, 5))
        logits.append(np.asarray(pipe.run_prefill_chunk(seq, seq.tokens), np.float64))
    scale = np.abs(logits[0]).max()
    assert np.abs(logits[1] - logits[0]).max() <= LOGIT_RTOL * scale
    jtoks = _greedy(JEngine(jpipe, eos_token_ids=set(), prefix_cache=False), JRequest, JSampling,
                    _prompts(tpipe.cfg.vocab_size))
    ttoks = _greedy(Engine(tpipe, eos_token_ids=set(), prefix_cache=False), GenerationRequest,
                    SamplingParams, _prompts(tpipe.cfg.vocab_size))
    assert ttoks == jtoks and all(len(t) == 6 for t in ttoks)


def _unpadded_router(p, num_experts):
    """The port pads a packed router to 16 outputs at fusion (quant/fuse.py);
    the JAX package does not: its real columns, as a JAX-shaped Linear."""
    from mistralrs_tpu_torch.quant.fuse import split_linear

    layers = []
    for lp in p.layers:
        mlp = dict(lp["mlp"])
        r = mlp["router"]
        if r.shape[1] > num_experts:
            mlp["router"] = split_linear(r, [num_experts, r.shape[1] - num_experts])[0]
        layers.append({**lp, "mlp": mlp})
    return dataclasses.replace(p, layers=layers)


def _jax_requant(jpipe, gtype):
    """JAX's re_isq requantization of every Linear but the dense expert
    stacks (the closure of JAX pipeline/text.py's re_isq, on its own
    functions: an identity forward in f32, then _maybe_quantize)."""
    from mistralrs_tpu.models.loader import _maybe_quantize, group_layers
    from mistralrs_tpu.quant.isq import parse_isq as jparse_isq
    from mistralrs_tpu.quant.qlinear import Linear as JLinear
    from mistralrs_tpu.quant.qlinear import linear as jlinear

    g = jparse_isq(gtype)

    def requant(lin):
        w = np.asarray(jlinear(lin, jnp.eye(lin.shape[0], dtype=jnp.float32)), np.float32)
        q = _maybe_quantize(np.ascontiguousarray(w.T), None, g, jnp.float32)
        return q if q is not None else JLinear(kind="dense", shape=lin.shape,
                                               data={"w": jnp.asarray(w)}, meta=None)

    layers = []
    for group, size in zip(jpipe.params.layer_groups, jpipe.params.group_sizes):
        for i in range(size):
            lp = jax.tree.map(
                lambda x, i=i: (JLinear(kind=x.kind, shape=x.shape, meta=x.meta,
                                        data={k: v[i] for k, v in x.data.items()})
                                if isinstance(x, JLinear) else x[i]),
                group, is_leaf=lambda x: isinstance(x, JLinear))
            lp["attn"] = {k: requant(v) for k, v in lp["attn"].items()}
            lp["mlp"] = dict(lp["mlp"], router=requant(lp["mlp"]["router"]))
            layers.append(lp)
    groups, sizes = group_layers(layers)
    return dataclasses.replace(jpipe.params, layer_groups=groups, group_sizes=sizes,
                               lm_head=requant(jpipe.params.lm_head))


@pytest.mark.parametrize("arch", ["llama", "gemma2", "mixtral"])
def test_re_isq_is_byte_equal_to_jax_and_serves(arch, dequant_route, one_thread):
    jpipe, tpipe = _pipelines(arch)
    prompts = _prompts(tpipe.cfg.vocab_size)
    teng = Engine(tpipe, eos_token_ids=set(), prefix_cache=False)
    assert len(_greedy(teng, GenerationRequest, SamplingParams, prompts[:1])[0]) == 6
    tpipe.re_isq("Q8_0")
    if arch == "mixtral":
        jpipe.params = _jax_requant(jpipe, "Q8_0")
        jpipe._step_fn = jpipe._build_step_fn()
        jpipe._multistep_fn = None
    else:
        jpipe.re_isq("Q8_0")
    got = tpipe.params
    if arch == "mixtral":
        got = _unpadded_router(got, tpipe.cfg.num_experts)
        assert tpipe.params.layers[0]["mlp"]["router"].shape[1] == 16  # padded again
    assert_params_equal(got, params_from_reference(jax.tree.map(np.asarray, jpipe.params),
                                                   device="cpu", dtype=torch.float32))
    assert _kinds(got) == ({"gguf_q8_0", "dense"} if arch == "mixtral" else {"gguf_q8_0"})
    jeng = JEngine(jpipe, eos_token_ids=set(), prefix_cache=False)
    assert _greedy(teng, GenerationRequest, SamplingParams, prompts) == _greedy(
        jeng, JRequest, JSampling, prompts)


def test_re_isq_refuses_packed_experts(tmp_path):
    """A GGUF Mixtral's packed expert stacks cannot be requantized (JAX's
    identity forward cannot unpack them either): re_isq raises, it does
    not serve them dense."""
    from mistralrs_tpu_torch.pipeline.gguf import load_gguf_model
    from torch_port_model import write_tiny_gguf

    path = tmp_path / "mixtral.gguf"
    write_tiny_gguf(path, experts=4)
    cfg, params, rope, _ = load_gguf_model(str(path), dtype=torch.float32, device="cpu")
    pipe = TextPipeline(cfg, params, rope, PipelineConfig(**KW, dtype=torch.float32, device="cpu",
                                                          rq8_group=None))
    with pytest.raises(NotImplementedError, match="packed expert stack"):
        pipe.re_isq("Q8_0")
