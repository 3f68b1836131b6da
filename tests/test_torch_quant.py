"""Port vs JAX package: GGUF packers, dequant, the Q6_K -> int8 requant, fusion.

Wire blocks come from the JAX package's kquants.quantize on seeded numpy
weights; both packages pack the same bytes. Layouts must be bit-equal;
dequantized values are f32 on both sides and may differ only by the
rounding of one f32 multiply-subtract (XLA may fuse it), so they are held
to 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.gguf.reader import GGMLType
from mistralrs_tpu.quant import fuse as jfuse
from mistralrs_tpu.quant import gguf_linear as jgl
from mistralrs_tpu_torch.quant import fuse as tfuse
from mistralrs_tpu_torch.quant import gguf_linear as tgl
from torch_port_model import jax_q4km_params, port_params, quantized

F32_RTOL = 1e-6


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_linear(jl, tl, exact=True):
    assert jl.kind == tl.kind and tuple(jl.shape) == tuple(tl.shape) and jl.meta == tl.meta
    assert set(jl.data) == set(tl.data)
    for k in jl.data:
        a, b = np.asarray(jl.data[k]), _np(tl.data[k])
        assert a.shape == b.shape, k
        if exact or not np.issubdtype(a.dtype, np.floating):
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=F32_RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize("gtype,out_f,in_f", [
    (GGMLType.Q4_K, 96, 512), (GGMLType.Q6_K, 64, 1024), (GGMLType.Q6_K, 40, 256),
    (GGMLType.Q8_0, 48, 96)])
def test_packers_bit_equal(gtype, out_f, in_f):
    rng = np.random.default_rng(int(gtype) + in_f)
    raw, jl = quantized(rng, gtype, out_f, in_f, 0.3)
    tl = tgl.linear_from_gguf(raw, int(gtype), (out_f, in_f), dtype=torch.float32, device="cpu")
    _same_linear(jl, tl)


@pytest.mark.parametrize("gtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0])
def test_dequant_matches(gtype):
    rng = np.random.default_rng(int(gtype))
    raw, jl = quantized(rng, gtype, 64, 512, 0.3)
    tl = tgl.linear_from_gguf(raw, int(gtype), (64, 512), dtype=torch.float32, device="cpu")
    want = np.asarray(jgl.DEQUANT_WEIGHTS[jl.kind](jl, jnp.float32))
    got = tgl.DEQUANT_WEIGHTS[tl.kind](tl, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_RTOL * np.abs(want).max())


@pytest.mark.parametrize("gs", [32, 64])
def test_requant_q6k_to_q8_matches(gs):
    rng = np.random.default_rng(gs)
    raw, jl = quantized(rng, GGMLType.Q6_K, 80, 512, 0.3)
    tl = tgl.linear_from_gguf(raw, GGMLType.Q6_K, (80, 512), dtype=torch.float32, device="cpu")
    jq = jgl.requant_q6k_to_q8(jl, gs)
    tq = tgl.requant_q6k_to_q8(tl, gs)
    assert tq.kind == "gguf_q8_0" and tq.meta == gs and tq.data["scale"].dtype == torch.float32
    # same f32 arithmetic on the same values: the int8 codes agree exactly
    # and the scales to f32 rounding
    np.testing.assert_array_equal(tq.data["q"].numpy(), np.asarray(jq.data["q"]))
    np.testing.assert_allclose(tq.data["scale"].numpy(), np.asarray(jq.data["scale"]),
                               rtol=F32_RTOL)


def test_pad_linear_out_matches():
    rng = np.random.default_rng(3)
    raw, jl = quantized(rng, GGMLType.Q6_K, 1920, 512, 0.3)
    tl = tgl.linear_from_gguf(raw, GGMLType.Q6_K, (1920, 512), dtype=torch.float32, device="cpu")
    jp, tp = jfuse.pad_linear_out(jl), tfuse.pad_linear_out(tl)
    assert tp.shape == (512, 2048)
    _same_linear(jp, tp)
    # too much padding (a tiny vocab) is refused on both sides
    raw, jl = quantized(rng, GGMLType.Q4_K, 200, 256, 0.3)
    tl = tgl.linear_from_gguf(raw, GGMLType.Q4_K, (200, 256), dtype=torch.float32, device="cpu")
    assert jfuse.pad_linear_out(jl) is None and tfuse.pad_linear_out(tl) is None


def test_split_linear_inverts_fuse():
    rng = np.random.default_rng(4)
    lins = [tgl.linear_from_gguf(quantized(rng, GGMLType.Q4_K, o, 256, 0.3)[0], GGMLType.Q4_K,
                                 (o, 256), dtype=torch.float32, device="cpu") for o in (64, 32)]
    fused = tfuse.fuse_linears(lins)
    back = tfuse.split_linear(fused, [64, 32])
    for a, b in zip(lins, back):
        for k in a.data:
            assert torch.equal(a.data[k], b.data[k])


def test_fuse_decoder_params_and_rq8_match():
    """Q4_K_M mix: q|k fuse (v is Q6_K), gate|up fuse, lm_head padded; then
    rq8 (gs 32) turns every Q6_K into int8. Same arrays as the JAX package."""
    jcfg, jparams = jax_q4km_params(seed=1)
    jf = jfuse.requant_q6k_params(jfuse.fuse_decoder_params(jparams), gs=32)
    tf = tfuse.requant_q6k_params(tfuse.fuse_decoder_params(port_params(jparams)), gs=32)
    assert tf.lm_head.shape == (512, 2048)
    _same_linear(jax.tree.map(np.asarray, jf.lm_head), tf.lm_head)
    i = 0
    for group, size in zip(jf.layer_groups, jf.group_sizes):
        for j in range(size):
            lp = tf.layers[i]
            assert set(lp["attn"]) == {"qk", "v", "o"} and set(lp["mlp"]) == {"gateup", "down"}
            for part in ("attn", "mlp"):
                for name, tl in lp[part].items():
                    jl = group[part][name]
                    one = type(jl)(kind=jl.kind, shape=jl.shape, meta=jl.meta,
                                   data={k: np.asarray(v)[j] for k, v in jl.data.items()})
                    _same_linear(one, tl)
            i += 1
    assert i == len(tf.layers) == jcfg.num_layers


def test_dense_linear_matches():
    from mistralrs_tpu.quant import qlinear as jq
    from mistralrs_tpu_torch.quant import qlinear as tq

    rng = np.random.default_rng(11)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    want = np.asarray(jq.linear(jq.make_dense(jnp.asarray(w), jnp.asarray(b)), jnp.asarray(x)))
    got = tq.linear(tq.make_dense(torch.from_numpy(w), torch.from_numpy(b)), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hf", [
    {"architectures": ["MistralForCausalLM"], "vocab_size": 32000, "hidden_size": 4096,
     "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
     "num_key_value_heads": 8, "rope_theta": 1e6, "sliding_window": 4096,
     "rms_norm_eps": 1e-5},
    {"model_type": "llama", "vocab_size": 128, "hidden_size": 64, "intermediate_size": 96,
     "num_hidden_layers": 2, "num_attention_heads": 4, "tie_word_embeddings": True},
    # the epsilon under its other names, which JAX's _base falls back to
    {"architectures": ["MistralForCausalLM"], "vocab_size": 32000, "hidden_size": 4096,
     "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
     "num_key_value_heads": 8, "layer_norm_eps": 1e-6},
    {"model_type": "llama", "vocab_size": 128, "hidden_size": 64, "intermediate_size": 96,
     "num_hidden_layers": 2, "num_attention_heads": 4, "norm_epsilon": 1e-6},
])
def test_config_from_hf_matches(hf):
    from mistralrs_tpu.models.config import config_from_hf as jconfig
    from mistralrs_tpu_torch.models.config import config_from_hf as tconfig

    jc, tc = jconfig(hf), tconfig(hf)
    for field in ("arch", "vocab_size", "hidden_size", "intermediate_size", "num_layers",
                  "num_heads", "num_kv_heads", "head_dim", "max_position_embeddings",
                  "norm_eps", "act", "rope_theta", "rope_scaling", "sliding_window",
                  "sliding_window_pattern", "query_scale", "tie_word_embeddings"):
        assert getattr(tc, field) == getattr(jc, field), field
    with pytest.raises(ValueError):  # an architecture the port does not translate
        tconfig({"model_type": "phi3"})


def test_pipeline_refuses_a_vocabulary_of_2_24():
    """Token ids go through f32 in the greedy packs, exact only below 2^24:
    the pipeline refuses a larger vocabulary, as the JAX package does."""
    from mistralrs_tpu_torch.models.config import ModelConfig
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    cfg = ModelConfig(arch="llama", vocab_size=2**24, hidden_size=64, intermediate_size=96,
                      num_layers=1, num_heads=4, num_kv_heads=4, head_dim=16,
                      max_position_embeddings=128)
    with pytest.raises(AssertionError, match="2\\^24"):
        TextPipeline(cfg, None, None, PipelineConfig(device="cpu"))


@pytest.mark.parametrize("sizing", [
    {"context_len": 1000},  # context_len wins over mem_bytes
    {"context_len": 1000, "mem_bytes": 1 << 30},
    {"mem_bytes": 3 << 30, "page_size": 32},
    {},  # no memory reported on the CPU: the fixed fallback
])
def test_calculate_num_pages_matches(sizing):
    from mistralrs_tpu.utils import memory as jmem
    from mistralrs_tpu_torch.utils import memory as tmem

    args = (32, 8, 128)
    kw = dict(dtype_bytes=2, max_seqs=16)
    want = jmem.calculate_num_pages(jmem.PagedCacheConfig(**sizing), *args, **kw,
                                    device=jax.devices("cpu")[0])
    got = tmem.calculate_num_pages(tmem.PagedCacheConfig(**sizing), *args, **kw, device="cpu")
    assert got == want
