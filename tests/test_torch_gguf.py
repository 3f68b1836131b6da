"""The port's GGUF reader, writer, dequantizers and loader against the JAX
package's, on the CPU.

(a) Both writers give byte-equal files for the same metadata (every value
    type the writers take) and tensors.
(b) Both readers give equal metadata, equal TensorInfos and equal raw bytes.
(c) The port's `dequantize` equals JAX's, bit for bit, for F32, F16, BF16,
    Q4_0, Q4_1, Q5_0, Q5_1, Q8_0 and Q2_K to Q6_K, and a tensor's shape
    stands as (out, in) on both sides for a non-square weight.
(d) `config_from_gguf` gives the JAX package's value in every field the
    port holds, for a llama GGUF and a Mixtral one (expert_count), and
    raises for phi2, phi3 and starcoder2.
(e) `params_from_gguf`: every Linear (and norm and the embedding) is
    byte-equal to JAX's, carried across by params_from_reference, for a
    Mistral in a Q4_K / Q5_K / Q6_K / Q8_0 mix, for one with q, k and v
    fused in one attn_qkv tensor (split by columns at load), and for
    Mixtral with its experts stacked (ffn_*_exps) and per expert
    (ffn_*.{e}).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.gguf.reader import GGMLType as JGGMLType
from mistralrs_tpu.gguf.reader import GGUFFile as JGGUFFile
from mistralrs_tpu.gguf.writer import write_gguf as jwrite_gguf
from mistralrs_tpu.pipeline.gguf import config_from_gguf as jconfig_from_gguf
from mistralrs_tpu.pipeline.gguf import load_gguf_model as jload_gguf_model
from mistralrs_tpu.quant import kquants as jkquants
from mistralrs_tpu_torch.gguf.reader import GGMLType, GGUFFile
from mistralrs_tpu_torch.gguf.writer import write_gguf
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.pipeline.gguf import config_from_gguf, load_gguf_model, params_from_gguf
from mistralrs_tpu_torch.quant import kquants
from mistralrs_tpu_torch.quant.qlinear import Linear
from torch_port_model import TINY_GGUF, port_params, write_tiny_gguf

QUANT_TYPES = (JGGMLType.Q4_0, JGGMLType.Q4_1, JGGMLType.Q5_0, JGGMLType.Q5_1, JGGMLType.Q8_0,
               JGGMLType.Q2_K, JGGMLType.Q3_K, JGGMLType.Q4_K, JGGMLType.Q5_K, JGGMLType.Q6_K)


def _metadata():
    return {"general.architecture": "llama", "general.name": "tiny", "llama.block_count": 2,
            "llama.rope.freq_base": 1e6, "neg": -3, "flag": True,
            "tokens": ["<s>", "</s>", "hello"], "scores": [0.5, -1.25, 2.0], "ids": [1, 2, 3],
            "f32s": np.arange(5, dtype=np.float32), "i32s": np.arange(4, dtype=np.int64)}


def _tensors():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((96, 512)) * 0.1).astype(np.float32)
    return {"a.weight": (JGGMLType.Q4_K, (96, 512), jkquants.quantize(w, JGGMLType.Q4_K)),
            "b.weight": (JGGMLType.Q8_0, (96, 512), jkquants.quantize(w, JGGMLType.Q8_0)),
            "norm.weight": (JGGMLType.F32, (7,), np.arange(7, dtype=np.float32)),
            "h.weight": (JGGMLType.F16, (3, 5), np.ones((3, 5), np.float16))}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = tmp_path_factory.mktemp("gguf")
    jwrite_gguf(str(d / "jax.gguf"), _metadata(), _tensors())
    write_gguf(str(d / "port.gguf"), _metadata(), _tensors())
    return d / "jax.gguf", d / "port.gguf"


def test_writers_give_byte_equal_files(written):
    jpath, tpath = written
    assert tpath.read_bytes() == jpath.read_bytes()


def test_readers_agree(written):
    jpath, _ = written
    jg, tg = JGGUFFile(str(jpath)), GGUFFile(str(jpath))
    assert tg.architecture == jg.architecture == "llama"
    assert set(tg.metadata) == set(jg.metadata)
    for k, v in jg.metadata.items():
        if isinstance(v, np.ndarray):
            assert tg.metadata[k].dtype == v.dtype and np.array_equal(tg.metadata[k], v), k
        else:
            assert tg.metadata[k] == v, k
    assert list(tg.tensors) == list(jg.tensors)
    for name, ji in jg.tensors.items():
        ti = tg.tensors[name]
        assert (ti.name, ti.shape, int(ti.ggml_type), ti.offset, ti.file_index) == \
            (ji.name, ji.shape, int(ji.ggml_type), ji.offset, ji.file_index)
        assert ti.byte_size == ji.byte_size
        assert np.array_equal(tg.raw_tensor(name)[1], jg.raw_tensor(name)[1])
        np.testing.assert_array_equal(tg.tensor_f32(name), jg.tensor_f32(name))


def test_reader_takes_shards(written):
    """Two files read as one model: each tensor's bytes come from its own file."""
    jpath, tpath = written
    tg = GGUFFile([str(jpath), str(tpath)])
    assert {ti.file_index for ti in tg.tensors.values()} == {1}  # the later shard's names win
    assert np.array_equal(tg.raw_tensor("a.weight")[1], JGGUFFile(str(jpath)).raw_tensor(
        "a.weight")[1])


def test_reader_refuses_a_file_that_is_not_gguf(tmp_path):
    p = tmp_path / "x.gguf"
    p.write_bytes(b"GGML" + bytes(60))
    with pytest.raises(ValueError):
        GGUFFile(str(p))


def test_one_enum():
    """The reader's enum is the one kquants and the packers use."""
    assert kquants.GGMLType is GGMLType
    from mistralrs_tpu_torch.quant import gguf_linear

    assert gguf_linear.GGMLType is GGMLType
    assert {t.name: int(t) for t in GGMLType} == {t.name: int(t) for t in JGGMLType}


@pytest.mark.parametrize("gtype", QUANT_TYPES, ids=lambda t: t.name)
def test_dequantize_equals_jax(gtype):
    rng = np.random.default_rng(int(gtype))
    w = (rng.standard_normal((24, 512)) * 0.3).astype(np.float32)
    raw = jkquants.quantize(w, gtype)
    want = jkquants.dequantize(raw, gtype, (24, 512))
    got = kquants.dequantize(raw, int(gtype), (24, 512))
    assert got.dtype == np.float32 and got.shape == (24, 512)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gtype,dt", [(JGGMLType.F32, np.float32), (JGGMLType.F16, np.float16),
                                      (JGGMLType.BF16, np.uint16)], ids=["F32", "F16", "BF16"])
def test_dequantize_float_types_equal_jax(gtype, dt):
    rng = np.random.default_rng(3)
    raw = (rng.standard_normal(60).astype(dt) if dt != np.uint16
           else rng.integers(0, 1 << 16, 60).astype(np.uint16) & 0x7F7F)
    raw = raw.view(np.uint8)
    np.testing.assert_array_equal(kquants.dequantize(raw, int(gtype), (6, 10)),
                                  jkquants.dequantize(raw, gtype, (6, 10)))


def test_dequantize_refuses_a_type_without_a_dequantizer():
    with pytest.raises(ValueError):
        kquants.dequantize(np.zeros(292, np.uint8), int(GGMLType.Q8_K), (256,))


def test_non_square_weight_is_out_by_in(tmp_path):
    """GGUF dims are stored innermost-first: the reader's shape is (out, in),
    which is what the packers take; the packed Linear is (in, out)."""
    from mistralrs_tpu_torch.quant.gguf_linear import linear_from_gguf

    rng = np.random.default_rng(4)
    w = (rng.standard_normal((96, 512)) * 0.2).astype(np.float32)
    path = tmp_path / "w.gguf"
    write_gguf(str(path), {"general.architecture": "llama"},
               {"w": (GGMLType.Q4_K, (96, 512), jkquants.quantize(w, JGGMLType.Q4_K))})
    g = GGUFFile(str(path))
    ti, raw = g.raw_tensor("w")
    assert ti.shape == (96, 512)
    assert np.abs(g.tensor_f32("w") - w).max() < 0.1
    lin = linear_from_gguf(raw, ti.ggml_type, ti.shape, torch.float32, "cpu")
    assert lin.shape == (512, 96) and lin.data["qs"].shape == (256, 96)


# ------------------------------------------------------------- configs


def _fields_equal(got: ModelConfig, want) -> None:
    for f in dataclasses.fields(ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    paths = {"mistral": d / "mistral.gguf", "mixtral": d / "mixtral.gguf",
             "mixtral_per_expert": d / "mixtral_pe.gguf", "fused_qkv": d / "fused_qkv.gguf"}
    write_tiny_gguf(paths["mistral"], seed=1)
    write_tiny_gguf(paths["fused_qkv"], seed=4, fused_qkv=True)
    write_tiny_gguf(paths["mixtral"], seed=2, experts=4)
    write_tiny_gguf(paths["mixtral_per_expert"], seed=3, experts=4, expert_layout="per_expert")
    return paths


@pytest.mark.parametrize("name", ["mistral", "mixtral"])
def test_config_from_gguf_equals_jax(tiny_files, name):
    path = str(tiny_files[name])
    got = config_from_gguf(GGUFFile(path))
    _fields_equal(got, jconfig_from_gguf(JGGUFFile(path)))
    assert got.arch == ("mixtral" if name == "mixtral" else "llama")
    assert (got.num_experts, got.num_experts_per_tok) == ((4, 2) if name == "mixtral" else (0, 0))
    assert (got.hidden_size, got.num_kv_heads, got.head_dim) == (512, 2, 128)


@pytest.mark.parametrize("arch", ["phi2", "phi3", "starcoder2", "gpt2"])
def test_config_from_gguf_refuses_archs_the_port_lacks(tmp_path, arch):
    path = tmp_path / f"{arch}.gguf"
    write_gguf(str(path), {"general.architecture": arch, f"{arch}.block_count": 1,
                           f"{arch}.embedding_length": 64, f"{arch}.feed_forward_length": 128,
                           f"{arch}.attention.head_count": 2, f"{arch}.vocab_size": 32}, {})
    with pytest.raises(ValueError, match="not ported" if arch != "gpt2" else "unsupported"):
        config_from_gguf(GGUFFile(str(path)))


# ------------------------------------------------------------- params


def _same(got, want, where: str) -> None:
    """Byte-equal trees of tensors, Linears, dicts and lists."""
    if isinstance(want, Linear):
        assert isinstance(got, Linear), where
        assert (got.kind, tuple(got.shape), got.meta) == (want.kind, tuple(want.shape),
                                                          want.meta), where
        _same(got.data, want.data, where)
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif want is None:
        assert got is None, where
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert torch.equal(got, want), where


@pytest.mark.parametrize("name", ["mistral", "mixtral", "mixtral_per_expert", "fused_qkv"])
def test_params_from_gguf_equal_jax(tiny_files, name):
    path = str(tiny_files[name])
    _, jparams, _, _ = jload_gguf_model(path, dtype=jnp.float32)
    want = port_params(jparams)
    g = GGUFFile(path)
    got = params_from_gguf(g, config_from_gguf(g), dtype=torch.float32, device="cpu")
    for field in ("embed", "layers", "final_norm", "lm_head"):
        _same(getattr(got, field), getattr(want, field), field)
    kinds = {lin.kind for lp in got.layers for part in ("attn", "mlp")
             for lin in lp[part].values() if isinstance(lin, Linear)}
    if name == "mistral":
        assert kinds == {"gguf_q4k", "gguf_q5k", "gguf_q6k", "gguf_q8_0"}
        k = got.layers[0]["attn"]["k"]
        assert k.shape == (512, 256) and k.data["qs"].shape == (256, 256)
    elif name == "fused_qkv":  # split by columns: q, then k, then v
        assert "attn_qkv.weight" in "".join(g.tensors) and "blk.0.attn_q.weight" not in g
        assert [got.layers[1]["attn"][n].shape for n in "qkv"] == [(512, 512), (512, 256),
                                                                   (512, 256)]
    else:
        ex = got.layers[0]["mlp"]["experts"]
        assert ex["gate"].data["qs"].shape == (4, 256, 1024)
        assert got.layers[0]["mlp"]["router"].kind == "dense"


def test_load_gguf_model_returns_the_four_slots(tiny_files):
    cfg, params, rope, tok = load_gguf_model(str(tiny_files["mistral"]), dtype=torch.float32,
                                             device="cpu")
    assert tok is None
    assert cfg.max_position_embeddings == TINY_GGUF["ctx"]
    assert params.embed.shape == (TINY_GGUF["vocab"], TINY_GGUF["hidden"])
    assert params.lm_head.kind == "gguf_q6k" and params.embed.device.type == "cpu"
    assert rope.cos.shape[0] == TINY_GGUF["ctx"]
