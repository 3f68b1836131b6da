"""The port's safetensors reader and HF loader (models/loader.py) against the
safetensors package and the JAX package, and chip_smoke.py's checkpoint
writer at a tiny size on the CPU.

- Files written by safetensors.numpy.save_file (bf16, f16, f32, int32, in
  two shards) read back equal; chip_smoke.write_safetensors' files read
  back through safetensors.safe_open equal; a name in two shards, a header
  that overruns its file, a tensor past the data and an unknown dtype
  raise.
- load_hf_model on a tiny HF directory (a bf16 Llama with its own lm_head,
  dense and ISQ Q4K with a topology file; an f32 Gemma-2) equals the JAX
  package's load_hf_model, leaf for leaf; an AutoGPTQ directory gives the
  JAX package's Linear data.
- chip_smoke.write_gemma2_hf's checkpoint loads with ISQ Q4K (every
  projection Q4_K, the embedding bf16), serves, re-quantizes to Q8_0 and
  serves again; its card-vs-CPU helpers run one side with forced tokens.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke
from mistralrs_tpu.models.loader import load_hf_model as jload_hf_model
from mistralrs_tpu_torch.models.loader import (BF16, TensorSource, load_hf_model,
                                                params_from_reference, read_safetensors)
from torch_port_model import assert_params_equal, hf_state_dict


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"a.bf16": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
            "b.f16": rng.standard_normal((4,)).astype(np.float16),
            "c.f32": rng.standard_normal((2, 3, 4)).astype(np.float32),
            "d.i32": rng.integers(-2**31, 2**31, (6, 2)).astype(np.int32)}


def _same(got: np.ndarray, want: np.ndarray) -> bool:
    if want.dtype == ml_dtypes.bfloat16:
        return got.dtype == BF16 and np.array_equal(got.view(np.uint16), want.view(np.uint16))
    return got.dtype == want.dtype and np.array_equal(got, want)


def test_reads_files_of_the_safetensors_package_in_two_shards(tmp_path):
    from safetensors.numpy import save_file

    arrs = _arrays()
    names = sorted(arrs)
    save_file({n: arrs[n] for n in names[:2]}, str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file({n: arrs[n] for n in names[2:]}, str(tmp_path / "model-00002-of-00002.safetensors"))
    src = TensorSource.from_safetensors_dir(str(tmp_path))
    assert src.names == set(names)
    for n in names:
        assert src(n).shape == arrs[n].shape and _same(src(n), arrs[n]), n


def test_chip_smoke_writer_reads_back_through_safetensors(tmp_path):
    from safetensors import safe_open

    arrs = _arrays(1)
    names = {"a.bf16": "BF16", "b.f16": "F16", "c.f32": "F32", "d.i32": "I32"}
    path = str(tmp_path / "w.safetensors")
    n = chip_smoke.write_safetensors(path, {
        k: (dt, arrs[k].shape, (arrs[k].view(np.uint16) if dt == "BF16" else arrs[k]))
        for k, dt in names.items()})
    assert n == sum(a.nbytes for a in arrs.values())
    with safe_open(path, framework="np") as f:
        assert set(f.keys()) == set(arrs)
        for k, a in arrs.items():
            got = f.get_tensor(k)
            assert got.dtype == a.dtype and np.array_equal(got.view(np.uint8), a.view(np.uint8)), k
    for k, a in read_safetensors(path).items():
        assert _same(a, arrs[k]), k
    with pytest.raises(ValueError, match="not F32"):
        chip_smoke.write_safetensors(path, {"x": ("F32", (2,), np.zeros(2, np.float16))})


def test_malformed_files_raise(tmp_path):
    from safetensors.numpy import save_file

    arrs = _arrays(2)
    save_file({"x": arrs["c.f32"]}, str(tmp_path / "a.safetensors"))
    save_file({"x": arrs["c.f32"], "y": arrs["d.i32"]}, str(tmp_path / "b.safetensors"))
    with pytest.raises(ValueError, match="in both"):
        TensorSource.from_safetensors_dir(str(tmp_path))

    def write(name, header: bytes, data: bytes, n=None):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write((len(header) if n is None else n).to_bytes(8, "little") + header + data)
        return path

    ok = json.dumps({"x": {"dtype": "F32", "shape": [2, 2], "data_offsets": [0, 16]}}).encode()
    with pytest.raises(ValueError, match="overruns"):
        read_safetensors(write("long.safetensors", ok, bytes(16), n=len(ok) + 17))
    with pytest.raises(ValueError, match="no safetensors header"):
        read_safetensors(_empty(tmp_path))
    with pytest.raises(ValueError, match="does not fit"):
        read_safetensors(write("cut.safetensors", ok, bytes(12)))
    bad = json.dumps({"x": {"dtype": "F32", "shape": [3], "data_offsets": [0, 16]}}).encode()
    with pytest.raises(ValueError, match="does not fit"):
        read_safetensors(write("count.safetensors", bad, bytes(16)))
    odd = json.dumps({"x": {"dtype": "F8_E4M3", "shape": [4], "data_offsets": [0, 4]}}).encode()
    with pytest.raises(ValueError, match="not read here"):
        read_safetensors(write("dtype.safetensors", odd, bytes(4)))
    assert np.array_equal(read_safetensors(write("ok.safetensors", ok, bytes(16)))["x"],
                          np.zeros((2, 2), np.float32))


def _empty(tmp_path) -> str:
    path = str(tmp_path / "empty.safetensors")
    open(path, "wb").close()
    return path


# ------------------------------------------------------------- load_hf_model


def _hf_dir(tmp_path, arch, bf16: bool) -> str:
    """A tiny seeded model (hf_state_dict) as an HF directory: config.json
    and its state dict in bf16 or f32 over two safetensors shards."""
    from safetensors.numpy import save_file

    hf, sd = hf_state_dict(arch)
    path = tmp_path / arch
    path.mkdir()
    (path / "config.json").write_text(json.dumps(hf))
    names = sorted(sd)
    for k, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        save_file({n: sd[n].astype(ml_dtypes.bfloat16 if bf16 else np.float32) for n in part},
                  str(path / f"model-{k + 1:05d}-of-00002.safetensors"))
    return str(path)


@pytest.mark.parametrize("case", ["llama-bf16-dense", "llama-bf16-q4k-topology",
                                  "gemma2-f32-q4k"])
def test_load_hf_model_equals_jax(tmp_path, case):
    arch, dt, isq = case.split("-")[:3]
    path = _hf_dir(tmp_path, arch, bf16=dt == "bf16")
    kw = {} if isq == "dense" else {"isq": "Q4K"}
    if case.endswith("topology"):
        topo = tmp_path / "topology.yaml"
        topo.write_text("0:\n  isq: Q8_0\n")
        kw["topology"] = str(topo)
    jcfg, jp, _ = jload_hf_model(path, dtype=jnp.float32, **kw)
    cfg, got, rope = load_hf_model(path, dtype=torch.float32, device="cpu", **kw)
    assert cfg.num_layers == jcfg.num_layers and cfg.arch == jcfg.arch
    assert_params_equal(got, params_from_reference(jax.tree.map(np.asarray, jp), device="cpu",
                                                   dtype=torch.float32))
    if "topology" in kw:
        assert got.layers[0]["attn"]["q"].kind == "gguf_q8_0"
        assert got.layers[1]["attn"]["q"].kind == got.lm_head.kind == "gguf_q4k"
    assert rope.cos.shape[0] == cfg.max_position_embeddings


def test_gptq_directory_equals_jax(tmp_path):
    """An AutoGPTQ checkpoint (the port's round-to-nearest GPTQ-format
    quantizer, 4 bits, group 32, quantization_config in config.json): JAX's
    Linear data for every projection."""
    from safetensors.numpy import save_file

    from mistralrs_tpu_torch.quant.gptq import quantize_gptq_rtn

    hf, sd = hf_state_dict("llama")
    tensors = {}
    for k, v in sd.items():
        if k.endswith("_proj.weight"):
            for name, arr in quantize_gptq_rtn(v, 4, group_size=32).items():
                tensors[f"{k[: -len('.weight')]}.{name}"] = arr
        else:
            tensors[k] = v
    d = tmp_path / "gptq"
    d.mkdir()
    save_file(tensors, str(d / "model.safetensors"))
    hf["quantization_config"] = {"quant_method": "gptq", "bits": 4, "group_size": 32}
    (d / "config.json").write_text(json.dumps(hf))
    _, jp, _ = jload_hf_model(str(d), dtype=jnp.float32)
    _, got, _ = load_hf_model(str(d), dtype=torch.float32, device="cpu")
    assert_params_equal(got, params_from_reference(jax.tree.map(np.asarray, jp), device="cpu",
                                                   dtype=torch.float32))
    for lp in got.layers:  # contiguous 4-bit groups at in % 512 == 0 are Q4_K's layout
        assert {lin.kind for lin in lp["attn"].values()} == {"gptq_4"}
        assert [lp["mlp"][k].kind for k in ("gate", "up", "down")] == ["gptq_4"] * 2 + ["gguf_q4k"]


# ------------------------------------------------------------- chip_smoke's checkpoint

TINY_GEMMA2 = chip_smoke.Sizes(vocab=512, hidden=256, inter=512, heads=4, kv_heads=2, head_dim=64,
                               layers=2, max_len=6)


def test_chip_smoke_gemma2_checkpoint_loads_serves_and_requantizes(tmp_path, monkeypatch):
    from mistralrs_tpu_torch.engine.engine import Engine
    from mistralrs_tpu_torch.ops import quant_matmul as qm
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    monkeypatch.setattr(qm, "MAX_KERNEL_ROWS", -1)
    sz = TINY_GEMMA2
    n = chip_smoke.write_gemma2_hf(str(tmp_path), sz, sz.layers, seed=21, device="cpu")
    shards = sorted(f for f in os.listdir(tmp_path) if f.endswith(".safetensors"))
    H, D = sz.hidden, sz.head_dim
    per_layer = H * (2 * sz.heads * D + 2 * sz.kv_heads * D + 3 * sz.inter + 4)
    assert len(shards) == 2 and n == 2 * (sz.vocab * H + sz.layers * per_layer + H)
    cfg, params, rope = load_hf_model(str(tmp_path), isq="Q4K", device="cpu")
    assert cfg == chip_smoke.gemma2_config(sz, sz.layers)
    assert chip_smoke.params_kinds(params) == chip_smoke.GEMMA2_KINDS
    assert params.embed.dtype == torch.bfloat16 and params.lm_head is None
    w = params.embed.float()
    assert 0.015 < float(w.std()) < 0.025 and float(params.layers[0]["input_norm"]["w"].abs().max()) == 0

    cfg, params, rope = load_hf_model(str(tmp_path), dtype=torch.float32, isq="Q4K", device="cpu")
    pipe = TextPipeline(cfg, params, rope, PipelineConfig(
        page_size=16, num_pages=32, max_seqs=4, max_model_len=256, prefill_buckets=(64,),
        decode_steps=4, dtype=torch.float32, device="cpu"))
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    rng = np.random.default_rng(1)

    def serve():
        groups = chip_smoke.add_requests(eng, rng, sz.vocab, 2, 30, sz.max_len)
        while not all(g.all_done() for g in groups):
            eng.step()
        return chip_smoke.check_served(groups, sz.vocab, sz.max_len, pipe)

    assert serve() == 2 * sz.max_len
    pipe.re_isq("Q8_0")
    assert chip_smoke.served_kinds(pipe) == ["gguf_q8_0"]
    assert serve() == 2 * sz.max_len

    # one side of the card-vs-CPU run, fed forced tokens
    prompt = [int(t) for t in rng.integers(1, sz.vocab, 256)]
    runs, counts = chip_smoke._token_major_run(
        None, lambda dev, dt: load_hf_model(str(tmp_path), dtype=dt, device=dev)[:2],
        torch.device("cpu"), prompt, 32, sides=((torch.device("cpu"), torch.float32),),
        forced=[1, 2, 3, 4])
    assert runs["cpu"].shape == (5, sz.vocab) and np.isfinite(runs["cpu"]).all()
