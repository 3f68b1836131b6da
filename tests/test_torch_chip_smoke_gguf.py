"""chip_smoke.py's GGUF phases at a tiny size on the CPU: a random Q5_K_M
GGUF written, read back and served on the bf16 route, the bf16 card-vs-CPU
run, and the kernel phase's bf16 GEMV groups through the plain versions."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke_tiny import TINY
from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline


# ------------------------------------------------------------- GGUF files


@pytest.fixture(scope="module")
def tiny_q5km_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gguf") / "q5km.gguf")
    nbytes = chip_smoke.write_random_gguf(path, TINY, 8, "Q5_K", seed=12)
    return path, nbytes


def test_random_gguf_has_the_q5km_mix_and_reads_back(tiny_q5km_gguf):
    """The random-wire builder at a tiny size: the port's reader finds the
    Q5_K_M rule's types (Q6_K attn_v, use_more_bits ffn_down and output,
    Q5_K elsewhere, F32 norms), every tensor dequantizes to finite values,
    and the packed scales and mins stay in bench.py's ranges."""
    from mistralrs_tpu_torch.gguf.reader import GGMLType, GGUFFile
    from mistralrs_tpu_torch.quant.gguf_linear import linear_from_gguf

    path, nbytes = tiny_q5km_gguf
    g = GGUFFile(path)
    assert g.architecture == "llama" and g.metadata["llama.block_count"] == 8
    assert sum(ti.byte_size for ti in g.tensors.values()) == nbytes
    assert len(g.tensors) == 3 + 9 * 8
    assert g.tensors["token_embd.weight"].ggml_type == GGMLType.Q5_K
    assert g.tensors["output.weight"].ggml_type == GGMLType.Q6_K
    for i in range(8):
        types = {n: g.tensors[f"blk.{i}.{n}.weight"].ggml_type.name
                 for n in chip_smoke.gguf_mix("Q5_K", i, 8)}
        assert types == chip_smoke.gguf_mix("Q5_K", i, 8)
        assert types["attn_v"] == "Q6_K" and types["attn_q"] == "Q5_K"
        assert types["ffn_down"] == ("Q6_K" if chip_smoke.use_more_bits(i, 8) else "Q5_K")
        assert g.tensors[f"blk.{i}.attn_norm.weight"].ggml_type == GGMLType.F32
    assert g.tensors["blk.0.attn_k.weight"].shape == (TINY.kv_heads * TINY.head_dim, TINY.hidden)
    for name in g.tensors:
        assert np.isfinite(g.tensor_f32(name)).all(), name
    ti, raw = g.raw_tensor("blk.0.ffn_gate.weight")
    lin = linear_from_gguf(raw, ti.ggml_type, ti.shape, torch.float32, "cpu")
    assert float(lin.data["scale"].max()) < 0.005 and float(lin.data["minv"].max()) < 0.002
    ti, raw = g.raw_tensor("output.weight")
    lin = linear_from_gguf(raw, ti.ggml_type, ti.shape, torch.float32, "cpu")
    assert float(lin.data["scale"].abs().max()) < 0.005


def test_random_gguf_serves_on_the_bf16_route(tiny_q5km_gguf, monkeypatch):
    """The gguf_bf16 phase's pipeline at a tiny size on the CPU: the file
    loaded by load_gguf_model and served with int8_activations=False at
    rq8_group=32 takes K9b's decode instantiation (the whole Q5_K product)
    at 1-16 rows, K5 and K9b's high-bit kernel only above 16 (here the
    prefill takes the dequant route), and K8, never an int8 GEMV (the
    wrappers counted by their rows, each taking its plain version here)."""
    from mistralrs_tpu_torch.ops import quant_matmul as qm
    from mistralrs_tpu_torch.pipeline.gguf import load_gguf_model

    calls = {}
    for name in ("q5k_bf16_gemv", "q4k_bf16_gemv", "q5k_hbit_bf16_gemv",
                 "q8_0_bf16_gemv") + chip_smoke.INT8_GEMVS:
        fn = getattr(qm, name)
        monkeypatch.setattr(qm, name,
                            lambda x, *a, _n=name, _f=fn, **k: calls.setdefault(_n, set()).add(
                                x.shape[0]) or _f(x, *a, **k))
    cfg, params, rope, _ = load_gguf_model(tiny_q5km_gguf[0], dtype=torch.float32, device="cpu")
    pc = PipelineConfig(page_size=16, num_pages=64, max_seqs=4, max_model_len=512,
                        prefill_buckets=(64, 256), decode_steps=4, dtype=torch.float32,
                        device="cpu", int8_activations=False)
    pipe = TextPipeline(dataclasses.replace(cfg, num_layers=2), dataclasses.replace(
        params, layers=params.layers[:2]), rope, pc)
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    rng = np.random.default_rng(1)
    groups = [eng.add_request(GenerationRequest([int(t) for t in rng.integers(1, TINY.vocab, n)],
                                                SamplingParams(max_len=6)))
              for n in (150, 40)]
    while not all(g.all_done() for g in groups):
        eng.step()
    assert all(g.seqs[0].num_generated == 6 for g in groups)
    assert np.isfinite(pipe.last_greedy_pack).all()
    assert {"q5k_bf16_gemv", "q8_0_bf16_gemv"} <= set(calls) <= {
        "q5k_bf16_gemv", "q4k_bf16_gemv", "q5k_hbit_bf16_gemv", "q8_0_bf16_gemv"}, calls
    assert max(calls["q5k_bf16_gemv"]) <= 16, calls
    assert calls.get("q4k_bf16_gemv") == calls.get("q5k_hbit_bf16_gemv"), calls
    assert min(calls.get("q4k_bf16_gemv", {17})) > 16, calls


def test_bf16_card_vs_cpu_loads_each_side_from_the_file(tiny_q5km_gguf):
    """card_vs_cpu_bf16's run with the CPU standing in for both sides:
    load_gguf_model on each side, a 256-token prefill and 4 decode steps."""
    from mistralrs_tpu_torch.pipeline.gguf import load_gguf_model

    def load(dev, dt):
        cfg, params, _, _ = load_gguf_model(tiny_q5km_gguf[0], dtype=dt, device=dev)
        return dataclasses.replace(cfg, num_layers=2), dataclasses.replace(
            params, layers=params.layers[:2])

    prompt = [int(t) for t in np.random.default_rng(13).integers(1, TINY.vocab, 256)]
    runs, counts = chip_smoke._token_major_run(None, load, torch.device("cpu"), prompt, 32,
                                               int8_activations=False)
    assert runs["cpu"].shape == (5, TINY.vocab) and np.isfinite(runs["cpu"]).all()
    assert counts["q4k_bf16_gemv"] == 0  # no launch on the CPU


class _CallOnce:
    """A stand-in for chip_smoke.Clock on the CPU: runs fn once, times nothing."""

    def ms(self, fn) -> float:
        fn()
        return 0.0


@pytest.mark.parametrize("sms,want_splits", [(32, {1, 2, 4}), (132, {2, 4})])
def test_bf16_kernels_hold_k9b_rows_at_every_gguf_bf16_shape(monkeypatch, sms, want_splits):
    """bf16_kernels at a tiny size on the CPU (the plain versions on both
    sides): K9b's rows instantiation is compared at gate|up, q|k, o and
    down, each row carries the plan's K split, and the phase raises unless
    one split and several were both compared."""
    from mistralrs_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "sm_count", lambda device: sms)
    # a profiler trace of the card's kernels a call needs the card: one here
    monkeypatch.setattr(chip_smoke, "kernels_a_call", lambda fn, calls=8: 1.0)
    rows = []
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, lo=0.0, hi=1.0, dtype=torch.float32):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dtype)

    def record(name, shape_name, err, rel, tol, *_, **extra):
        assert rel <= tol, (name, shape_name, rel)
        rows.append((name, shape_name, extra.get("splits")))

    run = lambda: chip_smoke.bf16_kernels(TINY, torch.device("cpu"), _CallOnce(), gen, rand, record)
    if 1 not in want_splits:  # every shape split: the phase must refuse
        with pytest.raises(AssertionError, match="not at one and at several"):
            run()
        return
    run()
    k9b = {(shape, ks) for name, shape, ks in rows if name == "q5k_hbit_bf16_gemv_rows"}
    assert {shape.split(" B=")[0] for shape, _ in k9b} == {"gate|up", "qk", "o", "down"}
    assert {shape for shape, _ in k9b} >= {f"{nm} B={B}" for nm in ("qk", "o", "down")
                                           for B in (17, 64, 256)}
    assert {ks for _, ks in k9b} == want_splits
    # K8's decode instantiation only up to 16 rows; K5's in k5_kernels
    assert not [r for r in rows if r[0] == "q4k_bf16_gemv"]
    assert not [r for r in rows if r[0] == "q8_0_bf16_gemv" and not r[1].endswith(
        ("B=1", "B=4", "B=16"))]
    assert {r[1] for r in rows if r[0] == "q8_0_bf16_gemv"} == {
        f"{nm} B={B}" for nm in ("v", "qk", "gate|up", "down", "lm_head", "lm_head wire")
        for B in (1, 4, 16)}


def test_k5_kernels_hold_the_decode_instantiation_at_every_projection(monkeypatch):
    """k5_kernels at a tiny size on the CPU (the plain versions on both
    sides): K5 at q|k, o, gate|up and down at 1, 4 and 16 rows, at 16 with
    the kernels the card runs a call (a stub here: the trace needs the
    card), which raise past one."""
    calls = []
    monkeypatch.setattr(chip_smoke, "kernels_a_call", lambda fn, calls_=8: calls.append(fn) or 1.0)
    rows = []
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, lo=0.0, hi=1.0, dtype=torch.float32):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dtype)

    def record(name, shape_name, err, rel, tol, *_, **extra):
        assert name == "q4k_bf16_gemv" and rel <= tol == 1e-4, (name, shape_name, rel)
        rows.append((shape_name, extra.get("kernels_a_call"), "int8_ms" in extra))

    chip_smoke.k5_kernels(TINY, torch.device("cpu"), _CallOnce(), gen, rand, record)
    assert [r[0] for r in rows] == [f"{nm} B={B}" for nm in ("qk", "o", "gate|up", "down")
                                    for B in (1, 4, 16)]
    assert [r[1] for r in rows if r[1] is not None] == [1.0] * 4 and len(calls) == 4
    assert all(r[2] for r in rows)
    monkeypatch.setattr(chip_smoke, "kernels_a_call", lambda fn, calls_=8: 3.0)
    with pytest.raises(AssertionError, match="q4k_bf16_gemv B=16: 3.0 kernels a call"):
        chip_smoke.k5_kernels(TINY, torch.device("cpu"), _CallOnce(), gen, rand, record)


# hidden 2048: K5's rows instantiation splits K at zs slices of 512
# elements, so o and down (K 512) take one split; 32 column tiles of the
# lm_head fill 32 SMs
WIDE = chip_smoke.Sizes(vocab=3968, hidden=2048, inter=512, heads=4, kv_heads=2, layers=2)


@pytest.mark.parametrize("sms", [32, 4])
def test_bf16_rows_kernels_hold_k5_and_k8_rows(monkeypatch, sms):
    """bf16_rows_kernels at a small size on the CPU (the plain versions on
    both sides, 17 and 64 rows): K5's rows instantiation at gate|up, q|k, o
    and down, K8's at v, down and the lm_head on f32 scales and at the
    lm_head on bf16 ones, each row with the plan's K split; with few SMs
    no K5 shape splits K, and the phase refuses."""
    from mistralrs_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "sm_count", lambda device: sms)
    monkeypatch.setattr(chip_smoke, "BF16_ROWS_B", (17, 64))
    rows = []

    def inputs(seed):
        gen = torch.Generator().manual_seed(seed)

        def rand(*shape, lo=0.0, hi=1.0, dtype=torch.float32):
            return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dtype)
        return gen, rand

    def record(name, shape_name, err, rel, tol, *_, **extra):
        assert rel <= tol, (name, shape_name, rel)
        rows.append((name, shape_name, extra["splits"]))

    run = lambda: chip_smoke.bf16_rows_kernels(WIDE, torch.device("cpu"), _CallOnce(),
                                               inputs(1), inputs(2), record)
    if sms == 4:
        with pytest.raises(AssertionError, match="q4k_bf16_gemv_rows: compared at K splits"):
            run()
        return
    run()
    k5 = {(shape, ks) for name, shape, ks in rows if name == "q4k_bf16_gemv_rows"}
    k8 = {(shape, ks) for name, shape, ks in rows if name == "q8_0_bf16_gemv_rows"}
    assert {shape for shape, _ in k5} == {f"{nm} B={B}" for nm in ("gate|up", "qk", "o", "down")
                                          for B in (17, 64)}
    assert {shape for shape, _ in k8} == {f"{nm} B={B}" for nm in ("v", "down", "lm_head")
                                          for B in (17, 64)} | {"lm_head wire B=64"}
    k5_splits, k8_splits = {ks for _, ks in k5}, {ks for _, ks in k8}
    assert 1 in k5_splits and max(k5_splits) > 1 and 1 in k8_splits and max(k8_splits) > 1


def test_gguf_bf16_path_holds_the_three_kernels():
    assert chip_smoke.PATH_KERNELS["gguf_bf16"] == (
        "q5k_bf16_gemv", "q8_0_bf16_gemv", "q5k_hbit_bf16_gemv_rows", "q4k_bf16_gemv_rows",
        "q8_0_bf16_gemv_rows")
    # 20 kernels, K1, K2, K9, K10, K4, K9b, K5 and K8 counted in two
    # instantiations each
    assert len(chip_smoke.KERNEL_INFO) == 28
    # K4's 16-row instantiation: only where Q6_K is kept with bf16 activations
    assert chip_smoke.PATH_KERNELS["card_vs_cpu_q5km_bf16"] == ("q6k_bf16_gemv",)
    # K5's decode instantiation: only a Q4_K_M model with bf16 activations
    assert chip_smoke.PATH_KERNELS["card_vs_cpu_bf16_q4km"] == ("q4k_bf16_gemv",)
    for name, path in (("q4k_q8_gemv", "slice"), ("q8_0_q8_gemv", "slice"),
                       ("q5k_q8_gemv", "quant_mix"), ("affine_gemv", "q2k"),
                       ("q6k_bf16_gemv", "quant_mix"), ("q4k_bf16_gemv", "gguf_bf16"),
                       ("q8_0_bf16_gemv", "gguf_bf16")):
        assert chip_smoke.KERNEL_INFO[f"{name}_rows"] == chip_smoke.KERNEL_INFO[name]
        assert f"{name}_rows" in chip_smoke.PATH_KERNELS[path]
    # K9b: the decode instantiation (the whole Q5_K product) and the rows one
    # (the high-bit term) in two sources, for the same TPU kernel
    assert chip_smoke.KERNEL_INFO["q5k_bf16_gemv"][1] == \
        chip_smoke.KERNEL_INFO["q5k_hbit_bf16_gemv_rows"][1]
    for name in chip_smoke.PATH_KERNELS["gguf_bf16"]:
        source, replaces = chip_smoke.KERNEL_INFO[name]
        assert source.startswith("mistralrs_tpu_torch/csrc/") and replaces.startswith(
            "mistralrs_tpu/ops/quant_matmul.py:")
