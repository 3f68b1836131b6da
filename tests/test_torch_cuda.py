"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA Hopper card and nvcc; without a card they
skip. This file imports neither jax nor the JAX package, so it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import math

import pytest
import torch

from mistralrs_tpu_torch.ops import flash_attention as fa
from mistralrs_tpu_torch.ops import paged_attention as pa
from mistralrs_tpu_torch.ops import quant_matmul as qm
from mistralrs_tpu_torch.ops import ragged_attention as ra
from mistralrs_tpu_torch.ops import splash as sp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _acts(B, K, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(B, K, generator=g) * 2.0).to(dev)


@pytest.mark.parametrize("B", [1, 3, 16, 40])
@pytest.mark.parametrize("K,O", [(512, 256), (4096, 1024), (1024, 272)])
def test_q4k_q8_gemv_matches_plain(dev, B, K, O):
    g = torch.Generator(device="cpu").manual_seed(B * 7 + K)
    qs = torch.randint(0, 256, (K // 2, O), generator=g, dtype=torch.uint8).to(dev)
    scale = (torch.rand(K // 32, O, generator=g) * 0.004 + 0.001).to(dev, torch.bfloat16)
    minv = (torch.rand(K // 32, O, generator=g) * 0.002).to(dev, torch.bfloat16)
    for xdt in (torch.float32, torch.bfloat16):
        x = _acts(B, K, dev, B).to(xdt)
        got = qm.q4k_q8_gemv(x, qs, scale, minv, out_dtype=torch.float32)
        want = qm.q4k_q8_gemv_plain(x, qs, scale, minv, torch.float32)
        torch.cuda.synchronize()
        # the same int8 codes and exact int32 dots on both sides; only the
        # f32 order of the per-block scaled sums (and of xsum) differs
        tol = 1e-5 * float(want.abs().max()) + 1e-5
        assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("gs,sdt", [(32, torch.float32), (64, torch.float32),
                                    (32, torch.bfloat16), (64, torch.bfloat16)])
@pytest.mark.parametrize("B", [1, 16, 20])
@pytest.mark.parametrize("O", [512, 144])
def test_q8_0_q8_gemv_matches_plain(dev, gs, sdt, B, O):
    K = 1024
    g = torch.Generator(device="cpu").manual_seed(gs + B)
    q = torch.randint(-128, 128, (K, O), generator=g, dtype=torch.int8).to(dev)
    s = (torch.rand(K // gs, O, generator=g) * 0.01).to(dev, sdt)
    x = _acts(B, K, dev, 3).to(torch.bfloat16)
    got = qm.q8_0_q8_gemv(x, q, s, gs, out_dtype=torch.float32)
    want = qm.q8_0_q8_gemv_plain(x, q, s, gs, torch.float32)
    torch.cuda.synchronize()
    tol = 1e-5 * float(want.abs().max()) + 1e-5
    assert float((got - want).abs().max()) <= tol


# the decode instantiations of K1 and K2 (1-16 rows) at the main path's
# shapes (Mistral-7B Q4_K_M: K1's fused q|k, o, gate|up, down; K2's v, the
# rq8 down, the padded lm_head), one and two n-tiles of x rows
DECODE_B = [1, 3, 16]
K1_DECODE = [(4096, 5120), (4096, 4096), (4096, 28672), (14336, 4096)]
K2_DECODE = [(4096, 1024), (14336, 4096), (4096, 32768)]
K2_SCALES = [(32, torch.float32), (64, torch.float32), (32, torch.bfloat16), (64, torch.bfloat16)]


def _q8_arrays(dev, K, O, gs, sdt, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randint(-128, 128, (K, O), generator=g, dtype=torch.int8).to(dev)
    s = (torch.rand(K // gs, O, generator=g) * 0.01).to(dev, sdt)
    return q, s


def _within(got, want):
    """The same int8 codes and exact int32 dots on both sides; only the f32
    order of the scaled sums differs: 1e-5 of max |y|."""
    want = want.float()
    return float((got.float() - want).abs().max()) <= 1e-5 * float(want.abs().max()) + 1e-5


@pytest.mark.parametrize("out_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", DECODE_B)
@pytest.mark.parametrize("K,O", K1_DECODE)
def test_q4k_q8_gemv_decode_main_path_matches_plain(dev, K, O, B, out_dt):
    qs, scale, minv = _q4k_arrays(dev, K, O, K + O + B)
    for xdt in (torch.float32, torch.bfloat16):
        x = _acts(B, K, dev, B).to(xdt)
        got = qm.q4k_q8_gemv(x, qs, scale, minv, out_dtype=out_dt)
        want = qm.q4k_q8_gemv_plain(x, qs, scale, minv, torch.float32)
        torch.cuda.synchronize()
        if out_dt == torch.float32:
            assert _within(got, want)
        else:  # the f32 sums rounded once
            f32 = qm.q4k_q8_gemv(x, qs, scale, minv, out_dtype=torch.float32)
            assert torch.equal(got, f32.to(torch.bfloat16)) and _within(f32, want)


@pytest.mark.parametrize("out_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", DECODE_B)
@pytest.mark.parametrize("gs,sdt", K2_SCALES)
@pytest.mark.parametrize("K,O", K2_DECODE)
def test_q8_0_q8_gemv_decode_main_path_matches_plain(dev, K, O, gs, sdt, B, out_dt):
    q, s = _q8_arrays(dev, K, O, gs, sdt, K + O + gs + B)
    for xdt in (torch.float32, torch.bfloat16):
        x = _acts(B, K, dev, B + 1).to(xdt)
        got = qm.q8_0_q8_gemv(x, q, s, gs, out_dtype=out_dt)
        want = qm.q8_0_q8_gemv_plain(x, q, s, gs, torch.float32)
        torch.cuda.synchronize()
        if out_dt == torch.float32:
            assert _within(got, want)
        else:
            f32 = qm.q8_0_q8_gemv(x, q, s, gs, out_dtype=torch.float32)
            assert torch.equal(got, f32.to(torch.bfloat16)) and _within(f32, want)


@pytest.mark.parametrize("B", DECODE_B)
@pytest.mark.parametrize("gs,sdt", K2_SCALES)
@pytest.mark.parametrize("K,O", [(1024, 144), (256, 272), (128, 1024)])
def test_q8_0_q8_gemv_decode_tails_match_plain(dev, K, O, gs, sdt, B):
    """Column tails past the last 64- or 128-column tile (zero-filled boxes,
    never written) and K of a few groups (one split, or splits of 4)."""
    q, s = _q8_arrays(dev, K, O, gs, sdt, K + O + B)
    x = _acts(B, K, dev, B).to(torch.bfloat16)
    got = qm.q8_0_q8_gemv(x, q, s, gs, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert _within(got, qm.q8_0_q8_gemv_plain(x, q, s, gs, torch.float32))


def _decode_calls(dev, B):
    """One K1, K2, K3, K4, K8, K10, K5, K9 and K9b decode call at the main
    path's q|k and v shapes (K3 and K4 at the Q6_K v, in clusters of 8
    splits; K8 at the rq8 v; K10 at the Q2_K q|k; K5, K9 and K9b (the whole
    Q5_K x bf16 product) at the Q5_K q|k, in clusters of 8 splits)."""
    qs, scale, minv = _q4k_arrays(dev, 4096, 5120, 1)
    q, s = _q8_arrays(dev, 4096, 1024, 32, torch.float32, 2)
    ql, qh, s6 = _q6k_span_arrays(dev, 4096, 1024, 512, 4)
    q2, s2, z2 = _affine_arrays(dev, 2, 16, 4096, 5120, 6)
    q5s, q5h, s5, m5 = _q5k_arrays(dev, 4096, 5120, 7)
    x = _acts(B, 4096, dev, 3).to(torch.bfloat16)
    return (lambda: qm.q4k_q8_gemv(x, qs, scale, minv, out_dtype=torch.float32),
            lambda: qm.q8_0_q8_gemv(x, q, s, 32, out_dtype=torch.float32),
            lambda: qm.q6k_q8_gemv(x, ql, qh, s6, 512, out_dtype=torch.float32),
            lambda: qm.q6k_bf16_gemv(x, ql, qh, s6, 512, out_dtype=torch.float32),
            lambda: qm.q8_0_bf16_gemv(x, q, s, out_dtype=torch.float32),
            lambda: qm.affine_gemv(x, q2, s2, z2, 2, 16, out_dtype=torch.float32),
            lambda: qm.q4k_bf16_gemv(x, q5s, s5, m5, out_dtype=torch.float32),
            lambda: qm.q5k_q8_gemv(x, q5s, q5h, s5, m5, out_dtype=torch.float32),
            lambda: qm.q5k_bf16_gemv(x, q5s, q5h, s5, m5, out_dtype=torch.float32))


@pytest.mark.parametrize("B", [1, 16])
def test_decode_gemv_is_bit_equal_on_repeat(dev, B):
    """The K splits of a column tile add their sums in the order of their
    cluster ranks, so a result does not depend on which block ran first."""
    for call in _decode_calls(dev, B):
        first = call()
        for _ in range(3):
            assert torch.equal(call(), first)


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4", "k8", "k10", "k5", "k9", "k9b"])
def test_decode_gemv_is_bit_equal_over_many_calls(dev, kernel):
    """1,000 calls at the down projection (14336 -> 4096, clusters of 8
    splits; K8 on rq8 weights, K10 on GPTQ-8 at group 128, K5, K9 and K9b's
    decode instantiation on Q5_K arrays), 16 rows, the L2
    flushed before every other call, each bit-equal to the first: a
    consumer's reads of a ring stage are ordered before the copies that
    refill it (without the decode ring's proxy fence K4 gave another result
    in about one call of 400)."""
    K, O = 14336, 4096
    x = _acts(16, K, dev, 5).to(torch.bfloat16)
    if kernel == "k1":
        qs, scale, minv = _q4k_arrays(dev, K, O, 6)
        call = lambda: qm.q4k_q8_gemv(x, qs, scale, minv)  # noqa: E731
    elif kernel == "k2":
        q, s = _q8_arrays(dev, K, O, 32, torch.float32, 6)
        call = lambda: qm.q8_0_q8_gemv(x, q, s, 32)  # noqa: E731
    elif kernel == "k8":
        q, s = _q8_arrays(dev, K, O, 32, torch.float32, 6)
        call = lambda: qm.q8_0_bf16_gemv(x, q, s)  # noqa: E731
    elif kernel == "k10":
        q, scale, zs = _affine_arrays(dev, 8, 128, K, O, 6)
        call = lambda: qm.affine_gemv(x, q, scale, zs, 8, 128)  # noqa: E731
    elif kernel in ("k5", "k9", "k9b"):
        qs, qh, scale, minv = _q5k_arrays(dev, K, O, 6)
        call = {"k5": lambda: qm.q4k_bf16_gemv(x, qs, scale, minv),
                "k9": lambda: qm.q5k_q8_gemv(x, qs, qh, scale, minv),
                "k9b": lambda: qm.q5k_bf16_gemv(x, qs, qh, scale, minv)}[kernel]
    else:
        ql, qh, s6 = _q6k_span_arrays(dev, K, O, 512, 6)
        fn = qm.q6k_q8_gemv if kernel == "k3" else qm.q6k_bf16_gemv
        call = lambda: fn(x, ql, qh, s6, 512)  # noqa: E731
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    first = call()
    outs = []
    for i in range(1000):
        if i % 2:
            flush.zero_()
        outs.append(call())
    torch.cuda.synchronize()
    assert sum(not torch.equal(o, first) for o in outs) == 0


@pytest.mark.parametrize("B", [1, 16])
def test_decode_gemv_replays_in_a_cuda_graph(dev, B):
    """A decode call captured in a CUDA graph (K1, K2, K3, K9: the quantize
    kernel, then the GEMV behind it by programmatic dependent launch; K4,
    K5, K8, K10, K9b: the GEMV alone) replays bit-equal to
    eager, and nothing in it waits for the card (sync debug mode "error"
    around the capture and the replay)."""
    for call in _decode_calls(dev, B):
        eager = call()
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()  # warm-up on a side stream, as torch.cuda.graphs asks
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.graph(graph):
                out = call()
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_decode_gemv_counts_one_launch_a_call(dev):
    """The decode counters count calls of the decode instantiations (the
    rows counters stay)."""
    k1, k2, k3, k4, k8, k10, k5, k9, k9b = _decode_calls(dev, 16)

    def counts():
        return (qm.q4k_q8_gemv_launches, qm.q4k_q8_gemv_rows_launches,
                qm.q8_0_q8_gemv_launches, qm.q8_0_q8_gemv_rows_launches,
                qm.q6k_q8_gemv_launches, qm.q6k_bf16_gemv_launches,
                qm.q6k_bf16_gemv_rows_launches, qm.q8_0_bf16_gemv_launches,
                qm.q8_0_bf16_gemv_rows_launches, qm.affine_gemv_launches,
                qm.affine_gemv_rows_launches, qm.q4k_bf16_gemv_launches,
                qm.q4k_bf16_gemv_rows_launches, qm.q5k_q8_gemv_launches,
                qm.q5k_q8_gemv_rows_launches, qm.q5k_bf16_gemv_launches,
                qm.q5k_hbit_bf16_gemv_rows_launches)

    before = counts()
    k1()
    k2()
    k2()
    k3()
    k4()
    k4()
    k4()
    k8()
    k8()
    k10()
    k5()
    k5()
    k9()
    k9b()
    k9b()
    k9b()
    assert [a - b for a, b in zip(counts(), before)] == [1, 0, 2, 0, 1, 3, 0, 2, 0, 1, 0, 2, 0,
                                                         1, 0, 3, 0]


# the kernels the card runs for one call of K5, of K9 and of K9b's decode
# instantiation at 1-16 rows, from a torch.profiler trace in a process of its
# own (a second profiler session in one process can come back empty): K5 the
# GEMV alone, K9 the quantize kernel and the GEMV, K9b the whole Q5_K x bf16
# product alone, called by itself and by the dispatcher (q5k_matmul with
# int8_act off)
_KERNELS_A_CALL = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from mistralrs_tpu_torch.ops import quant_matmul as qm
from mistralrs_tpu_torch.quant.qlinear import Linear
dev = torch.device("cuda")
g = torch.Generator(device="cpu").manual_seed(0)
out = {}
for name, K, O in (("qk", 4096, 5120), ("gate|up", 4096, 28672), ("down", 14336, 4096)):
    qs = torch.randint(0, 256, (K // 2, O), generator=g, dtype=torch.uint8).to(dev)
    qh = torch.randint(0, 256, (K // 8, O), generator=g, dtype=torch.uint8).to(dev)
    sc = (torch.rand(K // 32, O, generator=g) * 0.004 + 0.001).to(dev, torch.bfloat16)
    mn = (torch.rand(K // 32, O, generator=g) * 0.002).to(dev, torch.bfloat16)
    for B in (1, 16):
        x = torch.randn(B, K, generator=g).to(dev, torch.bfloat16)
        out[f"k5 {name} B={B}"] = cs.kernels_a_call(lambda: qm.q4k_bf16_gemv(x, qs, sc, mn))
        out[f"k9 {name} B={B}"] = cs.kernels_a_call(lambda: qm.q5k_q8_gemv(x, qs, qh, sc, mn))
        out[f"k9b {name} B={B}"] = cs.kernels_a_call(lambda: qm.q5k_bf16_gemv(x, qs, qh, sc, mn))
        lin = Linear("gguf_q5k", (K, O), {"qs": qs, "qh": qh, "scale": sc, "minv": mn},
                     int8_act=False)
        out[f"k9b route {name} B={B}"] = cs.kernels_a_call(lambda: qm.q5k_matmul(lin, x))
print(json.dumps(out))
"""


def test_k5_and_k9_decode_calls_launch_one_and_two_kernels(dev):
    """At 1 and 16 rows and the Q5_K q|k, gate|up (one split) and down
    (clusters of 8) shapes, a K5 call runs one kernel on the card (no sums
    kernel, no split-K pass), a K9 call two (the quantize kernel and the
    GEMV; no split-K pass) and a K9b decode call one, alone and through
    q5k_matmul with int8_act off (no K5, no high-bit kernel, no add):
    kernel events of a torch.profiler trace."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    r = subprocess.run([sys.executable, "-c", _KERNELS_A_CALL, root], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    per_call = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(per_call) == 24
    for key, n in per_call.items():
        assert n == (2 if key.startswith("k9 ") else 1), (key, n)


# the rows instantiations of K1 and K2 (17-256 rows): one and two row tiles
# of 64 and 128, their edges (150 and 192: a second 128-row tile that B
# rounded up to 64 does not cover), and column tails that are not multiples
# of 128
ROWS_B = [17, 63, 64, 65, 128, 150, 192, 200, 256]
ROWS_K = [1024, 4096, 14336]
ROWS_O = [256, 272, 144]


def _q4k_arrays(dev, K, O, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    qs = torch.randint(0, 256, (K // 2, O), generator=g, dtype=torch.uint8).to(dev)
    scale = (torch.rand(K // 32, O, generator=g) * 0.004 + 0.001).to(dev, torch.bfloat16)
    minv = (torch.rand(K // 32, O, generator=g) * 0.002).to(dev, torch.bfloat16)
    return qs, scale, minv


@pytest.mark.parametrize("B", ROWS_B)
@pytest.mark.parametrize("K", ROWS_K)
@pytest.mark.parametrize("O", ROWS_O)
def test_q4k_q8_gemv_rows_matches_plain(dev, B, K, O):
    qs, scale, minv = _q4k_arrays(dev, K, O, B + K + O)
    for xdt in (torch.float32, torch.bfloat16):
        x = _acts(B, K, dev, B).to(xdt)
        got = qm.q4k_q8_gemv(x, qs, scale, minv, out_dtype=torch.float32)
        want = qm.q4k_q8_gemv_plain(x, qs, scale, minv, torch.float32)
        torch.cuda.synchronize()
        # exact int32 dots on both sides; only the f32 order of the scaled sums differs
        tol = 1e-5 * float(want.abs().max()) + 1e-5
        assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("gs,sdt", [(32, torch.float32), (64, torch.float32),
                                    (32, torch.bfloat16), (64, torch.bfloat16)])
@pytest.mark.parametrize("B", ROWS_B)
@pytest.mark.parametrize("K", ROWS_K)
@pytest.mark.parametrize("O", ROWS_O)
def test_q8_0_q8_gemv_rows_matches_plain(dev, gs, sdt, B, K, O):
    g = torch.Generator(device="cpu").manual_seed(gs + B + K + O)
    q = torch.randint(-128, 128, (K, O), generator=g, dtype=torch.int8).to(dev)
    s = (torch.rand(K // gs, O, generator=g) * 0.01).to(dev, sdt)
    for xdt in (torch.float32, torch.bfloat16):
        x = _acts(B, K, dev, 3).to(xdt)
        got = qm.q8_0_q8_gemv(x, q, s, gs, out_dtype=torch.float32)
        want = qm.q8_0_q8_gemv_plain(x, q, s, gs, torch.float32)
        torch.cuda.synchronize()
        tol = 1e-5 * float(want.abs().max()) + 1e-5
        assert float((got - want).abs().max()) <= tol


# shapes that the plan runs in one K split, where nothing follows x's pieces
# in the workspace: K of 4 K steps, and the main path's gate|up and lm_head;
# K9 and K10 (Q2_K, group 16) at gate|up
ONE_SPLIT = [("k1", 256, 272, 32), ("k1", 4096, 28672, 32), ("k2", 128, 272, 32),
             ("k2", 256, 144, 64), ("k2", 4096, 32768, 32), ("k9", 4096, 28672, 32),
             ("k10", 4096, 28672, 16)]


@pytest.mark.parametrize("kernel,K,O,gs", ONE_SPLIT)
@pytest.mark.parametrize("B", [150, 192, 256])
def test_rows_one_split_matches_plain(dev, kernel, K, O, gs, B):
    """One K split (the kernel writes out itself): within the tolerance of
    the plain version (K10: 1e-4, bf16 products), and bit-equal on repeat."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x = _acts(B, K, dev, B + K).to(torch.bfloat16)
    tol_rel = 1e-5
    if kernel in ("k1", "k9"):
        assert qm.int8_gemv_plan(B, K, O, K // 64, gs, 32, sms).ksplit == 1
        if kernel == "k1":
            qs, scale, minv = _q4k_arrays(dev, K, O, B + O)
            run = lambda: qm.q4k_q8_gemv(x, qs, scale, minv, out_dtype=torch.float32)
            want = qm.q4k_q8_gemv_plain(x, qs, scale, minv, torch.float32)
        else:
            assert qm.q5k_q8_plan(B, K, O, sms).ksplit == 1
            qs, qh, scale, minv = _q5k_arrays(dev, K, O, B + O)
            run = lambda: qm.q5k_q8_gemv(x, qs, qh, scale, minv, out_dtype=torch.float32)
            want = qm.q5k_q8_gemv_plain(x, qs, qh, scale, minv, torch.float32)
    elif kernel == "k2":
        assert qm.int8_gemv_plan(B, K, O, K // gs, gs, 0, sms).ksplit == 1
        g = torch.Generator(device="cpu").manual_seed(B + O)
        q = torch.randint(-128, 128, (K, O), generator=g, dtype=torch.int8).to(dev)
        s = (torch.rand(K // gs, O, generator=g) * 0.01).to(dev)
        run = lambda: qm.q8_0_q8_gemv(x, q, s, gs, out_dtype=torch.float32)
        want = qm.q8_0_q8_gemv_plain(x, q, s, gs, torch.float32)
    else:
        assert qm.plane_gemv_plan(B, K, O, 2, gs, sms).ksplit == 1
        q, scale, zs = _affine_arrays(dev, 2, gs, K, O, B + O)
        run = lambda: qm.affine_gemv(x, q, scale, zs, 2, gs, out_dtype=torch.float32)
        want = qm.affine_gemv_plain(x, q, scale, zs, 2, gs, torch.float32)
        tol_rel = 1e-4
    got, again = run(), run()
    torch.cuda.synchronize()
    tol = tol_rel * float(want.abs().max()) + 1e-5
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, again)


def test_rows_instantiations_count_apart(dev):
    """At 64 rows K1, K2, K9 and K10 launch their rows instantiations (and
    bf16 out matches the f32 one rounded); the 16-row counters stay."""
    K, O, B = 1024, 256, 64
    qs, scale, minv = _q4k_arrays(dev, K, O, 1)
    q = torch.randint(-128, 128, (K, O), dtype=torch.int8, device=dev)
    s = torch.rand(K // 32, O, device=dev) * 0.01
    qs5, qh5, s5, m5 = _q5k_arrays(dev, K, O, 3)
    q2, s2, z2 = _affine_arrays(dev, 2, 16, K, O, 4)
    x = _acts(B, K, dev, 2).to(torch.bfloat16)
    names = ("q4k_q8_gemv", "q8_0_q8_gemv", "q5k_q8_gemv", "affine_gemv")

    def counts():
        return [getattr(qm, f"{n}{r}_launches") for n in names for r in ("", "_rows")]

    calls = (lambda dt: qm.q4k_q8_gemv(x, qs, scale, minv, out_dtype=dt),
             lambda dt: qm.q8_0_q8_gemv(x, q, s, 32, out_dtype=dt),
             lambda dt: qm.q5k_q8_gemv(x, qs5, qh5, s5, m5, out_dtype=dt),
             lambda dt: qm.affine_gemv(x, q2, s2, z2, 2, 16, out_dtype=dt))
    before = counts()
    ys = [call(torch.bfloat16) for call in calls]
    assert [a - b for a, b in zip(counts(), before)] == [0, 1] * 4
    fs = [call(torch.float32) for call in calls]
    torch.cuda.synchronize()
    for y, f in zip(ys, fs):
        assert y.dtype == torch.bfloat16 and torch.equal(y, f.to(torch.bfloat16))


@pytest.mark.parametrize("B,T,Hq,Hkv", [(1, 128, 4, 2), (2, 200, 8, 2), (1, 64, 4, 4),
                                        (1, 1, 2, 1), (4, 512, 32, 8),
                                        # around the 128-row query and key tiles,
                                        # and 1, 4 and 16 query heads a kv head
                                        (2, 1, 8, 8), (1, 127, 8, 2), (2, 129, 16, 4),
                                        (1, 384, 32, 8), (1, 1024, 16, 1)])
def test_flash_prefill_matches_plain(dev, B, T, Hq, Hkv):
    g = torch.Generator(device="cpu").manual_seed(T + Hq)
    q = torch.randn(B, T, Hq, 128, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(B, T, Hkv, 128, generator=g).to(dev, torch.bfloat16)
    v = torch.randn(B, T, Hkv, 128, generator=g).to(dev, torch.bfloat16)
    got = fa.flash_prefill(q, k, v, 128 ** -0.5).float()
    want = fa.flash_prefill_plain(q, k, v, 128 ** -0.5).float()
    torch.cuda.synchronize()
    # both round the f32 result to bf16 once (2^-8 relative); the kernel also
    # rounds P to bf16 before P.V (2^-8 relative per weight, averaging out
    # over the keys), and its f32 sums run in another order
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


def _launch_counts():
    """Every launch counter of the kernels' wrappers (ops/*.py)."""
    import importlib
    import pkgutil

    import mistralrs_tpu_torch.ops as ops

    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"mistralrs_tpu_torch.ops.{info.name}")
        for name, val in vars(mod).items():
            if name.endswith("_launches") and isinstance(val, int):
                out[f"{info.name}.{name}"] = val
    return out


def test_flash_prefill_call_launches_one_kernel(dev):
    g = torch.Generator(device="cpu").manual_seed(3)
    q = torch.randn(2, 300, 8, 128, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(2, 300, 2, 128, generator=g).to(dev, torch.bfloat16)
    before = _launch_counts()
    fa.flash_prefill(q, k, k, 128 ** -0.5)
    torch.cuda.synchronize()
    after = _launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == \
        {"flash_attention.flash_prefill_launches": 1}


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros(2, 96, dtype=torch.bfloat16, device=dev)  # K % 64 != 0
    with pytest.raises(ValueError):
        qm.q4k_q8_gemv(x, torch.zeros(48, 8, dtype=torch.uint8, device=dev),
                       torch.zeros(3, 8, dtype=torch.bfloat16, device=dev),
                       torch.zeros(3, 8, dtype=torch.bfloat16, device=dev))
    x = torch.zeros(2, 128, dtype=torch.bfloat16, device=dev)[:, ::2]  # not contiguous
    with pytest.raises(ValueError):
        qm.q8_0_q8_gemv(x, torch.zeros(64, 8, dtype=torch.int8, device=dev),
                        torch.zeros(2, 8, device=dev), 32)
    q = torch.zeros(1, 4, 2, 128, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        fa.flash_prefill(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous(), 1.0)


@pytest.mark.parametrize("K,O", [(512, 256), (1024, 272)])
def test_dequant_kernels_match_plain_exactly(dev, K, O):
    """The prefill route's dequantization rounds as the plain bf16 ops do."""
    g = torch.Generator(device="cpu").manual_seed(K + O)
    qs = torch.randint(0, 256, (K // 2, O), generator=g, dtype=torch.uint8).to(dev)
    scale = (torch.rand(K // 32, O, generator=g) * 0.004 + 0.001).to(dev, torch.bfloat16)
    minv = (torch.rand(K // 32, O, generator=g) * 0.002).to(dev, torch.bfloat16)
    got = qm.q4k_dequant(qs, scale, minv, torch.bfloat16)
    assert torch.equal(got, qm.q4k_dequant_plain(qs, scale, minv, torch.bfloat16))
    q = torch.randint(-128, 128, (K, O), generator=g, dtype=torch.int8).to(dev)
    for gs, sdt in ((32, torch.float32), (64, torch.float32), (32, torch.bfloat16)):
        s = (torch.rand(K // gs, O, generator=g) * 0.01).to(dev, sdt)
        got = qm.q8_0_dequant(q, s, gs, torch.bfloat16)
        assert torch.equal(got, qm.q8_0_dequant_plain(q, s, gs, torch.bfloat16))


def _q6k_arrays(dev, K, O, seed):
    from mistralrs_tpu_torch.quant.gguf_linear import q6k_chunk_size

    g = torch.Generator(device="cpu").manual_seed(seed)
    ql = torch.randint(0, 256, (K // 2, O), generator=g, dtype=torch.uint8).to(dev)
    qh = torch.randint(0, 256, (K // 4, O), generator=g, dtype=torch.uint8).to(dev)
    scale = (torch.randn(K // 16, O, generator=g) * 0.003).to(dev, torch.bfloat16)
    return ql, qh, scale, q6k_chunk_size(K)


def _q5k_arrays(dev, K, O, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    qs = torch.randint(0, 256, (K // 2, O), generator=g, dtype=torch.uint8).to(dev)
    qh = torch.randint(0, 256, (K // 8, O), generator=g, dtype=torch.uint8).to(dev)
    scale = (torch.rand(K // 32, O, generator=g) * 0.004 + 0.001).to(dev, torch.bfloat16)
    minv = (torch.rand(K // 32, O, generator=g) * 0.002).to(dev, torch.bfloat16)
    return qs, qh, scale, minv


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


# K3's and K4's decode instantiations (1-16 rows): spans G of 128, 256 and
# 512, 272 columns (a partial column tile) in clusters of 4 and of 8 (the
# full cluster), and a one-split shape whose 199 column tiles of 128 (the
# last partial) fill the card; one and two n-tiles of x rows and their edges
Q6K_DEC_B = [1, 2, 5, 8, 9, 16]
Q6K_DEC_SHAPES = [(512, 272, 128), (2048, 272, 256), (4096, 272, 512), (1024, 25360, 256)]


def _q6k_span_arrays(dev, K, O, G, seed):
    ql, qh, scale, _ = _q6k_arrays(dev, K, O, seed)
    assert K % (4 * G) == 0
    return ql, qh, scale


@pytest.mark.parametrize("B", Q6K_DEC_B + [17, 256])
@pytest.mark.parametrize("K,O,G", Q6K_DEC_SHAPES)
def test_q6k_q8_gemv_matches_plain(dev, B, K, O, G):
    """K3: the same int8 codes and exact per-16 dots on both sides, f32 sums
    in another order (1e-5 of max |y|); bit-equal on a repeat (the K splits
    add in rank order), one count a call, the bf16 output the f32 one
    rounded. Above 16 rows it raises, as the JAX package routes K3 only up
    to 16."""
    ql, qh, scale = _q6k_span_arrays(dev, K, O, G, B + K)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = qm.q6k_q8_plan(min(B, 16), K, O, G, sms)
    assert plan.ksplit in ((1,) if O > 20000 else (4, 8)), plan
    for xdt in (torch.float32, torch.bfloat16):
        x = _acts(B, K, dev, B).to(xdt)
        if B > 16:
            with pytest.raises(ValueError):
                qm.q6k_q8_gemv(x, ql, qh, scale, G, out_dtype=torch.float32)
            continue
        before = qm.q6k_q8_gemv_launches
        got = qm.q6k_q8_gemv(x, ql, qh, scale, G, out_dtype=torch.float32)
        again = qm.q6k_q8_gemv(x, ql, qh, scale, G, out_dtype=torch.float32)
        y16 = qm.q6k_q8_gemv(x, ql, qh, scale, G)
        want = qm.q6k_q8_gemv_plain(x, ql, qh, scale, G, torch.float32)
        torch.cuda.synchronize()
        assert qm.q6k_q8_gemv_launches == before + 3
        assert bool(torch.isfinite(got).all()) and _rel_err(got, want) <= 1e-5, plan
        assert torch.equal(got, again) and torch.equal(y16, got.to(torch.bfloat16))


@pytest.mark.parametrize("B", Q6K_DEC_B + [17, 256])
@pytest.mark.parametrize("K,O,G", Q6K_DEC_SHAPES)
def test_q6k_bf16_gemv_matches_plain(dev, B, K, O, G):
    """K4: the same bf16(q * s16) weights on both sides; f32 sums of bf16
    products in another order (1e-4 of max |y|); bit-equal on a repeat, one
    count a call. Up to 16 rows its decode instantiation, above its rows
    instantiation."""
    ql, qh, scale = _q6k_span_arrays(dev, K, O, G, B + K + 1)
    x = _acts(B, K, dev, B + 1).to(torch.bfloat16)
    before = (qm.q6k_bf16_gemv_launches, qm.q6k_bf16_gemv_rows_launches)
    got = qm.q6k_bf16_gemv(x, ql, qh, scale, G, out_dtype=torch.float32)
    again = qm.q6k_bf16_gemv(x, ql, qh, scale, G, out_dtype=torch.float32)
    want = qm.q6k_bf16_gemv_plain(x, ql, qh, scale, G, torch.float32)
    torch.cuda.synchronize()
    assert (qm.q6k_bf16_gemv_launches - before[0],
            qm.q6k_bf16_gemv_rows_launches - before[1]) == ((2, 0) if B <= 16 else (0, 2))
    assert bool(torch.isfinite(got).all()) and _rel_err(got, want) <= 1e-4
    assert torch.equal(got, again)


# the 16-row kernels' row counts, then the rows instantiations' (one and two
# row tiles of 64 and 128, and their edges)
K9_K10_B = [1, 5, 16, 17, 64, 65, 128, 129, 200, 256]


@pytest.mark.parametrize("B", K9_K10_B)
@pytest.mark.parametrize("K,O", [(512, 256), (4096, 272), (14336, 128)])
def test_q5k_q8_gemv_matches_plain(dev, B, K, O):
    """K9 (the decode instantiation up to 16 rows, the rows instantiation
    above): exact int32 dots on both sides, f32 sums in another order."""
    qs, qh, scale, minv = _q5k_arrays(dev, K, O, B + K)
    for xdt in (torch.float32, torch.bfloat16):
        x = _acts(B, K, dev, B).to(xdt)
        before = (qm.q5k_q8_gemv_launches, qm.q5k_q8_gemv_rows_launches)
        got = qm.q5k_q8_gemv(x, qs, qh, scale, minv, out_dtype=torch.float32)
        want = qm.q5k_q8_gemv_plain(x, qs, qh, scale, minv, torch.float32)
        torch.cuda.synchronize()
        assert (qm.q5k_q8_gemv_launches - before[0], qm.q5k_q8_gemv_rows_launches - before[1]) == (
            (1, 0) if B <= 16 else (0, 1))
        assert _rel_err(got, want) <= 1e-5


# K5's and K9's decode instantiations at the main path's Q5_K shapes (q|k,
# o and down in clusters of 8 splits, gate|up in one) and one and two
# n-tiles of x rows
K5_K9_DECODE_SHAPES = [(4096, 5120), (4096, 4096), (4096, 28672), (14336, 4096)]


@pytest.mark.parametrize("B", [1, 4, 9, 16])
@pytest.mark.parametrize("K,O", K5_K9_DECODE_SHAPES)
def test_k5_k9_decode_main_path_matches_plain(dev, K, O, B):
    """K5 (within 1e-4 of max |y|: bf16 products summed in another order,
    the scale on each sub-block's f32 dot) and K9 (within 1e-5: exact int32
    dots, f32 sums in another order) against their plain versions, f32
    and bf16 out, one decode count a call each."""
    qs, qh, scale, minv = _q5k_arrays(dev, K, O, K + O + B)
    x = _acts(B, K, dev, B).to(torch.bfloat16)
    for out_dt in (torch.float32, torch.bfloat16):
        before = (qm.q4k_bf16_gemv_launches, qm.q5k_q8_gemv_launches)
        y5 = qm.q4k_bf16_gemv(x, qs, scale, minv, out_dtype=out_dt)
        y9 = qm.q5k_q8_gemv(x, qs, qh, scale, minv, out_dtype=out_dt)
        torch.cuda.synchronize()
        assert (qm.q4k_bf16_gemv_launches - before[0], qm.q5k_q8_gemv_launches - before[1]) == (
            1, 1)
        want5 = qm.q4k_bf16_gemv_plain(x, qs, scale, minv, torch.float32)
        want9 = qm.q5k_q8_gemv_plain(x, qs, qh, scale, minv, torch.float32)
        assert y5.dtype == y9.dtype == out_dt
        assert bool(torch.isfinite(y5).all()) and bool(torch.isfinite(y9).all())
        if out_dt == torch.float32:
            assert _rel_err(y5, want5) <= 1e-4
            assert _within(y9, want9)
        else:  # one bf16 rounding of the f32 result
            assert _rel_err(y5.float(), want5) <= 1e-2 and _rel_err(y9.float(), want9) <= 1e-2


@pytest.mark.parametrize("K,O", [(512, 256), (1024, 272), (4096, 128)])
def test_q56k_dequant_kernels_match_plain_exactly(dev, K, O):
    ql, qh, scale, G = _q6k_arrays(dev, K, O, K + O)
    for dt in (torch.bfloat16, torch.float32):
        got = qm.q6k_dequant(ql, qh, scale, G, dt)
        assert got.dtype == dt
        assert torch.equal(got, qm.q6k_dequant_plain(ql, qh, scale, G, dt))
    qs, qh5, s5, m5 = _q5k_arrays(dev, K, O, K + O + 1)
    got = qm.q5k_dequant(qs, qh5, s5, m5, torch.bfloat16)
    assert torch.equal(got, qm.q5k_dequant_plain(qs, qh5, s5, m5, torch.bfloat16))


def test_q6k_linear_at_prefill_rows_runs_k4(dev):
    """A gguf_q6k Linear on 2 x 128 rows (G = 128) goes through K4's rows
    instantiation on the card: no NotImplementedError, no torch.matmul;
    above 256 rows the dequant route."""
    from mistralrs_tpu_torch.quant.gguf_linear import q6k_perm
    from mistralrs_tpu_torch.quant.qlinear import Linear, linear

    K, O = 512, 256
    ql, qh, scale, G = _q6k_arrays(dev, K, O, 6)
    perm = torch.from_numpy(q6k_perm(K, G))
    lin = Linear("gguf_q6k", (K, O), {"ql": ql, "qh": qh, "scale": scale, "perm": perm.to(dev),
                                      "inv_perm": torch.argsort(perm).to(dev)}, meta=G)
    x = _acts(256, K, dev, 4).to(torch.bfloat16).reshape(2, 128, K)
    k4, deq = qm.q6k_bf16_gemv_rows_launches, qm.q6k_dequant_launches
    y = linear(lin, x)
    torch.cuda.synchronize()
    assert qm.q6k_bf16_gemv_rows_launches == k4 + 1 and qm.q6k_dequant_launches == deq
    want = qm.q6k_bf16_gemv_plain(x.reshape(256, K), ql, qh, scale, G, torch.float32)
    assert y.shape == (2, 128, O) and _rel_err(y.reshape(256, O).float(), want) <= 1e-2
    y = linear(lin, _acts(257, K, dev, 5).to(torch.bfloat16))
    assert qm.q6k_dequant_launches == deq + 1
    assert y.shape == (257, O) and bool(torch.isfinite(y).all())


# K4's rows instantiation (17-256 rows) at the Q5_K_M path's Q6_K shapes
# (G = 512: v with 8 K splits at 256 rows, down with 2, the lm_head with 1)
# and at the spans 128 and 256 (two chunks, a column tail)
K4_ROWS_SHAPES = [(4096, 1024), (14336, 4096), (4096, 32768), (1024, 272), (2048, 256)]
ROWS_ONLY_B = [17, 65, 129, 200, 256]
# K9b's rows instantiation at the Q5_K projections (gate|up with one K split
# at 256 rows, q|k, o and down with more) and a column tail
K9B_ROWS_SHAPES = [(4096, 28672), (4096, 5120), (4096, 4096), (14336, 4096), (512, 272)]


def _q3k_arrays(dev, K, O, seed):
    """Q3_K's codes (28..35) packed in Q6_K's layout, as pack_q3k does."""
    from mistralrs_tpu_torch.quant.gguf_linear import q6k_chunk_size

    G = q6k_chunk_size(K)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randint(28, 36, (K, O), generator=g, dtype=torch.uint8)
    C = K // (4 * G)
    ln, hb = (q & 0xF).reshape(4, C, G, O), (q >> 4).reshape(4, C, G, O)
    ql = torch.cat([ln[0] | ln[2] << 4, ln[1] | ln[3] << 4], dim=1).reshape(K // 2, O)
    qh = (hb[0] | hb[1] << 2 | hb[2] << 4 | hb[3] << 6).reshape(K // 4, O)
    scale = (torch.rand(K // 16, O, generator=g) * 0.004 + 0.001).to(torch.bfloat16)
    return ql.to(dev), qh.to(dev), scale.to(dev), G


@pytest.mark.parametrize("q3k", [False, True])
@pytest.mark.parametrize("B", ROWS_ONLY_B)
@pytest.mark.parametrize("K,O", K4_ROWS_SHAPES)
def test_q6k_bf16_gemv_rows_matches_plain(dev, K, O, B, q3k):
    """K4's rows instantiation with one K split and with many, on random
    Q6_K codes and on Q3_K's (28..35): within 1e-4 of max |y| of the plain
    version, bit-equal on repeat, bf16 out the f32 out rounded once."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ql, qh, scale, G = (_q3k_arrays if q3k else _q6k_arrays)(dev, K, O, B + K + O)
    plan = qm.q6k_bf16_plan(B, K, O, G, sms)
    assert plan.rows in (64, 128)
    x = _acts(B, K, dev, B + 3).to(torch.bfloat16)
    before = (qm.q6k_bf16_gemv_launches, qm.q6k_bf16_gemv_rows_launches)
    got = qm.q6k_bf16_gemv(x, ql, qh, scale, G, out_dtype=torch.float32)
    again = qm.q6k_bf16_gemv(x, ql, qh, scale, G, out_dtype=torch.float32)
    y16 = qm.q6k_bf16_gemv(x, ql, qh, scale, G)
    want = qm.q6k_bf16_gemv_plain(x, ql, qh, scale, G, torch.float32)
    torch.cuda.synchronize()
    assert (qm.q6k_bf16_gemv_launches - before[0],
            qm.q6k_bf16_gemv_rows_launches - before[1]) == (0, 3)
    assert bool(torch.isfinite(got).all()) and _rel_err(got, want) <= 1e-4, plan
    assert torch.equal(got, again)
    assert torch.equal(y16, got.to(torch.bfloat16))


@pytest.mark.parametrize("K,O", [(1024, 272), (4096, 1024)])
def test_q6k_rows_decode_is_bit_equal_to_the_plain_weight(dev, K, O):
    """One-hot rows of x read single weights: with x = e_k the rows kernel's
    f32 out is bf16(q * s16) - 32 * s16 exactly (both terms exact in f32),
    the plain version's bit for bit, for every element k of every span and
    chunk."""
    ql, qh, scale, G = _q6k_arrays(dev, K, O, K + 1)
    for k0 in range(0, K, 256):
        x = torch.zeros(256, K, dtype=torch.bfloat16, device=dev)
        x[torch.arange(256), k0 + torch.arange(256)] = 1.0
        got = qm.q6k_bf16_gemv(x, ql, qh, scale, G, out_dtype=torch.float32)
        want = qm.q6k_bf16_gemv_plain(x, ql, qh, scale, G, torch.float32)
        assert torch.equal(got, want), k0


@pytest.mark.parametrize("B", ROWS_ONLY_B)
@pytest.mark.parametrize("K,O", K9B_ROWS_SHAPES)
def test_q5k_hbit_bf16_gemv_rows_matches_plain(dev, K, O, B):
    """K9b's rows instantiation (no zs term) with one K split and with
    many: within 1e-4 of max |y| of the plain version (the weights s or 0
    are exact), bit-equal on repeat, bf16 out the f32 out rounded once."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, qh, scale, _ = _q5k_arrays(dev, K, O, B + K + O)
    plan = qm.q5k_hbit_bf16_plan(B, K, O, sms)
    assert plan.rows in (64, 128)
    x = _acts(B, K, dev, B + 4).to(torch.bfloat16)
    before = qm.q5k_hbit_bf16_gemv_rows_launches
    got = qm.q5k_hbit_bf16_gemv(x, qh, scale, out_dtype=torch.float32)
    again = qm.q5k_hbit_bf16_gemv(x, qh, scale, out_dtype=torch.float32)
    y16 = qm.q5k_hbit_bf16_gemv(x, qh, scale)
    want = qm.q5k_hbit_bf16_gemv_plain(x, qh, scale, torch.float32)
    torch.cuda.synchronize()
    assert qm.q5k_hbit_bf16_gemv_rows_launches - before == 3
    assert bool(torch.isfinite(got).all()) and _rel_err(got, want) <= 1e-4, plan
    assert torch.equal(got, again)
    assert torch.equal(y16, got.to(torch.bfloat16))


def test_k4_k9b_rows_count_apart(dev):
    """At 16 rows K4 launches its 16-row instantiation and K9b's high-bit
    kernel raises (at 1-16 rows the whole Q5_K product is K9b's decode
    instantiation), at 17 their rows instantiations, each counted apart;
    the Q5_K bf16 route at 64 rows launches K5's and K9b's rows
    instantiations, at 16 K9b's decode instantiation alone."""
    from mistralrs_tpu_torch.quant.qlinear import Linear

    K, O = 1024, 256
    ql, qh6, s6, G = _q6k_arrays(dev, K, O, 1)
    qs, qh5, s5, m5 = _q5k_arrays(dev, K, O, 2)

    def counts():
        return [qm.q6k_bf16_gemv_launches, qm.q6k_bf16_gemv_rows_launches,
                qm.q5k_bf16_gemv_launches, qm.q5k_hbit_bf16_gemv_rows_launches]

    for B, want in ((16, [1, 0, 0, 0]), (17, [0, 1, 0, 1])):
        x = _acts(B, K, dev, B).to(torch.bfloat16)
        before = counts()
        qm.q6k_bf16_gemv(x, ql, qh6, s6, G)
        if B <= 16:
            with pytest.raises(ValueError):
                qm.q5k_hbit_bf16_gemv(x, qh5, s5)
        else:
            qm.q5k_hbit_bf16_gemv(x, qh5, s5)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(counts(), before)] == want, B
    lin = Linear("gguf_q5k", (K, O), {"qs": qs, "qh": qh5, "scale": s5, "minv": m5},
                 int8_act=False)
    def k5_k9():
        return [qm.q4k_bf16_gemv_launches, qm.q4k_bf16_gemv_rows_launches,
                qm.q5k_q8_gemv_rows_launches]

    for B, want in ((64, [0, 0, 0, 1, 0, 1, 0]), (16, [0, 0, 1, 0, 0, 0, 0])):
        before = counts() + k5_k9()
        qm.q5k_matmul(lin, _acts(B, K, dev, 3).to(torch.bfloat16))
        after = counts() + k5_k9()
        assert [a - b for a, b in zip(after, before)] == want, B


def _affine_arrays(dev, bits, group, K, O, seed):
    """Random plane-major codes (every byte is valid), bf16 scale and zs."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randint(0, 256, (K * bits // 8, O), generator=g, dtype=torch.uint8)
    if bits == 8:  # byte-per-value kinds hold 3- or 8-bit codes
        q = q & 0x7 if seed % 2 else q
    scale = (torch.rand(K // group, O, generator=g) * 0.004 + 0.001).to(dev, torch.bfloat16)
    zs = (torch.randn(K // group, O, generator=g) * 0.01).to(dev, torch.bfloat16)
    return q.to(dev), scale, zs


# K10: the decode instantiation's row counts (one n-tile up to 8 rows, two
# above) and the rows instantiation's
K10_B = [1, 2, 5, 8, 9, 16, 17, 64, 65, 128, 129, 200, 256]


@pytest.mark.parametrize("B", K10_B)
@pytest.mark.parametrize("bits,group,K,O", [
    (2, 16, 512, 256), (2, 16, 4096, 272),      # GGUF Q2_K
    (1, 64, 4096, 256), (1, 16, 512, 144),      # HQQ-1: 8 planes
    (2, 64, 2048, 256),                         # GPTQ-2 / HQQ-2
    (4, 16, 1024, 272), (4, 128, 2048, 256),    # GPTQ-4 off the Q4_K layout
    (8, 128, 14336, 128), (8, 64, 1024, 256),   # GPTQ-8 / GPTQ-3 bytes / HQQ-3, HQQ-8
])
def test_affine_gemv_matches_plain(dev, B, bits, group, K, O):
    """K10: the same bf16(q * scale) weights on both sides, the zs term as a
    second bf16 mma with A = -zs over x (the decode instantiation), on the
    tensor cores over per-group sums in three exact bf16 parts (the rows
    instantiation), and per-group sums in the plain version; f32 sums in
    another order (1e-4 of max |y|, as K4)."""
    q, scale, zs = _affine_arrays(dev, bits, group, K, O, B + K + bits)
    x = _acts(B, K, dev, B + bits).to(torch.bfloat16)
    before = (qm.affine_gemv_launches, qm.affine_gemv_rows_launches)
    got = qm.affine_gemv(x, q, scale, zs, bits, group, out_dtype=torch.float32)
    want = qm.affine_gemv_plain(x, q, scale, zs, bits, group, torch.float32)
    torch.cuda.synchronize()
    assert (qm.affine_gemv_launches - before[0], qm.affine_gemv_rows_launches - before[1]) == (
        (1, 0) if B <= 16 else (0, 1))
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= 1e-4
    y16 = qm.affine_gemv(x, q, scale, zs, bits, group)
    assert y16.dtype == torch.bfloat16
    assert _rel_err(y16.float(), want) <= 1e-2


@pytest.mark.parametrize("B", [1, 2, 5, 8, 9, 16])
@pytest.mark.parametrize("bits,group,K,O", [
    (8, 14336, 14336, 256),   # GPTQ-8 per channel: one group of all K, 224 steps of 64 rows
    (8, 1056, 1056, 272),     # per channel at K % 64 == 32: a last step of 32 rows
    (8, 48, 4608, 144),       # a group that is not a power of two, across steps
    (4, 48, 3072, 272),       # the same below 8 bits (32-row steps)
    (2, 16, 4096, 28672),     # Q2_K gate|up: one K split, 224 column tiles
    (1, 16, 512, 144),        # HQQ-1 at group 16: two scale rows a plane a step
])
def test_affine_gemv_decode_cases_match_plain(dev, B, bits, group, K, O):
    """K10's decode instantiation where its step walk is tested hardest: a
    group of all K that is not a power of two, a partial last step, groups
    that start inside a step, one K split, a partial column tile; within
    1e-4 of max |y| of the plain version, bit-equal on a repeat, one count
    a call."""
    q, scale, zs = _affine_arrays(dev, bits, group, K, O, B + K + bits + 7)
    x = _acts(B, K, dev, B + 3).to(torch.bfloat16)
    before = (qm.affine_gemv_launches, qm.affine_gemv_rows_launches, qm.affine_dequant_launches)
    got = qm.affine_gemv(x, q, scale, zs, bits, group, out_dtype=torch.float32)
    again = qm.affine_gemv(x, q, scale, zs, bits, group, out_dtype=torch.float32)
    want = qm.affine_gemv_plain(x, q, scale, zs, bits, group, torch.float32)
    torch.cuda.synchronize()
    assert (qm.affine_gemv_launches - before[0], qm.affine_gemv_rows_launches - before[1],
            qm.affine_dequant_launches - before[2]) == (2, 0, 0)
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    assert _rel_err(got, want) <= 1e-4


def test_affine_qmatmul_keeps_per_channel_gptq8_on_k10(dev):
    """A GPTQ-8 Linear whose group is all of K (14336, not a power of two)
    reaches K10's decode instantiation at up to 16 rows, as before; above
    16 rows it takes the dequant route (the rows kernel needs a power-of-two
    group)."""
    from mistralrs_tpu_torch.quant.qlinear import Linear

    K, O = 14336, 256
    q, scale, zs = _affine_arrays(dev, 8, K, K, O, 11)
    lin = Linear("gptq_8", (K, O), {"q": q, "scale": scale, "zs": zs})
    for rows, k10, deq in ((1, 1, 0), (16, 1, 0), (17, 0, 1)):
        a, d = qm.affine_gemv_launches, qm.affine_dequant_launches
        x = _acts(rows, K, dev, rows).to(torch.bfloat16)
        y = qm.affine_qmatmul(lin, x, bits=8, group=K)
        torch.cuda.synchronize()
        assert (qm.affine_gemv_launches - a, qm.affine_dequant_launches - d) == (k10, deq)
        want = qm.affine_gemv_plain(x, q, scale, zs, 8, K, torch.float32)
        assert _rel_err(y.float(), want) <= 1e-2


@pytest.mark.parametrize("bits,group,K,O", [(2, 16, 512, 256), (2, 16, 4096, 272),
                                            (1, 64, 4096, 256), (4, 128, 2048, 136),
                                            (8, 128, 1024, 256)])
def test_affine_dequant_matches_plain_exactly(dev, bits, group, K, O):
    """bf16(bf16(q * scale) - zs) on both sides."""
    q, scale, zs = _affine_arrays(dev, bits, group, K, O, K + bits)
    before = qm.affine_dequant_launches
    got = qm.affine_dequant(q, scale, zs, bits, group, torch.bfloat16)
    assert qm.affine_dequant_launches == before + 1
    assert torch.equal(got, qm.affine_dequant_plain(q, scale, zs, bits, group, torch.bfloat16))


def test_q2k_linear_routes_on_the_card(dev):
    """A gguf_q2k Linear takes K10 up to 256 rows and affine_dequant +
    matmul above; a shape K10 does not take (out % 16) dequantizes too."""
    from mistralrs_tpu_torch.quant.qlinear import Linear, linear

    K, O = 1024, 256
    q, scale, minv = _affine_arrays(dev, 2, 16, K, O, 3)
    lin = Linear("gguf_q2k", (K, O), {"q": q, "scale": scale, "minv": minv})
    for rows, k10, k10_rows, deq in ((1, 1, 0, 0), (256, 0, 1, 0), (257, 0, 0, 1)):
        a, r, d = qm.affine_gemv_launches, qm.affine_gemv_rows_launches, qm.affine_dequant_launches
        x = _acts(rows, K, dev, rows).to(torch.bfloat16)
        y = linear(lin, x)
        torch.cuda.synchronize()
        assert (qm.affine_gemv_launches - a, qm.affine_gemv_rows_launches - r,
                qm.affine_dequant_launches - d) == (k10, k10_rows, deq)
        want = qm.affine_gemv_plain(x, q, scale, minv, 2, 16, torch.float32)
        assert y.shape == (rows, O) and _rel_err(y.float(), want) <= 1e-2
    lin8 = Linear("gguf_q2k", (K, 8), {k: v[:, :8].contiguous() for k, v in lin.data.items()})
    a, d = qm.affine_gemv_launches, qm.affine_dequant_launches
    linear(lin8, _acts(4, K, dev, 9).to(torch.bfloat16))
    assert (qm.affine_gemv_launches - a, qm.affine_dequant_launches - d) == (0, 1)


def test_affine_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q, scale, zs = _affine_arrays(dev, 2, 16, 512, 256, 1)
    x = _acts(4, 512, dev, 1)
    with pytest.raises(ValueError):  # f32 x
        qm.affine_gemv(x, q, scale, zs, 2, 16)
    with pytest.raises(ValueError):  # bits 3 is stored a byte a code
        qm.affine_gemv(x.to(torch.bfloat16), q, scale, zs, 3, 16)
    with pytest.raises(ValueError):  # f32 scales
        qm.affine_gemv(x.to(torch.bfloat16), q, scale.float(), zs, 2, 16)
    with pytest.raises(ValueError):  # f32 weights out of the dequant kernel
        qm.affine_dequant(q, scale, zs, 2, 16, torch.float32)
    # a group that spans two planes (64 byte rows, group 128) is refused at
    # every row count, not served by another kernel: the decode
    # instantiation's boxes see scale and zs as [planes][Kp/group][O]
    # (affine_qmatmul sends no such shape to K10)
    q1, s1, z1 = _affine_arrays(dev, 1, 128, 512, 256, 2)
    for rows in (4, 16, 40):
        with pytest.raises(ValueError, match="inside one plane"):
            qm.affine_gemv(_acts(rows, 512, dev, 1).to(torch.bfloat16), q1, s1, z1, 1, 128)


def _paged_inputs(dev, B, T, kv_lens, Hq, Hkv, head_major, seed, page=16, D=128):
    """q [B,T,Hq,D], one layer's pools and a meta whose block tables name
    shuffled pages (page 0 unused), wide enough for every row."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    MP = max(1, max(-(-n // page) for n in kv_lens) + 1)
    P = 1 + B * MP
    shape = (Hkv, P, page, D) if head_major else (P, page, Hkv, D)
    k = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
    v = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
    tables = (1 + torch.randperm(P - 1, generator=g)).reshape(B, MP)
    q = torch.randn(B, T, Hq, D, generator=g).to(dev, torch.bfloat16)
    zeros = torch.zeros(B, T, dtype=torch.int64, device=dev)
    meta = pa.PagedAttnMeta(positions=zeros, slot_mapping=zeros, block_tables=tables.to(dev),
                            kv_lens=torch.tensor(kv_lens, device=dev),
                            active=torch.ones(B, device=dev), head_major=head_major)
    return q, k, v, meta


@pytest.mark.parametrize("page", [16, 8, 256])
@pytest.mark.parametrize("head_major", [True, False])
@pytest.mark.parametrize("B,T,kv_lens,Hq,Hkv", [
    (2, 128, (200, 128), 4, 2),     # row 1 starts at 0 (a mixed batch)
    (1, 256, (1000,), 32, 8),       # ends mid-page; the diagonal straddles two key tiles
    (3, 64, (70, 333, 64), 8, 2),   # T not a multiple of 128
    (4, 512, (4096, 3584, 1024, 517), 32, 8),
    (1, 128, (300,), 8, 2),         # the diagonal straddles two key tiles
    (3, 384, (500, 421, 384), 32, 8),  # three query tiles, row 2 starts at 0
    (2, 200, (457, 200), 4, 4),     # one query head a kv head
    (2, 128, (300, 129), 16, 1),    # 16 query heads on one kv head
])
def test_flash_prefill_paged_matches_plain(dev, page, head_major, B, T, kv_lens, Hq, Hkv):
    q, k, v, meta = _paged_inputs(dev, B, T, kv_lens, Hq, Hkv, head_major, seed=T + B,
                                  page=page)
    before = pa.flash_prefill_paged_launches
    got = pa.flash_prefill_continuation(q, k, v, meta, scale=128 ** -0.5).float()
    want = pa.flash_prefill_continuation_plain(q, k, v, meta, scale=128 ** -0.5).float()
    torch.cuda.synchronize()
    assert pa.flash_prefill_paged_launches == before + 1
    # as K6: one bf16 rounding of the output on each side, P rounded to bf16
    # before P.V in the kernel, f32 sums in another order
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


@pytest.mark.parametrize("head_major", [True, False])
def test_flash_prefill_paged_padded_chunk(dev, head_major):
    """Row 0's chunk holds 200 real tokens padded to 256 rows at positions
    300..555: its table names page 0 (the garbage page padding tokens write
    to) past the real prompt, as the engine's tables do."""
    B, T, page = 2, 256, 16
    q, k, v, meta = _paged_inputs(dev, B, T, (556, 256), 32, 8, head_major, seed=11, page=page)
    meta.block_tables[0, -(-500 // page):] = 0
    got = pa.flash_prefill_continuation(q, k, v, meta, scale=128 ** -0.5).float()
    want = pa.flash_prefill_continuation_plain(q, k, v, meta, scale=128 ** -0.5).float()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


@pytest.mark.parametrize("page", [16, 256])
@pytest.mark.parametrize("head_major", [True, False])
def test_flash_prefill_paged_ignores_slots_past_kv_len(dev, page, head_major):
    """Every pool slot that no row reads below its kv_len holds NaN, the
    rest of each row's last page included (a recycled page's stale data),
    and rows 0 and 1 share their last page: the output is finite and the
    one of pools that hold finite values there."""
    B, T, kv_lens = 3, 128, (1000, 300, 129)
    q, k, v, meta = _paged_inputs(dev, B, T, kv_lens, 8, 2, head_major, seed=21, page=page)
    tables = meta.block_tables
    tables[1, (kv_lens[1] - 1) // page] = tables[0, (kv_lens[0] - 1) // page]
    live = torch.zeros(k.shape[:3] if head_major else k.shape[:2], dtype=torch.bool)
    for b, n in enumerate(kv_lens):
        pos = torch.arange(n)
        pages = tables[b].cpu()[pos // page]
        live[(slice(None), pages, pos % page) if head_major else (pages, pos % page)] = True
    live = live.to(dev)[..., None] if head_major else live.to(dev)[..., None, None]
    k_nan, v_nan = (torch.where(live, t, torch.full_like(t, float("nan"))) for t in (k, v))
    got = pa.flash_prefill_continuation(q, k_nan, v_nan, meta, scale=128 ** -0.5)
    clean = pa.flash_prefill_continuation(q, k, v, meta, scale=128 ** -0.5)
    want = pa.flash_prefill_continuation_plain(q, k, v, meta, scale=128 ** -0.5).float()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, clean)
    assert float((got.float() - want).abs().max()) <= 1e-2 * float(want.abs().max())


def test_flash_prefill_paged_call_launches_one_kernel(dev):
    q, k, v, meta = _paged_inputs(dev, 2, 256, (1000, 256), 8, 2, True, seed=5)
    before = _launch_counts()
    pa.flash_prefill_continuation(q, k, v, meta, scale=128 ** -0.5)
    torch.cuda.synchronize()
    after = _launch_counts()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == \
        {"paged_attention.flash_prefill_paged_launches": 1}


@pytest.mark.parametrize("head_major", [True, False])
@pytest.mark.parametrize("B,kv_lens,Hq,Hkv", [
    (1, (4089,), 32, 8),
    (4, (3456, 1, 17, 2048), 32, 8),
    (16, tuple(range(256, 4097, 256)), 32, 8),
    (3, (100, 0, 640), 8, 8),     # kv_len 0 gives zeros
    (2, (300, 77), 16, 1),        # 16 query heads on one kv head
])
def test_paged_decode_matches_plain(dev, head_major, B, kv_lens, Hq, Hkv):
    q, k, v, meta = _paged_inputs(dev, B, 1, kv_lens, Hq, Hkv, head_major, seed=B + Hq)
    before = pa.paged_decode_launches
    got = pa.paged_decode_attention(q, k, v, meta, scale=128 ** -0.5).float()
    want = pa.paged_decode_attention_plain(q, k, v, meta, scale=128 ** -0.5).float()
    torch.cuda.synchronize()
    assert pa.paged_decode_launches == before + 1
    assert bool(torch.isfinite(got).all())
    for b, n in enumerate(kv_lens):
        if n == 0:
            assert not bool(got[b].any())
    # bf16 output on both sides, P rounded to bf16 before P.V in the kernel,
    # the splits' partials combined in another f32 order
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


def test_paged_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q, k, v, meta = _paged_inputs(dev, 1, 1, (40,), 4, 2, True, seed=0)
    with pytest.raises(ValueError):  # f32 query
        pa.paged_decode_attention(q.float(), k, v, meta, scale=1.0)
    with pytest.raises(ValueError):  # two query tokens
        pa.paged_decode_attention(torch.cat([q, q], 1), k, v, meta, scale=1.0)
    with pytest.raises(ValueError):  # pools that are not one layer's
        pa.flash_prefill_continuation(q, k[None], v[None], meta, scale=1.0)
    with pytest.raises(ValueError):  # head dim 64
        pa.flash_prefill_continuation(q[..., :64].contiguous(), k[..., :64].contiguous(),
                                      v[..., :64].contiguous(), meta, scale=1.0)
    with pytest.raises(ValueError):  # a non-contiguous pool
        pa.paged_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2), meta, scale=1.0)
    cpu_meta = pa.PagedAttnMeta(**{f: getattr(meta, f).cpu() for f in (
        "positions", "slot_mapping", "block_tables", "kv_lens", "active")}, head_major=True)
    with pytest.raises(ValueError):  # tables on another device
        pa.paged_decode_attention(q, k, v, cpu_meta, scale=1.0)


@pytest.mark.parametrize("head_major", [True, False])
@pytest.mark.parametrize("B,kv_lens,Hq,Hkv,cap", [
    (16, tuple(range(256, 4097, 256)), 16, 8, 50.0),  # Gemma-2-9B widths
    (3, (100, 0, 4000), 8, 4, 50.0),                  # Gemma-2-2B widths; kv_len 0
    (2, (300, 77), 16, 1, None),                      # D 256 without a cap
    (2, (513, 1000), 32, 8, 30.0),                    # D 128 with a cap
])
def test_paged_decode_softcap_matches_plain(dev, head_major, B, kv_lens, Hq, Hkv, cap):
    """K7 with a logit soft cap and at head dim 256."""
    D = 128 if Hq == 32 else 256
    q, k, v, meta = _paged_inputs(dev, B, 1, kv_lens, Hq, Hkv, head_major, seed=B + Hq, D=D)
    # scores wide enough for the cap to bite
    q = (q.float() * 4).to(torch.bfloat16)
    scale = 256 ** -0.5 if D == 256 else 128 ** -0.5
    before = pa.paged_decode_launches
    got = pa.paged_decode_attention(q, k, v, meta, scale=scale, logits_softcap=cap).float()
    want = pa.paged_decode_attention_plain(q, k, v, meta, scale=scale,
                                           logits_softcap=cap).float()
    torch.cuda.synchronize()
    assert pa.paged_decode_launches == before + 1
    assert bool(torch.isfinite(got).all())
    for b, n in enumerate(kv_lens):
        if n == 0:
            assert not bool(got[b].any())
    # as K7 without a cap: bf16 output on both sides, P rounded to bf16
    # before P.V, f32 sums in another order; tanhf against torch.tanh
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


def _splash_inputs(dev, B, T, Hq, Hkv, D, seed, amp=1.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = (torch.randn(B, T, Hq, D, generator=g) * amp).to(dev, torch.bfloat16)
    k = torch.randn(B, T, Hkv, D, generator=g).to(dev, torch.bfloat16)
    v = torch.randn(B, T, Hkv, D, generator=g).to(dev, torch.bfloat16)
    return q, k, v


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("window", [None, 48, 128, 200, 5000])
@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("B,T,Hq,Hkv", [(2, 256, 4, 2), (1, 200, 8, 8), (1, 512, 16, 8)])
def test_splash_prefill_matches_plain(dev, D, window, cap, B, T, Hq, Hkv):
    """K11: windows inside a tile (48), on a tile edge (128), off it (200)
    and past the chunk (5000); T not a multiple of 64 (200); a scale that
    is not exact in bf16 (144 ** -0.5, Gemma-2-27B's)."""
    q, k, v = _splash_inputs(dev, B, T, Hq, Hkv, D, seed=T + Hq + D, amp=3.0)
    scale = 144 ** -0.5
    before = sp.splash_prefill_launches
    got = sp.splash_prefill(q, k, v, scale=scale, sliding_window=window,
                            logits_softcap=cap).float()
    want = sp.splash_prefill_plain(q, k, v, scale=scale, sliding_window=window,
                                   logits_softcap=cap).float()
    torch.cuda.synchronize()
    assert sp.splash_prefill_launches == before + 1
    assert bool(torch.isfinite(got).all())
    # as K6: one bf16 rounding of the output on each side, P rounded to bf16
    # before P.V in the kernel, f32 sums in another order, tanhf against
    # torch.tanh
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


# chip_smoke.SPLASH_CASES (B, T, Hq, Hkv, D, window, cap): Gemma-2-9B's first
# chunks with the cap (no window; 4096, which does not clip; 128, which
# does; T 256), Gemma-2-2B's heads, a Mistral-width chunk clipped by a
# window without a cap; and the edges of K11's items: one token, a second
# item of one row, a window of one key
SPLASH_CASES = [(4, 512, 16, 8, 256, None, 50.0), (4, 512, 16, 8, 256, 4096, 50.0),
                (4, 512, 16, 8, 256, 128, 50.0), (4, 256, 16, 8, 256, None, 50.0),
                (4, 512, 8, 4, 256, None, 50.0), (1, 512, 32, 8, 128, 128, None),
                (1, 1, 16, 8, 256, None, 50.0), (2, 129, 8, 4, 128, None, 30.0),
                (1, 300, 8, 8, 256, 1, None)]


@pytest.mark.parametrize("B,T,Hq,Hkv,D,window,cap", SPLASH_CASES)
def test_splash_prefill_at_the_served_shapes(dev, B, T, Hq, Hkv, D, window, cap):
    """K11 on the Hopper core at chip_smoke's cases and the items' edges:
    q drawn 8 times wider with a cap (the logits reach the cap's bend),
    within 1e-2 of max |out| of the plain version (as K6: bf16 out, P
    rounded to bf16, tanhf against torch.tanh), bit-equal on repeat."""
    amp = 8.0 if cap else 1.0
    q, k, v = _splash_inputs(dev, B, T, Hq, Hkv, D, seed=B + T + D, amp=amp)
    kw = dict(scale=D ** -0.5, sliding_window=window, logits_softcap=cap)
    got = sp.splash_prefill(q, k, v, **kw).float()
    again = sp.splash_prefill(q, k, v, **kw).float()
    want = sp.splash_prefill_plain(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


def test_splash_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    q, k, v = _splash_inputs(dev, 1, 128, 4, 2, 64, seed=0)
    with pytest.raises(ValueError):  # head dim 64
        sp.splash_prefill(q, k, v, scale=0.1, logits_softcap=50.0)
    q, k, v = _splash_inputs(dev, 1, 128, 4, 2, 256, seed=0)
    with pytest.raises(ValueError):  # f32 query
        sp.splash_prefill(q.float(), k, v, scale=0.1)
    with pytest.raises(ValueError):  # k on the CPU
        sp.splash_prefill(q, k.cpu(), v, scale=0.1)
    with pytest.raises(ValueError):  # head dim 96 for the decode kernel
        pa.paged_decode_attention(*_paged_inputs(dev, 1, 1, (40,), 4, 2, True, seed=0, D=96),
                                  scale=1.0)


def _ragged_inputs(dev, seqs, B, Hq, Hkv, D, seed, page=16, amp=1.0):
    """K12's arguments: live sequences `seqs` ((q_len, kv_len) each) in B
    slots (the rest padding), packed bf16 queries, a combined pool with
    each sequence on its own shuffled pages, tables a power of two of pages
    wide, int32 metadata."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    W = 4
    while W * page < max(kv for _, kv in seqs):
        W *= 2
    P = 1 + B * W
    pool = torch.randn(P, page, 2 * Hkv, D, generator=g).to(dev, torch.bfloat16)
    tables = (1 + torch.randperm(P - 1, generator=g)).reshape(B, W).to(dev, torch.int32)
    q_lens = [ql for ql, _ in seqs] + [0] * (B - len(seqs))
    kv_lens = [kv for _, kv in seqs] + [1] * (B - len(seqs))
    q = (torch.randn(sum(q_lens), Hq, D, generator=g) * amp).to(dev, torch.bfloat16)
    cu = torch.cumsum(torch.tensor([0] + q_lens), 0).to(dev, torch.int32)
    i32 = dict(dtype=torch.int32, device=dev)
    return (q, pool, torch.tensor(kv_lens, **i32), tables, cu,
            torch.tensor([len(seqs)], **i32))


RAGGED_CASES = [
    # decode (max_q_len 1): Mistral-7B and Gemma-2-9B widths, a window that
    # clips, fewer live sequences than slots, kv_len 1
    (((1, 4096),) * 16, 16, 32, 8, 128, None, None, 1),
    (((1, 1024),) * 16, 16, 16, 8, 256, None, 50.0, 1),
    (((1, 4664), (1, 3), (1, 4100), (1, 1)), 16, 16, 8, 256, 4096, 50.0, 1),
    (((1, 300), (1, 77)), 3, 16, 1, 256, 48, None, 1),
    # chunks: 4 x 512 continuations, the window clipping inside them,
    # a ragged q_len, a window inside one tile, a first chunk
    (((512, 4096),) * 4, 4, 32, 8, 128, None, None, 512),
    (((512, 4608),) * 4, 4, 16, 8, 256, 4096, 50.0, 512),
    (((176, 1200), (256, 256)), 3, 32, 8, 128, 48, 30.0, 256),
    (((200, 200),), 1, 16, 8, 256, None, 50.0, 256),
    # a mixed batch: decode, first chunk and continuation in 4 slots
    (((1, 3000), (256, 256), (176, 1200)), 4, 16, 8, 256, 4096, 50.0, None),
    (((1, 3000), (256, 256), (176, 1200)), 4, 32, 8, 128, None, None, None),
]


@pytest.mark.parametrize("seqs,B,Hq,Hkv,D,window,cap,max_q", RAGGED_CASES)
def test_ragged_attention_matches_plain(dev, seqs, B, Hq, Hkv, D, window, cap, max_q):
    """K12 on the rows of its live sequences; rows of sequences past
    num_seqs are not its to write."""
    args = _ragged_inputs(dev, seqs, B, Hq, Hkv, D, seed=len(seqs) + D, amp=4.0 if cap else 1.0)
    kw = dict(scale=D ** -0.5, sliding_window=window, logits_softcap=cap)
    before = ra.ragged_attention_launches
    got = ra.ragged_attention(*args, **kw, max_q_len=max_q).float()
    want = ra.ragged_attention_plain(*args, **kw).float()
    torch.cuda.synchronize()
    assert ra.ragged_attention_launches == before + 1
    assert bool(torch.isfinite(got).all())
    # as K6'/K7: bf16 output on both sides, P rounded to bf16 before P.V in
    # the kernel, f32 sums in another order; tanhf against torch.tanh
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


def test_ragged_padded_on_the_card_zeroes_padding_rows(dev):
    """ragged_attention_padded around K12: a continuation of 176 real rows
    padded to 256 beside a padding slot; the real rows match the plain
    path, the padding comes out zero."""
    B, T, Hq, Hkv, D, page = 2, 256, 32, 8, 128, 16
    g = torch.Generator(device="cpu").manual_seed(3)
    W = 128
    pool = torch.randn(1 + W, page, 2 * Hkv, D, generator=g).to(dev, torch.bfloat16)
    tables = torch.zeros(B, W, dtype=torch.int64)
    tables[0] = torch.arange(1, 1 + W)
    start, n = 1024, 176
    pos = torch.arange(start, start + n)
    slots = torch.zeros(B, T, dtype=torch.int64)
    slots[0, :n] = tables[0, pos // page] * page + pos % page
    meta = pa.PagedAttnMeta(positions=torch.zeros(B, T, dtype=torch.int64, device=dev),
                            slot_mapping=slots.to(dev), block_tables=tables.to(dev),
                            kv_lens=torch.tensor([start + T, 1], device=dev),
                            active=torch.tensor([1.0, 0.0], device=dev))
    q = torch.randn(B, T, Hq, D, generator=g).to(dev, torch.bfloat16)
    got = ra.ragged_attention_padded(q, pool, meta, scale=D ** -0.5).float()
    cpu_meta = pa.PagedAttnMeta(**{f: getattr(meta, f).cpu() for f in (
        "positions", "slot_mapping", "block_tables", "kv_lens", "active")})
    want = ra.ragged_attention_padded(q.cpu().float(), pool.cpu().float(), cpu_meta,
                                      scale=D ** -0.5).to(dev)
    torch.cuda.synchronize()
    assert not bool(got[0, n:].any()) and not bool(got[1].any())
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


# K12's chunk instantiation (the Hopper core, csrc/flash_sm90.cuh): live
# sequences ((q_len, kv_len) each), slots B, Hq, Hkv, D, page, window, soft
# cap; ids say what each case holds
CHUNK_CASES = [
    pytest.param(((512, 4096),) * 2, 2, 32, 8, 128, 16, None, None, id="mistral-g4"),
    pytest.param(((512, 4608),) * 2, 2, 16, 8, 256, 16, 4096, 50.0, id="gemma2-g2-window-cap"),
    pytest.param(((300, 1000),), 1, 8, 8, 128, 64, None, None, id="g1-page64"),
    pytest.param(((300, 1000),), 1, 8, 8, 256, 256, None, 50.0, id="d256-g1-page256-cap"),
    pytest.param(((200, 777),), 1, 16, 8, 128, 256, None, None, id="g2-page256"),
    pytest.param(((130, 900),), 2, 32, 4, 128, 16, 300, None, id="g8-window-across-pages"),
    pytest.param(((129, 900),), 1, 32, 2, 256, 64, 40, 50.0, id="d256-g16-window-in-a-tile"),
    pytest.param(((257, 1100),), 1, 32, 2, 128, 16, 40, None, id="g16-window-in-a-tile"),
    pytest.param(((100, 700), (150, 900)), 2, 32, 8, 128, 16, None, None,
                 id="first-ends-mid-tile"),
    pytest.param(((37, 500), (64, 64), (90, 1000)), 3, 16, 4, 256, 16, 100, 50.0,
                 id="d256-g4-three-end-mid-tile"),
    pytest.param(((1, 3000), (256, 256), (176, 1200)), 4, 32, 8, 128, 64, None, None,
                 id="mixed-decode-and-chunks"),
    pytest.param(((1, 3000), (256, 256), (176, 1200)), 4, 16, 8, 256, 16, 4096, 50.0,
                 id="gemma2-mixed"),
    pytest.param(((48, 999),), 1, 16, 2, 128, 4, None, None, id="page4"),
]


def _nan_past_kv(pool, tables, kv_lens, num_seqs):
    """The pool with every slot that no live sequence's context holds set to
    NaN: the rest of each last page, and every page past it."""
    pool = pool.clone()
    page = pool.shape[1]
    keep = torch.zeros(pool.shape[0], page, dtype=torch.bool, device=pool.device)
    for i in range(int(num_seqs[0])):
        kv = int(kv_lens[i])
        pages = tables[i, :-(-kv // page)].long()
        keep[pages] = True
        keep[pages[-1], kv - (len(pages) - 1) * page:] = False
    pool[~keep] = float("nan")
    return pool


@pytest.mark.parametrize("nan", [False, True], ids=["pool", "nan-past-kv"])
@pytest.mark.parametrize("seqs,B,Hq,Hkv,D,page,window,cap", CHUNK_CASES)
def test_ragged_chunk_matches_plain(dev, seqs, B, Hq, Hkv, D, page, window, cap, nan):
    """K12's chunk instantiation against its plain version at 1e-2 of max
    |out| on the rows of the live sequences (q drawn 4x wider under a cap,
    so the logits reach its bend): every query-head grouping, both head
    dims, pages of 4-256 slots, windows inside one key tile and across
    pages, sequences that end mid-tile (the next one's rows are another
    item's: the epilogue must not write them), kv_lens off the page, a mixed
    step, and slots past each context holding NaN. Bit-equal on repeat;
    counted as one chunk launch."""
    q, pool, kv_lens, tables, cu, num_seqs = _ragged_inputs(
        dev, seqs, B, Hq, Hkv, D, seed=sum(ql for ql, _ in seqs) + D + page,
        page=page, amp=4.0 if cap else 1.0)
    if nan:
        pool = _nan_past_kv(pool, tables, kv_lens, num_seqs)
    args = (q, pool, kv_lens, tables, cu, num_seqs)
    kw = dict(scale=D ** -0.5, sliding_window=window, logits_softcap=cap)
    max_q = max(ql for ql, _ in seqs)
    before = ra.ragged_chunk_launches, ra.ragged_attention_launches
    got = ra.ragged_attention(*args, **kw, max_q_len=max_q)
    again = ra.ragged_attention(*args, **kw, max_q_len=max_q)
    want = ra.ragged_attention_plain(*args, **kw).float()
    torch.cuda.synchronize()
    assert (ra.ragged_chunk_launches, ra.ragged_attention_launches) == (before[0] + 2,
                                                                        before[1] + 2)
    assert torch.equal(got, again)
    got = got.float()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


def test_ragged_chunk_raises_for_a_scale_it_cannot_fold(dev):
    """Without a cap the chunk instantiation takes the running max over raw
    scores, which needs a positive scale; with one any scale works."""
    args = _ragged_inputs(dev, ((40, 100),), 1, 8, 2, 128, seed=0)
    with pytest.raises(ValueError):
        ra.ragged_attention(*args, scale=-0.1, max_q_len=40)
    got = ra.ragged_attention(*args, scale=-0.1, logits_softcap=30.0, max_q_len=40).float()
    want = ra.ragged_attention_plain(*args, scale=-0.1, logits_softcap=30.0).float()
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


def test_ragged_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    args = list(_ragged_inputs(dev, ((4, 40),), 1, 4, 2, 128, seed=0))
    with pytest.raises(ValueError):  # f32 queries
        ra.ragged_attention(args[0].float(), *args[1:], scale=1.0)
    with pytest.raises(ValueError):  # head dim 64
        small = _ragged_inputs(dev, ((4, 40),), 1, 4, 2, 64, seed=0)
        ra.ragged_attention(*small, scale=1.0)
    with pytest.raises(ValueError):  # a page size of 12
        odd = _ragged_inputs(dev, ((4, 40),), 1, 4, 2, 128, seed=0, page=12)
        ra.ragged_attention(*odd, scale=1.0)
    with pytest.raises(ValueError):  # a non-contiguous pool
        ra.ragged_attention(args[0], args[1].transpose(1, 2).contiguous().transpose(1, 2),
                            *args[2:], scale=1.0)
    with pytest.raises(ValueError):  # 3 query heads per kv head
        three = _ragged_inputs(dev, ((4, 40),), 1, 6, 2, 128, seed=0)
        ra.ragged_attention(*three, scale=1.0)
    with pytest.raises(ValueError):  # kv_lens on the CPU
        ra.ragged_attention(args[0], args[1], args[2].cpu(), *args[3:], scale=1.0)


def _grouped_inputs(dev, sizes, K, N, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    M = sum(sizes)
    lhs = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
    rhs = (torch.randn(len(sizes), K, N, generator=g) * K ** -0.5).to(dev, torch.bfloat16)
    return lhs, rhs, torch.tensor(sizes, dtype=torch.int32, device=dev)


def _skewed_sizes(M, G, seed):
    """M rows over G groups with a seeded skew (some groups empty)."""
    import numpy as np

    p = np.random.default_rng(seed).dirichlet(np.full(G, 0.5))
    return np.bincount(np.random.default_rng(seed + 1).choice(G, M, p=p), minlength=G).tolist()


def _forty_rows(G, seed):
    """G groups of 30-50 rows each (seeded)."""
    import numpy as np

    return np.random.default_rng(seed).integers(30, 51, G).tolist()


GROUPED_CASES = [
    # small shapes: empty groups, M not a multiple of any row tile, one group
    ([10, 0, 25, 15], 96, 160),
    ([32, 32, 32, 32], 96, 160),
    ([0, 131, 0, 0], 96, 160),
    ([3, 1, 0, 7, 2, 5, 0, 14], 256, 72),
    ([300, 5, 0, 211], 128, 264),
    # Mixtral widths: decode (M 32, 4 x 64 and 4 x 256 rows, top-2), gate and down
    (_skewed_sizes(32, 8, 0), 4096, 14336),
    (_skewed_sizes(32, 8, 1), 14336, 4096),
    (_skewed_sizes(512, 8, 2), 4096, 14336),
    (_skewed_sizes(2048, 8, 3), 14336, 4096),
    ([0, 0, 512, 0, 0, 0, 0, 0], 4096, 14336),
    # above 32 rows a group (the tiles instantiation): a group of 129 rows,
    # one row into its second 128-row tile; the K tail (96 = 64 + 32) and the
    # N edge inside a 64-column box; 256 groups of ~40 rows on narrow K and
    # N; groups that end inside tiles at Mixtral widths and M = 4,096 (4 x
    # 512 rows, top-2), gate and down
    ([129], 128, 192),
    ([100, 0, 70], 96, 264),
    (_forty_rows(256, 0), 96, 72),
    (_skewed_sizes(4096, 8, 4), 4096, 14336),
    (_skewed_sizes(4096, 8, 5), 14336, 4096),
]


@pytest.mark.parametrize("sizes,K,N", GROUPED_CASES)
def test_grouped_gemm_matches_plain(dev, sizes, K, N):
    from mistralrs_tpu_torch.ops import grouped_gemm as gg

    lhs, rhs, gs = _grouped_inputs(dev, sizes, K, N, seed=len(sizes) + K)
    before = gg.grouped_gemm_launches
    got = gg.grouped_matmul(lhs, rhs, gs).float()
    want = gg.grouped_matmul_ref(lhs, rhs, gs).float()
    torch.cuda.synchronize()
    assert gg.grouped_gemm_launches == before + 1
    assert got.shape == (sum(sizes), N) and bool(torch.isfinite(got).all())
    # bf16 out on both sides from f32 sums in another order: one bf16 ulp
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


@pytest.mark.parametrize("sizes,K,N", [([200, 170, 0, 165], 160, 264),
                                       ([300, 0, 260], 256, 4096),
                                       ([5, 0, 9, 3], 96, 136)])
def test_grouped_gemm_one_hot_rows_select_weight_rows_exactly(dev, sizes, K, N):
    """Row m of lhs one-hot at K index k_m: out[m] is the group's weight row
    k_m rounded to bf16, exactly (one product, f32 sum, one rounding), for
    every group; k_m walks the group's K indices, so where a group has K
    rows (the first two cases, the tiles instantiation) every element of
    its weight is read where the kernel's staged layout puts it (the
    MN-major B operand of the tiles kernel, the ldmatrix.trans fragments of
    the decode one; the last case)."""
    from mistralrs_tpu_torch.ops import grouped_gemm as gg

    _, rhs, gs = _grouped_inputs(dev, sizes, K, N, seed=K + N)
    M = sum(sizes)
    ks, want = [], []
    for g, n in enumerate(sizes):
        k = torch.arange(n) % K
        ks.append(k)
        want.append(rhs[g].cpu()[k])
    lhs = torch.nn.functional.one_hot(torch.cat(ks), K).to(dev, torch.bfloat16)
    got = gg.grouped_matmul(lhs, rhs, gs)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), torch.cat(want)) and got.shape == (M, N)


@pytest.mark.parametrize("sizes,K,N", [(_skewed_sizes(2048, 8, 6), 4096, 14336),
                                       ([100, 0, 70], 96, 264),
                                       (_skewed_sizes(32, 8, 7), 4096, 14336)])
def test_grouped_gemm_is_bit_equal_on_repeat(dev, sizes, K, N):
    """No split-K and no atomics in either instantiation: calls on the same
    inputs agree bit for bit."""
    from mistralrs_tpu_torch.ops import grouped_gemm as gg

    lhs, rhs, gs = _grouped_inputs(dev, sizes, K, N, seed=7)
    first = gg.grouped_matmul(lhs, rhs, gs)
    for _ in range(2):
        assert torch.equal(gg.grouped_matmul(lhs, rhs, gs), first)


@pytest.mark.parametrize("sizes,M,K,N", [([100, -5, 80, 60], 200, 96, 136),
                                         ([700, 300], 800, 128, 192),
                                         ([10, -3, 30], 30, 64, 72)])
def test_grouped_gemm_drops_rows_past_m(dev, sizes, M, K, N):
    """Sizes that sum above M (rows past M dropped) and negative sizes
    (counted as 0), on the tiles instantiation (the first two) and the
    decode one, against the plain version."""
    from mistralrs_tpu_torch.ops import grouped_gemm as gg

    g = torch.Generator(device="cpu").manual_seed(M)
    lhs = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
    rhs = (torch.randn(len(sizes), K, N, generator=g) * K ** -0.5).to(dev, torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    got = gg.grouped_matmul(lhs, rhs, gs).float()
    want = gg.grouped_matmul_ref(lhs, rhs, gs).float()
    torch.cuda.synchronize()
    assert got.shape == (M, N) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


@pytest.mark.parametrize("M,G", [(32, 1), (33, 1), (256, 8), (264, 8), (8192, 256),
                                 (8193, 256)])
def test_grouped_gemm_route_takes_tiles_above_32_rows_a_group(dev, M, G):
    """Up to 32 rows a group on average the decode instantiation launches,
    above it the tiles one: by the per-instantiation counter and by the
    kernel's name in a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    from mistralrs_tpu_torch.ops import grouped_gemm as gg

    sizes = [M // G + (g < M % G) for g in range(G)]
    lhs, rhs, gs = _grouped_inputs(dev, sizes, 64, 128, seed=M)
    gg.grouped_matmul(lhs, rhs, gs)  # built and loaded before the trace
    tiles = M > 32 * G
    before, before_tiles = gg.grouped_gemm_launches, gg.grouped_gemm_tiles_launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gg.grouped_matmul(lhs, rhs, gs)
        torch.cuda.synchronize()
    assert gg.grouped_gemm_launches == before + 1
    assert gg.grouped_gemm_tiles_launches == before_tiles + tiles
    names = [e.key for e in prof.key_averages() if "grouped_gemm" in e.key]
    want = "grouped_gemm_tiles_kernel" if tiles else "grouped_gemm_decode_kernel"
    assert names and all(want in n for n in names), names


def test_grouped_gemm_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    from mistralrs_tpu_torch.ops import grouped_gemm as gg

    lhs, rhs, gs = _grouped_inputs(dev, [8, 8], 64, 64, seed=0)
    with pytest.raises(ValueError):  # f32 lhs
        gg.grouped_matmul(lhs.float(), rhs, gs)
    with pytest.raises(ValueError):  # int64 sizes
        gg.grouped_matmul(lhs, rhs, gs.long())
    with pytest.raises(ValueError):  # sizes on the CPU
        gg.grouped_matmul(lhs, rhs, gs.cpu())
    with pytest.raises(ValueError):  # K % 32
        gg.grouped_matmul(lhs[:, :48].contiguous(), rhs[:, :48].contiguous(), gs)
    with pytest.raises(ValueError):  # a non-contiguous weight
        gg.grouped_matmul(lhs, rhs.transpose(1, 2), gs)


def test_moe_decode_forward_never_waits_for_the_card(dev):
    """One decode forward of a 2-layer Mixtral with dense bf16 experts (the
    grouped dispatch: K13 for gate, up and down) run under sync debug mode
    "error": no op of the step blocks the host on the card. The first
    forward, outside that mode, builds and loads the kernels."""
    import dataclasses

    import chip_smoke
    from mistralrs_tpu_torch.models import decoder as td
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.ops import grouped_gemm as gg
    from mistralrs_tpu_torch.quant.fuse import fuse_decoder_params

    sz = chip_smoke.Sizes(vocab=1920, hidden=512, inter=1024, heads=4, kv_heads=2, layers=2)
    cfg = dataclasses.replace(chip_smoke.mixtral_config(sz, 2), moe_grouped=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = fuse_decoder_params(chip_smoke.random_mixtral_params(sz, 2, dev, gen,
                                                                  torch.bfloat16))
    rope = make_rope(cfg, 512, device=dev)
    B, page = 8, 16
    cache = pa.PagedKVCache.create(2, 1 + 4 * B, page, 2, 128, torch.bfloat16, device=dev)
    kv_lens = 3 + 5 * torch.arange(B, device=dev)  # the new token included
    tables = (1 + torch.arange(4 * B, device=dev)).reshape(B, 4)
    pos = (kv_lens - 1)[:, None]
    meta = pa.PagedAttnMeta(positions=pos, block_tables=tables, kv_lens=kv_lens,
                            slot_mapping=torch.gather(tables, 1, pos // page) * page + pos % page,
                            active=torch.ones(B, device=dev))
    ids = torch.randint(1, sz.vocab, (B, 1), device=dev, generator=gen)
    td.decoder_forward(params, cfg, rope, ids, cache, meta)
    before = gg.grouped_gemm_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        h, _ = td.decoder_forward(params, cfg, rope, ids, cache, meta)
        logits = td.compute_logits(params, cfg, h[:, 0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert gg.grouped_gemm_launches == before + 3 * 2
    assert logits.shape == (B, sz.vocab) and bool(torch.isfinite(logits).all())


# ------------------------------------------------------------- attention routes


def _tiny_d64_llama(seed=0):
    """A tiny seeded llama whose heads are 64 wide (2 layers, 4 query heads
    over 2 kv heads), dense f32 weights on the CPU. Its lm_head makes row
    (7i + 3) mod V 0.05 * embed[i] (plus noise), so the token after i wins
    by a wide margin while the layers still move every logit."""
    from mistralrs_tpu_torch.models.config import ModelConfig
    from mistralrs_tpu_torch.models.decoder import DecoderParams
    from mistralrs_tpu_torch.quant.qlinear import Linear

    cfg = ModelConfig(arch="mistral", vocab_size=384, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      max_position_embeddings=1024, rope_theta=1e4)
    g = torch.Generator().manual_seed(seed)
    H, I, V, D = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.head_dim

    def dense(i, o):
        return Linear("dense", (i, o), {"w": torch.randn(i, o, generator=g) * 0.02})

    layers = [{"attn": {"q": dense(H, 4 * D), "k": dense(H, 2 * D), "v": dense(H, 2 * D),
                        "o": dense(4 * D, H)},
               "mlp": {"gate": dense(H, I), "up": dense(H, I), "down": dense(I, H)},
               "input_norm": {"w": torch.ones(H)}, "post_attn_norm": {"w": torch.ones(H)}}
              for _ in range(cfg.num_layers)]
    embed = torch.randn(V, H, generator=g)
    head = torch.randn(V, H, generator=g) * 0.01
    head[(7 * torch.arange(V) + 3) % V] += 0.05 * embed
    params = DecoderParams(embed=embed, layers=layers, final_norm={"w": torch.ones(H)},
                           lm_head=Linear("dense", (H, V), {"w": head.T.contiguous()}))
    return cfg, params


def _serve_tokens(cfg, params, device, dtype, backend):
    """Greedy tokens of two requests (a 130-token prompt: one first chunk
    of 256 rows; a 20-token one) served through the engine."""
    import chip_smoke
    from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    moved = dataclasses.replace(params, embed=params.embed.to(device, dtype),
                                layers=chip_smoke._moved(params.layers, device, dtype),
                                final_norm=chip_smoke._moved(params.final_norm, device, dtype),
                                lm_head=chip_smoke._moved(params.lm_head, device, dtype))
    pc = PipelineConfig(max_seqs=2, max_model_len=512, num_pages=64, dtype=dtype,
                        device=str(device), attn_backend=backend)
    pipe = TextPipeline(cfg, moved, make_rope(cfg, 512, device=device), pc)
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    rng = torch.Generator().manual_seed(5)
    groups = [eng.add_request(GenerationRequest(
        torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist(), SamplingParams(max_len=8)))
        for n in (130, 20)]
    while not all(g.all_done() for g in groups):
        eng.step()
    return [list(s.generated_tokens) for g in groups for s in g.seqs]


@pytest.mark.parametrize("backend", [None, "ragged"])
def test_head_dim_64_llama_serves_on_the_card(dev, backend):
    """No card attention kernel takes head dim 64, so every step of this
    model takes the gather route on the card (over the split views of the
    ragged backend's combined pool); its greedy tokens equal the CPU run's,
    where the first chunk takes the flash route and the ragged backend K12
    (their plain versions)."""
    from mistralrs_tpu_torch.ops import paged_attention as pa_ops

    cfg, params = _tiny_d64_llama()
    want = _serve_tokens(cfg, params, torch.device("cpu"), torch.float32, backend)
    before = (fa.flash_prefill_launches, pa_ops.paged_decode_launches,
              pa_ops.flash_prefill_paged_launches, ra.ragged_attention_launches,
              sp.splash_prefill_launches)
    got = _serve_tokens(cfg, params, dev, torch.bfloat16, backend)
    after = (fa.flash_prefill_launches, pa_ops.paged_decode_launches,
             pa_ops.flash_prefill_paged_launches, ra.ragged_attention_launches,
             sp.splash_prefill_launches)
    assert after == before
    assert got == want and all(len(t) == 8 for t in got)


# ------------------------------------------------------------- bf16 activations

# (in, out) of Mistral-7B's projections: gate|up, q|k, down, v, and the
# lm_head padded to 32768
MISTRAL_SHAPES = [(4096, 28672), (4096, 5120), (14336, 4096)]
BF16_ROWS = [1, 5, 16, 17, 64, 256]


@pytest.mark.parametrize("B", BF16_ROWS)
@pytest.mark.parametrize("K,O", MISTRAL_SHAPES + [(512, 272)])
def test_q4k_bf16_gemv_matches_plain(dev, B, K, O):
    """K5: the same bf16 x and exact nibbles on both sides; f32 sums of bf16
    products in another order, the scale on each sub-block's sum (1e-4 of
    max |y|, as K4). Up to 16 rows its decode instantiation, above its rows
    instantiation (the weight as two exact bf16 parts)."""
    qs, _, scale, minv = _q5k_arrays(dev, K, O, B + K)
    x = _acts(B, K, dev, B).to(torch.bfloat16)
    before = (qm.q4k_bf16_gemv_launches, qm.q4k_bf16_gemv_rows_launches)
    got = qm.q4k_bf16_gemv(x, qs, scale, minv, out_dtype=torch.float32)
    want = qm.q4k_bf16_gemv_plain(x, qs, scale, minv, torch.float32)
    torch.cuda.synchronize()
    assert (qm.q4k_bf16_gemv_launches - before[0],
            qm.q4k_bf16_gemv_rows_launches - before[1]) == ((1, 0) if B <= 16 else (0, 1))
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= 1e-4
    y16 = qm.q4k_bf16_gemv(x, qs, scale, minv)
    assert y16.dtype == torch.bfloat16 and _rel_err(y16.float(), want) <= 1e-2


@pytest.mark.parametrize("B", BF16_ROWS)
@pytest.mark.parametrize("K,O", MISTRAL_SHAPES + [(512, 272)])
def test_q5k_hbit_bf16_gemv_matches_plain(dev, B, K, O):
    """K9b's high-bit kernel: the same bf16(scale) * bit weights (exact) on
    both sides, above 16 rows its rows instantiation; at 1-16 rows it has
    none (the whole Q5_K product is K9b's decode instantiation,
    test_q5k_bf16_gemv_matches_plain) and the wrapper raises."""
    _, qh, scale, _ = _q5k_arrays(dev, K, O, B + K + 1)
    x = _acts(B, K, dev, B + 1).to(torch.bfloat16)
    if B <= 16:
        with pytest.raises(ValueError):
            qm.q5k_hbit_bf16_gemv(x, qh, scale)
        return
    before = qm.q5k_hbit_bf16_gemv_rows_launches
    got = qm.q5k_hbit_bf16_gemv(x, qh, scale, out_dtype=torch.float32)
    want = qm.q5k_hbit_bf16_gemv_plain(x, qh, scale, torch.float32)
    torch.cuda.synchronize()
    assert qm.q5k_hbit_bf16_gemv_rows_launches - before == 1
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= 1e-4


# the gguf_bf16 path's Q5_K projections: q|k, o, gate|up, down; and a small
# shape with a partial column tile
Q5K_BF16_SHAPES = [(4096, 5120), (4096, 4096), (4096, 28672), (14336, 4096), (512, 272)]


@pytest.mark.parametrize("B", [1, 4, 5, 9, 16])
@pytest.mark.parametrize("K,O", Q5K_BF16_SHAPES)
def test_q5k_bf16_gemv_matches_plain(dev, B, K, O):
    """K9b's decode instantiation, the whole Q5_K x bf16 product in one
    launch: the same bf16 x, exact nibbles and bits on both sides, f32 sums
    in another order; the f32 out within 1e-5 of max |y| of the plain
    version's, the bf16 out (JAX's roundings, bf16(bf16(y4) + 16 *
    bf16(yh))) within one bf16 ulp of max |y|; bit-equal on repeat; one
    launch counted a call."""
    qs, qh, scale, minv = _q5k_arrays(dev, K, O, B + K + 2)
    x = _acts(B, K, dev, B + 2).to(torch.bfloat16)
    before = qm.q5k_bf16_gemv_launches
    got = qm.q5k_bf16_gemv(x, qs, qh, scale, minv, out_dtype=torch.float32)
    again = qm.q5k_bf16_gemv(x, qs, qh, scale, minv, out_dtype=torch.float32)
    y16 = qm.q5k_bf16_gemv(x, qs, qh, scale, minv)
    want = qm.q5k_bf16_gemv_plain(x, qs, qh, scale, minv, torch.float32)
    want16 = qm.q5k_bf16_gemv_plain(x, qs, qh, scale, minv, torch.bfloat16)
    torch.cuda.synchronize()
    assert qm.q5k_bf16_gemv_launches - before == 3
    assert bool(torch.isfinite(got).all()) and _rel_err(got, want) <= 1e-5
    assert torch.equal(got, again)
    top = float(want.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    assert y16.dtype == torch.bfloat16
    assert float((y16.float() - want16.float()).abs().max()) <= ulp


@pytest.mark.parametrize("B", [1, 2, 5, 8, 9, 16, 17, 64, 256])
@pytest.mark.parametrize("K,O,sdt", [(4096, 1024, torch.float32), (14336, 4096, torch.float32),
                                     (4096, 32768, torch.float32), (4096, 32768, torch.bfloat16),
                                     (1024, 272, torch.bfloat16), (1056, 144, torch.float32),
                                     (4096, 28672, torch.float32)])
def test_q8_0_bf16_gemv_matches_plain(dev, B, K, O, sdt):
    """K8: the same bf16(q * bf16(s)) weights on both sides (rq8's f32
    scales are rounded to bf16 first, as the JAX kernel casts them). Up to
    16 rows its decode instantiation (clusters of 8 splits at v and down,
    one split at gate|up and the lm_head, a partial column tile, a last
    step of 32 rows at K 1056), above its rows instantiation; bit-equal on
    a repeat."""
    g = torch.Generator(device="cpu").manual_seed(B + K + O)
    q = torch.randint(-128, 128, (K, O), generator=g, dtype=torch.int8).to(dev)
    s = (torch.rand(K // 32, O, generator=g) * 3e-4 + 1e-4).to(dev, sdt)
    x = _acts(B, K, dev, B + 2).to(torch.bfloat16)
    before = (qm.q8_0_bf16_gemv_launches, qm.q8_0_bf16_gemv_rows_launches)
    got = qm.q8_0_bf16_gemv(x, q, s, out_dtype=torch.float32)
    want = qm.q8_0_bf16_gemv_plain(x, q, s, torch.float32)
    torch.cuda.synchronize()
    assert (qm.q8_0_bf16_gemv_launches - before[0],
            qm.q8_0_bf16_gemv_rows_launches - before[1]) == ((1, 0) if B <= 16 else (0, 1))
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= 1e-4
    assert torch.equal(qm.q8_0_bf16_gemv(x, q, s, out_dtype=torch.float32), got)


# K5's rows instantiation at the Q4_K / Q5_K projections (gate|up with one K
# split at 256 rows, q|k, o and down with more) and a column tail; K8's at
# the rq8 v (8 splits), down (2) and lm_head (1), wire Q8_0's lm_head, and a
# column tail with bf16 scales
K5_ROWS_SHAPES = [(4096, 28672), (4096, 5120), (4096, 4096), (14336, 4096), (512, 272)]
K8_ROWS_SHAPES = [(4096, 1024, torch.float32), (14336, 4096, torch.float32),
                  (4096, 32768, torch.float32), (4096, 32768, torch.bfloat16),
                  (1024, 272, torch.bfloat16)]
K5_K8_ROWS_B = [17, 64, 129, 256]


def _q8_bf16_arrays(dev, K, O, sdt, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randint(-128, 128, (K, O), generator=g, dtype=torch.int8).to(dev)
    s = (torch.rand(K // 32, O, generator=g) * 3e-4 + 1e-4).to(dev, sdt)
    return q, s


def _rows_case(dev, plan, call, plain, counters):
    """One rows-instantiation call against its plain version: f32 out within
    1e-4 of max |y|, bit-equal on repeat, bf16 out the f32 out rounded
    once, three launches counted as rows and none as 16-row."""
    assert plan.rows in (64, 128)
    before = [getattr(qm, c) for c in counters]
    got, again, y16 = call(torch.float32), call(torch.float32), call(torch.bfloat16)
    want = plain()
    torch.cuda.synchronize()
    assert [getattr(qm, c) - b for c, b in zip(counters, before)] == [0, 3]
    assert bool(torch.isfinite(got).all()) and _rel_err(got, want) <= 1e-4, plan
    assert torch.equal(got, again)
    assert torch.equal(y16, got.to(torch.bfloat16))


@pytest.mark.parametrize("B", K5_K8_ROWS_B)
@pytest.mark.parametrize("K,O", K5_ROWS_SHAPES)
def test_q4k_bf16_gemv_rows_matches_plain(dev, K, O, B):
    """K5's rows instantiation with one K split and with many: within 1e-4
    of max |y| of the plain version (the weight q * s exact, only the f32
    sums' order differs), bit-equal on repeat."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qs, _, scale, minv = _q5k_arrays(dev, K, O, B + K + O + 5)
    x = _acts(B, K, dev, B + 5).to(torch.bfloat16)
    _rows_case(dev, qm.q4k_bf16_plan(B, K, O, sms),
               lambda dt: qm.q4k_bf16_gemv(x, qs, scale, minv, out_dtype=dt),
               lambda: qm.q4k_bf16_gemv_plain(x, qs, scale, minv, torch.float32),
               ("q4k_bf16_gemv_launches", "q4k_bf16_gemv_rows_launches"))


@pytest.mark.parametrize("B", K5_K8_ROWS_B)
@pytest.mark.parametrize("K,O,sdt", K8_ROWS_SHAPES)
def test_q8_0_bf16_gemv_rows_matches_plain(dev, K, O, sdt, B):
    """K8's rows instantiation (x read in place) with one K split and with
    many, f32 and bf16 scales: within 1e-4 of max |y| of the plain version
    (the same bf16(q * bf16(s)) weights), bit-equal on repeat."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    q, s = _q8_bf16_arrays(dev, K, O, sdt, B + K + O + 6)
    x = _acts(B, K, dev, B + 6).to(torch.bfloat16)
    _rows_case(dev, qm.q8_0_bf16_plan(B, K, O, sdt == torch.float32, sms),
               lambda dt: qm.q8_0_bf16_gemv(x, q, s, out_dtype=dt),
               lambda: qm.q8_0_bf16_gemv_plain(x, q, s, torch.float32),
               ("q8_0_bf16_gemv_launches", "q8_0_bf16_gemv_rows_launches"))


def test_k5_k8_rows_split_at_one_and_several(dev):
    """The shapes above reach the rows instantiations at one K split and at
    several, for each of the two kernels."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k5 = {qm.q4k_bf16_plan(B, K, O, sms).ksplit for K, O in K5_ROWS_SHAPES for B in K5_K8_ROWS_B}
    k8 = {qm.q8_0_bf16_plan(B, K, O, sdt == torch.float32, sms).ksplit
          for K, O, sdt in K8_ROWS_SHAPES for B in K5_K8_ROWS_B}
    assert 1 in k5 and max(k5) > 1 and 1 in k8 and max(k8) > 1, (k5, k8)


@pytest.mark.parametrize("K,O", [(512, 272), (4096, 1024)])
def test_q4k_rows_weight_is_exact(dev, K, O):
    """One-hot rows of x read single weights: with x = e_k and minv = 0 the
    rows kernel's f32 out is q * s exactly (its two bf16 parts add up to
    the exact product), the plain version's bit for bit, for every element
    k of both nibble planes; a weight rounded to bf16 would not be."""
    qs, _, scale, minv = _q5k_arrays(dev, K, O, K + 7)
    minv = torch.zeros_like(minv)
    q = torch.cat([qs & 0xF, qs >> 4], dim=0).float()
    exact = q * torch.repeat_interleave(scale.float(), 32, dim=0)
    assert not torch.equal(exact.to(torch.bfloat16).float(), exact)
    for k0 in range(0, K, 256):
        x = torch.zeros(256, K, dtype=torch.bfloat16, device=dev)
        x[torch.arange(256), k0 + torch.arange(256)] = 1.0
        got = qm.q4k_bf16_gemv(x, qs, scale, minv, out_dtype=torch.float32)
        assert torch.equal(got, exact[k0:k0 + 256]), k0
        assert torch.equal(got, qm.q4k_bf16_gemv_plain(x, qs, scale, minv, torch.float32)), k0


@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,O", [(1024, 272), (4096, 1024)])
def test_q8_0_rows_decode_is_bit_equal_to_the_plain_weight(dev, K, O, sdt):
    """With x = e_k the rows kernel's f32 out is bf16(q * bf16(s)), the
    plain version's weight, bit for bit, for every element k."""
    q, s = _q8_bf16_arrays(dev, K, O, sdt, K + 8)
    w = qm.q8_0_dequant_plain(q, s, 32, torch.bfloat16).float()
    for k0 in range(0, K, 256):
        x = torch.zeros(256, K, dtype=torch.bfloat16, device=dev)
        x[torch.arange(256), k0 + torch.arange(256)] = 1.0
        got = qm.q8_0_bf16_gemv(x, q, s, out_dtype=torch.float32)
        assert torch.equal(got, w[k0:k0 + 256]), k0


def test_k5_k8_rows_count_apart(dev):
    """At 16 rows K5 and K8 launch their decode instantiations, at 17 their
    rows instantiations, each counted apart."""
    K, O = 1024, 256
    qs, _, scale, minv = _q5k_arrays(dev, K, O, 9)
    q, s = _q8_bf16_arrays(dev, K, O, torch.float32, 10)

    def counts():
        return [getattr(qm, f"{n}{r}_launches") for n in ("q4k_bf16_gemv", "q8_0_bf16_gemv")
                for r in ("", "_rows")]

    for B, want in ((16, [1, 0, 1, 0]), (17, [0, 1, 0, 1])):
        x = _acts(B, K, dev, B).to(torch.bfloat16)
        before = counts()
        qm.q4k_bf16_gemv(x, qs, scale, minv)
        qm.q8_0_bf16_gemv(x, q, s)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(counts(), before)] == want, B


@pytest.mark.parametrize("mix", ["Q4_K", "Q5_K"])
def test_gguf_bf16_prefill_of_256_rows_matches_the_cpu(dev, tmp_path, mix):
    """A 2-layer GGUF at hidden 1024 in the Q4_K_M or Q5_K_M rule (random
    wire blocks, rq8 at group 32), served with int8_activations=False on
    the card (bf16) and on the CPU (plain versions, f32): the 256-token
    prefill step runs K5's and K8's rows instantiations on the card, no int8
    GEMV; every step's logits are finite and its greedy token is the CPU's
    wherever the CPU's top two logits are further apart than twice the
    step's largest card-CPU difference (bf16 activations against f32 ones:
    a closer pair is not decided by the kernels). The logits' distance is
    chip_smoke's card_vs_cpu_bf16 check, at full width: this model's
    logits span ~4, so a few bf16 roundings weigh more against them.

    What sets that distance is not the rows kernels
    (scripts/torch_gguf_bf16_gap.py, which this test runs): every K5, K8 and
    K9b rows call of the prefill agrees with its plain version on its own
    bf16 input as the kernel phase's do (bound 1e-5 of max |y|), and the
    card's logits on the rows kernels stay within 2e-2 of its logits on the
    dequant route (dequant kernels + torch.matmul, the same bf16
    activations; they differ by K5's exact weight against its bf16
    rounding), whose own distance to the CPU is the rows route's."""
    import importlib.util
    from pathlib import Path

    import numpy as np

    import chip_smoke

    script = Path(chip_smoke.__file__).resolve().parent / "scripts" / "torch_gguf_bf16_gap.py"
    spec = importlib.util.spec_from_file_location("torch_gguf_bf16_gap", script)
    gap = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gap)
    numbers, runs, card = gap.run(mix, dev, str(tmp_path))
    assert card["q4k_bf16_gemv_rows"] > 0 and card["q8_0_bf16_gemv_rows"] > 0, card
    for name in ("k5_rows", "k8_rows") + (("k9b_rows",) if mix == "Q5_K" else ()):
        worst, calls = numbers[name]
        assert calls > 0 and worst <= 1e-5, numbers
    assert numbers["rows_vs_dequant_all"] <= 2e-2, numbers
    assert not any(card[k] for k in chip_smoke.INT8_COUNTERS), card
    ref, got = runs["cpu"], runs["cuda"]
    assert np.isfinite(got).all()
    top2 = np.sort(ref, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * np.abs(got - ref).max(axis=1)
    assert (ref.argmax(1) == got.argmax(1))[decided].all(), decided


def test_bf16_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    qs, qh, scale, minv = _q5k_arrays(dev, 512, 256, 2)
    x = _acts(4, 512, dev, 1)
    q = torch.zeros(512, 256, dtype=torch.int8, device=dev)
    s = torch.zeros(16, 256, dtype=torch.float32, device=dev)
    for call in (lambda: qm.q4k_bf16_gemv(x, qs, scale, minv),  # f32 x
                 lambda: qm.q5k_hbit_bf16_gemv(x, qh, scale),
                 lambda: qm.q8_0_bf16_gemv(x, q, s),
                 lambda: qm.q4k_bf16_gemv(x.to(torch.bfloat16), qs, scale.float(), minv),
                 lambda: qm.q5k_hbit_bf16_gemv(x.to(torch.bfloat16)[:, :256], qh[:32], scale),
                 lambda: qm.q8_0_bf16_gemv(x.to(torch.bfloat16), q, s.to(torch.float16))):
        with pytest.raises(ValueError):
            call()


def test_gguf_pipeline_decodes_on_the_bf16_route(dev, tmp_path):
    """A 2-layer Mistral GGUF at hidden 1024 in the Q5_K_M rule (random wire
    blocks, chip_smoke.write_random_gguf), loaded by load_gguf_model and
    served with int8_activations=False: a 40-token prefill and 8 greedy
    decode steps take K9b and K8 (both instantiations of each; K9b's decode
    one the whole Q5_K product) and K5's rows instantiation, and neither
    K5's decode instantiation (the Q5_K_M rule has no Q4_K tensor) nor an
    int8 GEMV; tokens are in the vocabulary and logits finite."""
    import numpy as np

    import chip_smoke
    from mistralrs_tpu_torch.engine.engine import Engine, GenerationRequest
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.pipeline.gguf import load_gguf_model
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    sz = chip_smoke.Sizes(vocab=2048, hidden=1024, inter=2048, heads=8, kv_heads=2, layers=2)
    path = str(tmp_path / "tiny.gguf")
    chip_smoke.write_random_gguf(path, sz, 2, "Q5_K", seed=3)
    cfg, params, rope, _ = load_gguf_model(path)
    assert params.embed.device.type == "cuda" and params.embed.dtype == torch.bfloat16
    pipe = TextPipeline(cfg, params, rope, PipelineConfig(
        num_pages=64, max_seqs=4, max_model_len=512, prefill_buckets=(64,), decode_steps=4,
        int8_activations=False))
    eng = Engine(pipe, eos_token_ids=set(), prefix_cache=False)
    names = ("q5k_bf16_gemv", "q8_0_bf16_gemv", "q5k_hbit_bf16_gemv_rows", "q4k_bf16_gemv_rows",
             "q8_0_bf16_gemv_rows", "q4k_bf16_gemv",
             "q4k_q8_gemv", "q8_0_q8_gemv", "q5k_q8_gemv", "q6k_q8_gemv", "q5k_q8_gemv_rows")
    before = {n: getattr(qm, f"{n}_launches") for n in names}
    rng = np.random.default_rng(0)
    group = eng.add_request(GenerationRequest([int(t) for t in rng.integers(1, 2048, 40)],
                                              SamplingParams(max_len=8)))
    while not group.all_done():
        eng.step()
    torch.cuda.synchronize()
    ran = {n: getattr(qm, f"{n}_launches") - before[n] for n in names}
    assert all(ran[n] > 0 for n in names[:5]) and not any(ran[n] for n in names[5:]), ran
    (seq,) = group.seqs
    assert seq.num_generated == 8 and all(0 <= t < 2048 for t in seq.generated_tokens)
    assert np.isfinite(pipe.last_greedy_pack).all()


# ------------------------------------------------------------- the decode loop's graphs

# each route the decode graphs carry: (builder, config, the counters of the
# kernels a decode call must launch, PipelineConfig fields, prompt tokens)
GRAPH_ROUTES = {
    "k1_k2": ("random_q4km_params", "model_config", ("q4k_q8_gemv", "q8_0_q8_gemv"), {}, 200),
    "k7_head_major": ("random_q4km_params", "model_config", ("paged_decode",),
                      {"max_model_len": 4096, "num_pages": 352}, 2100),
    "k12_ragged": ("random_q4km_params", "model_config", ("ragged_attention",),
                   {"attn_backend": "ragged"}, 200),
    "k13_mixtral": ("random_mixtral_params", "mixtral_config", ("grouped_gemm",), {}, 200),
    "bf16_k5_k8": ("random_q4km_params", "model_config", ("q4k_bf16_gemv", "q8_0_bf16_gemv"),
                   {"int8_activations": False}, 200),
    "bf16_k9b_k8": ("random_q5km_params", "model_config", ("q5k_bf16_gemv", "q8_0_bf16_gemv"),
                    {"int8_activations": False}, 200),
    # int8 KV pools: decode on the gather route over dequantized pages
    "int8_kv": ("random_q4km_params", "model_config", ("q4k_q8_gemv",), {"kv_quant": True}, 200),
    # int8 pools at span 32768 (past 16,384): decode on the blockwise route
    "int8_kv_blockwise": ("random_q4km_params", "model_config", ("q4k_q8_gemv", "blockwise_steps"),
                          {"kv_quant": True, "max_model_len": 32768, "num_pages": 2720}, 16500),
}


def _launch_deltas(fn):
    from mistralrs_tpu_torch.pipeline import graphs

    before = graphs.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = graphs.launch_counts()
    return out, {name: after[(m, name)] - n for (m, name), n in before.items()
                 if after[(m, name)] != n}


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("route", list(GRAPH_ROUTES))
def test_decode_loop_replays_bit_equal_to_the_eager_loop(dev, route, sampled):
    """A 2-layer full-width pipeline (chip_smoke's builders, 4 slots, 3
    prefilled sequences, 4 steps a call) on each route the decode graphs
    carry: run_decode_multi (captured on its first call under sync debug
    mode "error", then replayed under it) against run_decode_multi_eager on
    the same inputs, greedy and sampled at one seed: tokens equal, packs
    bit-equal, and a replay's launch counts equal the eager loop's (the
    route's kernels among them)."""
    import numpy as np

    import chip_smoke as cs
    from mistralrs_tpu_torch.engine.block_manager import BlockManager
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.engine.sequence import Sequence
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.pipeline import graphs
    from mistralrs_tpu_torch.pipeline import text
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    build, config, want, over, plen = GRAPH_ROUTES[route]
    sz = cs.MIXTRAL if route == "k13_mixtral" else cs.Sizes()
    cfg = getattr(cs, config)(sz, 2)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = getattr(cs, build)(sz, 2, dev, gen, torch.bfloat16)
    pc = PipelineConfig(**{"page_size": 16, "num_pages": 96, "max_seqs": 4, "max_model_len": 2048,
                           "prefill_buckets": (64, 512), "decode_steps": 4,
                           "dtype": torch.bfloat16, "device": "cuda", **over})
    pipe = TextPipeline(cfg, params, make_rope(cfg, pc.max_model_len, device=dev), pc)
    del params
    bm = BlockManager(pc.num_pages, pc.page_size)
    rng = np.random.default_rng(1)
    seqs = []
    for n in (plen, plen - 17, plen // 2):
        seq = Sequence([int(t) for t in rng.integers(1, sz.vocab, n)], SamplingParams(max_len=8),
                       max_model_len=pc.max_model_len)
        bm.allocate(seq)
        for start in range(0, n, 512):
            pipe.run_prefill_chunk(seq, seq.tokens[start:start + 512])
        seq.tokens.append(int(rng.integers(1, sz.vocab)))
        bm.append_slot(seq, pc.decode_steps)
        seqs.append(seq)
    sampling = ([1.5, 0.8, 1.0], [40, 64, 1], [1.0, 0.9, 1.0], [0.0, 0.05, 0.0], 99) \
        if sampled else None

    def rewind():
        for seq in seqs:
            seq.kv_len -= pc.decode_steps

    eager, d_eager = _launch_deltas(lambda: pipe.run_decode_multi_eager(seqs, sampling))
    rewind()
    captures, replays = graphs.decode_graph_captures, graphs.decode_graph_replays
    first = pipe.run_decode_multi(seqs, sampling)
    rewind()
    assert (graphs.decode_graph_captures, graphs.decode_graph_replays) == (captures + 1,
                                                                          replays + 1)
    key = pipe._fill_loop(seqs, sampling)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, d_replay = _launch_deltas(lambda: pipe.graphs.replay(key, pipe._decode_loop))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again = out.cpu().numpy()[:, :, :len(seqs)]
    assert graphs.decode_graph_captures == captures + 1
    for pack in (first, again):
        np.testing.assert_array_equal(pack[0], eager[0])
        assert np.array_equal(pack, eager)  # bit-equal, NaNs none
    assert np.isfinite(eager).all() and ((eager[0] >= 0) & (eager[0] < sz.vocab)).all()
    assert d_replay == d_eager and all(
        d_replay.get(n if n.endswith("_steps") else f"{n}_launches", 0) > 0 for n in want), (
        d_replay, d_eager)
    assert text.decode_eager_loops >= 1 and len(pipe.graphs.graphs) == 1
    assert pipe.graphs.pool_bytes() > 0


@pytest.mark.parametrize("kv_quant", [False, True])
def test_swap_between_replays_leaves_the_next_replay_unchanged(dev, kv_quant):
    """Two 2-layer full-width pipelines (chip_smoke's builders) over the same
    weights and the same prefilled pools, 3 sequences, a decode call each
    (captured, replayed). Then on one of them the second sequence is swapped
    out by the engine's _swap_out_seq, its pages freed, taken by another
    sequence and overwritten, and the sequence swapped back in
    (_swap_in_seq) into fresh pages: its context reads back bit-equal
    through the new pages, and the next call (a replay of the same graph)
    gives a pack, and writes K/V, bit-equal to the unswapped pipeline's, on
    bf16 and on int8 pools; the pools keep their addresses. (On random
    weights a pack depends little on the context: the page checks carry
    the test.)"""
    import numpy as np

    import chip_smoke as cs
    from mistralrs_tpu_torch.engine.block_manager import BlockManager
    from mistralrs_tpu_torch.engine.engine import Engine
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.engine.sequence import Sequence
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.ops.paged_attention import _pool_leaves
    from mistralrs_tpu_torch.pipeline import graphs
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    sz = cs.Sizes()
    cfg = cs.model_config(sz, 2)
    gen = torch.Generator(device=dev).manual_seed(0)
    pc = PipelineConfig(page_size=16, num_pages=96, max_seqs=4, max_model_len=2048,
                        prefill_buckets=(64, 256), decode_steps=4, dtype=torch.bfloat16,
                        device="cuda", kv_quant=kv_quant)
    rope = make_rope(cfg, pc.max_model_len, device=dev)
    a = TextPipeline(cfg, cs.random_q4km_params(sz, 2, dev, gen, torch.bfloat16), rope, pc)
    b = TextPipeline(cfg, a.params, rope, pc)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, sz.vocab, n)] for n in (200, 183, 100)]
    sides = []
    for pipe in (a, b):
        bm = BlockManager(pc.num_pages, pc.page_size)
        seqs = []
        for p in prompts:
            seq = Sequence(list(p), SamplingParams(max_len=16), max_model_len=pc.max_model_len)
            bm.allocate(seq)
            seqs.append(seq)
        sides.append((pipe, bm, seqs))
    a.run_prefill_chunks([(s, list(s.tokens)) for s in sides[0][2]])
    for dst, src in zip(_pool_leaves(b.cache).values(), _pool_leaves(a.cache).values()):
        dst.copy_(src)
    for _, _, seqs in sides:
        for seq in seqs:
            seq.prefill_done_tokens = seq.kv_len = len(seq.tokens)
            seq.tokens.append(7)  # the token the first call feeds

    def call(side):
        """One decode call; its tokens join each sequence, the last one fed next."""
        pipe, bm, seqs = side
        for seq in seqs:
            bm.append_slot(seq, pc.decode_steps)
        pack = pipe.run_decode_multi(seqs)
        for i, seq in enumerate(seqs):
            seq.tokens.extend(int(t) for t in pack[0][:, i])
        return pack

    first = [call(side) for side in sides]
    assert np.array_equal(first[0], first[1])
    ptrs = [t.data_ptr() for t in _pool_leaves(a.cache).values()]
    _, bm, seqs = sides[0]
    seq = seqs[1]
    old = list(seq.block_table)
    eng = Engine(a, eos_token_ids=set(), prefix_cache=False, preempt_mode="swap")
    eng._swap_out_seq(seq)
    bm.free_sequence(seq)
    other = Sequence([1] * (16 * len(old)), SamplingParams(max_len=1),
                     max_model_len=pc.max_model_len)
    bm.allocate(other)  # takes the freed pages first
    assert set(old) <= set(other.block_table)
    at = (slice(None),) * a.cache.page_axis + (old,)
    for leaf in _pool_leaves(a.cache).values():
        leaf[at] = 3 if leaf.dtype == torch.int8 else 1e3
    bm.allocate(seq)
    assert not set(seq.block_table) & set(old)
    eng._swap_in_seq(seq)
    assert seq.swap_host is None
    twin = sides[1][2][1]

    def context(pipe, s, n):
        """Every leaf's first n pages of s, in table order."""
        idx = torch.tensor(s.block_table[:n], device=dev)
        return [leaf.index_select(pipe.cache.page_axis, idx)
                for leaf in _pool_leaves(pipe.cache).values()]

    live = -(-seq.kv_len // pc.page_size)
    assert all(torch.equal(x, y) for x, y in zip(context(a, seq, live), context(b, twin, live)))
    replays = graphs.decode_graph_replays
    got, want = call(sides[0]), call(sides[1])
    assert graphs.decode_graph_replays == replays + 2 and len(a.graphs.graphs) == 1
    assert np.array_equal(got, want) and np.isfinite(got).all()
    # the replay wrote the new tokens' K/V through the new table, as b did
    live = -(-seq.kv_len // pc.page_size)
    assert all(torch.equal(x, y) for x, y in zip(context(a, seq, live), context(b, twin, live)))
    assert [t.data_ptr() for t in _pool_leaves(a.cache).values()] == ptrs


# ------------------------------------------------------------- runtime re-quantization

# (builder, config, the kernels a decode call launches before and after
# re_isq("Q8_0")): Mistral-7B Q4_K_M (rq8) and Gemma-2-9B as ISQ Q4K loads it
RE_ISQ_MODELS = {
    "q4km": ("random_q4km_params", "model_config", ("q4k_q8_gemv",), "Sizes"),
    "gemma2": ("random_gemma2_params", "gemma2_config", ("q4k_q8_gemv",), "GEMMA2"),
}


@pytest.mark.parametrize("model", list(RE_ISQ_MODELS))
def test_re_isq_drops_the_decode_graphs(dev, model):
    """A 2-layer full-width pipeline (4 slots, 3 prefilled sequences, 4 steps
    a call) whose decode graph was captured and replayed; then
    re_isq("Q8_0") and run_decode_multi again: a new graph is captured
    (the old one, which read the freed Q4_K weights, is gone), K2 serves
    the call, and its pack is bit-equal to a fresh pipeline's over the
    requantized params and the same KV pool, replayed and eager alike."""
    import numpy as np

    import chip_smoke as cs
    from mistralrs_tpu_torch.engine.block_manager import BlockManager
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.engine.sequence import Sequence
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.pipeline import graphs
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    build, config, before_kernels, sizes = RE_ISQ_MODELS[model]
    sz = cs.Sizes() if sizes == "Sizes" else getattr(cs, sizes)
    cfg = getattr(cs, config)(sz, 2)
    gen = torch.Generator(device=dev).manual_seed(0)
    pc = PipelineConfig(page_size=16, num_pages=64, max_seqs=4, max_model_len=2048,
                        prefill_buckets=(64, 256), decode_steps=4, dtype=torch.bfloat16,
                        device="cuda")
    rope = make_rope(cfg, pc.max_model_len, device=dev)
    pipe = TextPipeline(cfg, getattr(cs, build)(sz, 2, dev, gen, torch.bfloat16), rope, pc)
    bm = BlockManager(pc.num_pages, pc.page_size)
    rng = np.random.default_rng(1)
    seqs = []
    for n in (200, 183, 100):
        seq = Sequence([int(t) for t in rng.integers(1, sz.vocab, n)], SamplingParams(max_len=8),
                       max_model_len=pc.max_model_len)
        bm.allocate(seq)
        pipe.run_prefill_chunk(seq, seq.tokens)
        seq.tokens.append(int(rng.integers(1, sz.vocab)))
        bm.append_slot(seq, pc.decode_steps)
        seqs.append(seq)

    def call(p, eager=False):
        out, d = _launch_deltas(lambda: (p.run_decode_multi_eager if eager
                                         else p.run_decode_multi)(seqs, None))
        for seq in seqs:
            seq.kv_len -= pc.decode_steps
        return out, d

    _, d_old = call(pipe)
    assert all(d_old.get(f"{n}_launches", 0) > 0 for n in before_kernels), d_old
    captures = graphs.decode_graph_captures
    pipe.re_isq("Q8_0")
    assert pipe.graphs is not None and not pipe.graphs.graphs
    assert cs.served_kinds(pipe) == ["gguf_q8_0"]
    new, d_new = call(pipe)
    assert graphs.decode_graph_captures == captures + 1
    assert d_new.get("q8_0_q8_gemv_launches", 0) > 0 and not d_new.get("q4k_q8_gemv_launches")
    fresh = TextPipeline(cfg, pipe.params, rope, pc)
    fresh.cache.k.copy_(pipe.cache.k)
    fresh.cache.v.copy_(pipe.cache.v)
    for got in (call(fresh)[0], call(fresh, eager=True)[0]):
        assert np.array_equal(got, new)
    assert np.isfinite(new).all() and ((new[0] >= 0) & (new[0] < sz.vocab)).all()


# ------------------------------------------------------------- the speculative loops' graphs

SPEC_GAMMA, SPEC_ROUNDS = 4, 3


def _spec_setup(dev, kind: str):
    """A 2-layer full-width Mistral-7B Q4_K_M pipeline (chip_smoke's
    builders; 16 slots, so the verify's 80 rows and the draft's 32-row
    catch-up take K1's and K2's rows instantiations and its 16-row feeds
    the decode ones), its speculative pipeline (kind "draft": the target's
    first layer as the draft, chip_smoke.draft_prefix; "pld": prompt
    lookup; with "_int8", kv_quant pools) at gamma 4 and 3 rounds a call,
    and 3 prefilled sequences (for "draft" the second's draft two tokens
    behind)."""
    import numpy as np

    import chip_smoke as cs
    from mistralrs_tpu_torch.engine.block_manager import BlockManager
    from mistralrs_tpu_torch.engine.sampler import SamplingParams
    from mistralrs_tpu_torch.engine.sequence import Sequence
    from mistralrs_tpu_torch.models.loader import make_rope
    from mistralrs_tpu_torch.pipeline.speculative import PromptLookupPipeline, SpeculativePipeline
    from mistralrs_tpu_torch.pipeline.text import PipelineConfig, TextPipeline

    sz = cs.Sizes()
    cfg = cs.model_config(sz, 2)
    gen = torch.Generator(device=dev).manual_seed(0)
    kv_quant = kind.endswith("_int8")
    kind = kind.removesuffix("_int8")
    pc = PipelineConfig(page_size=16, num_pages=96, max_seqs=16, max_model_len=2048,
                        prefill_buckets=(64, 256), decode_steps=4, dtype=torch.bfloat16,
                        device="cuda", kv_quant=kv_quant)
    target = TextPipeline(cfg, cs.random_q4km_params(sz, 2, dev, gen, torch.bfloat16),
                          make_rope(cfg, pc.max_model_len, device=dev), pc)
    if kind == "draft":
        pipe = SpeculativePipeline(target, cs.draft_prefix(target, 1), SPEC_GAMMA, SPEC_ROUNDS)
    else:
        pipe = PromptLookupPipeline(target, SPEC_GAMMA, spec_rounds=SPEC_ROUNDS, hist_cap=256)
    bm = BlockManager(pc.num_pages, pc.page_size)
    rng = np.random.default_rng(1)
    seqs = []
    for n in (200, 183, 100):
        seg = [int(t) for t in rng.integers(1, sz.vocab, 32 if kind == "pld" else n)]
        seq = Sequence((seg * (n // len(seg) + 1))[:n], SamplingParams(max_len=64),
                       max_model_len=pc.max_model_len)
        bm.allocate(seq)
        pipe.run_prefill_chunk(seq, seq.tokens)
        seq.tokens.append(int(rng.integers(1, sz.vocab)))
        bm.append_slot(seq, SPEC_ROUNDS * (SPEC_GAMMA + 1))
        seqs.append(seq)
    if kind == "draft":
        seqs[1].draft_kv_len = len(seqs[1].tokens) - 2
    return pipe, seqs


@pytest.mark.parametrize("kind", ["draft", "pld", "draft_int8", "pld_int8"])
def test_spec_loop_replays_bit_equal_to_the_eager_loop(dev, kind):
    """run_spec_multi (captured on its first call under sync debug mode
    "error", then replayed under it) against run_spec_multi_eager on the
    same inputs: packs bit-equal, a replay's launch counts equal to the
    eager loop's, K1 and K2 at their rows instantiations among them (and
    at their decode ones for the model draft); "_int8": the target's and
    the draft's KV pools int8 (kv_quant)."""
    import numpy as np

    from mistralrs_tpu_torch.pipeline import graphs
    from mistralrs_tpu_torch.pipeline import speculative as spec

    pipe, seqs = _spec_setup(dev, kind)
    loops = spec.spec_eager_loops
    eager, d_eager = _launch_deltas(lambda: pipe.run_spec_multi_eager(seqs))
    captures, replays = graphs.spec_graph_captures, graphs.spec_graph_replays
    first = pipe.run_spec_multi(seqs)
    assert (graphs.spec_graph_captures, graphs.spec_graph_replays) == (captures + 1, replays + 1)
    key, offs = pipe._fill_spec(seqs)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, d_replay = _launch_deltas(lambda: pipe.graphs.replay(key, pipe._spec_loop))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again = pipe._spec_result(seqs, out, offs)
    assert graphs.spec_graph_captures == captures + 1 and spec.spec_eager_loops == loops + 1
    W = SPEC_GAMMA + 1
    for pack in (first, again):
        assert np.array_equal(pack, eager)  # bit-equal, NaNs none
    assert np.isfinite(eager).all() and ((eager[:, :, :W] >= 0) & (eager[:, :, :W] < 32000)).all()
    counts = eager[:, :, 2 * W]
    assert counts.min() >= 1 and counts.max() <= W
    want = ["q4k_q8_gemv_rows", "q8_0_q8_gemv_rows"]
    if kind.startswith("draft"):
        want += ["q4k_q8_gemv", "q8_0_q8_gemv"]
    assert d_replay == d_eager and all(d_replay.get(f"{n}_launches", 0) > 0 for n in want), (
        d_replay, d_eager)
    assert len(pipe.graphs.graphs) == 1 and pipe.graphs.pool_bytes() > 0


def test_re_isq_of_the_target_drops_the_spec_graphs(dev):
    """The model-draft loop's graph captured and replayed; then the target's
    re_isq("Q8_0"): the next run_spec_multi captures a new graph in a new
    store (the old one read the freed Q4_K weights), K2 serves the target's
    projections in it, and its pack is bit-equal to the eager loop's."""
    import numpy as np

    from mistralrs_tpu_torch.pipeline import graphs

    pipe, seqs = _spec_setup(dev, "draft")
    pipe.run_spec_multi(seqs)
    old = pipe.graphs
    pipe.target.re_isq("Q8_0")
    captures = graphs.spec_graph_captures
    new, d_new = _launch_deltas(lambda: pipe.run_spec_multi(seqs))
    assert graphs.spec_graph_captures == captures + 1 and pipe.graphs is not old
    assert d_new.get("q8_0_q8_gemv_rows_launches", 0) > 0
    assert np.array_equal(new, pipe.run_spec_multi_eager(seqs))
    assert np.array_equal(pipe.run_spec_multi(seqs), new)
    assert graphs.spec_graph_captures == captures + 1
