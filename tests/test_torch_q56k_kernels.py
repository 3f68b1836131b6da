"""Port vs JAX package: the plain versions of K3 (Q6_K x int8), K4 (Q6_K x
activations in their dtype) and K9 (Q5_K x int8), and the routes of the
q6k_matmul / q5k_matmul dispatchers.

The JAX side runs its Pallas kernels under the TPU interpreter, as
tests/test_quant_matmul_kernel.py does. K3 and K9 quantize the activations
as JAX does (the scale may differ by one f32 ulp) and take exact integer
dots, so only the order of the f32 sums of scaled dots differs: 1e-5 of the
largest |y|. K4 does the same f32 products as `_q6k_kernel` in f32 here, in
another order: 1e-5 too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mistralrs_tpu.gguf.reader import GGMLType
from mistralrs_tpu.ops import quant_matmul as jqm
from mistralrs_tpu.quant import gguf_linear as jgl
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.quant import gguf_linear as tgl
from torch_port_model import quantized

SUM_ORDER_RTOL = 1e-5


def _pair(gtype, out_f, in_f, seed):
    rng = np.random.default_rng(seed)
    raw, jl = quantized(rng, gtype, out_f, in_f, 0.3)
    tl = tgl.linear_from_gguf(raw, int(gtype), (out_f, in_f), dtype=torch.float32, device="cpu")
    return jl, tl


def _x(B, K, seed):
    return (np.random.default_rng(seed).standard_normal((B, K)) * 0.7).astype(np.float32)


def _close(got, want, rtol=SUM_ORDER_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max() + 1e-6


def _pad8(x):
    return np.pad(x, ((0, (-x.shape[0]) % 8), (0, 0)))


@pytest.mark.parametrize("K", [1024, 4096])
@pytest.mark.parametrize("B", [1, 8])
def test_k3_plain_matches_pallas_q6k_q8(B, K):
    O = 256
    jl, tl = _pair(GGMLType.Q6_K, O, K, B + K)
    G = tl.meta
    assert G == (256 if K == 1024 else 512)
    x = _x(B, K, 3 + B)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm._q6k_q8_matmul_padded(
            jnp.asarray(_pad8(x)), jl.data["ql"], jl.data["qh"], jl.data["scale"],
            block_o=O, G=G, out_dtype=jnp.float32))[:B]
    got = tqm.q6k_q8_gemv(torch.from_numpy(x), tl.data["ql"], tl.data["qh"], tl.data["scale"],
                          G, out_dtype=torch.float32)
    _close(got.numpy(), want)


def _k4_against_pallas(K, natural, B):
    O = 256
    jl, tl = _pair(GGMLType.Q6_K, O, K, K)
    G = tl.meta
    assert G == (512 if natural else 128)
    x = _x(B, K, 5)
    xin = x if natural else x[:, np.asarray(jl.data["perm"])]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm._q6k_matmul_padded(
            jnp.asarray(xin), jl.data["ql"], jl.data["qh"], jl.data["scale"],
            block_o=O, G=G, natural=natural))
    got = tqm.q6k_bf16_gemv(torch.from_numpy(x), tl.data["ql"], tl.data["qh"], tl.data["scale"],
                            G, out_dtype=torch.float32)
    _close(got.numpy(), want)


@pytest.mark.parametrize("K,natural", [(2048, True), (512, False)])
def test_k4_plain_matches_pallas_q6k(K, natural):
    """Natural element order at G = 512; at G = 128 the JAX kernel's legacy
    contract takes x gathered by perm (on the JAX side only: the port reads
    x in element order at every G)."""
    _k4_against_pallas(K, natural, 24)


@pytest.mark.parametrize("B", [40, 200])  # the rows instantiation's row counts
@pytest.mark.parametrize("K,natural", [(2048, True), (512, False)])
def test_k4_plain_matches_pallas_q6k_at_prefill_rows(K, natural, B):
    """The same at the row counts of K4's rows instantiation (one row tile
    of 64, two of 128)."""
    _k4_against_pallas(K, natural, B)


@pytest.mark.parametrize("B", [8, 40, 200])  # 40, 200: the rows instantiation's row counts
@pytest.mark.parametrize("K", [2048, 4096])
def test_k9_plain_matches_pallas_q5k_q8(K, B):
    O = 256
    jl, tl = _pair(GGMLType.Q5_K, O, K, K + 1)
    x = _x(B, K, 7)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm._q5k_q8_matmul_padded(
            jnp.asarray(x), jl.data["qs"], jl.data["qh"], jl.data["scale"], jl.data["minv"],
            block_o=O, block_k=512, block_k8=256, out_dtype=jnp.float32))
    got = tqm.q5k_q8_gemv(torch.from_numpy(x), tl.data["qs"], tl.data["qh"], tl.data["scale"],
                          tl.data["minv"], out_dtype=torch.float32)
    _close(got.numpy(), want)


@pytest.fixture
def routes(monkeypatch):
    """Counts of each route the two dispatchers take."""
    counts = {"k3": 0, "k4": 0, "k9": 0, "dequant": 0}

    def counted(route, fn):
        def wrapped(*args, **kw):
            counts[route] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tqm, "q6k_q8_gemv_plain", counted("k3", tqm.q6k_q8_gemv_plain))
    monkeypatch.setattr(tqm, "q6k_bf16_gemv_plain", counted("k4", tqm.q6k_bf16_gemv_plain))
    monkeypatch.setattr(tqm, "q5k_q8_gemv_plain", counted("k9", tqm.q5k_q8_gemv_plain))
    monkeypatch.setattr(tgl, "_ref_forward", counted("dequant", tgl._ref_forward))
    return counts


@pytest.mark.parametrize("rows,K,want", [
    (1, 2048, "k3"), (16, 2048, "k3"), (17, 2048, "k4"), (256, 2048, "k4"),
    (257, 2048, "dequant"), (1, 512, "k4"), (16, 512, "k4"), (256, 512, "k4"),
    (300, 512, "dequant")])
def test_q6k_routes_by_rows_and_chunk_span(routes, rows, K, want):
    """G = 512 at K = 2048, G = 128 at K = 512 (K3 needs G >= 256)."""
    _, tl = _pair(GGMLType.Q6_K, 64, K, 1)
    y = tqm.q6k_matmul(tl, torch.from_numpy(_x(rows, K, 2)))
    assert tuple(y.shape) == (rows, 64)
    assert routes == {"k3": 0, "k4": 0, "k9": 0, "dequant": 0, want: 1}


@pytest.mark.parametrize("rows,want", [(1, "k9"), (16, "k9"), (256, "k9"), (257, "dequant")])
def test_q5k_routes_by_rows(routes, rows, want):
    _, tl = _pair(GGMLType.Q5_K, 64, 512, 1)
    tqm.q5k_matmul(tl, torch.from_numpy(_x(rows, 512, 2)))
    assert routes == {"k3": 0, "k4": 0, "k9": 0, "dequant": 0, want: 1}


@pytest.mark.parametrize("rows", [17, 64, 256])
@pytest.mark.parametrize("gtype", [GGMLType.Q6_K, GGMLType.Q3_K], ids=lambda t: t.name)
def test_q6k_layout_takes_k4_at_prefill_rows(routes, gtype, rows):
    """Q6_K and Q3_K (packed in Q6_K's layout, G = 256 at K = 1024) take
    K4 at 17-256 rows, where its rows instantiation runs on the card."""
    _, tl = _pair(gtype, 64, 1024, rows)
    assert tl.kind == "gguf_q6k" and tl.meta == 256 and tl.int8_act
    y = tqm.q6k_matmul(tl, torch.from_numpy(_x(rows, 1024, 3)))
    assert tuple(y.shape) == (rows, 64) and bool(torch.isfinite(y).all())
    assert routes == {"k3": 0, "k4": 1, "k9": 0, "dequant": 0}


def test_q6k_below_chunk_span_128_dequantizes(routes):
    """in = 768 gives G = 64: no kernel takes it."""
    _, tl = _pair(GGMLType.Q6_K, 32, 768, 1)
    assert tl.meta == 64
    tqm.q6k_matmul(tl, torch.from_numpy(_x(4, 768, 2)))
    assert routes["dequant"] == 1 and routes["k3"] == routes["k4"] == 0


@pytest.mark.parametrize("gtype", [GGMLType.Q5_K, GGMLType.Q6_K])
def test_prefill_route_is_dequant_matmul(gtype):
    """More than 256 rows: dequantize + one matmul, as JAX's _ref_forward."""
    jl, tl = _pair(gtype, 128, 1024, 7)
    x = _x(300, 1024, 8)
    want = np.asarray(jgl._ref_forward(jl, jnp.asarray(x)))
    got = (tqm.q5k_matmul if gtype == GGMLType.Q5_K else tqm.q6k_matmul)(tl, torch.from_numpy(x))
    _close(got.numpy(), want)


def _q8_bound(jl, x, want):
    """|dy| <= sum_k |w_k| |dx_k| with |dx| <= max|x_block|/254 per element,
    plus the sum-order allowance."""
    K = x.shape[-1]
    w = np.asarray(jgl.DEQUANT_WEIGHTS[jl.kind](jl, jnp.float32))  # [O, K]
    xb = np.abs(x.reshape(-1, K // 32, 32)).max(axis=2) / 254.0
    return np.repeat(xb, 32, axis=1) @ np.abs(w).T + 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("gtype,K,lead", [
    (GGMLType.Q6_K, 2048, (1,)), (GGMLType.Q6_K, 2048, (2, 8)), (GGMLType.Q5_K, 512, (1,)),
    (GGMLType.Q5_K, 2048, (4, 4)), (GGMLType.Q5_K, 512, (256,))])
def test_int8_routes_are_within_q8_bound_of_exact(gtype, K, lead):
    """K3 (at most 16 rows, G >= 256) and K9: the only error against the
    exact f32 product is the activation rounding."""
    O = 128
    jl, tl = _pair(gtype, O, K, 9)
    x = _x(int(np.prod(lead)), K, 11).reshape(*lead, K)
    want = np.asarray(jgl._ref_forward(jl, jnp.asarray(x)))
    fn = tqm.q5k_matmul if gtype == GGMLType.Q5_K else tqm.q6k_matmul
    got = fn(tl, torch.from_numpy(x))
    assert tuple(got.shape) == (*lead, O)
    err = np.abs(got.numpy().reshape(-1, O) - want.reshape(-1, O))
    assert (err <= _q8_bound(jl, x.reshape(-1, K), want)).all()
    assert err.max() > 0  # the int8 route really ran


@pytest.mark.parametrize("K,rows", [(512, 4), (2048, 40)])
def test_k4_route_matches_exact(K, rows):
    """K4 keeps x in its dtype (f32 here): the route equals the exact
    product up to the f32 sum order."""
    jl, tl = _pair(GGMLType.Q6_K, 128, K, 13)
    x = _x(rows, K, 14)
    want = np.asarray(jgl._ref_forward(jl, jnp.asarray(x)))
    _close(tqm.q6k_matmul(tl, torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("rows", [1, 40])
def test_q3k_weights_through_q6k_matmul(rows):
    """Q3_K packed into the Q6_K layout (q3 + 28) serves through K3 at one
    row (G = 256) and K4 at 40, against JAX's exact product."""
    jl, tl = _pair(GGMLType.Q3_K, 128, 1024, 17)
    assert tl.kind == "gguf_q6k" and tl.meta == 256
    x = _x(rows, 1024, 18)
    want = np.asarray(jgl._ref_forward(jl, jnp.asarray(x)))
    got = tqm.q6k_matmul(tl, torch.from_numpy(x)).numpy()
    if rows == 1:
        assert (np.abs(got - want) <= _q8_bound(jl, x, want)).all()
    else:
        _close(got, want)


def test_q6k_dequant_plain_is_q6k_layout_read_back():
    """The element-order read-back of the chunked layout inverts the
    packer at G = 128, 256 and 512: q and s16 come back as packed."""
    rng = np.random.default_rng(0)
    for K in (512, 1024, 4096):
        q = rng.integers(0, 64, (24, K)).astype(np.uint8)
        s16 = rng.standard_normal((24, K // 16)).astype(np.float32)
        lin = tgl._pack_q6k_from_values(q, s16, 24, K, torch.float32, "cpu")
        got_q, got_s = tqm._q6k_natural(lin.data["ql"], lin.data["qh"], lin.data["scale"],
                                        lin.meta)
        np.testing.assert_array_equal(got_q.numpy(), q.T)
        np.testing.assert_array_equal(got_s.numpy(), s16.T)
