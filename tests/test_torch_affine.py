"""Port vs JAX package: the plane-major affine layouts (GGUF Q2_K, GPTQ,
HQQ), the plain version of K10 (`affine_gemv_plain`) and of its dequant
kernel, and the routes of the `affine_qmatmul` dispatcher.

The JAX side runs `affine_qmatmul` (its Pallas `_affine_kernel`) under the
TPU interpreter at the shapes tests/test_quant_matmul_kernel.py uses. Both
sides form q * scale in f32 here and sum the products and the zs term
xsum_g @ zs in f32, in another order: 1e-5 of the largest |y|. The
dequantized weights are equal: the same f32 ops on the same numbers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mistralrs_tpu.gguf.reader import GGMLType
from mistralrs_tpu.ops import quant_matmul as jqm
from mistralrs_tpu.quant import gguf_linear as jgl
from mistralrs_tpu.quant import gptq as jgptq
from mistralrs_tpu.quant import hqq as jhqq
from mistralrs_tpu.quant import kquants
from mistralrs_tpu.quant.qlinear import linear as jlinear
from mistralrs_tpu_torch.models.loader import _linear as port_linear
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.quant import gguf_linear as tgl
from mistralrs_tpu_torch.quant.qlinear import Linear, linear

SUM_ORDER_RTOL = 1e-5


def _x(B, K, seed):
    return (np.random.default_rng(seed).standard_normal((B, K)) * 0.5).astype(np.float32)


def _close(got, want, rtol=SUM_ORDER_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _q2k_pair(out_f, in_f, seed):
    """(raw Q2_K bytes, JAX Linear, port Linear) of a seeded normal weight."""
    w = (np.random.default_rng(seed).standard_normal((out_f, in_f)) * 0.3).astype(np.float32)
    raw = kquants.quantize(w, GGMLType.Q2_K)
    jl = jgl.linear_from_gguf(raw, GGMLType.Q2_K, (out_f, in_f), dtype=jnp.float32)
    tl = tgl.linear_from_gguf(raw, int(GGMLType.Q2_K), (out_f, in_f), dtype=torch.float32,
                              device="cpu")
    return raw, jl, tl


def _gptq_pair(bits, in_f, out_f, seed, group=64):
    """(JAX, port) GPTQ Linears of one round-to-nearest checkpoint."""
    from mistralrs_tpu_torch.quant import gptq as tgptq

    w = (np.random.default_rng(seed).standard_normal((out_f, in_f)) * 0.3).astype(np.float32)
    t = jgptq.quantize_gptq_rtn(w, bits, group_size=group)
    args = (t["qweight"], t["qzeros"], t["scales"].astype(np.float32), t["g_idx"], bits, in_f,
            out_f)
    return (jgptq.gptq_linear_from_tensors(*args, dtype=jnp.float32),
            tgptq.gptq_linear_from_tensors(*args, dtype=torch.float32, device="cpu"))


def _hqq_pair(bits, in_f, out_f, seed, group=64):
    from mistralrs_tpu_torch.quant import hqq as thqq

    w = (np.random.default_rng(seed).standard_normal((out_f, in_f)) * 0.3).astype(np.float32)
    return (jhqq.quantize_hqq(w, bits, group_size=group, dtype=jnp.float32),
            thqq.quantize_hqq(w, bits, group_size=group, dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("out_f,in_f", [(256, 512), (64, 1024), (48, 256)])
def test_pack_q2k_is_byte_equal_to_jax(out_f, in_f):
    _, jl, tl = _q2k_pair(out_f, in_f, out_f + in_f)
    assert tl.kind == jl.kind == "gguf_q2k" and tl.shape == jl.shape == (in_f, out_f)
    assert tl.data["q"].dtype == torch.uint8 and tuple(tl.data["q"].shape) == (in_f // 4, out_f)
    for key in ("q", "scale", "minv"):
        np.testing.assert_array_equal(tl.data[key].numpy(), np.asarray(jl.data[key]))


def test_q2k_needs_whole_super_blocks():
    raw, _, _ = _q2k_pair(16, 256, 0)
    with pytest.raises(ValueError):
        tgl.linear_from_gguf(np.concatenate([raw, raw]), int(GGMLType.Q2_K), (16, 512 - 128),
                             dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("out_f,in_f", [(256, 512), (64, 1024)])
def test_dequant_q2k_weights_equal_jax_and_the_wire_format(out_f, in_f):
    raw, jl, tl = _q2k_pair(out_f, in_f, in_f)
    want = np.asarray(jgl.dequant_q2k_weights(jl, jnp.float32))
    got = tgl.DEQUANT_WEIGHTS["gguf_q2k"](tl, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    # and both are llama.cpp's Q2_K dequantization of the wire blocks, up to
    # the bf16-free f32 rounding of d * sc and dmin * m
    wire = kquants.dequantize(raw, GGMLType.Q2_K, (out_f, in_f))
    np.testing.assert_allclose(got, wire, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fmt,bits,in_f", [("gptq", 2, 2048), ("gptq", 8, 1024), ("gptq", 3, 1024),
                                           ("hqq", 1, 4096), ("hqq", 2, 2048), ("hqq", 3, 512),
                                           ("hqq", 8, 512)])
def test_affine_dequant_plain_equals_jax_dequant(fmt, bits, in_f):
    if fmt == "gptq":
        jl, tl = _gptq_pair(bits, in_f, 256, bits + in_f)
        want = np.asarray(jgptq._gptq_weights(jl, jnp.float32, 8 if bits == 3 else bits))
    else:
        jl, tl = _hqq_pair(bits, in_f, 256, bits + in_f)
        want = np.asarray(jhqq.hqq_dequant_weights(jl, jnp.float32, bits))
    dbits = 8 if bits in (3, 8) else bits
    group = in_f // tl.data["scale"].shape[0]
    got = tqm.affine_dequant_plain(tl.data["q"], tl.data["scale"], tl.data["zs"], dbits, group,
                                   torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B", [8, 40, 200])  # 40, 200: the rows instantiation's row counts
def test_affine_gemv_plain_matches_pallas_q2k(B):
    _, jl, tl = _q2k_pair(256, 512, 5)
    x = _x(B, 512, 6)
    with pltpu.force_tpu_interpret_mode():
        want = jqm.affine_qmatmul(jl, jnp.asarray(x), bits=2, group=16, zs_key="minv")
    assert want is not None
    got = tqm.affine_gemv(torch.from_numpy(x), tl.data["q"], tl.data["scale"], tl.data["minv"],
                          2, 16, out_dtype=torch.float32)
    _close(got.numpy(), want)


@pytest.mark.parametrize("B", [3, 40, 200])  # 40, 200: the rows instantiation's row counts
@pytest.mark.parametrize("fmt,bits,in_f", [("gptq", 2, 2048), ("gptq", 8, 1024),
                                           ("hqq", 1, 4096), ("hqq", 2, 2048), ("hqq", 3, 512),
                                           ("hqq", 8, 512)])
def test_affine_gemv_plain_matches_pallas(fmt, bits, in_f, B):
    """The shapes of tests/test_quant_matmul_kernel.py (group 64), where the
    JAX dispatcher takes its kernel; 3-bit codes are a byte each (bits 8)."""
    jl, tl = (_gptq_pair if fmt == "gptq" else _hqq_pair)(bits, in_f, 256, 3 * bits + in_f)
    assert tl.kind == jl.kind
    dbits = 8 if bits in (3, 8) else bits
    x = _x(B, in_f, bits)
    with pltpu.force_tpu_interpret_mode():
        want = jqm.affine_qmatmul(jl, jnp.asarray(x), bits=dbits, group=64)
    assert want is not None
    got = tqm.affine_gemv(torch.from_numpy(x), tl.data["q"], tl.data["scale"], tl.data["zs"],
                          dbits, 64, out_dtype=torch.float32)
    _close(got.numpy(), want)


def test_affine_gemv_plain_rounds_the_weight_to_x_dtype():
    """In bf16 the weight is bf16(q * scale), one rounding, as the JAX kernel
    forms `vals * srep` in x's dtype; the zs term stays f32."""
    _, _, tl = _q2k_pair(64, 512, 8)
    q, s, m = tl.data["q"], tl.data["scale"].bfloat16(), tl.data["minv"].bfloat16()
    x = torch.from_numpy(_x(4, 512, 9)).bfloat16()
    got = tqm.affine_gemv_plain(x, q, s, m, 2, 16, torch.float32)
    w = (tqm._affine_values(q, 2).float() * s.float().repeat_interleave(16, 0)).bfloat16()
    want = x.float() @ w.float() - tqm._xsum(x, 16) @ m.float()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture
def routes(monkeypatch):
    """Counts of the dispatcher's two routes (the plain versions' calls)."""
    counts = {"k10": 0, "dequant": 0}

    def counted(route, fn):
        def wrapped(*args, **kw):
            counts[route] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tqm, "affine_gemv_plain", counted("k10", tqm.affine_gemv_plain))
    monkeypatch.setattr(tqm, "affine_dequant_plain", counted("dequant", tqm.affine_dequant_plain))
    return counts


@pytest.mark.parametrize("rows,want", [(1, "k10"), (16, "k10"), (64, "k10"), (256, "k10"),
                                       (257, "dequant"), (1024, "dequant")])
def test_q2k_routes_by_rows(routes, rows, want):
    _, _, tl = _q2k_pair(64, 512, 1)
    y = linear(tl, torch.from_numpy(_x(rows, 512, 2)))
    assert tuple(y.shape) == (rows, 64)
    assert routes == {"k10": 0, "dequant": 0, want: 1}


@pytest.mark.parametrize("bits,group,in_f,out_f,want", [
    (2, 16, 512, 48, "k10"),
    (2, 16, 512, 40, "dequant"),     # out % 16
    (1, 64, 256, 64, "dequant"),     # a group would straddle two of the 8 planes
    (1, 64, 512, 64, "k10"),
    (2, 16, 64, 64, "dequant"),      # 16 byte rows: fewer than the kernel's 32-row step
    (8, 128, 1024, 64, "k10"),
    (4, 16, 256, 32, "k10"),
])
def test_affine_routes_by_shape(routes, bits, group, in_f, out_f, want):
    g = torch.Generator().manual_seed(in_f + out_f)
    lin = Linear("gptq_x", (in_f, out_f), {
        "q": torch.randint(0, 256, (in_f * bits // 8, out_f), generator=g, dtype=torch.uint8),
        "scale": torch.rand(in_f // group, out_f, generator=g),
        "zs": torch.rand(in_f // group, out_f, generator=g)})
    x = torch.from_numpy(_x(4, in_f, 3))
    y = tqm.affine_qmatmul(lin, x, bits=bits, group=group)
    assert tuple(y.shape) == (4, out_f)
    assert routes == {"k10": 0, "dequant": 0, want: 1}
    w = tqm.affine_dequant_plain(lin.data["q"], lin.data["scale"], lin.data["zs"], bits, group,
                                 torch.float32)
    _close(y.numpy(), (x @ w).numpy())


@pytest.mark.parametrize("lead", [(1,), (2, 3), (300,)])
def test_q2k_linear_with_bias_matches_jax(lead):
    """Both routes against the JAX package's forward (its CPU path
    dequantizes), on 2-D and 3-D inputs, with a bias."""
    _, jl, tl = _q2k_pair(64, 512, 11)
    b = np.random.default_rng(12).standard_normal(64).astype(np.float32)
    jl.data["b"] = jnp.asarray(b)
    tl.data["b"] = torch.from_numpy(b)
    x = _x(int(np.prod(lead)), 512, 13).reshape(*lead, 512)
    want = np.asarray(jlinear(jl, jnp.asarray(x)))
    got = linear(tl, torch.from_numpy(x))
    assert tuple(got.shape) == (*lead, 64)
    _close(got.numpy(), want)


def test_loader_carries_q2k_across():
    """params_from_reference's Linear conversion keeps the codes as uint8
    bytes and gives scale and minv the working dtype."""
    _, jl, _ = _q2k_pair(64, 512, 14)
    tl = port_linear(type(jl)(kind=jl.kind, shape=jl.shape,
                              data={k: np.asarray(v) for k, v in jl.data.items()}, meta=jl.meta),
                     "cpu", torch.bfloat16)
    assert tl.kind == "gguf_q2k" and tl.data["q"].dtype == torch.uint8
    assert tl.data["scale"].dtype == tl.data["minv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tl.data["q"].numpy(), np.asarray(jl.data["q"]))
