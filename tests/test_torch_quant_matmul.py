"""Port vs JAX package: the plain versions of the int8 GEMV kernels K1 and K2,
and the dispatchers' routes.

The JAX side runs its Pallas kernels under the TPU interpreter, as
tests/test_quant_matmul_kernel.py does. Both sides quantize the activations
the same way (the port multiplies by 1/127 where JAX divides: the scales
may differ by one f32 ulp) and take exact integer dots per block; only the
order of the f32 sums of scaled block dots differs, so the outputs must
agree to 1e-5 of their largest magnitude.
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


# 64 and 200 rows: counts the rows instantiations of K1 and K2 serve on the card
@pytest.mark.parametrize("B", [1, 8, 64, 200])
def test_k1_plain_matches_pallas_q4k_q8(B):
    K, O = 1024, 256
    jl, tl = _pair(GGMLType.Q4_K, O, K, B)
    x = _x(B, K, 10 + B)
    bo, bk = jqm._pick_blocks(O, K, 1024, 1024)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm._q4k_q8_matmul_padded(
            jnp.asarray(_pad8(x)), jl.data["qs"], jl.data["scale"], jl.data["minv"],
            block_o=bo, block_k=bk, out_dtype=jnp.float32))[:B]
    got = tqm.q4k_q8_gemv(torch.from_numpy(x), tl.data["qs"], tl.data["scale"],
                          tl.data["minv"], out_dtype=torch.float32)
    _close(got.numpy(), want)


@pytest.mark.parametrize("gs", [32, 64])
@pytest.mark.parametrize("B", [1, 8, 64, 200])
def test_k2_plain_matches_pallas_q8_0_q8(gs, B):
    """The rq8 layout (f32 scales) at both group sizes."""
    K, O = 1024, 256
    jl, tl = _pair(GGMLType.Q6_K, O, K, gs + B)
    jl, tl = jgl.requant_q6k_to_q8(jl, gs), tgl.requant_q6k_to_q8(tl, gs)
    x = _x(B, K, 20 + B)
    bo, bk = jqm._pick_blocks(O, K, 1024, 1024)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm._q8_0_q8_matmul_padded(
            jnp.asarray(_pad8(x)), jl.data["q"], jl.data["scale"], block_o=bo, block_k=bk,
            gs=gs, out_dtype=jnp.float32))[:B]
    got = tqm.q8_0_q8_gemv(torch.from_numpy(x), tl.data["q"], tl.data["scale"], gs,
                           out_dtype=torch.float32)
    _close(got.numpy(), want)


def test_k2_plain_matches_pallas_on_wire_q8_0():
    K, O, B = 512, 128, 8
    jl, tl = _pair(GGMLType.Q8_0, O, K, 5)
    x = _x(B, K, 6)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm._q8_0_q8_matmul_padded(
            jnp.asarray(x), jl.data["q"], jl.data["scale"], block_o=128, block_k=512, gs=32,
            out_dtype=jnp.float32))
    got = tqm.q8_0_q8_gemv(torch.from_numpy(x), tl.data["q"], tl.data["scale"], 32,
                           out_dtype=torch.float32)
    _close(got.numpy(), want)


@pytest.mark.parametrize("gtype", [GGMLType.Q4_K, GGMLType.Q8_0])
def test_prefill_route_is_dequant_matmul(gtype):
    """More than 256 rows: dequantize + one matmul, as JAX's _ref_forward
    (f32 on both sides; only the matmul's summation order differs)."""
    jl, tl = _pair(gtype, 128, 512, 7)
    x = _x(300, 512, 8)
    want = np.asarray(jgl._ref_forward(jl, jnp.asarray(x)))
    got = (tqm.q4k_matmul if gtype == GGMLType.Q4_K else tqm.q8_0_matmul)(tl, torch.from_numpy(x))
    _close(got.numpy(), want)


@pytest.mark.parametrize("gtype", [GGMLType.Q4_K, GGMLType.Q8_0])
@pytest.mark.parametrize("lead", [(1,), (2, 3), (256,)])
def test_decode_route_is_within_q8_bound_of_exact(gtype, lead):
    """At most 256 rows the dispatchers take the int8 kernel route: the
    only error against the exact f32 product (JAX _ref_forward on the CPU)
    is the activation rounding, |dx| <= max|x_block|/254 per element, so
    |dy| <= sum_k |w_k| |dx_k|."""
    K, O = 512, 128
    jl, tl = _pair(gtype, O, K, 9)
    x = _x(int(np.prod(lead)), K, 11).reshape(*lead, K)
    want = np.asarray(jgl._ref_forward(jl, jnp.asarray(x)))
    got = (tqm.q4k_matmul if gtype == GGMLType.Q4_K else tqm.q8_0_matmul)(tl, torch.from_numpy(x))
    assert tuple(got.shape) == (*lead, O)
    w = np.asarray(jgl.DEQUANT_WEIGHTS[jl.kind](jl, jnp.float32))  # [O, K]
    xb = np.abs(x.reshape(-1, K // 32, 32)).max(axis=2) / 254.0  # [n, K/32]
    dx = np.repeat(xb, 32, axis=1)  # [n, K]
    bound = dx @ np.abs(w).T + 1e-5 * np.abs(want).max()
    err = np.abs(got.numpy().reshape(-1, O) - want.reshape(-1, O))
    assert (err <= bound).all()
    assert err.max() > 0  # the int8 route really ran


def test_activation_quantization_codes():
    """Half-way codes round to even and clip at +-127; an all-zero block
    quantizes to zeros (the 1e-10 floor keeps the scale finite)."""
    x = np.zeros((2, 32), np.float32)
    x[0, :4] = [127.0, 63.5, -0.5 * 127 / 127, 1.5]
    xq, xs = tqm._quantize_acts_q8(torch.from_numpy(x))
    assert xs[0, 0].item() == np.float32(127.0) * np.float32(1.0 / 127.0)
    assert xq[0, :4].tolist() == [127, 64, 0, 2]
    assert xq[1].abs().sum().item() == 0 and xs[1, 0].item() > 0
