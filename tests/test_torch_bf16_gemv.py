"""Port vs JAX package: the plain versions of K5 (Q4_K x activations in
their dtype), K8 (int8 weights x activations in their dtype) and K9b (the
Q5_K high-bit term), and the dispatchers with Linear.int8_act off, against
JAX's q4k_matmul, q8_0_matmul and q5k_matmul, whose Pallas kernels
(_q4k_kernel, _q8_0_kernel, _q5k_hbit_kernel) run under the TPU
interpreter, as tests/test_quant_matmul_kernel.py runs them. Off the TPU
the JAX int8 gates are off, so those dispatchers take exactly these
kernels.

Tolerances: with f32 inputs 1e-5 of the largest |y| (the same f32 products,
summed in another order); with bf16 inputs and outputs one bf16 ulp of the
largest |y| (2^-7): both sides round the same f32 sums to bf16 once, and
the sums differ in their last f32 bits.

The routes (counted at the plain versions): with int8_act on, K1, K2, K9
and K3 run; with it off, K5, K8, K9b and K4; above 256 rows the dequant
route in both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mistralrs_tpu.gguf.reader import GGMLType
from mistralrs_tpu.ops import quant_matmul as jqm
from mistralrs_tpu.quant import gguf_linear as jgl
from mistralrs_tpu.quant import kquants as jkquants
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.quant import gguf_linear as tgl
from mistralrs_tpu_torch.quant.qlinear import linear

F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -7
O = 256
ROWS = (1, 5, 16, 17)
K_OF = {GGMLType.Q4_K: 512, GGMLType.Q8_0: 512, GGMLType.Q5_K: 2048}
JAX_MATMUL = {GGMLType.Q4_K: jqm.q4k_matmul, GGMLType.Q8_0: jqm.q8_0_matmul,
              GGMLType.Q5_K: jqm.q5k_matmul}


def _pair(gtype, out_f, in_f, seed, bf16=False, bias=False):
    """(JAX Linear, port Linear) of the same seeded weight, f32 or bf16
    floats, with a bias or without."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((out_f, in_f)) * 0.3).astype(np.float32)
    raw = jkquants.quantize(w, gtype)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jl = jgl.linear_from_gguf(raw, gtype, (out_f, in_f), dtype=jdt)
    tl = tgl.linear_from_gguf(raw, int(gtype), (out_f, in_f), dtype=tdt, device="cpu")
    if bias:
        b = (rng.standard_normal(out_f) * 0.5).astype(np.float32)
        jl.data["b"] = jnp.asarray(b, jdt)
        tl.data["b"] = torch.from_numpy(b).to(tdt)
    tl.int8_act = False
    return jl, tl


def _x(B, K, seed):
    return (np.random.default_rng(seed).standard_normal((B, K)) * 0.7).astype(np.float32)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _jax(jfn, jl, x, dtype):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jfn(jl, jnp.asarray(x, dtype)).astype(jnp.float32))


@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("gtype", list(K_OF), ids=lambda t: t.name)
def test_dispatcher_f32_matches_jax_interpret(gtype, B):
    """The port's dispatcher with int8_act off (K5; K8; K5 + 16 * K9b) on
    f32 x against JAX's on the TPU interpreter, with a bias."""
    K = K_OF[gtype]
    jl, tl = _pair(gtype, O, K, B + K, bias=True)
    x = _x(B, K, B)
    want = _jax(JAX_MATMUL[gtype], jl, x, jnp.float32)
    got = linear(tl, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, F32_RTOL)


@pytest.mark.parametrize("B", ROWS)
@pytest.mark.parametrize("gtype", list(K_OF), ids=lambda t: t.name)
def test_dispatcher_bf16_matches_jax_interpret(gtype, B):
    """The same with bf16 weights' floats, x and outputs on both sides."""
    K = K_OF[gtype]
    jl, tl = _pair(gtype, O, K, B + 2 * K, bf16=True)
    x = _x(B, K, B + 1)
    want = _jax(JAX_MATMUL[gtype], jl, x, jnp.bfloat16)
    got = linear(tl, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, BF16_RTOL)


@pytest.mark.parametrize("B", (1, 16, 64))  # 64: the rows instantiation's
def test_k5_plain_matches_pallas_q4k(B):
    K = 1024
    jl, tl = _pair(GGMLType.Q4_K, O, K, 11 + B)
    x = _x(B, K, 2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm._q4k_matmul_padded(
            jnp.asarray(np.pad(x, ((0, (-B) % 8), (0, 0)))), jl.data["qs"], jl.data["scale"],
            jl.data["minv"], block_o=O, block_k=512))[:B]
    got = tqm.q4k_bf16_gemv(torch.from_numpy(x), tl.data["qs"], tl.data["scale"],
                            tl.data["minv"], out_dtype=torch.float32)
    _close(got.numpy(), want, F32_RTOL)


@pytest.mark.parametrize("B", (1, 16, 64))  # 64: the rows instantiation's
def test_k8_plain_matches_pallas_q8_0(B):
    K = 1024
    jl, tl = _pair(GGMLType.Q8_0, O, K, 21 + B)
    x = _x(B, K, 3)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqm._q8_0_matmul_padded(
            jnp.asarray(np.pad(x, ((0, (-B) % 8), (0, 0)))), jl.data["q"], jl.data["scale"],
            block_o=O, block_k=512))[:B]
    got = tqm.q8_0_bf16_gemv(torch.from_numpy(x), tl.data["q"], tl.data["scale"],
                             out_dtype=torch.float32)
    _close(got.numpy(), want, F32_RTOL)


def _jax_hbit(x, qh, scale):
    """JAX's second pallas_call of _q5k_matmul_padded (the high-bit term
    alone), as that function makes it, at block_o 256 and block_k8 256."""
    B, K = x.shape
    Kq, Oq = qh.shape
    return pl.pallas_call(
        functools.partial(jqm._q5k_hbit_kernel, block_k=256),
        out_shape=jax.ShapeDtypeStruct((B, Oq), x.dtype),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0, grid=(Oq // 256, Kq // 256),
            in_specs=[pl.BlockSpec((B, K), lambda o, k: (0, 0)),
                      pl.BlockSpec((256, 256), lambda o, k: (k, o)),
                      pl.BlockSpec((K // 32, 256), lambda o, k: (0, o))],
            out_specs=pl.BlockSpec((B, 256), lambda o, k: (0, o)),
            scratch_shapes=[pltpu.VMEM((B, 256), jnp.float32)]),
        compiler_params=pltpu.CompilerParams(dimension_semantics=("parallel", "arbitrary")),
    )(x, qh, scale)


@pytest.mark.parametrize("B", (1, 8, 24, 40, 200))  # 40, 200: the rows instantiation's
def test_k9b_plain_matches_pallas_q5k_hbit(B):
    K = 2048
    jl, tl = _pair(GGMLType.Q5_K, O, K, 31 + B)
    x = _x(B, K, 4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_jax_hbit(jnp.asarray(x), jl.data["qh"], jl.data["scale"]))
    got = tqm.q5k_hbit_bf16_gemv(torch.from_numpy(x), tl.data["qh"], tl.data["scale"],
                                 out_dtype=torch.float32)
    assert np.abs(want).max() > 0
    _close(got.numpy(), want, F32_RTOL)


def test_q5k_route_adds_16_high_bit_terms():
    """y + 16 * yh of K5 and K9b is the whole Q5_K product (the dequantized
    weight's), in f32 to the sum order."""
    K = 2048
    _, tl = _pair(GGMLType.Q5_K, O, K, 5)
    x = torch.from_numpy(_x(4, K, 5))
    w = tgl.dequant_q5k_weights(tl, torch.float32)  # [out, in]
    _close(linear(tl, x).numpy(), (x @ w.T).numpy(), F32_RTOL)


# ------------------------------------------------------------- routes


@pytest.fixture
def routes(monkeypatch):
    """Counts of each route the dispatchers take, at the plain versions."""
    names = {"k1": "q4k_q8_gemv_plain", "k2": "q8_0_q8_gemv_plain", "k9": "q5k_q8_gemv_plain",
             "k3": "q6k_q8_gemv_plain", "k4": "q6k_bf16_gemv_plain", "k5": "q4k_bf16_gemv_plain",
             "k8": "q8_0_bf16_gemv_plain", "k9b": "q5k_hbit_bf16_gemv_plain"}
    counts = {k: 0 for k in names} | {"dequant": 0}

    def counted(route, fn):
        def wrapped(*args, **kw):
            counts[route] += 1
            return fn(*args, **kw)
        return wrapped

    for route, name in names.items():
        monkeypatch.setattr(tqm, name, counted(route, getattr(tqm, name)))
    monkeypatch.setattr(tgl, "_ref_forward", counted("dequant", tgl._ref_forward))
    return counts


ROUTE_CASES = [  # (type, in, rq8 group, rows, int8_act) -> routes taken
    (GGMLType.Q4_K, 512, None, 16, True, {"k1": 1}),
    (GGMLType.Q4_K, 512, None, 16, False, {"k5": 1}),
    (GGMLType.Q4_K, 512, None, 300, False, {"dequant": 1}),
    (GGMLType.Q5_K, 2048, None, 5, True, {"k9": 1}),
    (GGMLType.Q5_K, 2048, None, 5, False, {"k5": 1, "k9b": 1}),
    (GGMLType.Q5_K, 2048, None, 257, True, {"dequant": 1}),
    (GGMLType.Q8_0, 512, None, 17, True, {"k2": 1}),
    (GGMLType.Q8_0, 512, None, 17, False, {"k8": 1}),
    (GGMLType.Q8_0, 512, None, 257, False, {"dequant": 1}),
    (GGMLType.Q6_K, 1024, None, 16, True, {"k3": 1}),
    (GGMLType.Q6_K, 1024, None, 16, False, {"k4": 1}),
    (GGMLType.Q6_K, 1024, None, 1, False, {"k4": 1}),
    (GGMLType.Q6_K, 1024, 32, 16, False, {"k8": 1}),  # rq8 at group 32
    (GGMLType.Q6_K, 1024, 64, 16, True, {"k2": 1}),
    (GGMLType.Q6_K, 1024, 64, 16, False, {"dequant": 1}),  # no bf16 kernel at group 64
    # 17-256 rows with int8_act off: the rows instantiations of K5, K9b, K4
    # and K8, never the dequant route
    (GGMLType.Q4_K, 512, None, 17, False, {"k5": 1}),
    (GGMLType.Q4_K, 512, None, 64, False, {"k5": 1}),
    (GGMLType.Q4_K, 512, None, 256, False, {"k5": 1}),
    (GGMLType.Q8_0, 512, None, 64, False, {"k8": 1}),
    (GGMLType.Q8_0, 512, None, 256, False, {"k8": 1}),
    (GGMLType.Q6_K, 1024, 32, 17, False, {"k8": 1}),  # rq8 at group 32
    (GGMLType.Q6_K, 1024, 32, 256, False, {"k8": 1}),
    (GGMLType.Q5_K, 2048, None, 17, False, {"k5": 1, "k9b": 1}),
    (GGMLType.Q5_K, 2048, None, 64, False, {"k5": 1, "k9b": 1}),
    (GGMLType.Q5_K, 2048, None, 256, False, {"k5": 1, "k9b": 1}),
    (GGMLType.Q6_K, 1024, None, 17, False, {"k4": 1}),
    (GGMLType.Q6_K, 1024, None, 64, False, {"k4": 1}),
    (GGMLType.Q6_K, 1024, None, 256, False, {"k4": 1}),
]


@pytest.mark.parametrize("gtype,K,rq8,rows,int8_act,want", ROUTE_CASES)
def test_routes(routes, gtype, K, rq8, rows, int8_act, want):
    _, tl = _pair(gtype, 64, K, K + rows)
    if rq8:
        tl = tgl.requant_q6k_to_q8(tl, gs=rq8)
    tl.int8_act = int8_act
    y = linear(tl, torch.from_numpy(_x(rows, K, 1)))
    assert y.shape == (rows, 64) and torch.isfinite(y).all()
    assert {k: v for k, v in routes.items() if v} == want


@pytest.mark.parametrize("site", ["requant", "fuse", "split", "pad"])
def test_rebuild_sites_carry_the_route(site):
    """Every site that rebuilds a Linear keeps int8_act (dataclasses.replace):
    a lost field would put the layer back on the int8 route. Linears on
    different routes do not fuse."""
    from mistralrs_tpu_torch.quant import fuse as tfuse

    _, a = _pair(GGMLType.Q6_K if site == "requant" else GGMLType.Q4_K, 64, 1024, 0)
    _, b = _pair(GGMLType.Q4_K, 32, 1024, 1)
    assert a.int8_act is False
    rebuilt = {"requant": lambda: [tgl.requant_q6k_to_q8(a, gs=32)],
               "fuse": lambda: [tfuse.fuse_linears([a, b])],
               "split": lambda: tfuse.split_linear(a, [16, 48]),
               "pad": lambda: [tfuse.pad_linear_out(a, 128, max_pad=64)]}[site]()
    assert rebuilt and all(lin.int8_act is False for lin in rebuilt)
    if site == "fuse":
        b.int8_act = True
        assert tfuse.fuse_linears([a, b]) is None


@pytest.mark.parametrize("name,args", [
    ("q4k_bf16_gemv", lambda: (torch.zeros(2, 96), torch.zeros(48, 16, dtype=torch.uint8),
                               torch.zeros(3, 16), torch.zeros(3, 16))),
    ("q8_0_bf16_gemv", lambda: (torch.zeros(2, 64), torch.zeros(64, 24, dtype=torch.int8),
                                torch.zeros(2, 24))),
    ("q5k_hbit_bf16_gemv", lambda: (torch.zeros(2, 128), torch.zeros(16, 16, dtype=torch.uint8),
                                    torch.zeros(4, 16))),
])
def test_wrappers_refuse_shapes_their_kernels_do_not_take(name, args):
    """K5 needs in % 64, K8 out % 16, K9b in % 256: the wrapper raises, on
    the CPU too, before it picks a version."""
    with pytest.raises(ValueError):
        getattr(tqm, name)(*args())
