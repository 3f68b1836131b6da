"""Port vs JAX package: the packers of the formats that ride the Q4_K, Q5_K
and Q6_K layouts (Q5_K, Q3_K, Q4_0, Q4_1, Q5_0, Q5_1), and the Q5_K and
Q6_K dequantizations.

Wire blocks come from the JAX package's kquants.quantize on seeded numpy
weights, so both packages pack the same bytes. The layouts must be
bit-equal. The dequantizations do the same f32 operations on the same
values in the same order (the port reads the Q6_K layout back in element
order with a reshape where JAX gathers by inv_perm), so they are held to
0 tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.gguf.reader import GGMLType
from mistralrs_tpu.quant import gguf_linear as jgl
from mistralrs_tpu_torch.quant import gguf_linear as tgl
from mistralrs_tpu_torch.quant.kquants import GGMLType as TGGMLType
from torch_port_model import quantized

NEW_TYPES = [GGMLType.Q5_K, GGMLType.Q3_K, GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0,
             GGMLType.Q5_1]


def _port(raw, gtype, out_f, in_f):
    return tgl.linear_from_gguf(raw, int(gtype), (out_f, in_f), dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("gtype", NEW_TYPES)
def test_ggml_type_values_match(gtype):
    assert int(TGGMLType[gtype.name]) == int(gtype)


@pytest.mark.parametrize("in_f", [256, 1024])
@pytest.mark.parametrize("gtype", NEW_TYPES)
def test_packers_bit_equal(gtype, in_f):
    out_f = 48
    rng = np.random.default_rng(int(gtype) * 7 + in_f)
    raw, jl = quantized(rng, gtype, out_f, in_f, 0.3)
    tl = _port(raw, gtype, out_f, in_f)
    assert jl.kind == tl.kind and tuple(jl.shape) == tuple(tl.shape) and jl.meta == tl.meta
    assert set(jl.data) == set(tl.data)
    for k, v in jl.data.items():
        a, b = np.asarray(v), tl.data[k].numpy()
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=k)


@pytest.mark.parametrize("gtype,in_f,G", [
    (GGMLType.Q5_K, 512, None), (GGMLType.Q5_K, 2048, None), (GGMLType.Q5_0, 256, None),
    (GGMLType.Q6_K, 512, 128), (GGMLType.Q6_K, 2048, 512), (GGMLType.Q3_K, 1024, 256)])
def test_dequant_equals_jax(gtype, in_f, G):
    rng = np.random.default_rng(in_f + int(gtype))
    raw, jl = quantized(rng, gtype, 64, in_f, 0.3)
    tl = _port(raw, gtype, 64, in_f)
    assert tl.meta == G
    want = np.asarray(jgl.DEQUANT_WEIGHTS[jl.kind](jl, jnp.float32))
    got = tgl.DEQUANT_WEIGHTS[tl.kind](tl, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gtype", NEW_TYPES)
def test_linear_from_gguf_builds_each_type(gtype):
    """Each new type lands in the layout it rides, at the `in` multiple its
    packer needs, and refuses an `in` that is not one."""
    kind = {GGMLType.Q5_K: "gguf_q5k", GGMLType.Q5_0: "gguf_q5k", GGMLType.Q5_1: "gguf_q5k",
            GGMLType.Q4_0: "gguf_q4k", GGMLType.Q4_1: "gguf_q4k", GGMLType.Q3_K: "gguf_q6k"}
    rng = np.random.default_rng(int(gtype))
    raw, _ = quantized(rng, gtype, 32, 256, 0.3)
    tl = _port(raw, gtype, 32, 256)
    assert tl.kind == kind[gtype] and tl.shape == (256, 32)
    mult = tgl._PACK_IN_MULTIPLE[TGGMLType(int(gtype))]
    with pytest.raises(ValueError):
        tgl.linear_from_gguf(np.zeros(1, np.uint8), int(gtype), (32, mult + 32))
