"""Port vs JAX package: the GPTQ and HQQ modules (quant/gptq.py,
quant/hqq.py), their forwards through `linear`, fusion of act-order
linears, and params_from_reference for every new kind.

The numpy halves (unpacking, the round-to-nearest GPTQ quantizer, the HQQ
proximal solver, the device layouts) are copies of the JAX package's, so
kinds and data must be equal. The forwards go through K10's plain version
(up to 256 rows) or affine_dequant + matmul, the JAX CPU path through its
dequantized weight: f32 sums in another order, 1e-5 of the largest |y|.
GPTQ-4 and HQQ-4 in the Q4_K layout take K1 up to 256 rows, which
quantizes x to int8 per 32 (|dx| <= max|x_block|/254 a value): 2% there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.models.decoder import DecoderParams as JDecoderParams
from mistralrs_tpu.models.loader import group_layers
from mistralrs_tpu.quant import fuse as jfuse
from mistralrs_tpu.quant import gptq as jgptq
from mistralrs_tpu.quant import hqq as jhqq
from mistralrs_tpu.quant.qlinear import linear as jlinear
from mistralrs_tpu_torch.models.loader import params_from_reference
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.quant import fuse as tfuse
from mistralrs_tpu_torch.quant import gptq as tgptq
from mistralrs_tpu_torch.quant import hqq as thqq
from mistralrs_tpu_torch.quant.qlinear import linear

SUM_ORDER_RTOL = 1e-5
Q8_RTOL = 2e-2


def _w(out_f, in_f, seed):
    return (np.random.default_rng(seed).standard_normal((out_f, in_f)) * 0.3).astype(np.float32)


def _same_linear(tl, jl):
    """Equal kind, shape, keys and values (integer widths may differ)."""
    assert tl.kind == jl.kind and tuple(tl.shape) == tuple(jl.shape)
    assert set(tl.data) == set(jl.data)
    for k, v in jl.data.items():
        np.testing.assert_array_equal(tl.data[k].numpy(), np.asarray(v), err_msg=k)


def _close(got, want, rtol=SUM_ORDER_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _forward_matches(tl, jl, rows, seed):
    x = (np.random.default_rng(seed).standard_normal((rows, tl.shape[0])) * 0.5).astype(np.float32)
    int8 = tl.kind == "gguf_q4k" and rows <= tqm.MAX_KERNEL_ROWS
    _close(linear(tl, torch.from_numpy(x)).numpy(), jlinear(jl, jnp.asarray(x)),
           Q8_RTOL if int8 else SUM_ORDER_RTOL)


# --------------------------------------------------------------- numpy half


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_int32_unpack_matches_jax(bits):
    rng = np.random.default_rng(bits)
    packed = rng.integers(-2**31, 2**31, (6, 10), dtype=np.int64).astype(np.int32)
    n = 6 * 32 // bits
    np.testing.assert_array_equal(tgptq._unpack_int32_rows(packed, bits, n - 3),
                                  jgptq._unpack_int32_rows(packed, bits, n - 3))
    np.testing.assert_array_equal(tgptq._unpack_int32_cols(packed.T, bits, n),
                                  jgptq._unpack_int32_cols(packed.T, bits, n))


def test_3bit_pack_unpack_match_jax_and_invert():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 8, (96, 7)).astype(np.uint8)
    packed = tgptq._pack_3bit_rows(vals)
    np.testing.assert_array_equal(packed, jgptq._pack_3bit_rows(vals))
    np.testing.assert_array_equal(tgptq._unpack_3bit_rows(packed, 96), vals)
    np.testing.assert_array_equal(tgptq._unpack_3bit_cols(packed.T, 96), vals.T)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pack_bytes_rows_matches_jax(bits):
    vals = np.random.default_rng(bits).integers(0, 1 << bits, (64, 9)).astype(np.uint8)
    got = tgptq._pack_bytes_rows(vals, bits)
    np.testing.assert_array_equal(got, jgptq._pack_bytes_rows(vals, bits))
    planes = tqm._affine_values(torch.from_numpy(got), bits)
    np.testing.assert_array_equal(planes.numpy(), vals)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("sym", [False, True])
def test_quantize_gptq_rtn_matches_jax(bits, sym):
    w = _w(64, 256, bits)
    got = tgptq.quantize_gptq_rtn(w, bits, group_size=64, sym=sym)
    want = jgptq.quantize_gptq_rtn(w, bits, group_size=64, sym=sym)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------- GPTQ layouts


def _gptq_tensors(bits, in_f, out_f, group, seed, order=None):
    """AutoGPTQ tensors; `order` "act" shuffles the rows (full groups, as a
    desc_act checkpoint), "ragged" gives groups of unequal sizes."""
    t = jgptq.quantize_gptq_rtn(_w(out_f, in_f, seed), bits, group_size=group)
    g_idx = t["g_idx"]
    qweight = t["qweight"]
    if order is not None:
        rng = np.random.default_rng(seed + 1)
        if order == "act":
            perm = rng.permutation(in_f)
        else:
            g_idx = np.sort(rng.integers(0, in_f // group, in_f)).astype(np.int32)
            perm = np.arange(in_f)
        g_idx = g_idx[perm]
        if bits == 3:
            q = jgptq._unpack_3bit_rows(qweight, in_f)[perm]
            qweight = jgptq._pack_3bit_rows(q)
        else:
            per = 32 // bits
            q = jgptq._unpack_int32_rows(qweight, bits, in_f)[perm].astype(np.uint32)
            packed = np.zeros((in_f // per, out_f), np.uint32)
            for j in range(per):
                packed |= q[j::per] << (bits * j)
            qweight = packed.astype(np.int32)
    return (qweight, t["qzeros"], t["scales"].astype(np.float32), g_idx, bits, in_f, out_f)


@pytest.mark.parametrize("bits,in_f,group,kind", [
    (2, 512, 64, "gptq_2"), (3, 512, 64, "gptq_b8"), (4, 512, 64, "gguf_q4k"),
    (4, 256, 64, "gptq_4"), (4, 512, 16, "gptq_4"), (8, 512, 128, "gptq_8")])
@pytest.mark.parametrize("order", [None, "act", "ragged"])
def test_gptq_linear_from_tensors_matches_jax(bits, in_f, group, kind, order):
    """Same kind and data for every bits value: 4-bit with contiguous
    groups onto gguf_q4k (K1), act-order rows sorted at load with in_perm,
    ragged groups keeping g_idx; the forwards agree."""
    args = _gptq_tensors(bits, in_f, 64, group, bits + in_f + group, order)
    jl = jgptq.gptq_linear_from_tensors(*args, dtype=jnp.float32)
    tl = tgptq.gptq_linear_from_tensors(*args, dtype=torch.float32, device="cpu")
    want_kind = {"ragged": f"gptq_{'b8' if bits == 3 else bits}"}.get(order, kind)
    assert tl.kind == want_kind
    assert ("in_perm" in tl.data) == (order == "act")
    assert ("g_idx" in tl.data) == (order == "ragged")
    for key in ("in_perm", "g_idx"):  # int64 for torch indexing (JAX keeps int32)
        assert tl.data.get(key, torch.zeros(0, dtype=torch.int64)).dtype == torch.int64
    _same_linear(tl, jl)
    for rows in (3, 300):
        _forward_matches(tl, jl, rows, rows + bits)


def test_gptq_rejects_unsupported_bits():
    with pytest.raises(ValueError):
        tgptq.gptq_linear_from_tensors(np.zeros((5, 8), np.int32), np.zeros((1, 5), np.int32),
                                       np.ones((1, 8), np.float32), None, 5, 32, 8, device="cpu")


def test_gptq_act_order_routes_through_k10_with_the_gather(monkeypatch):
    """An act-order GPTQ-8 linear at decode rows: x gathered by in_perm in
    `linear`, then K10 on the sorted rows (no g_idx gather)."""
    seen = []
    plain = tqm.affine_gemv_plain
    monkeypatch.setattr(tqm, "affine_gemv_plain",
                        lambda x, *a, **kw: seen.append(a[3:5]) or plain(x, *a, **kw))
    args = _gptq_tensors(8, 512, 64, 128, 5, "act")
    tl = tgptq.gptq_linear_from_tensors(*args, dtype=torch.float32, device="cpu")
    jl = jgptq.gptq_linear_from_tensors(*args, dtype=jnp.float32)
    _forward_matches(tl, jl, 4, 6)
    assert seen == [(8, 128)]


# --------------------------------------------------------------- HQQ


@pytest.mark.parametrize("bits,in_f,group,kind", [
    (1, 512, 64, "hqq_1"), (2, 512, 64, "hqq_2"), (3, 256, 64, "hqq_3"),
    (4, 512, 64, "gguf_q4k"), (4, 256, 64, "hqq_4"), (8, 256, 32, "hqq_8")])
def test_quantize_hqq_matches_jax(bits, in_f, group, kind):
    w = _w(48, in_f, bits + in_f)
    jl = jhqq.quantize_hqq(w, bits, group_size=group, dtype=jnp.float32)
    tl = thqq.quantize_hqq(w, bits, group_size=group, dtype=torch.float32, device="cpu")
    assert tl.kind == kind
    _same_linear(tl, jl)
    if kind != "gguf_q4k":
        np.testing.assert_array_equal(
            thqq.hqq_dequant_weights(tl, torch.float32, bits).numpy(),
            np.asarray(jhqq.hqq_dequant_weights(jl, jnp.float32, bits)))
    for rows in (2, 257):
        _forward_matches(tl, jl, rows, rows + bits)


def test_hqq_type_and_shrink_match_jax():
    assert thqq.HqqType(2).group_size == jhqq.HqqType(2).group_size == 64
    with pytest.raises(ValueError):
        thqq.HqqType(5)
    x = np.random.default_rng(0).standard_normal(100)
    np.testing.assert_array_equal(thqq._shrink_lp(x, 10.0, 0.7), jhqq._shrink_lp(x, 10.0, 0.7))


# --------------------------------------------------------------- fusion


def _act_order_pair(seed, perm_seed, in_f=512, out_f=32):
    """(JAX, port) GPTQ-2 linears whose rows follow the permutation drawn
    from perm_seed."""
    t = jgptq.quantize_gptq_rtn(_w(out_f, in_f, seed), 2, group_size=64)
    perm = np.random.default_rng(perm_seed).permutation(in_f)
    q = jgptq._unpack_int32_rows(t["qweight"], 2, in_f)[perm].astype(np.uint32)
    packed = np.zeros((in_f // 16, out_f), np.uint32)
    for j in range(16):
        packed |= q[j::16] << (2 * j)
    args = (packed.astype(np.int32), t["qzeros"], t["scales"].astype(np.float32),
            t["g_idx"][perm], 2, in_f, out_f)
    return (jgptq.gptq_linear_from_tensors(*args, dtype=jnp.float32),
            tgptq.gptq_linear_from_tensors(*args, dtype=torch.float32, device="cpu"))


def test_fuse_refuses_mismatched_act_order_perms():
    (j1, t1), (j2, t2) = _act_order_pair(1, 10), _act_order_pair(2, 11)
    assert "in_perm" in t1.data and "in_perm" in t2.data
    assert tfuse.fuse_linears([t1, t2]) is None and jfuse.fuse_linears([j1, j2]) is None
    plain = tgptq.gptq_linear_from_tensors(
        *(lambda t: (t["qweight"], t["qzeros"], t["scales"].astype(np.float32), t["g_idx"], 2,
                     512, 32))(jgptq.quantize_gptq_rtn(_w(32, 512, 3), 2, group_size=64)),
        dtype=torch.float32, device="cpu")
    assert "in_perm" not in plain.data
    assert tfuse.fuse_linears([t1, plain]) is None and tfuse.fuse_linears([plain, t1]) is None


def test_fuse_refuses_ragged_g_idx():
    args = _gptq_tensors(2, 512, 32, 64, 4, "ragged")
    t1 = tgptq.gptq_linear_from_tensors(*args, dtype=torch.float32, device="cpu")
    assert "g_idx" in t1.data
    assert tfuse.fuse_linears([t1, t1]) is None
    assert tfuse.split_linear(t1, [16, 16]) is None and tfuse.pad_linear_out(t1, 64) is None


def test_fuse_shared_act_order_perm_matches_concat():
    """Identical in_perms fuse: the shared gather hoists past the fused
    product, which equals the two products side by side (and JAX's)."""
    (j1, t1), (j2, t2) = _act_order_pair(5, 12), _act_order_pair(6, 12)
    fused, jfused = tfuse.fuse_linears([t1, t2]), jfuse.fuse_linears([j1, j2])
    assert fused is not None and fused.kind == "gptq_2" and fused.shape == (512, 64)
    assert torch.equal(fused.data["in_perm"], t1.data["in_perm"])
    x = torch.from_numpy((np.random.default_rng(7).standard_normal((3, 512))).astype(np.float32))
    got = linear(fused, x)
    _close(got.numpy(), torch.cat([linear(t1, x), linear(t2, x)], dim=-1).numpy())
    _close(got.numpy(), jlinear(jfused, jnp.asarray(x.numpy())))


@pytest.mark.parametrize("kind_of", ["gptq", "hqq", "q2k"])
def test_fuse_concatenates_the_new_kinds(kind_of):
    from mistralrs_tpu.gguf.reader import GGMLType
    from mistralrs_tpu.quant import kquants
    from mistralrs_tpu_torch.quant.gguf_linear import linear_from_gguf

    def make(seed):
        w = _w(32, 512, seed)
        if kind_of == "gptq":
            t = jgptq.quantize_gptq_rtn(w, 8, group_size=128)
            return tgptq.gptq_linear_from_tensors(t["qweight"], t["qzeros"],
                                                  t["scales"].astype(np.float32), None, 8, 512,
                                                  32, dtype=torch.float32, device="cpu")
        if kind_of == "hqq":
            return thqq.quantize_hqq(w, 2, dtype=torch.float32, device="cpu")
        return linear_from_gguf(kquants.quantize(w, GGMLType.Q2_K), int(GGMLType.Q2_K),
                                (32, 512), dtype=torch.float32, device="cpu")

    l1, l2 = make(1), make(2)
    fused = tfuse.fuse_linears([l1, l2])
    assert fused is not None and fused.kind == l1.kind and fused.shape == (512, 64)
    x = torch.from_numpy((np.random.default_rng(3).standard_normal((2, 512))).astype(np.float32))
    _close(linear(fused, x).numpy(), torch.cat([linear(l1, x), linear(l2, x)], dim=-1).numpy())
    parts = tfuse.split_linear(fused, [32, 32])
    _close(linear(parts[1], x).numpy(), linear(l2, x).numpy())


# -------------------------------------------------- params_from_reference


def test_params_from_reference_carries_every_new_kind():
    """A one-layer JAX model whose projections are Q2_K, GPTQ (act-order,
    ragged, 3-bit) and HQQ Linears arrives with the same kinds and bytes,
    int32 indices widened to int64, float data in the working dtype; its
    projections compute what the JAX ones do."""
    from mistralrs_tpu.gguf.reader import GGMLType
    from mistralrs_tpu.quant import kquants
    from mistralrs_tpu.quant.gguf_linear import linear_from_gguf

    H, I = 512, 512
    q2k = linear_from_gguf(kquants.quantize(_w(H, H, 1), GGMLType.Q2_K), GGMLType.Q2_K, (H, H),
                           dtype=jnp.float32)
    act = jgptq.gptq_linear_from_tensors(*_gptq_tensors(8, H, H, 128, 2, "act"),
                                         dtype=jnp.float32)
    ragged = jgptq.gptq_linear_from_tensors(*_gptq_tensors(2, H, H, 64, 3, "ragged"),
                                            dtype=jnp.float32)
    b3 = jgptq.gptq_linear_from_tensors(*_gptq_tensors(3, H, H, 64, 4), dtype=jnp.float32)
    layer = {"attn": {"q": q2k, "k": act, "v": ragged, "o": b3},
             "mlp": {"gate": jhqq.quantize_hqq(_w(I, H, 5), 1, dtype=jnp.float32),
                     "up": jhqq.quantize_hqq(_w(I, H, 6), 3, dtype=jnp.float32),
                     "down": jhqq.quantize_hqq(_w(H, I, 7), 8, dtype=jnp.float32)},
             "input_norm": {"w": jnp.ones((H,), jnp.float32)},
             "post_attn_norm": {"w": jnp.ones((H,), jnp.float32)}}
    groups, sizes = group_layers([layer])
    jp = JDecoderParams(embed=jnp.zeros((16, H), jnp.float32), layer_groups=groups,
                        final_norm={"w": jnp.ones((H,), jnp.float32)}, lm_head=None,
                        group_sizes=sizes)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.float32)
    (tlayer,) = tp.layers
    kinds = {k: lin.kind for part in ("attn", "mlp") for k, lin in tlayer[part].items()}
    assert kinds == {"q": "gguf_q2k", "k": "gptq_8", "v": "gptq_2", "o": "gptq_b8",
                     "gate": "hqq_1", "up": "hqq_3", "down": "hqq_8"}
    assert tlayer["attn"]["k"].data["in_perm"].dtype == torch.int64
    assert tlayer["attn"]["v"].data["g_idx"].dtype == torch.int64
    bf = params_from_reference(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.bfloat16)
    for part in ("attn", "mlp"):
        for name, jl in layer[part].items():
            tl = tlayer[part][name]
            for k, v in jl.data.items():
                np.testing.assert_array_equal(tl.data[k].numpy(), np.asarray(v), err_msg=name + k)
            assert tl.data.get("q", tl.data.get("qs")).dtype == torch.uint8
            assert bf.layers[0][part][name].data["scale"].dtype == torch.bfloat16
            _forward_matches(tl, jl, 3, len(name))
