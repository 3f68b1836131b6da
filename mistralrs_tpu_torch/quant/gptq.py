"""GPTQ checkpoint tensors -> packed device formats, and their forwards.

Counterpart of mistralrs_tpu/quant/gptq.py. The AutoGPTQ format per linear:
    qweight int32 [in*bits/32, out]   (32/bits input dims packed per int32)
    qzeros  int32 [in/group, out*bits/32]
    scales  f16   [in/group, out]
    g_idx   int32 [in]                (group of each input dim; act-order)
The device layouts are byte for byte the JAX package's:
- 4-bit with contiguous groups (in % 512 == 0, group % 32 == 0) maps onto
  "gguf_q4k" (w = q*scale - minv at 32-element granularity) and rides K1;
- otherwise "gptq_2" / "gptq_4" / "gptq_8": q uint8 plane-major packed along
  `in` (quant/gptq._pack_bytes_rows: byte row r, bit slot j = element
  j*(in*bits/8) + r), scale [in/group, out], zs = scale*zero; "gptq_b8"
  keeps 3-bit codes one a byte. w[k, o] = q[k, o]*scale[g(k), o] - zs[g(k), o].
- act-order checkpoints whose groups are all full are sorted by g_idx at
  load: the rows move into contiguous groups and `in_perm` gathers x
  (quant/qlinear.linear); ragged groups keep `g_idx` and a gathered dequant.
The forwards go to ops/quant_matmul.affine_qmatmul (K10 up to 256 rows,
affine_dequant + torch.matmul above); a `g_idx` Linear dequantizes with the
scale gather (torch ops, as the JAX package leaves it to XLA) + torch.matmul.
"""

from __future__ import annotations

import numpy as np
import torch

from mistralrs_tpu_torch.quant.gguf_linear import _tensor
from mistralrs_tpu_torch.quant.qlinear import Linear, register_kind


def _unpack_int32_rows(packed: np.ndarray, bits: int, total: int) -> np.ndarray:
    """[n_packed, C] int32 -> [total, C] uint8, `32//bits` values per int32
    along axis 0 (AutoGPTQ row packing)."""
    per = 32 // bits
    mask = (1 << bits) - 1
    u = packed.astype(np.uint32)
    out = np.empty((packed.shape[0] * per, packed.shape[1]), np.uint8)
    for j in range(per):
        out[j::per] = ((u >> (bits * j)) & mask).astype(np.uint8)
    return out[:total]


def _unpack_int32_cols(packed: np.ndarray, bits: int, total: int) -> np.ndarray:
    """[R, n_packed] int32 -> [R, total] uint8 along axis 1."""
    per = 32 // bits
    mask = (1 << bits) - 1
    u = packed.astype(np.uint32)
    out = np.empty((packed.shape[0], packed.shape[1] * per), np.uint8)
    for j in range(per):
        out[:, j::per] = ((u >> (bits * j)) & mask).astype(np.uint8)
    return out[:, :total]


def _unpack_3bit_rows(packed: np.ndarray, total: int) -> np.ndarray:
    """AutoGPTQ 3-bit row packing: 32 values per 3 int32s (bit-contiguous)."""
    u = packed.astype(np.uint32)
    n_trip = packed.shape[0] // 3
    C = packed.shape[1]
    vals = np.empty((n_trip * 32, C), np.uint8)
    # 96 bits per 32-value triple; a 3-bit field may straddle two words
    w0, w1, w2 = u[0::3].astype(np.uint64), u[1::3].astype(np.uint64), u[2::3].astype(np.uint64)
    for j in range(32):
        lo_bit = 3 * j
        hi_bit = lo_bit + 3
        if hi_bit <= 32:
            v = (w0 >> lo_bit) & 0x7
        elif lo_bit < 32:
            v = ((w0 >> lo_bit) | (w1 << (32 - lo_bit))) & 0x7
        elif hi_bit <= 64:
            v = (w1 >> (lo_bit - 32)) & 0x7
        elif lo_bit < 64:
            v = ((w1 >> (lo_bit - 32)) | (w2 << (64 - lo_bit))) & 0x7
        else:
            v = (w2 >> (lo_bit - 64)) & 0x7
        vals[j::32] = v.astype(np.uint8)
    return vals[:total]


def _unpack_3bit_cols(packed: np.ndarray, total: int) -> np.ndarray:
    """Column-direction 3-bit unpack: [R, n*3] int32 -> [R, total] uint8."""
    return _unpack_3bit_rows(packed.T, total).T


def _pack_3bit_rows(vals: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_3bit_rows: [R, C] uint8 (values < 8, R % 32 == 0)
    -> [R*3/32, C] int32, 32 values bit-contiguous per 3 uint32 words."""
    R, C = vals.shape
    if R % 32:
        raise ValueError(f"3-bit packing needs rows % 32 == 0, got {R}")
    n_trip = R // 32
    w = np.zeros((n_trip, 3, C), np.uint64)
    v = vals.reshape(n_trip, 32, C).astype(np.uint64)
    for j in range(32):
        word, off = divmod(3 * j, 32)
        w[:, word] |= v[:, j] << off
        if off > 29:  # the field straddles into the next word
            w[:, word + 1] |= v[:, j] >> (32 - off)
    return (w & 0xFFFFFFFF).astype(np.uint32).reshape(n_trip * 3, C).astype(np.int32)


def _pack_bytes_rows(vals: np.ndarray, bits: int) -> np.ndarray:
    """[in, out] uint8 (values < 2^bits) -> packed uint8 [in*bits/8, out],
    plane-major: byte row r, bit slot j holds element j*(in*bits/8) + r, so
    each unpacked plane is a contiguous element chunk (the layout K10 reads)."""
    per = 8 // bits
    K, O = vals.shape
    if K % per:
        raise ValueError(f"{bits}-bit packing needs rows % {per} == 0, got {K}")
    planes = vals.reshape(per, K // per, O).astype(np.uint16)
    out = np.zeros((K // per, O), np.uint16)
    for j in range(per):
        out |= planes[j] << (bits * j)
    return out.astype(np.uint8)


def gptq_linear_from_tensors(
    qweight: np.ndarray,
    qzeros: np.ndarray,
    scales: np.ndarray,
    g_idx: np.ndarray | None,
    bits: int,
    in_features: int,
    out_features: int,
    dtype=torch.bfloat16,
    zero_plus_one: bool = True,
    bias: np.ndarray | None = None,
    device="cuda",
) -> Linear:
    """Build the device Linear from AutoGPTQ tensors.

    zero_plus_one: v1 checkpoints store zero-1 (the kernels add 1 back);
    gptq_v2 stores the true zero."""
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"GPTQ bits {bits} not in (2, 3, 4, 8)")
    if bits == 3:
        q = _unpack_3bit_rows(qweight, in_features)  # [in, out] uint8
        zeros = _unpack_3bit_cols(qzeros, out_features)
    else:
        q = _unpack_int32_rows(qweight, bits, in_features)  # [in, out] uint8
        zeros = _unpack_int32_cols(qzeros, bits, out_features)  # [ng, out]
    if zero_plus_one:
        zeros = zeros.astype(np.int32) + 1
    s = scales.astype(np.float32)  # [ng, out]
    zs = s * zeros.astype(np.float32)
    n_groups = s.shape[0]
    group_size = in_features // n_groups
    gi = None
    in_perm = None
    if g_idx is not None:
        want = np.arange(in_features) // group_size
        if not np.array_equal(g_idx, want):
            counts = np.bincount(g_idx, minlength=n_groups)
            if np.all(counts == group_size):
                # act-order with full groups: sort the rows into contiguous
                # groups once here; the forward gathers x by in_perm
                perm = np.argsort(g_idx, kind="stable")
                q = np.ascontiguousarray(q[perm])
                in_perm = _tensor(perm.astype(np.int64), device)
            else:
                # ragged groups: the dequant gathers scale rows by g_idx
                gi = _tensor(g_idx.astype(np.int64), device)
    data = {}
    if bits == 4 and gi is None and in_features % 512 == 0 and group_size % 32 == 0:
        # contiguous-group 4-bit GPTQ is exactly the Q4_K device format
        # (w = q*scale - minv) at 32-element granularity: K1 serves it
        rep = group_size // 32
        half = in_features // 2
        kind = "gguf_q4k"
        data = {"qs": _tensor(q[:half] | (q[half:] << 4), device),
                "scale": _tensor(np.repeat(s, rep, axis=0), device, dtype),
                "minv": _tensor(np.repeat(zs, rep, axis=0), device, dtype)}
    else:
        if bits == 3:
            kind, qdev = "gptq_b8", q  # one code a byte
        else:
            kind, qdev = f"gptq_{bits}", _pack_bytes_rows(q, bits)
        data = {"q": _tensor(qdev, device), "scale": _tensor(s, device, dtype),
                "zs": _tensor(zs, device, dtype)}
        if gi is not None:
            data["g_idx"] = gi
    if in_perm is not None:
        data["in_perm"] = in_perm
    if bias is not None:
        data["b"] = _tensor(bias, device, dtype)
    return Linear(kind=kind, shape=(in_features, out_features), data=data)


# ------------------------------------------------------------------ forward


def _gptq_weights(lin: Linear, dtype, bits: int) -> torch.Tensor:
    """Dequantized w [in, out] in `dtype`: affine_dequant (one kernel on the
    card), or, with a ragged g_idx, the codes times the scale and zs rows
    gathered by g_idx."""
    from mistralrs_tpu_torch.ops.quant_matmul import _affine_values, affine_dequant

    q, scale, zs = lin.data["q"], lin.data["scale"], lin.data["zs"]
    gi = lin.data.get("g_idx")
    if gi is None:
        group = lin.shape[0] // scale.shape[0]
        return affine_dequant(q, scale, zs, bits, group, dtype)
    return _affine_values(q, bits).to(dtype) * scale.to(dtype)[gi] - zs.to(dtype)[gi]


def _gptq_forward(bits: int):
    """bits: the device codes' width (8 for the byte-per-value 3-bit kind)."""

    def fwd(lin: Linear, x: torch.Tensor) -> torch.Tensor:
        from mistralrs_tpu_torch.ops.quant_matmul import _add_bias, affine_qmatmul

        if "g_idx" in lin.data:
            return _add_bias(lin, torch.matmul(x, _gptq_weights(lin, x.dtype, bits)))
        group = lin.shape[0] // lin.data["scale"].shape[0]
        return affine_qmatmul(lin, x, bits=bits, group=group)

    return fwd


register_kind("gptq_2")(_gptq_forward(2))
register_kind("gptq_4")(_gptq_forward(4))
register_kind("gptq_8")(_gptq_forward(8))
register_kind("gptq_b8")(_gptq_forward(8))


# ------------------------------------------------- reference-style quantizer


def quantize_gptq_rtn(w_out_in: np.ndarray, bits: int, group_size: int = 128,
                      sym: bool = False) -> dict[str, np.ndarray]:
    """Round-to-nearest GPTQ-format quantizer (no Hessian pass): AutoGPTQ
    layout tensors for tests and for quantizing a dense weight."""
    out_f, in_f = w_out_in.shape
    if in_f % group_size:
        raise ValueError(f"in_features {in_f} % group_size {group_size} != 0")
    w = w_out_in.T.astype(np.float32)  # [in, out]
    ng = in_f // group_size
    wg = w.reshape(ng, group_size, out_f)
    maxq = (1 << bits) - 1
    if sym:
        amax = np.abs(wg).max(axis=1, keepdims=True)
        scale = np.maximum(amax / ((maxq + 1) / 2 - 0.5), 1e-9)
        zero = np.full_like(scale, (maxq + 1) // 2)
    else:
        wmin = np.minimum(wg.min(axis=1, keepdims=True), 0)
        wmax = np.maximum(wg.max(axis=1, keepdims=True), 0)
        scale = np.maximum((wmax - wmin) / maxq, 1e-9)
        zero = np.clip(np.round(-wmin / scale), 0, maxq)
    q = np.clip(np.round(wg / scale) + zero, 0, maxq).astype(np.uint8)
    q = q.reshape(in_f, out_f)
    zcols = np.clip(zero[:, 0].astype(np.int32) - 1, 0, maxq).astype(np.uint32)  # v1: zero - 1
    if bits == 3:
        qweight = _pack_3bit_rows(q)
        qzeros = _pack_3bit_rows(zcols.T).T
    else:
        per = 32 // bits
        qweight = np.zeros((in_f // per, out_f), np.uint32)
        for j in range(per):
            qweight |= q[j::per].astype(np.uint32) << (bits * j)
        qzeros = np.zeros((ng, out_f // per), np.uint32)
        for j in range(per):
            qzeros |= zcols[:, j::per] << (bits * j)
    return {
        "qweight": np.ascontiguousarray(qweight.astype(np.int32)),
        "qzeros": np.ascontiguousarray(qzeros.astype(np.int32)),
        "scales": np.ascontiguousarray(scale[:, 0].astype(np.float16)),  # [ng, out]
        "g_idx": (np.arange(in_f) // group_size).astype(np.int32),
    }
