"""Quantized `Linear` device formats for GGUF weights (Q2_K, Q4_K, Q5_K, Q6_K,
Q8_0).

Counterpart of mistralrs_tpu/quant/gguf_linear.py. The device layouts are
byte-for-byte those of the JAX package, so one numpy pack feeds both:
- "gguf_q4k":  qs uint8 [in/2, out] paired nibbles (byte row r holds element
  r in its low and element r + in/2 in its high nibble), scale and minv
  [in/32, out] (w = scale*q - minv);
- "gguf_q5k":  the gguf_q4k arrays plus qh uint8 [in/8, out], plane-major
  high bits (row r, bit j = element j*in/8 + r); w = scale*(nib + 16*hbit)
  - minv;
- "gguf_q6k":  ql uint8 [in/2, out], qh uint8 [in/4, out], scale [in/16,
  out] in the chunked permuted order of `q6k_perm`, with perm/inv_perm
  (kept for layout parity; the kernels read x in element order);
- "gguf_q8_0": q int8 [in, out], scale [in/gs, out]; gs = meta or 32 (wire
  Q8_0 has 32 and a bf16 scale, the Q6_K requant "rq8" an f32 scale);
- "gguf_q2k":  q uint8 [in/4, out] quarter-plane-major 2-bit codes (row r,
  bits 2j = element j*in/4 + r), scale and minv [in/16, out]
  (w = scale*q - minv), served by the plane-affine kernel K10.
The legacy formats ride these layouts with numpy packers alone: Q4_0/Q4_1
as gguf_q4k, Q5_0/Q5_1 as gguf_q5k, Q3_K as gguf_q6k (q3 + 28).

Every forward goes to a dispatcher of ops/quant_matmul.py: the GEMV kernels
at up to 256 rows, dequantize + torch.matmul above.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mistralrs_tpu_torch.quant import kquants
from mistralrs_tpu_torch.quant.kquants import GGMLType
from mistralrs_tpu_torch.quant.qlinear import Linear, register_kind


def _tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


# ----------------------------------------------------------------- packers


def _paired_nibbles(v: np.ndarray) -> np.ndarray:
    """[in, out] values (low 4 bits used) -> [in/2, out] paired bytes."""
    half = v.shape[0] // 2
    lo = v & 0xF
    return lo[:half] | (lo[half:] << 4)


def _plane_bits(hb: np.ndarray) -> np.ndarray:
    """[in, out] bits 0/1 in element order -> [in/8, out] plane-major bytes
    (row r, bit j = element j*in/8 + r)."""
    K8 = hb.shape[0] // 8
    planes = hb.reshape(8, K8, hb.shape[1])
    qhp = np.zeros((K8, hb.shape[1]), np.uint8)
    for j in range(8):
        qhp |= planes[j] << j
    return qhp


def _k4_wire_nibbles(qs: np.ndarray, out_f: int, in_f: int) -> np.ndarray:
    """Q4_K/Q5_K wire nibbles [out, nblk, 128] -> element order [in, out]."""
    nblk = in_f // 256
    qs4 = qs.reshape(out_f, nblk, 4, 32)
    v = np.empty((out_f, nblk, 4, 2, 32), np.uint8)
    v[..., 0, :] = qs4 & 0xF  # elements 256b + 64c + j
    v[..., 1, :] = qs4 >> 4  # elements 256b + 64c + 32 + j
    return v.reshape(out_f, in_f).T


def _k4_scales(b: np.ndarray, out_f: int) -> tuple[np.ndarray, np.ndarray]:
    """Q4_K/Q5_K block header (d, dmin, 12 scale bytes) -> scale, minv
    [in/32, out] f32."""
    nblk = b.shape[1]
    d = kquants._f16(b[:, :, 0:2].copy())  # [out, nblk, 1]
    dmin = kquants._f16(b[:, :, 2:4].copy())
    sc, mn = kquants._unpack_scales_k4(b[:, :, 4:16])  # [out, nblk, 8] uint8
    scale = d * sc.astype(np.float32)
    minv = dmin * mn.astype(np.float32)
    return (scale.transpose(1, 2, 0).reshape(nblk * 8, out_f),
            minv.transpose(1, 2, 0).reshape(nblk * 8, out_f))


def pack_q4k(raw: np.ndarray, out_features: int, in_features: int,
             dtype=torch.bfloat16, device="cuda") -> Linear:
    """GGUF Q4_K wire blocks -> K-major paired-nibble layout. raw: uint8 of (out, in)."""
    b = kquants._blocks(raw, 144).reshape(out_features, in_features // 256, 144)
    scale_t, minv_t = _k4_scales(b, out_features)
    v = _k4_wire_nibbles(b[:, :, 16:144], out_features, in_features)  # [in, out]
    return Linear(
        kind="gguf_q4k",
        shape=(in_features, out_features),
        data={
            "qs": _tensor(_paired_nibbles(v), device),
            "scale": _tensor(scale_t, device, dtype),
            "minv": _tensor(minv_t, device, dtype),
        },
    )


def pack_q5k(raw: np.ndarray, out_features: int, in_features: int,
             dtype=torch.bfloat16, device="cuda") -> Linear:
    """GGUF Q5_K wire blocks (176 B / 256 elements) -> the gguf_q4k paired
    nibbles, scale and minv plus plane-major high bits qh [in/8, out]."""
    nblk = in_features // 256
    b = kquants._blocks(raw, 176).reshape(out_features, nblk, 176)
    scale_t, minv_t = _k4_scales(b, out_features)
    v = _k4_wire_nibbles(b[:, :, 48:176], out_features, in_features)
    # high bits: qh byte j bit (2c+h) -> element 256b + 32*(2c+h) + j
    qh = b[:, :, 16:48]  # [out, nblk, 32]
    shifts = np.arange(8, dtype=np.uint8)
    hb = ((qh[:, :, None, :] >> shifts[None, None, :, None]) & 1).astype(np.uint8)
    hb = hb.reshape(out_features, in_features).T  # [in, out] element order
    return Linear(
        kind="gguf_q5k",
        shape=(in_features, out_features),
        data={
            "qs": _tensor(_paired_nibbles(v), device),
            "qh": _tensor(_plane_bits(hb), device),
            "scale": _tensor(scale_t, device, dtype),
            "minv": _tensor(minv_t, device, dtype),
        },
    )


def _pack_affine_q4(v: np.ndarray, scale32: np.ndarray, minv32: np.ndarray,
                    in_features: int, out_features: int, dtype, device) -> Linear:
    """w = scale*q - minv with 4-bit q (v [out, in], 0..15, element order)
    and per-32 scale32/minv32 [out, in/32] -> the gguf_q4k layout."""
    return Linear(
        kind="gguf_q4k",
        shape=(in_features, out_features),
        data={
            "qs": _tensor(_paired_nibbles(v.T), device),
            "scale": _tensor(scale32.T, device, dtype),
            "minv": _tensor(minv32.T, device, dtype),
        },
    )


def _pack_affine_q5(v: np.ndarray, scale32: np.ndarray, minv32: np.ndarray,
                    in_features: int, out_features: int, dtype, device) -> Linear:
    """The 5-bit form (v [out, in], 0..31) -> the gguf_q5k layout."""
    vT = v.T
    return Linear(
        kind="gguf_q5k",
        shape=(in_features, out_features),
        data={
            "qs": _tensor(_paired_nibbles(vT), device),
            "qh": _tensor(_plane_bits((vT >> 4).astype(np.uint8)), device),
            "scale": _tensor(scale32.T, device, dtype),
            "minv": _tensor(minv32.T, device, dtype),
        },
    )


def _legacy_blocks(raw, out_f: int, in_f: int, nbytes: int):
    """Q4_0/Q4_1/Q5_0/Q5_1 blocks of 32: (the blocks [out, nblk, nbytes], d
    [out, nblk] f32, the trailing nibble bytes [out, nblk, 16])."""
    b = kquants._blocks(raw, nbytes).reshape(out_f, in_f // 32, nbytes)
    return b, _f16_field(b, 0), b[:, :, nbytes - 16:]


def _f16_field(b: np.ndarray, off: int) -> np.ndarray:
    """The f16 at byte `off` of each block, as f32 [out, nblk]."""
    return kquants._f16(b[:, :, off : off + 2].copy())[..., 0]


def _nibbles32(qs: np.ndarray, out_f: int, in_f: int) -> np.ndarray:
    return np.concatenate([qs & 0xF, qs >> 4], axis=2).reshape(out_f, in_f)


def _high_bits32(qh_bytes: np.ndarray) -> np.ndarray:
    """4 little-endian bytes per block -> [out, nblk, 32] bits."""
    qh = qh_bytes.copy().view(np.uint32)[..., 0]
    return ((qh[..., None] >> np.arange(32, dtype=np.uint32)) & 1).astype(np.uint8)


def pack_q4_0(raw: np.ndarray, out_features: int, in_features: int,
              dtype=torch.bfloat16, device="cuda") -> Linear:
    """Q4_0 rides the Q4_K layout: w = d*(v-8) = d*v - 8d."""
    _, d, qs = _legacy_blocks(raw, out_features, in_features, 18)
    v = _nibbles32(qs, out_features, in_features)
    return _pack_affine_q4(v, d, 8.0 * d, in_features, out_features, dtype, device)


def pack_q4_1(raw: np.ndarray, out_features: int, in_features: int,
              dtype=torch.bfloat16, device="cuda") -> Linear:
    """Q4_1 rides the Q4_K layout: w = d*v + m = d*v - (-m)."""
    b, d, qs = _legacy_blocks(raw, out_features, in_features, 20)
    m = _f16_field(b, 2)
    v = _nibbles32(qs, out_features, in_features)
    return _pack_affine_q4(v, d, -m, in_features, out_features, dtype, device)


def pack_q5_0(raw: np.ndarray, out_features: int, in_features: int,
              dtype=torch.bfloat16, device="cuda") -> Linear:
    """Q5_0 rides the Q5_K layout: w = d*(v-16) = d*v - 16d."""
    b, d, qs = _legacy_blocks(raw, out_features, in_features, 22)
    v = _nibbles32(qs, out_features, in_features)
    v = v | (_high_bits32(b[:, :, 2:6]).reshape(out_features, in_features) << 4)
    return _pack_affine_q5(v, d, 16.0 * d, in_features, out_features, dtype, device)


def pack_q5_1(raw: np.ndarray, out_features: int, in_features: int,
              dtype=torch.bfloat16, device="cuda") -> Linear:
    """Q5_1 rides the Q5_K layout: w = d*v + m."""
    b, d, qs = _legacy_blocks(raw, out_features, in_features, 24)
    m = _f16_field(b, 2)
    v = _nibbles32(qs, out_features, in_features)
    v = v | (_high_bits32(b[:, :, 4:8]).reshape(out_features, in_features) << 4)
    return _pack_affine_q5(v, d, -m, in_features, out_features, dtype, device)


def _q6k_int_values(raw: np.ndarray, out_f: int, in_f: int) -> tuple[np.ndarray, np.ndarray]:
    """Q6_K wire blocks -> (q uint8 [out, in] 6-bit values in element order,
    scale f32 [out, in/16] per-16 sub-scales d*int8)."""
    nblk = in_f // 256
    b = kquants._blocks(raw, 210).reshape(out_f, nblk, 210)
    ql = b[..., 0:128].reshape(out_f, nblk, 2, 64)
    qh = b[..., 128:192].reshape(out_f, nblk, 2, 32)
    sc = b[..., 192:208].view(np.int8).astype(np.float32)  # [out, nblk, 16]
    d = kquants._f16(b[..., 208:210].copy())  # [out, nblk, 1]
    lo = np.stack(
        [ql[..., 0:32] & 0xF, ql[..., 32:64] & 0xF, ql[..., 0:32] >> 4, ql[..., 32:64] >> 4],
        axis=3,
    )  # [out, nblk, 2, 4, 32]
    hi = np.stack([(qh >> s) & 3 for s in (0, 2, 4, 6)], axis=3)
    q = (lo | (hi << 4)).reshape(out_f, in_f)
    scale = d * sc  # [out, nblk, 16] per-16 groups in element order
    return q, scale.reshape(out_f, in_f // 16)


def _q3k_values(raw: np.ndarray, out_f: int, in_f: int) -> tuple[np.ndarray, np.ndarray]:
    """Q3_K wire blocks -> (q3 + 4 uint8 [out, in] element order (0..7),
    scale f32 [out, in/16])."""
    nblk = in_f // 256
    b = kquants._blocks(raw, 110).reshape(out_f * nblk, 110)
    N = b.shape[0]
    hmask = b[:, 0:32]
    qs = b[:, 32:96].reshape(N, 2, 32)
    packed = b[:, 96:108]
    d = kquants._f16(b[:, 108:110].copy())
    high = np.empty((N, 16), np.uint8)
    for j in range(4):
        high[:, 4 * j : 4 * j + 4] = (packed[:, 8:12] >> (2 * j)) & 3
    sc = np.empty((N, 16), np.int32)
    sc[:, 0:8] = (packed[:, 0:8] & 0xF).astype(np.int32) | (high[:, 0:8].astype(np.int32) << 4)
    sc[:, 8:16] = (packed[:, 0:8] >> 4).astype(np.int32) | (high[:, 8:16].astype(np.int32) << 4)
    sc = sc - 32
    shifts = np.arange(4, dtype=np.uint8)
    q = ((qs[:, :, None, :] >> (2 * shifts)[None, None, :, None]) & 3).reshape(N, 16, 16)
    mbits = np.empty((N, 16, 16), bool)
    for half in range(2):
        for j in range(4):
            chunk = (hmask.astype(np.int32) & (1 << (half * 4 + j))) != 0
            mbits[:, half * 8 + 2 * j] = chunk[:, 0:16]
            mbits[:, half * 8 + 2 * j + 1] = chunk[:, 16:32]
    q = q.astype(np.int32) - np.where(mbits, 0, 4) + 4  # 0..7 (true value + 4)
    scale = d * sc.astype(np.float32)  # [N, 16] per-16
    return q.reshape(out_f, in_f).astype(np.uint8), scale.reshape(out_f, in_f // 16)


def q6k_chunk_size(in_features: int) -> int | None:
    """Largest span size G with in/4 % G == 0."""
    for g in (512, 256, 128, 64):
        if (in_features // 4) % g == 0:
            return g
    return None


def q6k_perm(K: int, G: int) -> np.ndarray:
    """The q6k chunked-layout permutation: packed position p = c*4G + j*G + t
    holds original element j*(K/4) + c*G + t."""
    C = K // (4 * G)
    j_idx, c_idx, t_idx = np.meshgrid(
        np.arange(4), np.arange(C), np.arange(G), indexing="ij"
    )
    return (j_idx * (K // 4) + c_idx * G + t_idx).transpose(1, 0, 2).reshape(K)


def pack_q6k(raw: np.ndarray, out_features: int, in_features: int,
             dtype=torch.bfloat16, device="cuda") -> Linear:
    """GGUF Q6_K wire blocks -> chunked K-major layout (see the JAX
    package's pack_q6k for the byte map); w = scale*(q-32)."""
    q, s16 = _q6k_int_values(raw, out_features, in_features)
    return _pack_q6k_from_values(q, s16, out_features, in_features, dtype, device)


def pack_q3k(raw: np.ndarray, out_features: int, in_features: int,
             dtype=torch.bfloat16, device="cuda") -> Linear:
    """Q3_K rides the Q6_K layout: w = s16*(q3-4) with q3 in 0..7 is exactly
    s16*(q6-32) with q6 = q3 + 28."""
    q3, s16 = _q3k_values(raw, out_features, in_features)
    return _pack_q6k_from_values(q3 + 28, s16, out_features, in_features, dtype, device)


def _pack_q6k_from_values(q: np.ndarray, s16: np.ndarray, out_features: int,
                          in_features: int, dtype, device) -> Linear:
    """Pack 6-bit values (q [out, in] element order, 0..63) + per-16 scales
    s16 [out, in/16] into the chunked q6k layout."""
    G = q6k_chunk_size(in_features)
    if G is None:
        raise ValueError(f"in_features {in_features} not packable for q6k")
    K, O = in_features, out_features
    C = K // (4 * G)
    qT = q.T  # [K, O]
    ln = (qT & 0xF).reshape(4, C, G, O)  # [span j, chunk c, t, O]
    hb = (qT >> 4).reshape(4, C, G, O)
    qlc = np.concatenate([ln[0] | (ln[2] << 4), ln[1] | (ln[3] << 4)], axis=1)  # [C, 2G, O]
    qhc = hb[0] | (hb[1] << 2) | (hb[2] << 4) | (hb[3] << 6)  # [C, G, O]
    sT = s16.T.reshape(4, C, G // 16, O).transpose(1, 0, 2, 3).reshape(K // 16, O)
    perm = q6k_perm(K, G)
    return Linear(
        kind="gguf_q6k",
        shape=(in_features, out_features),
        data={
            "ql": _tensor(qlc.reshape(K // 2, O), device),
            "qh": _tensor(qhc.reshape(K // 4, O), device),
            "scale": _tensor(sT, device, dtype),
            "perm": _tensor(perm.astype(np.int64), device),
            "inv_perm": _tensor(np.argsort(perm), device),
        },
        meta=G,
    )


def pack_q2k(raw: np.ndarray, out_features: int, in_features: int,
             dtype=torch.bfloat16, device="cuda") -> Linear:
    """GGUF Q2_K wire blocks (84 B / 256 elements: 16 scale bytes, 64 code
    bytes, f16 d, f16 dmin) -> the gguf_q2k layout: q uint8 [in/4, out]
    quarter-plane-major (row r bits 2j hold element j*(in/4) + r), scale =
    d*sc4 and minv = dmin*mn4 [in/16, out]."""
    nblk = in_features // 256
    b = kquants._blocks(raw, 84).reshape(out_features * nblk, 84)
    N = b.shape[0]
    scales = b[:, 0:16]
    qs = b[:, 16:80].reshape(N, 2, 32)
    d = kquants._f16(b[:, 80:82].copy())
    dmin = kquants._f16(b[:, 82:84].copy())
    shifts = np.arange(4, dtype=np.uint8)
    q = ((qs[:, :, None, :] >> (2 * shifts)[None, None, :, None]) & 3).reshape(N, 256)
    sc = d * (scales & 0xF).astype(np.float32)  # [N, 16]
    mn = dmin * (scales >> 4).astype(np.float32)
    planes = q.reshape(out_features, in_features).T.reshape(4, in_features // 4, out_features)
    qp = planes[0] | (planes[1] << 2) | (planes[2] << 4) | (planes[3] << 6)
    return Linear(
        kind="gguf_q2k",
        shape=(in_features, out_features),
        data={
            "q": _tensor(qp, device),
            "scale": _tensor(sc.reshape(out_features, in_features // 16).T, device, dtype),
            "minv": _tensor(mn.reshape(out_features, in_features // 16).T, device, dtype),
        },
    )


def pack_q8_0(raw: np.ndarray, out_features: int, in_features: int,
              dtype=torch.bfloat16, device="cuda") -> Linear:
    nblk = in_features // 32
    b = kquants._blocks(raw, 34).reshape(out_features, nblk, 34)
    d = kquants._f16(b[:, :, 0:2].copy())[:, :, 0]  # [out, nblk]
    q = b[:, :, 2:34].view(np.int8).reshape(out_features, in_features)
    return Linear(
        kind="gguf_q8_0",
        shape=(in_features, out_features),
        data={"q": _tensor(q.T, device), "scale": _tensor(d.T, device, dtype)},
    )


PACKERS = {
    GGMLType.Q4_K: pack_q4k, GGMLType.Q5_K: pack_q5k, GGMLType.Q6_K: pack_q6k,
    GGMLType.Q8_0: pack_q8_0, GGMLType.Q4_0: pack_q4_0, GGMLType.Q4_1: pack_q4_1,
    GGMLType.Q5_0: pack_q5_0, GGMLType.Q5_1: pack_q5_1, GGMLType.Q3_K: pack_q3k,
    GGMLType.Q2_K: pack_q2k,
}
# `in` divisibility per packer (block structure + device pairing / planes)
_PACK_IN_MULTIPLE = {
    GGMLType.Q4_K: 256, GGMLType.Q5_K: 256, GGMLType.Q6_K: 256, GGMLType.Q3_K: 256,
    GGMLType.Q8_0: 32, GGMLType.Q4_0: 64, GGMLType.Q4_1: 64,
    GGMLType.Q5_0: 256, GGMLType.Q5_1: 256, GGMLType.Q2_K: 256,
}


def linear_from_gguf(raw: np.ndarray, gtype, shape: tuple[int, ...],
                     dtype=torch.bfloat16, device="cuda") -> Linear:
    """Build a Linear from a GGUF weight tensor (shape = (out, in) numpy
    order). Types without a packer here (Q8_K) raise."""
    out_f, in_f = shape
    gtype = GGMLType(int(gtype))
    if in_f % _PACK_IN_MULTIPLE[gtype]:
        raise ValueError(f"{gtype.name} needs in_features % {_PACK_IN_MULTIPLE[gtype]} == 0, "
                         f"got {in_f}")
    return PACKERS[gtype](raw, out_f, in_f, dtype, device)


# ------------------------------------------------------------- dequant


def dequant_q4k_weights(lin: Linear, dtype) -> torch.Tensor:
    """[out, in] dequantized (paired layout: byte row r = element r |
    element r + in/2 << 4); one kernel on the card (ops/quant_matmul.py)."""
    from mistralrs_tpu_torch.ops.quant_matmul import q4k_dequant

    return q4k_dequant(lin.data["qs"], lin.data["scale"], lin.data["minv"], dtype).T


def dequant_q5k_weights(lin: Linear, dtype) -> torch.Tensor:
    """[out, in]: paired nibbles + plane-major high bits; one kernel on the
    card (ops/quant_matmul.py)."""
    from mistralrs_tpu_torch.ops.quant_matmul import q5k_dequant

    return q5k_dequant(lin.data["qs"], lin.data["qh"], lin.data["scale"], lin.data["minv"],
                       dtype).T


def dequant_q6k_weights(lin: Linear, dtype) -> torch.Tensor:
    """[out, in] in element order, straight from the chunked layout; one
    kernel on the card (ops/quant_matmul.py)."""
    from mistralrs_tpu_torch.ops.quant_matmul import q6k_dequant

    return q6k_dequant(lin.data["ql"], lin.data["qh"], lin.data["scale"], lin.meta, dtype).T


def dequant_q8_0_gs_weights(lin: Linear, dtype) -> torch.Tensor:
    """[out, in] for the per-gs int8 layout (meta = gs; wire Q8_0 is 32);
    one kernel on the card (ops/quant_matmul.py)."""
    from mistralrs_tpu_torch.ops.quant_matmul import q8_0_dequant

    return q8_0_dequant(lin.data["q"], lin.data["scale"], lin.meta or 32, dtype).T


def dequant_q2k_weights(lin: Linear, dtype) -> torch.Tensor:
    """[out, in]: quarter-plane-major 2-bit codes, per-16 scale and min; one
    kernel on the card (ops/quant_matmul.py)."""
    from mistralrs_tpu_torch.ops.quant_matmul import affine_dequant

    return affine_dequant(lin.data["q"], lin.data["scale"], lin.data["minv"], 2, 16, dtype).T


def requant_q6k_to_q8(lin: Linear, gs: int = 64) -> Linear:
    """Load-time requant of a Q6_K Linear to the int8 per-gs layout served by
    the Q8_0 kernel ("rq8"): dequantize in element order, then round to int8
    with an absmax scale per gs rows. The added error, s_gs/2 with s_gs ~
    max|w|_gs/127, is about 4x below Q6_K's own step."""
    K, O = lin.shape
    w = dequant_q6k_weights(lin, torch.float32).T  # [in, out] f32
    wg = w.reshape(K // gs, gs, O)
    s = torch.clamp_min(wg.abs().amax(dim=1), 1e-12) / 127.0  # [K/gs, O]
    q = torch.clamp(torch.round(wg / s[:, None, :]), -127, 127).to(torch.int8)
    data = {"q": q.reshape(K, O), "scale": s.to(torch.float32)}
    if "b" in lin.data:
        data["b"] = lin.data["b"]
    return dataclasses.replace(lin, kind="gguf_q8_0", data=data, meta=gs)


DEQUANT_WEIGHTS = {
    "gguf_q4k": dequant_q4k_weights,
    "gguf_q5k": dequant_q5k_weights,
    "gguf_q6k": dequant_q6k_weights,
    "gguf_q8_0": dequant_q8_0_gs_weights,
    "gguf_q2k": dequant_q2k_weights,
}


# ------------------------------------------------------------- forwards


def _ref_forward(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    """Dequantize to x's dtype, then one torch.matmul: the prefill route
    (more than 256 rows), as the JAX package leaves it to XLA."""
    w = DEQUANT_WEIGHTS[lin.kind](lin, x.dtype)  # [out, in]
    y = torch.matmul(x, w.T)
    b = lin.data.get("b")
    if b is not None:
        y = y + b.to(y.dtype)
    return y


@register_kind("gguf_q4k")
def _q4k_forward(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    from mistralrs_tpu_torch.ops.quant_matmul import q4k_matmul

    return q4k_matmul(lin, x)


@register_kind("gguf_q5k")
def _q5k_forward(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    from mistralrs_tpu_torch.ops.quant_matmul import q5k_matmul

    return q5k_matmul(lin, x)


@register_kind("gguf_q6k")
def _q6k_forward(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    from mistralrs_tpu_torch.ops.quant_matmul import q6k_matmul

    return q6k_matmul(lin, x)


@register_kind("gguf_q8_0")
def _q8_0_forward(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    from mistralrs_tpu_torch.ops.quant_matmul import q8_0_matmul

    return q8_0_matmul(lin, x)


@register_kind("gguf_q2k")
def _q2k_forward(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    from mistralrs_tpu_torch.ops.quant_matmul import affine_qmatmul

    return affine_qmatmul(lin, x, bits=2, group=16, zs_key="minv")
