"""ggml/GGUF quant block formats: the numpy dequantizers and quantizers.

Counterpart of mistralrs_tpu/quant/kquants.py: `dequantize` turns the raw
bytes of a whole tensor of type F32, F16, BF16, Q4_0, Q4_1, Q5_0, Q5_1,
Q8_0 or Q2_K to Q6_K into float32 (gguf/reader.GGUFFile.tensor_f32 reads
norms and embeddings with it); `quantize` turns a float array into the wire
blocks of Q8_0, Q4_0, Q4_1, Q5_0, Q5_1 or Q2_K to Q6_K (in-situ
quantization, quant/isq.py, and the runtime re-quantization of
pipeline/text.py). Both are the JAX package's numpy operations, so the two
packages give equal arrays and bit-equal wire bytes. `GGMLType` is the
reader's enum (gguf/reader.py).
"""

from __future__ import annotations

import numpy as np

from mistralrs_tpu_torch.gguf.reader import GGMLType

QK_K = 256


def _f16(u16: np.ndarray) -> np.ndarray:
    return u16.view(np.float16).astype(np.float32)


def _blocks(raw: np.ndarray, block_bytes: int) -> np.ndarray:
    if raw.size % block_bytes:
        raise ValueError(f"{raw.size} bytes is not a whole number of {block_bytes}-byte blocks")
    return raw.reshape(-1, block_bytes)


def _unpack_scales_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Q4_K/Q5_K 12-byte scales -> (sc [N,8], m [N,8]) 6-bit (ggml get_scale_min_k4)."""
    q = scales.astype(np.uint8)
    sc = np.empty(q.shape[:-1] + (8,), np.uint8)
    mn = np.empty_like(sc)
    sc[..., :4] = q[..., 0:4] & 63
    mn[..., :4] = q[..., 4:8] & 63
    sc[..., 4:] = (q[..., 8:12] & 0xF) | ((q[..., 0:4] >> 6) << 4)
    mn[..., 4:] = (q[..., 8:12] >> 4) | ((q[..., 4:8] >> 6) << 4)
    return sc, mn


# ---------------------------------------------------------------- dequantizers
# (the JAX package's operations; each takes the raw uint8 buffer of a whole
# tensor and returns float32 blocks)


def _dequant_q4_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 18)
    d = _f16(b[:, 0:2].copy().view(np.uint16))  # [N,1]
    qs = b[:, 2:18]
    lo = (qs & 0xF).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)  # [N,32]
    return q * d


def _dequant_q4_1(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 20)
    d = _f16(b[:, 0:2].copy().view(np.uint16))
    m = _f16(b[:, 2:4].copy().view(np.uint16))
    qs = b[:, 4:20]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.float32)
    return q * d + m


def _dequant_q5_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 22)
    d = _f16(b[:, 0:2].copy().view(np.uint16))
    qh = b[:, 2:6].copy().view(np.uint32)  # [N,1]
    qs = b[:, 6:22]
    bits = (qh >> np.arange(32, dtype=np.uint32)[None]) & 1  # [N,32]
    lo = (qs & 0xF).astype(np.int32)
    hi = (qs >> 4).astype(np.int32)
    q = np.concatenate([lo, hi], axis=1) | (bits.astype(np.int32) << 4)
    return (q - 16).astype(np.float32) * d


def _dequant_q5_1(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 24)
    d = _f16(b[:, 0:2].copy().view(np.uint16))
    m = _f16(b[:, 2:4].copy().view(np.uint16))
    qh = b[:, 4:8].copy().view(np.uint32)
    qs = b[:, 8:24]
    bits = (qh >> np.arange(32, dtype=np.uint32)[None]) & 1
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.int32) | (
        bits.astype(np.int32) << 4)
    return q.astype(np.float32) * d + m


def _dequant_q8_0(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 34)
    d = _f16(b[:, 0:2].copy().view(np.uint16))
    q = b[:, 2:34].view(np.int8).astype(np.float32)
    return q * d


def _dequant_q4_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 144)
    d = _f16(b[:, 0:2].copy().view(np.uint16))  # [N,1]
    dmin = _f16(b[:, 2:4].copy().view(np.uint16))
    sc, mn = _unpack_scales_k4(b[:, 4:16])  # [N,8]
    N = b.shape[0]
    # 4 chunks of 32 bytes; each chunk -> (low nibbles: 32 elems, high: 32 elems)
    qs = b[:, 16:144].reshape(N, 4, 32)
    lo = (qs & 0xF).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    q = np.stack([lo, hi], axis=2)  # [N,4,2,32]: sub-block index = chunk*2 + half
    dl = (d * sc.astype(np.float32)).reshape(N, 4, 2, 1)
    ml = (dmin * mn.astype(np.float32)).reshape(N, 4, 2, 1)
    return (q * dl - ml).reshape(N, QK_K)


def _dequant_q5_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 176)
    d = _f16(b[:, 0:2].copy().view(np.uint16))
    dmin = _f16(b[:, 2:4].copy().view(np.uint16))
    sc, mn = _unpack_scales_k4(b[:, 4:16])
    qh = b[:, 16:48]  # [N,32]
    qs = b[:, 48:176].reshape(-1, 4, 32)
    N = b.shape[0]
    lo = (qs & 0xF).astype(np.int32)
    hi = (qs >> 4).astype(np.int32)
    q = np.stack([lo, hi], axis=2)  # [N,4,2,32]
    # high bit j for sub-block s comes from qh bit (2*chunk + half)
    shifts = np.arange(8, dtype=np.uint8).reshape(4, 2)
    hbits = ((qh[:, None, None, :] >> shifts[None, :, :, None]) & 1).astype(np.int32)
    q = q + 16 * hbits
    dl = (d * sc.astype(np.float32)).reshape(N, 4, 2, 1)
    ml = (dmin * mn.astype(np.float32)).reshape(N, 4, 2, 1)
    return (q.astype(np.float32) * dl - ml).reshape(N, QK_K)


def _dequant_q6_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 210)
    N = b.shape[0]
    ql = b[:, 0:128].reshape(N, 2, 64)  # two 128-element halves
    qh = b[:, 128:192].reshape(N, 2, 32)
    scales = b[:, 192:208].view(np.int8).astype(np.float32)  # [N,16]
    d = _f16(b[:, 208:210].copy().view(np.uint16))  # [N,1]
    out = np.empty((N, 2, 128), np.float32)
    sc = scales.reshape(N, 2, 8)
    for half in range(2):
        l_ql = ql[:, half]  # [N,64]
        l_qh = qh[:, half]  # [N,32]
        q1 = (l_ql[:, 0:32] & 0xF).astype(np.int32) | (((l_qh >> 0) & 3).astype(np.int32) << 4)
        q2 = (l_ql[:, 32:64] & 0xF).astype(np.int32) | (((l_qh >> 2) & 3).astype(np.int32) << 4)
        q3 = (l_ql[:, 0:32] >> 4).astype(np.int32) | (((l_qh >> 4) & 3).astype(np.int32) << 4)
        q4 = (l_ql[:, 32:64] >> 4).astype(np.int32) | (((l_qh >> 6) & 3).astype(np.int32) << 4)
        qq = np.stack([q1, q2, q3, q4], axis=1) - 32  # [N,4,32]
        # each 32-element chunk j takes scales 2j (first 16) and 2j+1
        s = sc[:, half].reshape(N, 4, 2, 1) * np.ones((1, 1, 1, 16), np.float32)
        s = s.reshape(N, 4, 32)
        out[:, half] = (qq.astype(np.float32) * s).reshape(N, 128)
    return (out.reshape(N, QK_K)) * d


def _dequant_q2_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 84)
    N = b.shape[0]
    scales = b[:, 0:16]  # [N,16] per 16-elem sub-block: low4 scale, high4 min
    qs = b[:, 16:80].reshape(N, 2, 32)  # two 128-halves of 32 bytes
    d = _f16(b[:, 80:82].copy().view(np.uint16))
    dmin = _f16(b[:, 82:84].copy().view(np.uint16))
    shifts = np.arange(4, dtype=np.uint8)
    q = (qs[:, :, None, :] >> (2 * shifts)[None, None, :, None]) & 3  # [N,2,4,32]
    q = q.reshape(N, 16, 16)  # 16 sub-blocks of 16 (order matches scales index)
    sc = (scales & 0xF).astype(np.float32)
    mn = (scales >> 4).astype(np.float32)
    out = d[:, :, None] * sc[:, :, None] * q.astype(np.float32) - dmin[:, :, None] * mn[:, :, None]
    return out.reshape(N, QK_K)


def _dequant_q3_k(raw: np.ndarray) -> np.ndarray:
    b = _blocks(raw, 110)
    N = b.shape[0]
    hmask = b[:, 0:32]
    qs = b[:, 32:96].reshape(N, 2, 32)
    packed = b[:, 96:108]
    d = _f16(b[:, 108:110].copy().view(np.uint16))
    # 16 6-bit signed scales from 12 bytes (ggml's kmask layout)
    lo4 = packed[:, 0:8] & 0xF  # scales 0..7 low 4 bits
    hi4 = packed[:, 0:8] >> 4  # scales 8..15 low 4 bits
    hi2 = packed[:, 8:12]  # 2-bit highs, 4 per byte
    high = np.empty((N, 16), np.uint8)
    for j in range(4):
        high[:, 4 * j : 4 * j + 4] = (hi2 >> (2 * j)) & 3
    sc = np.empty((N, 16), np.int32)
    sc[:, 0:8] = lo4.astype(np.int32) | (high[:, 0:8].astype(np.int32) << 4)
    sc[:, 8:16] = hi4.astype(np.int32) | (high[:, 8:16].astype(np.int32) << 4)
    sc = sc - 32
    shifts = np.arange(4, dtype=np.uint8)
    q = (qs[:, :, None, :] >> (2 * shifts)[None, None, :, None]) & 3  # [N,2,4,32]
    q = q.reshape(N, 16, 16).astype(np.int32)
    mbits = np.empty((N, 16, 16), np.int32)
    for half in range(2):
        for j in range(4):
            m = 1 << (half * 4 + j)
            chunk = (hmask.astype(np.int32) & m) != 0  # [N,32]
            mbits[:, half * 8 + 2 * j] = chunk[:, 0:16]
            mbits[:, half * 8 + 2 * j + 1] = chunk[:, 16:32]
    q = q - np.where(mbits, 0, 4)
    out = d[:, :, None] * sc.astype(np.float32)[:, :, None] * q.astype(np.float32)
    return out.reshape(N, QK_K)


def _dequant_f(raw: np.ndarray, dtype) -> np.ndarray:
    return raw.view(dtype).astype(np.float32)


def _dequant_bf16(raw: np.ndarray) -> np.ndarray:
    u = raw.view(np.uint16).astype(np.uint32) << 16
    return u.view(np.float32)


_DEQUANT = {
    GGMLType.F32: lambda r: _dequant_f(r, np.float32),
    GGMLType.F16: lambda r: _dequant_f(r, np.float16),
    GGMLType.BF16: _dequant_bf16,
    GGMLType.Q4_0: _dequant_q4_0,
    GGMLType.Q4_1: _dequant_q4_1,
    GGMLType.Q5_0: _dequant_q5_0,
    GGMLType.Q5_1: _dequant_q5_1,
    GGMLType.Q8_0: _dequant_q8_0,
    GGMLType.Q2_K: _dequant_q2_k,
    GGMLType.Q3_K: _dequant_q3_k,
    GGMLType.Q4_K: _dequant_q4_k,
    GGMLType.Q5_K: _dequant_q5_k,
    GGMLType.Q6_K: _dequant_q6_k,
}


def dequantize(raw: np.ndarray, gtype, shape: tuple[int, ...]) -> np.ndarray:
    """The raw bytes of a whole tensor of type `gtype` -> float32 `shape`."""
    gtype = GGMLType(int(gtype))
    if gtype not in _DEQUANT:
        raise ValueError(f"no dequantizer for GGML type {gtype.name}")
    out = _DEQUANT[gtype](np.ascontiguousarray(raw))
    return out.reshape(shape).astype(np.float32)


# ---------------------------------------------------------------- quantizers
# (ISQ path; ggml-compatible layouts, nearest-rounding scale heuristics)


def _best_scale(x: np.ndarray, nmax: int, rmin: int) -> np.ndarray:
    """Per-row symmetric scale d so round(x/d) in [rmin, nmax] minimizes |err|.

    ggml's make_qx_quants does a small search around max/|nmax|; we use the
    same anchor (sign-aware max) which is what it returns for most rows.
    """
    amax_idx = np.argmax(np.abs(x), axis=-1, keepdims=True)
    maxv = np.take_along_axis(x, amax_idx, axis=-1)
    d = np.where(np.abs(maxv) > 0, maxv / rmin, 1.0)
    return d


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    amax = np.abs(x).max(axis=-1, keepdims=True)
    d = amax / 127.0
    d_safe = np.where(d > 0, d, 1.0)
    q = np.clip(np.round(x / d_safe), -128, 127).astype(np.int8)
    out = np.empty((x.shape[0], 34), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    d = _best_scale(x, 7, -8)
    d_safe = np.where(np.abs(d) > 0, d, 1.0)
    q = np.clip(np.round(x / d_safe) + 8, 0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 18), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def _minmax_subblock(x: np.ndarray, nmax: int) -> tuple[np.ndarray, np.ndarray]:
    """Asymmetric (scale, min) per sub-block: q = round((x+m)/d), w = d*q - m."""
    mn = np.minimum(x.min(axis=-1), 0.0)
    mx = np.maximum(x.max(axis=-1), 0.0)
    d = (mx - mn) / nmax
    return d, -mn


def quantize_q4_k(x: np.ndarray) -> np.ndarray:
    """x -> Q4_K blocks (144B per 256 elems)."""
    x = x.reshape(-1, 8, 32).astype(np.float32)  # [N, sub, 32]
    N = x.shape[0]
    d_sub, m_sub = _minmax_subblock(x, 15)  # [N,8]
    dmax = d_sub.max(axis=-1)
    mmax = m_sub.max(axis=-1)
    d = dmax / 63.0
    dmin = mmax / 63.0
    inv_d = np.where(d > 0, 1.0 / d, 0.0)
    inv_m = np.where(dmin > 0, 1.0 / dmin, 0.0)
    sc = np.clip(np.round(d_sub * inv_d[:, None]), 0, 63).astype(np.uint8)
    mn = np.clip(np.round(m_sub * inv_m[:, None]), 0, 63).astype(np.uint8)
    d_eff = d[:, None] * sc  # [N,8]
    m_eff = dmin[:, None] * mn
    inv_deff = np.where(d_eff > 0, 1.0 / d_eff, 0.0)
    q = np.clip(np.round((x + m_eff[:, :, None]) * inv_deff[:, :, None]), 0, 15).astype(np.uint8)
    out = np.empty((N, 144), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.astype(np.float16).view(np.uint8).reshape(-1, 2)
    scales = np.zeros((N, 12), np.uint8)
    scales[:, 0:4] = (sc[:, :4] & 63) | ((sc[:, 4:] >> 4) << 6)
    scales[:, 4:8] = (mn[:, :4] & 63) | ((mn[:, 4:] >> 4) << 6)
    scales[:, 8:12] = (sc[:, 4:] & 0xF) | ((mn[:, 4:] & 0xF) << 4)
    out[:, 4:16] = scales
    qr = q.reshape(N, 4, 2, 32)
    out[:, 16:144] = (qr[:, :, 0] | (qr[:, :, 1] << 4)).reshape(N, 128)
    return out.reshape(-1)


def quantize_q6_k(x: np.ndarray) -> np.ndarray:
    """x -> Q6_K blocks (210B per 256 elems)."""
    x = x.reshape(-1, 16, 16).astype(np.float32)  # 16 sub-blocks of 16
    N = x.shape[0]
    d_sub = _best_scale(x, 31, -32)[..., 0]  # [N,16]
    dmax = d_sub[np.arange(N), np.argmax(np.abs(d_sub), axis=-1)]
    d = dmax / 127.0
    inv_d = np.where(np.abs(d) > 0, 1.0 / d, 0.0)
    sc = np.clip(np.round(d_sub * inv_d[:, None]), -128, 127).astype(np.int8)
    d_eff = d[:, None] * sc.astype(np.float32)  # [N,16]
    inv_deff = np.where(np.abs(d_eff) > 0, 1.0 / d_eff, 0.0)
    q = np.clip(np.round(x * inv_deff[:, :, None]) + 32, 0, 63).astype(np.uint8)
    q = q.reshape(N, 2, 128)  # two halves
    out = np.empty((N, 210), np.uint8)
    for half in range(2):
        qh_half = q[:, half]  # [N,128] values 0..63, layout: l, l+32, l+64, l+96
        ql = np.empty((N, 64), np.uint8)
        qh = np.empty((N, 32), np.uint8)
        q1, q2, q3, q4 = (qh_half[:, 32 * i : 32 * (i + 1)] for i in range(4))
        ql[:, 0:32] = (q1 & 0xF) | ((q3 & 0xF) << 4)
        ql[:, 32:64] = (q2 & 0xF) | ((q4 & 0xF) << 4)
        qh[:, :] = (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)
        out[:, 64 * half : 64 * (half + 1)] = ql
        out[:, 128 + 32 * half : 128 + 32 * (half + 1)] = qh
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    d, m = _minmax_subblock(x, 15)
    d_safe = np.where(d > 0, d, 1.0)
    q = np.clip(np.round((x + m[:, None]) / d_safe[:, None]), 0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 20), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = (-m).astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 4:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    d = _best_scale(x, 15, -16)
    d_safe = np.where(np.abs(d) > 0, d, 1.0)
    q = np.clip(np.round(x / d_safe) + 16, 0, 31).astype(np.uint8)  # [N,32]
    out = np.empty((x.shape[0], 22), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    hb = (q >> 4).astype(np.uint32)  # bit j of qh = high bit of elem j
    qh = (hb << np.arange(32, dtype=np.uint32)[None]).sum(axis=1, dtype=np.uint32)
    out[:, 2:6] = qh[:, None].view(np.uint8)
    out[:, 6:] = (q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)
    return out.reshape(-1)


def quantize_q5_1(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    d, m = _minmax_subblock(x, 31)
    d_safe = np.where(d > 0, d, 1.0)
    q = np.clip(np.round((x + m[:, None]) / d_safe[:, None]), 0, 31).astype(np.uint8)
    out = np.empty((x.shape[0], 24), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = (-m).astype(np.float16).view(np.uint8).reshape(-1, 2)
    hb = (q >> 4).astype(np.uint32)
    qh = (hb << np.arange(32, dtype=np.uint32)[None]).sum(axis=1, dtype=np.uint32)
    out[:, 4:8] = qh[:, None].view(np.uint8)
    out[:, 8:] = (q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)
    return out.reshape(-1)


def quantize_q5_k(x: np.ndarray) -> np.ndarray:
    """x -> Q5_K blocks (176B per 256 elems): Q4_K scheme with 5-bit q."""
    x = x.reshape(-1, 8, 32).astype(np.float32)
    N = x.shape[0]
    d_sub, m_sub = _minmax_subblock(x, 31)
    d = d_sub.max(axis=-1) / 63.0
    dmin = m_sub.max(axis=-1) / 63.0
    inv_d = np.where(d > 0, 1.0 / d, 0.0)
    inv_m = np.where(dmin > 0, 1.0 / dmin, 0.0)
    sc = np.clip(np.round(d_sub * inv_d[:, None]), 0, 63).astype(np.uint8)
    mn = np.clip(np.round(m_sub * inv_m[:, None]), 0, 63).astype(np.uint8)
    d_eff = d[:, None] * sc
    m_eff = dmin[:, None] * mn
    inv_deff = np.where(d_eff > 0, 1.0 / d_eff, 0.0)
    q = np.clip(np.round((x + m_eff[:, :, None]) * inv_deff[:, :, None]), 0, 31).astype(np.uint8)
    out = np.empty((N, 176), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.astype(np.float16).view(np.uint8).reshape(-1, 2)
    scales = np.zeros((N, 12), np.uint8)
    scales[:, 0:4] = (sc[:, :4] & 63) | ((sc[:, 4:] >> 4) << 6)
    scales[:, 4:8] = (mn[:, :4] & 63) | ((mn[:, 4:] >> 4) << 6)
    scales[:, 8:12] = (sc[:, 4:] & 0xF) | ((mn[:, 4:] & 0xF) << 4)
    out[:, 4:16] = scales
    qsub = q.reshape(N, 4, 2, 32)  # sub-block = chunk*2 + half
    out[:, 48:176] = ((qsub[:, :, 0] & 0xF) | ((qsub[:, :, 1] & 0xF) << 4)).reshape(N, 128)
    # high bit of sub-block (chunk, half) lives at qh bit 2*chunk + half
    qh = np.zeros((N, 32), np.uint8)
    for chunk in range(4):
        for half in range(2):
            qh |= (qsub[:, chunk, half] >> 4).astype(np.uint8) << (2 * chunk + half)
    out[:, 16:48] = qh
    return out.reshape(-1)


def quantize_q2_k(x: np.ndarray) -> np.ndarray:
    """x -> Q2_K blocks (84B per 256 elems): 16 sub-blocks of 16, 4-bit
    scale/min pairs."""
    x = x.reshape(-1, 16, 16).astype(np.float32)
    N = x.shape[0]
    d_sub, m_sub = _minmax_subblock(x, 3)
    d = d_sub.max(axis=-1) / 15.0
    dmin = m_sub.max(axis=-1) / 15.0
    inv_d = np.where(d > 0, 1.0 / d, 0.0)
    inv_m = np.where(dmin > 0, 1.0 / dmin, 0.0)
    sc = np.clip(np.round(d_sub * inv_d[:, None]), 0, 15).astype(np.uint8)
    mn = np.clip(np.round(m_sub * inv_m[:, None]), 0, 15).astype(np.uint8)
    d_eff = d[:, None] * sc
    m_eff = dmin[:, None] * mn
    inv_deff = np.where(d_eff > 0, 1.0 / d_eff, 0.0)
    q = np.clip(np.round((x + m_eff[:, :, None]) * inv_deff[:, :, None]), 0, 3).astype(np.uint8)
    out = np.empty((N, 84), np.uint8)
    out[:, 0:16] = sc | (mn << 4)
    # inverse of dequant: q[N,16,16] -> [N,2,4,32] shift-major halves
    qq = q.reshape(N, 2, 4, 2, 16)  # [N, half, shift, pair, 16]
    qs = np.zeros((N, 2, 32), np.uint8)
    for shift in range(4):
        qs |= (qq[:, :, shift].reshape(N, 2, 32)) << (2 * shift)
    out[:, 16:80] = qs.reshape(N, 64)
    out[:, 80:82] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 82:84] = dmin.astype(np.float16).view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


def quantize_q3_k(x: np.ndarray) -> np.ndarray:
    """x -> Q3_K blocks (110B per 256 elems): 16 sub-blocks of 16, 6-bit
    signed scales, 3-bit values split into 2-bit qs + hmask."""
    x = x.reshape(-1, 16, 16).astype(np.float32)
    N = x.shape[0]
    d_sub = _best_scale(x, 3, -4)[..., 0]  # [N,16]
    dmax = d_sub[np.arange(N), np.argmax(np.abs(d_sub), axis=-1)]
    d = dmax / 31.0
    inv_d = np.where(np.abs(d) > 0, 1.0 / d, 0.0)
    sc6 = np.clip(np.round(d_sub * inv_d[:, None]), -32, 31).astype(np.int32)
    d_eff = d[:, None] * sc6.astype(np.float32)
    inv_deff = np.where(np.abs(d_eff) > 0, 1.0 / d_eff, 0.0)
    q = np.clip(np.round(x * inv_deff[:, :, None]), -4, 3).astype(np.int32) + 4  # 0..7
    out = np.zeros((N, 110), np.uint8)
    # scales: 16 x 6-bit (sc6+32) packed as in the dequant
    u = (sc6 + 32).astype(np.uint8)
    out[:, 96:104] = (u[:, 0:8] & 0xF) | ((u[:, 8:16] & 0xF) << 4)
    high = np.concatenate([u[:, 0:8] >> 4, u[:, 8:16] >> 4], axis=1)  # [N,16] 2-bit
    # dequant reads high[4j + b] from byte b at shift 2j: byte b packs
    # scales {b, b+4, b+8, b+12}
    for b in range(4):
        out[:, 104 + b] = (high[:, b] | (high[:, 4 + b] << 2)
                           | (high[:, 8 + b] << 4) | (high[:, 12 + b] << 6))
    # values: low 2 bits -> qs (shift-major), high bit -> hmask
    low = (q & 3).astype(np.uint8).reshape(N, 2, 4, 2, 16)
    qs = np.zeros((N, 2, 32), np.uint8)
    for shift in range(4):
        qs |= low[:, :, shift].reshape(N, 2, 32) << (2 * shift)
    out[:, 32:96] = qs.reshape(N, 64)
    hbit = (q >> 2).astype(np.uint8).reshape(N, 2, 4, 2, 16)  # 1 = +0, 0 = -4
    hmask = np.zeros((N, 32), np.uint8)
    for half in range(2):
        for j in range(4):
            m = np.uint8(1 << (half * 4 + j))
            hmask[:, 0:16] |= hbit[:, half, j, 0] * m
            hmask[:, 16:32] |= hbit[:, half, j, 1] * m
    out[:, 0:32] = hmask
    out[:, 108:110] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


QUANTIZERS = {
    GGMLType.Q8_0: quantize_q8_0,
    GGMLType.Q4_0: quantize_q4_0,
    GGMLType.Q4_1: quantize_q4_1,
    GGMLType.Q5_0: quantize_q5_0,
    GGMLType.Q5_1: quantize_q5_1,
    GGMLType.Q2_K: quantize_q2_k,
    GGMLType.Q3_K: quantize_q3_k,
    GGMLType.Q4_K: quantize_q4_k,
    GGMLType.Q5_K: quantize_q5_k,
    GGMLType.Q6_K: quantize_q6_k,
}


def quantize(x: np.ndarray, gtype) -> np.ndarray:
    """Quantize a float array into raw ggml blocks (row-major over last axis)."""
    gtype = GGMLType(int(gtype))
    if gtype not in QUANTIZERS:
        raise NotImplementedError(f"no quantizer for {gtype.name}")
    return QUANTIZERS[gtype](np.ascontiguousarray(x, np.float32))
