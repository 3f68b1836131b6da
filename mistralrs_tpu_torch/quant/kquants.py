"""ggml/GGUF quant block formats: the pieces the packers need and the numpy
dequantizers.

Counterpart of mistralrs_tpu/quant/kquants.py (:24-263): `dequantize` turns
the raw bytes of a whole tensor of type F32, F16, BF16, Q4_0, Q4_1, Q5_0,
Q5_1, Q8_0 or Q2_K to Q6_K into float32 (gguf/reader.GGUFFile.tensor_f32
reads norms and embeddings with it), with the same numpy operations as the
JAX package, so the two give equal arrays. The wire-format quantizers stay
in the JAX package; the tests use them to make inputs. `GGMLType` is the
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
