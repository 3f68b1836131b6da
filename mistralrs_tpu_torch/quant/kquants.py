"""The parts of the ggml/GGUF block formats that the packers need.

Counterpart of mistralrs_tpu/quant/kquants.py (:24-104). The wire-format
quantizers and dequantizers stay in the JAX package; the tests use them to
make inputs.
"""

from __future__ import annotations

import enum

import numpy as np


class GGMLType(enum.IntEnum):
    """The GGUF tensor types this port packs (values as in the GGUF spec)."""

    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14


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
