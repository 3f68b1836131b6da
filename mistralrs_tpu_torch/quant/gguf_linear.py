"""Quantized `Linear` device formats for GGUF weights (Q4_K, Q6_K, Q8_0).

Counterpart of mistralrs_tpu/quant/gguf_linear.py. The device layouts are
byte-for-byte those of the JAX package, so one numpy pack feeds both:
- "gguf_q4k":  qs uint8 [in/2, out] paired nibbles (byte row r holds element
  r in its low and element r + in/2 in its high nibble), scale and minv
  [in/32, out] (w = scale*q - minv);
- "gguf_q6k":  ql uint8 [in/2, out], qh uint8 [in/4, out], scale [in/16,
  out] in the chunked permuted order of `q6k_perm`, with perm/inv_perm;
- "gguf_q8_0": q int8 [in, out], scale [in/gs, out]; gs = meta or 32 (wire
  Q8_0 has 32 and a bf16 scale, the Q6_K requant "rq8" an f32 scale).

The forwards of gguf_q4k and gguf_q8_0 go to the int8 GEMV kernels of
ops/quant_matmul.py. gguf_q6k has no GEMV kernel in this port yet (the JAX
package's K3/K4): on the card it serves only the prefill route (more than
256 rows, dequantize + torch.matmul) and raises below that; on the CPU it
dequantizes at any row count. The serving path requantizes Q6_K to rq8 at
load (quant/fuse.requant_q6k_params), so it never reaches it.
"""

from __future__ import annotations

import numpy as np
import torch

from mistralrs_tpu_torch.quant import kquants
from mistralrs_tpu_torch.quant.kquants import GGMLType
from mistralrs_tpu_torch.quant.qlinear import Linear, register_kind


def _tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


# ----------------------------------------------------------------- packers


def pack_q4k(raw: np.ndarray, out_features: int, in_features: int,
             dtype=torch.bfloat16, device="cuda") -> Linear:
    """GGUF Q4_K wire blocks -> K-major paired-nibble layout. raw: uint8 of (out, in)."""
    nblk = in_features // 256
    b = kquants._blocks(raw, 144).reshape(out_features, nblk, 144)
    d = kquants._f16(b[:, :, 0:2].copy())  # [out, nblk, 1]
    dmin = kquants._f16(b[:, :, 2:4].copy())
    sc, mn = kquants._unpack_scales_k4(b[:, :, 4:16])  # [out, nblk, 8] uint8
    qs = b[:, :, 16:144]  # [out, nblk, 128]
    scale = d * sc.astype(np.float32)  # [out, nblk, 8]
    minv = dmin * mn.astype(np.float32)
    # wire order -> element-order nibble matrix V [in, out]
    qs4 = qs.reshape(out_features, nblk, 4, 32)
    v = np.empty((out_features, nblk, 4, 2, 32), np.uint8)
    v[..., 0, :] = qs4 & 0xF  # elements 256b + 64c + j
    v[..., 1, :] = qs4 >> 4  # elements 256b + 64c + 32 + j
    v = v.reshape(out_features, in_features).T  # [in, out]
    half = in_features // 2
    qs_t = v[:half] | (v[half:] << 4)
    scale_t = scale.transpose(1, 2, 0).reshape(nblk * 8, out_features)
    minv_t = minv.transpose(1, 2, 0).reshape(nblk * 8, out_features)
    return Linear(
        kind="gguf_q4k",
        shape=(in_features, out_features),
        data={
            "qs": _tensor(qs_t, device),
            "scale": _tensor(scale_t, device, dtype),
            "minv": _tensor(minv_t, device, dtype),
        },
    )


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


PACKERS = {GGMLType.Q4_K: pack_q4k, GGMLType.Q6_K: pack_q6k, GGMLType.Q8_0: pack_q8_0}
_PACK_IN_MULTIPLE = {GGMLType.Q4_K: 256, GGMLType.Q6_K: 256, GGMLType.Q8_0: 32}


def linear_from_gguf(raw: np.ndarray, gtype, shape: tuple[int, ...],
                     dtype=torch.bfloat16, device="cuda") -> Linear:
    """Build a Linear from a GGUF weight tensor (shape = (out, in) numpy
    order). Only Q4_K, Q6_K and Q8_0 are ported; other types raise."""
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


def dequant_q6k_weights(lin: Linear, dtype) -> torch.Tensor:
    """[out, in] in element order: inverts the chunked permuted layout."""
    ql = lin.data["ql"]  # [in/2, out] chunked
    qh = lin.data["qh"]  # [in/4, out]
    K2, out_f = ql.shape
    K = K2 * 2
    G = lin.meta
    C = K // (4 * G)
    qlc = ql.reshape(C, 2, G, out_f).to(torch.int32)
    h = qh.reshape(C, G, out_f).to(torch.int32)
    q0 = (qlc[:, 0] & 0xF) | ((h & 3) << 4)
    q1 = (qlc[:, 1] & 0xF) | (((h >> 2) & 3) << 4)
    q2 = (qlc[:, 0] >> 4) | (((h >> 4) & 3) << 4)
    q3 = (qlc[:, 1] >> 4) | ((h >> 6) << 4)
    q_perm = torch.stack([q0, q1, q2, q3], dim=1).reshape(K, out_f) - 32
    scale = torch.repeat_interleave(lin.data["scale"].to(dtype), 16, dim=0)  # permuted
    w_perm = q_perm.to(dtype) * scale
    w_elem = torch.index_select(w_perm, 0, lin.data["inv_perm"])  # [in, out]
    return w_elem.T


def dequant_q8_0_gs_weights(lin: Linear, dtype) -> torch.Tensor:
    """[out, in] for the per-gs int8 layout (meta = gs; wire Q8_0 is 32);
    one kernel on the card (ops/quant_matmul.py)."""
    from mistralrs_tpu_torch.ops.quant_matmul import q8_0_dequant

    return q8_0_dequant(lin.data["q"], lin.data["scale"], lin.meta or 32, dtype).T


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
    return Linear(kind="gguf_q8_0", shape=lin.shape, data=data, meta=gs)


DEQUANT_WEIGHTS = {
    "gguf_q4k": dequant_q4k_weights,
    "gguf_q6k": dequant_q6k_weights,
    "gguf_q8_0": dequant_q8_0_gs_weights,
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


@register_kind("gguf_q6k")
def _q6k_forward(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    from mistralrs_tpu_torch.ops.quant_matmul import MAX_KERNEL_ROWS

    if x.device.type == "cuda" and x.shape[:-1].numel() <= MAX_KERNEL_ROWS:
        raise NotImplementedError(
            "gguf_q6k GEMV (the JAX package's _q6k_q8_kernel) is not ported yet; "
            "requantize Q6_K to int8 at load (PipelineConfig.rq8_group)")
    return _ref_forward(lin, x)


@register_kind("gguf_q8_0")
def _q8_0_forward(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    from mistralrs_tpu_torch.ops.quant_matmul import q8_0_matmul

    return q8_0_matmul(lin, x)
