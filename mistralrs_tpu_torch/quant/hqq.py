"""HQQ, half-quadratic quantization (quantize-on-load, data-free), and the
forwards of its device formats.

Counterpart of mistralrs_tpu/quant/hqq.py: the same numpy proximal solver
(alternating lp-shrinkage of the weight residual and a closed-form
zero-point update) over `group_size` input dims, and the same layouts:
- 4-bit with in % 512 == 0 and group % 32 == 0 -> "gguf_q4k" (K1);
- otherwise "hqq_<bits>": q uint8 plane-major packed (bits 1, 2, 4; the
  layout of gptq._pack_bytes_rows) or one code a byte (bits 3, 8), scale
  [in/group, out], zs = scale*zero; w[k, o] = q*scale[g, o] - zs[g, o].
The forwards go to ops/quant_matmul.affine_qmatmul (K10 up to 256 rows,
affine_dequant + torch.matmul above).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mistralrs_tpu_torch.quant.gguf_linear import _tensor
from mistralrs_tpu_torch.quant.gptq import _pack_bytes_rows
from mistralrs_tpu_torch.quant.qlinear import Linear, register_kind


@dataclasses.dataclass(frozen=True)
class HqqType:
    """A quantization target: bits and group size."""

    bits: int
    group_size: int = 64

    def __post_init__(self):
        if self.bits not in (1, 2, 3, 4, 8):
            raise ValueError(f"HQQ bits {self.bits} not in (1, 2, 3, 4, 8)")


def _shrink_lp(x: np.ndarray, beta: float, lp: float) -> np.ndarray:
    """lp<1 soft-shrinkage operator (HQQ paper eq. 8)."""
    ax = np.abs(x)
    return np.sign(x) * np.maximum(ax - (1.0 / beta) * np.power(ax + 1e-8, lp - 1.0), 0.0)


def _device_bits(bits: int) -> int:
    """Width of the device codes: 3-bit codes are stored one a byte."""
    return 8 if bits in (3, 8) else bits


def quantize_hqq(
    w_out_in: np.ndarray,
    bits: int,
    group_size: int = 64,
    iters: int = 20,
    beta: float = 10.0,
    kappa: float = 1.01,
    lp: float = 0.7,
    dtype=torch.bfloat16,
    bias: np.ndarray | None = None,
    device="cuda",
) -> Linear:
    """Quantize a torch-layout (out, in) weight."""
    out_f, in_f = w_out_in.shape
    if in_f % group_size:
        raise ValueError(f"in_features {in_f} % group_size {group_size} != 0")
    maxq = (1 << bits) - 1
    w = w_out_in.T.astype(np.float32)  # [in, out]
    ng = in_f // group_size
    wg = w.reshape(ng, group_size, out_f)

    if bits == 1:
        # min/max init is poor at 1 bit; start at mean +/- mean-abs-dev
        m = wg.mean(axis=1, keepdims=True)
        a = np.abs(wg - m).mean(axis=1, keepdims=True)
        scale = np.maximum(2.0 * a, 1e-8)
        zero = 0.5 - m / scale
    else:
        wmin = wg.min(axis=1, keepdims=True)
        wmax = wg.max(axis=1, keepdims=True)
        scale = np.maximum((wmax - wmin) / maxq, 1e-8)  # [ng, 1, out]
        zero = -wmin / scale

    # half-quadratic proximal iterations on the zero-point
    b = beta
    for _ in range(iters):
        q = np.clip(np.round(wg / scale + zero), 0, maxq)
        we = _shrink_lp(wg - (q - zero) * scale, b, lp)
        zero = np.mean(q - (wg - we) / scale, axis=1, keepdims=True)
        b *= kappa

    q = np.clip(np.round(wg / scale + zero), 0, maxq).astype(np.uint8)
    q = q.reshape(in_f, out_f)
    s2 = scale[:, 0]  # [ng, out]
    zs = (scale * zero)[:, 0]

    if bits == 4 and in_f % 512 == 0 and group_size % 32 == 0:
        # the Q4_K device format (w = q*scale - minv): K1 serves it
        rep = group_size // 32
        half = in_f // 2
        kind = "gguf_q4k"
        data = {"qs": _tensor(q[:half] | (q[half:] << 4), device),
                "scale": _tensor(np.repeat(s2, rep, axis=0).astype(np.float32), device, dtype),
                "minv": _tensor(np.repeat(zs, rep, axis=0).astype(np.float32), device, dtype)}
    else:
        qdev = q if bits in (8, 3) else _pack_bytes_rows(q, bits)
        kind = f"hqq_{bits}"
        data = {"q": _tensor(qdev, device), "scale": _tensor(s2, device, dtype),
                "zs": _tensor(zs, device, dtype)}
    if bias is not None:
        data["b"] = _tensor(bias, device, dtype)
    return Linear(kind=kind, shape=(in_f, out_f), data=data)


def hqq_dequant_weights(lin: Linear, dtype, bits: int) -> torch.Tensor:
    """[in, out] dequantized (one kernel on the card, ops/quant_matmul.py)."""
    from mistralrs_tpu_torch.ops.quant_matmul import affine_dequant

    group = lin.shape[0] // lin.data["scale"].shape[0]
    return affine_dequant(lin.data["q"], lin.data["scale"], lin.data["zs"], _device_bits(bits),
                          group, dtype)


def _hqq_forward(bits: int):
    def fwd(lin: Linear, x: torch.Tensor) -> torch.Tensor:
        from mistralrs_tpu_torch.ops.quant_matmul import affine_qmatmul

        group = lin.shape[0] // lin.data["scale"].shape[0]
        return affine_qmatmul(lin, x, bits=_device_bits(bits), group=group)

    return fwd


for _bits in (1, 2, 3, 4, 8):
    register_kind(f"hqq_{_bits}")(_hqq_forward(_bits))
