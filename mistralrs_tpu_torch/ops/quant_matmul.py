"""Packed-weight GEMVs for GGUF layouts: int8 activations x Q4_K / int8 weights.

Counterpart of mistralrs_tpu/ops/quant_matmul.py, for the two kernels the
serving path of a Q4_K_M model runs: K1 `q4k_q8_gemv` (replaces
`_q4k_q8_kernel`) and K2 `q8_0_q8_gemv` (replaces `_q8_0_q8_kernel`), both
hand-written CUDA under csrc/.

Activations are quantized per block to int8 (ggml's Q8 approach, as the JAX
int8 path does): xs = max(max|x_block|, 1e-10)/127, xq = clip(round(x/xs),
-127, 127), so |err| <= max|x_block|/254 per element; round is half to
even, as jnp.round. The kernels take x itself: the C entry point of each
runs a quantize kernel, the GEMV and a split-K pass (one host call instead
of a dozen torch ops per projection). Their plain versions quantize with
the same f32 operations in torch, so the int8 codes agree bit for bit; the
scale is max|x|*(1/127) in both, where JAX divides by 127 (at most one f32
ulp apart). The activation scales and block sums are [B, K/gs] here (JAX
keeps them transposed for TPU sublane alignment).

Routing rule of this port (the dispatchers below):
- more than 256 rows (prefill chunks) -> dequantize + torch.matmul
  (gguf_linear._ref_forward), as the JAX package leaves prefill to XLA; on
  the card the dequantization is one kernel per format (`q4k_dequant`,
  `q8_0_dequant`, the pass XLA fuses in the JAX package);
- otherwise the kernel, when its shape rule holds (Q4_K: in % 64 == 0;
  int8: gs in {32, 64}; both: out % 16 == 0, for 16-byte column chunks),
  else the dequant route.
The Mosaic-only rules of the JAX package (in % 512, block_k >= 512, row
padding to 8) do not apply to the CUDA kernels and are gone.

Each kernel wrapper takes its plain PyTorch version when (and only when) its
tensors lie on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from mistralrs_tpu_torch.ops import kernels
from mistralrs_tpu_torch.quant.qlinear import Linear

MAX_KERNEL_ROWS = 256

# launches of each kernel (one per wrapper call that launched it)
q4k_q8_gemv_launches = 0
q8_0_q8_gemv_launches = 0
q4k_dequant_launches = 0
q8_0_dequant_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


# ------------------------------------------------------- activation quant


# 1/127 rounded to f32 once, so torch (any device) and the CUDA kernels
# multiply by the same number
_INV127 = float(np.float32(1.0) / np.float32(127.0))


def _quantize_acts_q8_gs(x2d: torch.Tensor, gs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, K] -> (xq int8 [B, K], xs f32 [B, K/gs])."""
    B, K = x2d.shape
    xf = x2d.to(torch.float32).reshape(B, K // gs, gs)
    xs = torch.clamp_min(xf.abs().amax(dim=2), 1e-10) * _INV127
    xq = torch.clamp(torch.round(xf / xs[..., None]), -127, 127)
    return xq.to(torch.int8).reshape(B, K), xs


def _quantize_acts_q8(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-32-block activation quantization (the Q4_K path's)."""
    return _quantize_acts_q8_gs(x2d, 32)


def _xsum32(x2d: torch.Tensor) -> torch.Tensor:
    """Per-32-block sums of the original x [B, K] -> [B, K/32] f32."""
    B, K = x2d.shape
    return x2d.to(torch.float32).reshape(B, K // 32, 32).sum(dim=2)


# ------------------------------------------------------- shared checks


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_tensor(name: str, t: torch.Tensor, dtype, shape: tuple) -> None:
    _require(t.dtype == dtype, f"{name}: dtype {t.dtype}, expected {dtype}")
    _require(tuple(t.shape) == tuple(shape), f"{name}: shape {tuple(t.shape)}, expected {shape}")


def _check_cuda(name: str, tensors: dict[str, torch.Tensor]) -> torch.device:
    devs = {t.device for t in tensors.values()}
    _require(len(devs) == 1, f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    _require(dev.type == "cuda", f"{name}: tensors on {dev}; the kernel runs on cuda "
                                 "(the plain version serves cpu tensors)")
    for k, t in tensors.items():
        _require(t.is_contiguous(), f"{name}: {k} is not contiguous")
        _require(t.data_ptr() % 16 == 0, f"{name}: {k} is not 16-byte aligned")
    return dev


_SMS: dict[int, int] = {}


def _ksplit(O: int, B: int, k_units: int, device) -> int:
    """Split of the K axis over blocks (a block owns 128 columns x 16 rows):
    about 4 blocks per SM, each split keeping at least 4 K steps (K1: pairs
    of sub-blocks, K2: scale groups) for its copy pipeline."""
    tiles = -(-O // 128) * -(-B // 16)
    idx = device.index if device.index is not None else torch.cuda.current_device()
    sms = _SMS.get(idx)
    if sms is None:
        sms = _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return max(1, min(-(-4 * sms // tiles), k_units // 4))


def _align256(n: int) -> int:
    return (n + 255) & ~255


def _workspace_bytes(B: int, K: int, O: int, gs: int, with_xsum: bool, ksplit: int) -> int:
    """Scratch of one GEMV call: xq [B, K], xs [K/gs, Bpad], (xsum [K/32,
    Bpad]), split-K partials [ksplit, B, O], each 256-byte aligned, in the
    order csrc/common.cuh::carve lays them out (Bpad = B rounded up to 16)."""
    bpad = -(-B // 16) * 16
    return (_align256(B * K) + _align256((K // gs) * bpad * 4)
            + (_align256((K // 32) * bpad * 4) if with_xsum else 0)
            + _align256(ksplit * B * O * 4))


def _check_x(name: str, x: torch.Tensor, K: int) -> int:
    _require(x.dim() == 2 and x.shape[1] == K, f"{name}: x {tuple(x.shape)} is not [B, {K}]")
    _require(x.shape[0] >= 1, f"{name}: no rows")
    return x.shape[0]


# ------------------------------------------------------- K1: Q4_K x int8


def q4k_q8_gemv_plain(x, qs, scale, minv, out_dtype=torch.float32):
    """Plain PyTorch version of K1 on any device: the same activation
    quantization, then per-sub-block dots that are integers below 2^24
    (|sum| <= 32*127*15), so the f32 batched products hold them exactly, as
    the kernel's int32 dots do."""
    B, K = x.shape
    O = qs.shape[1]
    nsub = K // 32
    xq, xs = _quantize_acts_q8(x)
    xsum = _xsum32(x)
    q = torch.cat([qs & 0xF, qs >> 4], dim=0)  # [K, O] element order
    acc = torch.zeros(B, O, dtype=torch.float32, device=x.device)
    step = max(1, min(2**26 // (B * O), 2**24 // (32 * O)))  # bounded temporaries
    for s0 in range(0, nsub, step):
        s1 = min(nsub, s0 + step)
        n = s1 - s0
        xb = xq[:, 32 * s0 : 32 * s1].to(torch.float32).reshape(B, n, 32).transpose(0, 1)
        wb = q[32 * s0 : 32 * s1].to(torch.float32).reshape(n, 32, O)
        dots = torch.bmm(xb, wb)  # [n, B, O]
        acc += (dots * xs[:, s0:s1].T[:, :, None]
                * scale[s0:s1].to(torch.float32)[:, None, :]).sum(dim=0)
    acc -= xsum @ minv.to(torch.float32)
    return acc.to(out_dtype)


def q4k_q8_gemv(x, qs, scale, minv, out_dtype=torch.bfloat16):
    """K1: y [B, O] = x @ W for Q4_K W with x quantized to int8 per 32
    (see csrc/q4k_q8_gemv.cu). x [B, K] (bf16 or f32 on cuda), qs uint8
    [K/2, O] paired nibbles, scale/minv [K/32, O] (bf16 on cuda)."""
    global q4k_q8_gemv_launches
    O = qs.shape[1]
    K = 2 * qs.shape[0]
    B = _check_x("q4k_q8_gemv", x, K)
    _require(K % 64 == 0 and O % 16 == 0,
             f"q4k_q8_gemv: needs K % 64 == 0 and O % 16 == 0, got K={K} O={O}")
    _check_tensor("qs", qs, torch.uint8, (K // 2, O))
    _require(out_dtype in (torch.bfloat16, torch.float32), f"q4k_q8_gemv: out {out_dtype}")
    if x.device.type == "cpu":
        return q4k_q8_gemv_plain(x, qs, scale, minv, out_dtype)
    _require(x.dtype in (torch.bfloat16, torch.float32), f"q4k_q8_gemv: x {x.dtype}")
    _check_tensor("scale", scale, torch.bfloat16, (K // 32, O))
    _check_tensor("minv", minv, torch.bfloat16, (K // 32, O))
    dev = _check_cuda("q4k_q8_gemv", dict(x=x, qs=qs, scale=scale, minv=minv))
    ksplit = _ksplit(O, B, K // 64, dev)
    nbytes = _workspace_bytes(B, K, O, 32, True, ksplit)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = torch.empty(B, O, dtype=out_dtype, device=dev)
    fn = kernels.function("q4k_q8_gemv", "q4k_q8_gemv",
                          [_P, _I, _P, _P, _P, _P, ctypes.c_longlong, _P] + [_I] * 5 + [_P])
    err = fn(kernels.ptr(x), int(x.dtype == torch.bfloat16), kernels.ptr(qs), kernels.ptr(scale),
             kernels.ptr(minv), kernels.ptr(ws), nbytes, kernels.ptr(out),
             int(out_dtype == torch.bfloat16), B, K, O, ksplit, _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q4k_q8_gemv")
    q4k_q8_gemv_launches += 1
    return out


# ------------------------------------------------------- K2: int8 x int8


def q8_0_q8_gemv_plain(x, q, s, gs: int, out_dtype=torch.float32):
    """Plain PyTorch version of K2 on any device: the same activation
    quantization, then per-group dots that are integers below 2^24
    (|sum| <= 64*127*128), so f32 holds them exactly."""
    B, K = x.shape
    O = q.shape[1]
    ng = K // gs
    xq, xs = _quantize_acts_q8_gs(x, gs)
    acc = torch.zeros(B, O, dtype=torch.float32, device=x.device)
    step = max(1, min(2**26 // (B * O), 2**24 // (gs * O)))
    for g0 in range(0, ng, step):
        g1 = min(ng, g0 + step)
        n = g1 - g0
        xb = xq[:, gs * g0 : gs * g1].to(torch.float32).reshape(B, n, gs).transpose(0, 1)
        wb = q[gs * g0 : gs * g1].to(torch.float32).reshape(n, gs, O)
        dots = torch.bmm(xb, wb)  # [n, B, O]
        acc += (dots * xs[:, g0:g1].T[:, :, None]
                * s[g0:g1].to(torch.float32)[:, None, :]).sum(dim=0)
    return acc.to(out_dtype)


def q8_0_q8_gemv(x, q, s, gs: int, out_dtype=torch.bfloat16):
    """K2: y [B, O] = x @ W for int8 W with a scale per gs rows, x quantized
    to int8 per gs (see csrc/q8_0_q8_gemv.cu). x [B, K] (bf16 or f32 on
    cuda), q int8 [K, O], s [K/gs, O] f32 or bf16."""
    global q8_0_q8_gemv_launches
    K, O = q.shape
    B = _check_x("q8_0_q8_gemv", x, K)
    _require(gs in (32, 64) and K % gs == 0 and O % 16 == 0,
             f"q8_0_q8_gemv: needs gs in (32, 64), K % gs == 0, O % 16 == 0; "
             f"got gs={gs} K={K} O={O}")
    _check_tensor("q", q, torch.int8, (K, O))
    _require(tuple(s.shape) == (K // gs, O), f"s: shape {tuple(s.shape)}, expected {(K // gs, O)}")
    _require(out_dtype in (torch.bfloat16, torch.float32), f"q8_0_q8_gemv: out {out_dtype}")
    if x.device.type == "cpu":
        return q8_0_q8_gemv_plain(x, q, s, gs, out_dtype)
    _require(x.dtype in (torch.bfloat16, torch.float32), f"q8_0_q8_gemv: x {x.dtype}")
    _require(s.dtype in (torch.float32, torch.bfloat16), f"s: dtype {s.dtype}")
    dev = _check_cuda("q8_0_q8_gemv", dict(x=x, q=q, s=s))
    ksplit = _ksplit(O, B, K // gs, dev)
    nbytes = _workspace_bytes(B, K, O, gs, False, ksplit)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = torch.empty(B, O, dtype=out_dtype, device=dev)
    fn = kernels.function("q8_0_q8_gemv", "q8_0_q8_gemv",
                          [_P, _I, _P, _P, _I, _I, _P, ctypes.c_longlong, _P] + [_I] * 5 + [_P])
    err = fn(kernels.ptr(x), int(x.dtype == torch.bfloat16), kernels.ptr(q), kernels.ptr(s),
             int(s.dtype == torch.bfloat16), gs, kernels.ptr(ws), nbytes, kernels.ptr(out),
             int(out_dtype == torch.bfloat16), B, K, O, ksplit, _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q8_0_q8_gemv")
    q8_0_q8_gemv_launches += 1
    return out


# ------------------------------------------------------- prefill dequant


def q4k_dequant_plain(qs, scale, minv, dtype):
    """[K, O] = scale * q - minv in `dtype` (the ops of the JAX package's
    dequant_q4k_weights, before its transpose)."""
    q = torch.cat([qs & 0xF, qs >> 4], dim=0).to(dtype)  # [K, O] element order
    return (q * torch.repeat_interleave(scale.to(dtype), 32, dim=0)
            - torch.repeat_interleave(minv.to(dtype), 32, dim=0))


def q4k_dequant(qs, scale, minv, dtype):
    """Q4_K paired layout -> dense [K, O] weight (csrc/q4k_q8_gemv.cu
    q4k_dequant on the card, bf16 only; the plain version on the CPU)."""
    global q4k_dequant_launches
    K, O = 2 * qs.shape[0], qs.shape[1]
    if qs.device.type == "cpu":
        return q4k_dequant_plain(qs, scale, minv, dtype)
    _require(dtype == torch.bfloat16 and K % 64 == 0 and O % 8 == 0,
             f"q4k_dequant: the kernel writes bf16 with K % 64 == 0, O % 8 == 0; "
             f"got {dtype} K={K} O={O}")
    _check_tensor("qs", qs, torch.uint8, (K // 2, O))
    _check_tensor("scale", scale, torch.bfloat16, (K // 32, O))
    _check_tensor("minv", minv, torch.bfloat16, (K // 32, O))
    dev = _check_cuda("q4k_dequant", dict(qs=qs, scale=scale, minv=minv))
    w = torch.empty(K, O, dtype=torch.bfloat16, device=dev)
    fn = kernels.function("q4k_q8_gemv", "q4k_dequant", [_P] * 4 + [_I] * 2 + [_P])
    err = fn(kernels.ptr(qs), kernels.ptr(scale), kernels.ptr(minv), kernels.ptr(w), K, O,
             _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q4k_dequant")
    q4k_dequant_launches += 1
    return w


def q8_0_dequant_plain(q, s, gs: int, dtype):
    """[K, O] = q * s in `dtype` (the ops of dequant_q8_0_gs_weights)."""
    return q.to(dtype) * torch.repeat_interleave(s.to(dtype), gs, dim=0)


def q8_0_dequant(q, s, gs: int, dtype):
    """int8 per-gs layout -> dense [K, O] weight (csrc/q8_0_q8_gemv.cu
    q8_0_dequant on the card, bf16 only; the plain version on the CPU)."""
    global q8_0_dequant_launches
    K, O = q.shape
    if q.device.type == "cpu":
        return q8_0_dequant_plain(q, s, gs, dtype)
    _require(dtype == torch.bfloat16 and K % gs == 0 and O % 8 == 0,
             f"q8_0_dequant: the kernel writes bf16 with K % gs == 0, O % 8 == 0; "
             f"got {dtype} K={K} O={O} gs={gs}")
    _check_tensor("q", q, torch.int8, (K, O))
    _require(tuple(s.shape) == (K // gs, O) and s.dtype in (torch.float32, torch.bfloat16),
             f"s: {tuple(s.shape)} {s.dtype}")
    dev = _check_cuda("q8_0_dequant", dict(q=q, s=s))
    w = torch.empty(K, O, dtype=torch.bfloat16, device=dev)
    fn = kernels.function("q8_0_q8_gemv", "q8_0_dequant", [_P, _P, _I, _I, _P, _I, _I, _P])
    err = fn(kernels.ptr(q), kernels.ptr(s), int(s.dtype == torch.bfloat16), gs, kernels.ptr(w),
             K, O, _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q8_0_dequant")
    q8_0_dequant_launches += 1
    return w


# ------------------------------------------------------- dispatchers


def _add_bias(lin: Linear, y: torch.Tensor) -> torch.Tensor:
    b = lin.data.get("b")
    return y if b is None else y + b.to(y.dtype)


def q4k_matmul(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    """Forward for kind 'gguf_q4k'. x [..., K] -> [..., O]."""
    from mistralrs_tpu_torch.quant.gguf_linear import _ref_forward

    in_f, out_f = lin.shape
    lead = x.shape[:-1]
    n_rows = math.prod(lead)
    if n_rows > MAX_KERNEL_ROWS or in_f % 64 or out_f % 16 or n_rows == 0:
        return _ref_forward(lin, x)
    y = q4k_q8_gemv(x.reshape(n_rows, in_f).contiguous(), lin.data["qs"], lin.data["scale"],
                    lin.data["minv"], out_dtype=x.dtype)
    return _add_bias(lin, y.reshape(*lead, out_f))


def q8_0_matmul(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    """Forward for kind 'gguf_q8_0' (wire Q8_0 or the rq8 requant layout;
    meta = scale group size, None = 32)."""
    from mistralrs_tpu_torch.quant.gguf_linear import _ref_forward

    in_f, out_f = lin.shape
    gs = lin.meta or 32
    lead = x.shape[:-1]
    n_rows = math.prod(lead)
    if n_rows > MAX_KERNEL_ROWS or gs not in (32, 64) or out_f % 16 or n_rows == 0:
        return _ref_forward(lin, x)
    y = q8_0_q8_gemv(x.reshape(n_rows, in_f).contiguous(), lin.data["q"], lin.data["scale"], gs,
                     out_dtype=x.dtype)
    return _add_bias(lin, y.reshape(*lead, out_f))
