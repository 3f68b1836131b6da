"""Packed-weight GEMVs: int8 or bf16 activations x Q4_K, Q5_K, Q6_K, int8
and plane-major affine (Q2_K, GPTQ, HQQ) weights.

Counterpart of mistralrs_tpu/ops/quant_matmul.py, for the kernels the
serving paths run, all hand-written CUDA under csrc/:
- K1 `q4k_q8_gemv` (replaces `_q4k_q8_kernel`), K2 `q8_0_q8_gemv`
  (`_q8_0_q8_kernel`): the Q4_K_M path; each has a decode instantiation
  (up to 16 rows) and a rows instantiation (17-256 rows, int8 wgmma, one
  weight read per call), chosen by `int8_gemv_plan` and counted apart;
- K3 `q6k_q8_gemv` (`_q6k_q8_kernel`), K4 `q6k_bf16_gemv` (`_q6k_kernel`)
  and K9 `q5k_q8_gemv` (`_q5k_hbit_q8_kernel` together with the K1 call
  that `_q5k_q8_matmul_padded` makes before it): the Q5_K_M path with Q6_K
  kept native; K9 has a rows instantiation (17-256 rows, K1's, on
  `q5k_q8_plan`), K4 one (17-256 rows, K10's with Q6_K's decode, on
  `q6k_bf16_plan`), each counted apart;
- K10 `affine_gemv` (`_affine_kernel`): w = q*scale - zs for plane-major
  packed codes of 1, 2, 4 or 8 bits, the GEMV of GGUF Q2_K (the Q2_K
  path), GPTQ and HQQ; bf16 activations, as the JAX kernel takes x's
  dtype; a decode instantiation (up to 16 rows, `plane_dec_plan`, shared
  with K8) and a rows instantiation (17-256 rows, bf16 wgmma, on
  `plane_gemv_plan`), counted apart;
- K5 `q4k_bf16_gemv` (`_q4k_kernel`), K8 `q8_0_bf16_gemv`
  (`_q8_0_kernel`) and K9b (`_q5k_hbit_kernel`): the routes of a Linear
  with `int8_act` off (PipelineConfig.int8_activations = False), where x
  stays in its dtype, as in the JAX package with its MISTRALRS_*_INT8
  gates off; K5 and K8 have a decode instantiation (up to 16 rows, K10's
  `plane_dec_plan`: K5's with Q4_K's format, K8's at 8 signed bits) and a
  rows instantiation (17-256 rows, K10's rows kernel: K5's with Q4_K's
  exact two-part weight on `q4k_bf16_plan`, K8's at 8 bits on
  `q8_0_bf16_plan`), counted apart; K9b's decode instantiation is the
  whole Q5_K product in one kernel, `q5k_bf16_gemv` (`_q4k_kernel` and
  `_q5k_hbit_kernel` as `_q5k_matmul_padded` adds them, on
  `q5k_bf16_plan`), its rows instantiation the high-bit term alone,
  `q5k_hbit_bf16_gemv` (K10's rows kernel at one bit, on
  `q5k_hbit_bf16_plan`).

Activations are quantized per block to int8 (ggml's Q8 approach, as the JAX
int8 path does): xs = max(max|x_block|, 1e-10)/127, xq = clip(round(x/xs),
-127, 127), so |err| <= max|x_block|/254 per element; round is half to
even, as jnp.round. The kernels take x itself: the C entry point of each
runs a quantize kernel, the GEMV and a split-K pass (one host call instead
of a dozen torch ops per projection); the decode instantiations (up to 16
rows) of K1, K2 and K3 add their K splits on chip instead, two launches a
call, and K4's, K5's, K8's, K10's and the Q5_K bf16 kernel's, which take
x as it is, one. Their plain
versions quantize with the same f32 operations in torch, so the int8 codes
agree bit for bit; the scale is max|x|*(1/127) in both, where JAX divides
by 127 (at most one f32 ulp apart). The activation scales and block sums are [B, K/gs] here (JAX
keeps them transposed for TPU sublane alignment). K4, K5, K8, K9b and K10
keep x in its dtype; K5, K9b's decode kernel and the rows instantiations of
K4 and K10 only take per-16, per-32 or per-group sums of it.

Routing rules of this port (the dispatchers below), by the Linear's
`int8_act` (the port's one switch for the JAX package's four gates
`_use_q4k_int8`, `_use_q5k_int8`, `_use_q6k_int8`, `_use_q8_0_int8`):
- more than 256 rows (prefill chunks) -> dequantize + torch.matmul
  (gguf_linear._ref_forward, or affine_qmatmul's own), as the JAX package
  leaves prefill to XLA; on the card the dequantization is one kernel per
  format (`q4k_dequant`, `q5k_dequant`, `q6k_dequant`, `q8_0_dequant`,
  `affine_dequant`, the pass XLA fuses in the JAX package);
- otherwise the kernel, when its shape rule holds (every kernel: out % 16
  == 0, for 16-byte column chunks), else the dequant route:
  - Q4_K: K1, or K5 with int8_act off;
  - Q5_K: K9, or with int8_act off the whole product in one kernel up to
    16 rows (`q5k_bf16_gemv`) and above K5 on the nibbles then K9b on the
    high bits, y + 16*yh in x's dtype, JAX's roundings either way;
  - int8 weights (wire Q8_0, rq8): K2 at group 32 or 64, or K8 at group 32
    with int8_act off (another group takes the dequant route there, as the
    JAX package's bf16 route does);
  - Q6_K: the JAX package's choice between its two kernels, since it
    changes the numbers: int8 activations (K3) at up to 16 rows with G >=
    256, K4 otherwise; K4 at every row count with int8_act off;
  - plane affine: K10 either way (it takes x in its dtype).
The Mosaic-only rules of the JAX package (in % 512 or % 2048, block_k >=
512, row padding to 8, x gathered by the Q6_K permutation at G = 128) do
not apply to the CUDA kernels and are gone: every kernel reads x in
element order.

Each kernel wrapper takes its plain PyTorch version when (and only when) its
tensors lie on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from mistralrs_tpu_torch.ops import kernels
from mistralrs_tpu_torch.quant.qlinear import Linear

MAX_KERNEL_ROWS = 256

# launches of each kernel (one per wrapper call that launched it)
q4k_q8_gemv_launches = 0
q8_0_q8_gemv_launches = 0
# K1's and K2's rows instantiations (17-256 rows), counted apart
q4k_q8_gemv_rows_launches = 0
q8_0_q8_gemv_rows_launches = 0
q4k_dequant_launches = 0
q8_0_dequant_launches = 0
q6k_q8_gemv_launches = 0
q6k_bf16_gemv_launches = 0
q5k_q8_gemv_launches = 0
q6k_dequant_launches = 0
q5k_dequant_launches = 0
affine_gemv_launches = 0
# K9's, K10's, K4's, K9b's, K5's and K8's rows instantiations (17-256 rows),
# counted apart
q5k_q8_gemv_rows_launches = 0
affine_gemv_rows_launches = 0
q6k_bf16_gemv_rows_launches = 0
q5k_hbit_bf16_gemv_rows_launches = 0
q4k_bf16_gemv_rows_launches = 0
q8_0_bf16_gemv_rows_launches = 0
affine_dequant_launches = 0
q4k_bf16_gemv_launches = 0
q8_0_bf16_gemv_launches = 0
# K9b's decode instantiation: the whole Q5_K x bf16 product at 1-16 rows
q5k_bf16_gemv_launches = 0

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


def _xsum(x2d: torch.Tensor, gs: int) -> torch.Tensor:
    """Per-gs-block sums of the original x [B, K] -> [B, K/gs] f32."""
    B, K = x2d.shape
    return x2d.to(torch.float32).reshape(B, K // gs, gs).sum(dim=2)


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


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    """The launch of a GEMV for one call, every field of which the CUDA
    entry point checks: the row tile of a block (16: the decode
    instantiation; 64 or 128: the rows instantiation, two consumer
    warpgroups), the GEMV's grid as the entry point launches it, the K
    split, the blocks of a thread-block cluster (the decode instantiation's
    K splits of a column tile, which add their sums on chip; 1 for rows),
    the columns a block owns, the decode ring's stages (0 for rows, whose
    ring is sized from shared memory) and the workspace bytes
    (csrc/common.cuh::carve)."""

    rows: int
    grid: tuple[int, int, int]
    ksplit: int
    cluster: int
    cols: int
    stages: int
    ws_bytes: int

    def launch_args(self) -> tuple[int, ...]:
        """The plan as the C entry points take it, after (B, K, O)."""
        return (self.rows, *self.grid, self.cluster, self.cols, self.stages)


# the decode instantiations (csrc/common.cuh): weight bytes a block's ring
# holds (half of them in flight), the K steps of a ring stage (64 byte rows
# of codes: 2 sub-block pairs of K1, 64/gs groups of K2), and the most
# blocks of a cluster (the portable limit)
DEC_IN_FLIGHT = 32 * 1024
DEC_SUB = 2
DEC_MAX_CLUSTER = 8
# K3's and K4's (csrc/q6k_gemv.cu): a K step is 32 t of one chunk for all
# four spans (128 elements), 112 weight bytes a column (ql 64 rows, qh 32,
# 8 bf16 scale rows), 14 KB at 128 columns, so a stage holds one step
Q6K_DEC_SUB = 1
Q6K_STEP_COL_BYTES = 112
# K9's (csrc/q5k_q8_gemv.cu) and K9b's (csrc/q5k_bf16_gemv.cu): a K step is
# the 32 qh rows 32r.. and the 4 qs blocks of 32 rows whose high bits they
# hold (256 elements), 192 weight bytes a column (qs 128 rows, qh 32, the 8
# sub-blocks' bf16 scale and minv rows), 24 KB at 128 columns: a stage a
# step
Q5K_STEP_COL_BYTES = 192


def dec_stages(stage_weight_bytes: int) -> int:
    """Ring stages of a decode instantiation (common.cuh dec_stages)."""
    return -(-DEC_IN_FLIGHT // stage_weight_bytes)


def dec_per_split(slices: int, splits: int, sub: int = DEC_SUB) -> int:
    """The K steps (K2: 32-row slices; K1: sub-block pairs; K3, K4: 128-element
    steps) a K split takes: whole stages of `sub` steps, the last split fewer
    (common.cuh dec_per_split)."""
    return -(-(-(-slices // splits)) // sub) * sub


def _dec_grid(O: int, steps: int, sub: int, sms: int) -> tuple[int, int, int]:
    """(K splits, columns a block, column tiles) of a decode instantiation
    over `steps` K steps, `sub` a ring stage: 128 columns a block, or 64
    where even clusters of the most splits would leave SMs idle; as many
    splits as put about three blocks on an SM, at most DEC_MAX_CLUSTER,
    each whole stages and none empty."""
    most = max(1, min(DEC_MAX_CLUSTER, -(-steps // sub)))
    cols = 128 if -(-O // 128) * most >= sms else 64
    ctiles = -(-O // cols)
    want = max(1, min(most, 3 * sms // ctiles))
    return -(-steps // dec_per_split(steps, want, sub)), cols, ctiles


def int8_gemv_plan(B: int, K: int, O: int, k_units: int, gs: int, sum_gs: int,
                   sms: int, scale_bytes: int = 2) -> GemvPlan:
    """Launch plan of K1 (k_units = K/64 sub-block pairs, gs = sum_gs = 32,
    bf16 scales) or K2 (k_units = K/gs groups, sum_gs = 0, scales of
    `scale_bytes`) on a card with `sms` SMs.

    Up to 16 rows: the decode instantiation. A block owns 128 columns, or
    64 where even clusters of the most splits would leave SMs idle (K2's
    v: 8 column tiles of 128); the grid is (K splits, column tiles, 1) and
    the splits of a column tile form one cluster: as many as put about
    three blocks on an SM (a block's ring holds DEC_IN_FLIGHT bytes, half
    of them in flight; 2 and 4 measured slower on the card), at most
    DEC_MAX_CLUSTER, each split whole ring stages and none empty.
    Above: the rows instantiation, one block per SM (its accumulators fill
    the register file), grid (row tiles, column tiles, ksplit) with the
    row tiles fastest, so each weight tile is read by at most two blocks
    that run side by side; K is split only when the tiles fall short of
    the SMs, into as many splits as one wave holds, each split keeping at
    least 4 K steps."""
    if B <= 16:
        slices = K // 64 if sum_gs else K // 32  # K1: pairs; K2: 32-row slices
        ks, cols, ctiles = _dec_grid(O, slices, DEC_SUB, sms)
        stage_bytes = (cols * DEC_SUB * (32 + 4 * 2) if sum_gs else
                       cols * (DEC_SUB * 32 + DEC_SUB * 32 // gs * scale_bytes))
        return GemvPlan(16, (ks, ctiles, 1), ks, ks, cols, dec_stages(stage_bytes),
                        _workspace_bytes(B, K, O, gs, sum_gs, ks, layout="decode"))
    ctiles = -(-O // 128)
    rows = 64 if B <= 64 else 128
    rtiles = -(-B // rows)
    tiles = ctiles * rtiles
    ks = max(1, min(sms // tiles, k_units // 4))
    return GemvPlan(rows, (rtiles, ctiles, ks), ks, 1, 128, 0,
                    _workspace_bytes(B, K, O, gs, sum_gs, ks, rows, "tiled"))


def _align256(n: int) -> int:
    return (n + 255) & ~255


def _workspace_bytes(B: int, K: int, O: int, gs: int, sum_gs: int, ksplit: int,
                     rows: int = 16, layout: str = "tiled", xcopy: bool = False) -> int:
    """Scratch of one GEMV call: (xq [Bpad, K], xs [K/gs, Bpad] unless gs is
    0), (xsum [K/sum_gs, Bpad] unless sum_gs is 0), (a bf16 copy of x [Bpad,
    K] with xcopy), split-K partials [ksplit, B, O], each 256-byte aligned,
    in the order csrc/common.cuh::carve lays them out for its x layout:
    "tiled" (the rows instantiations of K1, K2, K9 and K10: Bpad
    B rounded up to the row tile `rows`, the partials only with more than
    one split) or "decode" (the decode instantiations of K1, K2, K3 and K9:
    Bpad 16, no partials; K4's, K5's, K8's, K9b's and K10's have no
    workspace)."""
    if layout != "tiled":
        rows = 16
    bpad = -(-B // rows) * rows
    part = layout == "tiled" and ksplit > 1
    return ((_align256(bpad * K) + _align256((K // gs) * bpad * 4) if gs else 0)
            + (_align256((K // sum_gs) * bpad * 4) if sum_gs else 0)
            + (_align256(bpad * K * 2) if xcopy else 0)
            + (_align256(ksplit * B * O * 4) if part else 0))


def _check_x(name: str, x: torch.Tensor, K: int) -> int:
    _require(x.dim() == 2 and x.shape[1] == K, f"{name}: x {tuple(x.shape)} is not [B, {K}]")
    _require(x.shape[0] >= 1, f"{name}: no rows")
    return x.shape[0]


# ------------------------------------------------------- K1: Q4_K x int8


def _sub_block_sums(xv, q, scale, xs=None):
    """sum_sub [xs[b, sub] *] scale[sub, o] * (xv_sub . q_sub) in f32, over
    32-element sub-blocks: xv [B, K] (int8 codes or x itself), codes q [K,
    O] in element order, scale [K/32, O], xs [B, K/32] (the int8 route's
    activation scales, or None)."""
    B, K = xv.shape
    O = q.shape[1]
    nsub = K // 32
    acc = torch.zeros(B, O, dtype=torch.float32, device=xv.device)
    step = max(1, min(2**26 // (B * O), 2**24 // (32 * O)))  # bounded temporaries
    for s0 in range(0, nsub, step):
        s1 = min(nsub, s0 + step)
        n = s1 - s0
        xb = xv[:, 32 * s0 : 32 * s1].to(torch.float32).reshape(B, n, 32).transpose(0, 1)
        wb = q[32 * s0 : 32 * s1].to(torch.float32).reshape(n, 32, O)
        dots = torch.bmm(xb, wb)  # [n, B, O]
        if xs is not None:
            dots = dots * xs[:, s0:s1].T[:, :, None]
        acc += (dots * scale[s0:s1].to(torch.float32)[:, None, :]).sum(dim=0)
    return acc


def _affine_q8_plain(x, q, scale, minv, out_dtype):
    """y = sum_sub xs*scale*(xq . q) - xsum32 @ minv for unsigned codes q
    [K, O] in element order with per-32 scale/minv: the plain versions of
    K1 (4-bit q) and K9 (5-bit q). The per-sub-block dots are integers below
    2^24 (|sum| <= 32*127*31), so the f32 batched products hold them
    exactly, as the kernels' int32 dots do."""
    xq, xs = _quantize_acts_q8(x)
    acc = _sub_block_sums(xq, q, scale, xs)
    acc -= _xsum(x, 32) @ minv.to(torch.float32)
    return acc.to(out_dtype)


def q4k_q8_gemv_plain(x, qs, scale, minv, out_dtype=torch.float32):
    """Plain PyTorch version of K1 on any device: the same activation
    quantization, then exact per-sub-block integer dots."""
    q = torch.cat([qs & 0xF, qs >> 4], dim=0)  # [K, O] element order
    return _affine_q8_plain(x, q, scale, minv, out_dtype)


def q4k_q8_gemv(x, qs, scale, minv, out_dtype=torch.bfloat16):
    """K1: y [B, O] = x @ W for Q4_K W with x quantized to int8 per 32
    (see csrc/q4k_q8_gemv.cu). x [B, K] (bf16 or f32 on cuda), qs uint8
    [K/2, O] paired nibbles, scale/minv [K/32, O] (bf16 on cuda). Up to 16
    rows the decode instantiation runs (two launches: the quantize kernel,
    then the GEMV whose K splits add their sums in a cluster), above it
    the rows instantiation, on the plan of int8_gemv_plan. Nothing of a
    call waits for the card or keeps state between calls, so a call can
    be captured in a CUDA graph."""
    global q4k_q8_gemv_launches, q4k_q8_gemv_rows_launches
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
    plan = int8_gemv_plan(B, K, O, K // 64, 32, 32, kernels.sm_count(dev))
    ws = torch.empty(plan.ws_bytes, dtype=torch.uint8, device=dev)
    out = torch.empty(B, O, dtype=out_dtype, device=dev)
    fn = kernels.function("q4k_q8_gemv", "q4k_q8_gemv",
                          [_P, _I, _P, _P, _P, _P, ctypes.c_longlong, _P] + [_I] * 11 + [_P])
    err = fn(kernels.ptr(x), int(x.dtype == torch.bfloat16), kernels.ptr(qs), kernels.ptr(scale),
             kernels.ptr(minv), kernels.ptr(ws), plan.ws_bytes, kernels.ptr(out),
             int(out_dtype == torch.bfloat16), B, K, O, *plan.launch_args(),
             _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q4k_q8_gemv")
    if plan.rows == 16:
        q4k_q8_gemv_launches += 1
    else:
        q4k_q8_gemv_rows_launches += 1
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
    cuda), q int8 [K, O], s [K/gs, O] f32 or bf16. Kernels as in
    q4k_q8_gemv."""
    global q8_0_q8_gemv_launches, q8_0_q8_gemv_rows_launches
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
    plan = int8_gemv_plan(B, K, O, K // gs, gs, 0, kernels.sm_count(dev), s.element_size())
    ws = torch.empty(plan.ws_bytes, dtype=torch.uint8, device=dev)
    out = torch.empty(B, O, dtype=out_dtype, device=dev)
    fn = kernels.function("q8_0_q8_gemv", "q8_0_q8_gemv",
                          [_P, _I, _P, _P, _I, _I, _P, ctypes.c_longlong, _P] + [_I] * 11 + [_P])
    err = fn(kernels.ptr(x), int(x.dtype == torch.bfloat16), kernels.ptr(q), kernels.ptr(s),
             int(s.dtype == torch.bfloat16), gs, kernels.ptr(ws), plan.ws_bytes,
             kernels.ptr(out), int(out_dtype == torch.bfloat16), B, K, O, *plan.launch_args(),
             _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q8_0_q8_gemv")
    if plan.rows == 16:
        q8_0_q8_gemv_launches += 1
    else:
        q8_0_q8_gemv_rows_launches += 1
    return out


# ------------------------------------------------------- Q6_K layout


def _q6k_natural(ql, qh, scale, G: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked Q6_K layout read back in element order: (q uint8 [K, O],
    0..63, and s16 [K/16, O]). Packed position (chunk c, span j, t) holds
    element j*K/4 + c*G + t, so this is a reshape and a transpose, no gather."""
    K, O = 2 * ql.shape[0], ql.shape[1]
    C = K // (4 * G)
    qlc = ql.reshape(C, 2, G, O)
    h = qh.reshape(C, G, O)
    q = torch.stack([(qlc[:, 0] & 0xF) | ((h & 3) << 4),
                     (qlc[:, 1] & 0xF) | (((h >> 2) & 3) << 4),
                     (qlc[:, 0] >> 4) | (((h >> 4) & 3) << 4),
                     (qlc[:, 1] >> 4) | ((h >> 6) << 4)])  # [span, C, G, O]
    s16 = scale.reshape(C, 4, G // 16, O).transpose(0, 1)
    return q.reshape(K, O), s16.reshape(K // 16, O)


def _check_q6k(name: str, x, ql, qh, G: int) -> tuple[int, int, int]:
    K, O = 2 * ql.shape[0], ql.shape[1]
    B = _check_x(name, x, K)
    _require(G % 32 == 0 and K % (4 * G) == 0 and O % 16 == 0,
             f"{name}: needs G % 32 == 0, K % 4G == 0, O % 16 == 0; got G={G} K={K} O={O}")
    _check_tensor("ql", ql, torch.uint8, (K // 2, O))
    _check_tensor("qh", qh, torch.uint8, (K // 4, O))
    return B, K, O


# ------------------------------------------------------- K3: Q6_K x int8


def q6k_q8_gemv_plain(x, ql, qh, scale, G: int, out_dtype=torch.float32):
    """Plain PyTorch version of K3 on any device: the activation
    quantization of K1, per-16 integer dots (|sum| <= 16*127*63, exact in
    f32), each 32-block's two dots scaled by their s16 and summed before
    the xs multiply (JAX's order), then the -32 term over the per-16 sums
    of the original x: -32 * xsum16 @ s16."""
    B, K = x.shape
    O = ql.shape[1]
    q, s16 = _q6k_natural(ql, qh, scale, G)
    s16 = s16.to(torch.float32)
    nsub = K // 32
    xq, xs = _quantize_acts_q8(x)
    acc = torch.zeros(B, O, dtype=torch.float32, device=x.device)
    step = max(1, min(2**25 // (B * O), 2**23 // (32 * O)))
    for s0 in range(0, nsub, step):
        s1 = min(nsub, s0 + step)
        n = s1 - s0
        xb = xq[:, 32 * s0 : 32 * s1].to(torch.float32).reshape(B, 2 * n, 16).transpose(0, 1)
        wb = q[32 * s0 : 32 * s1].to(torch.float32).reshape(2 * n, 16, O)
        dots = torch.bmm(xb, wb) * s16[2 * s0 : 2 * s1, None, :]  # [2n, B, O]
        t = dots.reshape(n, 2, B, O).sum(dim=1)
        acc += (t * xs[:, s0:s1].T[:, :, None]).sum(dim=0)
    acc -= 32.0 * (_xsum(x, 16) @ s16)
    return acc.to(out_dtype)


def _q6k_dec_plan(B: int, K: int, O: int, G: int, sms: int, ws_bytes: int) -> GemvPlan:
    """The decode plan of K3 and K4 (csrc/q6k_gemv.cu) up to 16 rows: K1's
    and K2's decode rules (_dec_grid) over K/128 steps of 128 elements, a
    ring stage a step; the span G whole 32-t steps."""
    _require(1 <= B <= 16, f"Q6_K decode plan: 1-16 rows, got {B}")
    _require(G >= 32 and G % 32 == 0 and K % (4 * G) == 0,
             f"Q6_K decode plan: needs G % 32 == 0 and K % 4G == 0; got G={G} K={K}")
    ks, cols, ctiles = _dec_grid(O, K // 128, Q6K_DEC_SUB, sms)
    return GemvPlan(16, (ks, ctiles, 1), ks, ks, cols,
                    dec_stages(cols * Q6K_STEP_COL_BYTES * Q6K_DEC_SUB), ws_bytes)


def q6k_q8_plan(B: int, K: int, O: int, G: int, sms: int) -> GemvPlan:
    """Launch plan of K3 on a card with `sms` SMs, every field of which the
    CUDA entry point checks: the decode plan (grid (K splits, column tiles,
    1), a cluster of the splits), and the workspace of the decode layout
    (x's codes of 16 rows, the scales per 32 and the sums per 16; no
    partials). K3 runs at 1-16 rows only, as the JAX package routes it
    (its q6k_matmul takes the int8 kernel at n_rows <= 16 only): above, it
    raises."""
    _require(B <= 16, f"q6k_q8_gemv: K3 runs at up to 16 rows, got {B}")
    return _q6k_dec_plan(B, K, O, G, sms, _workspace_bytes(B, K, O, 32, 16, 1, layout="decode"))


def q6k_q8_gemv(x, ql, qh, scale, G: int, out_dtype=torch.bfloat16):
    """K3: y [B, O] = x @ W for Q6_K W (chunk span G) with x quantized to
    int8 per 32 (see csrc/q6k_gemv.cu). x [B, K] in element order (bf16 or
    f32 on cuda; at most 16 rows there), ql uint8 [K/2, O], qh uint8 [K/4,
    O], scale [K/16, O] (bf16 on cuda), all in the chunked layout of
    gguf_linear.pack_q6k. Two launches a call (the quantize kernel, then the
    GEMV whose K splits add their sums in a cluster), on the plan of
    q6k_q8_plan; nothing of a call waits for the card or keeps state
    between calls, so it can be captured in a CUDA graph."""
    global q6k_q8_gemv_launches
    B, K, O = _check_q6k("q6k_q8_gemv", x, ql, qh, G)
    _require(out_dtype in (torch.bfloat16, torch.float32), f"q6k_q8_gemv: out {out_dtype}")
    if x.device.type == "cpu":
        return q6k_q8_gemv_plain(x, ql, qh, scale, G, out_dtype)
    _require(x.dtype in (torch.bfloat16, torch.float32), f"q6k_q8_gemv: x {x.dtype}")
    _check_tensor("scale", scale, torch.bfloat16, (K // 16, O))
    dev = _check_cuda("q6k_q8_gemv", dict(x=x, ql=ql, qh=qh, scale=scale))
    plan = q6k_q8_plan(B, K, O, G, kernels.sm_count(dev))
    ws = torch.empty(plan.ws_bytes, dtype=torch.uint8, device=dev)
    out = torch.empty(B, O, dtype=out_dtype, device=dev)
    fn = kernels.function("q6k_gemv", "q6k_q8_gemv",
                          [_P, _I, _P, _P, _P, _I, _P, ctypes.c_longlong, _P] + [_I] * 11 + [_P])
    err = fn(kernels.ptr(x), int(x.dtype == torch.bfloat16), kernels.ptr(ql), kernels.ptr(qh),
             kernels.ptr(scale), G, kernels.ptr(ws), plan.ws_bytes, kernels.ptr(out),
             int(out_dtype == torch.bfloat16), B, K, O, *plan.launch_args(),
             _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q6k_q8_gemv")
    q6k_q8_gemv_launches += 1
    return out


# ------------------------------------------------------- K4: Q6_K x bf16


def q6k_bf16_gemv_plain(x, ql, qh, scale, G: int, out_dtype=torch.float32):
    """Plain PyTorch version of K4 on any device, the ops of JAX's
    `_q6k_kernel`: w = q * s16 rounded to x's dtype (q in 0..63), the
    product with f32 accumulation (x.float() @ w.float(), as the kernel's
    f32 accumulators), then -32 * xsum16 @ s16 in f32."""
    q, s16 = _q6k_natural(ql, qh, scale, G)
    w = q.to(x.dtype) * torch.repeat_interleave(s16.to(x.dtype), 16, dim=0)
    y = x.to(torch.float32) @ w.to(torch.float32)
    y -= 32.0 * (_xsum(x, 16) @ s16.to(torch.float32))
    return y.to(out_dtype)


def q6k_rows_take(K: int, G: int) -> bool:
    """Whether K4's rows instantiation takes the layout: a chunk span G that
    is a power of two and a multiple of 128 (a zs slice, 128 r of a span,
    then lies in one chunk, and the kernel's index arithmetic is shifts),
    K a multiple of 4G. q6k_matmul's G >= 128 (q6k_chunk_size's spans are
    powers of two) always holds it."""
    return G >= 128 and G & (G - 1) == 0 and K % (4 * G) == 0


def q6k_bf16_plan(B: int, K: int, O: int, G: int, sms: int) -> GemvPlan:
    """Launch plan of K4 on a card with `sms` SMs, every field of which the
    CUDA entry point checks. Up to 16 rows the decode instantiation
    (q6k_bf16_dec_kernel): K3's decode plan (grid (K splits, column tiles,
    1), a cluster of the splits) and no workspace (x goes in by TMA as it
    is). Above: the rows instantiation, K10's 2-bit plan (Q6_K is its
    geometry: 4 planes, 16-element groups, a zs slice of 128 r) with Q6_K's
    ring stages; the span G must pass q6k_rows_take."""
    if B <= 16:
        return _q6k_dec_plan(B, K, O, G, sms, 0)
    _require(q6k_rows_take(K, G), f"q6k_bf16_gemv: above 16 rows the kernel needs a power-of-two "
                                  f"span G >= 128 with K % 4G == 0; got G={G} K={K}")
    return plane_gemv_plan(B, K, O, 2, 16, sms, codes_in_tile=True)


def q6k_bf16_gemv(x, ql, qh, scale, G: int, out_dtype=torch.bfloat16):
    """K4: y [B, O] = x @ W for Q6_K W with the weight dequantized to x's
    dtype inside the kernel (see csrc/q6k_gemv.cu). x [B, K] in element
    order (bf16 on cuda), the weight arrays as for K3. Up to 16 rows the
    decode instantiation (one launch, the K splits added in a cluster),
    above it the rows instantiation (plane_gemv.cuh's rows kernel with
    Q6_K's decode), on the plan of q6k_bf16_plan."""
    global q6k_bf16_gemv_launches, q6k_bf16_gemv_rows_launches
    B, K, O = _check_q6k("q6k_bf16_gemv", x, ql, qh, G)
    _require(out_dtype in (torch.bfloat16, torch.float32), f"q6k_bf16_gemv: out {out_dtype}")
    if x.device.type == "cpu":
        return q6k_bf16_gemv_plain(x, ql, qh, scale, G, out_dtype)
    _require(x.dtype == torch.bfloat16, f"q6k_bf16_gemv: the kernel takes bf16 x, got {x.dtype}")
    _check_tensor("scale", scale, torch.bfloat16, (K // 16, O))
    dev = _check_cuda("q6k_bf16_gemv", dict(x=x, ql=ql, qh=qh, scale=scale))
    plan = q6k_bf16_plan(B, K, O, G, kernels.sm_count(dev))
    ws = torch.empty(plan.ws_bytes, dtype=torch.uint8, device=dev)
    out = torch.empty(B, O, dtype=out_dtype, device=dev)
    fn = kernels.function("q6k_gemv", "q6k_bf16_gemv",
                          [_P, _P, _P, _P, _I, _P, ctypes.c_longlong, _P] + [_I] * 11 + [_P])
    err = fn(kernels.ptr(x), kernels.ptr(ql), kernels.ptr(qh), kernels.ptr(scale), G,
             kernels.ptr(ws), plan.ws_bytes, kernels.ptr(out), int(out_dtype == torch.bfloat16),
             B, K, O, *plan.launch_args(), _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q6k_bf16_gemv")
    if plan.rows == 16:
        q6k_bf16_gemv_launches += 1
    else:
        q6k_bf16_gemv_rows_launches += 1
    return out


# ------------------------------------------------------- K9: Q5_K x int8


def _q5k_values(qs, qh) -> torch.Tensor:
    """Q5_K codes nib | hbit << 4 (0..31), uint8 [K, O] in element order."""
    planes = torch.cat([(qh >> j) & 1 for j in range(8)], dim=0)
    return torch.cat([qs & 0xF, qs >> 4], dim=0) | (planes << 4)


def q5k_q8_gemv_plain(x, qs, qh, scale, minv, out_dtype=torch.float32):
    """Plain PyTorch version of K9 on any device: K1's per-32 integer dots
    over the 5-bit codes. JAX's K1 dot plus 16 x its high-bit dot is the
    same integer, so only the f32 order of the scaled sums differs."""
    return _affine_q8_plain(x, _q5k_values(qs, qh), scale, minv, out_dtype)


def q5k_q8_plan(B: int, K: int, O: int, sms: int) -> GemvPlan:
    """Launch plan of K9 on a card with `sms` SMs, every field of which the
    CUDA entry point checks. Up to 16 rows the decode instantiation
    (q5k_q8_dec_kernel): K1's decode rules (_dec_grid) over K/256 steps of
    256 elements (the 32 qh rows a step reads once), a ring stage a step,
    the ring's stages from the step's Q5K_STEP_COL_BYTES a column, and the
    decode workspace (x's codes of 16 rows, the scales and sums per 32; no
    partials). Above: K1's rows plan (int8_gemv_plan with K/64 pairs, gs =
    sum_gs = 32); the kernel splits K at groups of 4 pairs,
    q5k_rows_pairs_per_split."""
    if B <= 16:
        ks, cols, ctiles = _dec_grid(O, K // 256, 1, sms)
        return GemvPlan(16, (ks, ctiles, 1), ks, ks, cols,
                        dec_stages(cols * Q5K_STEP_COL_BYTES),
                        _workspace_bytes(B, K, O, 32, 32, ks, layout="decode"))
    return int8_gemv_plan(B, K, O, K // 64, 32, 32, sms)


def q5k_rows_pairs_per_split(K: int, ksplit: int) -> int:
    """The sub-block pairs a K split of K9's rows kernel takes: whole groups
    of 4 pairs (the pairs p + m*K/256 that share 32 qh rows), every split
    but the last the same (csrc/q4k_rows.cuh pairs_per_split)."""
    return 4 * -(-(K // 256) // ksplit)


def q5k_q8_gemv(x, qs, qh, scale, minv, out_dtype=torch.bfloat16):
    """K9: y [B, O] = x @ W for Q5_K W with x quantized to int8 per 32
    (see csrc/q5k_q8_gemv.cu). x [B, K] (bf16 or f32 on cuda), qs uint8
    [K/2, O] paired nibbles, qh uint8 [K/8, O] plane-major high bits,
    scale/minv [K/32, O] (bf16 on cuda). Up to 16 rows the decode
    instantiation (two launches: the quantize kernel, then the GEMV whose K
    splits add their sums in a cluster), above it the rows instantiation,
    on the plan of q5k_q8_plan. Nothing of a call waits for the card or
    keeps state between calls, so a call can be captured in a CUDA
    graph."""
    global q5k_q8_gemv_launches, q5k_q8_gemv_rows_launches
    O = qs.shape[1]
    K = 2 * qs.shape[0]
    B = _check_x("q5k_q8_gemv", x, K)
    _require(K % 256 == 0 and O % 16 == 0,
             f"q5k_q8_gemv: needs K % 256 == 0 and O % 16 == 0, got K={K} O={O}")
    _check_tensor("qs", qs, torch.uint8, (K // 2, O))
    _check_tensor("qh", qh, torch.uint8, (K // 8, O))
    _require(out_dtype in (torch.bfloat16, torch.float32), f"q5k_q8_gemv: out {out_dtype}")
    if x.device.type == "cpu":
        return q5k_q8_gemv_plain(x, qs, qh, scale, minv, out_dtype)
    _require(x.dtype in (torch.bfloat16, torch.float32), f"q5k_q8_gemv: x {x.dtype}")
    _check_tensor("scale", scale, torch.bfloat16, (K // 32, O))
    _check_tensor("minv", minv, torch.bfloat16, (K // 32, O))
    dev = _check_cuda("q5k_q8_gemv", dict(x=x, qs=qs, qh=qh, scale=scale, minv=minv))
    plan = q5k_q8_plan(B, K, O, kernels.sm_count(dev))
    ws = torch.empty(plan.ws_bytes, dtype=torch.uint8, device=dev)
    out = torch.empty(B, O, dtype=out_dtype, device=dev)
    fn = kernels.function("q5k_q8_gemv", "q5k_q8_gemv",
                          [_P, _I, _P, _P, _P, _P, _P, ctypes.c_longlong, _P] + [_I] * 11 + [_P])
    err = fn(kernels.ptr(x), int(x.dtype == torch.bfloat16), kernels.ptr(qs), kernels.ptr(qh),
             kernels.ptr(scale), kernels.ptr(minv), kernels.ptr(ws), plan.ws_bytes,
             kernels.ptr(out), int(out_dtype == torch.bfloat16), B, K, O, *plan.launch_args(),
             _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q5k_q8_gemv")
    if plan.rows == 16:
        q5k_q8_gemv_launches += 1
    else:
        q5k_q8_gemv_rows_launches += 1
    return out


# ------------------------------------------------------- K10: plane affine

AFFINE_BITS = (1, 2, 4, 8)

# K10's rows kernel (csrc/plane_gemv.cuh plane_rows_kernel): shared memory
# its ring may fill (common.cuh kRingBudgetMax, less 1 KB of alignment)
PLANE_RING_BYTES = 226 * 1024 - 1024


def plane_row_geom(bits: int, elems: int | None = None) -> tuple[int, int, int]:
    """(planes of a byte row, elements of a main K step, byte rows of a
    step) of the rows kernel (csrc/plane_gemv.cuh PlaneRowGeom): `elems`
    elements a step, by default 64 (32 at 8 bits)."""
    per = 8 // bits
    e = elems or (32 if bits == 8 else 64)
    return per, e, e // per


def plane_row_stage_bytes(bits: int, rows: int, scale_bytes: int = 2,
                          codes_in_tile: bool = False, parts: int = 1,
                          elems: int | None = None) -> int:
    """Bytes of a stage of the rows kernel (sizeof of its format's stage,
    1 KB aligned): the x tile, the decoded bf16 tiles (`parts` of them:
    Q4kFmt's hi and lo), the byte rows, the scale rows of `scale_bytes`
    each (the most a step takes: a row a plane, or a row a 16 elements).
    With codes_in_tile (Q6kFmt's Q6kRowStage) the step's bytes wait in the
    decoded tile and the stage has no byte rows of its own."""
    per, e, r = plane_row_geom(bits, elems)
    stage = (rows * e * 2 + parts * e * 128 * 2 + (0 if codes_in_tile else r * 128)
             + max(per, e // 16) * 128 * scale_bytes)
    return -(-stage // 1024) * 1024


def plane_row_stages(bits: int, rows: int, scale_bytes: int = 2,
                     codes_in_tile: bool = False, parts: int = 1,
                     elems: int | None = None) -> int:
    """Ring stages of the rows kernel at a row tile (common.cuh
    ring_stages of plane_row_stage_bytes: a multiple of 3, at most 12; the
    kernel refuses fewer than 3)."""
    stage = plane_row_stage_bytes(bits, rows, scale_bytes, codes_in_tile, parts, elems)
    return min(12, PLANE_RING_BYTES // stage) // 3 * 3


def plane_slice_steps(bits: int, group: int, zs: bool = True, elems: int | None = None) -> int:
    """Main K steps of one zs slice of the rows kernel (32 groups at
    64-element steps, 16 at 32, and one zs step); without the zs term (K9b,
    K8) the K split's unit, 4 main steps (csrc/plane_gemv.cuh
    plane_slice_steps)."""
    if not zs:
        return 4
    e = plane_row_geom(bits, elems)[1]
    return (32 if e == 64 else 16) * group // e


def plane_rows_take(K: int, bits: int, group: int) -> bool:
    """Whether the rows kernel takes the shape: each group inside one plane
    ((K/per) % group == 0) and a power of two (a step's rows are then whole
    scale rows, or a scale row whole steps, and the kernel's index
    arithmetic is shifts)."""
    per = 8 // bits
    return (K // per) % group == 0 and group & (group - 1) == 0


def plane_dec_geom(bits: int) -> tuple[int, int, int]:
    """(planes of a byte row, byte rows of a K step, most scale rows a
    plane a step) of the decode kernel (csrc/plane_gemv.cuh PlaneDecGeom):
    64-row steps at 8 bits, 32 below, a scale row at most every 16 rows."""
    per = 8 // bits
    r = 64 if bits == 8 else 32
    return per, r, r // 16


def plane_dec_rows(bits: int, group: int) -> int:
    """Scale rows a plane of a decode step's box (csrc/plane_gemv.cuh
    plane_dec_rows): the most groups a step's rows can touch, rows starting
    at multiples of 16 in a group."""
    r = plane_dec_geom(bits)[1]
    if r % group == 0:
        return r // group
    if group % r == 0:
        return 1
    return (group - 16 + r - 1) // group + 1


def plane_dec_stage_weight_bytes(bits: int, cols: int, scale_bytes: int = 2,
                                 zs: bool = True) -> int:
    """The most weight bytes a decode stage holds (PlaneDecStage's
    kWeightBytes): a step's codes for `cols` columns, and its scale (and zs)
    rows at their most."""
    per, r, nr = plane_dec_geom(bits)
    return cols * r + per * nr * cols * (scale_bytes + (2 if zs else 0))


def plane_dec_plan(B: int, K: int, O: int, bits: int, group: int, sms: int, zs: bool = True,
                   scale_bytes: int = 2) -> GemvPlan:
    """The decode plan of K10 and K8 (csrc/plane_gemv.cuh plane_dec_kernel)
    up to 16 rows: K4's decode rules (_dec_grid) over ceil(Kp / R) steps of
    R byte rows (64 at 8 bits, 32 below), a ring stage a step; the ring's
    stages from the stage's most weight bytes (the scale at
    `scale_bytes`, zs with the zs term); no workspace. The scale and zs
    boxes see [K/group, O] as [planes][Kp/group][O], so a group must lie
    inside one plane (Kp % group == 0): a group that straddles two planes
    raises."""
    per, r, _ = plane_dec_geom(bits)
    kp = K // per
    _require(1 <= B <= 16, f"plane decode plan: 1-16 rows, got {B}")
    _require(group % 16 == 0 and kp % 32 == 0 and kp % group == 0,
             f"plane decode plan: needs group % 16 == 0, (K/(8/bits)) % 32 == 0 and a group "
             f"inside one plane ((K/(8/bits)) % group == 0); got K={K} bits={bits} group={group}")
    ks, cols, ctiles = _dec_grid(O, -(-kp // r), 1, sms)
    return GemvPlan(16, (ks, ctiles, 1), ks, ks, cols,
                    dec_stages(plane_dec_stage_weight_bytes(bits, cols, scale_bytes, zs)), 0)


def plane_gemv_plan(B: int, K: int, O: int, bits: int, group: int, sms: int,
                    zs: bool = True, codes_in_tile: bool = False, scale_bytes: int = 2,
                    parts: int = 1, elems: int | None = None) -> GemvPlan:
    """Launch plan of K10 (and, above 16 rows, of K9b and K8 with zs False,
    of K4 with codes_in_tile, of K5 with parts 2) on a card with `sms` SMs,
    every field of which the CUDA entry point checks.
    Up to 16 rows the decode plan (plane_dec_plan). Above: the rows kernel,
    64 or 128 rows a block, grid (row tiles, column tiles, K splits), row
    tiles fastest, so
    each weight tile is read by at most two blocks; K is split at zs slices
    (without zs: at 4 main steps) and only to fill one wave, no split
    empty; its ring's stages (plane_row_stages of the format's stage: the
    scale's width, K4's codes in the tile, K5's two parts, `elems` a step);
    the tiled workspace (per-group sums unless zs is False, x's copy in the
    kernel's step order unless x is read in place, at 8 bits without zs,
    partials with more than one split)."""
    per = 8 // bits
    kp = K // per
    ctiles = -(-O // 128)
    if B <= 16:
        return plane_dec_plan(B, K, O, bits, group, sms, zs, scale_bytes)
    rows = 64 if B <= 64 else 128
    rtiles = -(-B // rows)
    steps = kp // plane_row_geom(bits, elems)[2]
    slices = -(-steps // plane_slice_steps(bits, group, zs, elems))
    ks = max(1, min(sms // (rtiles * ctiles), slices))
    ks = -(-slices // -(-slices // ks))  # the same slices a split, none empty
    return GemvPlan(rows, (rtiles, ctiles, ks), ks, 1, 128,
                    plane_row_stages(bits, rows, scale_bytes, codes_in_tile, parts, elems),
                    _workspace_bytes(B, K, O, 0, group if zs else 0, ks, rows, "tiled",
                                     xcopy=per > 1 or zs))


def _affine_values(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Plane-major codes q [K*bits/8, O] -> uint8 [K, O] in element order
    (plane j of byte row r is element j*K*bits/8 + r); at 8 bits q holds
    one code a byte already."""
    if bits == 8:
        return q
    mask = (1 << bits) - 1
    return torch.cat([(q >> (bits * j)) & mask for j in range(8 // bits)], dim=0)


def affine_gemv_plain(x, q, scale, zs, bits: int, group: int, out_dtype=torch.float32):
    """Plain PyTorch version of K10 on any device, the ops of JAX's
    `_affine_kernel`: w = q * scale rounded to x's dtype, the product with
    f32 accumulation (x.float() @ w.float(), as the kernel's f32
    accumulators), then minus the per-group sums of x @ zs in f32."""
    w = _affine_values(q, bits).to(x.dtype) * torch.repeat_interleave(scale.to(x.dtype), group,
                                                                      dim=0)
    y = x.to(torch.float32) @ w.to(torch.float32)
    y -= _xsum(x, group) @ zs.to(torch.float32)
    return y.to(out_dtype)


def affine_gemv(x, q, scale, zs, bits: int, group: int, out_dtype=torch.bfloat16):
    """K10: y [B, O] = x @ W for W = q * scale[g] - zs[g] with plane-major
    codes of `bits` bits, the weight rounded to bf16 inside the kernel (see
    csrc/affine_gemv.cu). x [B, K] bf16 on cuda, q uint8 [K*bits/8, O],
    scale/zs [K/group, O] (bf16 on cuda). The kernels take group % 16 == 0
    and (K*bits/8) % 32 == 0. Up to 16 rows the decode instantiation
    (plane_dec_kernel: one launch, the K splits summed in a cluster), which
    also needs a group inside one plane ((K*bits/8) % group == 0); above 16
    rows the rows instantiation, which also takes plane_rows_take's rule;
    on the plan of plane_gemv_plan. Nothing of a call waits for the card
    or keeps state between calls, so it can be captured in a CUDA graph."""
    global affine_gemv_launches, affine_gemv_rows_launches
    _require(bits in AFFINE_BITS, f"affine_gemv: bits {bits} not in {AFFINE_BITS}")
    Kp, O = q.shape
    K = Kp * (8 // bits)
    B = _check_x("affine_gemv", x, K)
    _require(group % 16 == 0 and K % group == 0 and Kp % 32 == 0 and O % 16 == 0,
             f"affine_gemv: needs group % 16 == 0, K % group == 0, K*bits/8 % 32 == 0, "
             f"O % 16 == 0; got group={group} K={K} O={O} bits={bits}")
    _require(q.dtype == torch.uint8, f"q: dtype {q.dtype}, expected torch.uint8")
    _require(tuple(scale.shape) == tuple(zs.shape) == (K // group, O),
             f"scale/zs: shapes {tuple(scale.shape)} {tuple(zs.shape)}, expected {(K // group, O)}")
    _require(out_dtype in (torch.bfloat16, torch.float32), f"affine_gemv: out {out_dtype}")
    if x.device.type == "cpu":
        return affine_gemv_plain(x, q, scale, zs, bits, group, out_dtype)
    _require(x.dtype == torch.bfloat16, f"affine_gemv: the kernel takes bf16 x, got {x.dtype}")
    _check_tensor("scale", scale, torch.bfloat16, (K // group, O))
    _check_tensor("zs", zs, torch.bfloat16, (K // group, O))
    dev = _check_cuda("affine_gemv", dict(x=x, q=q, scale=scale, zs=zs))
    _require(Kp % group == 0 and (B <= 16 or plane_rows_take(K, bits, group)),
             f"affine_gemv: the kernels need a group inside one plane ((K/(8/bits)) % group == 0) "
             f"and, above 16 rows, a power-of-two group; got K={K} bits={bits} group={group}")
    plan = plane_gemv_plan(B, K, O, bits, group, kernels.sm_count(dev))
    ws = torch.empty(plan.ws_bytes, dtype=torch.uint8, device=dev)
    out = torch.empty(B, O, dtype=out_dtype, device=dev)
    fn = kernels.function("affine_gemv", "affine_gemv",
                          [_P] * 4 + [_I, _I, _P, ctypes.c_longlong, _P] + [_I] * 11 + [_P])
    err = fn(kernels.ptr(x), kernels.ptr(q), kernels.ptr(scale), kernels.ptr(zs), bits, group,
             kernels.ptr(ws), plan.ws_bytes, kernels.ptr(out), int(out_dtype == torch.bfloat16),
             B, K, O, *plan.launch_args(), _P(kernels.stream_ptr(dev)))
    kernels.check(err, "affine_gemv")
    if plan.rows == 16:
        affine_gemv_launches += 1
    else:
        affine_gemv_rows_launches += 1
    return out


# ------------------------------------------------------- K5: Q4_K x bf16


def q4k_bf16_gemv_plain(x, qs, scale, minv, out_dtype=torch.float32):
    """Plain PyTorch version of K5 on any device, the ops of JAX's
    `_q4k_kernel`: per 32-element sub-block the f32 dot of x with the
    nibbles (exact in x's dtype), times the sub-block's scale on the
    accumulator, then minus the per-32 sums of x (f32) @ minv."""
    q = torch.cat([qs & 0xF, qs >> 4], dim=0)  # [K, O] element order
    acc = _sub_block_sums(x, q, scale)
    acc -= _xsum(x, 32) @ minv.to(torch.float32)
    return acc.to(out_dtype)


# elements of a main step of K5's rows instantiation (csrc/q4k_bf16_gemv.cu
# kQ4kRowElems), where the 4-bit default is 64
Q4K_ROW_ELEMS = 32


def q4k_bf16_plan(B: int, K: int, O: int, sms: int) -> GemvPlan:
    """Launch plan of K5 on a card with `sms` SMs, every field of which the
    CUDA entry point checks: K10's 4-bit plan at group 32 with Q4_K's
    format (csrc/plane_gemv.cuh Q4kFmt: the paired nibbles are the 4-bit
    planes; the min term is the zs term). Up to 16 rows the decode plan
    (plane_dec_plan: grid (K splits, column tiles, 1), a cluster of the
    splits, no workspace; the kernel keeps the scale on the accumulator).
    Above: the rows plan with a stage of two decoded tiles, the weight's
    exact hi and lo parts. plane_rows_take(K, 4, 32) holds for every K %
    64 == 0, which the wrapper requires."""
    if B <= 16:
        return plane_dec_plan(B, K, O, 4, 32, sms)
    return plane_gemv_plan(B, K, O, 4, 32, sms, parts=2, elems=Q4K_ROW_ELEMS)


def q4k_bf16_gemv(x, qs, scale, minv, out_dtype=torch.bfloat16):
    """K5: y [B, O] = x @ W for Q4_K W with x kept in bf16 (see
    csrc/q4k_bf16_gemv.cu). x [B, K] bf16 on cuda, qs uint8 [K/2, O] paired
    nibbles, scale/minv [K/32, O] (bf16 on cuda). Up to 16 rows the decode
    instantiation (plane_dec_kernel with Q4kFmt: one launch, the nibble as
    the A operand and the scale on each sub-block's f32 dot, the K splits
    summed in a cluster), above it the rows instantiation (plane_rows_kernel
    with Q4kFmt: the weight q * s as two exact bf16 parts), on the plan of
    q4k_bf16_plan, each counted apart. Nothing of a call waits for the card
    or keeps state between calls, so it can be captured in a CUDA graph."""
    global q4k_bf16_gemv_launches, q4k_bf16_gemv_rows_launches
    O = qs.shape[1]
    K = 2 * qs.shape[0]
    B = _check_x("q4k_bf16_gemv", x, K)
    _require(K % 64 == 0 and O % 16 == 0,
             f"q4k_bf16_gemv: needs K % 64 == 0 and O % 16 == 0, got K={K} O={O}")
    _check_tensor("qs", qs, torch.uint8, (K // 2, O))
    _require(out_dtype in (torch.bfloat16, torch.float32), f"q4k_bf16_gemv: out {out_dtype}")
    if x.device.type == "cpu":
        return q4k_bf16_gemv_plain(x, qs, scale, minv, out_dtype)
    _require(x.dtype == torch.bfloat16, f"q4k_bf16_gemv: the kernel takes bf16 x, got {x.dtype}")
    _check_tensor("scale", scale, torch.bfloat16, (K // 32, O))
    _check_tensor("minv", minv, torch.bfloat16, (K // 32, O))
    dev = _check_cuda("q4k_bf16_gemv", dict(x=x, qs=qs, scale=scale, minv=minv))
    plan = q4k_bf16_plan(B, K, O, kernels.sm_count(dev))
    ws = torch.empty(plan.ws_bytes, dtype=torch.uint8, device=dev)
    out = torch.empty(B, O, dtype=out_dtype, device=dev)
    fn = kernels.function("q4k_bf16_gemv", "q4k_bf16_gemv",
                          [_P] * 5 + [ctypes.c_longlong, _P] + [_I] * 11 + [_P])
    err = fn(kernels.ptr(x), kernels.ptr(qs), kernels.ptr(scale), kernels.ptr(minv),
             kernels.ptr(ws), plan.ws_bytes, kernels.ptr(out), int(out_dtype == torch.bfloat16),
             B, K, O, *plan.launch_args(), _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q4k_bf16_gemv")
    if plan.rows == 16:
        q4k_bf16_gemv_launches += 1
    else:
        q4k_bf16_gemv_rows_launches += 1
    return out


# ------------------------------------------------------- K8: int8 x bf16


def q8_0_bf16_gemv_plain(x, q, s, out_dtype=torch.float32):
    """Plain PyTorch version of K8 on any device, the ops of JAX's
    `_q8_0_kernel`: w = q * s (scale group 32) formed in x's dtype, then the
    product with f32 accumulation (x.float() @ w.float())."""
    w = q8_0_dequant_plain(q, s, 32, x.dtype)
    return (x.to(torch.float32) @ w.to(torch.float32)).to(out_dtype)


def q8_0_bf16_plan(B: int, K: int, O: int, f32_scales: bool, sms: int) -> GemvPlan:
    """Launch plan of K8 on a card with `sms` SMs, every field of which the
    CUDA entry point checks: K10's plan at 8 bits, group 32 and no zs term,
    the scale at its width (4 bytes for rq8's f32 scales, 2 for wire Q8_0's
    bf16). Up to 16 rows the decode plan (plane_dec_plan: grid (K splits,
    column tiles, 1), a cluster of the splits, no workspace). Above: the
    rows kernel (K split at 4 main steps), its ring's stages at the scale's
    width, and a tiled workspace of the partials alone (at 8 bits the
    kernel reads x in place)."""
    return plane_gemv_plan(B, K, O, 8, 32, sms, zs=False, scale_bytes=4 if f32_scales else 2)


def q8_0_bf16_gemv(x, q, s, out_dtype=torch.bfloat16):
    """K8: y [B, O] = x @ W for int8 W with a scale per 32 rows, the weight
    rounded to bf16 inside the kernel (see csrc/q8_0_bf16_gemv.cu). x [B, K]
    bf16 on cuda, q int8 [K, O], s [K/32, O] f32 or bf16. Up to 16 rows the
    decode instantiation (plane_dec_kernel with PlaneFmt at 8 signed bits,
    K10's: one launch, the K splits summed in a cluster), above it the rows
    instantiation (plane_rows_kernel with the same format), on the plan of
    q8_0_bf16_plan, each counted apart. Nothing of a call waits for the
    card or keeps state between calls, so it can be captured in a CUDA
    graph."""
    global q8_0_bf16_gemv_launches, q8_0_bf16_gemv_rows_launches
    K, O = q.shape
    B = _check_x("q8_0_bf16_gemv", x, K)
    _require(K % 32 == 0 and O % 16 == 0,
             f"q8_0_bf16_gemv: needs K % 32 == 0 and O % 16 == 0, got K={K} O={O}")
    _check_tensor("q", q, torch.int8, (K, O))
    _require(tuple(s.shape) == (K // 32, O), f"s: shape {tuple(s.shape)}, expected {(K // 32, O)}")
    _require(out_dtype in (torch.bfloat16, torch.float32), f"q8_0_bf16_gemv: out {out_dtype}")
    if x.device.type == "cpu":
        return q8_0_bf16_gemv_plain(x, q, s, out_dtype)
    _require(x.dtype == torch.bfloat16, f"q8_0_bf16_gemv: the kernel takes bf16 x, got {x.dtype}")
    _require(s.dtype in (torch.float32, torch.bfloat16), f"s: dtype {s.dtype}")
    dev = _check_cuda("q8_0_bf16_gemv", dict(x=x, q=q, s=s))
    plan = q8_0_bf16_plan(B, K, O, s.dtype == torch.float32, kernels.sm_count(dev))
    ws = torch.empty(plan.ws_bytes, dtype=torch.uint8, device=dev)
    out = torch.empty(B, O, dtype=out_dtype, device=dev)
    fn = kernels.function("q8_0_bf16_gemv", "q8_0_bf16_gemv",
                          [_P, _P, _P, _I, _P, ctypes.c_longlong, _P] + [_I] * 11 + [_P])
    err = fn(kernels.ptr(x), kernels.ptr(q), kernels.ptr(s), int(s.dtype == torch.bfloat16),
             kernels.ptr(ws), plan.ws_bytes, kernels.ptr(out), int(out_dtype == torch.bfloat16),
             B, K, O, *plan.launch_args(), _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q8_0_bf16_gemv")
    if plan.rows == 16:
        q8_0_bf16_gemv_launches += 1
    else:
        q8_0_bf16_gemv_rows_launches += 1
    return out


# ------------------------------------------------------- K9b: Q5_K high bits x bf16


def q5k_hbit_bf16_gemv_plain(x, qh, scale, out_dtype=torch.float32):
    """Plain PyTorch version of K9b on any device, the ops of JAX's
    `_q5k_hbit_kernel`: w = hbit * scale in x's dtype (exact: hbit is 0 or
    1), then the product with f32 accumulation."""
    w = _affine_values(qh, 1).to(x.dtype) * torch.repeat_interleave(scale.to(x.dtype), 32, dim=0)
    return (x.to(torch.float32) @ w.to(torch.float32)).to(out_dtype)


def q5k_hbit_bf16_plan(B: int, K: int, O: int, sms: int) -> GemvPlan:
    """Launch plan of K9b's rows instantiation on a card with `sms` SMs,
    every field of which the CUDA entry point checks: the rows kernel at
    one bit, group 32 and no zs term (plane_gemv_plan with zs False), 17 to
    256 rows. Up to 16 rows there is no high-bit kernel: the whole Q5_K
    product is one kernel there (q5k_bf16_plan), and this plan raises."""
    _require(16 < B <= MAX_KERNEL_ROWS,
             f"q5k_hbit_bf16_plan: 17-{MAX_KERNEL_ROWS} rows, got {B} (up to 16 rows the "
             "Q5_K product is q5k_bf16_gemv)")
    return plane_gemv_plan(B, K, O, 1, 32, sms, zs=False)


def q5k_hbit_bf16_gemv(x, qh, scale, out_dtype=torch.bfloat16):
    """K9b's rows instantiation: yh [B, O] = sum_i x[:, i] * scale[i/32] *
    hbit[i] for the plane-major Q5_K high bits (see
    csrc/q5k_hbit_bf16_gemv.cu), the Q5_K product's term that q5k_matmul
    adds 16 times to K5's above 16 rows. x [B, K] bf16 on cuda, 17-256
    rows, qh uint8 [K/8, O], scale [K/32, O] (bf16 on cuda); on the plan of
    q5k_hbit_bf16_plan (a call of 1-16 rows raises on cuda)."""
    global q5k_hbit_bf16_gemv_rows_launches
    Kp, O = qh.shape
    K = 8 * Kp
    B = _check_x("q5k_hbit_bf16_gemv", x, K)
    _require(K % 256 == 0 and O % 16 == 0,
             f"q5k_hbit_bf16_gemv: needs K % 256 == 0 and O % 16 == 0, got K={K} O={O}")
    _require(qh.dtype == torch.uint8, f"qh: dtype {qh.dtype}, expected torch.uint8")
    _require(tuple(scale.shape) == (K // 32, O),
             f"scale: shape {tuple(scale.shape)}, expected {(K // 32, O)}")
    _require(out_dtype in (torch.bfloat16, torch.float32), f"q5k_hbit_bf16_gemv: out {out_dtype}")
    if x.device.type == "cpu":
        return q5k_hbit_bf16_gemv_plain(x, qh, scale, out_dtype)
    _require(x.dtype == torch.bfloat16,
             f"q5k_hbit_bf16_gemv: the kernel takes bf16 x, got {x.dtype}")
    _check_tensor("scale", scale, torch.bfloat16, (K // 32, O))
    dev = _check_cuda("q5k_hbit_bf16_gemv", dict(x=x, qh=qh, scale=scale))
    plan = q5k_hbit_bf16_plan(B, K, O, kernels.sm_count(dev))
    ws = torch.empty(plan.ws_bytes, dtype=torch.uint8, device=dev)
    out = torch.empty(B, O, dtype=out_dtype, device=dev)
    fn = kernels.function("q5k_hbit_bf16_gemv", "q5k_hbit_bf16_gemv",
                          [_P] * 4 + [ctypes.c_longlong, _P] + [_I] * 11 + [_P])
    err = fn(kernels.ptr(x), kernels.ptr(qh), kernels.ptr(scale), kernels.ptr(ws), plan.ws_bytes,
             kernels.ptr(out), int(out_dtype == torch.bfloat16), B, K, O, *plan.launch_args(),
             _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q5k_hbit_bf16_gemv")
    q5k_hbit_bf16_gemv_rows_launches += 1
    return out


# ------------------------------------------------------- K9b decode: Q5_K x bf16


def q5k_bf16_gemv_plain(x, qs, qh, scale, minv, out_dtype=torch.float32):
    """Plain PyTorch version of K9b's decode instantiation on any device,
    the ops of JAX's `_q5k_matmul_padded` with its gates off: K5's plain
    version on the nibbles (the nibble and min terms) and K9b's on the high
    bits, each rounded to out_dtype, added as y + 16 * yh in out_dtype."""
    y = q4k_bf16_gemv_plain(x, qs, scale, minv, out_dtype)
    return y + 16.0 * q5k_hbit_bf16_gemv_plain(x, qh, scale, out_dtype)


def q5k_bf16_plan(B: int, K: int, O: int, sms: int) -> GemvPlan:
    """Launch plan of K9b's decode instantiation (csrc/q5k_bf16_gemv.cu
    q5k_bf16_dec_kernel) on a card with `sms` SMs, every field of which the
    CUDA entry point checks: 1-16 rows; K9's decode geometry, K1's decode
    rules (_dec_grid) over K/256 steps of 256 elements (the 32 qh rows a
    step reads once), a ring stage a step, the ring's stages from the
    step's Q5K_STEP_COL_BYTES a column; no workspace (x is read in bf16 by
    TMA). Above 16 rows the route is K5's and K9b's rows instantiations."""
    _require(1 <= B <= 16, f"q5k_bf16_plan: 1-16 rows, got {B}")
    _require(K % 256 == 0, f"q5k_bf16_plan: needs K % 256 == 0, got K={K}")
    ks, cols, ctiles = _dec_grid(O, K // 256, 1, sms)
    return GemvPlan(16, (ks, ctiles, 1), ks, ks, cols, dec_stages(cols * Q5K_STEP_COL_BYTES), 0)


def q5k_bf16_gemv(x, qs, qh, scale, minv, out_dtype=torch.bfloat16):
    """K9b's decode instantiation: y [B, O] = x @ W for Q5_K W with x kept in
    bf16, 1-16 rows, in one launch (see csrc/q5k_bf16_gemv.cu): JAX's
    nibble-and-min sum and high-bit sum in f32, each rounded to out_dtype
    and added as y + 16 * yh, as `_q5k_matmul_padded` returns them. x [B,
    K] bf16 on cuda, qs uint8 [K/2, O] paired nibbles, qh uint8 [K/8, O]
    plane-major high bits, scale/minv [K/32, O] (bf16 on cuda); on the
    plan of q5k_bf16_plan. Nothing of a call waits for the card or keeps
    state between calls, so it can be captured in a CUDA graph."""
    global q5k_bf16_gemv_launches
    O = qs.shape[1]
    K = 2 * qs.shape[0]
    B = _check_x("q5k_bf16_gemv", x, K)
    _require(K % 256 == 0 and O % 16 == 0,
             f"q5k_bf16_gemv: needs K % 256 == 0 and O % 16 == 0, got K={K} O={O}")
    _check_tensor("qs", qs, torch.uint8, (K // 2, O))
    _check_tensor("qh", qh, torch.uint8, (K // 8, O))
    _require(out_dtype in (torch.bfloat16, torch.float32), f"q5k_bf16_gemv: out {out_dtype}")
    if x.device.type == "cpu":
        return q5k_bf16_gemv_plain(x, qs, qh, scale, minv, out_dtype)
    _require(x.dtype == torch.bfloat16, f"q5k_bf16_gemv: the kernel takes bf16 x, got {x.dtype}")
    _check_tensor("scale", scale, torch.bfloat16, (K // 32, O))
    _check_tensor("minv", minv, torch.bfloat16, (K // 32, O))
    dev = _check_cuda("q5k_bf16_gemv", dict(x=x, qs=qs, qh=qh, scale=scale, minv=minv))
    plan = q5k_bf16_plan(B, K, O, kernels.sm_count(dev))
    out = torch.empty(B, O, dtype=out_dtype, device=dev)
    fn = kernels.function("q5k_bf16_gemv", "q5k_bf16_gemv", [_P] * 6 + [_I] * 11 + [_P])
    err = fn(kernels.ptr(x), kernels.ptr(qs), kernels.ptr(qh), kernels.ptr(scale),
             kernels.ptr(minv), kernels.ptr(out), int(out_dtype == torch.bfloat16), B, K, O,
             *plan.launch_args(), _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q5k_bf16_gemv")
    q5k_bf16_gemv_launches += 1
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


def q6k_dequant_plain(ql, qh, scale, G: int, dtype):
    """[K, O] = (q - 32) * s16 in `dtype`, element order (the ops of the JAX
    package's dequant_q6k_weights, with its inverse-permutation gather
    replaced by _q6k_natural's reshape)."""
    q, s16 = _q6k_natural(ql, qh, scale, G)
    return ((q.to(torch.int32) - 32).to(dtype)
            * torch.repeat_interleave(s16.to(dtype), 16, dim=0))


def q6k_dequant(ql, qh, scale, G: int, dtype):
    """Chunked Q6_K layout -> dense [K, O] weight in element order
    (csrc/q6k_gemv.cu q6k_dequant on the card, bf16 for the prefill route
    or f32 for requant_q6k_to_q8; the plain version on the CPU)."""
    global q6k_dequant_launches
    K, O = 2 * ql.shape[0], ql.shape[1]
    if ql.device.type == "cpu":
        return q6k_dequant_plain(ql, qh, scale, G, dtype)
    _require(dtype in (torch.bfloat16, torch.float32) and G % 16 == 0 and K % (4 * G) == 0
             and O % 8 == 0, f"q6k_dequant: the kernel writes bf16 or f32 with G % 16 == 0, "
                             f"K % 4G == 0, O % 8 == 0; got {dtype} G={G} K={K} O={O}")
    _check_tensor("ql", ql, torch.uint8, (K // 2, O))
    _check_tensor("qh", qh, torch.uint8, (K // 4, O))
    _check_tensor("scale", scale, torch.bfloat16, (K // 16, O))
    dev = _check_cuda("q6k_dequant", dict(ql=ql, qh=qh, scale=scale))
    w = torch.empty(K, O, dtype=dtype, device=dev)
    fn = kernels.function("q6k_gemv", "q6k_dequant", [_P] * 4 + [_I] * 4 + [_P])
    err = fn(kernels.ptr(ql), kernels.ptr(qh), kernels.ptr(scale), kernels.ptr(w),
             int(dtype == torch.bfloat16), G, K, O, _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q6k_dequant")
    q6k_dequant_launches += 1
    return w


def q5k_dequant_plain(qs, qh, scale, minv, dtype):
    """[K, O] = (nib + 16*hbit) * scale - minv in `dtype` (the ops of the
    JAX package's dequant_q5k_weights, before its transpose)."""
    v = _q5k_values(qs, qh).to(dtype)
    return (v * torch.repeat_interleave(scale.to(dtype), 32, dim=0)
            - torch.repeat_interleave(minv.to(dtype), 32, dim=0))


def q5k_dequant(qs, qh, scale, minv, dtype):
    """Q5_K layout -> dense [K, O] weight (csrc/q5k_q8_gemv.cu q5k_dequant
    on the card, bf16 only; the plain version on the CPU)."""
    global q5k_dequant_launches
    K, O = 2 * qs.shape[0], qs.shape[1]
    if qs.device.type == "cpu":
        return q5k_dequant_plain(qs, qh, scale, minv, dtype)
    _require(dtype == torch.bfloat16 and K % 256 == 0 and O % 8 == 0,
             f"q5k_dequant: the kernel writes bf16 with K % 256 == 0, O % 8 == 0; "
             f"got {dtype} K={K} O={O}")
    _check_tensor("qs", qs, torch.uint8, (K // 2, O))
    _check_tensor("qh", qh, torch.uint8, (K // 8, O))
    _check_tensor("scale", scale, torch.bfloat16, (K // 32, O))
    _check_tensor("minv", minv, torch.bfloat16, (K // 32, O))
    dev = _check_cuda("q5k_dequant", dict(qs=qs, qh=qh, scale=scale, minv=minv))
    w = torch.empty(K, O, dtype=torch.bfloat16, device=dev)
    fn = kernels.function("q5k_q8_gemv", "q5k_dequant", [_P] * 5 + [_I] * 2 + [_P])
    err = fn(kernels.ptr(qs), kernels.ptr(qh), kernels.ptr(scale), kernels.ptr(minv),
             kernels.ptr(w), K, O, _P(kernels.stream_ptr(dev)))
    kernels.check(err, "q5k_dequant")
    q5k_dequant_launches += 1
    return w


def affine_dequant_plain(q, scale, zs, bits: int, group: int, dtype):
    """[K, O] = q * scale - zs in `dtype`, element order (the ops of the JAX
    package's dequant_q2k_weights, _gptq_weights and hqq_dequant_weights,
    before their transposes)."""
    return (_affine_values(q, bits).to(dtype) * torch.repeat_interleave(scale.to(dtype), group, dim=0)
            - torch.repeat_interleave(zs.to(dtype), group, dim=0))


def affine_dequant(q, scale, zs, bits: int, group: int, dtype):
    """Plane-major affine layout -> dense [K, O] weight (csrc/affine_gemv.cu
    affine_dequant on the card, bf16 only; the plain version on the CPU)."""
    global affine_dequant_launches
    Kp, O = q.shape
    K = Kp * (8 // bits)
    if q.device.type == "cpu":
        return affine_dequant_plain(q, scale, zs, bits, group, dtype)
    _require(dtype == torch.bfloat16 and bits in AFFINE_BITS and K % group == 0 and O % 8 == 0,
             f"affine_dequant: the kernel writes bf16 with bits in {AFFINE_BITS}, K % group == 0, "
             f"O % 8 == 0; got {dtype} bits={bits} group={group} K={K} O={O}")
    _check_tensor("q", q, torch.uint8, (Kp, O))
    _check_tensor("scale", scale, torch.bfloat16, (K // group, O))
    _check_tensor("zs", zs, torch.bfloat16, (K // group, O))
    dev = _check_cuda("affine_dequant", dict(q=q, scale=scale, zs=zs))
    w = torch.empty(K, O, dtype=torch.bfloat16, device=dev)
    fn = kernels.function("affine_gemv", "affine_dequant", [_P] * 4 + [_I] * 4 + [_P])
    err = fn(kernels.ptr(q), kernels.ptr(scale), kernels.ptr(zs), kernels.ptr(w), bits, group,
             K, O, _P(kernels.stream_ptr(dev)))
    kernels.check(err, "affine_dequant")
    affine_dequant_launches += 1
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
    gemv = q4k_q8_gemv if lin.int8_act else q4k_bf16_gemv
    y = gemv(x.reshape(n_rows, in_f).contiguous(), lin.data["qs"], lin.data["scale"],
             lin.data["minv"], out_dtype=x.dtype)
    return _add_bias(lin, y.reshape(*lead, out_f))


def q8_0_matmul(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    """Forward for kind 'gguf_q8_0' (wire Q8_0 or the rq8 requant layout;
    meta = scale group size, None = 32): K2 at group 32 or 64, or with
    int8_act off K8 at group 32; other groups, and more than 256 rows,
    dequantize + matmul."""
    from mistralrs_tpu_torch.quant.gguf_linear import _ref_forward

    in_f, out_f = lin.shape
    gs = lin.meta or 32
    lead = x.shape[:-1]
    n_rows = math.prod(lead)
    groups = (32, 64) if lin.int8_act else (32,)
    if n_rows > MAX_KERNEL_ROWS or gs not in groups or out_f % 16 or n_rows == 0:
        return _ref_forward(lin, x)
    x2 = x.reshape(n_rows, in_f).contiguous()
    if lin.int8_act:
        y = q8_0_q8_gemv(x2, lin.data["q"], lin.data["scale"], gs, out_dtype=x.dtype)
    else:
        y = q8_0_bf16_gemv(x2, lin.data["q"], lin.data["scale"], out_dtype=x.dtype)
    return _add_bias(lin, y.reshape(*lead, out_f))


def q5k_matmul(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    """Forward for kind 'gguf_q5k' (Q5_K, and Q5_0/Q5_1 packed into its
    layout). x [..., K] -> [..., O]. Up to 256 rows, when in % 256 == 0 and
    out % 16 == 0: K9 (the whole product in one kernel, where the JAX
    package runs K1 and its high-bit kernel), or with int8_act off the
    JAX package's `_q5k_matmul_padded` (the nibble-and-min sum and the
    high-bit sum, each rounded to x's dtype, added as y + 16 * yh in it):
    up to 16 rows in one kernel (`q5k_bf16_gemv`), above it K5 on the
    nibbles and K9b on the high bits and the add; else dequantize +
    matmul."""
    from mistralrs_tpu_torch.quant.gguf_linear import _ref_forward

    in_f, out_f = lin.shape
    lead = x.shape[:-1]
    n_rows = math.prod(lead)
    if n_rows > MAX_KERNEL_ROWS or in_f % 256 or out_f % 16 or n_rows == 0:
        return _ref_forward(lin, x)
    x2 = x.reshape(n_rows, in_f).contiguous()
    if lin.int8_act:
        y = q5k_q8_gemv(x2, lin.data["qs"], lin.data["qh"], lin.data["scale"], lin.data["minv"],
                        out_dtype=x.dtype)
    elif n_rows <= 16:
        y = q5k_bf16_gemv(x2, lin.data["qs"], lin.data["qh"], lin.data["scale"],
                          lin.data["minv"], out_dtype=x.dtype)
    else:
        y = q4k_bf16_gemv(x2, lin.data["qs"], lin.data["scale"], lin.data["minv"],
                          out_dtype=x.dtype)
        y = y + 16.0 * q5k_hbit_bf16_gemv(x2, lin.data["qh"], lin.data["scale"], out_dtype=x.dtype)
    return _add_bias(lin, y.reshape(*lead, out_f))


def q6k_matmul(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    """Forward for kind 'gguf_q6k' (Q6_K, and Q3_K packed into its layout).
    x [..., K] -> [..., O]; meta = the layout's chunk span G. Routes, the
    JAX package's q6k_matmul rules where they change the numbers:
    - at most 16 rows and G >= 256, with int8_act on: K3 (int8 activations);
    - otherwise, up to 256 rows and G >= 128: K4 (activations in x's dtype);
    - more than 256 rows, G < 128 or out % 16: dequantize + matmul.
    Both kernels read x in element order at every G."""
    from mistralrs_tpu_torch.quant.gguf_linear import _ref_forward

    in_f, out_f = lin.shape
    G = lin.meta
    lead = x.shape[:-1]
    n_rows = math.prod(lead)
    if n_rows > MAX_KERNEL_ROWS or G is None or G < 128 or out_f % 16 or n_rows == 0:
        return _ref_forward(lin, x)
    x2 = x.reshape(n_rows, in_f).contiguous()
    gemv = q6k_q8_gemv if lin.int8_act and n_rows <= 16 and G >= 256 else q6k_bf16_gemv
    y = gemv(x2, lin.data["ql"], lin.data["qh"], lin.data["scale"], G, out_dtype=x.dtype)
    return _add_bias(lin, y.reshape(*lead, out_f))


def affine_qmatmul(lin: Linear, x: torch.Tensor, *, bits: int, group: int, q_key: str = "q",
                   zs_key: str = "zs") -> torch.Tensor:
    """Forward of the plane-major affine kinds (gguf_q2k: bits 2, group 16,
    zs_key "minv"; gptq_2/4/8/b8 and hqq_1/2/3/4/8: bits 1, 2, 4 or 8 with
    byte-per-value codes at 8, group = in / scale rows). x [..., K] ->
    [..., O]. Routes:
    - up to 256 rows (the JAX package's row rule), K10 when
      in % (per*group) == 0 (per = 8 // bits: no group straddles two
      planes), out % 16 == 0, and the kernel's own group % 16 == 0 and
      (in / per) % 32 == 0 (every shape of the supported models has both);
      above 16 rows also when its rows instantiation takes the group
      (plane_rows_take: a power of two, as every grouped GPTQ and HQQ
      checkpoint and Q2_K have; a per-channel GPTQ-8 group of in rows
      that is not one takes the dequant route there);
    - otherwise affine_dequant + torch.matmul.
    The Mosaic-only rules of the JAX dispatcher (block_o >= 128, block_k %
    (8*group), block_k % 128, row padding to 8) are gone. The two routes
    differ in the last bits: K10 subtracts the zs term in f32, the dequant
    route folds it into a weight rounded to x's dtype."""
    in_f, out_f = lin.shape
    per = 8 // bits
    lead = x.shape[:-1]
    n_rows = math.prod(lead)
    q, scale, zs = lin.data[q_key], lin.data["scale"], lin.data[zs_key]
    if (0 < n_rows <= MAX_KERNEL_ROWS and in_f % (per * group) == 0 and out_f % 16 == 0
            and group % 16 == 0 and (in_f // per) % 32 == 0
            and (n_rows <= 16 or plane_rows_take(in_f, bits, group))):
        y = affine_gemv(x.reshape(n_rows, in_f).contiguous(), q, scale, zs, bits, group,
                        out_dtype=x.dtype)
        return _add_bias(lin, y.reshape(*lead, out_f))
    return _add_bias(lin, torch.matmul(x, affine_dequant(q, scale, zs, bits, group, x.dtype)))
