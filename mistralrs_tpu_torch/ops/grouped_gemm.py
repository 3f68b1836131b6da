"""The grouped GEMM of the dropless MoE dispatch, K13.

Counterpart of mistralrs_tpu/ops/grouped_gemm.py. `grouped_matmul(lhs, rhs,
group_sizes)` has the contract of the JAX function: lhs [M, K] with rows
sorted by group, rhs [G, K, N], group_sizes [G] int32 summing to M;
``out[m] = lhs[m] @ rhs[g(m)]`` with f32 accumulation, returned in lhs's
dtype. On a CUDA tensor it launches csrc/grouped_gemm.cu (the port of the
TPU library kernel megablox `gmm`) or raises; the plain version
`grouped_matmul_ref` serves tensors that lie on the CPU.

The JAX package has two exact backends behind `MISTRALRS_MOE_BACKEND`
(`lax.ragged_dot` and `gmm`); the port has one route, the kernel, and no
`backend` argument. The JAX `_gmm`'s padding of rows to the 128-row m-tile
is not ported: the kernel masks rows itself. group_sizes stays on the
device: both of the kernel's instantiations find their tiles on the card
(`grouped_gemm_plan` picks one from M, K, N and G alone), so nothing here
waits for the card.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from mistralrs_tpu_torch.ops import kernels

# launches of K13 (one per wrapper call that launched it), and of its tiles
# instantiation among them (the rest are the decode one)
grouped_gemm_launches = 0
grouped_gemm_tiles_launches = 0

# most groups the kernel's shared-memory table holds
MAX_GROUPS = 256

_P = ctypes.c_void_p
_I = ctypes.c_int


def grouped_matmul_ref(lhs: torch.Tensor, rhs: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K13, any device: per group, an f32 product
    of its rows, rounded to lhs's dtype. Reads the sizes on the host."""
    M, N = lhs.shape[0], rhs.shape[2]
    out = torch.zeros(M, N, dtype=torch.float32, device=lhs.device)
    start = 0
    for g, n in enumerate(group_sizes.tolist()):
        n = max(int(n), 0)
        stop = min(start + n, M)
        if stop > start:
            out[start:stop] = lhs[start:stop].float() @ rhs[g].float()
        start += n
    return out.to(lhs.dtype)


# the decode instantiation takes calls of at most this many rows a group on
# average
DECODE_MAX_AVG_ROWS = 32
# the tiles instantiation's column tile (csrc/grouped_gemm.cu's kBN)
TILES_BN = 256
# the ring's budget for the tiles instantiation's stages (csrc/common.cuh
# kRingBudget)
RING_BUDGET = 200 * 1024
KINDS = ("decode", "tiles")


@dataclasses.dataclass(frozen=True)
class GroupedPlan:
    """The launch of K13 (csrc/grouped_gemm.cu checks every field against
    its own constants and refuses any other plan). `kind` "decode": a block
    for each possible `bm`-row tile times each `bn`-column tile, a
    `stages`-deep cp.async ring of `bk` of K; "tiles": a persistent grid
    (`grid[0]` blocks, at most one an SM) walking the groups' `bm` x `bn`
    tiles, found on the card, through a TMA-fed ring of `stages` stages of
    `bk` of K. `smem_bytes`: dynamic shared memory a block."""

    kind: str
    bm: int
    bn: int
    bk: int
    stages: int
    threads: int
    grid: tuple[int, int, int]
    smem_bytes: int


def grouped_gemm_plan(M: int, K: int, N: int, G: int, sm_count: int) -> GroupedPlan:
    """K13's launch for lhs [M, K] over G groups of rhs [G, K, N] on a card
    with `sm_count` SMs, from the shapes alone (the group sizes stay on the
    card). Up to DECODE_MAX_AVG_ROWS rows a group on average the decode
    instantiation (16-row tiles: its grid is the most 16-row tiles group
    boundaries can make, ceil(M / 16) + G - 1, times N / 128 column tiles);
    above it the tiles one (128-row tiles, TILES_BN columns, 64 of K a
    stage, as many stages as RING_BUDGET holds; the grid is the SM count or
    the most tiles group boundaries can make, whichever is less). Shared
    memory of the tiles kernel: the stages and three 8-byte mbarriers each,
    each consumer warp's 16 x 64 bf16 epilogue buffer, the group tables (3
    x 256 ints and 4), and 1024 bytes to align the ring to the 128-byte
    swizzle's period."""
    if M < 1 or K < 1 or N < 1 or not 1 <= G <= MAX_GROUPS or sm_count < 1:
        raise ValueError(f"grouped_gemm_plan: nothing to launch for M={M} K={K} N={N} G={G} "
                         f"on {sm_count} SMs")
    if M <= DECODE_MAX_AVG_ROWS * G:
        bm, bn, bk, stages = 16, 128, 32, 4
        return GroupedPlan("decode", bm, bn, bk, stages, 128,
                           (-(-N // bn), -(-M // bm) + G - 1, 1),
                           stages * (bm * bk * 2 + bk * bn * 2))
    bm, bn, bk = 128, TILES_BN, 64
    stage = bm * bk * 2 + bk * bn * 2
    stages = RING_BUDGET // stage
    tiles = min(-(-M // bm) + G - 1, M) * -(-N // bn)
    smem = stages * (stage + 3 * 8) + 8 * 16 * 128 + 4 * (3 * MAX_GROUPS + 4) + 1024
    return GroupedPlan("tiles", bm, bn, bk, stages, 384, (min(sm_count, tiles), 1, 1), smem)


def launch_args(plan: GroupedPlan) -> tuple[int, ...]:
    """The plan as the C entry point takes and checks it."""
    return (KINDS.index(plan.kind), plan.bm, plan.bn, plan.bk, plan.stages, plan.threads,
            *plan.grid, plan.smem_bytes)


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """K13: ``out[g_start:g_end] = lhs[g_start:g_end] @ rhs[g]`` for each
    group g. lhs [M, K] rows sorted by group; rhs [G, K, N]; group_sizes [G]
    int32 summing to M. Returns [M, N] in lhs's dtype (f32 accumulation).
    On the card: bf16 lhs and rhs, contiguous, K % 32 == 0, N % 8 == 0, at
    most 256 groups."""
    global grouped_gemm_launches, grouped_gemm_tiles_launches
    if lhs.dim() != 2 or rhs.dim() != 3 or rhs.shape[1] != lhs.shape[1] \
            or tuple(group_sizes.shape) != (rhs.shape[0],):
        raise ValueError(f"grouped_matmul: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}")
    if all(t.device.type == "cpu" for t in (lhs, rhs, group_sizes)):
        return grouped_matmul_ref(lhs, rhs, group_sizes)
    M, K = lhs.shape
    G, _, N = rhs.shape
    for nm, t in (("lhs", lhs), ("rhs", rhs), ("group_sizes", group_sizes)):
        if t.device.type != "cuda" or t.device != lhs.device:
            raise ValueError(f"grouped_matmul: {nm} on {t.device}, expected one cuda device")
    for nm, t in (("lhs", lhs), ("rhs", rhs)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"grouped_matmul: {nm} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"grouped_matmul: {nm} must be contiguous and 16-byte aligned")
    if group_sizes.dtype != torch.int32:
        raise ValueError(f"grouped_matmul: group_sizes is {group_sizes.dtype}; expected int32")
    if K % 32 or N % 8 or not 1 <= G <= MAX_GROUPS:
        raise ValueError(f"grouped_matmul: needs K % 32 == 0, N % 8 == 0 and 1 <= G <= "
                         f"{MAX_GROUPS}; got K={K} N={N} G={G}")
    out = torch.empty(M, N, dtype=torch.bfloat16, device=lhs.device)
    if M == 0:
        return out
    sizes = group_sizes.contiguous()
    plan = grouped_gemm_plan(M, K, N, G, kernels.sm_count(lhs.device))
    fn = kernels.function("grouped_gemm", "grouped_gemm", [_P] * 4 + [_I] * 14 + [_P])
    err = fn(kernels.ptr(lhs), kernels.ptr(rhs), kernels.ptr(sizes), kernels.ptr(out), M, K, N,
             G, *launch_args(plan), _P(kernels.stream_ptr(lhs.device)))
    kernels.check(err, "grouped_matmul")
    grouped_gemm_launches += 1
    grouped_gemm_tiles_launches += plan.kind == "tiles"
    return out
