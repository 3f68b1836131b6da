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
device: the kernel's grid is the most row tiles that group boundaries can
make, so nothing here waits for the card.
"""

from __future__ import annotations

import ctypes

import torch

from mistralrs_tpu_torch.ops import kernels

# launches of K13 (one per wrapper call that launched it)
grouped_gemm_launches = 0

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


def _tile_rows(M: int, G: int) -> int:
    """The kernel's rows a block by the average rows a group: one m16 tile
    at decode, 128 rows once a group has a few hundred."""
    avg = M / G
    return 16 if avg <= 32 else 64 if avg <= 128 else 128


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """K13: ``out[g_start:g_end] = lhs[g_start:g_end] @ rhs[g]`` for each
    group g. lhs [M, K] rows sorted by group; rhs [G, K, N]; group_sizes [G]
    int32 summing to M. Returns [M, N] in lhs's dtype (f32 accumulation).
    On the card: bf16 lhs and rhs, contiguous, K % 32 == 0, N % 8 == 0, at
    most 256 groups."""
    global grouped_gemm_launches
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
    fn = kernels.function("grouped_gemm", "grouped_gemm", [_P] * 4 + [_I] * 5 + [_P])
    err = fn(kernels.ptr(lhs), kernels.ptr(rhs), kernels.ptr(sizes), kernels.ptr(out), M, K, N,
             G, _tile_rows(M, G), _P(kernels.stream_ptr(lhs.device)))
    kernels.check(err, "grouped_matmul")
    grouped_gemm_launches += 1
    return out
