"""Causal flash attention for first prefill chunks (kernel K6).

Counterpart of the library Pallas kernel
`jax.experimental.pallas.ops.tpu.flash_attention` that
mistralrs_tpu/models/decoder.py::_attention calls on a first prompt chunk:
the chunk's own K/V is its whole context, so no paged gather is needed and
the [B, Hq, T, T] score matrix is never written to memory.

Layouts are the decoder's: q [B, T, Hq, D], k/v [B, T, Hkv, D]; query head
h reads kv head h // (Hq/Hkv) directly, without repeating K/V. The kernel
(csrc/flash_prefill.cu, on the Hopper attention core of csrc/flash_sm90.cuh
that K6' shares) takes bf16 with D = 128 and any T; the softmax runs in
f32. Its launch, and K6''s, is `flash_plan`. `flash_prefill` takes the plain
version below when (and only when) its tensors lie on the CPU; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from mistralrs_tpu_torch.ops import kernels
from mistralrs_tpu_torch.ops.attention import NEG_INF

# launches of the kernel (one per wrapper call that launched it)
flash_prefill_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """The launch of K6 or K6' (csrc/flash_sm90.cuh::plan_fits refuses one
    that is not its core's): a work item is `rows` query rows of one (row,
    head), `items` of them; a block of `threads` (two consumer warpgroups
    and a producer) walks its items' `key_tile`-key tiles through a ring of
    `stages` K/V stages; the grid (one block an SM, at most one an item) is
    persistent: block x takes items x, x + grid[0], ...
    (csrc/flash_sm90.cuh::item_at)."""

    rows: int
    key_tile: int
    stages: int
    threads: int
    items: int
    grid: tuple[int, int, int]
    smem_bytes: int


def flash_plan(B: int, T: int, Hq: int, Hkv: int, D: int, sms: int) -> FlashPlan:
    """The launch plan of K6 and K6' for q [B, T, Hq, D] against Hkv kv
    heads on a card with `sms` SMs. Shared memory: the ring's stages
    (a K and a V tile of 128 x D bf16 each, and three 8-byte mbarriers),
    the Q tile and its 8-byte barrier (16 bytes), and 1024 bytes to align
    the start to the 128-byte swizzle's period."""
    if D != 128:
        raise ValueError(f"flash_plan: head dim {D}; the kernels take 128")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_plan: {Hq} query heads on {Hkv} kv heads")
    if B < 1 or T < 1 or sms < 1:
        raise ValueError(f"flash_plan: nothing to launch for B={B} T={T} on {sms} SMs")
    rows = keys = 128
    stages = 3
    tile = keys * D * 2
    items = Hq * B * -(-T // rows)
    return FlashPlan(rows, keys, stages, 384, items, (min(sms, items), 1, 1),
                     stages * (2 * tile + 3 * 8) + rows * D * 2 + 16 + 1024)


def chunk_core(D: int) -> tuple[int, int, int]:
    """(key tile, stages, shared memory bytes) of K11's and K12's chunk
    configuration of the core (csrc/flash_sm90.cuh ChunkCore, a stage's K
    and V freed apart): D 128 128-key tiles in 3 stages, D 256 64-key tiles
    in 2. Shared memory: the stages (a K and a V tile of key_tile x D bf16
    and four 8-byte mbarriers each), the Q tile of 128 x D bf16 and its
    8-byte barrier (16 bytes), and 1024 bytes to align the start to the
    128-byte swizzle's period."""
    keys, stages = (128, 3) if D == 128 else (64, 2)
    return keys, stages, stages * (2 * keys * D * 2 + 4 * 8) + 128 * D * 2 + 16 + 1024


def launch_args(plan: FlashPlan) -> tuple[int, ...]:
    """The plan as the C entry points take and check it."""
    return (plan.rows, plan.key_tile, plan.stages, plan.threads, *plan.grid, plan.smem_bytes)


def check_scale(name: str, scale: float) -> None:
    """The kernels take the running max over raw scores, which needs a
    positive scale."""
    if not scale > 0:
        raise ValueError(f"{name}: scale {scale}; the kernel takes a positive scale")


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Plain PyTorch version: masked f32 einsum/softmax, any device."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.to(torch.float32).reshape(B, T, Hkv, G, D)
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.to(torch.float32)) * scale
    keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p, v.to(torch.float32))
    return o.reshape(B, T, Hq, D).to(q.dtype)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Causal attention of a first prefill chunk -> [B, T, Hq, D] in q's dtype."""
    global flash_prefill_launches
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if not (k.shape == v.shape == (B, T, Hkv, D) and Hkv >= 1 and Hq % Hkv == 0):
        raise ValueError(f"flash_prefill: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} are not [B,T,Hq,D] / [B,T,Hkv,D] with Hq % Hkv == 0")
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_prefill_plain(q, k, v, scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_prefill: {name} on {t.device}, expected one cuda device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_prefill: {name} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_prefill: {name} must be contiguous and 16-byte aligned")
    if D != 128:
        raise ValueError(f"flash_prefill: head dim {D}; the kernel takes 128")
    check_scale("flash_prefill", scale)
    out = torch.empty_like(q)
    if T == 0 or B == 0:
        return out
    plan = flash_plan(B, T, Hq, Hkv, D, kernels.sm_count(q.device))
    fn = kernels.function("flash_prefill", "flash_prefill",
                          [_P] * 4 + [_I] * 4 + [ctypes.c_float] + [_I] * 8 + [_P])
    err = fn(kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(out), B, T, Hq, Hkv,
             float(scale), *launch_args(plan), _P(kernels.stream_ptr(q.device)))
    kernels.check(err, "flash_prefill")
    flash_prefill_launches += 1
    return out
