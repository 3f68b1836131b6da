"""First-chunk prefill with a logit soft cap or a clipping sliding window
(kernel K11).

Counterpart of mistralrs_tpu/ops/splash.py::splash_prefill, which runs the
library Pallas splash kernel on the first prompt chunks the plain flash
kernel K6 rejects: Gemma-2's logit soft cap (with its alternating local and
global layers) and sliding windows that clip inside the chunk. As there, the
chunk's own K/V is its whole context, so no paged gather is needed and the
[B, Hq, T, T] score matrix is never written to memory.

Layouts are the decoder's: q [B, T, Hq, D], k/v [B, T, Hkv, D]; query head
h reads kv head h // (Hq/Hkv) directly, without repeating K/V. The caller
picks the window per layer (None on global layers). As the JAX function
does, the scale is folded into q in q's dtype and the soft cap applies to
the scaled logits before the mask. The kernel (csrc/splash_prefill.cu, on
the Hopper attention core of csrc/flash_sm90.cuh in K12's chunk
configuration) takes bf16 with D = 128 or 256 and any T; the softmax runs
in f32. Its launch is `splash_plan`. `splash_prefill` takes the plain
version below when (and only when) its tensors lie on the CPU; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from mistralrs_tpu_torch.ops import kernels
from mistralrs_tpu_torch.ops.attention import NEG_INF
from mistralrs_tpu_torch.ops.flash_attention import FlashPlan, chunk_core, launch_args

# launches of the kernel (one per wrapper call that launched it)
splash_prefill_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def splash_plan(B: int, T: int, Hq: int, Hkv: int, D: int, sms: int) -> FlashPlan:
    """The launch of K11 (csrc/splash_prefill.cu refuses any other) for q
    [B, T, Hq, D] against Hkv kv heads on a card with `sms` SMs: K6's work
    items, 128 query rows of one (row, head), B * Hq * ceil(T / 128) of
    them, walked by a persistent grid (one block an SM, at most one an
    item) through the ring of K12's chunk configuration (chunk_core)."""
    if D not in (128, 256):
        raise ValueError(f"splash_plan: head dim {D}; the kernel takes 128 or 256")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"splash_plan: {Hq} query heads on {Hkv} kv heads")
    if B < 1 or T < 1 or sms < 1:
        raise ValueError(f"splash_plan: nothing to launch for B={B} T={T} on {sms} SMs")
    keys, stages, smem = chunk_core(D)
    items = B * Hq * -(-T // 128)
    return FlashPlan(128, keys, stages, 384, items, (min(sms, items), 1, 1), smem)


def splash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                         sliding_window: int | None = None,
                         logits_softcap: float | None = None) -> torch.Tensor:
    """Plain PyTorch version: masked f32 einsum/softmax, any device."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qs = q * torch.tensor(scale, dtype=q.dtype)
    qg = qs.to(torch.float32).reshape(B, T, Hkv, G, D)
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.to(torch.float32))
    if logits_softcap is not None:
        s = logits_softcap * torch.tanh(s / logits_softcap)
    t = torch.arange(T, device=q.device)
    keep = t[None, :] <= t[:, None]
    if sliding_window is not None:
        keep &= t[None, :] > t[:, None] - sliding_window
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p, v.to(torch.float32))
    return o.reshape(B, T, Hq, D).to(q.dtype)


def splash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                   sliding_window: int | None = None,
                   logits_softcap: float | None = None) -> torch.Tensor:
    """Causal attention of a first prefill chunk, query t keeping keys
    t - (sliding_window - 1) .. t, with logits soft-capped as cap * tanh(s /
    cap) when logits_softcap is given -> [B, T, Hq, D] in q's dtype."""
    global splash_prefill_launches
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if not (k.shape == v.shape == (B, T, Hkv, D) and Hkv >= 1 and Hq % Hkv == 0):
        raise ValueError(f"splash_prefill: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} are not [B,T,Hq,D] / [B,T,Hkv,D] with Hq % Hkv == 0")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"splash_prefill: sliding window {sliding_window}; expected >= 1")
    if logits_softcap is not None and not logits_softcap > 0:
        raise ValueError(f"splash_prefill: soft cap {logits_softcap}; expected > 0")
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return splash_prefill_plain(q, k, v, scale=scale, sliding_window=sliding_window,
                                    logits_softcap=logits_softcap)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"splash_prefill: {name} on {t.device}, expected one cuda device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"splash_prefill: {name} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"splash_prefill: {name} must be contiguous and 16-byte aligned")
    if D not in (128, 256):
        raise ValueError(f"splash_prefill: head dim {D}; the kernel takes 128 or 256")
    out = torch.empty_like(q)
    if T == 0 or B == 0:
        return out
    plan = splash_plan(B, T, Hq, Hkv, D, kernels.sm_count(q.device))
    fn = kernels.function("splash_prefill", "splash_prefill",
                          [_P] * 4 + [_I] * 6 + [_F, _F] + [_I] * 8 + [_P])
    err = fn(kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(out), B, T, Hq, Hkv, D,
             min(sliding_window or 0, T), float(scale), float(logits_softcap or 0.0),
             *launch_args(plan), _P(kernels.stream_ptr(q.device)))
    kernels.check(err, "splash_prefill")
    splash_prefill_launches += 1
    return out
