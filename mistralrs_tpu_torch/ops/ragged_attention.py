"""The ragged attention backend: the combined K/V pool and the ragged paged
attention kernel K12.

Counterpart of mistralrs_tpu/ops/ragged_attention.py: `write_combined_kv`,
`split_combined`, `combine_kv`, `flatten_queries`, `pack_ragged_meta`,
`ragged_attention_padded` and `ragged_attention`. One combined pool per
layer, [P, page, 2*Hkv, D] with K at the even and V at the odd head indices
(token-major), serves every continuation chunk and every decode step
through one kernel, with the sliding window and the logit soft cap applied
inside it.

The kernel's contract is that of the TPU library kernel
`ragged_paged_attention`: queries packed as rows [N, Hq, D], sequence i
owning rows cu_q_lens[i] .. cu_q_lens[i+1] for i < num_seqs; it reads its
kv_lens[i] keys through page_indices[i], and its query j sits at position
kv_lens[i] - q_len + j. The wrapper `ragged_attention` launches
csrc/ragged_attention.cu on a CUDA tensor (or raises on what it does not
take) and takes the plain version `ragged_attention_plain` only when the
tensors lie on the CPU.

Unlike the JAX functions, `write_combined_kv` writes the pool IN PLACE
(and returns it). The packing builds its stable partition from a cumsum and
a scatter, so nothing on the card path waits for the device.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from mistralrs_tpu_torch.ops import kernels
from mistralrs_tpu_torch.ops.flash_attention import FlashPlan, check_scale, chunk_core, launch_args

# launches of K12 (one per wrapper call that launched it), and of its chunk
# instantiation among them
ragged_attention_launches = 0
ragged_chunk_launches = 0

# the TPU reference's mask value: a large finite negative, so that a masked
# score never makes a NaN
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_P = ctypes.c_void_p
_I = ctypes.c_int


def write_combined_kv(pool: torch.Tensor, new_k: torch.Tensor, new_v: torch.Tensor,
                      slot_mapping: torch.Tensor) -> torch.Tensor:
    """reshape_and_cache into one layer's combined pool [P, page, 2*Hkv, D],
    in place (padding slots hit page 0); returns the pool."""
    P, page, H2, D = pool.shape
    idx = slot_mapping.reshape(-1).to(torch.int64)
    inter = torch.stack([new_k, new_v], dim=3).reshape(-1, H2, D).to(pool.dtype)
    pool.view(P * page, H2, D).index_copy_(0, idx, inter)
    return pool


def split_combined(pool: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Combined pool -> (k, v) token-major views [.., page, Hkv, D] (strided
    head slices, no copy)."""
    return pool[..., 0::2, :], pool[..., 1::2, :]


def combine_kv(k_hm: torch.Tensor, v_hm: torch.Tensor) -> torch.Tensor:
    """Head-major per-layer pools [Hkv, P, page, D] -> a combined pool
    [P, page, 2*Hkv, D] (a copy; tests and benchmarks only)."""
    k = k_hm.permute(1, 2, 0, 3)
    v = v_hm.permute(1, 2, 0, 3)
    P, page, Hkv, D = k.shape
    return torch.stack([k, v], dim=3).reshape(P, page, 2 * Hkv, D)


def _partition(valid: torch.Tensor) -> torch.Tensor:
    """Indices of the True entries of a flat mask, in order, followed by
    zeros (jnp.nonzero(valid, size=len, fill_value=0) without a host sync)."""
    n = valid.shape[0]
    dest = torch.where(valid, torch.cumsum(valid.to(torch.int64), 0) - 1, n)
    buf = torch.zeros(n + 1, dtype=torch.int64, device=valid.device)
    buf.scatter_(0, dest, torch.arange(n, device=valid.device))
    return buf[:n]


def _valid(q_lens: torch.Tensor, T: int) -> torch.Tensor:
    """Which of the B*T padded query rows are a row's real queries."""
    return (torch.arange(T, device=q_lens.device)[None, :] < q_lens[:, None]).reshape(-1)


def _cu(q_lens: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros(1, dtype=torch.int32, device=q_lens.device)
    return torch.cat([zero, torch.cumsum(q_lens.to(torch.int32), 0).to(torch.int32)])


def flatten_queries(q: torch.Tensor, q_lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded per-row queries [B, T, Hq, D] and valid lengths [B] -> (flat
    [B*T, Hq, D], cu_q_lens [B+1]): each row's valid queries contiguous and
    in order, then copies of row 0 (the kernel never reads them)."""
    B, T, Hq, D = q.shape
    return q.reshape(B * T, Hq, D)[_partition(_valid(q_lens, T))], _cu(q_lens)


@dataclasses.dataclass
class RaggedPlan:
    """What packing a padded [B, T] step into the kernel's convention needs,
    the same for every layer of the step: cu_q_lens [B+1], kv_lens [B] and
    num_seqs [1] (int32, the kernel's arguments), q_lens [B], and the
    gather (`rows`) and scatter-back (`back`) indices with the valid mask of
    the B*T padded rows."""

    cu_q_lens: torch.Tensor
    kv_lens: torch.Tensor
    num_seqs: torch.Tensor
    q_lens: torch.Tensor
    rows: torch.Tensor
    back: torch.Tensor
    valid: torch.Tensor


def ragged_plan(meta, T: int, page: int) -> RaggedPlan:
    """The packing of a padded PagedAttnMeta step of T query rows a sequence.

    q_lens counts each row's real tokens (padding slots point into page 0);
    num_seqs counts the live rows, which precede the padding rows. The
    meta's kv_lens use the padded-width convention (start + T); the kernel
    places query i at kv_len - q_len + i, so the padding T - q_len comes off
    (clamped to 1)."""
    q_lens = (meta.slot_mapping // page != 0).sum(dim=1).to(torch.int32)
    num_seqs = (meta.active > 0).sum().to(torch.int32).reshape(1)
    kv_lens = torch.clamp(meta.kv_lens.to(torch.int32) - (T - q_lens), min=1)
    valid = _valid(q_lens, T)
    back = torch.where(valid, torch.cumsum(valid.to(torch.int64), 0) - 1, 0)
    return RaggedPlan(cu_q_lens=_cu(q_lens), kv_lens=kv_lens, num_seqs=num_seqs, q_lens=q_lens,
                      rows=_partition(valid), back=back, valid=valid)


def pack_ragged_meta(q: torch.Tensor, meta, page: int):
    """Padded PagedAttnMeta batch -> the kernel's ragged convention:
    (q_flat, cu_q_lens, kv_lens, num_seqs, q_lens)."""
    B, T, Hq, D = q.shape
    plan = ragged_plan(meta, T, page)
    q_flat = q.reshape(B * T, Hq, D)[plan.rows]
    return q_flat, plan.cu_q_lens, plan.kv_lens, plan.num_seqs, plan.q_lens


def ragged_attention_padded(q: torch.Tensor, pool: torch.Tensor, meta, *, scale: float,
                            sliding_window: int | None = None,
                            logits_softcap: float | None = None,
                            plan: RaggedPlan | None = None) -> torch.Tensor:
    """The decoder-facing call: packs the padded batch q [B, T, Hq, D] into
    the kernel's ragged convention, attends over one layer's combined pool,
    and scatters the output back to [B, T, Hq, D]; padding tokens give
    zeros. `plan` (ragged_plan of this step) saves repacking the metadata
    in every layer."""
    B, T, Hq, D = q.shape
    if plan is None:
        plan = ragged_plan(meta, T, pool.shape[1])
    q_flat = q.reshape(B * T, Hq, D)[plan.rows]
    out_flat = ragged_attention(q_flat, pool, plan.kv_lens, meta.block_tables, plan.cu_q_lens,
                                plan.num_seqs, scale=scale, sliding_window=sliding_window,
                                logits_softcap=logits_softcap, max_q_len=T)
    out = torch.where(plan.valid[:, None, None], out_flat[plan.back], 0.0)
    return out.to(q.dtype).reshape(B, T, Hq, D)


# ------------------------------------------------------------- the kernel


def ragged_attention_plain(q_flat: torch.Tensor, kv_pages: torch.Tensor, kv_lens: torch.Tensor,
                           page_indices: torch.Tensor, cu_q_lens: torch.Tensor,
                           num_seqs: torch.Tensor, *, scale: float,
                           sliding_window: int | None = None,
                           logits_softcap: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of K12, any device; what the TPU library's
    ref_ragged_paged_attention computes: per sequence, f32 scores times the
    scale, then cap * tanh(s / cap), then the mask (causal at kv_len - q_len
    + i; with a window w a key k is dropped when q - w >= k), softmax in
    f32, the probabilities in the pool's dtype for P.V. Rows past
    cu_q_lens[num_seqs] are zeros."""
    N, Hq, D = q_flat.shape
    H2 = kv_pages.shape[2]
    G = Hq // (H2 // 2)
    out = torch.zeros_like(q_flat)
    cu, lens = cu_q_lens.tolist(), kv_lens.tolist()
    for i in range(int(num_seqs.reshape(-1)[0])):
        q0, q1, kv_len = cu[i], cu[i + 1], lens[i]
        if q1 <= q0:
            continue
        kv = kv_pages[page_indices[i].to(torch.int64)].reshape(-1, H2, D)[:kv_len]
        k = kv[:, 0::2].repeat_interleave(G, dim=1)
        v = kv[:, 1::2].repeat_interleave(G, dim=1)
        s = torch.einsum("qhd,khd->hqk", q_flat[q0:q1].float(), k.float()) * scale
        q_pos = kv_len - (q1 - q0) + torch.arange(q1 - q0, device=s.device)[:, None]
        k_pos = torch.arange(kv.shape[0], device=s.device)[None, :]
        mask = q_pos < k_pos
        if sliding_window is not None:
            mask |= q_pos - sliding_window >= k_pos
        if logits_softcap is not None:
            s = logits_softcap * torch.tanh(s / logits_softcap)
        s = s + torch.where(mask, MASK_VALUE, 0.0)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        out[q0:q1] = torch.einsum("hqk,khd->qhd", p.float(), v.float()).to(out.dtype)
    return out


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


# the CTAs of each head dim that fit on an SM at once in the decode kernel
# (68 KB of shared memory each at D = 128, 136 KB at D = 256)
_DECODE_CTAS_PER_SM = {128: 2, 256: 1}


def _decode_grid(Hkv: int, span: int, D: int, device) -> tuple[int, int]:
    """(most splits, CTAs) of the decode kernel: one wave of the card's SMs.
    The kernel splits each live (sequence, kv head) pair's keys min(most,
    CTAs // (num_seqs * Hkv)) ways, reading num_seqs on the device, so the
    wave is full however many of the slots are live; the most is what one
    live sequence would take, at least one 64-key tile a split."""
    ctas = _DECODE_CTAS_PER_SM[D] * kernels.sm_count(device)
    return max(1, min(-(-span // 64), ctas // Hkv)), ctas


def ragged_chunk_plan(B: int, max_q_len: int, Hq: int, Hkv: int, D: int, page: int,
                      sms: int) -> FlashPlan:
    """The launch of K12's chunk instantiation (csrc/ragged_attention.cu
    ::launch_chunk refuses any other) for B sequences of at most max_q_len
    queries, Hq query heads on Hkv kv heads of dim D, a pool of `page`-slot
    pages, on a card with `sms` SMs. A work item is 128 (query, head) rows
    of one sequence and one kv head (128/G queries of its G = Hq/Hkv query
    heads), B * Hkv * ceil(max_q_len / (128/G)) of them; the persistent
    grid (one block an SM, at most one an item) walks them through the
    ring of the core's chunk configuration (flash_attention.chunk_core)."""
    if D not in (128, 256):
        raise ValueError(f"ragged_chunk_plan: head dim {D}; the kernel takes 128 or 256")
    if Hkv < 1 or Hq % Hkv or (Hq // Hkv) & (Hq // Hkv - 1) or Hq // Hkv > 16:
        raise ValueError(f"ragged_chunk_plan: {Hq} query heads on {Hkv} kv heads; the kernel "
                         "takes a power of two up to 16 a kv head")
    if page < 1 or page & (page - 1):
        raise ValueError(f"ragged_chunk_plan: page size {page}; the kernel takes a power of two")
    if B < 1 or max_q_len < 1 or sms < 1:
        raise ValueError(f"ragged_chunk_plan: nothing to launch for B={B} "
                         f"max_q_len={max_q_len} on {sms} SMs")
    keys, stages, smem = chunk_core(D)
    items = B * Hkv * -(-max_q_len // (128 // (Hq // Hkv)))
    return FlashPlan(128, keys, stages, 384, items, (min(sms, items), 1, 1), smem)


def _check_card(q_flat, kv_pages, ints) -> None:
    """Raise on what K12 does not take."""
    for nm, t in (("q_flat", q_flat), ("kv_pages", kv_pages), *ints):
        if t.device.type != "cuda" or t.device != q_flat.device:
            raise ValueError(f"ragged_attention: {nm} on {t.device}, expected one cuda device")
    for nm, t in (("q_flat", q_flat), ("kv_pages", kv_pages)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"ragged_attention: {nm} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"ragged_attention: {nm} must be contiguous and 16-byte aligned")
    for nm, t in ints:
        if t.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"ragged_attention: {nm} is {t.dtype}; expected an integer tensor")
    D = q_flat.shape[-1]
    if D not in (128, 256):
        raise ValueError(f"ragged_attention: head dim {D}; the kernel takes 128 or 256")
    page = kv_pages.shape[1]
    if page & (page - 1):
        raise ValueError(f"ragged_attention: page size {page}; the kernel takes a power of two")
    G = q_flat.shape[1] // (kv_pages.shape[2] // 2)
    if G & (G - 1) or G > 16:
        raise ValueError(f"ragged_attention: {G} query heads per kv head; the kernel takes "
                         "a power of two up to 16")


def ragged_attention(q_flat: torch.Tensor, kv_pages: torch.Tensor, kv_lens: torch.Tensor,
                     page_indices: torch.Tensor, cu_q_lens: torch.Tensor,
                     num_seqs: torch.Tensor, *, scale: float, sliding_window: int | None = None,
                     logits_softcap: float | None = None,
                     max_q_len: int | None = None) -> torch.Tensor:
    """K12: ragged paged attention over one layer's combined pool.

    q_flat [N, Hq, D]; kv_pages [P, page, 2*Hkv, D] (K even, V odd);
    kv_lens [B], page_indices [B, W], cu_q_lens [B+1], num_seqs [1] integer
    tensors -> [N, Hq, D] in q's dtype. Rows past cu_q_lens[num_seqs] are
    left unspecified (zeros on the CPU). `max_q_len`, when the caller knows
    it, bounds every sequence's query count: 1 selects the decode
    instantiation (the keys of each sequence split across CTAs), anything
    else the chunk instantiation (launched by `ragged_chunk_plan`). On the
    card: D 128 or 256, a power-of-two page size, Hq/Hkv a power of two up
    to 16, bf16 contiguous q and pool; the chunk instantiation takes a
    positive scale where there is no soft cap."""
    global ragged_attention_launches, ragged_chunk_launches
    if q_flat.dim() != 3 or kv_pages.dim() != 4 or kv_pages.shape[-1] != q_flat.shape[-1] \
            or kv_pages.shape[2] % 2 or q_flat.shape[1] % (kv_pages.shape[2] // 2):
        raise ValueError(f"ragged_attention: q {tuple(q_flat.shape)} against a combined pool "
                         f"{tuple(kv_pages.shape)}")
    B = kv_lens.shape[0]
    if page_indices.dim() != 2 or page_indices.shape[0] != B or tuple(cu_q_lens.shape) != (B + 1,) \
            or num_seqs.numel() != 1:
        raise ValueError(f"ragged_attention: page_indices {tuple(page_indices.shape)}, cu_q_lens "
                         f"{tuple(cu_q_lens.shape)} and num_seqs {tuple(num_seqs.shape)} do not "
                         f"match {B} sequences")
    if logits_softcap is not None and not logits_softcap > 0:
        raise ValueError(f"ragged_attention: soft cap {logits_softcap}; expected > 0")
    if sliding_window is not None and not sliding_window > 0:
        raise ValueError(f"ragged_attention: window {sliding_window}; expected > 0")
    ints = (("kv_lens", kv_lens), ("page_indices", page_indices), ("cu_q_lens", cu_q_lens),
            ("num_seqs", num_seqs))
    if _on_cpu(q_flat, kv_pages, *(t for _, t in ints)):
        return ragged_attention_plain(q_flat, kv_pages, kv_lens, page_indices, cu_q_lens,
                                      num_seqs, scale=scale, sliding_window=sliding_window,
                                      logits_softcap=logits_softcap)
    _check_card(q_flat, kv_pages, ints)
    kv_lens, page_indices, cu_q_lens, num_seqs = (t.to(torch.int32).contiguous()
                                                  for _, t in ints)
    N, Hq, D = q_flat.shape
    P, page, H2, _ = kv_pages.shape
    Hkv, W = H2 // 2, page_indices.shape[1]
    out = torch.empty_like(q_flat)
    if N == 0 or B == 0:
        return out
    max_q_len = N if max_q_len is None else max_q_len
    window = int(sliding_window or 0)
    cap = float(logits_softcap or 0.0)
    stream = _P(kernels.stream_ptr(q_flat.device))
    head = (kernels.ptr(q_flat), kernels.ptr(kv_pages), kernels.ptr(kv_lens),
            kernels.ptr(page_indices), kernels.ptr(cu_q_lens), kernels.ptr(num_seqs))
    if max_q_len == 1:
        max_splits, ctas = _decode_grid(Hkv, W * page, D, q_flat.device)
        parts = 4 * max_splits  # one partial per warp of each split
        part_o = torch.empty(B, Hq, parts, D, dtype=torch.float32, device=q_flat.device)
        part_ml = torch.empty(B, Hq, parts, 2, dtype=torch.float32, device=q_flat.device)
        fn = kernels.function("ragged_attention", "ragged_decode",
                              [_P] * 9 + [_I] * 9 + [ctypes.c_float, ctypes.c_float, _I, _P])
        err = fn(*head, kernels.ptr(part_o), kernels.ptr(part_ml), kernels.ptr(out), B, Hq, Hkv,
                 W, page, page.bit_length() - 1, max_splits, ctas, D, float(scale), cap, window,
                 stream)
    else:
        if not cap:
            check_scale("ragged_attention", scale)
        plan = ragged_chunk_plan(B, max_q_len, Hq, Hkv, D, page, kernels.sm_count(q_flat.device))
        fn = kernels.function("ragged_attention", "ragged_chunk",
                              [_P] * 7 + [_I] * 10 + [ctypes.c_float, ctypes.c_float]
                              + [_I] * 9 + [_P])
        err = fn(*head, kernels.ptr(out), N, B, max_q_len, Hq, Hkv, W, P, page,
                 page.bit_length() - 1, D, float(scale), cap, window, *launch_args(plan), stream)
    kernels.check(err, "ragged_attention")
    ragged_attention_launches += 1
    ragged_chunk_launches += max_q_len != 1
    return out
