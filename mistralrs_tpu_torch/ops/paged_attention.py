"""Paged (block-table) KV cache: token-major pools, scatter, gather, copies.

Counterpart of mistralrs_tpu/ops/paged_attention.py for the token-major
pools (`PagedKVCache`, `PagedAttnMeta`, `write_paged_kv`, `gather_paged_kv`,
`paged_attention_reference`, `copy_pages`). Head-major, int8, combined and
split pools are later work.

Layout: k and v are [L, P, page, Hkv, D]; each layer's pool `k[l]` is a
view, so the decoder passes per-layer views without copies. Page 0 of every
layer is the garbage page: padding tokens' slot_mapping points into it, so
writes need no masking, and the block manager never hands it out.

Unlike the JAX functions, which return new arrays, `write_paged_kv` and
`copy_pages` update the pools IN PLACE (index_copy_ / indexed assignment):
a functional update would copy the whole pool every layer and step.
"""

from __future__ import annotations

import dataclasses

import torch

from mistralrs_tpu_torch.ops.attention import NEG_INF, sdpa


@dataclasses.dataclass
class PagedKVCache:
    """k/v pages, token-major [L, P, page, Hkv, D]. Page 0 is reserved."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, num_layers: int, num_pages: int, page_size: int, kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, device="cuda") -> "PagedKVCache":
        shape = (num_layers, num_pages, page_size, kv_heads, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]


@dataclasses.dataclass
class PagedAttnMeta:
    """Step metadata for the paged backend.

    positions:    [B, T] absolute positions of query tokens
    slot_mapping: [B, T] flat destination slot (page_idx * page_size + offset)
                  of each new token; padding tokens point into page 0
    block_tables: [B, MAX_PAGES] page index per logical block (0-padded)
    kv_lens:      [B] context length after this step's write
    active:       [B] 1.0 live row / 0.0 padding slot
    first_chunk:  every row starts at position 0, so the chunk's own K/V is
                  its whole context (the flash prefill path)
    """

    positions: torch.Tensor
    slot_mapping: torch.Tensor
    block_tables: torch.Tensor
    kv_lens: torch.Tensor
    active: torch.Tensor
    first_chunk: bool = False


def write_paged_kv(
    cache_k: torch.Tensor,  # one layer [P, page, Hkv, D]
    cache_v: torch.Tensor,
    new_k: torch.Tensor,  # [B, T, Hkv, D]
    new_v: torch.Tensor,
    slot_mapping: torch.Tensor,  # [B, T]
) -> None:
    """reshape_and_cache: scatter the new K/V rows into their slots, in place.
    Several padding tokens may share a garbage slot; which one lands there
    does not matter."""
    P, page, H, D = cache_k.shape
    idx = slot_mapping.reshape(-1).to(torch.int64)
    cache_k.view(P * page, H, D).index_copy_(0, idx, new_k.reshape(-1, H, D).to(cache_k.dtype))
    cache_v.view(P * page, H, D).index_copy_(0, idx, new_v.reshape(-1, H, D).to(cache_v.dtype))


def gather_paged_kv(
    cache_k: torch.Tensor,  # one layer [P, page, Hkv, D]
    cache_v: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MAX_PAGES]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's context, [B, MAX_PAGES*page, Hkv, D], in position order."""
    B, MP = block_tables.shape
    P, page, H, D = cache_k.shape
    flat = block_tables.reshape(-1).to(torch.int64)
    k = torch.index_select(cache_k, 0, flat)
    v = torch.index_select(cache_v, 0, flat)
    return k.reshape(B, MP * page, H, D), v.reshape(B, MP * page, H, D)


def paged_attention_reference(
    q: torch.Tensor,  # [B, T, Hq, D]
    cache_k: torch.Tensor,  # one layer [P, page, Hkv, D]
    cache_v: torch.Tensor,
    meta: PagedAttnMeta,
    *,
    scale: float,
) -> torch.Tensor:
    """Attention of q against the paged context (gather + dense SDPA), for
    decode (T=1) and continuation chunks; the chunk's own K/V must already
    be written with write_paged_kv."""
    B, T = q.shape[0], q.shape[1]
    k, v = gather_paged_kv(cache_k, cache_v, meta.block_tables)
    S = k.shape[1]
    q_off = meta.kv_lens.to(torch.int64) - T
    q_ids = torch.arange(T, device=q.device)[None, :] + q_off[:, None]  # [B, T]
    kv_ids = torch.arange(S, device=q.device)[None, :]
    keep = kv_ids[:, None, :] <= q_ids[:, :, None]  # [B, T, S] causal
    keep &= (kv_ids < meta.kv_lens.to(torch.int64)[:, None])[:, None, :]
    bias = torch.where(keep, 0.0, NEG_INF).to(torch.float32)[:, None]  # [B, 1, T, S]
    return sdpa(q, k.to(q.dtype), v.to(q.dtype), scale=scale, mask=bias)


def copy_pages(cache: PagedKVCache, src, dst) -> PagedKVCache:
    """COW page copies in every layer, in place (the right-hand side is
    gathered before the write, so overlapping src/dst copy the old pages)."""
    dev = cache.k.device
    src = torch.as_tensor(src, dtype=torch.int64, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.int64, device=dev)
    for arr in (cache.k, cache.v):
        arr[:, dst] = arr[:, src]
    return cache
