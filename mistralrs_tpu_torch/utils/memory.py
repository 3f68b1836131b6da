"""Paged-KV pool sizing from device memory.

Counterpart of mistralrs_tpu/utils/memory.py (`PagedCacheConfig`,
`calculate_num_pages`), reading free memory with torch.cuda.mem_get_info.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PagedCacheConfig:
    mem_fraction: float | None = 0.9  # fraction of free device memory
    mem_bytes: int | None = None  # absolute budget
    context_len: int | None = None  # size for N cached tokens per sequence instead
    page_size: int = 16


def calculate_num_pages(
    cfg: PagedCacheConfig,
    num_layers: int,
    num_kv_heads: int,
    head_dim: int,
    dtype_bytes: float = 2,
    max_seqs: int = 16,
    device="cuda",
) -> int:
    """Number of KV pages the pool should hold.

    dtype_bytes is a K or V element's bytes, fractional for an int8 pool
    (1 + 4 / head_dim: the payload and its share of the f32 scale a slot
    and head). Priority: context_len > mem_bytes > mem_fraction of free
    memory. 512 pages when the device reports no memory (the CPU)."""
    page_bytes = 2 * num_layers * num_kv_heads * head_dim * cfg.page_size * dtype_bytes
    if cfg.context_len is not None:
        per_seq = -(-cfg.context_len // cfg.page_size)
        return max(per_seq * max_seqs + 1, 2)
    budget = cfg.mem_bytes
    if budget is None:
        device = torch.device(device)
        if device.type != "cuda":
            return 512
        free, _total = torch.cuda.mem_get_info(device)
        budget = int(free * (cfg.mem_fraction or 0.9))
    return max(int(budget // page_bytes), 2)
