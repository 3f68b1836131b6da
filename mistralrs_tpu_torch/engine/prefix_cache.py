"""Prefix cache: radix trie of token prefixes -> resident KV pages.

Reference parity: mistralrs-core/src/prefix_cacher.rs — `PrefixCacheManager`
(radix trie of token-prefix -> cached KV, `add_sequence` :58, eviction :91,
`search_for_matching_cache` :163). The reference clones whole per-layer KV
tensors into the trie and is *disabled* under PagedAttention
(engine/mod.rs:70-71); on TPU the paged pool makes the opposite design
natural: cached prefixes stay as refcounted *pages* in the device pool
(zero-copy hits, vLLM-style), keyed per full page of token ids. Eviction
drops LRU trie leaves (reference evicts oldest to CPU beyond `n_on_device`;
host swap of HBM pages would serialize the engine, so we reclaim instead —
a hit after eviction is recomputed, mirroring preempt-by-recompute).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable

from mistralrs_tpu_torch.engine.block_manager import BlockManager


@dataclasses.dataclass
class _Node:
    key: tuple[int, ...]  # page_size token ids covered by this page
    page: int  # physical page id (refcounted by the trie)
    last_access: int = 0
    children: dict[tuple[int, ...], "_Node"] = dataclasses.field(default_factory=dict)
    parent: "_Node | None" = None


class PrefixCacheManager:
    """Page-granular radix trie over the paged KV pool.

    Matching returns only *full* pages and never the entire prompt (at least
    one token must be prefilled to produce logits — ref prefix_cacher.rs
    returns `leftover` tokens for the same reason).
    """

    def __init__(self, block_manager: BlockManager, max_pages: int | None = None):
        self.bm = block_manager
        self.page_size = block_manager.page_size
        # default cap: half the pool may hold cold prefixes
        self.max_pages = max_pages if max_pages is not None else block_manager.num_pages // 2
        self._root: dict[tuple[int, ...], _Node] = {}
        self._clock = itertools.count()
        self.num_cached_pages = 0
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------- lookup
    def match(self, tokens: list[int]) -> tuple[int, list[int]]:
        """Longest cached page-aligned proper prefix of `tokens`.

        Returns (num_matched_tokens, pages); refcounts are NOT bumped here —
        the caller attaches pages via BlockManager.share_prefix.
        (Ref search_for_matching_cache prefix_cacher.rs:163.)
        """
        ps = self.page_size
        limit = (len(tokens) - 1) // ps  # proper prefix: leave >=1 token to prefill
        pages: list[int] = []
        level = self._root
        tick = next(self._clock)
        for i in range(limit):
            key = tuple(tokens[i * ps : (i + 1) * ps])
            node = level.get(key)
            if node is None:
                break
            node.last_access = tick
            pages.append(node.page)
            level = node.children
        if pages:
            self.hits += 1
        else:
            self.misses += 1
        return len(pages) * ps, pages

    # ------------------------------------------------------------- insert
    def insert(self, tokens: list[int], block_table: list[int], kv_len: int) -> None:
        """Cache the full pages of a finished sequence (ref add_sequence :58).

        Takes its own refs on newly cached pages; already-cached content keeps
        the existing page (dedup), so forked children collapse to one entry.
        """
        ps = self.page_size
        # kv_len can exceed len(tokens) when a sequence finished mid-span
        # (speculative decoding); only token-backed pages are cacheable
        n_full = min(min(kv_len, len(tokens)) // ps, len(block_table))
        level = self._root
        parent: _Node | None = None
        tick = next(self._clock)
        for i in range(n_full):
            key = tuple(tokens[i * ps : (i + 1) * ps])
            node = level.get(key)
            if node is None:
                node = _Node(key=key, page=block_table[i], parent=parent)
                self.bm.ref_pages([node.page])
                level[key] = node
                self.num_cached_pages += 1
            node.last_access = tick
            parent = node
            level = node.children
        if self.num_cached_pages > self.max_pages:
            self.evict(self.num_cached_pages - self.max_pages)

    # ------------------------------------------------------------- eviction
    def _leaves(self) -> Iterable[_Node]:
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                yield node

    def evict(self, need_pages: int) -> int:
        """Drop LRU leaves until `need_pages` pool pages were actually released
        (or the trie is empty). A leaf shared with a live sequence frees
        nothing (refcount stays >0), so progress is measured on the allocator.
        (Ref evict_to_cpu :91 evicts oldest beyond n_on_device; see module
        docstring for why we reclaim instead of host-swap.)"""
        start_free = self.bm.num_free
        while self.bm.num_free - start_free < need_pages:
            leaves = sorted(self._leaves(), key=lambda n: n.last_access)
            if not leaves:
                break
            for leaf in leaves:
                if self.bm.num_free - start_free >= need_pages:
                    break
                self._remove_leaf(leaf)
        return self.bm.num_free - start_free

    def _remove_leaf(self, node: _Node) -> None:
        assert not node.children
        siblings = node.parent.children if node.parent else self._root
        siblings.pop(node.key, None)
        self.bm.unref_pages([node.page])
        self.num_cached_pages -= 1

    def clear(self) -> None:
        for leaf in list(self._leaves()):
            n: _Node | None = leaf
            while n is not None and not n.children:
                self._remove_leaf(n)
                n = n.parent
