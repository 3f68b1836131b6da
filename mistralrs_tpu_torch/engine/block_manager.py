"""Physical KV page allocator with refcounting and copy-on-write.

Counterpart of mistralrs_tpu/engine/block_manager.py (the Python
`BlockManager`; the native C++ allocator is not ported yet).

Reference parity: mistralrs-core/src/paged_attention/block_engine.rs —
`BlockEngine` (:11-378): refcounted `PhysicalTokenBlock`s, allocation gate
(`AllocStatus`), `free_sequence`, `append_token_slot_to_seq` with COW on a
shared last block (:300-330). The reference's CPU-swap allocator is not
needed: swap preemption (the engine's `_swap_out_seq`) keeps a swapped
sequence's pages in host tensors of its own and frees its device pages here.

Page 0 is reserved as the garbage page for padding writes
(see ops/paged_attention.py), so the allocatable pool is pages 1..P-1.
"""

from __future__ import annotations

import enum

from mistralrs_tpu_torch.engine.sequence import Sequence


class AllocStatus(enum.Enum):
    OK = "ok"
    LATER = "later"  # not enough pages now, retry later
    IMPOSSIBLE = "impossible"  # larger than the whole pool


def make_block_manager(num_pages: int, page_size: int, watermark: float = 0.01):
    """The Python allocator (the JAX package's C++ one is later work here)."""
    return BlockManager(num_pages, page_size, watermark)


class BlockManager:
    def __init__(self, num_pages: int, page_size: int, watermark: float = 0.01):
        assert num_pages >= 2
        self.num_pages = num_pages
        self.page_size = page_size
        self.free_pages: list[int] = list(range(num_pages - 1, 0, -1))  # pop() -> low ids first
        self.refcount: dict[int, int] = {}
        self.watermark_pages = max(1, int(watermark * num_pages))

    # ------------------------------------------------------------- queries
    @property
    def num_free(self) -> int:
        return len(self.free_pages)

    def pages_needed(self, num_tokens: int) -> int:
        return (num_tokens + self.page_size - 1) // self.page_size

    def can_allocate(self, seq: Sequence) -> AllocStatus:
        total = self.pages_needed(len(seq.tokens))
        if total > self.num_pages - 1:
            return AllocStatus.IMPOSSIBLE
        # pages already attached (prefix-cache hit) don't need allocating
        need = total - len(seq.block_table)
        if self.num_free - need >= self.watermark_pages:
            return AllocStatus.OK
        return AllocStatus.LATER

    def can_append_token(self, seq: Sequence, n: int = 1) -> bool:
        """True if an n-token append is satisfiable (n>1: speculative
        lookahead, reserving the whole draft span before the step)."""
        end_pages = self.pages_needed(seq.kv_len + n)
        need = max(0, end_pages - len(seq.block_table))
        return self.num_free >= need

    # ------------------------------------------------------------- mutation
    def _alloc_page(self) -> int:
        page = self.free_pages.pop()
        self.refcount[page] = 1
        return page

    def allocate(self, seq: Sequence) -> None:
        """Allocate pages to cover seq's current tokens (prefill admission).

        Extends past any prefix-cache pages already attached to the table."""
        need = self.pages_needed(len(seq.tokens)) - len(seq.block_table)
        assert len(self.free_pages) >= need
        seq.block_table.extend(self._alloc_page() for _ in range(need))

    def append_slot(self, seq: Sequence, n: int = 1) -> tuple[int, int] | None:
        """Ensure capacity for n more tokens at kv positions
        [seq.kv_len, seq.kv_len + n).

        Returns (src_page, dst_page) if a COW copy is required (first write
        lands in a shared page), else None. Pages past the first write are
        always freshly allocated, never shared.
        (Ref append_token_slot_to_seq :300-330.)
        """
        kv = seq.kv_len
        cow: tuple[int, int] | None = None
        first_idx = kv // self.page_size
        if kv % self.page_size != 0 and first_idx < len(seq.block_table):
            page = seq.block_table[first_idx]
            if self.refcount.get(page, 1) > 1:
                # copy-on-write: replace the shared page with a fresh copy
                new = self._alloc_page()
                self.refcount[page] -= 1
                seq.block_table[first_idx] = new
                cow = (page, new)
        end_pages = self.pages_needed(kv + n)
        while len(seq.block_table) < end_pages:
            seq.block_table.append(self._alloc_page())
        return cow

    def fork(self, parent: Sequence, child: Sequence) -> None:
        """Share parent's pages with child (prefix cache / beam fork);
        window-released placeholder entries are copied but not referenced."""
        child.block_table = list(parent.block_table)
        child.released_pages = parent.released_pages
        for p in child.block_table[parent.released_pages:]:
            self.refcount[p] = self.refcount.get(p, 0) + 1

    def share_prefix(self, seq: Sequence, pages: list[int]) -> None:
        """Attach already-populated prefix pages (prefix cache hit)."""
        seq.block_table = list(pages)
        for p in pages:
            self.refcount[p] = self.refcount.get(p, 0) + 1

    def free_sequence(self, seq: Sequence) -> None:
        self.unref_pages(seq.block_table[seq.released_pages:])
        seq.block_table = []
        seq.released_pages = 0

    def release_prefix(self, seq: Sequence, n: int) -> None:
        """Early-release whole pages strictly behind a sliding window:
        frees block_table[released, n) while keeping the entries as
        positional placeholders (never gathered — the decode paths slice
        tables from the window base). The paged equivalent of the
        reference's sliding-window KV truncation (cache_manager.rs:101-154)."""
        n = min(n, len(seq.block_table))
        self.unref_pages(seq.block_table[seq.released_pages : n])
        seq.released_pages = max(seq.released_pages, n)

    def ref_pages(self, pages: list[int]) -> None:
        """Take an ownership reference on pages (prefix cache retention)."""
        for p in pages:
            self.refcount[p] = self.refcount.get(p, 0) + 1

    def unref_pages(self, pages: list[int]) -> None:
        for p in pages:
            rc = self.refcount.get(p, 0) - 1
            if rc <= 0:
                self.refcount.pop(p, None)
                self.free_pages.append(p)
            else:
                self.refcount[p] = rc
