"""Paged (block-table) KV cache: pools, scatter, gather, copies, swaps, the
int8 pools, the blockwise long-span route, and the paged attention kernels
K6' and K7.

Counterpart of mistralrs_tpu/ops/paged_attention.py: `PagedKVCache`,
`PagedAttnMeta`, `write_paged_kv`, `write_paged_kv_q` (with
`_quantize_rows`, `_write_scale`), `gather_paged_kv`, `gather_paged_kv_q`,
`paged_attention_reference`, `blockwise_prefill_continuation`,
`_pool_leaves`, `copy_pages`, `swap_out_pages`, `swap_in_pages`,
`flash_prefill_continuation` (K6') and `paged_decode_attention` (K7).
Split pools (a tuple of per-group arrays) are not ported: the port keeps
one [L, ...] pool a leaf.

Three pool layouts, as in the JAX package (`head_major`, `combined`):
- token-major k/v [L, P, page, Hkv, D]: one page row is one token's heads;
- head-major k/v [L, Hkv, P, page, D]: each kv head's page is one
  contiguous [page, D] block, the layout the decode kernel streams;
- combined k [L, P, page, 2*Hkv, D] with v None: token-major, K at the even
  and V at the odd head indices, the layout of the ragged backend
  (ops/ragged_attention.py).
An int8 pool (`quant=True`, either of the first two layouts) holds int8
payloads in k/v and one f32 absmax scale per (slot, head) in
k_scale/v_scale, shaped like the payload without D; a value is payload *
scale. The decoder hands a layer of such a pool to the ops below as
(payload, scale) pairs.
Each layer's pool `k[l]` is a view, so the decoder passes per-layer views
without copies. Page 0 of every layer is the garbage page: padding tokens'
slot_mapping points into it, so writes need no masking, and the block
manager never hands it out.

Unlike the JAX functions, which return new arrays, `write_paged_kv`,
`write_paged_kv_q`, `copy_pages` and `swap_in_pages` update the pools IN
PLACE (index_copy_ / indexed assignment): a functional update would copy
the whole pool every layer and step, and the decode loop's CUDA graphs
hold the pools' addresses (pipeline/graphs.py).

The kernels (csrc/flash_prefill_paged.cu, csrc/paged_decode.cu) read the
context through the block table, never a gathered copy; K6' shares K6's
Hopper attention core and launch plan (ops/flash_attention.py::flash_plan). Their wrappers take
the plain versions below when (and only when) the tensors lie on the CPU;
on a CUDA tensor they launch the kernel or raise. They take bf16 pools
only; the decoder never gives them an int8 one. The blockwise route is
the JAX package's own plain computation (XLA einsums there), not a
kernel's stand-in.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from mistralrs_tpu_torch.ops import kernels
from mistralrs_tpu_torch.ops.attention import (
    NEG_INF,
    block_attend,
    finalize_flash,
    flash_combine,
    sdpa,
    sdpa_head_major,
)
from mistralrs_tpu_torch.ops.flash_attention import check_scale, flash_plan, launch_args

# launches of each kernel (one per wrapper call that launched it)
flash_prefill_paged_launches = 0
paged_decode_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@dataclasses.dataclass
class PagedKVCache:
    """k/v pages, token-major [L, P, page, Hkv, D] or head-major
    [L, Hkv, P, page, D]; or one combined pool k [L, P, page, 2*Hkv, D]
    (K even, V odd) with v None. Int8 pools (quant=True) hold int8 k/v and
    f32 k_scale/v_scale of the payload's shape without D. Page 0 is
    reserved."""

    k: torch.Tensor
    v: torch.Tensor | None
    head_major: bool = False
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @classmethod
    def create(cls, num_layers: int, num_pages: int, page_size: int, kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, device="cuda",
               head_major: bool = False, combined: bool = False,
               quant: bool = False) -> "PagedKVCache":
        if combined:
            if head_major or quant:
                raise ValueError("a combined pool is token-major and not quantized")
            shape = (num_layers, num_pages, page_size, 2 * kv_heads, head_dim)
            return cls(k=torch.zeros(shape, dtype=dtype, device=device), v=None)
        if head_major:
            shape = (num_layers, kv_heads, num_pages, page_size, head_dim)
        else:
            shape = (num_layers, num_pages, page_size, kv_heads, head_dim)
        if quant:
            return cls(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device),
                       head_major=head_major,
                       k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                       v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), head_major=head_major)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def combined(self) -> bool:
        return self.v is None

    @property
    def page_size(self) -> int:
        return self.k.shape[3] if self.head_major else self.k.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k.shape[2] if self.head_major else self.k.shape[1]

    @property
    def page_axis(self) -> int:
        """Axis of the page index in the full [L, ...] pools (COW copies)."""
        return 2 if self.head_major else 1


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
    head_major:   layout of the pools this step receives
    """

    positions: torch.Tensor
    slot_mapping: torch.Tensor
    block_tables: torch.Tensor
    kv_lens: torch.Tensor
    active: torch.Tensor
    first_chunk: bool = False
    head_major: bool = False


def write_paged_kv(
    cache_k: torch.Tensor,  # one layer; layout per `head_major`
    cache_v: torch.Tensor,
    new_k: torch.Tensor,  # [B, T, Hkv, D]
    new_v: torch.Tensor,
    slot_mapping: torch.Tensor,  # [B, T]
    head_major: bool = False,
) -> None:
    """reshape_and_cache: scatter the new K/V rows into their slots, in place.
    Several padding tokens may share a garbage slot; which one lands there
    does not matter."""
    idx = slot_mapping.reshape(-1).to(torch.int64)
    if head_major:
        H, P, page, D = cache_k.shape
        for pool, new in ((cache_k, new_k), (cache_v, new_v)):
            rows = new.reshape(-1, H, D).transpose(0, 1).to(pool.dtype)  # [H, B*T, D]
            pool.view(H, P * page, D).index_copy_(1, idx, rows)
        return
    P, page, H, D = cache_k.shape
    cache_k.view(P * page, H, D).index_copy_(0, idx, new_k.reshape(-1, H, D).to(cache_k.dtype))
    cache_v.view(P * page, H, D).index_copy_(0, idx, new_v.reshape(-1, H, D).to(cache_v.dtype))


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, T, H, D] -> (int8 payload, f32 per-(token, head) scale): s =
    max|x| / 127 (a division, as JAX computes it) floored at 1e-8, the
    payload round-half-to-even(x / s) clipped to +-127."""
    xf = x.to(torch.float32)
    s = torch.amax(torch.abs(xf), dim=-1) / 127.0
    s = torch.clamp(s, min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _write_scale(scale_pool: torch.Tensor, new_s: torch.Tensor, idx: torch.Tensor,
                 head_major: bool) -> None:
    """Scatter per-(token, head) scales [B, T, H] into one layer's scale pool
    ([H, P, page] or [P, page, H]) as write_paged_kv does payloads, in place."""
    if head_major:
        H, P, page = scale_pool.shape
        scale_pool.view(H, P * page).index_copy_(1, idx, new_s.reshape(-1, H).transpose(0, 1))
        return
    P, page, H = scale_pool.shape
    scale_pool.view(P * page, H).index_copy_(0, idx, new_s.reshape(-1, H))


def write_paged_kv_q(
    ck: tuple[torch.Tensor, torch.Tensor],  # (int8 payload, f32 scale) of one layer
    cv: tuple[torch.Tensor, torch.Tensor],
    new_k: torch.Tensor,  # [B, T, Hkv, D]
    new_v: torch.Tensor,
    slot_mapping: torch.Tensor,  # [B, T]
    head_major: bool = False,
) -> None:
    """reshape_and_cache for int8 pools, in place: each new (token, head) row
    quantized with its own absmax scale (_quantize_rows), payloads and
    scales scattered into their slots."""
    idx = slot_mapping.reshape(-1).to(torch.int64)
    qk, sk = _quantize_rows(new_k)
    qv, sv = _quantize_rows(new_v)
    write_paged_kv(ck[0], cv[0], qk, qv, slot_mapping, head_major)
    _write_scale(ck[1], sk, idx, head_major)
    _write_scale(cv[1], sv, idx, head_major)


def gather_paged_kv(
    cache_k: torch.Tensor,  # one layer; layout per `head_major`
    cache_v: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MAX_PAGES]
    head_major: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's context in position order, reshaped from the pool layout
    without a transposed copy: head-major pools give [Hkv, B, S, D] (read
    by sdpa_head_major), token-major pools [B, S, Hkv, D] (read by sdpa)."""
    B, MP = block_tables.shape
    flat = block_tables.reshape(-1).to(torch.int64)
    if head_major:
        H, P, page, D = cache_k.shape
        k = torch.index_select(cache_k, 1, flat)
        v = torch.index_select(cache_v, 1, flat)
        return k.reshape(H, B, MP * page, D), v.reshape(H, B, MP * page, D)
    P, page, H, D = cache_k.shape
    k = torch.index_select(cache_k, 0, flat)
    v = torch.index_select(cache_v, 0, flat)
    return k.reshape(B, MP * page, H, D), v.reshape(B, MP * page, H, D)


def gather_paged_kv_q(
    ck: tuple[torch.Tensor, torch.Tensor],
    cv: tuple[torch.Tensor, torch.Tensor],
    block_tables: torch.Tensor,
    head_major: bool = False,
    dtype=torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather and dequantize int8 pools to `dtype` (layouts as
    gather_paged_kv): payload.to(dtype) * scale.to(dtype), the scale rounded
    to `dtype` before the product, as the JAX function does."""
    B, MP = block_tables.shape
    k, v = gather_paged_kv(ck[0], cv[0], block_tables, head_major=head_major)
    flat = block_tables.reshape(-1).to(torch.int64)
    if head_major:
        H, P, page = ck[1].shape
        sk = torch.index_select(ck[1], 1, flat).reshape(H, B, MP * page)
        sv = torch.index_select(cv[1], 1, flat).reshape(H, B, MP * page)
    else:
        P, page, H = ck[1].shape
        sk = torch.index_select(ck[1], 0, flat).reshape(B, MP * page, H)
        sv = torch.index_select(cv[1], 0, flat).reshape(B, MP * page, H)
    return (k.to(dtype) * sk[..., None].to(dtype), v.to(dtype) * sv[..., None].to(dtype))


def paged_attention_reference(
    q: torch.Tensor,  # [B, T, Hq, D]
    cache_k: torch.Tensor,  # one layer; layout per meta.head_major
    cache_v: torch.Tensor,
    meta: PagedAttnMeta,
    *,
    scale: float,
    sliding_window: int | None = None,
    logits_softcap: float | None = None,
) -> torch.Tensor:
    """Attention of q against the paged context (gather + dense SDPA), for
    decode (T=1) and continuation chunks; the chunk's own K/V must already
    be written with write_paged_kv. Query i of a row sits at position
    kv_len - T + i and sees positions up to its own that are < kv_len.
    logits_softcap caps the scaled logits before the mask, as sdpa does."""
    B, T = q.shape[0], q.shape[1]
    hm = meta.head_major
    k, v = gather_paged_kv(cache_k, cache_v, meta.block_tables, head_major=hm)
    S = k.shape[2] if hm else k.shape[1]
    kv_lens = meta.kv_lens.to(torch.int64)
    q_ids = torch.arange(T, device=q.device)[None, :] + (kv_lens - T)[:, None]  # [B, T]
    kv_ids = torch.arange(S, device=q.device)[None, :]
    keep = kv_ids[:, None, :] <= q_ids[:, :, None]  # [B, T, S] causal
    keep &= (kv_ids < kv_lens[:, None])[:, None, :]
    if sliding_window is not None:
        keep &= kv_ids[:, None, :] > q_ids[:, :, None] - sliding_window
    bias = torch.where(keep, 0.0, NEG_INF).to(torch.float32)[:, None]  # [B, 1, T, S]
    attn = sdpa_head_major if hm else sdpa
    return attn(q, k.to(q.dtype), v.to(q.dtype), scale=scale, mask=bias,
                logits_softcap=logits_softcap)


def blockwise_prefill_continuation(
    q: torch.Tensor,  # [B, T, Hq, D] chunk queries
    cache_k,  # one layer, layout per meta.head_major; an int8 pool as (payload, scale)
    cache_v,
    meta: PagedAttnMeta,
    *,
    scale: float,
    sliding_window: int | None = None,
    logits_softcap: float | None = None,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Blockwise (online-softmax) attention of a continuation chunk, or a
    decode step, over a long paged context (the chunk's own K/V already
    written) -> [B, T, Hq, D] in q's dtype.

    The gather route holds [B, Hq, T, span] f32 scores; this walks the span
    in `kv_block`-token key blocks (JAX's lax.scan as a Python loop), each
    block's pages gathered (and, for an int8 pool, dequantized to q's dtype)
    on their own, so peak memory is O(T * kv_block). The block tables are
    padded with page 0 to whole blocks; keys are masked by position (causal,
    and < kv_len) and, with `sliding_window`, by the window. The decoder
    passes `sliding_window` None on a global layer, where JAX passes its
    window with a traced per-layer gate."""
    B, T, Hq, D = q.shape
    hm = meta.head_major
    kv_quant = isinstance(cache_k, tuple)
    pool_k = cache_k[0] if kv_quant else cache_k
    page = pool_k.shape[2] if hm else pool_k.shape[1]
    Hkv = pool_k.shape[0] if hm else pool_k.shape[2]
    G = Hq // Hkv
    MP = meta.block_tables.shape[1]
    ppb = max(kv_block // page, 1)
    nb = -(-MP // ppb)
    tables = meta.block_tables.to(torch.int64)
    if nb * ppb != MP:
        tables = torch.nn.functional.pad(tables, (0, nb * ppb - MP))
    blk = ppb * page
    dev = q.device
    kv_lens = meta.kv_lens.to(torch.int64)
    q_ids = (kv_lens - T)[:, None] + torch.arange(T, device=dev)[None]  # [B, T]
    qg = (q.to(torch.float32) * scale).reshape(B, T, Hkv, G, D)
    m = torch.full((B, Hkv, G, T), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, T, Hkv, G, D), dtype=torch.float32, device=dev)
    offs = torch.arange(blk, device=dev)
    for b in range(nb):
        tb = tables[:, b * ppb:(b + 1) * ppb]
        if kv_quant:
            k, v = gather_paged_kv_q(cache_k, cache_v, tb, head_major=hm, dtype=q.dtype)
        else:
            k, v = gather_paged_kv(cache_k, cache_v, tb, head_major=hm)
        if hm:  # [Hkv, B, blk, D] -> [B, blk, Hkv, D]
            k = k.permute(1, 2, 0, 3)
            v = v.permute(1, 2, 0, 3)
        kv_ids = (b * blk + offs)[None, None, :]  # [1, 1, blk]
        keep = (kv_ids <= q_ids[:, :, None]) & (kv_ids < kv_lens[:, None, None])
        if sliding_window is not None:
            keep = keep & (kv_ids > q_ids[:, :, None] - sliding_window)
        m, l, acc = flash_combine(m, l, acc, *block_attend(qg, k, v, keep,
                                                           logits_softcap=logits_softcap))
    return finalize_flash(l, acc).to(q.dtype)


def _pool_leaves(cache: PagedKVCache) -> dict[str, torch.Tensor]:
    """The cache's page-indexed tensors (payloads, and an int8 pool's
    scales), all on the same page axis (cache.page_axis). A combined pool
    has one leaf."""
    leaves = {"k": cache.k}
    if not cache.combined:
        leaves["v"] = cache.v
    if cache.quantized:
        leaves["k_scale"] = cache.k_scale
        leaves["v_scale"] = cache.v_scale
    return leaves


def copy_pages(cache: PagedKVCache, src, dst) -> PagedKVCache:
    """COW page copies in every layer of every leaf (an int8 pool's scales
    too), on the page axis of either layout, in place (the right-hand side
    is gathered before the write, so overlapping src/dst copy the old
    pages)."""
    dev = cache.k.device
    src = torch.as_tensor(src, dtype=torch.int64, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.int64, device=dev)
    for arr in _pool_leaves(cache).values():
        if cache.page_axis == 2:
            arr[:, :, dst] = arr[:, :, src]
        else:
            arr[:, dst] = arr[:, src]
    return cache


def swap_out_pages(cache: PagedKVCache, pages) -> tuple[torch.Tensor, ...]:
    """Copy the named pages of every leaf to host memory, synchronously (ref
    cache_engine.rs swap_out / swap_blocks D2H): CPU tensors (k, v[,
    k_scale, v_scale]) with the pages on the pool's page axis, in the
    pool's layout order."""
    idx = torch.as_tensor(pages, dtype=torch.int64, device=cache.k.device)
    return tuple(arr.index_select(cache.page_axis, idx).cpu()
                 for arr in _pool_leaves(cache).values())


def swap_in_pages(cache: PagedKVCache, host_kv: tuple, pages) -> PagedKVCache:
    """Write host K/V (from swap_out_pages) into the named destination pages
    of every leaf, in place (ref cache_engine.rs swap_in / swap_blocks
    H2D): the pools keep their addresses, which captured decode graphs
    read. Returns the same cache."""
    idx = torch.as_tensor(pages, dtype=torch.int64, device=cache.k.device)
    for arr, host in zip(_pool_leaves(cache).values(), host_kv):
        arr.index_copy_(cache.page_axis, idx, host.to(arr.device, arr.dtype))
    return cache


# ------------------------------------------------------------- kernels


def _paged_plain(q, cache_k, cache_v, meta, scale, logits_softcap=None):
    """Masked f32 attention over the gathered context; rows with kv_len 0
    give zeros, as the kernels do."""
    out = paged_attention_reference(q.to(torch.float32), cache_k, cache_v, meta, scale=scale,
                                    logits_softcap=logits_softcap)
    live = (meta.kv_lens > 0).to(out.dtype)[:, None, None, None]
    return (out * live).to(q.dtype)


# one plain function, under each kernel's name, so that a caller (or a test
# counting routes) can tell the two kernels' plain versions apart
def flash_prefill_continuation_plain(q, cache_k, cache_v, meta, *, scale: float):
    """Plain PyTorch version of K6', any device."""
    return _paged_plain(q, cache_k, cache_v, meta, scale)


def paged_decode_attention_plain(q, cache_k, cache_v, meta, *, scale: float,
                                 logits_softcap: float | None = None):
    """Plain PyTorch version of K7 (the same function at T = 1), any device."""
    return _paged_plain(q, cache_k, cache_v, meta, scale, logits_softcap)


def _pool_geometry(cache_k: torch.Tensor, head_major: bool):
    """(Hkv, pages, page size, element strides of a page, a slot and a kv
    head) of one layer's pool."""
    if head_major:
        H, P, page, D = cache_k.shape
        return H, P, page, page * D, D, P * page * D
    P, page, H, D = cache_k.shape
    return H, P, page, page * H * D, H * D, D


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_card(name: str, q, cache_k, cache_v, meta,
                head_dims=(128,)) -> tuple[torch.Tensor, torch.Tensor]:
    """Raise on what the kernels do not take (a head dim outside
    `head_dims`, among others); returns the block tables and kv_lens as
    contiguous int64 on q's device."""
    for nm, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v),
                  ("block_tables", meta.block_tables), ("kv_lens", meta.kv_lens)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {nm} on {t.device}, expected one cuda device")
    for nm, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {nm} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {nm} must be contiguous and 16-byte aligned")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"{name}: head dim {q.shape[-1]}; the kernel takes "
                         + " or ".join(map(str, head_dims)))
    page = _pool_geometry(cache_k, meta.head_major)[2]
    if page & (page - 1):
        raise ValueError(f"{name}: page size {page}; the kernel takes a power of two")
    for nm, t in (("block_tables", meta.block_tables), ("kv_lens", meta.kv_lens)):
        if t.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{name}: {nm} is {t.dtype}; expected an integer tensor")
    return (meta.block_tables.to(torch.int64).contiguous(),
            meta.kv_lens.to(torch.int64).contiguous())


def _check_shapes(name: str, q, cache_k, cache_v, meta) -> None:
    B, T, Hq, D = q.shape
    if cache_k.dim() != 4 or cache_k.shape != cache_v.shape:
        raise ValueError(f"{name}: pools {tuple(cache_k.shape)} / {tuple(cache_v.shape)} "
                         "are not one layer's [Hkv,P,page,D] or [P,page,Hkv,D]")
    H = _pool_geometry(cache_k, meta.head_major)[0]
    if cache_k.shape[-1] != D or Hq % H:
        raise ValueError(f"{name}: q {tuple(q.shape)} against pools {tuple(cache_k.shape)}")
    if meta.block_tables.dim() != 2 or meta.block_tables.shape[0] != B \
            or tuple(meta.kv_lens.shape) != (B,):
        raise ValueError(f"{name}: block_tables {tuple(meta.block_tables.shape)} and kv_lens "
                         f"{tuple(meta.kv_lens.shape)} do not match {B} rows")


def flash_prefill_continuation(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                               meta: PagedAttnMeta, *, scale: float) -> torch.Tensor:
    """K6': causal attention of a prefill chunk q [B, T, Hq, D] over its paged
    context (the chunk's own K/V already written) -> [B, T, Hq, D] in q's
    dtype. Query i of row b sits at position kv_lens[b] - T + i; rows may
    start at 0. Pools of either layout. What a pool holds at or past a row's
    kv_len (the rest of its last page included, even NaN) does not reach
    the result."""
    global flash_prefill_paged_launches
    _check_shapes("flash_prefill_continuation", q, cache_k, cache_v, meta)
    if _on_cpu(q, cache_k, cache_v, meta.block_tables, meta.kv_lens):
        return flash_prefill_continuation_plain(q, cache_k, cache_v, meta, scale=scale)
    tables, kv_lens = _check_card("flash_prefill_continuation", q, cache_k, cache_v, meta)
    check_scale("flash_prefill_continuation", scale)
    B, T, Hq, D = q.shape
    H, P, page = _pool_geometry(cache_k, meta.head_major)[:3]
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    plan = flash_plan(B, T, Hq, H, D, kernels.sm_count(q.device))
    fn = kernels.function("flash_prefill_paged", "flash_prefill_paged",
                          [_P] * 6 + [_I] * 9 + [ctypes.c_float] + [_I] * 8 + [_P])
    err = fn(kernels.ptr(q), kernels.ptr(cache_k), kernels.ptr(cache_v), kernels.ptr(tables),
             kernels.ptr(kv_lens), kernels.ptr(out), B, T, Hq, H, tables.shape[1], P, page,
             page.bit_length() - 1, int(meta.head_major), float(scale), *launch_args(plan),
             _P(kernels.stream_ptr(q.device)))
    kernels.check(err, "flash_prefill_paged")
    flash_prefill_paged_launches += 1
    return out


# keys of one staged tile of the decode kernel, and the CTAs of each head
# dim that fit on an SM at once (68 KB of shared memory each at D = 128,
# 136 KB at D = 256)
_DECODE_TILE = 64
_DECODE_CTAS_PER_SM = {128: 2, 256: 1}


def _decode_splits(B: int, H: int, span: int, D: int, device) -> tuple[int, int]:
    """(splits, 64-key tiles per split) of K7's grid: each (row, kv head)
    pair's span is cut into splits so that B * H * splits fills the card's
    SMs with as many CTAs as fit on each; the splits' partials are combined
    in a second pass."""
    tiles = max(1, -(-span // _DECODE_TILE))
    want = max(1, _DECODE_CTAS_PER_SM[D] * kernels.sm_count(device) // max(B * H, 1))
    per = -(-tiles // min(want, tiles))
    return -(-tiles // per), per


def paged_decode_attention(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                           meta: PagedAttnMeta, *, scale: float,
                           logits_softcap: float | None = None) -> torch.Tensor:
    """K7: one query token per row q [B, 1, Hq, D] against the first
    kv_lens[b] positions of its block table -> [B, 1, Hq, D] in q's dtype,
    the scaled logits soft-capped as cap * tanh(s / cap) when
    logits_softcap is given. Streams only the named pages; a row with
    kv_len 0 gives zeros. D = 128 or 256 on the card."""
    global paged_decode_launches
    _check_shapes("paged_decode_attention", q, cache_k, cache_v, meta)
    if q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention: {q.shape[1]} query tokens per row, expected 1")
    if logits_softcap is not None and not logits_softcap > 0:
        raise ValueError(f"paged_decode_attention: soft cap {logits_softcap}; expected > 0")
    if _on_cpu(q, cache_k, cache_v, meta.block_tables, meta.kv_lens):
        return paged_decode_attention_plain(q, cache_k, cache_v, meta, scale=scale,
                                            logits_softcap=logits_softcap)
    tables, kv_lens = _check_card("paged_decode_attention", q, cache_k, cache_v, meta,
                                  head_dims=(128, 256))
    B, _, Hq, D = q.shape
    H, _, page, s_page, s_slot, s_head = _pool_geometry(cache_k, meta.head_major)
    if Hq // H > 16:
        raise ValueError(f"paged_decode_attention: {Hq // H} query heads per kv head; "
                         "the kernel takes at most 16")
    out = torch.empty_like(q)
    if B == 0:
        return out
    MP = tables.shape[1]
    splits, per = _decode_splits(B, H, MP * page, D, q.device)
    parts = splits * 4  # one partial per warp
    part_o = torch.empty(B, Hq, parts, D, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(B, Hq, parts, 2, dtype=torch.float32, device=q.device)
    fn = kernels.function("paged_decode", "paged_decode",
                          [_P] * 8 + [_I] * 7 + [_L] * 3 + [_I, _I, ctypes.c_float,
                                                              ctypes.c_float, _P])
    err = fn(kernels.ptr(q), kernels.ptr(cache_k), kernels.ptr(cache_v), kernels.ptr(tables),
             kernels.ptr(kv_lens), kernels.ptr(part_o), kernels.ptr(part_ml), kernels.ptr(out),
             B, Hq, H, MP, page, page.bit_length() - 1, splits, s_page, s_slot, s_head, per, D,
             float(scale), float(logits_softcap or 0.0), _P(kernels.stream_ptr(q.device)))
    kernels.check(err, "paged_decode")
    paged_decode_launches += 1
    return out
