"""The decoder: llama/mistral/mixtral (prenorm) and gemma2 (sandwich) blocks
over the paged KV cache.

Counterpart of mistralrs_tpu/models/decoder.py for the serving path of a
llama/mistral/mixtral/gemma2 model: `_norm` (with gemma's (1 + w) offset),
`_mlp` (fused gate|up or separate), `_moe_mlp` (mixtral's sparse MoE block,
see below), `_attention` (fused q|k + v, fused qkv, or separate
projections; logit soft cap), `_block` in prenorm or sandwich form,
`decoder_forward` as a plain loop over layers (embedding scale, per-layer
sliding windows), and `compute_logits` (final logit soft cap).

The MoE block routes each token to its top-k experts (softmax over the
selected logits) and takes one of the JAX package's three formulations:
- dense (bf16) experts with `cfg.moe_grouped` (the pipeline sets it):
  the grouped dropless dispatch `_moe_mlp_grouped`, (token, expert) pairs
  sorted by expert through three grouped GEMMs (K13,
  ops/grouped_gemm.py) and added back, with nothing read on the host;
- packed (GGUF) experts stacked [E, ...]: every expert's Linear on every
  token, combined by the routing weights;
- dense experts without `moe_grouped`: the every-expert einsum.

Attention on the paged cache, routed once per step by the JAX package's
shape rules (without its backend checks and environment gates), in its
order; on the card a kernel is taken only where it takes the step (bf16,
its head dims, page and GQA ratio: `_card_takes`), else the step gathers:
- a first prompt chunk whose length is a multiple of 128, with no logit soft
  cap and no sliding window that clips it, runs the flash prefill kernel K6
  on the chunk's own K/V (ops/flash_attention.py);
- such a first chunk that K6 rejects for a soft cap or a clipping window
  (and a windowed pattern) runs the splash kernel K11 (ops/splash.py), with
  the window on the layers that use one;
- decode (T = 1) on a head-major pool at a span of 4096 or more, no longer
  than the sliding window if there is one, runs the block-table decode
  kernel K7 (ops/paged_attention.py), soft cap included;
- a continuation chunk of 128-row blocks at a span of at most 4096, without
  a soft cap, runs the paged continuation kernel K6' over either pool
  layout;
- any other continuation chunk at a span past 4096, and decode at a span
  past `_BLOCKWISE_DECODE_SPAN` (16,384), takes the blockwise route
  `blockwise_prefill_continuation` (ops/paged_attention.py), an
  online-softmax walk over 1024-token key blocks whose memory does not grow
  with the span (the JAX package's route for these steps, plain PyTorch as
  JAX's is plain XLA), with the layer's window and the soft cap;
- everything else gathers its pages and runs the f32 einsum `sdpa`, or
  `sdpa_head_major` on a head-major pool (ops/attention.py), soft cap
  included.
The new K/V are written into the pool in place before any of them.

An int8 pool (`PagedKVCache.quantized`) reaches each layer as (payload,
scale) pairs: the new K/V go in through `write_paged_kv_q`, K7 and K6'
never take it (they stream bf16), first chunks keep K6 and K11 (their
context is the chunk's own K/V), and the gather route dequantizes with
`gather_paged_kv_q`; the blockwise route dequantizes block by block.

On the ragged backend (a combined K/V pool, `cache.v` None) the same first
chunks still take K6 or K11 on the chunk's own K/V; every other step, a
continuation chunk or decode at any span, runs the ragged paged attention
kernel K12 (ops/ragged_attention.py) with the layer's window, unless the
span fits inside it, and the soft cap, or, where the card's K12 does not
take the step, the gather route over the pool's split K/V views (the JAX
package's off-TPU route); K6' and K7 are never taken on a combined pool.
The new K/V go in with `write_combined_kv`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.ops import layers as L
from mistralrs_tpu_torch.ops.attention import NEG_INF, causal_mask_bias, sdpa, sdpa_head_major
from mistralrs_tpu_torch.ops.flash_attention import flash_prefill
from mistralrs_tpu_torch.ops.grouped_gemm import grouped_matmul
from mistralrs_tpu_torch.ops.paged_attention import (
    PagedAttnMeta,
    PagedKVCache,
    blockwise_prefill_continuation,
    flash_prefill_continuation,
    gather_paged_kv,
    gather_paged_kv_q,
    paged_decode_attention,
    write_paged_kv,
    write_paged_kv_q,
)
from mistralrs_tpu_torch.ops.ragged_attention import (
    RaggedPlan,
    ragged_attention_padded,
    ragged_plan,
    split_combined,
    write_combined_kv,
)
from mistralrs_tpu_torch.ops.rope import RopeTable, apply_rope
from mistralrs_tpu_torch.ops.splash import splash_prefill
from mistralrs_tpu_torch.quant.qlinear import Linear, linear


# forwards that took the "blockwise" route (a graph replay adds its
# capture's count, as for the kernels' launch counters)
blockwise_steps = 0


@dataclasses.dataclass
class DecoderParams:
    """Model parameters: one dict per layer ({"attn": {...Linear},
    "mlp": {...Linear}, "input_norm": {"w"}, "post_attn_norm": {"w"}}, and
    "pre_mlp_norm", "post_mlp_norm" in the sandwich form). An MoE layer's
    "mlp" is {"router": Linear [H -> E], "experts": {"gate", "up", "down"}}
    with each expert Linear stacked on a leading expert axis: dense "w"
    [E, H, I] / [E, I, H], or packed tensors [E, ...] sharing one K-side
    permutation table."""

    embed: torch.Tensor  # [V, E]
    layers: list[dict[str, Any]]
    final_norm: dict[str, torch.Tensor]
    lm_head: Linear | None = None  # None => tied to embed

    @property
    def num_layers(self) -> int:
        return len(self.layers)


def _use_flash_prefill(cfg: ModelConfig, T: int, meta: PagedAttnMeta) -> bool:
    """First-chunk flash eligibility, the JAX package's shape rule: a first
    chunk of 128-row blocks, no logit soft cap, and no sliding window that
    clips it."""
    if T < 128 or T % 128 or not meta.first_chunk:
        return False
    if cfg.attn_logit_softcap is not None:
        return False
    return not (cfg.sliding_window is not None and cfg.sliding_window < T)


def _use_splash_prefill(cfg: ModelConfig, T: int, meta: PagedAttnMeta) -> bool:
    """Splash (K11) eligibility, the JAX package's shape rule without its
    environment gate: a first chunk of 128-row blocks that K6 rejects for a
    logit soft cap or for a sliding window (of a windowed pattern) that
    clips inside the chunk."""
    if T < 128 or T % 128 or not meta.first_chunk:
        return False
    window_clips = (cfg.sliding_window is not None and cfg.sliding_window_pattern != "none"
                    and cfg.sliding_window < T)
    # the simple case (no softcap, window >= chunk) belongs to plain flash
    return cfg.attn_logit_softcap is not None or window_clips


def _use_flash_continuation(cfg: ModelConfig, T: int, meta: PagedAttnMeta, span: int) -> bool:
    """Continuation-chunk kernel (K6') eligibility, the JAX package's shape
    rule: a later chunk of 128-row blocks whose span (block-table width x
    page) is a multiple of 128 and at most 4096, no logit soft cap, and no
    sliding window that clips the span."""
    if T < 128 or T % 128 or meta.first_chunk:
        return False
    if span % 128 or span > 4096:
        return False
    if cfg.attn_logit_softcap is not None:
        return False
    return not (cfg.sliding_window is not None and cfg.sliding_window < span)


# decode (T = 1) leaves the one-shot gather for the blockwise route past
# this span (JAX decoder.py:128-133); a module constant, so a test can
# lower it
_BLOCKWISE_DECODE_SPAN = 16384


def _use_blockwise_continuation(cfg: ModelConfig, T: int, meta: PagedAttnMeta, span: int) -> bool:
    """Blockwise route eligibility, the JAX package's rule: a step that is
    not a first chunk, with more than one query row at a span past 4096, or
    one (decode) at a span past _BLOCKWISE_DECODE_SPAN."""
    if meta.first_chunk:
        return False
    if T > 1:
        return span > 4096
    return span > _BLOCKWISE_DECODE_SPAN


def _use_paged_decode_kernel(cfg: ModelConfig, T: int, meta: PagedAttnMeta, span: int) -> bool:
    """Block-table decode kernel (K7) eligibility, the JAX package's shape
    rule: one query token, a head-major pool, a span of at least 4096, and
    no sliding window that could clip the span (the kernel masks by length
    only)."""
    if T != 1 or not meta.head_major or span < 4096:
        return False
    if cfg.sliding_window is None or cfg.sliding_window_pattern == "none":
        return True
    return span <= cfg.sliding_window


# What each card kernel takes beyond the shape rules: its wrapper's checks
# (ops/flash_attention.py, ops/splash.py, ops/paged_attention.py,
# ops/ragged_attention.py). Every one takes bf16 only.
_CARD_HEAD_DIMS = {"flash": (128,), "splash": (128, 256), "decode": (128, 256),
                   "continuation": (128,), "ragged": (128, 256)}


def _card_takes(route: str, cfg: ModelConfig, dtype, kv_dtype, page: int) -> bool:
    """Whether the card kernel of `route` takes a step of this model: bf16
    activations (and pool, for the kernels that read it), a head dim it
    has, a power-of-two page (K6', K7, K12), at most 16 query heads a kv
    head (K7), and a GQA ratio that is a power of two up to 16 (K12)."""
    if dtype != torch.bfloat16 or cfg.head_dim not in _CARD_HEAD_DIMS[route]:
        return False
    if route in ("flash", "splash"):  # the chunk's own K/V, in the activations' dtype
        return True
    if kv_dtype != torch.bfloat16 or page & (page - 1):
        return False
    G = cfg.num_heads // cfg.num_kv_heads
    if route == "decode":
        return G <= 16
    if route == "ragged":
        return G & (G - 1) == 0 and G <= 16
    return True


def _attention_route(cfg: ModelConfig, T: int, meta: PagedAttnMeta, span: int,
                     combined: bool = False, device_type: str = "cpu",
                     dtype=torch.bfloat16, kv_dtype=torch.bfloat16, page: int = 16) -> str:
    """The step's attention route, the same for every layer: "flash" (K6),
    "splash" (K11), "decode" (K7), "continuation" (K6'), "blockwise" or
    "gather"; on a combined pool "flash", "splash", "ragged" (K12) or
    "gather" (over the pool's split K/V views). `kv_dtype` is the pool's
    payload dtype: int8 for a quantized pool, which K7 and K6' never take.

    The rule: the JAX package's shape rules pick a route, in the order
    above. On "cuda" a kernel is picked only if its card kernel also takes
    the step (`_card_takes`: the activations' and pool's dtype, head dim,
    page, GQA ratio), so the wrappers never refuse it; a step that no
    kernel takes goes to the blockwise or the gather route, as in the JAX
    package. On the CPU the plain versions take any shape, so the shape
    rules alone decide."""
    card = device_type == "cuda"
    quant = kv_dtype == torch.int8

    def takes(route: str) -> bool:
        return not card or _card_takes(route, cfg, dtype, kv_dtype, page)

    if _use_flash_prefill(cfg, T, meta) and takes("flash"):
        return "flash"
    if _use_splash_prefill(cfg, T, meta) and takes("splash"):
        return "splash"
    if combined:
        return "ragged" if takes("ragged") else "gather"
    if not quant and _use_paged_decode_kernel(cfg, T, meta, span) and takes("decode"):
        return "decode"
    if not quant and _use_flash_continuation(cfg, T, meta, span) and takes("continuation"):
        return "continuation"
    if _use_blockwise_continuation(cfg, T, meta, span):
        return "blockwise"
    return "gather"


def _norm(cfg: ModelConfig, p: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return L.rms_norm(x, p["w"], cfg.norm_eps, offset=cfg.norm_offset)


def _mlp(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    act = L.ACTIVATIONS[cfg.act]
    if "gateup" in p:  # fused gate/up projection (quant/fuse.py)
        gu = linear(p["gateup"], x)
        I = cfg.intermediate_size
        return linear(p["down"], act(gu[..., :I]) * gu[..., I:])
    return linear(p["down"], act(linear(p["gate"], x)) * linear(p["up"], x))


def _expert_slice(lin: Linear, e: int) -> Linear:
    """Expert e's Linear out of stacked packed expert tensors [E, ...] (the
    K-side permutation tables are shared by the experts)."""
    data = {k: (v if k in ("perm", "inv_perm") else v[e]) for k, v in lin.data.items()}
    return dataclasses.replace(lin, data=data)


def _route(cfg: ModelConfig, p: dict[str, Any], xt: torch.Tensor):
    """Top-k routing of tokens xt [N, H]: (weights [N, k] f32, the softmax
    over the selected logits; expert ids [N, k] int64). The router's out
    axis may carry padding (quant/fuse.py), which comes off first. A tie
    puts the lower expert index first, as jax.lax.top_k does: a stable
    descending sort, since torch.topk promises no order among equals."""
    logits = linear(p["router"], xt)[:, : cfg.num_experts].to(torch.float32)
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    return torch.softmax(vals[:, :k], dim=-1), ids[:, :k]


def _moe_mlp(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Mixtral's sparse MoE block (the three formulations of the module
    docstring; all compute the same per-pair math)."""
    ex = p["experts"]
    if cfg.moe_grouped and ex["gate"].kind == "dense":
        return _moe_mlp_grouped(cfg, p, x)
    B, T, H = x.shape
    xt = x.reshape(B * T, H)
    topw, topi = _route(cfg, p, xt)
    # the combine weights as a dense [N, E] matrix
    combine = torch.zeros(B * T, cfg.num_experts, dtype=torch.float32, device=x.device)
    combine.scatter_add_(1, topi, topw)
    act = L.ACTIVATIONS[cfg.act]
    if ex["gate"].kind != "dense":
        # packed experts: each expert's GEMV (or dequant + matmul) on every
        # token, weighted by its column of the combine matrix
        out = torch.zeros_like(xt)
        comb = combine.to(xt.dtype)
        for e in range(cfg.num_experts):
            g = linear(_expert_slice(ex["gate"], e), xt)
            u = linear(_expert_slice(ex["up"], e), xt)
            d = linear(_expert_slice(ex["down"], e), act(g) * u)
            out = out + d * comb[:, e : e + 1]
        return out.reshape(B, T, H)
    g = torch.einsum("nh,ehi->eni", xt, ex["gate"].data["w"].to(xt.dtype))
    u = torch.einsum("nh,ehi->eni", xt, ex["up"].data["w"].to(xt.dtype))
    d = torch.einsum("eni,eih->enh", act(g) * u, ex["down"].data["w"].to(xt.dtype))
    return torch.einsum("enh,ne->nh", d, combine.to(d.dtype)).reshape(B, T, H)


def _moe_mlp_grouped(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Grouped dropless dispatch: the N * k (token, expert) pairs sorted by
    expert (stably, so each group keeps token order) feed three grouped
    GEMMs, and each pair's output, times its routing weight, is added back
    onto its token. Nothing waits for the device: the group sizes are a
    scatter-add into [E] int32 (torch.bincount would read the max on the
    host), and the grouped GEMM reads them on the device. Each output row
    gets exactly k addends onto zero, so with k = 2 the sum does not depend
    on the order index_add_ adds them in."""
    B, T, H = x.shape
    N = B * T
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    xt = x.reshape(N, H)
    topw, topi = _route(cfg, p, xt)
    eid = topi.reshape(-1)  # [N * K], pair i is token i // K
    order = torch.argsort(eid, stable=True)
    tok_sorted = torch.div(order, K, rounding_mode="floor")
    gathered = torch.index_select(xt, 0, tok_sorted)  # [N * K, H]
    group_sizes = torch.zeros(E, dtype=torch.int32, device=x.device)
    group_sizes.scatter_add_(0, eid, torch.ones_like(eid, dtype=torch.int32))
    act = L.ACTIVATIONS[cfg.act]
    ex = p["experts"]
    g = grouped_matmul(gathered, ex["gate"].data["w"].to(xt.dtype), group_sizes)
    u = grouped_matmul(gathered, ex["up"].data["w"].to(xt.dtype), group_sizes)
    d = grouped_matmul(act(g) * u, ex["down"].data["w"].to(xt.dtype), group_sizes)  # [N * K, H]
    w_pair = torch.index_select(topw.reshape(-1), 0, order).to(d.dtype)
    out = torch.zeros(N, H, dtype=d.dtype, device=x.device)
    out.index_add_(0, tok_sorted, d * w_pair[:, None])
    return out.reshape(B, T, H).to(x.dtype)


def _attention(
    cfg: ModelConfig,
    p: dict[str, Any],
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    rot_dim: int,
    cache_k,
    cache_v,
    meta: PagedAttnMeta,
    route: str,
    bias: torch.Tensor | None,
    window: int | None,
    plan: RaggedPlan | None,
) -> torch.Tensor:
    """One layer's attention; `window` is the layer's sliding window (None
    on a global layer), read by the splash, ragged and blockwise routes (the
    gather route's `bias` already holds it). cache_v is None on a combined
    pool, whose step packing `plan` the ragged route reads; an int8 pool's
    cache_k and cache_v are (payload, scale) pairs."""
    B, T, _ = x.shape
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "qkv" in p:  # fused projection (quant/fuse.py)
        qkv = linear(p["qkv"], x)
        q = qkv[..., : Hq * D].reshape(B, T, Hq, D)
        k = qkv[..., Hq * D : (Hq + Hkv) * D].reshape(B, T, Hkv, D)
        v = qkv[..., (Hq + Hkv) * D :].reshape(B, T, Hkv, D)
    elif "qk" in p:  # partial fusion: q+k same kind, v differs (Q4_K_M mix)
        qk = linear(p["qk"], x)
        q = qk[..., : Hq * D].reshape(B, T, Hq, D)
        k = qk[..., Hq * D :].reshape(B, T, Hkv, D)
        v = linear(p["v"], x).reshape(B, T, Hkv, D)
    else:
        q = linear(p["q"], x).reshape(B, T, Hq, D)
        k = linear(p["k"], x).reshape(B, T, Hkv, D)
        v = linear(p["v"], x).reshape(B, T, Hkv, D)
    q = apply_rope(q, cos, sin, rot_dim)
    k = apply_rope(k, cos, sin, rot_dim)
    scale = cfg.query_scale if cfg.query_scale is not None else D**-0.5
    cap = cfg.attn_logit_softcap
    hm = meta.head_major
    kv_quant = isinstance(cache_k, tuple)
    if kv_quant:
        write_paged_kv_q(cache_k, cache_v, k, v, meta.slot_mapping, head_major=hm)
    elif cache_v is None:
        write_combined_kv(cache_k, k, v, meta.slot_mapping)
    else:
        write_paged_kv(cache_k, cache_v, k, v, meta.slot_mapping, head_major=hm)
    if route == "flash":
        # first prefill chunk: its own K/V is the whole context, so no paged
        # gather and no [B, Hq, T, T] scores in memory
        out = flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(), scale)
        # zero padding rows (they attended garbage) via the active mask
        out = out * meta.active[:, None, None, None].to(out.dtype)
    elif route == "splash":
        out = splash_prefill(q.contiguous(), k.contiguous(), v.contiguous(), scale=scale,
                             sliding_window=window, logits_softcap=cap)
        out = out * meta.active[:, None, None, None].to(out.dtype)
    elif route == "decode":
        # streams only the pages each row's table names
        out = paged_decode_attention(q.contiguous(), cache_k, cache_v, meta, scale=scale,
                                     logits_softcap=cap)
    elif route == "continuation":
        out = flash_prefill_continuation(q.contiguous(), cache_k, cache_v, meta, scale=scale)
        out = out * meta.active[:, None, None, None].to(out.dtype)
    elif route == "ragged":
        # one kernel for continuation chunks and decode; a span that fits
        # inside the window needs no window mask (the JAX package's window_ok)
        span = meta.block_tables.shape[1] * cache_k.shape[1]
        win = window if window is not None and span > window else None
        out = ragged_attention_padded(q.contiguous(), cache_k, meta, scale=scale,
                                      sliding_window=win, logits_softcap=cap, plan=plan)
        out = out * meta.active[:, None, None, None].to(out.dtype)
    elif route == "blockwise":
        # a span that fits inside the window needs no window mask (JAX's window_ok)
        pool = cache_k[0] if kv_quant else cache_k
        span = meta.block_tables.shape[1] * (pool.shape[2] if hm else pool.shape[1])
        win = window if window is not None and span > window else None
        out = blockwise_prefill_continuation(q, cache_k, cache_v, meta, scale=scale,
                                             sliding_window=win, logits_softcap=cap)
        out = out * meta.active[:, None, None, None].to(out.dtype)
    else:
        if kv_quant:
            ctx_k, ctx_v = gather_paged_kv_q(cache_k, cache_v, meta.block_tables, head_major=hm,
                                             dtype=q.dtype)
        elif cache_v is None:  # a combined pool: its split K/V views, token-major
            ctx_k, ctx_v = gather_paged_kv(*split_combined(cache_k), meta.block_tables)
        else:
            ctx_k, ctx_v = gather_paged_kv(cache_k, cache_v, meta.block_tables, head_major=hm)
        attn = sdpa_head_major if hm else sdpa
        out = attn(q, ctx_k.to(q.dtype), ctx_v.to(q.dtype), scale=scale, mask=bias,
                   logits_softcap=cap)
    return linear(p["o"], out.reshape(B, T, Hq * D))


def _block(cfg, p, h, cos, sin, rot_dim, ck, cv, meta, route, bias, window, plan):
    mlp_fn = _moe_mlp if cfg.is_moe else _mlp
    x = _norm(cfg, p["input_norm"], h)
    attn = _attention(cfg, p["attn"], x, cos, sin, rot_dim, ck, cv, meta, route, bias, window,
                      plan)
    if cfg.block_style == "sandwich":  # gemma2
        h = h + _norm(cfg, p["post_attn_norm"], attn)
        x = _norm(cfg, p["pre_mlp_norm"], h)
        return h + _norm(cfg, p["post_mlp_norm"], mlp_fn(cfg, p["mlp"], x))
    h = h + attn
    return h + mlp_fn(cfg, p["mlp"], _norm(cfg, p["post_attn_norm"], h))


def decoder_forward(
    params: DecoderParams,
    cfg: ModelConfig,
    rope: RopeTable,
    input_ids: torch.Tensor,  # [B, T] int
    cache: PagedKVCache,
    meta: PagedAttnMeta,
) -> tuple[torch.Tensor, PagedKVCache]:
    """Run the decoder stack. Returns (hidden [B, T, E], cache); the cache's
    pools are updated in place (the returned cache is the same object).
    Each layer gets its views of the pools: of an int8 pool, (payload,
    scale) pairs."""
    global blockwise_steps
    B, T = input_ids.shape
    h = params.embed[input_ids.to(torch.int64)]
    if cfg.embed_scale != 1.0:
        # the scale rounded to the embedding's dtype first, as the JAX package does
        h = h * torch.tensor(cfg.embed_scale, dtype=h.dtype)
    cos, sin = rope.gather(meta.positions.to(torch.int64))  # [B, T, rot/2]
    S = meta.block_tables.shape[1] * cache.page_size
    route = _attention_route(cfg, T, meta, S, combined=cache.combined,
                             device_type=h.device.type, dtype=h.dtype, kv_dtype=cache.k.dtype,
                             page=cache.page_size)
    if route == "blockwise":
        blockwise_steps += 1
    # the ragged route's packing of this step, the same in every layer
    plan = ragged_plan(meta, T, cache.page_size) if route == "ragged" else None
    bias_full = bias_win = None
    if route == "gather":
        # masks built once per step (only for the gather route), picked per layer
        kv_lens = meta.kv_lens.to(torch.int64)
        q_offsets = kv_lens - T
        pad = torch.where(torch.arange(S, device=h.device)[None] < kv_lens[:, None], 0.0, NEG_INF)
        bias_full = causal_mask_bias(T, S, q_offsets=q_offsets) + pad[:, None, None, :]
        bias_win = bias_full
        if cfg.sliding_window is not None and cfg.sliding_window_pattern != "none":
            bias_win = causal_mask_bias(T, S, q_offsets=q_offsets,
                                        sliding_window=cfg.sliding_window) + pad[:, None, None, :]
    for i, lp in enumerate(params.layers):
        local = cfg.layer_uses_sliding_window(i)
        if cache.quantized:
            ck, cv = (cache.k[i], cache.k_scale[i]), (cache.v[i], cache.v_scale[i])
        else:
            ck, cv = cache.k[i], None if cache.combined else cache.v[i]
        h = _block(cfg, lp, h, cos, sin, rope.rot_dim, ck, cv, meta, route,
                   bias_win if local else bias_full, cfg.sliding_window if local else None, plan)
    return _norm(cfg, params.final_norm, h), cache


def compute_logits(params: DecoderParams, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h [..., E] -> f32 logits [..., V], soft-capped in f32 when the model
    has a final logit soft cap (gemma2)."""
    if params.lm_head is not None:
        logits = linear(params.lm_head, h)
        if logits.shape[-1] != cfg.vocab_size:
            # lm_head out-padded (quant/fuse.pad_linear_out): the padded
            # columns are zeros, but real logits can all be negative, so they
            # come off before argmax
            logits = logits[..., : cfg.vocab_size]
    else:
        logits = torch.matmul(h, params.embed.to(h.dtype).T)
    logits = logits.to(torch.float32)
    if cfg.final_logit_softcap is not None:
        logits = L.softcap(logits, cfg.final_logit_softcap)
    return logits
