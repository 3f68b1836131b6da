"""The decoder: prenorm llama/mistral blocks over the paged KV cache.

Counterpart of mistralrs_tpu/models/decoder.py for the serving path of a
dense llama/mistral model: `_norm`, `_mlp` (fused gate|up or separate),
`_attention` (fused q|k + v, fused qkv, or separate projections), `_block`
in prenorm form, `decoder_forward` as a plain loop over layers, and
`compute_logits`.

Attention on the paged cache:
- a first prompt chunk whose length is a multiple of 128 (and whose sliding
  window, if any, does not clip it) runs the flash prefill kernel K6 on the
  chunk's own K/V (ops/flash_attention.py);
- decode and every other chunk gather their pages and run the f32 einsum
  `sdpa` (ops/attention.py).
The new K/V are written into the pool in place before either.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.ops import layers as L
from mistralrs_tpu_torch.ops.attention import NEG_INF, causal_mask_bias, sdpa
from mistralrs_tpu_torch.ops.flash_attention import flash_prefill
from mistralrs_tpu_torch.ops.paged_attention import (
    PagedAttnMeta,
    PagedKVCache,
    gather_paged_kv,
    write_paged_kv,
)
from mistralrs_tpu_torch.ops.rope import RopeTable, apply_rope
from mistralrs_tpu_torch.quant.qlinear import Linear, linear


@dataclasses.dataclass
class DecoderParams:
    """Model parameters: one dict per layer ({"attn": {...Linear},
    "mlp": {...Linear}, "input_norm": {"w"}, "post_attn_norm": {"w"}})."""

    embed: torch.Tensor  # [V, E]
    layers: list[dict[str, Any]]
    final_norm: dict[str, torch.Tensor]
    lm_head: Linear | None = None  # None => tied to embed

    @property
    def num_layers(self) -> int:
        return len(self.layers)


def _use_flash_prefill(cfg: ModelConfig, T: int, meta: PagedAttnMeta) -> bool:
    """First-chunk flash eligibility, the JAX package's shape rule: a first
    chunk of 128-row blocks whose sliding window does not clip it."""
    if T < 128 or T % 128 or not meta.first_chunk:
        return False
    return not (cfg.sliding_window is not None and cfg.sliding_window < T)


def _norm(cfg: ModelConfig, p: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return L.rms_norm(x, p["w"], cfg.norm_eps)


def _mlp(cfg: ModelConfig, p: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    act = L.ACTIVATIONS[cfg.act]
    if "gateup" in p:  # fused gate/up projection (quant/fuse.py)
        gu = linear(p["gateup"], x)
        I = cfg.intermediate_size
        return linear(p["down"], act(gu[..., :I]) * gu[..., I:])
    return linear(p["down"], act(linear(p["gate"], x)) * linear(p["up"], x))


def _attention(
    cfg: ModelConfig,
    p: dict[str, Any],
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    rot_dim: int,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    meta: PagedAttnMeta,
    bias: torch.Tensor | None,
) -> torch.Tensor:
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
    write_paged_kv(cache_k, cache_v, k, v, meta.slot_mapping)
    if _use_flash_prefill(cfg, T, meta):
        # first prefill chunk: its own K/V is the whole context, so no paged
        # gather and no [B, Hq, T, T] scores in memory
        out = flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(), scale)
        # zero padding rows (they attended garbage) via the active mask
        out = out * meta.active[:, None, None, None].to(out.dtype)
    else:
        ctx_k, ctx_v = gather_paged_kv(cache_k, cache_v, meta.block_tables)
        out = sdpa(q, ctx_k.to(q.dtype), ctx_v.to(q.dtype), scale=scale, mask=bias)
    return linear(p["o"], out.reshape(B, T, Hq * D))


def _block(cfg, p, h, cos, sin, rot_dim, ck, cv, meta, bias):
    x = _norm(cfg, p["input_norm"], h)
    h = h + _attention(cfg, p["attn"], x, cos, sin, rot_dim, ck, cv, meta, bias)
    return h + _mlp(cfg, p["mlp"], _norm(cfg, p["post_attn_norm"], h))


def decoder_forward(
    params: DecoderParams,
    cfg: ModelConfig,
    rope: RopeTable,
    input_ids: torch.Tensor,  # [B, T] int
    cache: PagedKVCache,
    meta: PagedAttnMeta,
) -> tuple[torch.Tensor, PagedKVCache]:
    """Run the decoder stack. Returns (hidden [B, T, E], cache); the cache's
    pools are updated in place (the returned cache is the same object)."""
    B, T = input_ids.shape
    h = params.embed[input_ids.to(torch.int64)]
    cos, sin = rope.gather(meta.positions.to(torch.int64))  # [B, T, rot/2]
    bias_full = bias_win = None
    if not _use_flash_prefill(cfg, T, meta):
        # masks built once per step, picked per layer
        S = meta.block_tables.shape[1] * cache.page_size
        kv_lens = meta.kv_lens.to(torch.int64)
        q_offsets = kv_lens - T
        pad = torch.where(torch.arange(S, device=h.device)[None] < kv_lens[:, None], 0.0, NEG_INF)
        bias_full = causal_mask_bias(T, S, q_offsets=q_offsets) + pad[:, None, None, :]
        bias_win = bias_full
        if cfg.sliding_window is not None and cfg.sliding_window_pattern != "none":
            bias_win = causal_mask_bias(T, S, q_offsets=q_offsets,
                                        sliding_window=cfg.sliding_window) + pad[:, None, None, :]
    for i, lp in enumerate(params.layers):
        bias = bias_win if cfg.layer_uses_sliding_window(i) else bias_full
        h = _block(cfg, lp, h, cos, sin, rope.rot_dim, cache.k[i], cache.v[i], meta, bias)
    return _norm(cfg, params.final_norm, h), cache


def compute_logits(params: DecoderParams, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h [..., E] -> f32 logits [..., V]."""
    if params.lm_head is not None:
        logits = linear(params.lm_head, h)
        if logits.shape[-1] != cfg.vocab_size:
            # lm_head out-padded (quant/fuse.pad_linear_out): the padded
            # columns are zeros, but real logits can all be negative, so they
            # come off before argmax
            logits = logits[..., : cfg.vocab_size]
    else:
        logits = torch.matmul(h, params.embed.to(h.dtype).T)
    return logits.to(torch.float32)
