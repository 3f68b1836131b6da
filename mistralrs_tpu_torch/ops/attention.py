"""Scaled-dot-product attention, written as plain torch einsum/softmax in f32.

Counterpart of mistralrs_tpu/ops/attention.py (`NEG_INF`,
`causal_mask_bias`, `sdpa`, `sdpa_head_major`). GQA folds the query-head group axis into the
einsum instead of repeating K/V. Masks are additive f32 biases (0 = keep,
NEG_INF = drop).
"""

from __future__ import annotations

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def causal_mask_bias(
    q_len: int,
    kv_len: int,
    *,
    q_offsets: torch.Tensor | None = None,
    sliding_window: int | None = None,
    device=None,
) -> torch.Tensor:
    """Additive causal (+ optional sliding-window) bias.

    q_offsets: [B] absolute position of each row's first query token
    (queries attend to kv positions <= q_offset + i). Returns
    [B, 1, q_len, kv_len] if q_offsets is given, else [1, 1, q_len, kv_len]."""
    if q_offsets is not None:
        device = q_offsets.device
    q_ids = torch.arange(q_len, device=device)[:, None]
    kv_ids = torch.arange(kv_len, device=device)[None, :]
    if q_offsets is not None:
        q_pos = q_ids[None] + q_offsets[:, None, None].to(torch.int64)  # [B, T, 1]
    else:
        q_pos = q_ids[None]
    kv = kv_ids[None]
    keep = kv <= q_pos
    if sliding_window is not None:
        keep &= kv > q_pos - sliding_window
    bias = torch.where(keep, 0.0, NEG_INF).to(torch.float32)
    return bias[:, None]


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    mask: torch.Tensor | None = None,
    logits_softcap: float | None = None,
) -> torch.Tensor:
    """GQA attention. q [B,T,Hq,D], k/v [B,S,Hkv,D] -> [B,T,Hq,D].

    mask: additive bias broadcastable to [B, 1|Hq, T, S]. logits_softcap:
    Gemma-2's cap * tanh(s / cap) on the scaled scores, before the mask.
    Scores and softmax in f32; the probabilities are cast to v's dtype for
    the second product, as the JAX function does."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"sdpa: {Hq} query heads over {Hkv} kv heads")
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, D)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.to(torch.float32), k.to(torch.float32))
    scores = scores * scale
    if logits_softcap is not None:
        scores = logits_softcap * torch.tanh(scores / logits_softcap)
    if mask is not None:
        m = mask.to(torch.float32)
        if m.shape[1] == 1:
            m = m[:, :, None]
        else:
            m = m.reshape(m.shape[0], Hkv, G, *m.shape[2:])
        scores = scores + m
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype), v)
    return out.reshape(B, T, Hq, D)


def sdpa_head_major(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    mask: torch.Tensor | None = None,
    logits_softcap: float | None = None,
) -> torch.Tensor:
    """GQA attention over a head-major gathered context: q [B,T,Hq,D],
    k/v [Hkv,B,S,D] -> [B,T,Hq,D] in q's dtype.

    The paged gather of a head-major pool yields [Hkv, B, S, D]; the einsums
    read it in that order, with no transposed copy. mask: additive bias
    [B, 1, T, S] (or [1, T, S]); logits_softcap as in `sdpa`. Scores,
    softmax and the second product in f32 (v rounded to q's dtype first),
    as the JAX function does."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[0]
    if Hq % Hkv:
        raise ValueError(f"sdpa_head_major: {Hq} query heads over {Hkv} kv heads")
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, D)
    scores = torch.einsum("bthgd,hbsd->bhgts", qg.to(torch.float32), k.to(torch.float32))
    scores = scores * scale
    if logits_softcap is not None:
        scores = logits_softcap * torch.tanh(scores / logits_softcap)
    if mask is not None:
        m = mask if mask.dim() == 4 else mask[None]
        scores = scores + m[:, :, None].to(torch.float32)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,hbsd->bthgd", probs, v.to(q.dtype).to(torch.float32))
    return out.reshape(B, T, Hq, D).to(q.dtype)
