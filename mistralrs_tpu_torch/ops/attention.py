"""Scaled-dot-product attention, written as plain torch einsum/softmax in f32.

Counterpart of mistralrs_tpu/ops/attention.py (`NEG_INF`,
`block_attend`, `flash_combine`, `finalize_flash`, `causal_mask_bias`,
`sdpa`, `sdpa_head_major`). GQA folds the query-head group axis into the
einsum instead of repeating K/V. Masks are additive f32 biases (0 = keep,
NEG_INF = drop), or boolean keep masks in the online-softmax pieces.
"""

from __future__ import annotations

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def block_attend(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, keep: torch.Tensor, *,
                 logits_softcap: float | None = None):
    """Partial attention of queries against one key/value block, in
    running-softmax form (the blockwise building block), in f32.

    qg: [B, T, Hkv, G, D] pre-scaled queries; k/v: [B, S, Hkv, D]; keep:
    boolean mask broadcastable to [B, T, S]. Returns (bm, bl, bo): the
    block's max and exp-sum [B, Hkv, G, T] and its unnormalized output
    [B, T, Hkv, G, D]. A fully masked row gives bm = NEG_INF (finite), bl =
    0, bo = 0, which combine as nothing."""
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.to(torch.float32))
    if logits_softcap is not None:
        s = torch.tanh(s / logits_softcap) * logits_softcap
    keep = torch.broadcast_to(keep, (s.shape[0],) + tuple(s.shape[3:]))  # [B, T, S]
    s = torch.where(keep[:, None, None], s, NEG_INF)
    bm = torch.amax(s, dim=-1)  # [B, Hkv, G, T]
    # a fully masked row has exp(NEG_INF - NEG_INF) = 1: zero it explicitly
    p = torch.where(s > NEG_INF / 2, torch.exp(s - bm[..., None]), 0.0)
    bl = torch.sum(p, dim=-1)
    bo = torch.einsum("bhgts,bshd->bthgd", p, v.to(torch.float32))
    return bm, bl, bo


def flash_combine(m, l, acc, bm, bl, bo):
    """Merge one block's (bm, bl, bo) into the running (m, l, acc) (the
    online-softmax rescale). m/l/bm/bl: [B, Hkv, G, T]; acc/bo: [B, T, Hkv,
    G, D]. NEG_INF is finite, so a row never attended combines as the
    identity."""
    new_m = torch.maximum(m, bm)
    alpha = torch.exp(m - new_m)
    beta = torch.exp(bm - new_m)
    l = l * alpha + bl * beta

    def expand(x):  # [B, Hkv, G, T] -> [B, T, Hkv, G, 1]
        return x.permute(0, 3, 1, 2)[..., None]

    acc = acc * expand(alpha).to(acc.dtype) + bo * expand(beta).to(acc.dtype)
    return new_m, l, acc


def finalize_flash(l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """acc [B, T, Hkv, G, D] / l [B, Hkv, G, T] -> [B, T, Hkv * G, D]."""
    B, T, Hkv, G, D = acc.shape
    norm = l.permute(0, 3, 1, 2).reshape(B, T, Hkv * G)[..., None]
    return acc.reshape(B, T, Hkv * G, D) / torch.clamp(norm, min=1e-20).to(acc.dtype)


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
