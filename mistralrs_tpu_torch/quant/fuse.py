"""Projection fusion (q|k|v, gate|up), lm_head out-padding and the Q6_K requant.

Counterpart of mistralrs_tpu/quant/fuse.py. Fusion is a pure layout
transform: every packed layout here keeps `out` on the last axis of each
data tensor, so fused projections are concatenations along it, and each
output column's bytes stay independent. Fewer, wider GEMV calls also mean
fewer kernel launches per decode step.
"""

from __future__ import annotations

import dataclasses

import torch

from mistralrs_tpu_torch.quant.qlinear import Linear

# data keys concatenated on the out axis, per kind
_CAT_AXIS1 = {
    "dense": ("w",),
    "gguf_q4k": ("qs", "scale", "minv"),
    "gguf_q5k": ("qs", "qh", "scale", "minv"),
    "gguf_q8_0": ("q", "scale"),
    "gguf_q6k": ("ql", "qh", "scale"),
    "gguf_q2k": ("q", "scale", "minv"),
    **{f"gptq_{b}": ("q", "scale", "zs") for b in ("2", "4", "8", "b8")},
    **{f"hqq_{b}": ("q", "scale", "zs") for b in (1, 2, 3, 4, 8)},
}
# K-side constants shared by same-in linears (q6k permutation tables, the
# act-order input permutation of GPTQ)
_SHARED_K = ("perm", "inv_perm", "in_perm")


def fuse_linears(lins: list[Linear]) -> Linear | None:
    """Concatenate same-kind, same-in-features linears along out-features.
    Returns None when they cannot fuse (mixed kinds, metas, activation
    routes or biases, a ragged act-order g_idx gather, or act-order input
    permutations that differ: each GPTQ desc_act linear sorts its rows by
    its own g_idx, so only identical permutations hoist past the fused
    product). The fused Linear carries the first one's fields."""
    kind = lins[0].kind
    if kind not in _CAT_AXIS1 or any(l.kind != kind for l in lins):
        return None
    if len({(l.shape[0], l.meta, l.int8_act) for l in lins}) != 1:
        return None
    if any("g_idx" in l.data for l in lins):
        return None
    perms = [l.data.get("in_perm") for l in lins]
    if any(p is not None for p in perms) and not all(
            p is not None and torch.equal(p, perms[0]) for p in perms):
        return None
    has_bias = [l.data.get("b") is not None for l in lins]
    if any(has_bias) and not all(has_bias):
        return None
    data = {key: torch.cat([l.data[key] for l in lins], dim=-1) for key in _CAT_AXIS1[kind]}
    if all(has_bias):
        data["b"] = torch.cat([l.data["b"] for l in lins], dim=-1)
    for key in _SHARED_K:
        if key in lins[0].data:
            data[key] = lins[0].data[key]
    out = sum(l.shape[1] for l in lins)
    return dataclasses.replace(lins[0], shape=(lins[0].shape[0], out), data=data)


def split_linear(lin: Linear, sizes: list[int]) -> list[Linear] | None:
    """Inverse of fuse_linears: slice a Linear into out-feature spans
    (views). Returns None for kinds it cannot slice (a g_idx gather)."""
    if lin.kind not in _CAT_AXIS1 or "g_idx" in lin.data:
        return None
    if sum(sizes) != lin.shape[1]:
        raise ValueError(f"split sizes {sizes} do not add up to {lin.shape[1]}")
    outs = []
    off = 0
    for size in sizes:
        data = {key: lin.data[key][..., off : off + size] for key in _CAT_AXIS1[lin.kind]}
        if lin.data.get("b") is not None:
            data["b"] = lin.data["b"][..., off : off + size]
        for key in _SHARED_K:
            if key in lin.data:
                data[key] = lin.data[key]
        outs.append(dataclasses.replace(lin, shape=(lin.shape[0], size), data=data))
        off += size
    return outs


def pad_linear_out(lin: Linear, mult: int = 2048, max_pad: int | None = None) -> Linear | None:
    """Zero-pad a packed Linear's out-features to a multiple of `mult` (the
    Q4_K_M lm_head: 32000 -> 32768; an 8-expert router: 8 -> 16, the
    GEMVs' column chunk). Zero bytes and zero scales decode to w == 0 in
    every format here; the caller slices the padding off. Returns None for
    dense weights, a g_idx gather, or when padding would add more than
    `max_pad` columns (default out / 8)."""
    kind = lin.kind
    if kind not in _CAT_AXIS1 or kind == "dense" or "g_idx" in lin.data:
        return None
    out = lin.shape[1]
    pad = (-out) % mult
    if pad == 0:
        return lin
    if pad > (out // 8 if max_pad is None else max_pad):
        return None
    data = {key: torch.nn.functional.pad(lin.data[key], (0, pad)) for key in _CAT_AXIS1[kind]}
    if lin.data.get("b") is not None:
        data["b"] = torch.nn.functional.pad(lin.data["b"], (0, pad))
    for key in _SHARED_K:
        if key in lin.data:
            data[key] = lin.data[key]
    return dataclasses.replace(lin, shape=(lin.shape[0], out + pad), data=data)


def fuse_decoder_params(params):
    """Fuse q/k/v -> qkv (or q/k -> qk when v's kind differs, as in the
    Q4_K_M and Q5_K_M mixes), gate/up -> gateup in every layer, and pad the lm_head's
    vocab to the 2048 multiple. An MoE layer's experts stay as they are (the
    JAX package fuses gate|up only at the top level of the mlp); a packed
    router's out axis is padded to 16 columns, the GEMVs' column chunk
    (models/decoder._route slices it off). Returns new DecoderParams; the
    input is not changed."""
    layers = []
    for lp in params.layers:
        lp = dict(lp)
        attn = dict(lp["attn"])
        if all(k in attn for k in ("q", "k", "v")):
            fused = fuse_linears([attn["q"], attn["k"], attn["v"]])
            if fused is not None:
                attn = {k: v for k, v in attn.items() if k not in ("q", "k", "v")}
                attn["qkv"] = fused
            else:
                fused_qk = fuse_linears([attn["q"], attn["k"]])
                if fused_qk is not None:
                    attn = {k: v for k, v in attn.items() if k not in ("q", "k")}
                    attn["qk"] = fused_qk
        lp["attn"] = attn
        mlp = dict(lp["mlp"])
        if "gate" in mlp and "up" in mlp:
            fused = fuse_linears([mlp["gate"], mlp["up"]])
            if fused is not None:
                mlp = {k: v for k, v in mlp.items() if k not in ("gate", "up")}
                mlp["gateup"] = fused
        if "router" in mlp:
            mlp["router"] = pad_linear_out(mlp["router"], 16, max_pad=15) or mlp["router"]
        lp["mlp"] = mlp
        layers.append(lp)
    lm_head = params.lm_head
    if lm_head is not None:
        lm_head = pad_linear_out(lm_head) or lm_head
    return dataclasses.replace(params, layers=layers, lm_head=lm_head)


def requant_q6k_params(params, gs: int = 64):
    """Requantize every Q6_K Linear (layers and lm_head) to the int8 per-gs
    layout served by the K2 kernel (gguf_linear.requant_q6k_to_q8). A Q6_K
    expert stack (ql [E, in/2, out]) raises: the JAX package's requant
    fails on one too (its layer groups stack it to [L, E, ...], which
    requant_q6k_to_q8 cannot unpack), so such a model is served with
    rq8_group=None, on the Q6_K kernels."""
    from mistralrs_tpu_torch.quant.gguf_linear import requant_q6k_to_q8

    def conv(node):
        if isinstance(node, Linear):
            if node.kind != "gguf_q6k":
                return node
            if node.data["ql"].dim() != 2:
                raise NotImplementedError(
                    f"rq8 of a stacked Q6_K Linear (ql {tuple(node.data['ql'].shape)}, MoE "
                    "experts) is not supported, as in the JAX package; serve it with "
                    "rq8_group=None")
            return requant_q6k_to_q8(node, gs)
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return node

    return dataclasses.replace(params, layers=[conv(lp) for lp in params.layers],
                               lm_head=conv(params.lm_head))
