"""Model construction helpers: the rope table and weights carried across.

Counterpart of mistralrs_tpu/models/loader.py for `make_rope`. Loading HF
safetensors and GGUF files is later work; `params_from_reference` carries a
JAX-package `DecoderParams` (after ``jax.tree.map(np.asarray, ...)``, so its
leaves are numpy arrays) into this package's parameters, reading it by duck
typing so that nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.decoder import DecoderParams
from mistralrs_tpu_torch.ops.rope import RopeTable, compute_rope_table
from mistralrs_tpu_torch.quant.qlinear import Linear


def make_rope(cfg: ModelConfig, max_pos: int | None = None, device="cuda") -> RopeTable:
    return compute_rope_table(
        cfg.head_dim,
        max_pos or cfg.max_position_embeddings,
        theta=cfg.rope_theta,
        rope_scaling=cfg.rope_scaling,
        device=device,
    )


def _tensor(a, device, dtype, keep_f32: bool = False) -> torch.Tensor:
    """numpy -> torch on `device`. Integer arrays (packed bytes, int8
    weights, permutations) keep their values and type (int32 indices widen
    to int64 for torch indexing); float arrays become `dtype`, or stay f32
    when `keep_f32` (the rq8 scales the int8 kernel reads as f32)."""
    a = np.asarray(a)
    if not a.flags.writeable:  # torch.from_numpy wants memory it may write
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == torch.int32:
        t = t.to(torch.int64)
    if t.is_floating_point():
        t = t.to(torch.float32 if keep_f32 and t.dtype == torch.float32 else dtype)
    return t.to(device)


def _is_linear(x) -> bool:
    return all(hasattr(x, a) for a in ("kind", "shape", "data", "meta"))


def _linear(lin, device, dtype, index=None) -> Linear:
    rq8 = lin.kind == "gguf_q8_0" and lin.meta is not None
    data = {}
    for k, v in lin.data.items():
        v = np.asarray(v)
        if index is not None:  # stacked groups stack every leaf, perms too
            v = v[index]
        data[k] = _tensor(v, device, dtype, keep_f32=rq8 and k == "scale")
    return Linear(kind=lin.kind, shape=tuple(lin.shape), data=data, meta=lin.meta)


def _convert(node, device, dtype, index=None):
    if _is_linear(node):
        return _linear(node, device, dtype, index)
    if isinstance(node, dict):
        return {k: _convert(v, device, dtype, index) for k, v in node.items()}
    a = np.asarray(node)
    return _tensor(a if index is None else a[index], device, dtype)


def params_from_reference(p, device="cuda", dtype=torch.bfloat16) -> DecoderParams:
    """The JAX package's DecoderParams (numpy leaves) -> this package's.

    Reads `.embed`, `.layer_groups`, `.group_sizes`, `.final_norm`,
    `.lm_head`, and for each Linear `.kind`, `.shape`, `.data`, `.meta`.
    Each stacked [L, ...] layer group is unstacked into per-layer dicts;
    packed bytes are kept as they are. An MoE layer's expert stacks come
    out as [E, ...] (dense [E, H, I] / [E, I, H], or packed tensors with
    their shared [in] permutation tables), since the group stacks every
    leaf of a layer, perms too, on one more leading axis."""
    layers = []
    for group, size in zip(p.layer_groups, p.group_sizes):
        if isinstance(group, (list, tuple)):
            raise NotImplementedError("super-grouped (superscan) params are not carried across")
        layers.extend(_convert(group, device, dtype, index=i) for i in range(size))
    return DecoderParams(
        embed=_tensor(p.embed, device, dtype),
        layers=layers,
        final_norm=_convert(p.final_norm, device, dtype),
        lm_head=None if p.lm_head is None else _linear(p.lm_head, device, dtype),
    )
