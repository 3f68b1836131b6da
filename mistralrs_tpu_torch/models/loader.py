"""Model construction: HF safetensors checkpoints (with in-situ
quantization), the rope table, and weights carried across from the JAX
package.

Counterpart of mistralrs_tpu/models/loader.py:
- `TensorSource` looks tensors up by name over the safetensors shards of a
  directory (or a dict). The files are read here, with no safetensors
  package: an 8-byte little-endian header length, a JSON header (name ->
  dtype, shape, byte offsets), and `np.memmap` over the data. BF16 comes
  back as its uint16 bits (dtype `BF16`): widened to f32 exactly where ISQ
  needs f32, viewed as torch.bfloat16 where the tensor stays dense.
- `params_from_source` builds the port's DecoderParams (a plain list of
  layers; the JAX package's scan groups are for XLA) for the architectures
  `config_from_hf` takes (llama, mistral, mixtral, gemma2), quantizing each
  projection on the host with quant/kquants.py (or quant/hqq.py) where an
  ISQ type is asked, or reading AutoGPTQ tensors. Layers are loaded by a
  pool of LOAD_THREADS threads, as pipeline/gguf.py packs GGUF layers.
- `load_hf_model` reads config.json, the shards, and an AutoGPTQ
  `quantization_config`.
- `params_from_reference` carries a JAX-package `DecoderParams` (after
  ``jax.tree.map(np.asarray, ...)``, so its leaves are numpy arrays) into
  this package's parameters, reading it by duck typing so that nothing here
  imports jax.
"""

from __future__ import annotations

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from mistralrs_tpu_torch.models.config import ModelConfig, config_from_hf
from mistralrs_tpu_torch.models.decoder import DecoderParams
from mistralrs_tpu_torch.ops.rope import RopeTable, compute_rope_table
from mistralrs_tpu_torch.quant import kquants
from mistralrs_tpu_torch.quant.gguf_linear import _PACK_IN_MULTIPLE, PACKERS, linear_from_gguf
from mistralrs_tpu_torch.quant.gptq import gptq_linear_from_tensors
from mistralrs_tpu_torch.quant.hqq import HqqType, quantize_hqq
from mistralrs_tpu_torch.quant.isq import Topology, parse_isq, quantizable
from mistralrs_tpu_torch.quant.qlinear import Linear, make_dense

# threads that load (and quantize) a checkpoint's layers, here and in
# pipeline/gguf.py
LOAD_THREADS = min(8, os.cpu_count() or 1)

# a BF16 tensor as its uint16 bits (numpy has no bfloat16)
BF16 = np.dtype([("bf16", "<u2")])
# safetensors dtype names -> numpy dtypes
SAFETENSORS_DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "BF16": BF16,
    "I64": np.dtype("<i8"), "I32": np.dtype("<i4"), "I16": np.dtype("<i2"), "I8": np.dtype("i1"),
    "U8": np.dtype("u1"), "BOOL": np.dtype("?"),
}


def make_rope(cfg: ModelConfig, max_pos: int | None = None, device="cuda") -> RopeTable:
    return compute_rope_table(
        cfg.head_dim,
        max_pos or cfg.max_position_embeddings,
        theta=cfg.rope_theta,
        rope_scaling=cfg.rope_scaling,
        device=device,
    )


# ------------------------------------------------------------ safetensors


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """name -> array (a view of one read-only memory map of the file's
    data; BF16 as `BF16`). A header that overruns the file, an unknown
    dtype and a tensor outside the data or of the wrong byte count raise."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes holds no safetensors header length")
        n = int.from_bytes(head, "little")
        if 8 + n > size:
            raise ValueError(f"{path}: a header of {n} bytes overruns the file of {size}")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    nbytes = size - 8 - n
    data = (np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n, shape=(nbytes,))
            if nbytes else np.empty(0, np.uint8))
    out = {}
    for name, info in header.items():
        dt = SAFETENSORS_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not read here "
                             f"(read: {sorted(SAFETENSORS_DTYPES)})")
        shape = tuple(int(s) for s in info["shape"])
        b, e = (int(x) for x in info["data_offsets"])
        if not 0 <= b <= e <= nbytes or e - b != math.prod(shape) * dt.itemsize:
            raise ValueError(f"{path}: {name} {info['dtype']} {list(shape)} at bytes [{b}, {e}) "
                             f"does not fit the {nbytes} bytes of data")
        out[name] = data[b:e].view(dt).reshape(shape)
    return out


def _is_bf16(a: np.ndarray) -> bool:
    # this module's BF16, or an ml_dtypes bfloat16 array given to from_dict
    return a.dtype == BF16 or a.dtype.name == "bfloat16"


def _as_f32(a: np.ndarray) -> np.ndarray:
    """A float array in f32 (BF16 bits widened exactly)."""
    if _is_bf16(a):
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(a, np.float32)


def _dense_tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A source array as a float tensor in `dtype` on `device`: BF16 viewed as
    torch.bfloat16 (so it is rounded once, if at all); always a copy, never
    the file's memory map."""
    if _is_bf16(a):
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def _in_out(w: np.ndarray) -> np.ndarray:
    """A torch-layout (out, in) weight as a contiguous (in, out) array of
    the same dtype."""
    if _is_bf16(w):
        return np.ascontiguousarray(w.view(np.uint16).T).view(BF16)
    return np.ascontiguousarray(w.T)


class TensorSource:
    """Tensor lookup by name over one or more safetensors shards (or a dict)."""

    def __init__(self, get: Callable[[str], np.ndarray], names: set[str]):
        self.get = get
        self.names = names

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def __call__(self, name: str) -> np.ndarray:
        return self.get(name)

    @classmethod
    def from_dict(cls, tensors: dict[str, np.ndarray]) -> "TensorSource":
        return cls(lambda n: tensors[n], set(tensors))

    @classmethod
    def from_safetensors_dir(cls, path: str) -> "TensorSource":
        """Every *.safetensors file of `path`, merged; a name found in two
        shards raises, as does a directory without a shard."""
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no *.safetensors file in {path}")
        tensors: dict[str, np.ndarray] = {}
        where: dict[str, str] = {}
        for f in files:
            for name, a in read_safetensors(f).items():
                if name in tensors:
                    raise ValueError(f"tensor {name} is in both {where[name]} and {f}")
                tensors[name] = a
                where[name] = f
        return cls.from_dict(tensors)


# ------------------------------------------------------------ HF -> params


def _maybe_quantize(w_out_in: np.ndarray, b: np.ndarray | None, gtype, dtype,
                    device="cuda") -> Linear | None:
    """ISQ a torch-layout (out, in) weight into a packed Linear; None where
    the JAX package keeps it dense: no ISQ type, `in` not a whole number of
    blocks, or no packer for the type at this `in` (the JAX packers fall
    back to a dense weight there, which its loader discards). `b` goes to
    data["b"]."""
    if gtype is None or not quantizable(w_out_in.shape, gtype):
        return None
    b = None if b is None else _as_f32(b)
    if isinstance(gtype, HqqType):
        return quantize_hqq(_as_f32(w_out_in), gtype.bits, gtype.group_size, dtype=dtype, bias=b,
                            device=device)
    if gtype not in PACKERS or w_out_in.shape[1] % _PACK_IN_MULTIPLE[gtype]:
        return None
    raw = kquants.quantize(_as_f32(w_out_in), gtype)
    lin = linear_from_gguf(raw, gtype, w_out_in.shape, dtype, device)
    if b is not None:
        lin.data["b"] = _dense_tensor(b, dtype, device)
    return lin


def _lin(src: TensorSource, prefix: str, dtype, device, isq=None,
         gptq: dict | None = None) -> Linear:
    b = src(prefix + ".bias") if (prefix + ".bias") in src else None
    if gptq is not None and (prefix + ".qweight") in src:
        # an AutoGPTQ checkpoint's projection
        bits = int(gptq["bits"])
        qw = src(prefix + ".qweight")
        in_f = (qw.shape[0] // 3) * 32 if bits == 3 else qw.shape[0] * (32 // bits)
        return gptq_linear_from_tensors(
            np.asarray(qw), np.asarray(src(prefix + ".qzeros")), _as_f32(src(prefix + ".scales")),
            np.asarray(src(prefix + ".g_idx")) if (prefix + ".g_idx") in src else None,
            bits, in_f, qw.shape[1], dtype=dtype, zero_plus_one=gptq.get("zero_plus_one", True),
            bias=None if b is None else _as_f32(b), device=device)
    w = src(prefix + ".weight")
    q = _maybe_quantize(w, b, isq, dtype, device)
    if q is not None:
        return q
    return make_dense(_dense_tensor(_in_out(w), dtype, device),
                      None if b is None else _dense_tensor(b, dtype, device))


def _norm_p(src: TensorSource, prefix: str, dtype, device) -> dict[str, torch.Tensor]:
    p = {"w": _dense_tensor(src(prefix + ".weight"), dtype, device)}
    if (prefix + ".bias") in src:
        p["b"] = _dense_tensor(src(prefix + ".bias"), dtype, device)
    return p


def _layer_params(cfg: ModelConfig, src: TensorSource, i: int, dtype, device, isq=None,
                  gptq: dict | None = None) -> dict[str, Any]:
    """Layer i: q/k/v/o, the gated MLP (or Mixtral's router and its dense
    experts stacked [E, H, I] / [E, I, H], which ISQ leaves dense, as in the
    JAX package), the prenorm or sandwich norms."""
    pre = f"model.layers.{i}"
    a = f"{pre}.self_attn"

    def lin(prefix, q=isq, g=gptq):
        return _lin(src, prefix, dtype, device, isq=q, gptq=g)

    p: dict[str, Any] = {"attn": {k: lin(f"{a}.{k}_proj") for k in ("q", "k", "v", "o")}}
    if cfg.is_moe:
        moe = f"{pre}.block_sparse_moe"

        def stack(w):  # the experts' weights -> [E, in, out]
            return make_dense(_dense_tensor(
                np.stack([_in_out(src(f"{moe}.experts.{e}.{w}.weight"))
                          for e in range(cfg.num_experts)]), dtype, device))

        p["mlp"] = {"router": lin(f"{moe}.gate", g=None),
                    "experts": {"gate": stack("w1"), "up": stack("w3"), "down": stack("w2")}}
    else:
        m = f"{pre}.mlp"
        p["mlp"] = {k: lin(f"{m}.{k}_proj") for k in ("gate", "up", "down")}
    p["input_norm"] = _norm_p(src, f"{pre}.input_layernorm", dtype, device)
    p["post_attn_norm"] = _norm_p(src, f"{pre}.post_attention_layernorm", dtype, device)
    if cfg.block_style == "sandwich":
        p["pre_mlp_norm"] = _norm_p(src, f"{pre}.pre_feedforward_layernorm", dtype, device)
        p["post_mlp_norm"] = _norm_p(src, f"{pre}.post_feedforward_layernorm", dtype, device)
    return p


def params_from_source(cfg: ModelConfig, src: TensorSource, dtype=torch.bfloat16, isq=None,
                       topology=None, gptq_cfg: dict | None = None,
                       device="cuda") -> DecoderParams:
    """isq: GGMLType, HqqType or ISQ name ("Q4K", "HQQ4", ...) for every
    projection; topology: quant.isq.Topology overriding it per layer (the
    lm_head takes `isq`); gptq_cfg: AutoGPTQ checkpoint info ({bits,
    zero_plus_one}) for qweight/qzeros/scales projections. The layers are
    loaded by a pool of LOAD_THREADS threads, a layer a task (the
    quantizers' numpy operations and torch's copies release the GIL), the
    embedding, the final norm and the lm_head beside them."""
    if isinstance(isq, str):
        isq = parse_isq(isq)

    def layer(i):
        q = topology.isq_for_layer(i, isq) if topology is not None else isq
        return _layer_params(cfg, src, i, dtype, device, isq=q, gptq=gptq_cfg)

    with ThreadPoolExecutor(max_workers=LOAD_THREADS) as pool:
        embed = pool.submit(_dense_tensor, src("model.embed_tokens.weight"), dtype, device)
        final_norm = pool.submit(_norm_p, src, "model.norm", dtype, device)
        lm_head = None
        if not cfg.tie_word_embeddings and "lm_head.weight" in src:
            lm_head = pool.submit(_lin, src, "lm_head", dtype, device, isq)
        layers = list(pool.map(layer, range(cfg.num_layers)))
        return DecoderParams(embed=embed.result(), layers=layers, final_norm=final_norm.result(),
                             lm_head=None if lm_head is None else lm_head.result())


def load_hf_model(path: str, dtype=torch.bfloat16, max_position_embeddings: int | None = None,
                  isq=None, topology=None,
                  device="cuda") -> tuple[ModelConfig, DecoderParams, RopeTable]:
    """config.json + *.safetensors of a local HF model directory -> (config,
    params, rope table), optionally ISQ-quantizing the projections (`isq` a
    name or type; `topology` a Topology or the path of its YAML file)."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    cfg = config_from_hf(hf)
    src = TensorSource.from_safetensors_dir(path)
    if isinstance(topology, str):
        topology = Topology.from_yaml_file(topology, cfg.num_layers)
    gptq_cfg = None
    qc = hf.get("quantization_config")
    if qc and qc.get("quant_method") == "gptq":
        gptq_cfg = {"bits": int(qc.get("bits", 4)),
                    "zero_plus_one": qc.get("checkpoint_format", "gptq") != "gptq_v2"}
    params = params_from_source(cfg, src, dtype, isq=isq, topology=topology, gptq_cfg=gptq_cfg,
                                device=device)
    return cfg, params, make_rope(cfg, max_position_embeddings, device=device)


# ------------------------------------------------------------ from the JAX package


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
