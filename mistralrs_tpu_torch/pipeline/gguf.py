"""GGUF model pipeline: a quantized checkpoint file -> a servable model.

Counterpart of mistralrs_tpu/pipeline/gguf.py for the "llama" architecture
(Llama and Mistral, and Mixtral through `expert_count`): metadata keys ->
ModelConfig; weight tensors stay packed in the device layouts of
quant/gguf_linear (packed on the host from the file's mmap, a few layers
at a time in a pool of threads, and moved to the device tensor by
tensor); norms and the token embedding are dequantized (the embedding must
be gatherable). Mixtral experts are split from the stacked
`ffn_*_exps` bytes directly, or gathered from per-expert `ffn_gate.{e}`
tensors. Multi-file GGUF is supported, as in the JAX package.

Not ported yet: phi2, phi3 and starcoder2 (the port's decoder lacks their
layernorm, parallel-block, partial-rotary and plain-MLP pieces), and the
GGUF tokenizer and chat template (gguf/tokenizer.py, with the front end).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any

import torch

from mistralrs_tpu_torch.gguf.reader import GGUFFile
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.decoder import DecoderParams
from mistralrs_tpu_torch.models.loader import LOAD_THREADS, make_rope
from mistralrs_tpu_torch.ops.rope import RopeTable
from mistralrs_tpu_torch.quant import kquants
from mistralrs_tpu_torch.quant.fuse import split_linear
from mistralrs_tpu_torch.quant.gguf_linear import _PACK_IN_MULTIPLE, PACKERS, linear_from_gguf
from mistralrs_tpu_torch.quant.qlinear import Linear, make_dense

SUPPORTED_ARCHS = ("llama",)
# architectures the JAX package loads whose decoder pieces the port lacks
NOT_PORTED_ARCHS = ("phi2", "phi3", "starcoder2")


def config_from_gguf(g: GGUFFile) -> ModelConfig:
    a = g.architecture
    md = g.metadata
    if a in NOT_PORTED_ARCHS:
        raise ValueError(f"GGUF architecture {a!r} is not ported: the port's decoder lacks its "
                         "layernorm / parallel-block / partial-rotary / plain-MLP pieces")
    if a not in SUPPORTED_ARCHS:
        raise ValueError(f"unsupported GGUF architecture {a!r} (supported: {SUPPORTED_ARCHS})")

    def key(name, default=None):
        return md.get(f"{a}.{name}", default)

    heads = int(key("attention.head_count"))
    hidden = int(key("embedding_length"))
    n_experts = int(key("expert_count", 0) or 0)
    vocab = md.get(f"{a}.vocab_size")
    if vocab is None:
        vocab = len(md["tokenizer.ggml.tokens"])
    rope_dim = key("rope.dimension_count")
    return ModelConfig(
        arch="mixtral" if n_experts else "llama",
        vocab_size=int(vocab),
        hidden_size=hidden,
        intermediate_size=int(key("feed_forward_length")),
        num_layers=int(key("block_count")),
        num_heads=heads,
        num_kv_heads=int(key("attention.head_count_kv", heads)),
        head_dim=int(rope_dim) if rope_dim else hidden // heads,
        max_position_embeddings=int(key("context_length", 4096)),
        norm_eps=float(key("attention.layer_norm_rms_epsilon", 1e-5)),
        rope_theta=float(key("rope.freq_base", 10000.0)),
        num_experts=n_experts,
        num_experts_per_tok=int(key("expert_used_count", 0) or 0),
    )


def _weight(raw, gtype, shape, dtype, device) -> Linear:
    """A packed Linear where a packer takes the type at this `in`; else the
    weight dequantized to a dense [in, out] one (as the JAX loader does for
    an F32 router or a ragged `in`)."""
    out_f, in_f = shape
    if gtype in PACKERS and in_f % _PACK_IN_MULTIPLE[gtype] == 0:
        return linear_from_gguf(raw, gtype, shape, dtype, device)
    w = kquants.dequantize(raw, gtype, shape)
    return make_dense(torch.from_numpy(w.T.copy()).to(device=device, dtype=dtype))


def _f32_tensor(g: GGUFFile, name: str, dtype, device) -> torch.Tensor:
    return torch.from_numpy(g.tensor_f32(name)).to(device=device, dtype=dtype)


def _qlin(g: GGUFFile, name: str, dtype, device, bias: bool = True) -> Linear:
    ti, raw = g.raw_tensor(name)
    lin = _weight(raw, ti.ggml_type, ti.shape, dtype, device)
    bname = name.replace(".weight", ".bias")
    if bias and bname in g:
        lin.data["b"] = _f32_tensor(g, bname, dtype, device)
    return lin


def _norm(g: GGUFFile, name: str, dtype, device) -> dict[str, Any]:
    p = {"w": _f32_tensor(g, name, dtype, device)}
    bias = name.replace(".weight", ".bias")
    if bias in g:
        p["b"] = _f32_tensor(g, bias, dtype, device)
    return p


def _split_qkv(g: GGUFFile, name: str, cfg: ModelConfig, dtype, device) -> dict[str, Linear]:
    """A fused attn_qkv -> separate q/k/v (a column split; exact)."""
    fused = _qlin(g, name, dtype, device)
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    q, k, v = split_linear(fused, [qd, kvd, kvd])
    return {"q": q, "k": k, "v": v}


def _stack_linears(lins: list[Linear]) -> Linear:
    """Same-kind Linears stacked on a new leading expert axis (the Q6_K
    permutation tables are K-side constants shared by the experts, kept
    unstacked)."""
    kinds = {lin.kind for lin in lins}
    if len(kinds) != 1:
        raise ValueError(f"experts with mixed quant kinds {kinds} unsupported")
    base = lins[0]
    data = {k: (v if k in ("perm", "inv_perm") else torch.stack([lin.data[k] for lin in lins]))
            for k, v in base.data.items()}
    return Linear(kind=base.kind, shape=base.shape, data=data, meta=base.meta)


def _moe_mlp_params(g: GGUFFile, pre: str, cfg: ModelConfig, dtype, device) -> dict[str, Any]:
    """Mixtral experts: stacked `ffn_*_exps` 3D tensors split by expert from
    the raw bytes, or per-expert `ffn_gate.{e}` tensors."""
    router = _qlin(g, f"{pre}.ffn_gate_inp.weight", dtype, device, bias=False)
    experts: dict[str, Linear] = {}
    for key, gname in (("gate", "ffn_gate"), ("up", "ffn_up"), ("down", "ffn_down")):
        exps_name = f"{pre}.{gname}_exps.weight"
        if exps_name in g:
            ti, raw = g.raw_tensor(exps_name)
            E, out_f, in_f = ti.shape
            per = raw.reshape(E, -1)
            lins = [_weight(per[e], ti.ggml_type, (out_f, in_f), dtype, device)
                    for e in range(E)]
        else:
            lins = [_qlin(g, f"{pre}.{gname}.{e}.weight", dtype, device, bias=False)
                    for e in range(cfg.num_experts)]
        experts[key] = _stack_linears(lins)
    return {"router": router, "experts": experts}


def _layer_params(g: GGUFFile, cfg: ModelConfig, i: int, dtype, device) -> dict[str, Any]:
    pre = f"blk.{i}"
    lp: dict[str, Any] = {"input_norm": _norm(g, f"{pre}.attn_norm.weight", dtype, device)}
    if f"{pre}.attn_qkv.weight" in g:
        attn = _split_qkv(g, f"{pre}.attn_qkv.weight", cfg, dtype, device)
    else:
        attn = {k: _qlin(g, f"{pre}.attn_{k}.weight", dtype, device) for k in ("q", "k", "v")}
    attn["o"] = _qlin(g, f"{pre}.attn_output.weight", dtype, device)
    lp["attn"] = attn
    if cfg.is_moe:
        lp["mlp"] = _moe_mlp_params(g, pre, cfg, dtype, device)
    else:
        lp["mlp"] = {k: _qlin(g, f"{pre}.ffn_{k}.weight", dtype, device)
                     for k in ("gate", "up", "down")}
    lp["post_attn_norm"] = _norm(g, f"{pre}.ffn_norm.weight", dtype, device)
    return lp


def params_from_gguf(g: GGUFFile, cfg: ModelConfig, dtype=torch.bfloat16,
                     device="cuda") -> DecoderParams:
    """The model's parameters, one dict per layer (the JAX package's layer
    groups are for XLA's scan; the port keeps a plain list). The packing is
    numpy work on the host: a pool of LOAD_THREADS threads packs one layer
    (or the embedding, or the lm_head) a task, straight from the mmap to
    the device (numpy's array operations and torch's copies release the
    GIL), so host memory holds a few layers' temporaries at a time."""
    with ThreadPoolExecutor(max_workers=LOAD_THREADS) as pool:
        embed = pool.submit(_f32_tensor, g, "token_embd.weight", dtype, device)
        final_norm = pool.submit(_norm, g, "output_norm.weight", dtype, device)
        lm_head = (pool.submit(_qlin, g, "output.weight", dtype, device)
                   if "output.weight" in g else None)
        layers = list(pool.map(lambda i: _layer_params(g, cfg, i, dtype, device),
                               range(cfg.num_layers)))
        return DecoderParams(embed=embed.result(), layers=layers, final_norm=final_norm.result(),
                             lm_head=None if lm_head is None else lm_head.result())


def load_gguf_model(paths: str | list[str], dtype=torch.bfloat16,
                    device="cuda") -> tuple[ModelConfig, DecoderParams, RopeTable, Any]:
    """(config, params, rope table, tokenizer) of one GGUF model (one file or
    its shards), the 4-tuple of the JAX package's load_gguf_model. The
    tokenizer slot is None: the GGUF tokenizer is ported with the front end,
    and the serving path here takes token ids."""
    g = GGUFFile(paths)
    cfg = config_from_gguf(g)
    params = params_from_gguf(g, cfg, dtype, device)
    return cfg, params, make_rope(cfg, device=device), None
