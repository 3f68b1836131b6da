"""Decoder configuration + the llama/mistral/mixtral/gemma2 HF config translators.

Counterpart of mistralrs_tpu/models/config.py, holding the fields the
ported serving path reads. Other architectures' translators are later work.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_position_embeddings: int = 4096
    norm_eps: float = 1e-5
    norm_offset: float = 0.0  # 1.0 for gemma-family zero-centered weights
    block_style: str = "prenorm"  # prenorm | sandwich (gemma2)
    act: str = "silu"
    rope_theta: float = 10000.0
    rope_scaling: dict[str, Any] | None = None
    # sliding-window attention: "none" | "all" (mistral-style, every layer)
    # | "alternate" (gemma2: even layers local)
    sliding_window: int | None = None
    sliding_window_pattern: str = "none"
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    query_scale: float | None = None  # overrides 1/sqrt(head_dim) (gemma2 query_pre_attn_scalar)
    tie_word_embeddings: bool = False
    embed_scale: float = 1.0  # gemma: sqrt(hidden_size)
    # MoE (mixtral)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    # MoE dispatch: grouped dropless GEMMs (K13, set by the pipeline) vs the
    # dense every-expert einsum
    moe_grouped: bool = False

    def __post_init__(self):
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.num_heads} heads over {self.num_kv_heads} kv heads")

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_uses_sliding_window(self, layer_idx: int) -> bool:
        if self.sliding_window is None or self.sliding_window_pattern == "none":
            return False
        if self.sliding_window_pattern == "all":
            return True
        return layer_idx % 2 == 0  # gemma2 alternate: even layers local


def _base(hf: dict[str, Any], arch: str, **over: Any) -> ModelConfig:
    num_heads = hf["num_attention_heads"]
    hidden = hf["hidden_size"]
    fields = dict(
        arch=arch,
        vocab_size=hf["vocab_size"],
        hidden_size=hidden,
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=num_heads,
        num_kv_heads=hf.get("num_key_value_heads", num_heads),
        head_dim=hf.get("head_dim") or hidden // num_heads,
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        norm_eps=hf.get("rms_norm_eps", hf.get("norm_epsilon", hf.get("layer_norm_eps", 1e-5))),
        rope_theta=hf.get("rope_theta", 10000.0),
        rope_scaling=hf.get("rope_scaling"),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        act=hf.get("hidden_act") or hf.get("hidden_activation") or "silu",
    )
    fields.update(over)
    return ModelConfig(**fields)


def _llama(hf):
    return _base(hf, "llama")


def _mistral(hf):
    return _base(
        hf, "mistral",
        sliding_window=hf.get("sliding_window"),
        sliding_window_pattern="all" if hf.get("sliding_window") else "none",
    )


def _mixtral(hf):
    return _base(
        hf, "mixtral",
        sliding_window=hf.get("sliding_window"),
        sliding_window_pattern="all" if hf.get("sliding_window") else "none",
        num_experts=hf["num_local_experts"],
        num_experts_per_tok=hf["num_experts_per_tok"],
    )


def _gemma2(hf):
    scalar = hf.get("query_pre_attn_scalar")
    return _base(
        hf, "gemma2",
        norm_offset=1.0,
        norm_eps=hf.get("rms_norm_eps", 1e-6),
        embed_scale=hf["hidden_size"] ** 0.5,
        tie_word_embeddings=True,
        block_style="sandwich",
        act=hf.get("hidden_activation") or "gelu_pytorch_tanh",
        sliding_window=hf.get("sliding_window", 4096),
        sliding_window_pattern="alternate",
        attn_logit_softcap=hf.get("attn_logit_softcapping", 50.0),
        final_logit_softcap=hf.get("final_logit_softcapping", 30.0),
        query_scale=(scalar**-0.5) if scalar else None,
    )


_TRANSLATORS = {
    "LlamaForCausalLM": _llama,
    "MistralForCausalLM": _mistral,
    "MixtralForCausalLM": _mixtral,
    "Gemma2ForCausalLM": _gemma2,
    "llama": _llama,
    "mistral": _mistral,
    "mixtral": _mixtral,
    "gemma2": _gemma2,
}


def config_from_hf(hf: dict[str, Any]) -> ModelConfig:
    """Translate an HF `config.json` dict. Tries `architectures`, then `model_type`."""
    for a in hf.get("architectures") or []:
        if a in _TRANSLATORS:
            return _TRANSLATORS[a](hf)
    mt = hf.get("model_type")
    if mt in _TRANSLATORS:
        return _TRANSLATORS[mt](hf)
    raise ValueError(f"unsupported architecture: {hf.get('architectures') or mt}")
