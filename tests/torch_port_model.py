"""Shared inputs for the tests of the PyTorch port (tests/test_torch_*.py).

A tiny model in the Q4_K_M, Q5_K_M or Q2_K type mix, built in the JAX package from seeded
numpy weights through its own quantizer (kquants.quantize) and packers, and
carried into the port with params_from_reference, so that both packages
compute on the same packed bytes; and a tiny seeded Llama, Gemma-2 and
Mixtral from transformers (hf_state_dict), loaded by the JAX package's HF
loader (dense, or ISQ Q4K).
Everything is float32 on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.gguf.reader import GGMLType
from mistralrs_tpu.models.config import ModelConfig as JModelConfig
from mistralrs_tpu.models.decoder import DecoderParams as JDecoderParams
from mistralrs_tpu.models.config import config_from_hf as jconfig_from_hf
from mistralrs_tpu.models.loader import TensorSource, group_layers, params_from_source
from mistralrs_tpu.quant import kquants
from mistralrs_tpu.quant.gguf_linear import linear_from_gguf
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.loader import params_from_reference

# int8 activation rounding allowance for whole-model logits, relative to a
# step's largest |logit| (measured at most 1.03% on this model; see
# tests/test_torch_slice.py), and the KV page size of the tests
SLICE_RTOL = 0.03
PAGE = 16

# hidden 512, 4 heads of 128 over 2 kv heads, intermediate 1024; a vocab of
# 1920 makes pad_linear_out pad the lm_head to 2048
TINY = dict(arch="mistral", vocab_size=1920, hidden_size=512, intermediate_size=1024,
            num_layers=3, num_heads=4, num_kv_heads=2, head_dim=128,
            max_position_embeddings=1024, rope_theta=1e6)


def use_more_bits(i: int, n: int) -> bool:
    """llama.cpp use_more_bits() (bench.py:173): ffn_down layers in Q6_K."""
    return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2


def quantized(rng, gtype, out_f: int, in_f: int, std: float):
    """(raw GGUF bytes, JAX Linear) of a seeded normal weight [out, in]."""
    w = (rng.standard_normal((out_f, in_f)) * std).astype(np.float32)
    raw = kquants.quantize(w, gtype)
    return raw, linear_from_gguf(raw, gtype, (out_f, in_f), dtype=jnp.float32)


def jax_q4km_params(seed: int = 0, **over):
    """(JAX ModelConfig, JAX DecoderParams) of a tiny Q4_K_M-mix model: q, k,
    o, gate, up in Q4_K; v, lm_head and the use_more_bits ffn_down in Q6_K."""
    return _jax_mix_params(GGMLType.Q4_K, seed, **over)


def jax_q5km_params(seed: int = 0, **over):
    """The same model in the Q5_K_M mix: Q5_K where Q4_K_M has Q4_K (llama.cpp
    takes both mixes through the same branches of llama_tensor_get_type)."""
    return _jax_mix_params(GGMLType.Q5_K, seed, **over)


def jax_q2k_params(seed: int = 0, **over):
    """The same model in llama.cpp's Q2_K mix as it stands for Mistral
    (LLAMA_FTYPE_MOSTLY_Q2_K with n_gqa = 4; the tiny model's n_gqa is 2,
    but the mix is taken as for the full model): q, k, gate, up in Q2_K; v
    in Q4_K; o and down in Q3_K; the lm_head in Q6_K."""
    return _jax_mix_params(GGMLType.Q2_K, seed, **over)


def _jax_mix_params(base, seed: int, **over):
    kw = dict(TINY, **over)
    cfg = JModelConfig(**kw)
    rng = np.random.default_rng(seed)
    H, I, D, L = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim, cfg.num_layers
    Q4, Q6 = base, GGMLType.Q6_K
    q2k = base == GGMLType.Q2_K
    V = GGMLType.Q4_K if q2k else Q6
    O = GGMLType.Q3_K if q2k else Q4

    def lin(gtype, out_f, in_f, std=0.05):
        return quantized(rng, gtype, out_f, in_f, std)[1]

    def down_type(i):
        if q2k:
            return GGMLType.Q3_K
        return Q6 if use_more_bits(i, L) else Q4

    layers = []
    for i in range(L):
        layers.append({
            "attn": {"q": lin(Q4, cfg.num_heads * D, H), "k": lin(Q4, cfg.num_kv_heads * D, H),
                     "v": lin(V, cfg.num_kv_heads * D, H), "o": lin(O, H, cfg.num_heads * D)},
            "mlp": {"gate": lin(Q4, I, H), "up": lin(Q4, I, H),
                    "down": lin(down_type(i), H, I, 0.03)},
            "input_norm": {"w": jnp.asarray(1.0 + 0.1 * rng.standard_normal(H), jnp.float32)},
            "post_attn_norm": {"w": jnp.asarray(1.0 + 0.1 * rng.standard_normal(H), jnp.float32)},
        })
    groups, sizes = group_layers(layers)
    embed = rng.standard_normal((cfg.vocab_size, H)).astype(np.float32)
    # "bigram" lm_head: row (7i + 3) mod V is 0.05 * embed[i], so the token
    # after i is decided with a wide top-2 margin while the layers still move
    # every logit's value; plus noise, quantized to Q6_K like a real output.weight
    nxt = (7 * np.arange(cfg.vocab_size) + 3) % cfg.vocab_size
    head = (rng.standard_normal((cfg.vocab_size, H)) * 0.01).astype(np.float32)
    head[nxt] += 0.05 * embed
    raw = kquants.quantize(head, Q6)
    params = JDecoderParams(
        embed=jnp.asarray(embed),
        layer_groups=groups,
        final_norm={"w": jnp.ones((H,), jnp.float32)},
        lm_head=linear_from_gguf(raw, Q6, (cfg.vocab_size, H), dtype=jnp.float32),
        group_sizes=sizes,
    )
    return cfg, params


@pytest.fixture
def one_thread():
    """One torch thread for a test of many tiny ops: on a loaded machine an
    oversubscribed thread pool slows such a test by up to 100x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_params(jparams):
    """The same weights as the port's DecoderParams (f32, CPU)."""
    return params_from_reference(jax.tree.map(np.asarray, jparams), device="cpu",
                                 dtype=torch.float32)


def port_config(jcfg) -> ModelConfig:
    """The port's ModelConfig with the JAX config's value in every field."""
    import dataclasses

    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)})


# hidden 256, 4 heads of 64 over 2 kv heads, intermediate 512, 4 layers (so
# two local and two global), window 48, caps 50 / 30, scale 64 ** -0.5
TINY_GEMMA2 = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=4,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                   sliding_window=48, attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                   query_pre_attn_scalar=64, max_position_embeddings=4096)


# hidden 256, 4 heads of 64 over 2 kv heads, intermediate 512, 2 layers,
# vocab 512, an lm_head of its own
TINY_LLAMA = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=1024,
                  tie_word_embeddings=False)

# arch -> (transformers config and model classes, tiny sizes, init std)
_HF_MODELS = {"llama": ("LlamaConfig", "LlamaForCausalLM", "TINY_LLAMA", 0.06),
              "gemma2": ("Gemma2Config", "Gemma2ForCausalLM", "TINY_GEMMA2", 0.1)}


def hf_state_dict(arch: str, seed: int = 0, **over) -> tuple[dict, dict[str, np.ndarray]]:
    """(config.json dict, f32 numpy state dict) of a tiny seeded
    transformers model: "llama" (TINY_LLAMA), "gemma2" (TINY_GEMMA2, norm
    weights drawn too, which HF starts at zero) or "mixtral"
    (TINY_MIXTRAL), with the sizes in `over` changed."""
    import json

    import transformers as tf

    cfg_cls, model_cls, tiny, std = _HF_MODELS[arch]
    torch.manual_seed(seed)
    hf_cfg = getattr(tf, cfg_cls)(**dict(globals()[tiny], **over), initializer_range=std)
    model = getattr(tf, model_cls)(hf_cfg).eval().float()
    if arch == "gemma2":
        with torch.no_grad():
            for name, w in model.named_parameters():
                if name.endswith("norm.weight"):
                    w.normal_(0.0, std)
    return (json.loads(hf_cfg.to_json_string()),
            {k: v.detach().numpy() for k, v in model.state_dict().items()})


def jax_gemma2_params(seed: int = 0, **over):
    """(JAX ModelConfig, JAX DecoderParams with every projection ISQ'd to
    Q4_K, the same params dense in f32) of a tiny seeded
    transformers.Gemma2ForCausalLM (hf_state_dict), loaded as the JAX
    package loads an HF checkpoint (config_from_hf, params_from_source).
    Weights are drawn with std 0.1 (norm weights too, which HF starts at
    zero), so that attention scores and logits reach the soft caps' bend."""
    hf, sd = hf_state_dict("gemma2", seed, **over)
    cfg = jconfig_from_hf(hf)
    src = TensorSource.from_dict(sd)
    return (cfg, params_from_source(cfg, src, dtype=jnp.float32, isq="Q4K"),
            params_from_source(cfg, src, dtype=jnp.float32))


# hidden 256, 4 heads of 64 over 2 kv heads, intermediate 512, 3 layers, 4
# experts with 2 a token (Mixtral-8x7B has 8), vocab 512
TINY_MIXTRAL = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=3,
                    num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
                    num_experts_per_tok=2, max_position_embeddings=1024, rope_theta=1e6)


_HF_MODELS["mixtral"] = ("MixtralConfig", "MixtralForCausalLM", "TINY_MIXTRAL", 0.06)


def jax_mixtral_params(seed: int = 0):
    """(JAX ModelConfig, JAX DecoderParams loaded dense, the same with ISQ
    Q4K) of a tiny seeded transformers.MixtralForCausalLM (hf_state_dict),
    loaded as the JAX package loads an HF checkpoint: under ISQ the router
    and the attention are Q4_K, the experts stay dense (f32 here) [E, H, I]
    / [E, I, H] a layer. Weights are drawn with std 0.06."""
    hf, sd = hf_state_dict("mixtral", seed)
    cfg = jconfig_from_hf(hf)
    src = TensorSource.from_dict(sd)
    return (cfg, params_from_source(cfg, src, dtype=jnp.float32),
            params_from_source(cfg, src, dtype=jnp.float32, isq="Q4K"))


def flat_params(p) -> dict:
    """Every leaf of DecoderParams by path: each Linear's kind, shape, meta
    and data tensors, every norm and the embedding."""
    out = {}

    def walk(node, pre):
        if hasattr(node, "kind"):
            out[pre + ":kind"], out[pre + ":shape"], out[pre + ":meta"] = (
                node.kind, tuple(node.shape), node.meta)
            for k, v in node.data.items():
                out[f"{pre}.{k}"] = v
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{pre}.{k}")
        elif node is not None:
            out[pre] = node

    walk({"embed": p.embed, "final_norm": p.final_norm, "lm_head": p.lm_head,
          **{str(i): lp for i, lp in enumerate(p.layers)}}, "")
    return out


def assert_params_equal(got, want):
    """Two port DecoderParams hold the same leaves, bit for bit."""
    g, w = flat_params(got), flat_params(want)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    for k in w:
        if isinstance(w[k], torch.Tensor):
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
        else:
            assert g[k] == w[k], (k, g[k], w[k])


# ---------------------------------------------------------------- GGUF files

# a tiny Mistral written as llama.cpp lays one out (general.architecture
# "llama"): hidden 512 (so Q6_K's chunk span is 128 and K4 takes it), 4
# heads of 128 over 2 kv heads, intermediate 1024, 2 layers, vocab 384
TINY_GGUF = dict(hidden=512, inter=1024, heads=4, kv_heads=2, head_dim=128, vocab=384, ctx=512)
# each layer's projection types: every packed type of the bf16-activation
# route (Q4_K, Q5_K, Q6_K, Q8_0), fused (q|k, gate|up) and not
GGUF_MIX = (
    {"attn_q": GGMLType.Q4_K, "attn_k": GGMLType.Q4_K, "attn_v": GGMLType.Q6_K,
     "attn_output": GGMLType.Q8_0, "ffn_gate": GGMLType.Q5_K, "ffn_up": GGMLType.Q5_K,
     "ffn_down": GGMLType.Q6_K},
    {"attn_q": GGMLType.Q5_K, "attn_k": GGMLType.Q5_K, "attn_v": GGMLType.Q8_0,
     "attn_output": GGMLType.Q4_K, "ffn_gate": GGMLType.Q4_K, "ffn_up": GGMLType.Q4_K,
     "ffn_down": GGMLType.Q8_0},
)


def write_tiny_gguf(path, seed: int = 0, mix=GGUF_MIX, experts: int = 0,
                    expert_layout: str = "stacked", fused_qkv: bool = False) -> None:
    """A tiny seeded GGUF model quantized by the JAX package's quantizers and
    written by its writer: F32 norms, a Q8_0 token embedding, a Q6_K output
    with a "bigram" structure (row (7i + 3) mod V carries 0.05 * embed[i], so
    greedy tokens have wide margins), and per layer the projection types of
    `mix`. With `experts`, a Mixtral (expert_count, 2 a token): an F32
    router and the ffn experts stacked as ffn_*_exps [E, out, in]
    ("stacked") or one ffn_*.{e} tensor each ("per_expert"). With
    `fused_qkv`, each layer's q, k and v are one attn_qkv tensor in
    attn_q's type."""
    from mistralrs_tpu.gguf.writer import write_gguf

    t = TINY_GGUF
    H, I, D, V = t["hidden"], t["inter"], t["head_dim"], t["vocab"]
    rng = np.random.default_rng(seed)

    def w(*shape, std=0.05):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def q(a, gtype):
        raw = (np.concatenate([kquants.quantize(x, gtype) for x in a]) if a.ndim == 3
               else kquants.quantize(a, gtype))
        return (gtype, a.shape, raw)

    embed = w(V, H, std=1.0)
    head = w(V, H, std=0.01)
    head[(7 * np.arange(V) + 3) % V] += 0.05 * embed
    tensors = {"token_embd.weight": q(embed, GGMLType.Q8_0),
               "output_norm.weight": (GGMLType.F32, (H,), 1.0 + 0.1 * w(H, std=1.0)),
               "output.weight": q(head, GGMLType.Q6_K)}
    for i, types in enumerate(mix):
        p = f"blk.{i}"
        tensors.update({
            f"{p}.attn_norm.weight": (GGMLType.F32, (H,), 1.0 + 0.1 * w(H, std=1.0)),
            f"{p}.attn_output.weight": q(w(H, t["heads"] * D), types["attn_output"]),
            f"{p}.ffn_norm.weight": (GGMLType.F32, (H,), 1.0 + 0.1 * w(H, std=1.0))})
        qkv = {"attn_q": w(t["heads"] * D, H), "attn_k": w(t["kv_heads"] * D, H),
               "attn_v": w(t["kv_heads"] * D, H)}
        if fused_qkv:
            tensors[f"{p}.attn_qkv.weight"] = q(np.concatenate(list(qkv.values())),
                                                types["attn_q"])
        else:
            tensors.update({f"{p}.{n}.weight": q(a, types[n]) for n, a in qkv.items()})
        shapes = {"ffn_gate": (I, H), "ffn_up": (I, H), "ffn_down": (H, I)}
        if not experts:
            tensors.update({f"{p}.{n}.weight": q(w(*s, std=0.03), types[n])
                            for n, s in shapes.items()})
            continue
        tensors[f"{p}.ffn_gate_inp.weight"] = (GGMLType.F32, (experts, H), w(experts, H, std=0.2))
        for n, s in shapes.items():
            stack = w(experts, *s, std=0.03)
            if expert_layout == "stacked":
                tensors[f"{p}.{n}_exps.weight"] = q(stack, types[n])
            else:
                tensors.update({f"{p}.{n}.{e}.weight": q(stack[e], types[n])
                                for e in range(experts)})
    md = {"general.architecture": "llama", "llama.block_count": len(mix),
          "llama.embedding_length": H, "llama.feed_forward_length": I,
          "llama.attention.head_count": t["heads"], "llama.attention.head_count_kv": t["kv_heads"],
          "llama.attention.layer_norm_rms_epsilon": 1e-5, "llama.rope.freq_base": 1e6,
          "llama.context_length": t["ctx"], "llama.vocab_size": V}
    if experts:
        md.update({"llama.expert_count": experts, "llama.expert_used_count": 2})
    write_gguf(str(path), md, tensors)
