"""Text-model pipeline: prefill and decode steps over the paged KV cache.

Counterpart of mistralrs_tpu/pipeline/text.py. Each step builds its host
arrays as the JAX pipeline does (decode padded to `max_seqs` rows, prefill
chunks padded to a bucket, page 0 as the garbage page for padding slots,
page-bucketed block-table widths), moves them to the device and runs
`decoder_forward` eagerly; the KV pools are updated in place, head-major
at `max_model_len >= 4096` unless `kv_head_major` says otherwise, or one
combined K/V pool on the ragged backend (`attn_backend="ragged"`), int8
with per-(slot, head) scales under `kv_quant` (which the ragged backend
does not take: it then serves the int8 pools on the default routes, as
the JAX package does). A batched
prefill has one row per sequence: eager PyTorch has no compiled shape to
keep, so it does not pad the batch to `max_seqs` as the JAX package does.

The multistep decode loop (`run_decode_multi`, JAX `_build_multistep_fn`)
runs `decode_steps` forwards over static device buffers, greedy or with
the device sampler (`sample_step`: temperature, top-k inside TOPK_PACK,
top-p, min-p, a Gumbel draw); on the card each call is one replay of a
CUDA graph captured per (block-table width, greedy or sampled) key
(pipeline/graphs.py), where JAX jits the loop into one dispatch. One-step
decode can return the device top-K pack (`run_decode(mode="topk")`).

An MoE model (mixtral) gets `moe_grouped` set, so dense experts take the
grouped dropless dispatch (models/decoder.py).

`re_isq` requantizes every Linear at run time (JAX :563-643) and drops the
decode graphs, which captured the old weights' addresses.

The verify path of speculative decoding (pipeline/speculative.py): `run_span`
(JAX :509-560) feeds each row a span of tokens at its own start position,
padded to `max_seqs` rows and a common width, and returns the logits at
every fed position (`_verify`, the target's verify) or at each row's last
one (the draft's steps). `supports_spec_device_loop` lets the speculative
pipelines run their device loops over this pipeline's forward.

Not in this port yet: meshes, and graphs of the one-step decode, the
prefill steps and `run_span` (they run eagerly).
"""

from __future__ import annotations

import dataclasses
import logging
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from mistralrs_tpu_torch.engine.sequence import Sequence
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.decoder import DecoderParams, compute_logits, decoder_forward
from mistralrs_tpu_torch.models.loader import LOAD_THREADS, _maybe_quantize
from mistralrs_tpu_torch.ops import quant_matmul as qm
from mistralrs_tpu_torch.ops.paged_attention import PagedAttnMeta, PagedKVCache, copy_pages
from mistralrs_tpu_torch.ops.rope import RopeTable
from mistralrs_tpu_torch.pipeline.graphs import DecodeGraphs
from mistralrs_tpu_torch.quant.fuse import fuse_decoder_params, pad_linear_out, requant_q6k_params
from mistralrs_tpu_torch.quant.isq import parse_isq
from mistralrs_tpu_torch.quant.qlinear import Linear, make_dense

# candidates of the device top-K sampling pack and of the sampled decode loop
TOPK_PACK = 64

# multistep calls that ran as an eager loop, not a graph replay:
# run_decode_multi_eager's, and run_decode_multi's on the CPU
decode_eager_loops = 0


def _top_k(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The TOPK_PACK largest of y [B, V] along V, descending, a tie with the
    lower index first as jax.lax.top_k puts it: a stable descending sort,
    since torch.topk promises no order among equals."""
    vals, ids = torch.sort(y, dim=-1, descending=True, stable=True)
    return vals[:, :TOPK_PACK], ids[:, :TOPK_PACK]


def greedy_pack(logits: torch.Tensor) -> torch.Tensor:
    """[2, ...] f32 of logits [..., V]: the argmax id (the first of equal
    maxima, as jnp.argmax takes it) and its logit."""
    top = torch.argmax(logits, dim=-1)
    chosen = torch.gather(logits, -1, top[..., None])[..., 0]
    return torch.stack([top.to(torch.float32), chosen])


def topk_pack(logits: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
    """The step's top-K sampling pack [B, 2K+2] f32 (JAX step fn :309-317):
    the K largest tempered logits y = logits / temps, their ids (exact in
    f32 below 2^24), y's max m and z = sum(exp(y - m)) over the vocab."""
    y = logits / temps[:, None]
    m = torch.amax(y, dim=-1)
    z = torch.sum(torch.exp(y - m[:, None]), dim=-1)
    tv, ti = _top_k(y)
    return torch.cat([tv, ti.to(torch.float32), m[:, None], z[:, None]], dim=1)


def sample_keep(logits: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor,
                top_ps: torch.Tensor, min_ps: torch.Tensor):
    """The sampled branch's truncation (JAX :371-390): (ti [B, K] the
    candidates' ids, kept [B, K] their probabilities under the full-vocab
    softmax of logits / temps, zero where cut, keep [B, K]). Top-k keeps
    the first top_ks; top-p (on for 0 < p < 1) keeps a candidate while the
    kept mass before it is below p; min-p (on inside top-p) keeps what
    exceeds min_p times the first candidate's probability."""
    y = logits / temps[:, None]
    tv, ti = _top_k(y)
    m = torch.amax(y, dim=-1, keepdim=True)
    z = torch.sum(torch.exp(y - m), dim=-1, keepdim=True)
    probs = torch.exp(tv - m) / z
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    keep = torch.arange(TOPK_PACK, device=y.device)[None] < top_ks[:, None]
    kept = torch.where(keep, probs, zero)
    cums = torch.cumsum(kept, dim=-1)
    p = top_ps[:, None]
    topp_on = (p > 0.0) & (p < 1.0)
    keep = keep & (~topp_on | ((cums - kept) < p))
    kept = torch.where(keep, probs, zero)
    mp = min_ps[:, None]
    minp_on = topp_on & (mp > 0.0) & (mp < 1.0)
    keep = keep & (~minp_on | (kept > kept[:, :1] * mp))
    return ti, torch.where(keep, probs, zero), keep


def sample_step(logits: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor,
                top_ps: torch.Tensor, min_ps: torch.Tensor, uniforms: torch.Tensor):
    """One sampled token a row (JAX :371-400): a Gumbel draw over
    sample_keep's kept probabilities with uniforms [B, K] in (0, 1), which
    picks candidate j with probability kept_j / sum(kept). Returns (token
    int64 [B], its raw logit, lp10 = log10 of its kept probability, 0 when
    nothing is kept). A greedy row is (temps 1, top_ks 1): its argmax."""
    ti, kept, keep = sample_keep(logits, temps, top_ks, top_ps, min_ps)
    g = -torch.log(-torch.log(uniforms + 1e-20) + 1e-20)
    zz = torch.where(keep, torch.log(torch.clamp(kept, min=1e-45)) + g, float("-inf"))
    idx = torch.argmax(zz, dim=-1, keepdim=True)
    tok = torch.gather(ti, 1, idx)
    chosen = torch.gather(kept, 1, idx)[:, 0]
    lp10 = torch.where(kept.sum(dim=-1) > 0.0, torch.log10(torch.clamp(chosen, min=1e-45)),
                       torch.zeros((), dtype=chosen.dtype, device=chosen.device))
    return tok[:, 0], torch.gather(logits, 1, tok)[:, 0], lp10


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (lowbias32) of int64 x in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def decode_uniforms(seed: torch.Tensor, step: int, B: int) -> torch.Tensor:
    """Uniforms [B, TOPK_PACK] f32 in (0, 1) for decode step `step` of a call
    with seed `seed` (an int64 tensor, any shape holding one value): a
    counter hash in integer tensor ops, so the same seed gives the same
    bits on every device, and a graph that reads the seed from a buffer
    draws anew at each replay. (The JAX package splits a PRNG key per step;
    the streams differ, as its docstring allows.)"""
    s = _mix32(seed.reshape(()) & _M32)
    c = torch.arange(B * TOPK_PACK, dtype=torch.int64, device=seed.device) + step * B * TOPK_PACK
    h = _mix32(_mix32(c ^ s) ^ _mix32(s ^ 0x9E3779B9))
    # 23 random bits as an odd multiple of 2^-24: exact in f32, never 0 or 1
    return ((((h >> 9) << 1) | 1).to(torch.float32) * 2.0 ** -24).reshape(B, TOPK_PACK)


def set_activation_route(params: DecoderParams, int8_act: bool) -> DecoderParams:
    """The params with `int8_act` set on every packed Linear (layers, MoE
    expert stacks and the lm_head), as new Linears: the caller's stay as
    they were."""

    def conv(node):
        if isinstance(node, Linear):
            return node if node.kind == "dense" else dataclasses.replace(node, int8_act=int8_act)
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return node

    return dataclasses.replace(params, layers=[conv(lp) for lp in params.layers],
                               lm_head=conv(params.lm_head))


def weight_f32(lin: Linear) -> torch.Tensor:
    """A Linear's weight [in, out] in f32, from the plain dequantizers of
    ops/quant_matmul.py on any device (the ops of the JAX package's
    DEQUANT_WEIGHTS in f32, which its re_isq reaches through an identity
    forward, without the [in, in] identity), in x's element order (an
    act-order `in_perm` undone)."""
    f32, d, kind = torch.float32, lin.data, lin.kind
    if kind == "dense":
        w = d["w"].to(f32)
    elif kind == "gguf_q4k":
        w = qm.q4k_dequant_plain(d["qs"], d["scale"], d["minv"], f32)
    elif kind == "gguf_q5k":
        w = qm.q5k_dequant_plain(d["qs"], d["qh"], d["scale"], d["minv"], f32)
    elif kind == "gguf_q6k":
        w = qm.q6k_dequant_plain(d["ql"], d["qh"], d["scale"], lin.meta, f32)
    elif kind == "gguf_q8_0":
        w = qm.q8_0_dequant_plain(d["q"], d["scale"], lin.meta or 32, f32)
    elif kind == "gguf_q2k":
        w = qm.affine_dequant_plain(d["q"], d["scale"], d["minv"], 2, 16, f32)
    elif kind.startswith(("gptq_", "hqq_")):
        # device code widths: the byte-per-value kinds (gptq_b8, hqq_3) hold 8
        bits = int(kind.split("_")[1]) if kind not in ("gptq_b8", "hqq_3") else 8
        if "g_idx" in d:
            w = (qm._affine_values(d["q"], bits).to(f32) * d["scale"].to(f32)[d["g_idx"]]
                 - d["zs"].to(f32)[d["g_idx"]])
        else:
            w = qm.affine_dequant_plain(d["q"], d["scale"], d["zs"], bits,
                                        lin.shape[0] // d["scale"].shape[0], f32)
    else:
        raise NotImplementedError(f"no f32 weight of Linear kind {kind!r}")
    if "in_perm" in d:  # row j of w is input element in_perm[j]
        w = torch.empty_like(w).index_copy_(0, d["in_perm"], w)
    return w


def _requant(lin: Linear, gtype, dtype, device, cols: int | None = None) -> Linear:
    """re_isq of one Linear (its first `cols` outputs): the f32 weight as
    JAX's identity forward gives it, eye @ w + b (a sum, so a -0.0 comes
    out +0.0) with the bias taken off again, quantized by the loader's
    _maybe_quantize, or dense where that returns None."""
    w = weight_f32(lin)[:, :cols]
    b = lin.data.get("b")
    b = None if b is None else b[..., :cols].to(torch.float32)
    w = w + (0.0 if b is None else b)
    if b is not None:
        w = w - b
    b = None if b is None else b.cpu().numpy()
    q = _maybe_quantize(w.T.contiguous().cpu().numpy(), b, gtype, dtype, device)
    if q is not None:
        return q
    return make_dense(w.to(dtype), None if b is None else torch.from_numpy(b).to(device, dtype))


def _requant_tree(node, gtype, dtype, device, num_experts: int, key=None):
    """re_isq of every Linear in a layer dict (or the lm_head): a router on
    its num_experts real columns, padded to 16 again; dense expert stacks
    kept; a packed expert stack raises."""
    if isinstance(node, Linear):
        if key == "router":
            lin = _requant(node, gtype, dtype, device, num_experts)
            return pad_linear_out(lin, 16, max_pad=15) or lin
        return _requant(node, gtype, dtype, device)
    if key == "experts":
        packed = [lin.kind for lin in node.values() if lin.kind != "dense"]
        if packed:
            raise NotImplementedError(
                f"re_isq of a packed expert stack ({packed[0]}) is not supported, as in the "
                "JAX package, whose identity forward cannot unpack one")
        return node
    if isinstance(node, dict):
        return {k: _requant_tree(v, gtype, dtype, device, num_experts, k) for k, v in node.items()}
    return node


def _next_bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class PipelineConfig:
    page_size: int = 16
    # None = size the pool from free device memory (utils/memory.py)
    num_pages: int | None = 512
    kv_mem_fraction: float = 0.9
    max_seqs: int = 8
    max_model_len: int = 4096
    prefill_buckets: tuple[int, ...] = (16, 64, 256, 512)
    dtype: Any = torch.bfloat16
    # greedy tokens generated per decode call; tokens past a stop condition
    # are discarded by the engine
    decode_steps: int = 8
    kv_mem_bytes: int | None = None
    kv_ctxt_len: int | None = None
    # Q6_K -> int8 per-group requant at load ("rq8", served by the K2
    # kernel): group 32 (the wire-Q8_0 layout) or 64; None keeps Q6_K as
    # Q6_K, served by K3 (int8 activations, decode rows), K4 (prefill rows
    # up to 256, and every row count at chunk span 128) and q6k_dequant +
    # torch.matmul above 256 rows
    rq8_group: int | None = 32
    # KV pool layout: None = head-major at max_model_len >= 4096 (the
    # layout the block-table decode kernel streams), token-major below
    kv_head_major: bool | None = None
    # int8 KV pools with one f32 absmax scale per (slot, head): ~2x the
    # pages in the same memory, for ~1/255 of each row's range of error a
    # value (JAX text.py:67-71); attention over them gathers and dequantizes
    # (the blockwise route past span 4096 block by block), as K6' and K7
    # stream bf16
    kv_quant: bool = False
    # paged attention backend: None/"default" = the per-step routes of
    # models/decoder.py; "ragged" = one combined K/V pool, token-major, with
    # the ragged paged attention kernel K12 for every continuation chunk and
    # decode step (ops/ragged_attention.py)
    attn_backend: str | None = None
    # activation route of every packed GEMV (Linear.int8_act): True = x
    # quantized to int8 per block (K1, K2, K3, K9), False = x kept in its
    # dtype (K5, K8, K9b, and K4 for Q6_K at every row count), at the price
    # of reading x at 2 bytes an element and running bf16 tensor cores. It
    # stands for the JAX package's four environment gates
    # (ops/quant_matmul.py:436 _use_q4k_int8, :832 _use_q5k_int8, :1060
    # _use_q6k_int8, :1365 _use_q8_0_int8), which are on on the TPU; with
    # them off, and off the TPU, no activation is rounded to int8.
    int8_activations: bool = True
    device: str = "cuda"


class TextPipeline:
    """Owns model params + paged cache + the step functions."""

    supports_multistep = True  # multi-token decode per call
    supports_topk_pack = True  # run_decode(mode="topk")
    supports_sampled_multistep = True  # run_decode_multi(seqs, sampling)
    supports_batched_prefill = True
    # the speculative device loops (pipeline/speculative.py) call
    # decoder_forward on this pipeline's params and cache directly
    supports_spec_device_loop = True

    def __init__(self, cfg: ModelConfig, params: DecoderParams, rope: RopeTable,
                 pc: PipelineConfig):
        self.device = torch.device(pc.device)
        # token ids go through f32 in the greedy packs (_run,
        # run_decode_multi), exact only while every id fits its mantissa
        assert cfg.vocab_size < (1 << 24), (
            f"vocab_size {cfg.vocab_size} >= 2^24: the f32-packed greedy ids would lose "
            "precision")
        if pc.attn_backend not in (None, "default", "ragged"):
            raise ValueError(f"attn_backend {pc.attn_backend!r}: expected None, 'default' or "
                             "'ragged'")
        if cfg.is_moe and not cfg.moe_grouped:
            # the grouped dropless dispatch (K13) for dense experts, as the JAX
            # pipeline sets it for every unsharded MoE model (without its
            # backend test and environment gate; the port has no meshes)
            cfg = dataclasses.replace(cfg, moe_grouped=True)
        self.cfg = cfg
        self.rope = rope.to(self.device)
        if pc.num_pages is None:
            from mistralrs_tpu_torch.utils.memory import PagedCacheConfig, calculate_num_pages

            n = calculate_num_pages(
                PagedCacheConfig(mem_fraction=pc.kv_mem_fraction, mem_bytes=pc.kv_mem_bytes,
                                 context_len=pc.kv_ctxt_len, page_size=pc.page_size),
                cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                # an int8 payload and its f32 scale's share: ~1 + 4 / head_dim bytes
                dtype_bytes=((1 + 4 / cfg.head_dim) if pc.kv_quant
                             else torch.empty((), dtype=pc.dtype).element_size()),
                max_seqs=pc.max_seqs, device=self.device,
            )
            pc = dataclasses.replace(pc, num_pages=n)
        self.pc = pc
        self.max_pages_per_seq = math.ceil(pc.max_model_len / pc.page_size)
        # q|k(|v) and gate|up fused into wide GEMVs; projections that cannot
        # fuse (mixed kinds) stay separate
        params = fuse_decoder_params(params)
        if pc.rq8_group:
            params = requant_q6k_params(params, gs=pc.rq8_group)
        self.params = set_activation_route(params, pc.int8_activations)
        self.kv_combined = pc.attn_backend == "ragged" and not pc.kv_quant
        if pc.attn_backend == "ragged" and pc.kv_quant:
            logging.getLogger(__name__).warning(
                "attn_backend=ragged is incompatible with kv_quant; serving the int8 cache over "
                "the default attention paths")
        # the combined pool is token-major by construction
        self.head_major = not self.kv_combined and (
            pc.kv_head_major if pc.kv_head_major is not None else pc.max_model_len >= 4096)
        self.cache = PagedKVCache.create(cfg.num_layers, pc.num_pages, pc.page_size,
                                         cfg.num_kv_heads, cfg.head_dim, pc.dtype,
                                         device=self.device, head_major=self.head_major,
                                         combined=self.kv_combined, quant=pc.kv_quant)
        self._last_greedy_pack: torch.Tensor | None = None
        self._last_topk_pack: torch.Tensor | None = None
        self._last_logits: torch.Tensor | None = None
        # the decode loop's static inputs, by block-table width: int64
        # [B, 5 + width] (ids, kv_lens, pos_off, top_ks, seed, the tables)
        # and f32 [B, 4] (active, temps, top_ps, min_ps)
        self._loop_bufs: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self.graphs = DecodeGraphs(self.device) if self.device.type == "cuda" else None

    # ------------------------------------------------------------- steps
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _hidden(self, ids, positions, slot_mapping, block_tables, kv_lens, active,
                first_chunk: bool = False) -> torch.Tensor:
        """The decoder's final hidden states [B, T, E] of a padded [B, T]
        batch given as host arrays; the new K/V go into the pools."""
        meta = PagedAttnMeta(
            positions=self._dev(positions),
            slot_mapping=self._dev(slot_mapping),
            block_tables=self._dev(block_tables),
            kv_lens=self._dev(kv_lens),
            active=self._dev(active),
            first_chunk=first_chunk,
            head_major=self.head_major,
        )
        return decoder_forward(self.params, self.cfg, self.rope, self._dev(ids), self.cache,
                               meta)[0]

    @torch.no_grad()
    def _run(self, ids, positions, slot_mapping, block_tables, kv_lens, active,
             last_idx, first_chunk: bool = False, temps=None) -> torch.Tensor:
        """One forward over a padded [B, T] batch; keeps the full logits at
        each row's `last_idx` and the greedy pack [2, B] (argmax id, its
        logit) on the device, and with `temps` [B] the top-K pack."""
        h = self._hidden(ids, positions, slot_mapping, block_tables, kv_lens, active, first_chunk)
        B = ids.shape[0]
        h_last = h[torch.arange(B, device=self.device), self._dev(last_idx).to(torch.int64)]
        logits = compute_logits(self.params, self.cfg, h_last)  # [B, V] f32
        self._last_greedy_pack = greedy_pack(logits)
        self._last_topk_pack = None if temps is None else topk_pack(logits, self._dev(temps))
        self._last_logits = logits
        return logits

    @torch.no_grad()
    def _verify(self, ids, positions, slot_mapping, block_tables, kv_lens,
                active) -> tuple[torch.Tensor, torch.Tensor]:
        """The all-positions forward of run_span (JAX _build_verify_fn
        :469-494, _verify :496-507), the target's verify of speculative
        decoding: f32 logits at every fed position [B, W, V] and the greedy
        pack [2, B, W] (argmax id as f32, its logit), on the device."""
        h = self._hidden(ids, positions, slot_mapping, block_tables, kv_lens, active)
        logits = compute_logits(self.params, self.cfg, h)
        return logits, greedy_pack(logits)

    @property
    def last_greedy_pack(self) -> np.ndarray:
        """[2, B] (argmax token id as f32, its logit) of the last step, on the host."""
        return self._last_greedy_pack.cpu().numpy()

    def fetch_full_logits_row(self, i: int) -> np.ndarray:
        """Full-vocab logits of row i from the last step."""
        return self._last_logits[i].cpu().numpy()

    def run_decode_multi(self, seqs: list[Sequence], sampling=None) -> np.ndarray:
        """Multi-token decode: `decode_steps` forwards, each feeding back its
        argmax, or with `sampling` = (temps [n], top_ks [n], top_ps [n],
        min_ps [n], seed) sample_step's draw. Returns pack [3, T, n] =
        (token ids, raw logit of the token, log10 of its kept probability;
        the raw logit again when greedy). Advances each seq's kv_len by
        decode_steps; the caller rewinds via kv_len when it consumes fewer.
        On the card the call is one replay of the key's CUDA graph (captured
        on its first use; a failed capture or replay raises); on the CPU the
        loop runs eagerly."""
        global decode_eager_loops
        key = self._fill_loop(seqs, sampling)
        if self.graphs is not None:
            pack = self.graphs.replay(key, self._decode_loop)
        else:
            decode_eager_loops += 1
            pack = self._decode_loop(key)
        return self._loop_result(seqs, pack)

    def run_decode_multi_eager(self, seqs: list[Sequence], sampling=None) -> np.ndarray:
        """run_decode_multi's call as T eager forwards on any device, over
        the same buffers (for tests and for timing against the graphs)."""
        global decode_eager_loops
        key = self._fill_loop(seqs, sampling)
        decode_eager_loops += 1
        return self._loop_result(seqs, self._decode_loop(key))

    def _loop_result(self, seqs: list[Sequence], pack: torch.Tensor) -> np.ndarray:
        out = pack.cpu().numpy()[:, :, :len(seqs)]
        for seq in seqs:
            seq.kv_len += self.pc.decode_steps
        return out

    def _fill_loop(self, seqs: list[Sequence], sampling) -> tuple[int, bool]:
        """Write a call's inputs into the static buffers of its block-table
        width (padding rows: page-0 tables, inactive, greedy as (1.0, 1,
        1.0, 0.0), JAX :450-458); returns the loop's key (width, sampled)."""
        B = self.pc.max_seqs
        T = self.pc.decode_steps
        n = len(seqs)
        if n > B:
            raise ValueError(f"{n} sequences > max_seqs {B}")
        ps = self.pc.page_size
        bases = [self._window_base_pages(s.kv_len) for s in seqs]
        width = self._table_width(seqs, T, bases)
        ints = np.zeros((B, 5 + width), np.int64)
        floats = np.zeros((B, 4), np.float32)
        ints[:, 3] = 1
        floats[:, 1:3] = 1.0
        for i, (seq, base) in enumerate(zip(seqs, bases)):
            ints[i, 0] = seq.tokens[-1]
            # masks/tables run window-relative; rope gets absolute positions
            ints[i, 1] = seq.kv_len - base * ps
            ints[i, 2] = base * ps
            ints[i, 5:] = self._tables_row(seq, width, base)
            floats[i, 0] = 1.0
        if sampling is not None:
            temps, top_ks, top_ps, min_ps, seed = sampling
            ints[:n, 3] = top_ks
            ints[:, 4] = seed
            floats[:n, 1] = temps
            floats[:n, 2] = top_ps
            floats[:n, 3] = min_ps
        bufs = self._loop_bufs.get(width)
        if bufs is None:
            bufs = self._loop_bufs[width] = (
                torch.zeros(ints.shape, dtype=torch.int64, device=self.device),
                torch.zeros(floats.shape, dtype=torch.float32, device=self.device))
        bufs[0].copy_(torch.from_numpy(ints))
        bufs[1].copy_(torch.from_numpy(floats))
        return width, sampling is not None

    @torch.no_grad()
    def _decode_loop(self, key: tuple[int, bool]) -> torch.Tensor:
        """The T forwards of a multistep call of key (block-table width,
        sampled), reading only the static buffers of that width (so a graph
        of it serves every call of its key): pack [3, T, B] f32 on the
        device."""
        width, sampled = key
        ints, floats = self._loop_bufs[width]
        ps = self.pc.page_size
        B = ints.shape[0]
        tok, kvl, off = ints[:, 0], ints[:, 1], ints[:, 2]
        tables = ints[:, 5:].contiguous()
        act = floats[:, 0].contiguous()
        samp = (floats[:, 1], ints[:, 3], floats[:, 2], floats[:, 3])
        toks, raws, lps = [], [], []
        for t in range(self.pc.decode_steps):
            pos = kvl[:, None]
            page = torch.gather(tables, 1, pos // ps)
            meta = PagedAttnMeta(positions=pos + off[:, None], slot_mapping=page * ps + pos % ps,
                                 block_tables=tables, kv_lens=kvl + 1, active=act,
                                 head_major=self.head_major)
            h, _ = decoder_forward(self.params, self.cfg, self.rope, tok[:, None], self.cache, meta)
            logits = compute_logits(self.params, self.cfg, h[:, 0])
            if sampled:
                tok, raw, lp = sample_step(logits, *samp, decode_uniforms(ints[0, 4], t, B))
            else:
                tok = torch.argmax(logits, dim=-1)
                raw = lp = torch.gather(logits, 1, tok[:, None])[:, 0]
            toks.append(tok)
            raws.append(raw)
            lps.append(lp)
            kvl = kvl + 1
        return torch.stack([torch.stack(toks).to(torch.float32), torch.stack(raws),
                            torch.stack(lps)])

    def apply_copies(self, ops: list[tuple[int, int]]) -> None:
        """COW page copies."""
        copy_pages(self.cache, [s for s, _ in ops], [d for _, d in ops])

    def re_isq(self, ggml_type: str) -> None:
        """Runtime re-quantization of every Linear to `ggml_type` (JAX
        :563-643, the reference's /re_isq; _requant_tree): each weight's
        f32 values (weight_f32; the bias added and taken off again, as JAX's
        identity forward does) are quantized on the host by the loader's
        _maybe_quantize, or kept dense where it returns None. Differences
        from JAX, where the port's params differ: a Mixtral router padded
        to 16 outputs by the fusion is requantized on its real columns and
        padded again; dense expert stacks stay dense (as ISQ leaves them at
        load; JAX's identity forward cannot take an [E, in, out] weight),
        and a packed one raises, as in JAX. The activation route is set
        again (rq8 is not applied again, as in JAX). Layers are requantized
        by a pool of the loader's LOAD_THREADS threads. The decode loop's
        CUDA graphs captured the old weights' addresses: they and their
        memory pool are dropped first, for an empty DecodeGraphs, so the
        next multistep call captures anew. Runs between engine steps."""
        gtype = parse_isq(ggml_type)
        dt, dev, E = self.pc.dtype, self.device, self.cfg.num_experts
        if self.graphs is not None:
            torch.cuda.synchronize(dev)
            self.graphs = DecodeGraphs(dev)
        with ThreadPoolExecutor(max_workers=LOAD_THREADS) as pool:
            layers = list(pool.map(lambda lp: _requant_tree(lp, gtype, dt, dev, E),
                                   self.params.layers))
        params = dataclasses.replace(self.params, layers=layers,
                                     lm_head=_requant_tree(self.params.lm_head, gtype, dt, dev, E))
        self.params = set_activation_route(params, self.pc.int8_activations)

    # ------------------------------------------------------------- helpers
    def _tables_row(self, seq: Sequence, width: int | None = None, base: int = 0) -> np.ndarray:
        width = width or self.max_pages_per_seq
        row = np.zeros(width, np.int64)
        bt = seq.block_table[base : base + width]
        row[: len(bt)] = bt
        return row

    def _window_base_pages(self, kv_len: int) -> int:
        """Whole pages strictly behind the sliding window when every layer is
        windowed: decode slices the tables from this base (window-relative
        kv_lens, absolute rope positions), so it never gathers dead history."""
        w = self.cfg.sliding_window
        if w is None or self.cfg.sliding_window_pattern != "all":
            return 0
        return max(0, kv_len - w) // self.pc.page_size

    def _table_width(self, seqs: list[Sequence], lookahead: int,
                     bases: list[int] | None = None) -> int:
        """Page-bucketed block-table width covering every row's context plus
        `lookahead` tokens about to be written (minus each row's window base)."""
        bases = bases or [0] * len(seqs)
        ps = self.pc.page_size
        return self._width_for_tokens(max(
            s.kv_len + lookahead - b * ps for s, b in zip(seqs, bases)
        ))

    def _width_for_tokens(self, need_tok: int) -> int:
        need = -(-need_tok // self.pc.page_size)
        w = 4
        while w < need:
            w *= 2
        return min(w, self.max_pages_per_seq)

    def _slot(self, seq: Sequence, pos: int) -> int:
        page = seq.block_table[pos // self.pc.page_size]
        return page * self.pc.page_size + pos % self.pc.page_size

    def _slots(self, table, start: int, m: int) -> np.ndarray:
        """Flat slots for positions start..start+m over a block table."""
        ps = self.pc.page_size
        pos = np.arange(start, start + m)
        table = np.asarray(table, np.int64)
        return table[pos // ps] * ps + pos % ps

    # ------------------------------------------------------------- decode
    def run_decode(self, seqs: list[Sequence], greedy: bool = False,
                   mode: str | None = None) -> np.ndarray:
        """One decode token for each seq. mode "full" (default) returns
        logits [n, V]; "greedy" the argmax pack [2, n]; "topk" the device
        top-K sampling pack (tv [n, K], ti [n, K], m [n], z [n]) of each
        seq's tempered logits (temperature 1 where it has none)."""
        mode = mode or ("greedy" if greedy else "full")
        if mode not in ("full", "greedy", "topk"):
            raise ValueError(f"decode mode {mode!r}: expected 'full', 'greedy' or 'topk'")
        B = self.pc.max_seqs
        if len(seqs) > B:
            raise ValueError(f"{len(seqs)} sequences > max_seqs {B}")
        ps = self.pc.page_size
        bases = [self._window_base_pages(s.kv_len) for s in seqs]
        width = self._table_width(seqs, 1, bases)
        ids = np.zeros((B, 1), np.int64)
        positions = np.zeros((B, 1), np.int64)
        slot_mapping = np.zeros((B, 1), np.int64)  # page-0 garbage for padding
        block_tables = np.zeros((B, width), np.int64)
        kv_lens = np.ones((B,), np.int64)  # 1 for padding rows: no empty softmax rows
        active = np.zeros((B,), np.float32)
        temps = np.ones((B,), np.float32)
        for i, (seq, base) in enumerate(zip(seqs, bases)):
            pos = seq.kv_len
            ids[i, 0] = seq.tokens[-1]
            positions[i, 0] = pos
            slot_mapping[i, 0] = self._slot(seq, pos)
            block_tables[i] = self._tables_row(seq, width, base)
            kv_lens[i] = pos + 1 - base * ps
            active[i] = 1.0
            if seq.sampling.temperature is not None:
                temps[i] = seq.sampling.temperature
        logits = self._run(ids, positions, slot_mapping, block_tables, kv_lens, active,
                           np.zeros((B,), np.int64), temps=temps if mode == "topk" else None)
        for seq in seqs:
            seq.kv_len += 1
        n = len(seqs)
        if mode == "greedy":
            return self.last_greedy_pack[:, :n]
        if mode == "topk":
            p = self._last_topk_pack.cpu().numpy()[:n]  # one fetch of [n, 2K+2]
            K = TOPK_PACK
            return p[:, :K], p[:, K:2 * K].astype(np.int32), p[:, 2 * K], p[:, 2 * K + 1]
        return logits[:n].cpu().numpy()

    def run_span(self, rows: list[tuple[list[int], int, np.ndarray]], width: int, *,
                 all_positions: bool = False, greedy: bool = False) -> np.ndarray:
        """Batched multi-token feed (JAX :509-560): row = (tokens, start
        position, block-table row); each row's tokens are written to the KV
        cache at positions start.. and attended causally, its padding past
        them into page 0, and padding rows up to `max_seqs` are inactive. With
        all_positions=True returns the logits at every fed position [n,
        width, V] (the target's verify), or with greedy the pack [2, n,
        width]; otherwise the logits at each row's last token [n, V] (the
        draft's steps), or with greedy the pack [2, n]. No Sequence state
        is mutated."""
        B = self.pc.max_seqs
        n = len(rows)
        if not 0 < n <= B:
            raise ValueError(f"{n} span rows for max_seqs {B}")
        W = width
        ps = self.pc.page_size
        bases = [self._window_base_pages(start) for _, start, _ in rows]
        tw = self._width_for_tokens(max(start + W - b * ps for (_, start, _), b in zip(rows, bases)))
        ids = np.zeros((B, W), np.int64)
        positions = np.zeros((B, W), np.int64)
        slot_mapping = np.zeros((B, W), np.int64)  # page-0 garbage for padding
        block_tables = np.zeros((B, tw), np.int64)
        kv_lens = np.ones((B,), np.int64)
        active = np.zeros((B,), np.float32)
        last_idx = np.zeros((B,), np.int64)
        for i, ((toks, start, table_row), base) in enumerate(zip(rows, bases)):
            m = len(toks)
            if not 0 < m <= W:
                raise ValueError(f"span row of {m} tokens for width {W}")
            ids[i, :m] = toks
            positions[i, :m] = np.arange(start, start + m)
            slot_mapping[i, :m] = self._slots(table_row, start, m)
            sl = table_row[base : base + tw]
            block_tables[i, : len(sl)] = sl
            # the padded-width trick of run_prefill_chunk (q_offset = kv_lens
            # - W), window-relative for window models
            kv_lens[i] = start + W - base * ps
            active[i] = 1.0
            last_idx[i] = m - 1
        if all_positions:
            logits, pack = self._verify(ids, positions, slot_mapping, block_tables, kv_lens,
                                        active)
            return (pack[:, :n] if greedy else logits[:n]).cpu().numpy()
        logits = self._run(ids, positions, slot_mapping, block_tables, kv_lens, active, last_idx)
        if greedy:
            return self.last_greedy_pack[:, :n]
        return logits[:n].cpu().numpy()

    # ------------------------------------------------------------- prefill
    def run_prefill_chunk(self, seq: Sequence, chunk: list[int], greedy: bool = False,
                          advance_state: bool = True) -> np.ndarray:
        """Prefill `chunk` tokens (continuing at seq.prefill_done_tokens).
        Returns logits [V] at the last chunk position, or with greedy=True
        the [2] argmax pack."""
        T = _next_bucket(len(chunk), self.pc.prefill_buckets)
        start = seq.prefill_done_tokens
        n = len(chunk)
        ps = self.pc.page_size
        ids = np.zeros((1, T), np.int64)
        ids[0, :n] = chunk
        positions = np.zeros((1, T), np.int64)
        positions[0, :n] = np.arange(start, start + n)
        slot_mapping = np.zeros((1, T), np.int64)
        slot_mapping[0, :n] = self._slots(seq.block_table, start, n)
        base = self._window_base_pages(start)
        block_tables = self._tables_row(seq, self._width_for_tokens(start + T - base * ps),
                                        base)[None]
        # the decoder derives q_offset = kv_lens - T; with the chunk padded
        # from n to T, start + T gives real queries q_pos = start + j
        kv_lens = np.asarray([start + T - base * ps], np.int64)
        logits = self._run(ids, positions, slot_mapping, block_tables, kv_lens,
                           np.ones((1,), np.float32), np.asarray([n - 1], np.int64),
                           first_chunk=(start == 0))
        if advance_state:
            seq.prefill_done_tokens = start + n
            seq.kv_len = start + n
        if greedy:
            return self.last_greedy_pack[:, 0]
        return logits[0].cpu().numpy()

    def run_prefill_chunks(self, items: list[tuple[Sequence, list[int]]]) -> None:
        """Batched chunked prefill: one forward of one row per sequence (rows
        may differ in length and start; the padding past each chunk writes to
        page 0). Leaves the greedy pack / logits for `last_greedy_pack` and
        `fetch_full_logits_row`."""
        B = len(items)
        if not 0 < B <= self.pc.max_seqs:
            raise ValueError(f"{B} prefill rows for max_seqs {self.pc.max_seqs}")
        T = _next_bucket(max(len(c) for _, c in items), self.pc.prefill_buckets)
        first = all(s.prefill_done_tokens == 0 for s, _ in items)
        ps = self.pc.page_size
        bases = [self._window_base_pages(s.prefill_done_tokens) for s, _ in items]
        width = self._width_for_tokens(max(
            s.prefill_done_tokens + T - b * ps for (s, _), b in zip(items, bases)
        ))
        ids = np.zeros((B, T), np.int64)
        positions = np.zeros((B, T), np.int64)
        slot_mapping = np.zeros((B, T), np.int64)
        block_tables = np.zeros((B, width), np.int64)
        kv_lens = np.ones((B,), np.int64)
        active = np.ones((B,), np.float32)
        last_idx = np.zeros((B,), np.int64)
        for i, ((seq, chunk), base) in enumerate(zip(items, bases)):
            start = seq.prefill_done_tokens
            m = len(chunk)
            ids[i, :m] = chunk
            positions[i, :m] = np.arange(start, start + m)
            slot_mapping[i, :m] = self._slots(seq.block_table, start, m)
            block_tables[i] = self._tables_row(seq, width, base)
            kv_lens[i] = start + T - base * ps
            last_idx[i] = m - 1
        self._run(ids, positions, slot_mapping, block_tables, kv_lens, active, last_idx,
                  first_chunk=first)
        for seq, chunk in items:
            seq.prefill_done_tokens += len(chunk)
            seq.kv_len = seq.prefill_done_tokens
