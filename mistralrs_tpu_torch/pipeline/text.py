"""Text-model pipeline: prefill and decode steps over the paged KV cache.

Counterpart of mistralrs_tpu/pipeline/text.py. Each step builds its host
arrays as the JAX pipeline does (decode padded to `max_seqs` rows, prefill
chunks padded to a bucket, page 0 as the garbage page for padding slots,
page-bucketed block-table widths), moves them to the device and runs
`decoder_forward` eagerly; the KV pools are updated in place, head-major
at `max_model_len >= 4096` unless `kv_head_major` says otherwise, or one
combined K/V pool on the ragged backend (`attn_backend="ragged"`). A batched
prefill has one row per sequence: eager PyTorch has no compiled shape to
keep, so it does not pad the batch to `max_seqs` as the JAX package does.

An MoE model (mixtral) gets `moe_grouped` set, so dense experts take the
grouped dropless dispatch (models/decoder.py).

Not in this port yet: the device-sampled multistep loop and the top-K pack
(sampled requests go through the engine's host sampler on full logits, so
`supports_topk_pack` and `supports_sampled_multistep` are False),
speculative verification, runtime re-quantization, meshes, CUDA-graph
capture of the decode loop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from mistralrs_tpu_torch.engine.sequence import Sequence
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.decoder import DecoderParams, compute_logits, decoder_forward
from mistralrs_tpu_torch.ops.paged_attention import PagedAttnMeta, PagedKVCache, copy_pages
from mistralrs_tpu_torch.ops.rope import RopeTable
from mistralrs_tpu_torch.quant.fuse import fuse_decoder_params, requant_q6k_params
from mistralrs_tpu_torch.quant.qlinear import Linear

# size of the device top-K sampling pack in the JAX package (the engine reads
# it when a pipeline supports that pack; this one does not)
TOPK_PACK = 64


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

    supports_multistep = True  # greedy multi-token decode per call
    supports_topk_pack = False  # no device top-K sampling pack
    supports_sampled_multistep = False  # no device-sampled multistep loop
    supports_batched_prefill = True

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
                dtype_bytes=torch.empty((), dtype=pc.dtype).element_size(),
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
        self.kv_combined = pc.attn_backend == "ragged"
        # the combined pool is token-major by construction
        self.head_major = not self.kv_combined and (
            pc.kv_head_major if pc.kv_head_major is not None else pc.max_model_len >= 4096)
        self.cache = PagedKVCache.create(cfg.num_layers, pc.num_pages, pc.page_size,
                                         cfg.num_kv_heads, cfg.head_dim, pc.dtype,
                                         device=self.device, head_major=self.head_major,
                                         combined=self.kv_combined)
        self._last_greedy_pack: torch.Tensor | None = None
        self._last_logits: torch.Tensor | None = None

    # ------------------------------------------------------------- steps
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @torch.no_grad()
    def _run(self, ids, positions, slot_mapping, block_tables, kv_lens, active,
             last_idx, first_chunk: bool = False) -> torch.Tensor:
        """One forward over a padded [B, T] batch; keeps the full logits at
        each row's `last_idx` and the greedy pack [2, B] (argmax id, its
        logit) on the device."""
        meta = PagedAttnMeta(
            positions=self._dev(positions),
            slot_mapping=self._dev(slot_mapping),
            block_tables=self._dev(block_tables),
            kv_lens=self._dev(kv_lens),
            active=self._dev(active),
            first_chunk=first_chunk,
            head_major=self.head_major,
        )
        h, _ = decoder_forward(self.params, self.cfg, self.rope, self._dev(ids), self.cache, meta)
        B = ids.shape[0]
        h_last = h[torch.arange(B, device=self.device), self._dev(last_idx).to(torch.int64)]
        logits = compute_logits(self.params, self.cfg, h_last)  # [B, V] f32
        top = torch.argmax(logits, dim=-1)
        chosen = torch.gather(logits, 1, top[:, None])[:, 0]
        self._last_greedy_pack = torch.stack([top.to(torch.float32), chosen])
        self._last_logits = logits
        return logits

    @property
    def last_greedy_pack(self) -> np.ndarray:
        """[2, B] (argmax token id as f32, its logit) of the last step, on the host."""
        return self._last_greedy_pack.cpu().numpy()

    def fetch_full_logits_row(self, i: int) -> np.ndarray:
        """Full-vocab logits of row i from the last step."""
        return self._last_logits[i].cpu().numpy()

    @torch.no_grad()
    def run_decode_multi(self, seqs: list[Sequence], sampling=None) -> np.ndarray:
        """Greedy multi-token decode: `decode_steps` forwards, each feeding its
        argmax back. Returns pack [3, T, n] = (token ids, raw logit of the
        token, the same logit). Advances each seq's kv_len by decode_steps;
        the caller rewinds via kv_len when it consumes fewer."""
        if sampling is not None:
            raise NotImplementedError("device-sampled multistep decode is not ported yet")
        B = self.pc.max_seqs
        T = self.pc.decode_steps
        ps = self.pc.page_size
        n = len(seqs)
        bases = [self._window_base_pages(s.kv_len) for s in seqs]
        width = self._table_width(seqs, T, bases)
        ids = np.zeros((B,), np.int64)
        kv_lens = np.zeros((B,), np.int64)
        pos_off = np.zeros((B,), np.int64)
        block_tables = np.zeros((B, width), np.int64)
        active = np.zeros((B,), np.float32)
        for i, (seq, base) in enumerate(zip(seqs, bases)):
            ids[i] = seq.tokens[-1]
            # masks/tables run window-relative; rope gets absolute positions
            kv_lens[i] = seq.kv_len - base * ps
            pos_off[i] = base * ps
            block_tables[i] = self._tables_row(seq, width, base)
            active[i] = 1.0
        tok, kvl, off = self._dev(ids), self._dev(kv_lens), self._dev(pos_off)
        tables, act = self._dev(block_tables), self._dev(active)
        toks, chosen = [], []
        for _ in range(T):
            pos = kvl[:, None]
            page = torch.gather(tables, 1, pos // ps)
            meta = PagedAttnMeta(positions=pos + off[:, None], slot_mapping=page * ps + pos % ps,
                                 block_tables=tables, kv_lens=kvl + 1, active=act,
                                 head_major=self.head_major)
            h, _ = decoder_forward(self.params, self.cfg, self.rope, tok[:, None], self.cache, meta)
            logits = compute_logits(self.params, self.cfg, h[:, 0])
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
            chosen.append(torch.gather(logits, 1, tok[:, None])[:, 0])
            kvl = kvl + 1
        vals = torch.stack(chosen)
        pack = torch.stack([torch.stack(toks).to(torch.float32), vals, vals])
        for seq in seqs:
            seq.kv_len += T
        return pack.cpu().numpy()[:, :, :n]

    def apply_copies(self, ops: list[tuple[int, int]]) -> None:
        """COW page copies."""
        copy_pages(self.cache, [s for s, _ in ops], [d for _, d in ops])

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
        logits [n, V]; "greedy" the argmax pack [2, n]."""
        mode = mode or ("greedy" if greedy else "full")
        if mode not in ("full", "greedy"):
            raise NotImplementedError(f"decode mode {mode!r} is not ported yet")
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
        for i, (seq, base) in enumerate(zip(seqs, bases)):
            pos = seq.kv_len
            ids[i, 0] = seq.tokens[-1]
            positions[i, 0] = pos
            slot_mapping[i, 0] = self._slot(seq, pos)
            block_tables[i] = self._tables_row(seq, width, base)
            kv_lens[i] = pos + 1 - base * ps
            active[i] = 1.0
        logits = self._run(ids, positions, slot_mapping, block_tables, kv_lens, active,
                           np.zeros((B,), np.int64))
        for seq in seqs:
            seq.kv_len += 1
        n = len(seqs)
        if mode == "greedy":
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
