"""The serve loop: schedule -> step -> sample -> stream.

Counterpart of mistralrs_tpu/engine/engine.py, copied nearly verbatim.
Reference parity: mistralrs-core/src/engine/mod.rs `Engine::run` (:97-421) +
`add_request` (:451-734) and pipeline/sampling.rs (`sample_and_add_toks`
:231, `finish_or_add_toks_to_seq` :15-229).

What this port does not have yet, and how it says so: grammar-constrained
requests (`add_request` raises NotImplementedError).

KV swap preemption (`preempt_mode="swap"`) copies a preempted sequence's
live pages to host tensors and writes them back in place on re-admission
(`_swap_out_seq`, `_swap_in_seq`), so the decode graphs' pool addresses
stay valid; the default is preempt-by-recompute, and a speculative
pipeline always recomputes, as in the JAX engine.

Sampled requests take the pipeline's device-sampled multistep loop where
`_multi_sampled_ok` allows it, else the device top-K pack, else the host
sampler on full logits, as in the JAX engine.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import numpy as np

from mistralrs_tpu_torch.engine.block_manager import make_block_manager
from mistralrs_tpu_torch.engine.prefix_cache import PrefixCacheManager
from mistralrs_tpu_torch.engine.sampler import SamplingParams
from mistralrs_tpu_torch.engine.scheduler import Scheduler
from mistralrs_tpu_torch.engine.sequence import (
    Sequence,
    SequenceGroup,
    SequenceState,
    StopReason,
)

# stream callback: (seq, new_text_delta, finished_reason_or_None)
StreamCallback = Callable[[Sequence, str, str | None], None]


@dataclasses.dataclass
class GenerationRequest:
    prompt_tokens: list[int]
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    request_id: str = ""
    return_logprobs: bool = False
    stream: StreamCallback | None = None
    constraint: Any | None = None  # grammar.Constraint (regex/yacc)
    # vision: preprocessed images [{"pixel_values", "orig_hw"}, ...]
    images: list | None = None


class Engine:
    def __init__(
        self,
        pipeline,
        *,
        eos_token_ids: set[int] = frozenset(),
        detokenizer: Callable[[list[int]], str] | None = None,
        seed: int = 0,
        preempt_mode: str = "recompute",
        prefix_cache: bool = True,
        prefix_cache_pages: int | None = None,
        grammar_vocab: list[bytes] | None = None,
        truncate_sequence: bool = True,
    ):
        """grammar_vocab: per-token byte strings enabling grammar-constrained
        decoding (built lazily into a TokTrie on the first constrained
        request; ref engine/mod.rs recognizer construction :668)."""
        self.pipeline = pipeline
        pc = pipeline.pc
        self.is_speculative = getattr(pipeline, "is_speculative", False)
        # Prefix caching composes with speculative decoding: draft and
        # target caches are indexed by the SAME page ids (one block_manager),
        # so a trie-retained page preserves both pools' KV — a hit replays
        # consistent draft AND target state, and the first post-hit prefill
        # chunk sets seq.draft_kv_len past the matched pages. (The reference
        # disables its prefix cacher in composite pipelines; this is a
        # deliberate capability beyond it — see tests/test_speculative.py
        # prefix-cache composition test.)
        self.block_manager = make_block_manager(pc.num_pages, pc.page_size)
        self.truncate_sequence = truncate_sequence
        self.prefix_cacher = (
            PrefixCacheManager(self.block_manager, max_pages=prefix_cache_pages)
            if prefix_cache
            else None
        )
        self.decode_steps = 1 if self.is_speculative else max(
            1, getattr(pc, "decode_steps", 1)
        )
        # on-device speculative loop (PromptLookupPipeline.run_spec_multi):
        # rounds per dispatch; the scheduler must reserve KV lookahead for
        # the worst case (every round fully accepted)
        self.spec_rounds = (
            max(1, getattr(pipeline, "spec_rounds", 1) or 1)
            if self.is_speculative and hasattr(pipeline, "run_spec_multi")
            else 1
        )
        self.batched_prefill_ok = getattr(pipeline, "supports_batched_prefill", False)
        self.scheduler = Scheduler(
            self.block_manager,
            max_seqs=pc.max_seqs,
            prefill_batch=pc.max_seqs if self.batched_prefill_ok else 1,
            prefix_cacher=self.prefix_cacher,
            lookahead=((pipeline.gamma + 1) * self.spec_rounds
                       if self.is_speculative else self.decode_steps),
            preempt_mode=(
                preempt_mode
                if getattr(pipeline, "cache", None) is not None
                and not self.is_speculative
                else "recompute"
            ),
        )
        if self.scheduler.preempt_mode == "swap":
            self.scheduler.swapper = self._swap_out_seq
        self.eos_token_ids = set(eos_token_ids)
        self.detokenizer = detokenizer
        # ref: engine-global seeded rng (engine/mod.rs:37 SEED=0)
        self.rng = np.random.default_rng(seed)
        self.prefill_chunk = pc.prefill_buckets[-1]
        self.max_model_len = pc.max_model_len
        self._groups: dict[str, SequenceGroup] = {}
        self._grammar_vocab = grammar_vocab
        self._tok_trie = None  # built on first constrained request
        # ref engine/mod.rs:39 TERMINATE_ALL_NEXT_STEP: cancel everything at
        # the top of the next scheduling step
        self.terminate_all_next_step = False
        # per-request cancellation (ref sampling.rs:86-97 dead-receiver
        # detection cancels a streaming seq); ids added from any thread,
        # applied at the top of the next step
        self._cancel_ids: set[str] = set()
        # opt-in per-step throughput log (ref engine/mod.rs:285-298 --throughput)
        self.throughput_logging = False
        self.last_throughput: dict | None = None
        # optional request/response JSONL log (ref lib.rs:415-453)
        self.request_log_file: str | None = None

    def _recognizer_for(self, constraint):
        if constraint is None or constraint.kind == "none":
            return None
        raise NotImplementedError("grammar-constrained decoding is not ported yet")

    # ------------------------------------------------------------- intake
    def add_request(self, req: GenerationRequest) -> SequenceGroup:
        """Raises only for what is not ported (a grammar constraint). Other
        intake failures (out-of-vocab ids, refused over-length prompts) come
        back as an already-finished group with finish_reason=error."""
        if req.constraint is not None and req.constraint.kind != "none":
            raise NotImplementedError("grammar-constrained decoding is not ported yet")
        rid = req.request_id or f"req-{int(time.time()*1e6)}"
        group = SequenceGroup(rid, req.sampling.n_choices)
        try:
            return self._add_request(req, rid, group)
        except Exception as e:  # noqa: BLE001 — engine thread must survive
            while len(group.seqs) < req.sampling.n_choices:
                seq = Sequence(list(req.prompt_tokens)[:8] or [0], req.sampling,
                               eos_token_ids=self.eos_token_ids,
                               max_model_len=self.max_model_len, group=group)
                group.add(seq)
            for seq in group.seqs:
                if not seq.is_finished():
                    seq.finish_error = f"{type(e).__name__}: {e}"
                    seq.finish(StopReason.ERROR)
                    if req.stream:
                        seq.stream = req.stream
                        req.stream(seq, "", StopReason.ERROR.value)
            self._groups[rid] = group
            self._log_event({"event": "request_rejected", "id": rid,
                             "reason": f"{type(e).__name__}: {e}"})
            return group

    def _add_request(self, req: GenerationRequest, rid: str,
                     group: SequenceGroup) -> SequenceGroup:
        vocab = getattr(getattr(self.pipeline, "cfg", None), "vocab_size", None)
        if vocab and req.prompt_tokens:
            lo, hi = min(req.prompt_tokens), max(req.prompt_tokens)
            if lo < 0 or hi >= vocab:
                # an out-of-range id would fault the device-side embedding gather
                raise ValueError(
                    f"prompt token id {lo if lo < 0 else hi} outside the "
                    f"model vocabulary [0, {vocab})")
        too_long = len(req.prompt_tokens) >= self.max_model_len
        if too_long and not self.truncate_sequence:
            # ref main.rs --truncate-sequence default: refuse over-length
            # prompts with an error response instead of silently truncating
            for _ in range(req.sampling.n_choices):
                seq = Sequence(list(req.prompt_tokens),
                               req.sampling, eos_token_ids=self.eos_token_ids,
                               max_model_len=len(req.prompt_tokens) + 1,
                               group=group)
                seq.finish_error = (
                    f"prompt ({len(req.prompt_tokens)} tokens) exceeds "
                    f"max_model_len ({self.max_model_len}) and "
                    "truncate_sequence is off")
                seq.finish(StopReason.ERROR)
                group.add(seq)
                if req.stream:
                    seq.stream = req.stream
                    req.stream(seq, "", StopReason.ERROR.value)
            self._groups[rid] = group
            self._log_event({"event": "request_refused", "id": rid,
                             "prompt_tokens": len(req.prompt_tokens),
                             "reason": "prompt exceeds max_model_len"})
            return group
        if too_long:
            # ref engine/mod.rs:537-561 truncation policy: keep the tail,
            # leaving room to generate
            keep = self.max_model_len - max(self.prefill_chunk // 4, 16)
            req.prompt_tokens = req.prompt_tokens[-keep:]
        # build the recognizer BEFORE any scheduler admission: a failure
        # (bad regex/grammar) must not leave earlier choices queued
        recognizers = [self._recognizer_for(req.constraint)
                       for _ in range(req.sampling.n_choices)]
        for recognizer in recognizers:
            seq = Sequence(
                req.prompt_tokens,
                req.sampling,
                eos_token_ids=self.eos_token_ids,
                max_model_len=self.max_model_len,
                detokenizer=self.detokenizer,
                return_logprobs=req.return_logprobs,
                group=group,
                recognizer=recognizer,
            )
            seq.stream = req.stream
            if req.images:
                seq.images = req.images
            group.add(seq)
            self.scheduler.add_seq(seq)
        self._groups[rid] = group
        self._log_event({"event": "request", "id": rid,
                         "prompt_tokens": len(req.prompt_tokens),
                         "n_choices": req.sampling.n_choices})
        return group

    def _log_event(self, obj: dict) -> None:
        if self.request_log_file:
            import json
            import time as _t

            obj["ts"] = _t.time()
            with open(self.request_log_file, "a") as f:
                f.write(json.dumps(obj) + "\n")

    # ------------------------------------------------------------- stepping
    @property
    def has_work(self) -> bool:
        return self.scheduler.num_unfinished > 0

    def cancel_request(self, request_id: str) -> None:
        """Thread-safe: cancel one request's sequences at the next step
        (ref dead-receiver detection, sampling.rs:86-97)."""
        self._cancel_ids.add(request_id)

    def _apply_cancellations(self) -> None:
        ids, self._cancel_ids = self._cancel_ids, set()
        for rid in ids:
            group = self._groups.get(rid)
            if group is None:
                continue
            for seq in group.seqs:
                if seq.is_finished():
                    continue
                self.scheduler.abort(seq)
                seq.swap_host = None
                seq.finish(StopReason.CANCELED)

    def step(self) -> None:
        if self._cancel_ids:
            self._apply_cancellations()
        if self.terminate_all_next_step:
            # ref TERMINATE_ALL_NEXT_STEP honored by both schedulers
            self.terminate_all_next_step = False
            self._cancel_all()
            return
        t0 = time.monotonic() if self.throughput_logging else 0.0
        out = self.scheduler.schedule()
        if out.copy_ops:
            self._execute_copies(out.copy_ops)
        for seq in out.swap_in:
            self._swap_in_seq(seq)
        n_prefill = n_decode = 0
        try:
            if out.prefill:
                before = sum(s.prefill_done_tokens for s in out.prefill)
                if len(out.prefill) > 1 and self.batched_prefill_ok:
                    self._prefill_batch(out.prefill)
                else:
                    for seq in out.prefill:
                        self._prefill_one(seq)
                n_prefill = sum(s.prefill_done_tokens for s in out.prefill) - before
            elif out.decode:
                before = sum(len(s.tokens) for s in out.decode)
                self._decode_batch(out.decode)
                n_decode = sum(len(s.tokens) for s in out.decode) - before
                self._release_window_pages(out.decode)
        except Exception as e:  # noqa: BLE001
            # ref handle_pipeline_forward_error! (pipeline/macros.rs, used at
            # engine/mod.rs:157-164): a forward error terminates the seqs in
            # this batch with an error response and the loop keeps serving
            self._fail_batch(list(out.prefill) + list(out.decode), e)
        self._finish_done()
        if self.throughput_logging and (n_prefill or n_decode):
            dt = max(time.monotonic() - t0, 1e-9)
            self.last_throughput = {
                "prompt_tok_s": n_prefill / dt if n_prefill else 0.0,
                "completion_tok_s": n_decode / dt if n_decode else 0.0,
            }

    def _swap_out_seq(self, seq: Sequence) -> None:
        """Swap preemption: copy the seq's live pages (every leaf, an int8
        pool's scales too) to host tensors, synchronously, before the
        scheduler frees them (ref cache_engine.rs swap_out)."""
        from mistralrs_tpu_torch.ops.paged_attention import swap_out_pages

        # save only pages holding data (up to kv_len); lookahead-reserved
        # pages past it are garbage and may exceed the re-admission table
        ps = self.pipeline.pc.page_size
        n_live = -(-seq.kv_len // ps)
        pages = seq.block_table[seq.released_pages : n_live]
        seq.swap_host = (seq.released_pages, swap_out_pages(self.pipeline.cache, pages))

    def _swap_in_seq(self, seq: Sequence) -> None:
        """Restore a re-admitted swapped seq's KV into its fresh pages, in
        place (ref cache_engine.rs swap_in); runs before this step's batch."""
        from mistralrs_tpu_torch.ops.paged_attention import swap_in_pages

        released, host = seq.swap_host
        # the fresh allocation may be larger than the saved span (the
        # next-token slot had not been appended when the seq was preempted)
        n_saved = host[0].shape[self.pipeline.cache.page_axis]
        dest = seq.block_table[released : released + n_saved]
        swap_in_pages(self.pipeline.cache, host, dest)
        seq.swap_host = None

    def _release_window_pages(self, seqs: list[Sequence]) -> None:
        """For all-layers-sliding-window models, hand whole pages strictly
        behind the window back to the pool (decode slices tables from the
        window base, so they are never read again) — the paged equivalent of
        the reference's sliding-window KV truncation (cache_manager.rs
        :101-154). Frees real capacity for long-running streams."""
        base_fn = getattr(self.pipeline, "_window_base_pages", None)
        if base_fn is None or not hasattr(self.block_manager, "release_prefix"):
            return
        for seq in seqs:
            base = base_fn(seq.kv_len)
            if base > seq.released_pages:
                self.block_manager.release_prefix(seq, base)

    def _fail_batch(self, seqs: list[Sequence], err: Exception) -> None:
        import logging

        logging.getLogger(__name__).error("pipeline step failed: %r", err)
        for seq in seqs:
            if seq.is_finished():
                continue
            seq.finish_error = f"{type(err).__name__}: {err}"
            seq.finish(StopReason.ERROR)
            stream = getattr(seq, "stream", None)
            if stream:
                stream(seq, "", StopReason.ERROR.value)

    def _cancel_all(self) -> None:
        from mistralrs_tpu_torch.engine.sequence import StopReason

        for seq in list(getattr(self.scheduler, "swapped", [])):
            seq.swap_host = None
            seq.finish(StopReason.CANCELED)
        getattr(self.scheduler, "swapped", deque()).clear()

        for seq in list(self.scheduler.running) + list(self.scheduler.waiting):
            if not seq.is_finished():
                seq.finish(StopReason.CANCELED)
                stream = getattr(seq, "stream", None)
                if stream:
                    stream(seq, "", StopReason.CANCELED.value)
        self.scheduler.waiting.clear()
        self._finish_done()

    def run_until_done(self) -> None:
        while self.has_work:
            self.step()

    # ------------------------------------------------------------- internals
    def _execute_copies(self, ops: list[tuple[int, int]]) -> None:
        """COW page copies (ref cache_engine.rs copy :205)."""
        if hasattr(self.pipeline, "apply_copies"):
            self.pipeline.apply_copies(ops)
            return
        from mistralrs_tpu_torch.ops.paged_attention import copy_pages

        self.pipeline.cache = copy_pages(
            self.pipeline.cache, [s for s, _ in ops], [d for _, d in ops]
        )

    @staticmethod
    def _greedy_ok(seq: Sequence) -> bool:
        """Eligible for the fused on-device argmax path (ref: argmax branch of
        sampler.rs sample(); penalties/bias/processors change the argmax, and
        logprob requests need the distribution)."""
        p = seq.sampling
        return (
            p.temperature is None
            and p.frequency_penalty is None
            and p.presence_penalty is None
            and not p.logits_bias
            and not p.logits_processors
            and not seq.return_logprobs
            and seq.recognizer is None
        )

    def _prefill_one(self, seq: Sequence) -> None:
        # prefill over *all* tokens so far: after preempt-by-recompute the
        # prompt includes previously generated tokens (ref scheduler.rs:292)
        target = len(seq.tokens)
        start = seq.prefill_done_tokens
        n = min(target - start, self.prefill_chunk)
        chunk = seq.tokens[start : start + n]
        greedy = self._greedy_ok(seq)
        out = self.pipeline.run_prefill_chunk(seq, chunk, greedy=greedy)
        if seq.prefill_done_tokens >= target:
            # final chunk: sample the next token
            if seq.prompt_timestamp is None:
                seq.prompt_timestamp = time.monotonic()
            seq.state = SequenceState.RUNNING_COMPLETION
            if greedy:
                self._emit_greedy([seq], out[:, None] if out.ndim == 1 else out)
            else:
                self._sample_and_emit([seq], out[None])

    def _prefill_batch(self, seqs: list[Sequence]) -> None:
        """Batched chunked prefill: one forward serves every scheduled
        prefilling sequence (amortizes the weight stream across prompts;
        ref: prompt batches in default_scheduler + make_prompt_chunk)."""
        items = []
        for seq in seqs:
            target = len(seq.tokens)
            start = seq.prefill_done_tokens
            m = min(target - start, self.prefill_chunk)
            items.append((seq, seq.tokens[start : start + m]))
        self.pipeline.run_prefill_chunks(items)
        pack = None
        for i, (seq, _chunk) in enumerate(items):
            if seq.prefill_done_tokens < len(seq.tokens):
                continue  # more chunks to go
            if seq.prompt_timestamp is None:
                seq.prompt_timestamp = time.monotonic()
            seq.state = SequenceState.RUNNING_COMPLETION
            if self._greedy_ok(seq):
                if pack is None:
                    pack = np.asarray(self.pipeline.last_greedy_pack)
                self._emit_greedy([seq], pack[:, i : i + 1])
            else:
                logits = self.pipeline.fetch_full_logits_row(i)
                self._sample_and_emit([seq], logits[None])

    def _decode_batch(self, seqs: list[Sequence]) -> None:
        if self.is_speculative:
            greedy = all(self._greedy_ok(s) for s in seqs)
            R = self.spec_rounds
            gate = getattr(self.pipeline, "spec_multi_ok", None)
            if (greedy and R > 1
                    and hasattr(self.pipeline, "run_spec_multi")
                    and (gate is None or gate(seqs))
                    and all(self._multi_ok(s, R * (self.pipeline.gamma + 1))
                            for s in seqs)):
                self._decode_spec_multi(seqs)
                return
            results = self.pipeline.speculative_step(seqs, self._seq_rng, greedy)
            for seq, lps in zip(seqs, results):
                for lp in lps:
                    if seq.is_finished():
                        break
                    self._postprocess_token(seq, lp)
            return
        T = self.decode_steps
        multi_ok = (
            T > 1
            and getattr(self.pipeline, "supports_multistep", False)
            and all(self._multi_ok(s, T) for s in seqs)
        )
        if all(self._greedy_ok(s) for s in seqs):
            if multi_ok:
                self._decode_multi(seqs, T)
                return
            pack = self.pipeline.run_decode(seqs, greedy=True)
            self._emit_greedy(seqs, pack)
        elif (multi_ok and getattr(self.pipeline, "supports_sampled_multistep", False)
              and all(self._multi_sampled_ok(s) for s in seqs)):
            self._decode_multi(seqs, T, sampled=True)
        elif self._topk_batch_ok(seqs):
            self._decode_topk(seqs)
        else:
            logits = self.pipeline.run_decode(seqs)
            self._sample_and_emit(seqs, logits)

    def _topk_batch_ok(self, seqs: list[Sequence]) -> bool:
        """Device top-K sampled decode: every row is either greedy-eligible
        or exactly samplable from the top-K pack (rare tail draws fall back
        to a full-logits fetch of that row)."""
        if not getattr(self.pipeline, "supports_topk_pack", False):
            return False
        from mistralrs_tpu_torch.engine.sampler import topk_eligible
        from mistralrs_tpu_torch.pipeline.text import TOPK_PACK

        return all(
            seq.recognizer is None
            and (self._greedy_ok(seq)
                 or topk_eligible(seq.sampler, seq.return_logprobs, TOPK_PACK))
            for seq in seqs
        )

    def _decode_topk(self, seqs: list[Sequence]) -> None:
        """Sampled decode from the device top-K pack: fetches [n,K] instead
        of [n,V] logits and skips the host softmax over the vocab."""
        from mistralrs_tpu_torch.engine.sampler import Logprobs, sample_from_topk

        tv, ti, m, z = self.pipeline.run_decode(seqs, mode="topk")
        for i, seq in enumerate(seqs):
            if self._greedy_ok(seq):
                lp = Logprobs(token=int(ti[i, 0]), logprob=float(tv[i, 0]))
            else:
                lp = sample_from_topk(
                    seq.sampler, tv[i], ti[i], float(m[i]), float(z[i]),
                    self._seq_rng(seq), seq.return_logprobs,
                )
                if lp is None:  # truncation set or draw beyond K: exact fallback
                    lp = seq.sampler.sample(
                        self.pipeline.fetch_full_logits_row(i), seq.tokens,
                        self._seq_rng(seq), seq.return_logprobs,
                    )
            self._postprocess_token(seq, lp)

    def _multi_ok(self, seq: Sequence, T: int) -> bool:
        """All T writes must land inside the seq's block table span."""
        phys = self.pipeline.max_pages_per_seq * self.pipeline.pc.page_size
        return seq.kv_len + T <= phys and len(seq.block_table) * self.pipeline.pc.page_size >= seq.kv_len + T

    def _multi_sampled_ok(self, seq: Sequence) -> bool:
        """Eligible for the on-device sampled multistep loop: temperature +
        top-k/top-p/min-p only (no penalties/bias/processors — those need
        host context), no logprob request, no grammar, and an explicit top_k
        that fits inside the device pack (makes device truncation exact)."""
        from mistralrs_tpu_torch.pipeline.text import TOPK_PACK

        if self._greedy_ok(seq):
            return True  # rides along as (temp=1, k=1)
        p = seq.sampling
        return (
            p.seed is None  # per-request rng incompatible with the shared key
            and p.temperature is not None
            and p.frequency_penalty is None
            and p.presence_penalty is None
            and not p.logits_bias
            and not p.logits_processors
            and not seq.return_logprobs
            and seq.recognizer is None
            and p.top_k is not None
            and 0 < p.top_k <= TOPK_PACK
        )

    def _decode_multi(self, seqs: list[Sequence], T: int, sampled: bool = False) -> None:
        """Multi-token decode: one dispatch emits up to T tokens per
        sequence; overshoot past stop conditions is discarded with a kv_len
        counter rewind (same trick as speculative rollback). With
        sampled=True the sampling (temp/top-k/top-p/min-p + the draw) runs
        on device (pipeline multistep sampled=True); greedy rows ride along
        and keep reporting the raw argmax logit."""
        from mistralrs_tpu_torch.engine.sampler import Logprobs

        if sampled:
            sampling = (
                [s.sampling.temperature if not self._greedy_ok(s) else 1.0
                 for s in seqs],
                [s.sampling.top_k if not self._greedy_ok(s) else 1 for s in seqs],
                [(s.sampling.top_p if s.sampling.top_p is not None else 1.0)
                 if not self._greedy_ok(s) else 1.0 for s in seqs],
                [(s.sampling.min_p if s.sampling.min_p is not None else 0.0)
                 if not self._greedy_ok(s) else 0.0 for s in seqs],
                int(self.rng.integers(2**31)),
            )
        else:
            sampling = None
        pack = self.pipeline.run_decode_multi(seqs, sampling)  # [3, T, n]
        for i, seq in enumerate(seqs):
            val_row = 1 if (not sampled or self._greedy_ok(seq)) else 2
            start_kv = seq.kv_len - T
            taken = 0
            for t in range(T):
                if seq.is_finished():
                    break
                lp = Logprobs(token=int(pack[0, t, i]),
                              logprob=float(pack[val_row, t, i]))
                self._postprocess_token(seq, lp)
                taken += 1
            seq.kv_len = start_kv + taken

    def _decode_spec_multi(self, seqs: list[Sequence]) -> None:
        """Greedy speculative decode, `spec_rounds` rounds in ONE dispatch
        (PromptLookupPipeline.run_spec_multi). Each round emits 1..gamma+1
        tokens; overshoot past stop conditions is discarded and kv_len
        advances by exactly the consumed count (counter-rewind rollback,
        same as _decode_multi)."""
        from mistralrs_tpu_torch.engine.sampler import Logprobs

        g = self.pipeline.gamma
        Wv = g + 1
        pack = self.pipeline.run_spec_multi(seqs)  # [R, n, 2*Wv+2(+1)]
        R = pack.shape[0]
        # model-draft loops append a draft_kv column (absolute); PLD has none
        has_dkv = pack.shape[2] > 2 * Wv + 2
        for i, seq in enumerate(seqs):
            consumed = 0
            for r in range(R):
                if seq.is_finished():
                    break
                count = int(pack[r, i, 2 * Wv])
                seq.spec_proposed += int(pack[r, i, 2 * Wv + 1])
                seq.spec_accepted += count - 1
                if has_dkv:
                    seq.draft_kv_len = int(pack[r, i, 2 * Wv + 2])
                for t in range(count):
                    if seq.is_finished():
                        break
                    lp = Logprobs(token=int(pack[r, i, t]),
                                  logprob=float(pack[r, i, Wv + t]))
                    self._postprocess_token(seq, lp)
                    consumed += 1
            seq.kv_len += consumed
            if has_dkv:
                # a stop-condition truncation leaves draft_kv ahead of the
                # tokens actually kept; clamp so the invariant dkv <= len-1
                # holds (the seq is finished in that case anyway)
                seq.draft_kv_len = min(seq.draft_kv_len, len(seq.tokens) - 1)

    def _emit_greedy(self, seqs: list[Sequence], pack: np.ndarray) -> None:
        from mistralrs_tpu_torch.engine.sampler import Logprobs

        for i, seq in enumerate(seqs):
            lp = Logprobs(token=int(pack[0, i]), logprob=float(pack[1, i]))
            self._postprocess_token(seq, lp)

    def _seq_rng(self, seq: Sequence):
        # per-request seeded rng (OpenAI seed) or the engine-global one; the
        # stream is shared across a group's n choices (one seeded stream per
        # REQUEST, so seeded n>1 still yields distinct choices)
        if seq.sampling.seed is None:
            return self.rng
        holder = seq.group if seq.group is not None else seq
        if getattr(holder, '_rng', None) is None:
            holder._rng = np.random.default_rng(seq.sampling.seed)
        return holder._rng

    def _sample_and_emit(self, seqs: list[Sequence], logits: np.ndarray) -> None:
        results = [
            s.sampler.sample(logits[i], s.tokens, self._seq_rng(s),
                             s.return_logprobs)
            for i, s in enumerate(seqs)
        ]
        for i, (seq, lp) in enumerate(zip(seqs, results)):
            if seq.recognizer is not None:
                lp = self._constrain_token(seq, logits[i], lp)
            self._postprocess_token(seq, lp)

    def _constrain_token(self, seq: Sequence, logits: np.ndarray, lp):
        """Constrained second sampling pass (ref sampling.rs:314-354): keep
        the sampled token if the grammar allows it, else mask and resample."""
        rec = seq.recognizer
        if lp.token in self.eos_token_ids and rec.eos_allowed:
            return lp
        if rec.allowed(lp.token):
            rec.advance(lp.token)
            return lp
        mask = rec.mask()
        biased = np.where(mask, logits.astype(np.float32), -np.inf)
        if rec.eos_allowed:
            for t in self.eos_token_ids:
                if 0 <= t < biased.shape[-1]:
                    biased[t] = logits[t]
        elif not mask.any():
            # grammar dead-end: terminate the sequence (ref recognizer error)
            eos = min(self.eos_token_ids) if self.eos_token_ids else 0
            from mistralrs_tpu_torch.engine.sampler import Logprobs

            seq.finish_error = "grammar dead-end: no token allowed"
            return Logprobs(token=eos, logprob=float("-inf"))
        lp2 = seq.sampler.sample(biased, seq.tokens, self._seq_rng(seq),
                                 seq.return_logprobs)
        if not (lp2.token in self.eos_token_ids and rec.eos_allowed):
            rec.advance(lp2.token)
        return lp2

    def _postprocess_token(self, seq: Sequence, lp) -> None:
        seq.add_token(lp)
        reason = seq.check_done()
        stream = getattr(seq, "stream", None)
        if reason is not None:
            seq.finish(reason)
            if seq.group is not None:
                self._log_event({"event": "response", "id": seq.group.request_id,
                                 "completion_tokens": seq.num_generated,
                                 "finish_reason": reason.value})
            if stream:
                stream(seq, seq.get_delta(), reason.value)
        elif stream:
            # ref sampling.rs:31 STREAMING_RATE_LIMIT=3: emit every 3rd
            # token (get_delta accumulates the text in between)
            if len(seq.tokens) % 3 == 0:
                delta = seq.get_delta()
                if delta:
                    stream(seq, delta, None)

    def _finish_done(self) -> None:
        self.scheduler.free_finished()

    # ------------------------------------------------------------- sync api
    def generate(
        self, prompt_tokens: list[int], sampling: SamplingParams | None = None
    ) -> tuple[list[int], str]:
        """Blocking single-prompt helper (tests / simple API)."""
        group = self.add_request(
            GenerationRequest(prompt_tokens, sampling or SamplingParams())
        )
        while not group.all_done():
            self.step()
        seq = group.seqs[0]
        return seq.generated_tokens, seq.final_text()
