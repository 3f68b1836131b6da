"""Continuous-batching scheduler over the paged KV cache.

Reference parity: mistralrs-core/src/paged_attention/scheduler.rs
`PagedAttentionScheduler::schedule` (:66-213) — FCFS waiting queue, admission
gated on page availability (`AllocStatus`), prompt-priority scheduling,
preemption by recompute (:292) when decode appends outrun free pages; and the
DefaultScheduler's `max_seqs` cap (default_scheduler.rs:15-329).

TPU twist: the decode batch is a fixed-width slot array (static jit shape);
prompt chunks are bucketed lengths (pipeline handles bucketing). The
scheduler only decides *which* sequences run; array building happens in the
pipeline.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from mistralrs_tpu_torch.engine.block_manager import AllocStatus, BlockManager
from mistralrs_tpu_torch.engine.sequence import Sequence, SequenceState, StopReason


@dataclasses.dataclass
class SchedulerOutput:
    # at most one of prefill/decode is non-empty per step (prompt-priority,
    # like the reference)
    prefill: list[Sequence]
    decode: list[Sequence]
    preempted: list[Sequence]
    copy_ops: list[tuple[int, int]]  # COW page copies to execute before step
    # swap-preempted seqs re-admitted this step: the engine must write their
    # host KV back into the freshly allocated pages before running the batch
    # (ref scheduler.rs blocks_to_swap_in + cache_engine swap_in)
    swap_in: list[Sequence] = dataclasses.field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return not self.prefill and not self.decode


class Scheduler:
    def __init__(self, block_manager: BlockManager, max_seqs: int = 16,
                 prefill_batch: int = 1, prefix_cacher=None, lookahead: int = 1,
                 preempt_mode: str = "recompute"):
        self.bm = block_manager
        self.max_seqs = max_seqs
        self.prefill_batch = prefill_batch
        self.prefix_cacher = prefix_cacher  # PrefixCacheManager | None
        # tokens reserved per decode step (>1 for speculative draft spans)
        self.lookahead = lookahead
        self.waiting: deque[Sequence] = deque()
        self.running: list[Sequence] = []
        # fairness: alternate prompt and completion batches when both are
        # runnable (ref runs one of each per loop pass, engine/mod.rs)
        self._decode_turn = False
        # "recompute" (default; what the reference actually runs) or "swap":
        # offload preempted seqs' KV pages to host and restore on re-admission
        # (ref scheduler.rs swapped_out queue + cache_engine swap kernels)
        assert preempt_mode in ("recompute", "swap")
        self.preempt_mode = preempt_mode
        self.swapped: deque[Sequence] = deque()
        # engine-installed callback copying a seq's pages to host (device op)
        self.swapper = None

    # ------------------------------------------------------------- intake
    def add_seq(self, seq: Sequence) -> None:
        seq.state = SequenceState.WAITING
        self.waiting.append(seq)

    def abort(self, seq: Sequence) -> None:
        if seq in self.running:
            self.running.remove(seq)
            self.bm.free_sequence(seq)
        for q in (self.waiting, self.swapped):
            try:
                q.remove(seq)
            except ValueError:
                pass

    @property
    def num_unfinished(self) -> int:
        return len(self.waiting) + len(self.running) + len(self.swapped)

    # ------------------------------------------------------------- schedule
    def schedule(self) -> SchedulerOutput:
        preempted: list[Sequence] = []
        copy_ops: list[tuple[int, int]] = []

        # 1. mid-prefill sequences continue first (they hold pages already) —
        # but alternate with decode when both are runnable, so live streams
        # keep emitting tokens during a long multi-chunk prefill (the
        # reference runs one completion batch AND one prompt batch per loop
        # pass, engine/mod.rs:145-155 + :310)
        prefilling = [s for s in self.running if s.state == SequenceState.RUNNING_PREFILL]
        decodable = any(
            s.state == SequenceState.RUNNING_COMPLETION and not s.is_finished()
            for s in self.running
        )
        decode_turn = self._decode_turn and decodable
        if prefilling and not decode_turn:
            self._decode_turn = True
            return SchedulerOutput(prefilling[: self.prefill_batch], [], [], [])

        # 2a. swapped-out sequences re-admit with priority (ref :168-175);
        # the engine restores their host KV before this step's batch runs
        swap_in: list[Sequence] = []
        while self.swapped and len(self.running) < self.max_seqs:
            status = self.bm.can_allocate(self.swapped[0])
            if status == AllocStatus.IMPOSSIBLE:
                seq = self.swapped.popleft()
                seq.finish_error = "swapped sequence no longer fits KV pool"
                seq.finish(StopReason.ERROR)
                stream = getattr(seq, "stream", None)
                if stream:
                    stream(seq, "", StopReason.ERROR.value)
                continue
            if status != AllocStatus.OK:
                break
            seq = self.swapped.popleft()
            # full fresh table; any window-released prefix is re-released by
            # the engine's post-decode hook (stale prefix pages are never
            # attended thanks to the windowed table slicing)
            self.bm.allocate(seq)
            seq.state = SequenceState.RUNNING_COMPLETION
            self.running.append(seq)
            swap_in.append(seq)

        # 2b. admit waiting sequences (prompt priority, FCFS; ref :72-107)
        admitted: list[Sequence] = []
        while (not decode_turn and self.waiting
               and len(self.running) + len(admitted) < self.max_seqs):
            seq = self.waiting[0]
            # prefix-cache hit: attach shared pages, skip their prefill
            # (ref engine/mod.rs:562 -> prefix_cacher.rs:163)
            if self.prefix_cacher is not None and not seq.block_table and seq.kv_len == 0:
                matched, pages = self.prefix_cacher.match(seq.tokens)
                if matched:
                    self.bm.share_prefix(seq, pages)
                    seq.kv_len = seq.prefill_done_tokens = matched
            status = self.bm.can_allocate(seq)
            if status == AllocStatus.LATER and self.prefix_cacher is not None:
                # reclaim cold cached prefixes before giving up (ref evict :91)
                need = self.bm.pages_needed(len(seq.tokens)) - len(seq.block_table)
                if self.prefix_cacher.evict(need - self.bm.num_free + self.bm.watermark_pages):
                    status = self.bm.can_allocate(seq)
            if status == AllocStatus.IMPOSSIBLE:
                self.waiting.popleft()
                seq.finish_error = "prompt longer than KV pool"
                seq.finish(StopReason.ERROR)  # finish_reason="error" + stream
                stream = getattr(seq, "stream", None)
                if stream:
                    stream(seq, "", StopReason.ERROR.value)
                continue
            if status == AllocStatus.LATER:
                break
            self.waiting.popleft()
            self.bm.allocate(seq)
            seq.state = SequenceState.RUNNING_PREFILL
            admitted.append(seq)
            if len(admitted) >= self.prefill_batch:
                break
        if admitted:
            self.running.extend(admitted)
            self._decode_turn = True
            return SchedulerOutput(admitted[: self.prefill_batch], [], [], [],
                                   swap_in=swap_in)
        self._decode_turn = False

        # 3. decode step: ensure every decoding seq can take one more token,
        #    preempting latest-arrived on pressure (ref :135-165, :292).
        #    Mid-prefill seqs are NOT decodable (they take the prompt turn of
        #    the prompt/completion alternation above).
        self.running.sort(key=lambda s: s.timestamp)
        # freshly re-admitted swap_in seqs decode from NEXT step (the engine
        # restores their host KV after this schedule() returns); they are
        # neither schedulable nor preemption victims right now
        fresh = set(swap_in)
        candidates = [
            s for s in self.running
            if not s.is_finished() and s not in fresh
        ]
        live = [
            s for s in candidates
            if s.state == SequenceState.RUNNING_COMPLETION
        ]
        scheduled: list[Sequence] = []
        for seq in live:
            if seq in preempted:
                continue
            while not self.bm.can_append_token(seq, self.lookahead):
                if self.prefix_cacher is not None and self.prefix_cacher.evict(1):
                    continue
                # victim: latest-arrived decoding seq first; mid-prefill seqs
                # only as a last resort (preempting one every page boundary
                # would re-run its prefill chunks from scratch each cycle)
                victim = None
                for pool in (live, candidates):
                    for cand in reversed(pool):
                        if (cand is not seq and cand not in preempted
                                and cand not in scheduled):
                            victim = cand
                            break
                    if victim is not None:
                        break
                if victim is None:
                    victim = seq
                self._preempt(victim, preempted)
                if victim is seq:
                    break
            else:
                cow = self.bm.append_slot(seq, self.lookahead)
                if cow is not None:
                    copy_ops.append(cow)
                scheduled.append(seq)
        for s in preempted:
            self.running.remove(s)
        return SchedulerOutput([], scheduled, preempted, copy_ops,
                               swap_in=swap_in)

    def _preempt(self, seq: Sequence, preempted: list[Sequence]) -> None:
        """Preempt a sequence: swap its KV to host when preempt_mode="swap"
        (decoding seqs only — mid-prefill work is cheaper to recompute),
        else drop pages and requeue for recompute (ref :292; the reference
        also ships the swap path but runs recompute by default)."""
        if (self.preempt_mode == "swap" and self.swapper is not None
                and seq.state == SequenceState.RUNNING_COMPLETION):
            self.swapper(seq)  # device->host copy, stores seq.swap_host
            self.bm.free_sequence(seq)
            seq.state = SequenceState.SWAPPED_OUT
            preempted.append(seq)
            self.swapped.append(seq)
            return
        self.bm.free_sequence(seq)
        seq.kv_len = 0
        seq.draft_kv_len = 0
        seq.prefill_done_tokens = 0
        seq.state = SequenceState.WAITING
        preempted.append(seq)
        self.waiting.appendleft(seq)

    def free_finished(self) -> list[Sequence]:
        done = [s for s in self.running if s.is_finished()]
        for s in done:
            # retain the finished sequence's full pages as a cached prefix
            # (ref sampling.rs finish path -> prefix_cacher.add_sequence :58)
            if (self.prefix_cacher is not None
                    and s.stop_reason is not StopReason.ERROR
                    and s.released_pages == 0):
                # errored seqs may hold partially-written KV pages; window-
                # released seqs have freed part of their prefix
                self.prefix_cacher.insert(s.tokens, s.block_table, s.kv_len)
            self.bm.free_sequence(s)
            self.running.remove(s)
        return done
