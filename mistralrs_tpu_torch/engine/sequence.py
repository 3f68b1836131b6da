"""Per-request generation state.

Reference parity: mistralrs-core/src/sequence.rs — `Sequence` (:146-196),
`SequenceState` (:52-64), `StopReason` (:28-39), UTF-8-safe streaming delta
(`get_delta` :591), stop-condition evaluation (`is_done` :532), logical
block bookkeeping for the paged backend (`blocks_to_add_new_tok` :199),
and `SequenceGroup` (:683-817) gating multi-choice responses.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Callable

from mistralrs_tpu_torch.engine.sampler import Logprobs, Sampler, SamplingParams


class SequenceState(enum.Enum):
    WAITING = "waiting"
    RUNNING_PREFILL = "running_prefill"
    RUNNING_COMPLETION = "running_completion"
    SWAPPED_OUT = "swapped_out"
    DONE = "done"
    ERROR = "error"


class StopReason(enum.Enum):
    EOS = "stop"  # eos token
    STOP_TOKEN = "stop"  # matched stop token id
    STOP_STRING = "stop"  # matched stop string
    LENGTH = "length"  # hit max_len / model limit
    CANCELED = "canceled"
    ERROR = "error"  # pipeline forward error (ref handle_pipeline_forward_error!)


@dataclasses.dataclass
class SequenceOutput:
    """One finished choice."""

    text: str
    tokens: list[int]
    finish_reason: str
    logprobs: list[Logprobs] | None = None


class Sequence:
    """One generation stream (a request with n_choices makes n Sequences)."""

    _next_id = 0

    def __init__(
        self,
        prompt_tokens: list[int],
        sampling: SamplingParams,
        *,
        eos_token_ids: set[int] = frozenset(),
        max_model_len: int = 4096,
        detokenizer: Callable[[list[int]], str] | None = None,
        return_logprobs: bool = False,
        group: "SequenceGroup | None" = None,
        recognizer: Any | None = None,
        suffix_prompt_tokens: list[int] | None = None,
    ):
        self.id = Sequence._next_id
        Sequence._next_id += 1
        self.prompt_tokens = list(prompt_tokens)
        self.tokens: list[int] = list(prompt_tokens)
        self.logprobs: list[Logprobs] = []
        self.sampling = sampling
        self.sampler = Sampler(sampling)
        self.eos_token_ids = set(eos_token_ids)
        self.max_model_len = max_model_len
        self.return_logprobs = return_logprobs
        self.state = SequenceState.WAITING
        self.stop_reason: StopReason | None = None
        self.finish_error: str | None = None  # error detail when stop=ERROR
        # whole pages handed back early (sliding-window release); entries
        # [0, released_pages) of block_table are stale placeholders
        self.released_pages = 0
        # (released_pages_at_swap, (host_k, host_v)) while state == SWAPPED
        self.swap_host = None
        self.group = group
        self.recognizer = recognizer  # grammar recognizer state (aici port)
        self.suffix_prompt_tokens = suffix_prompt_tokens or []

        self._detok = detokenizer
        self._streamed_text = ""  # text already emitted
        self._decoded_upto = len(prompt_tokens)
        # scheduling info
        self.prefill_done_tokens = 0  # how many prompt tokens already prefilled
        self.slot: int | None = None  # decode batch slot while running
        self.block_table: list[int] = []  # physical page ids (paged backend)
        self.timestamp = time.monotonic()
        self.prompt_timestamp: float | None = None
        self.completion_timestamp: float | None = None
        # valid kv entries currently in cache (target model)
        self.kv_len = 0
        # speculative decoding bookkeeping: valid kv entries in the draft
        # model's cache (ref sequence.rs draft caches; rollback = counter
        # rewind with paged KV, SURVEY.md §7 hard part 5)
        self.draft_kv_len = 0
        self.spec_proposed = 0  # draft tokens proposed
        self.spec_accepted = 0  # draft tokens accepted by the target

    # ------------------------------------------------------------- properties
    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)

    @property
    def generated_tokens(self) -> list[int]:
        return self.tokens[self.prompt_len :]

    @property
    def num_generated(self) -> int:
        return len(self.tokens) - self.prompt_len

    def is_finished(self) -> bool:
        return self.state in (SequenceState.DONE, SequenceState.ERROR)

    # ------------------------------------------------------------- generation
    def add_token(self, lp: Logprobs) -> None:
        self.tokens.append(lp.token)
        self.logprobs.append(lp)

    def check_done(self) -> StopReason | None:
        """Evaluate stop conditions after a new token (ref is_done :532)."""
        p = self.sampling
        tok = self.tokens[-1]
        if tok in self.eos_token_ids:
            return StopReason.EOS
        if tok in p.stop_token_ids:
            return StopReason.STOP_TOKEN
        if p.max_len is not None and self.num_generated >= p.max_len:
            return StopReason.LENGTH
        if len(self.tokens) >= self.max_model_len:
            return StopReason.LENGTH
        if p.stop_strings and self._detok:
            text = self._detok(self.generated_tokens)
            for s in p.stop_strings:
                if s in text:
                    return StopReason.STOP_STRING
        return None

    def finish(self, reason: StopReason) -> None:
        self.stop_reason = reason
        self.state = SequenceState.DONE
        self.completion_timestamp = time.monotonic()

    # ------------------------------------------------------------- streaming
    def get_delta(self) -> str:
        """New text since last call, holding back bytes that end mid-UTF-8 /
        mid-token (ref get_delta :591 uses a byte buffer; tokenizers'
        incremental decode achieves the same by only emitting once the
        decoded string stops changing retroactively)."""
        if self._detok is None:
            return ""
        full = self._detok(self.generated_tokens)
        if full.endswith("�"):  # incomplete utf-8 at the boundary
            return ""
        delta = full[len(self._streamed_text) :]
        self._streamed_text = full
        return delta

    def final_text(self) -> str:
        if self._detok is None:
            return ""
        text = self._detok(self.generated_tokens)
        # trim matched stop string (reference keeps text up to the match)
        for s in self.sampling.stop_strings:
            idx = text.find(s)
            if idx >= 0:
                text = text[:idx]
        return text

    def output(self) -> SequenceOutput:
        reason = self.stop_reason.value if self.stop_reason else "stop"
        text = self.final_text()
        if self.finish_error and reason == "error":
            text = text or f"[error] {self.finish_error}"
        return SequenceOutput(
            text=text,
            tokens=self.generated_tokens,
            finish_reason=reason,
            logprobs=self.logprobs if self.return_logprobs else None,
        )


@dataclasses.dataclass
class Usage:
    """Ref: response.rs Usage + sequence.rs get_usage (:735)."""

    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0
    avg_prompt_tok_per_sec: float = 0.0
    avg_compl_tok_per_sec: float = 0.0


class SequenceGroup:
    """The n_choices sequences of one request; response fires when all done
    (ref SequenceGroup :683-817)."""

    def __init__(self, request_id: str, n_choices: int):
        self.request_id = request_id
        self.n_choices = n_choices
        self.seqs: list[Sequence] = []
        self.created = time.time()

    def add(self, seq: Sequence) -> None:
        seq.group = self
        self.seqs.append(seq)

    def all_done(self) -> bool:
        return all(s.is_finished() for s in self.seqs)

    def usage(self) -> Usage:
        u = Usage()
        prompt_time = 0.0
        compl_time = 0.0
        for s in self.seqs:
            u.prompt_tokens += s.prompt_len
            u.completion_tokens += s.num_generated
            if s.prompt_timestamp:
                prompt_time += max(s.prompt_timestamp - s.timestamp, 1e-6)
            if s.completion_timestamp and s.prompt_timestamp:
                compl_time += max(s.completion_timestamp - s.prompt_timestamp, 1e-6)
        u.total_tokens = u.prompt_tokens + u.completion_tokens
        if prompt_time > 0:
            u.avg_prompt_tok_per_sec = u.prompt_tokens / prompt_time
        if compl_time > 0:
            u.avg_compl_tok_per_sec = u.completion_tokens / compl_time
        return u
