"""Token sampler with reference-exact semantics.

Reference parity: mistralrs-core/src/sampler.rs — pipeline order
(`Sampler::sample` :401-455): penalties -> custom logits processors ->
(argmax if no temperature) -> temperature -> softmax -> top-k -> top-p ->
min-p -> multinomial over the *unnormalized* clamped probs
(`sample_top_kp_min_p` :309-372); frequency/presence penalties count over the
full context (`apply_penalties` :374-399); logprob is log10 of the selected
prob; top-n logprobs from the sorted distribution.

Host-side numpy implementation — exact, deterministic (single engine-owned
Generator mirroring the reference's engine-global Isaac64 seeded rng,
engine/mod.rs:37,98). The greedy path is also available on device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np

# custom logits processor: (logits, context_tokens) -> logits
LogitsProcessor = Callable[[np.ndarray, Sequence[int]], np.ndarray]


@dataclasses.dataclass
class SamplingParams:
    """Ref: sampler.rs SamplingParams (:27-56)."""

    temperature: float | None = None
    top_k: int | None = None
    top_p: float | None = None
    min_p: float | None = None
    top_n_logprobs: int = 0
    frequency_penalty: float | None = None
    presence_penalty: float | None = None
    stop_strings: list[str] = dataclasses.field(default_factory=list)
    stop_token_ids: list[int] = dataclasses.field(default_factory=list)
    max_len: int | None = None
    logits_bias: dict[int, float] | None = None
    n_choices: int = 1
    logits_processors: list[LogitsProcessor] = dataclasses.field(default_factory=list)
    # per-request RNG seed (OpenAI `seed`); None = the engine-global stream
    # (ref engine/mod.rs:37 SEED=0 engine rng)
    seed: int | None = None

    def __post_init__(self):
        # ref Sampler::new: temperature < 1e-7 means argmax
        if self.temperature is not None and self.temperature < 1e-7:
            self.temperature = None


@dataclasses.dataclass
class TopLogprob:
    token: int
    logprob: float
    bytes: str | None = None


@dataclasses.dataclass
class Logprobs:
    token: int
    logprob: float
    bytes: str | None = None
    top_logprobs: list[TopLogprob] | None = None


class Sampler:
    """Per-sequence sampler instance (ref builds one per Sequence)."""

    def __init__(self, params: SamplingParams):
        self.p = params

    def _apply_penalties(self, logits: np.ndarray, context: Sequence[int]) -> np.ndarray:
        p = self.p
        if p.frequency_penalty is None and p.presence_penalty is None:
            return logits
        freq = p.frequency_penalty or 0.0
        pres = p.presence_penalty or 0.0
        counts = np.bincount(
            np.asarray(context, dtype=np.int64), minlength=logits.shape[-1]
        ).astype(np.float32)[: logits.shape[-1]]
        return logits - counts * freq - (counts > 0).astype(np.float32) * pres

    def _processors(self, logits: np.ndarray, context: Sequence[int]) -> np.ndarray:
        p = self.p
        if p.logits_bias:
            logits = logits.copy()
            for tok, bias in p.logits_bias.items():
                if 0 <= tok < logits.shape[-1]:
                    logits[tok] += bias
        for proc in p.logits_processors:
            logits = proc(logits, context)
        return logits

    def sample(
        self,
        logits: np.ndarray,  # [V] float32
        context: Sequence[int],
        rng: np.random.Generator,
        return_logprobs: bool = False,
    ) -> Logprobs:
        p = self.p
        logits = self._apply_penalties(logits.astype(np.float32), context)
        logits = self._processors(logits, context)

        if p.temperature is None:
            tok = int(np.argmax(logits))
            # ref sample_argmax: logprob is the raw logit value of the token
            return Logprobs(token=tok, logprob=float(logits[tok]),
                            top_logprobs=self._top_from(logits) if return_logprobs else None)

        x = logits / p.temperature
        x = x - x.max()
        probs = np.exp(x)
        probs /= probs.sum()

        order = np.argsort(-probs, kind="stable")
        top_k = p.top_k if p.top_k and p.top_k > 0 else 0
        if top_k > 0 and top_k < probs.shape[-1]:
            probs[order[top_k:]] = 0.0
        top_p = p.top_p if p.top_p is not None else 1.0
        if 0.0 < top_p < 1.0:
            # ref: keep tokens until cumsum >= top_p, zero the rest
            cums = np.cumsum(probs[order])
            cut = cums - probs[order] >= top_p  # cumsum *before* adding this token
            probs[order[cut]] = 0.0
            min_p = p.min_p if p.min_p is not None else 0.0
            if 0.0 < min_p < 1.0:
                max_p = probs[order[0]]
                probs[probs <= max_p * min_p] = 0.0

        total = probs.sum()
        if total <= 0:  # degenerate: fall back to best token
            tok = int(order[0])
            return Logprobs(token=tok, logprob=0.0,
                            top_logprobs=self._top_from_probs(probs, order) if return_logprobs else None)
        tok = int(rng.choice(probs.shape[-1], p=probs / total))
        # ref sample_multinomial: log10 of the (unnormalized) clamped prob
        lp = float(np.log10(probs[tok])) if probs[tok] > 0 else float("-inf")
        return Logprobs(
            token=tok, logprob=lp,
            top_logprobs=self._top_from_probs(probs, order) if return_logprobs else None,
        )

    def probs(self, logits: np.ndarray, context: Sequence[int]) -> np.ndarray | None:
        """Normalized distribution after the full processing pipeline
        (penalties -> processors -> temperature -> softmax -> top-k/p/min-p),
        for speculative rejection sampling (ref speculative.rs :471-487 +
        sampler.rs sample_speculative). Returns None on the argmax path."""
        p = self.p
        if p.temperature is None:
            return None
        logits = self._apply_penalties(logits.astype(np.float32), context)
        logits = self._processors(logits, context)
        x = logits / p.temperature
        x = x - x.max()
        probs = np.exp(x)
        probs /= probs.sum()
        order = np.argsort(-probs, kind="stable")
        top_k = p.top_k if p.top_k and p.top_k > 0 else 0
        if top_k > 0 and top_k < probs.shape[-1]:
            probs[order[top_k:]] = 0.0
        top_p = p.top_p if p.top_p is not None else 1.0
        if 0.0 < top_p < 1.0:
            cums = np.cumsum(probs[order])
            cut = cums - probs[order] >= top_p
            probs[order[cut]] = 0.0
            min_p = p.min_p if p.min_p is not None else 0.0
            if 0.0 < min_p < 1.0:
                max_p = probs[order[0]]
                probs[probs <= max_p * min_p] = 0.0
        total = probs.sum()
        if total <= 0:
            probs[:] = 0.0
            probs[order[0]] = 1.0
            return probs
        return probs / total

    def _top_from(self, logits: np.ndarray) -> list[TopLogprob]:
        n = self.p.top_n_logprobs
        if n <= 0:
            return []
        order = np.argsort(-logits, kind="stable")[:n]
        return [TopLogprob(int(t), float(logits[t])) for t in order]

    def _top_from_probs(self, probs: np.ndarray, order: np.ndarray) -> list[TopLogprob]:
        n = self.p.top_n_logprobs
        if n <= 0:
            return []
        sel = order[:n]
        out = []
        for t in sel:
            pv = probs[t]
            out.append(TopLogprob(int(t), float(np.log10(pv)) if pv > 0 else float("-inf")))
        return out


def topk_eligible(sampler: "Sampler", return_logprobs: bool, k: int) -> bool:
    """Can this sequence sample exactly from the device top-K pack?
    Penalties / bias / custom processors perturb arbitrary logits (need the
    full vector); top-n logprobs must fit in K."""
    p = sampler.p
    if p.temperature is None:
        return False  # argmax path handles it
    if p.frequency_penalty is not None or p.presence_penalty is not None:
        return False
    if p.logits_bias or p.logits_processors:
        return False
    if return_logprobs and p.top_n_logprobs > k:
        return False
    return True


def sample_from_topk(
    sampler: "Sampler",
    tv: np.ndarray,  # [K] tempered logits of the top-K candidates (desc)
    ti: np.ndarray,  # [K] their token ids
    m: float,  # max over the full tempered vocab
    z: float,  # sum(exp(y - m)) over the full vocab
    rng: np.random.Generator,
    return_logprobs: bool = False,
) -> "Logprobs | None":
    """Reference-exact sampling restricted to the device top-K pack.

    probs are exact (the softmax normalizer covers the FULL vocab); whenever
    the reference pipeline's truncation set could extend beyond K — top-p /
    min-p cutoffs not reached inside K, or the multinomial draw landing in
    the tail mass — returns None and the caller falls back to full logits.
    """
    p = sampler.p
    k = tv.shape[0]
    probs = np.exp(tv.astype(np.float64) - m) / z  # [K] exact, descending
    cum_k = float(probs.sum())

    top_k = p.top_k if p.top_k and p.top_k > 0 else 0
    if top_k and top_k < k:
        probs = probs[:top_k].copy()
    elif top_k == 0 or top_k >= k:
        # no top-k truncation inside K: the tail may carry real mass
        probs = probs.copy()

    kept = probs
    top_p = p.top_p if p.top_p is not None else 1.0
    if 0.0 < top_p < 1.0:
        cums = np.cumsum(kept)
        if cums[-1] < top_p and not (top_k and top_k <= kept.shape[0]):
            return None  # cutoff beyond K: need the full vector
        cut = cums - kept >= top_p
        kept = np.where(cut, 0.0, kept)
        min_p = p.min_p if p.min_p is not None else 0.0
        if 0.0 < min_p < 1.0:
            kept = np.where(kept <= kept[0] * min_p, 0.0, kept)
    elif not (top_k and top_k <= kept.shape[0]):
        # untruncated multinomial over the full vocab: draw u and fall back
        # only if it lands in the tail (exact: tail mass = 1 - cum_k)
        u = rng.random()
        if u > cum_k:
            return None  # rare for peaked LLM distributions
        cums = np.cumsum(probs)
        idx = int(np.searchsorted(cums, u, side="right"))
        idx = min(idx, probs.shape[0] - 1)
        tok = int(ti[idx])
        lp = float(np.log10(probs[idx])) if probs[idx] > 0 else float("-inf")
        return Logprobs(token=tok, logprob=lp,
                        top_logprobs=_top_from_pack(sampler, probs, ti) if return_logprobs else None)

    total = kept.sum()
    if total <= 0:
        tok = int(ti[0])
        return Logprobs(token=tok, logprob=0.0,
                        top_logprobs=_top_from_pack(sampler, kept, ti) if return_logprobs else None)
    u = rng.random() * total
    cums = np.cumsum(kept)
    idx = int(np.searchsorted(cums, u, side="right"))
    idx = min(idx, kept.shape[0] - 1)
    tok = int(ti[idx])
    lp = float(np.log10(kept[idx])) if kept[idx] > 0 else float("-inf")
    return Logprobs(token=tok, logprob=lp,
                    top_logprobs=_top_from_pack(sampler, kept, ti) if return_logprobs else None)


def _top_from_pack(sampler, probs, ti) -> list["TopLogprob"]:
    n = sampler.p.top_n_logprobs
    if n <= 0:
        return []
    out = []
    for j in range(min(n, probs.shape[0])):
        pv = probs[j]
        out.append(TopLogprob(int(ti[j]),
                              float(np.log10(pv)) if pv > 0 else float("-inf")))
    return out
