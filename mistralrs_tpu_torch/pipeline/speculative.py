"""Speculative decoding: a draft proposes gamma tokens, the target verifies.

Counterpart of mistralrs_tpu/pipeline/speculative.py (reference parity:
mistralrs-core/src/pipeline/speculative.rs `SpeculativePipeline::step`
:309-617), whose behaviour is the specification:
- greedy output (temperature None) is identical to plain greedy decoding,
  for any draft and any gamma: acceptance is argmax matching;
- otherwise standard speculative sampling (`_reject_sample`, host numpy on
  the engine's per-sequence rng): accept draft token d with probability
  min(1, p(d)/q(d)), on rejection resample from normalize(max(p - q, 0)),
  after gamma acceptances a bonus token from the target's last position;
- KV rollback is a counter rewind (seq.kv_len, seq.draft_kv_len): slots
  past kv_len are never attended and are overwritten later;
- draft and target share one page-id space (the same page geometry), so
  one block manager serves both models' caches.

Two pipelines, each driven through Engine as the JAX tests drive them:
`SpeculativePipeline(target, draft)` (a draft model) and
`PromptLookupPipeline(target)` (proposals from an n-gram match over the
sequence's own tokens). Each has a host-driven step (`speculative_step`:
the draft's feeds and the target's verify through TextPipeline.run_span,
acceptance on the host), which serves sampled batches, and a device loop
of `spec_rounds` greedy rounds (`run_spec_multi`), which the engine takes
for greedy batches: drafting, the width-(gamma+1) verify, acceptance and
the rewinds all run on the device, and one pack comes back. The loop reads
only static buffers of its key ("spec_draft" or "spec_pld", block-table
width), which `_fill_spec` writes; on the card a call is one replay of a
CUDA graph of `_spec_loop(key)` (pipeline/graphs.py, kind "spec"), where
the JAX package jits the loop as one lax.scan, and a failed capture or
replay raises. On the CPU the loop runs eagerly; `run_spec_multi_eager`
runs it eagerly on any device (tests, A/B). A graph holds the addresses of
both pipelines' weights and caches, so the store is dropped when the
target or the draft drops its own decode graphs (TextPipeline.re_isq).

Where the JAX loops rely on an out-of-range index being clamped or dropped
(the block-table lookup of a position, the history's update slice), the
port clamps it explicitly: an out-of-range gather faults on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from mistralrs_tpu_torch.engine.sampler import Logprobs
from mistralrs_tpu_torch.engine.sequence import Sequence
from mistralrs_tpu_torch.models.decoder import compute_logits, decoder_forward
from mistralrs_tpu_torch.ops.paged_attention import PagedAttnMeta
from mistralrs_tpu_torch.pipeline.graphs import DecodeGraphs
from mistralrs_tpu_torch.pipeline.text import TextPipeline

_TINY = 1e-10

# device-loop calls that ran as an eager loop, not a graph replay
# (run_spec_multi_eager's, and run_spec_multi's on the CPU), and
# host-driven speculative steps
spec_eager_loops = 0
spec_host_steps = 0


def _log10(x: float) -> float:
    return float(np.log10(x)) if x > 0 else float("-inf")


def _forward(pipe: TextPipeline, ids: torch.Tensor, pos0: torch.Tensor, tables: torch.Tensor,
             kv_end: torch.Tensor, active: torch.Tensor, pos_off: torch.Tensor) -> torch.Tensor:
    """One forward of ids [B, W] at window-relative positions pos0.. on
    `pipe`'s params and cache (JAX fwd :149-166), its slots from the device
    tables (the page index clamped to the table), attending up to kv_end;
    returns f32 logits [B, W, V]."""
    ps = pipe.pc.page_size
    pos = pos0[:, None] + torch.arange(ids.shape[1], device=ids.device)[None]
    page = torch.gather(tables, 1, torch.clamp(pos // ps, 0, tables.shape[1] - 1))
    meta = PagedAttnMeta(positions=pos + pos_off[:, None], slot_mapping=page * ps + pos % ps,
                         block_tables=tables, kv_lens=kv_end, active=active,
                         head_major=pipe.head_major)
    h, _ = decoder_forward(pipe.params, pipe.cfg, pipe.rope, ids, pipe.cache, meta)
    return compute_logits(pipe.params, pipe.cfg, h)


def _verify_greedy(logits: torch.Tensor, props: torch.Tensor, nprop: torch.Tensor | None = None):
    """Argmax-match acceptance of a verify's logits [B, g+1, V] against
    proposals props [B, g] (the first nprop [B] of them, if given): (toks
    [B, g+1] the target's argmax ids, vals their logits, count [B] the
    tokens emitted = accepted + 1)."""
    toks = torch.argmax(logits, dim=-1)
    vals = torch.gather(logits, -1, toks[..., None])[..., 0]
    g = props.shape[1]
    match = toks[:, :g] == props
    if nprop is not None:
        match &= torch.arange(g, device=props.device)[None] < nprop[:, None]
    acc = torch.cumprod(match.to(torch.int64), dim=1).sum(dim=1)
    return toks, vals, acc + 1


def propose(hist: torch.Tensor, hl: torch.Tensor, gamma: int, ngram_min: int,
            ngram_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Device mirror of PromptLookupPipeline._propose (JAX propose
    :551-577) over histories hist [B, C] of lengths hl [B]: for n =
    ngram_min..ngram_max (a larger n wins) the most recent earlier
    occurrence of a row's last n tokens proposes up to gamma tokens that
    followed it. Returns (props [B, gamma], nprop [B]); a row without a
    match gets nprop 0. Indices are clipped to the history, as in JAX."""
    B, C = hist.shape
    dev = hist.device
    steps = torch.arange(gamma, device=dev)[None]
    props = torch.zeros(B, gamma, dtype=hist.dtype, device=dev)
    nprop = torch.zeros(B, dtype=hl.dtype, device=dev)
    for n in range(ngram_min, ngram_max + 1):
        sidx = torch.clamp(hl[:, None] - n + torch.arange(n, device=dev)[None], 0, C - 1)
        suffix = torch.gather(hist, 1, sidx)  # [B, n]
        M = C - n + 1
        ok = torch.ones(B, M, dtype=torch.bool, device=dev)
        for i in range(n):
            ok &= hist[:, i : i + M] == suffix[:, i : i + 1]
        starts = torch.arange(M, device=dev)[None]
        ok &= starts < (hl - n)[:, None]  # strictly before the suffix itself
        last = torch.amax(torch.where(ok, starts, -1), dim=1)
        found = (last >= 0) & (hl >= n + 1)
        fs = last + n  # the first following token
        cand = torch.gather(hist, 1, torch.clamp(fs[:, None] + steps, 0, C - 1))
        props = torch.where(found[:, None], cand, props)
        nprop = torch.where(found, torch.clamp(hl - fs, max=gamma), nprop)
    return props, nprop


class SpeculativePipeline:
    """Wraps (target, draft) TextPipelines; the engine-facing surface of a
    TextPipeline plus `speculative_step` and the device loop
    `run_spec_multi` (spec_rounds > 1; 1 = the host step only)."""

    is_speculative = True

    def __init__(self, target: TextPipeline, draft: TextPipeline, gamma: int = 4,
                 spec_rounds: int = 1):
        tp, dp = target.pc, draft.pc
        if (tp.page_size, tp.num_pages, tp.max_model_len) != (dp.page_size, dp.num_pages,
                                                               dp.max_model_len):
            raise ValueError("draft and target must share page size, page count and "
                             "max_model_len (one block manager serves both caches)")
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError("speculative decoding requires a shared vocabulary "
                             "(ref speculative.rs tokenizer check)")
        if target.device != draft.device:
            raise ValueError(f"draft on {draft.device}, target on {target.device}")
        self.target = target
        self.draft = draft
        self._init(target, gamma, spec_rounds)

    def _init(self, target: TextPipeline, gamma: int, spec_rounds: int) -> None:
        self.gamma = gamma
        self.spec_rounds = spec_rounds
        self.pc = target.pc
        self.cfg = target.cfg
        self.max_pages_per_seq = target.max_pages_per_seq
        # the device loop's static inputs by key: int64 and f32 [B, ...]
        self._bufs: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
        # the loop's graphs (None until the first call on the card), and the
        # decode-graph stores of target and draft they were captured beside
        self.graphs: DecodeGraphs | None = None
        self._graph_owners: tuple | None = None

    # ------------------------------------------------------------- plumbing
    @property
    def last_greedy_pack(self) -> np.ndarray:
        """The engine's batched-prefill emission reads the target's pack."""
        return self.target.last_greedy_pack

    def fetch_full_logits_row(self, i: int) -> np.ndarray:
        return self.target.fetch_full_logits_row(i)

    def apply_copies(self, ops: list[tuple[int, int]]) -> None:
        self.target.apply_copies(ops)
        self.draft.apply_copies(ops)

    def run_prefill_chunk(self, seq: Sequence, chunk: list[int], greedy: bool = False):
        # the draft prefills the same chunk into its own cache (same pages)
        self.draft.run_prefill_chunk(seq, chunk, greedy=True, advance_state=False)
        out = self.target.run_prefill_chunk(seq, chunk, greedy=greedy)
        seq.draft_kv_len = seq.prefill_done_tokens
        return out

    def run_decode(self, seqs: list[Sequence], greedy: bool = False):
        # plain decode on the target (the engine routes decode through
        # speculative_step and run_spec_multi)
        return self.target.run_decode(seqs, greedy=greedy)

    # ------------------------------------------------------------- the step
    def _effective_gamma(self, seq: Sequence) -> int:
        """The draft span, clamped so no KV write lands past physical
        capacity and no more tokens are drafted than the sequence can
        still emit."""
        L = len(seq.tokens)
        phys_max = self.max_pages_per_seq * self.pc.page_size
        cap = min(self.gamma, phys_max - L, seq.max_model_len - L)
        if seq.sampling.max_len is not None:
            cap = min(cap, seq.sampling.max_len - seq.num_generated - 1)
        return max(0, cap)

    def speculative_step(self, seqs: list[Sequence], rng_for,
                         greedy: bool) -> list[list[Logprobs]]:
        """One engine decode step on the host: per-seq emitted Logprobs (1
        to gamma+1 each). Updates kv_len and draft_kv_len; the engine
        appends the tokens and checks stop conditions."""
        global spec_host_steps
        spec_host_steps += 1
        tables = [self.target._tables_row(s) for s in seqs]
        gis = [self._effective_gamma(s) for s in seqs]
        for s in seqs:
            if s.kv_len != len(s.tokens) - 1:
                raise AssertionError("decode invariant: kv_len == len(tokens) - 1")

        # ---- 1. draft proposals
        proposals: list[list[int]] = [[] for _ in seqs]
        qdists: list[list[np.ndarray | None]] = [[] for _ in seqs]
        live = [i for i, gi in enumerate(gis) if gi > 0]
        if live:
            # catch-up + first proposal: feed tokens[draft_kv : L] (width 1,
            # or 2 right after a fully accepted span)
            wc = max(len(seqs[i].tokens) - seqs[i].draft_kv_len for i in live)
            rows = [(seqs[i].tokens[seqs[i].draft_kv_len :], seqs[i].draft_kv_len, tables[i])
                    for i in live]
            out = self.draft.run_span(rows, wc, greedy=greedy)
            self._collect_draft(out, seqs, live, proposals, qdists, rng_for, greedy)
            for i in live:
                seqs[i].draft_kv_len = len(seqs[i].tokens)
            # the remaining gamma-1 proposals: single-token feeds
            for k in range(1, max(gis)):
                step_live = [i for i in live if gis[i] > k]
                if not step_live:
                    break
                rows = [([proposals[i][k - 1]], len(seqs[i].tokens) - 1 + k, tables[i])
                        for i in step_live]
                out = self.draft.run_span(rows, 1, greedy=greedy)
                self._collect_draft(out, seqs, step_live, proposals, qdists, rng_for, greedy)
            for i in live:
                seqs[i].spec_proposed += len(proposals[i])

        return self._verify_and_accept(seqs, tables, proposals, qdists, gis, rng_for, greedy,
                                       update_draft=True)

    def _verify_and_accept(self, seqs, tables, proposals, qdists, gis, rng_for, greedy,
                           update_draft: bool) -> list[list[Logprobs]]:
        """One target verify over [last token, d_0..d_{gi-1}] per row, then
        acceptance and the kv_len rewind (shared with prompt lookup)."""
        g = self.gamma
        rows = [([s.tokens[-1]] + proposals[i], s.kv_len, tables[i]) for i, s in enumerate(seqs)]
        out = self.target.run_span(rows, g + 1, all_positions=True, greedy=greedy)
        results: list[list[Logprobs]] = []
        for i, s in enumerate(seqs):
            L = len(s.tokens)
            gi = gis[i]
            if greedy:
                toks = out[0, i].astype(np.int64)  # [g+1] argmax per position
                vals = out[1, i]
                emitted = []
                for j in range(gi):
                    tok = int(toks[j])
                    emitted.append(Logprobs(token=tok, logprob=float(vals[j])))
                    if tok != proposals[i][j]:
                        break
                else:
                    emitted.append(Logprobs(token=int(toks[gi]), logprob=float(vals[gi])))
                a = len(emitted) - 1
            else:
                emitted, a = self._reject_sample(s, out[i], proposals[i], qdists[i], gi,
                                                 rng_for(s))
            s.spec_accepted += a
            s.kv_len = L + a  # rollback = counter rewind (ref :489-530)
            if update_draft and gi > 0:
                # the draft cache holds positions through L+gi-2; keep only
                # the prefix consistent with the accepted tokens
                s.draft_kv_len = min(L + a, L + gi - 1)
            results.append(emitted)
        return results

    def _collect_draft(self, out, seqs, idxs, proposals, qdists, rng_for, greedy) -> None:
        """One proposal per live row from a draft run_span output."""
        if greedy:
            for r, i in enumerate(idxs):
                proposals[i].append(int(out[0, r]))
                qdists[i].append(None)
            return
        for r, i in enumerate(idxs):
            s = seqs[i]
            ctx = s.tokens + proposals[i]
            q = s.sampler.probs(out[r], ctx)
            if q is None:
                # argmax-mode sampler: propose greedily, verify greedily
                logits = s.sampler._processors(
                    s.sampler._apply_penalties(out[r].astype(np.float32), ctx), ctx)
                proposals[i].append(int(np.argmax(logits)))
                qdists[i].append(None)
            else:
                proposals[i].append(int(rng_for(s).choice(q.shape[-1], p=q)))
                qdists[i].append(q)

    def _reject_sample(self, s, logits, props, qd, gi, rng):
        """Speculative acceptance (ref speculative.rs :471-487 adapted to
        stochastic sampling). Returns (emitted Logprobs, accepted count)."""
        ctx = list(s.tokens)
        emitted: list[Logprobs] = []
        sampler = s.sampler
        for j in range(gi):
            d = props[j]
            p = sampler.probs(logits[j], ctx)
            q = qd[j]
            if p is None:
                # greedy target: accept iff argmax matches the draft token
                pl = sampler._processors(
                    sampler._apply_penalties(logits[j].astype(np.float32), ctx), ctx)
                tok = int(np.argmax(pl))
                emitted.append(Logprobs(token=tok, logprob=float(pl[tok])))
                if tok != d:
                    return emitted, j
                ctx.append(d)
                continue
            if q is not None and rng.random() <= p[d] / max(q[d], _TINY):
                emitted.append(Logprobs(token=d, logprob=_log10(p[d])))
                ctx.append(d)
                continue
            if q is None:
                # greedy draft, stochastic target: q is a point mass at d
                if rng.random() <= p[d]:
                    emitted.append(Logprobs(token=d, logprob=_log10(p[d])))
                    ctx.append(d)
                    continue
                res = p.copy()
                res[d] = 0.0
            else:
                res = np.maximum(p - q, 0.0)
            tot = res.sum()
            dist = res / tot if tot > 0 else p
            tok = int(rng.choice(dist.shape[-1], p=dist))
            emitted.append(Logprobs(token=tok, logprob=_log10(p[tok])))
            return emitted, j
        # all gi accepted: the bonus token from the target's last position
        p = sampler.probs(logits[gi], ctx)
        if p is None:
            pl = sampler._processors(
                sampler._apply_penalties(logits[gi].astype(np.float32), ctx), ctx)
            tok = int(np.argmax(pl))
            emitted.append(Logprobs(token=tok, logprob=float(pl[tok])))
        else:
            tok = int(rng.choice(p.shape[-1], p=p))
            emitted.append(Logprobs(token=tok, logprob=_log10(p[tok])))
        return emitted, gi

    # --------------------------------------------------- the device loop
    def spec_multi_ok(self, seqs: list[Sequence]) -> bool:
        """Device-loop eligibility: both pipelines run a plain forward, and
        the loop's width-2 draft catch-up covers every row's gap (1 or 2;
        a wider one takes the host step and qualifies again next step)."""
        return (getattr(self.target, "supports_spec_device_loop", False)
                and getattr(self.draft, "supports_spec_device_loop", False)
                and all(s.draft_kv_len >= len(s.tokens) - 2 for s in seqs))

    def run_spec_multi(self, seqs: list[Sequence]) -> np.ndarray:
        """`spec_rounds` greedy rounds in one call: pack [R, n, W] of per
        round (the target's argmax ids [g+1], their logits [g+1], the
        emitted count, gamma or the proposals made, and for a model draft
        its absolute draft_kv_len after the round). Does not advance
        kv_len: the engine adds the tokens it consumes. On the card one
        graph replay (captured on the key's first use); on the CPU the
        loop runs eagerly."""
        global spec_eager_loops
        key, offs = self._fill_spec(seqs)
        graphs = self._graph_store()
        if graphs is not None:
            pack = graphs.replay(key, self._spec_loop)
        else:
            spec_eager_loops += 1
            pack = self._spec_loop(key)
        return self._spec_result(seqs, pack, offs)

    def run_spec_multi_eager(self, seqs: list[Sequence]) -> np.ndarray:
        """run_spec_multi's call as an eager loop on any device, over the
        same buffers (for tests and for timing against the graphs)."""
        global spec_eager_loops
        key, offs = self._fill_spec(seqs)
        spec_eager_loops += 1
        return self._spec_result(seqs, self._spec_loop(key), offs)

    def _graph_store(self) -> DecodeGraphs | None:
        """The loop's graph store on the card (None on the CPU), made anew
        when the target or the draft has dropped its decode graphs since
        the last call: the old graphs hold the old weights' addresses."""
        owners = (self.target.graphs, getattr(self.draft, "graphs", None))
        if owners[0] is None:
            return None
        if self._graph_owners is None or any(a is not b for a, b in zip(owners,
                                                                         self._graph_owners)):
            if self.graphs is not None:
                torch.cuda.synchronize(self.target.device)
            self.graphs = DecodeGraphs(self.target.device, "spec")
            self._graph_owners = owners
        return self.graphs

    def _write_bufs(self, key: tuple, ints: np.ndarray, floats: np.ndarray) -> None:
        bufs = self._bufs.get(key)
        if bufs is None:
            dev = self.target.device
            bufs = self._bufs[key] = (torch.zeros(ints.shape, dtype=torch.int64, device=dev),
                                      torch.zeros(floats.shape, dtype=torch.float32, device=dev))
        bufs[0].copy_(torch.from_numpy(ints))
        bufs[1].copy_(torch.from_numpy(floats))

    def _rows(self, seqs: list[Sequence]) -> tuple[int, list[int], int]:
        """(max_seqs, each row's window base in pages, the block-table
        width covering every row's context plus R(gamma+1) tokens)."""
        tp = self.target
        B = tp.pc.max_seqs
        if len(seqs) > B:
            raise ValueError(f"{len(seqs)} sequences > max_seqs {B}")
        bases = [tp._window_base_pages(s.kv_len) for s in seqs]
        return B, bases, tp._table_width(seqs, self.spec_rounds * (self.gamma + 1), bases)

    def _fill_spec(self, seqs: list[Sequence]) -> tuple[tuple, list[int]]:
        """Write a call's inputs into the static buffers of its block-table
        width (JAX run_spec_multi :236-255): int64 [B, 5 + width] (the last
        two tokens, kv_len, draft_kv_len, pos_off, the tables; window-
        relative), f32 [B, 1] active; padding rows have kv_len 0, page-0
        tables and are inactive. Returns the key and each row's offset."""
        tp = self.target
        ps = tp.pc.page_size
        B, bases, width = self._rows(seqs)
        ints = np.zeros((B, 5 + width), np.int64)
        floats = np.zeros((B, 1), np.float32)
        for i, (s, base) in enumerate(zip(seqs, bases)):
            ints[i, :2] = s.tokens[-2:] if len(s.tokens) >= 2 else [s.tokens[-1]] * 2
            ints[i, 2] = s.kv_len - base * ps
            ints[i, 3] = s.draft_kv_len - base * ps
            ints[i, 4] = base * ps
            ints[i, 5:] = tp._tables_row(s, width, base)
            floats[i, 0] = 1.0
        key = ("spec_draft", width)
        self._write_bufs(key, ints, floats)
        return key, [b * ps for b in bases]

    @torch.no_grad()
    def _spec_loop(self, key: tuple) -> torch.Tensor:
        """The R rounds of a call of `key` (JAX spec_multi :168-223) over
        that key's static buffers alone. A round: the draft's width-2
        catch-up from draft_kv_len (a gap of 1 feeds the last token twice;
        the second slot is overwritten by the next feed) gives the first
        proposal, gamma-1 single-token feeds the rest, the target verifies
        [last token, proposals] at kv_len, argmax matching accepts, and the
        counters rewind: draft_kv_len = L + min(accepted, gamma-1), kv_len +=
        emitted. Returns pack [R, B, 2(g+1)+3] f32 on the device."""
        ints, floats = self._bufs[key]
        tp, dp = self.target, self.draft
        g = self.gamma
        last2, kvl, dkv, off = ints[:, 0:2], ints[:, 2], ints[:, 3], ints[:, 4]
        tables = ints[:, 5:].contiguous()
        act = floats[:, 0].contiguous()
        rounds = []
        for _ in range(self.spec_rounds):
            L = kvl + 1
            gap = L - dkv  # 1 or 2
            ids0 = torch.where((gap == 1)[:, None], last2[:, 1:2].expand(-1, 2), last2)
            lg = _forward(dp, ids0, dkv, tables, dkv + 2, act, off)
            first = torch.clamp(gap - 1, 0, 1)[:, None]
            props = [torch.gather(torch.argmax(lg, dim=-1), 1, first)[:, 0]]
            for k in range(1, g):
                lg = _forward(dp, props[-1][:, None], L + (k - 1), tables, L + k, act, off)
                props.append(torch.argmax(lg[:, 0], dim=-1))
            props = torch.stack(props, dim=1)  # [B, g]
            ids = torch.cat([last2[:, 1:2], props], dim=1)
            lt = _forward(tp, ids, kvl, tables, kvl + g + 1, act, off)
            toks, vals, count = _verify_greedy(lt, props)
            dkv = L + torch.clamp(count - 1, max=g - 1)
            kvl = kvl + count
            tprev = torch.cat([last2[:, 1:2], toks], dim=1)
            at = (count - 1)[:, None]
            last2 = torch.cat([torch.gather(tprev, 1, at), torch.gather(toks, 1, at)], dim=1)
            col = torch.ones_like(vals[:, :1])
            rounds.append(torch.cat([toks.to(torch.float32), vals, count[:, None].to(vals.dtype),
                                     col * g, dkv[:, None].to(vals.dtype)], dim=1))
        return torch.stack(rounds)

    def _spec_result(self, seqs: list[Sequence], pack: torch.Tensor,
                     offs: list[int]) -> np.ndarray:
        out = pack.cpu().numpy()[:, :len(seqs)]
        # draft_kv_len came back window-relative: absolute per row
        out[:, :, 2 * (self.gamma + 1) + 2] += np.asarray(offs, np.float32)[None]
        return out


class PromptLookupPipeline(SpeculativePipeline):
    """Prompt-lookup (n-gram) speculative decoding: the longest recent
    n-gram suffix match over the sequence's own tokens proposes the tokens
    that followed it. No draft model and no draft KV; the verify and
    acceptance are inherited, with the draft a point mass (q one-hot)."""

    # the target's prefill fast paths survive intact (no draft shadowing)
    supports_batched_prefill = True

    def __init__(self, target: TextPipeline, gamma: int = 4, ngram_max: int = 3,
                 ngram_min: int = 1, spec_rounds: int = 8, hist_cap: int = 1024):
        self.target = target
        self.draft = None
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        # the device loop's token history: the last hist_cap - R(gamma+1)
        # tokens of each sequence, room for the R rounds' appends
        self.hist_cap = hist_cap
        self._init(target, gamma, spec_rounds)

    def spec_multi_ok(self, seqs: list[Sequence]) -> bool:
        # no draft cache to catch up; the target must run a plain forward
        return getattr(self.target, "supports_spec_device_loop", False)

    def apply_copies(self, ops: list[tuple[int, int]]) -> None:
        self.target.apply_copies(ops)

    def run_prefill_chunk(self, seq: Sequence, chunk: list[int], greedy: bool = False):
        return self.target.run_prefill_chunk(seq, chunk, greedy=greedy)

    def run_prefill_chunks(self, items) -> None:
        return self.target.run_prefill_chunks(items)

    def _propose(self, tokens: list[int], gi: int) -> list[int]:
        """Longest-suffix n-gram match: for n = ngram_max..ngram_min, the
        most recent earlier occurrence of tokens[-n:] proposes up to gi
        tokens that followed it (vectorized over the history)."""
        L = len(tokens)
        arr = np.asarray(tokens, dtype=np.int64)
        for n in range(min(self.ngram_max, L - 1), self.ngram_min - 1, -1):
            suffix = arr[L - n :]
            # candidate starts 0..L-n-1 (not the suffix's own position);
            # every match has >= 1 following token by construction
            ok = arr[0 : L - n] == suffix[0]
            for j in range(1, n):
                ok &= arr[j : j + L - n] == suffix[j]
            idx = np.nonzero(ok)[0]
            if idx.size:
                start = int(idx[-1])  # the most recent occurrence
                return tokens[start + n : start + n + gi]
        return []

    def speculative_step(self, seqs: list[Sequence], rng_for,
                         greedy: bool) -> list[list[Logprobs]]:
        global spec_host_steps
        spec_host_steps += 1
        tables = [self.target._tables_row(s) for s in seqs]
        gis = [self._effective_gamma(s) for s in seqs]
        for s in seqs:
            if s.kv_len != len(s.tokens) - 1:
                raise AssertionError("decode invariant: kv_len == len(tokens) - 1")
        # ---- 1. host n-gram proposals (no device work)
        proposals: list[list[int]] = []
        for i, s in enumerate(seqs):
            props = self._propose(s.tokens, gis[i]) if gis[i] > 0 else []
            gis[i] = len(props)
            proposals.append(props)
            s.spec_proposed += len(props)
        # ---- 2+3. the shared verify and acceptance (point-mass draft)
        qdists = [[None] * gi for gi in gis]
        return self._verify_and_accept(seqs, tables, proposals, qdists, gis, rng_for, greedy,
                                       update_draft=False)

    def _fill_spec(self, seqs: list[Sequence]) -> tuple[tuple, list[int]]:
        """The static buffers of the key's width (JAX run_spec_multi
        :644-666): int64 [B, C + 3 + width] (the history of the last
        keep = C - R(gamma+1) tokens, its length, kv_len, pos_off, the
        tables), f32 [B, 1] active."""
        tp = self.target
        ps = tp.pc.page_size
        C = self.hist_cap
        keep = C - self.spec_rounds * (self.gamma + 1)
        if keep <= 0:
            raise ValueError("hist_cap must exceed spec_rounds * (gamma + 1)")
        B, bases, width = self._rows(seqs)
        ints = np.zeros((B, C + 3 + width), np.int64)
        floats = np.zeros((B, 1), np.float32)
        for i, (s, base) in enumerate(zip(seqs, bases)):
            t = s.tokens[-keep:]
            ints[i, : len(t)] = t
            ints[i, C] = len(t)
            ints[i, C + 1] = s.kv_len - base * ps
            ints[i, C + 2] = base * ps
            ints[i, C + 3 :] = tp._tables_row(s, width, base)
            floats[i, 0] = 1.0
        key = ("spec_pld", width)
        self._write_bufs(key, ints, floats)
        return key, [b * ps for b in bases]

    @torch.no_grad()
    def _spec_loop(self, key: tuple) -> torch.Tensor:
        """The R rounds of a call of `key` (JAX spec_multi :579-625): the
        n-gram proposal from the device history (`propose`), the target's
        verify of [last token, proposals] at kv_len, argmax matching of the
        first nprop proposals, all g+1 verify outputs written into the
        history at hl (the start clamped so they fit, as
        dynamic_update_slice clamps it), then hl and kv_len advance by the
        emitted count. Returns pack [R, B, 2(g+1)+2] f32 on the device."""
        ints, floats = self._bufs[key]
        g, C = self.gamma, self.hist_cap
        hist = ints[:, :C]
        hl, kvl, off = ints[:, C], ints[:, C + 1], ints[:, C + 2]
        tables = ints[:, C + 3 :].contiguous()
        act = floats[:, 0].contiguous()
        span = torch.arange(g + 1, device=ints.device)[None]
        rounds = []
        for _ in range(self.spec_rounds):
            props, nprop = propose(hist, hl, g, self.ngram_min, self.ngram_max)
            last = torch.gather(hist, 1, torch.clamp(hl - 1, 0, C - 1)[:, None])
            lt = _forward(self.target, torch.cat([last, props], dim=1), kvl, tables,
                          kvl + g + 1, act, off)
            toks, vals, count = _verify_greedy(lt, props, nprop)
            hist = hist.scatter(1, torch.clamp(hl, 0, C - g - 1)[:, None] + span, toks)
            hl = hl + count
            kvl = kvl + count
            rounds.append(torch.cat([toks.to(torch.float32), vals, count[:, None].to(vals.dtype),
                                     nprop[:, None].to(vals.dtype)], dim=1))
        return torch.stack(rounds)

    def _spec_result(self, seqs: list[Sequence], pack: torch.Tensor,
                     offs: list[int]) -> np.ndarray:
        return pack.cpu().numpy()[:, :len(seqs)]
