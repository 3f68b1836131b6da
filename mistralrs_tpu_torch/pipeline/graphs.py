"""CUDA graphs of the device loops: one capture per key, one replay a call.

A graph is PyTorch's counterpart of the JAX package's jitted `lax.scan`
(mistralrs_tpu/pipeline/text.py `_build_multistep_fn`, and the speculative
loops of mistralrs_tpu/pipeline/speculative.py): a loop's forwards run on
the card without a host round trip between kernels. A TextPipeline's store
holds its decode loop's graphs (kind "decode"), a speculative pipeline's
its round loop's (kind "spec"); each kind has its own replay and capture
counters.
`DecodeGraphs.replay(key, run)` captures `run(key)` on first use of a
key, after one warm-up run on a side stream (which also builds the
kernels), under `torch.cuda.set_sync_debug_mode("error")`, so a host
sync inside the loop raises at capture, and with Python's garbage
collector run first and held off during the capture. Every graph of one
DecodeGraphs draws from one memory pool; the wrappers' per-call buffers
come from it. A failed capture or replay raises: there is no eager
fallback.

The kernel wrappers count a launch when they enqueue it (ops/*.py,
`*_launches`), and the decoder a forward on the blockwise route
(models/decoder.py, `blockwise_steps`), which at capture time runs
nothing. So a capture records each counter's increase, takes it back, and
every replay adds it again: the counters go on counting what the card ran.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Hashable

import torch

from mistralrs_tpu_torch.models import decoder
from mistralrs_tpu_torch.ops import (
    flash_attention,
    grouped_gemm,
    paged_attention,
    quant_matmul,
    ragged_attention,
    splash,
)

# replays and captures of decode graphs and of speculative-loop graphs, over
# all pipelines
decode_graph_replays = 0
decode_graph_captures = 0
spec_graph_replays = 0
spec_graph_captures = 0

# the modules whose `*_launches` counters a graph replays
_COUNTED = (flash_attention, grouped_gemm, paged_attention, quant_matmul, ragged_attention,
            splash)


def launch_counts() -> dict[tuple[object, str], int]:
    """Every kernel launch counter of the ops modules and the decoder's
    blockwise route counter, by (module, name)."""
    out = {(mod, name): value for mod in _COUNTED for name, value in vars(mod).items()
           if name.endswith("_launches") and isinstance(value, int)}
    out[(decoder, "blockwise_steps")] = decoder.blockwise_steps
    return out


def _add_counts(delta: dict[tuple[object, str], int], sign: int = 1) -> None:
    for (mod, name), n in delta.items():
        setattr(mod, name, getattr(mod, name) + sign * n)


def _bump(counter: str) -> None:
    globals()[counter] += 1


class DecodeGraphs:
    """Graphs captured on `device`, one per key, of a function of the key
    alone (key -> output tensor, over static buffers). `kind` ("decode" or
    "spec") names the module counters that its replays and captures add
    to."""

    def __init__(self, device: torch.device, kind: str = "decode"):
        if kind not in ("decode", "spec"):
            raise ValueError(f"graph kind {kind!r}: expected 'decode' or 'spec'")
        self.device = device
        self.kind = kind
        self.pool = None
        # key -> (graph, its output tensor, the launch counts one replay adds)
        self.graphs: dict[Hashable, tuple[torch.cuda.CUDAGraph, torch.Tensor, dict]] = {}
        self.capture_s = 0.0

    def replay(self, key: Hashable, run: Callable[[Hashable], torch.Tensor]) -> torch.Tensor:
        """Replay key's graph, capturing run(key) first if the key is new.
        Returns the graph's output, which the next replay overwrites."""
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(key, run)
        graph, out, delta = entry
        graph.replay()
        _add_counts(delta)
        _bump(f"{self.kind}_graph_replays")
        return out

    def _capture(self, key: Hashable, run: Callable[[Hashable], torch.Tensor]):
        t0 = time.perf_counter()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            run(key)  # warm-up (its launches are real and stay counted)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        # garbage that holds a CUDA graph (another pipeline's) must not be
        # collected while this one captures: destroying a graph is a CUDA
        # call the capture forbids, and it invalidates the capture
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = run(key)
        finally:
            if gc_was_on:
                gc.enable()
            torch.cuda.set_sync_debug_mode(mode)
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        _add_counts(delta, -1)  # the capture itself ran nothing
        _bump(f"{self.kind}_graph_captures")
        self.capture_s += time.perf_counter() - t0
        return graph, out, delta

    def pool_bytes(self) -> int:
        """Bytes of the device memory segments the graphs' pool holds."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
