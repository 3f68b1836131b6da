"""The launch plan of K12's chunk instantiation (ragged_attention with more
than one query a sequence): rows a work item, key tile, stages, grid and
shared memory, for every head dim, grouping of query heads, page and query
count it takes. Pure Python: the plan is what the wrapper hands the CUDA
entry point, which checks it (csrc/ragged_attention.cu::launch_chunk)."""

import re
from pathlib import Path

import numpy as np
import pytest

from mistralrs_tpu_torch.ops import ragged_attention as ra

SMEM_PER_BLOCK = 232_448  # what one block of an H100 may take (227 KB)
SMS = 132  # an H100 SXM's SMs
CSRC = Path(ra.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("D", [128, 256])
def test_plan_fits_shared_memory_for_every_page_and_query_count(D, G):
    Hkv = 8 if G < 16 else 2
    for page in (1, 4, 16, 64, 256):
        for max_q_len in (2, 176, 512, 4096):
            plan = ra.ragged_chunk_plan(4, max_q_len, G * Hkv, Hkv, D, page, SMS)
            assert plan.smem_bytes <= SMEM_PER_BLOCK, (page, max_q_len, plan)
            assert plan.rows == 128 and plan.threads == 384
            assert plan.items == 4 * Hkv * -(-max_q_len // (128 // G))
            assert plan.grid == (min(SMS, plan.items), 1, 1)


@pytest.mark.parametrize("D,keys,stages", [(128, 128, 3), (256, 64, 2)])
def test_plan_shared_memory_holds_the_ring_and_the_q_tile(D, keys, stages):
    plan = ra.ragged_chunk_plan(4, 512, 32, 8, D, 16, SMS)
    assert (plan.key_tile, plan.stages) == (keys, stages)
    tile = keys * D * 2  # bf16 bytes of a K or V tile
    # each stage: K and V tiles and four mbarriers (full, ready, and the K
    # and V halves' empty: they are freed apart); the Q tile and its
    # barrier; 1024 bytes to align the start to the 128-byte swizzle's
    # period
    assert plan.smem_bytes == stages * (2 * tile + 4 * 8) + 128 * D * 2 + 16 + 1024


def covered_rows(plan, B, max_q_len, Hq, Hkv):
    """How often each (sequence, query, head) row of a step is owned by a
    work item: item w is query tile qtiles - 1 - w // (B * Hkv) (128/G
    queries) of sequence (w % (B * Hkv)) // Hkv and kv head w % Hkv, its G
    query heads (csrc/ragged_attention.cu::chunk_item)."""
    G = Hq // Hkv
    qt = plan.rows // G
    qtiles = -(-max_q_len // qt)
    count = np.zeros((B, max_q_len, Hq), dtype=np.int64)
    for x in range(plan.grid[0]):
        for w in range(x, plan.items, plan.grid[0]):
            r = w % (B * Hkv)
            b, kvh, t0 = r // Hkv, r % Hkv, (qtiles - 1 - w // (B * Hkv)) * qt
            count[b, t0:t0 + qt, kvh * G:(kvh + 1) * G] += 1
    return count


@pytest.mark.parametrize("B,max_q_len,Hq,Hkv,sms", [
    (4, 512, 32, 8, 132), (4, 512, 16, 8, 132), (3, 176, 32, 2, 132), (1, 2, 8, 8, 132),
    (16, 300, 16, 1, 132), (2, 1000, 32, 4, 7)])
def test_blocks_own_every_query_row_once(B, max_q_len, Hq, Hkv, sms):
    plan = ra.ragged_chunk_plan(B, max_q_len, Hq, Hkv, 128, 16, sms)
    assert (covered_rows(plan, B, max_q_len, Hq, Hkv) == 1).all(), plan


@pytest.mark.parametrize("args", [
    (1, 128, 4, 2, 64, 16, SMS),     # head dim 64
    (1, 128, 4, 2, 96, 16, SMS),     # head dim 96
    (1, 128, 6, 2, 128, 16, SMS),    # 3 query heads a kv head
    (1, 128, 64, 2, 256, 16, SMS),   # 32 query heads a kv head
    (1, 128, 4, 3, 128, 16, SMS),    # Hq not a multiple of Hkv
    (1, 128, 8, 2, 128, 12, SMS),    # a page of 12
    (0, 128, 8, 2, 128, 16, SMS), (1, 0, 8, 2, 128, 16, SMS), (1, 128, 8, 2, 128, 16, 0)])
def test_plan_raises_for_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        ra.ragged_chunk_plan(*args)


def test_plan_is_the_kernels_launch():
    """What launch_chunk holds a call to: the configuration of its core at
    each head dim (K6's tiles and stages at D 128; 64-key tiles in 2 stages
    at D 256; K and V freed apart at both) and the plan in launch_args order
    after the scalars."""
    text = (CSRC / "ragged_attention.cu").read_text()
    sm90 = (CSRC / "flash_sm90.cuh").read_text()
    # the configuration, shared with K11, lives beside the core
    assert "using C = fa3::ChunkCore<D>;" in text
    assert "using ChunkCore = Core<D, D == 128 ? 128 : 64, D == 128 ? 3 : 2, true>;" in sm90
    k6 = [int(re.search(rf"constexpr int {n} = (\d+);", sm90).group(1))
          for n in ("kRows", "kKeys", "kStages")]
    plan = ra.ragged_chunk_plan(4, 512, 32, 8, 128, 16, SMS)
    assert [plan.rows, plan.key_tile, plan.stages] == k6
    params = re.search(r'extern "C" int ragged_chunk\(([^)]*)\)', text).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names[names.index("window") + 1:] == ["rows", "keys", "stages", "threads", "gx",
                                                 "gy", "gz", "smem", "stream"]
    assert "ragged_chunk_kernel" not in text  # the FlashAttention-2 chunk kernel is gone
