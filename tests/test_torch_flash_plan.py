"""The launch plan of K6 (flash_prefill) and K6' (flash_prefill_continuation):
rows a block, key tile, stages, grid and shared memory, for every chunk
length up to 4096. Pure Python: the plan is what the wrappers hand the CUDA
entry points, which check it (csrc/flash_sm90.cuh::plan_fits)."""

import re
from pathlib import Path

import numpy as np
import pytest

from mistralrs_tpu_torch.ops import flash_attention as fa

SMEM_PER_BLOCK = 232_448  # what one block of an H100 may take (227 KB)
SMS = 132  # an H100 SXM's SMs


def covered_rows(plan, B, T, Hq):
    """How often each query row of each (row, head) is owned by a work item
    of some block: block x takes items x, x + grid, ...; item w is query
    tile qtiles - 1 - w // (Hq * B) of batch row (w % (Hq * B)) // Hq, head
    w % Hq (csrc/flash_sm90.cuh::item_at)."""
    qtiles = -(-T // plan.rows)
    count = np.zeros((B, Hq, T), dtype=np.int64)
    for x in range(plan.grid[0]):
        w = np.arange(x, plan.items, plan.grid[0])
        r = w % (Hq * B)
        q0 = (qtiles - 1 - w // (Hq * B)) * plan.rows
        for b, h, q in zip(r // Hq, r % Hq, q0):
            count[b, h, q:min(q + plan.rows, T)] += 1
    return count


@pytest.mark.parametrize("B", [1, 4, 16])
def test_plan_covers_every_row_once_within_shared_memory(B):
    Hq = 32
    for T in range(1, 4097):
        plan = fa.flash_plan(B, T, Hq, 8, 128, SMS)
        qtiles = -(-T // plan.rows)
        assert plan.grid == (min(SMS, plan.items), 1, 1), (T, plan)
        assert plan.stages >= 2 and plan.smem_bytes <= SMEM_PER_BLOCK, plan
        assert plan.threads == 384  # two consumer warpgroups and a producer
        # every item w < items falls to block w % grid; the items are every
        # (query tile, row, head) once, and the query tiles cover 0..T-1 once
        w = np.arange(plan.items)
        r, qt = w % (Hq * B), qtiles - 1 - w // (Hq * B)
        assert plan.items == Hq * B * qtiles and qt.min() == 0
        assert np.unique((qt * B + r // Hq) * Hq + r % Hq).size == plan.items, (T, plan)
        assert (qtiles - 1) * plan.rows < T <= qtiles * plan.rows


@pytest.mark.parametrize("B,T,Hq,sms", [(1, 1, 4, 132), (4, 512, 32, 132), (16, 256, 32, 132),
                                        (2, 1000, 8, 132), (3, 4096, 32, 132), (4, 300, 8, 7)])
def test_blocks_own_every_query_row_once(B, T, Hq, sms):
    plan = fa.flash_plan(B, T, Hq, 2, 128, sms)
    assert (covered_rows(plan, B, T, Hq) == 1).all(), plan


def test_plan_shared_memory_holds_the_ring_and_the_q_tile():
    plan = fa.flash_plan(4, 512, 32, 8, 128, SMS)
    tile = plan.key_tile * 128 * 2  # bf16 bytes of a K or V tile
    # each stage: K and V tiles and three 8-byte mbarriers; the Q tile and
    # its barrier; 1024 bytes to align the start to the 128-byte swizzle's
    # 1024-byte period
    assert plan.smem_bytes >= plan.stages * (2 * tile + 24) + plan.rows * 128 * 2 + 8 + 1024
    assert plan.rows == plan.key_tile == 128


@pytest.mark.parametrize("Hq,Hkv", [(32, 8), (4, 2), (16, 1), (8, 8)])
def test_plan_takes_any_grouping_of_heads(Hq, Hkv):
    plan = fa.flash_plan(2, 300, Hq, Hkv, 128, SMS)
    assert plan.items == Hq * 2 * 3 and plan.grid == (min(SMS, plan.items), 1, 1)


@pytest.mark.parametrize("D", [64, 96, 256])
def test_plan_raises_for_other_head_dims(D):
    with pytest.raises(ValueError):
        fa.flash_plan(1, 128, 4, 2, D, SMS)


@pytest.mark.parametrize("args", [(1, 128, 6, 4, 128, SMS), (0, 128, 4, 2, 128, SMS),
                                  (1, 0, 4, 2, 128, SMS), (1, 128, 4, 2, 128, 0)])
def test_plan_raises_for_what_it_cannot_launch(args):
    with pytest.raises(ValueError):
        fa.flash_plan(*args)


CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"


def constant(name, header):
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / header).read_text()).group(1))


def test_plan_is_the_cores_launch():
    # what plan_fits (csrc/flash_sm90.cuh) holds a launch to: its core's rows,
    # key tile, stages and threads
    plan = fa.flash_plan(4, 512, 32, 8, 128, SMS)
    assert (plan.rows, plan.key_tile, plan.stages, plan.threads) == (
        constant("kRows", "flash_sm90.cuh"), constant("kKeys", "flash_sm90.cuh"),
        constant("kStages", "flash_sm90.cuh"), constant("kRowThreads", "common.cuh"))
    assert fa.launch_args(plan) == (128, 128, 3, 384, *plan.grid, plan.smem_bytes)


@pytest.mark.parametrize("source,entry", [("flash_prefill.cu", "flash_prefill"),
                                          ("flash_prefill_paged.cu", "flash_prefill_paged")])
def test_entry_points_take_the_plan_in_launch_args_order(source, entry):
    text = (CSRC / source).read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names[names.index("scale") + 1:] == ["rows", "keys", "stages", "threads", "gx", "gy",
                                                "gz", "smem", "stream"]
    assert "plan_fits(rows, keys, stages, threads, gx, gy, gz, smem, B, T, Hq)" in text
