"""The launch plan of K11 (splash_prefill, csrc/splash_prefill.cu on the
Hopper attention core of csrc/flash_sm90.cuh in K12's chunk configuration):
rows a work item, key tile, stages, grid and shared memory for both head
dims; the items own every (row, head) once; each item's key tiles, and the
tiles the kernel masks, cover exactly the keys that splash_prefill_plain's
mask keeps, with a window and without. Pure Python: the plan is what the
wrapper hands the CUDA entry point, which checks it."""

import re
from pathlib import Path

import numpy as np
import pytest

from mistralrs_tpu_torch.ops import splash as sp

SMEM_PER_BLOCK = 232_448  # what one block of an H100 may take (227 KB)
SMS = 132  # an H100 SXM's SMs
ROWS = 128  # query rows of a work item (fa3::kRows)
CSRC = Path(sp.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("D,keys,stages", [(128, 128, 3), (256, 64, 2)])
def test_plan_fits_shared_memory(D, keys, stages):
    """Each stage: K and V tiles and four mbarriers (full, ready, and the K
    and V halves' empty: they are freed apart); the Q tile and its barrier;
    1024 bytes to align the start to the 128-byte swizzle's period; at most
    what one block may take, at every batch and chunk length."""
    for B, T, Hq, Hkv in ((4, 512, 16, 8), (1, 1, 8, 4), (16, 4096, 32, 8), (3, 200, 32, 1)):
        plan = sp.splash_plan(B, T, Hq, Hkv, D, SMS)
        assert (plan.rows, plan.key_tile, plan.stages, plan.threads) == (ROWS, keys, stages, 384)
        tile = keys * D * 2
        assert plan.smem_bytes == stages * (2 * tile + 4 * 8) + ROWS * D * 2 + 16 + 1024
        assert plan.smem_bytes <= SMEM_PER_BLOCK
        assert plan.items == B * Hq * -(-T // ROWS)
        assert plan.grid == (min(SMS, plan.items), 1, 1)


def items(plan, B, T, Hq):
    """Work item w of a block x (w = x, x + grid, ...): K6's fa3::item_at,
    the last query tile of every (row, head) first, heads fastest."""
    qtiles = -(-T // ROWS)
    per = Hq * B
    for x in range(plan.grid[0]):
        for w in range(x, plan.items, plan.grid[0]):
            r = w % per
            yield r // Hq, r % Hq, (qtiles - 1 - w // per) * ROWS


@pytest.mark.parametrize("B,T,Hq,Hkv,sms", [
    (4, 512, 16, 8, 132), (4, 512, 8, 4, 132), (1, 512, 32, 8, 132), (3, 200, 16, 8, 7),
    (2, 129, 4, 1, 132)])
def test_blocks_own_every_row_and_head_once(B, T, Hq, Hkv, sms):
    plan = sp.splash_plan(B, T, Hq, Hkv, 256, sms)
    count = np.zeros((B, T, Hq), dtype=np.int64)
    for b, h, q0 in items(plan, B, T, Hq):
        count[b, q0:q0 + ROWS, h] += 1
    assert (count == 1).all(), plan


def keys_of_item(q0, T, KT, win):
    """The keys each row of an item gets, as the kernel walks them
    (splash_prefill_kernel): tiles t_lo.. up to the diagonal; in a masked
    tile the exact rule, in an unmasked one every key of it."""
    t_lo = max(0, q0 - (win - 1)) // KT
    n = min(q0 + ROWS - 1, T - 1) // KT + 1 - t_lo
    got = np.zeros((ROWS, T + KT), dtype=bool)
    for tt in range(n):
        k0 = (t_lo + tt) * KT
        masked = k0 + KT - 1 > q0 or k0 < q0 + ROWS - 1 - (win - 1)
        for r in range(ROWS):
            qi = q0 + r
            keep = np.arange(k0, k0 + KT)
            if masked:
                keep = keep[(keep <= qi) & (keep > qi - win)]
            got[r, keep] = True
    return got[:, :T]


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("T,window", [(512, None), (512, 4096), (512, 128), (256, None),
                                      (200, 64), (384, 129), (640, 200), (1, None)])
def test_item_key_tiles_cover_the_plain_mask(D, T, window):
    """The keys the kernel's items attend (tiles from the first row's window
    start to the diagonal, masked where they cross the diagonal or the last
    row's window start) are exactly the keys splash_prefill_plain keeps
    (u <= t and, with a window w, u > t - w), for every real row; no item
    walks a tile without a kept key."""
    plan = sp.splash_plan(1, T, 1, 1, D, SMS)
    KT = plan.key_tile
    win = window if window and window < T else 1 << 30
    t = np.arange(T)
    want = t[None, :] <= t[:, None]
    if window is not None:
        want &= t[None, :] > t[:, None] - window
    for _, _, q0 in items(plan, 1, T, 1):
        got = keys_of_item(q0, T, KT, win)
        nr = min(ROWS, T - q0)
        assert np.array_equal(got[:nr], want[q0:q0 + nr]), (q0, window)
        t_lo = max(0, q0 - (win - 1)) // KT
        for k0 in range(t_lo * KT, min(q0 + ROWS - 1, T - 1) + 1, KT):
            assert want[q0:q0 + nr, k0:k0 + KT].any(), (q0, k0)


@pytest.mark.parametrize("args", [
    (1, 128, 4, 2, 64, SMS), (1, 128, 4, 2, 96, SMS), (1, 128, 4, 2, 512, SMS),
    (1, 128, 4, 3, 128, SMS), (0, 128, 4, 2, 128, SMS), (1, 0, 4, 2, 128, SMS),
    (1, 128, 4, 2, 128, 0)])
def test_plan_raises_for_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        sp.splash_plan(*args)


def test_plan_is_the_kernels_launch():
    """What splash_prefill holds a call to: K12's chunk configuration of the
    core (fa3::ChunkCore) on fa3::run_items, and the plan in launch_args
    order after the scalars; PR 5's FlashAttention-2 loop (flash_attn.cuh)
    is gone from it."""
    text = (CSRC / "splash_prefill.cu").read_text()
    assert "using C = fa3::ChunkCore<D>;" in text and "fa3::run_items<C>(" in text
    assert '#include "flash_sm90.cuh"' in text and "flash_attn.cuh" not in text
    params = re.search(r'extern "C" int splash_prefill\(([^)]*)\)', text).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names[names.index("softcap") + 1:] == ["rows", "keys", "stages", "threads", "gx",
                                                  "gy", "gz", "smem", "stream"]
