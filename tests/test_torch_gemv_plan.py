"""The launch plan of K1 (q4k_q8_gemv) and K2 (q8_0_q8_gemv): row tile,
grid, K split and workspace bytes, at every row count up to 256 and the
Mistral-7B Q4_K_M main path's projection shapes. Pure Python: the plan is
what the wrappers hand the CUDA entry points."""

import pytest

from mistralrs_tpu_torch.ops import quant_matmul as qm

# (kernel, name, K, O): K1's fused q|k, o, gate|up and down; K2's v, the
# rq8 down and the padded lm_head
SHAPES = [("k1", "qk", 4096, 6144), ("k1", "o", 4096, 4096), ("k1", "gate|up", 4096, 28672),
          ("k1", "down", 14336, 4096), ("k2", "v", 4096, 1024), ("k2", "down rq8", 14336, 4096),
          ("k2", "lm_head", 4096, 32768)]


def _align256(n):
    return (n + 255) // 256 * 256


def carve(B, K, O, gs, sum_gs, ksplit, rows):
    """csrc/common.cuh::carve, written out again: bpad and the pieces xq, xs,
    xsum, partials as {name: (offset, bytes)}, and the total."""
    tiled = rows > 16
    bpad = (B + rows - 1) // rows * rows
    pieces, off = {}, 0
    sizes = []
    if gs:
        sizes += [("xq", (bpad if tiled else B) * K), ("xs", (K // gs) * bpad * 4)]
    if sum_gs:
        sizes.append(("xsum", (K // sum_gs) * bpad * 4))
    if not tiled or ksplit > 1:
        sizes.append(("part", ksplit * B * O * 4))
    for name, n in sizes:
        pieces[name] = (off, n)
        off += _align256(n)
    return bpad, pieces, off


def carve_bytes(B, K, O, gs, sum_gs, ksplit, rows):
    return carve(B, K, O, gs, sum_gs, ksplit, rows)[2]


def check_row_tile_reads(B, K, gs, sum_gs, plan):
    """Every bulk copy of a rows block (x's codes of a 32-element slice, xs
    of a group, xsum of a sub-block, for its `rows` rows) lies inside its
    piece of the workspace, down to the last row tile on the last slice."""
    bpad, pieces, total = carve(B, K, 0, gs, sum_gs, plan.ksplit, plan.rows)
    rtiles = plan.grid[0]
    assert bpad >= rtiles * plan.rows, (B, plan)
    last = (rtiles - 1) * plan.rows  # first row of the last row tile
    reads = [("xq", (K // 32 - 1) * bpad * 32 + last * 32, plan.rows * 32),
             ("xs", (K // gs - 1) * bpad * 4 + last * 4, plan.rows * 4)]
    if sum_gs:
        reads.append(("xsum", (K // sum_gs - 1) * bpad * 4 + last * 4, plan.rows * 4))
    for name, start, n in reads:
        off, size = pieces[name]
        assert start + n <= size and off + size <= total, (name, B, plan)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("kernel,name,K,O", SHAPES)
def test_int8_gemv_plan(kernel, name, K, O, sms):
    gs, sum_gs, k_units = (32, 32, K // 64) if kernel == "k1" else (32, 0, K // 32)
    ctiles = -(-O // 128)
    for B in range(1, 257):
        plan = qm.int8_gemv_plan(B, K, O, k_units, gs, sum_gs, sms)
        assert 1 <= plan.ksplit <= max(1, k_units // 4), (B, plan)
        if B <= 16:
            assert plan.rows == 16
            assert plan.grid == (ctiles, plan.ksplit, 1)
        else:
            assert plan.rows == (64 if B <= 64 else 128), (B, plan)
            rtiles, ct, ks = plan.grid
            # each weight tile is read by at most two blocks, row tiles fastest
            assert ct == ctiles and ks == plan.ksplit
            assert rtiles <= 2 and (rtiles - 1) * plan.rows < B <= rtiles * plan.rows, (B, plan)
            # K is split only to fill one wave of blocks
            assert plan.ksplit == 1 or rtiles * ctiles * plan.ksplit <= sms, (B, plan)
            check_row_tile_reads(B, K, gs, sum_gs, plan)
        assert plan.ws_bytes == carve_bytes(B, K, O, gs, sum_gs, plan.ksplit, plan.rows)


def test_int8_gemv_plan_k2_group_64():
    K, O = 14336, 4096
    for B in (1, 16, 17, 64, 65, 200, 256):
        plan = qm.int8_gemv_plan(B, K, O, K // 64, 64, 0, 132)
        assert 1 <= plan.ksplit <= K // 64 // 4
        assert plan.ws_bytes == carve_bytes(B, K, O, 64, 0, plan.ksplit, plan.rows)
        if B > 16:
            check_row_tile_reads(B, K, 64, 0, plan)


def test_decode_plan_is_the_earlier_split():
    """Up to 16 rows the plan keeps the decode kernel's split of before."""
    for B in (1, 5, 16):
        for kernel, _, K, O in SHAPES:
            k_units = K // 64 if kernel == "k1" else K // 32
            plan = qm.int8_gemv_plan(B, K, O, k_units, 32, 32 if kernel == "k1" else 0, 132)
            assert plan.ksplit == qm._ksplit_for(O, B, k_units, 132)


@pytest.mark.parametrize("B", [129, 150, 192])
def test_row_tiles_of_128_pad_the_workspace(B):
    """Between 129 and 192 rows the second 128-row tile reaches past B
    rounded up to 64: the workspace pads x's rows to the tile, and the
    one-split shapes (no partials after x's pieces) keep every read inside."""
    for kernel, _, K, O in SHAPES:
        gs, sum_gs, k_units = (32, 32, K // 64) if kernel == "k1" else (32, 0, K // 32)
        plan = qm.int8_gemv_plan(B, K, O, k_units, gs, sum_gs, 132)
        assert plan.rows == 128 and plan.grid[0] == 2
        check_row_tile_reads(B, K, gs, sum_gs, plan)
        bpad = carve(B, K, O, gs, sum_gs, plan.ksplit, plan.rows)[0]
        assert bpad == 256
