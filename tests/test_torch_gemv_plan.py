"""The launch plan of K1 (q4k_q8_gemv) and K2 (q8_0_q8_gemv): row tile,
grid, K split, cluster, column tile, ring stages and workspace bytes, at
every row count up to 256 and the Mistral-7B Q4_K_M main path's projection
shapes. Pure Python: the plan is what the wrappers hand the CUDA entry
points, which check every field of it."""

import dataclasses

import pytest

from mistralrs_tpu_torch.ops import quant_matmul as qm

# (kernel, name, K, O): K1's fused q|k (6144: q|k|v's width; 5120: the main
# path's, whose v is Q6_K), o, gate|up and down; K2's v, the rq8 down and the
# padded lm_head
SHAPES = [("k1", "qk", 4096, 6144), ("k1", "o", 4096, 4096), ("k1", "gate|up", 4096, 28672),
          ("k1", "down", 14336, 4096), ("k2", "v", 4096, 1024), ("k2", "down rq8", 14336, 4096),
          ("k2", "lm_head", 4096, 32768), ("k1", "q|k", 4096, 5120)]


def _align256(n):
    return (n + 255) // 256 * 256


def carve(B, K, O, gs, sum_gs, ksplit, rows, xcopy=False):
    """csrc/common.cuh::carve, written out again for K1, K2, K9 and K10 (row
    tile 16: the decode layout; 64 or 128: tiled): bpad and the pieces xq,
    xs, xsum, xc (K10's bf16 copy of x), partials as {name: (offset,
    bytes)}, and the total."""
    tiled = rows > 16
    bpad = (B + rows - 1) // rows * rows
    pieces, off = {}, 0
    sizes = []
    if gs:
        sizes += [("xq", bpad * K), ("xs", (K // gs) * bpad * 4)]
    if sum_gs:
        sizes.append(("xsum", (K // sum_gs) * bpad * 4))
    if xcopy:
        sizes.append(("xc", bpad * K * 2))
    if tiled and ksplit > 1:
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


def check_decode_plan(B, K, O, k_units, gs, sum_gs, sms, plan, scale_bytes=2):
    """Up to 16 rows: one cluster of the K splits a column tile (within the
    portable limit of 8), each column tile once in the grid, the K splits
    whole ring stages that cover K with none empty, the
    ring's stages as csrc/common.cuh::dec_stages counts them, and no
    partials in the workspace."""
    assert plan.rows == 16 and plan.cols in (64, 128), (B, plan)
    ks, ctiles, one = plan.grid
    assert one == 1 and ctiles == -(-O // plan.cols) and (ctiles - 1) * plan.cols < O, (B, plan)
    assert plan.cluster == plan.ksplit == ks and 1 <= ks <= 8, (B, plan)
    slices = K // 64 if sum_gs else K // 32  # K1: pairs; K2: 32-row slices
    sub = qm.DEC_SUB  # K steps (pairs, or 32-row slices) of a stage
    per = -(-(-(-slices // ks)) // sub) * sub  # whole stages
    assert per == qm.dec_per_split(slices, ks)
    assert (ks - 1) * per < slices <= ks * per, (B, plan)  # no empty split
    step = plan.cols * ((32 + 4 * 2) * sub if sum_gs else (32 * sub + 32 * sub // gs * scale_bytes))
    assert plan.stages == -(-32768 // step), (B, plan)
    assert "part" not in carve(B, K, O, gs, sum_gs, ks, 16)[1]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("kernel,name,K,O", SHAPES)
def test_int8_gemv_plan(kernel, name, K, O, sms):
    gs, sum_gs, k_units = (32, 32, K // 64) if kernel == "k1" else (32, 0, K // 32)
    ctiles = -(-O // 128)
    for B in range(1, 257):
        plan = qm.int8_gemv_plan(B, K, O, k_units, gs, sum_gs, sms)
        assert 1 <= plan.ksplit <= max(1, k_units // 4), (B, plan)
        if B <= 16:
            check_decode_plan(B, K, O, k_units, gs, sum_gs, sms, plan)
        else:
            assert plan.cluster == 1 and plan.cols == 128 and plan.stages == 0, (B, plan)
            assert plan.rows == (64 if B <= 64 else 128), (B, plan)
            rtiles, ct, ks = plan.grid
            # each weight tile is read by at most two blocks, row tiles fastest
            assert ct == ctiles and ks == plan.ksplit
            assert rtiles <= 2 and (rtiles - 1) * plan.rows < B <= rtiles * plan.rows, (B, plan)
            # K is split only to fill one wave of blocks
            assert plan.ksplit == 1 or rtiles * ctiles * plan.ksplit <= sms, (B, plan)
            check_row_tile_reads(B, K, gs, sum_gs, plan)
        assert plan.ws_bytes == carve_bytes(B, K, O, gs, sum_gs, plan.ksplit, plan.rows)


def _check_k2_plans(gs, scale_bytes):
    for K, O in [(14336, 4096), (4096, 1024), (4096, 32768), (1024, 144), (1024, 512)]:
        for B in (1, 3, 8, 9, 16, 17, 64, 65, 200, 256):
            plan = qm.int8_gemv_plan(B, K, O, K // gs, gs, 0, 132, scale_bytes)
            assert plan.ws_bytes == carve_bytes(B, K, O, gs, 0, plan.ksplit, plan.rows)
            if B <= 16:  # splits of whole ring stages
                check_decode_plan(B, K, O, K // gs, gs, 0, 132, plan, scale_bytes)
            else:
                assert 1 <= plan.ksplit <= max(1, K // gs // 4)
                check_row_tile_reads(B, K, gs, 0, plan)


def test_int8_gemv_plan_k2_group_64():
    """K2 at group 64 (rq8 64 with f32 scales, and bf16 scales) at the main
    path's shapes and the tests' tails."""
    for scale_bytes in (4, 2):
        _check_k2_plans(64, scale_bytes)


def test_int8_gemv_plan_k2_group_32_scales():
    """K2 at group 32: rq8's f32 scales and wire Q8_0's bf16 ones."""
    for scale_bytes in (4, 2):
        _check_k2_plans(32, scale_bytes)


def test_decode_plan_fills_the_card_in_one_wave():
    """Up to 16 rows the plan puts about three blocks on every SM, in one
    wave: at the main path's shapes the grid holds between one and three
    blocks an SM, 64-column tiles only where 128-column clusters of 8
    would leave SMs idle (K2's v), and the plan does not depend on B."""
    for sms in (132, 114):
        for kernel, name, K, O in SHAPES:
            sum_gs, k_units = (32, K // 64) if kernel == "k1" else (0, K // 32)
            plans = {qm.int8_gemv_plan(B, K, O, k_units, 32, sum_gs, sms) for B in range(1, 17)}
            assert len(plans) == 1, (name, plans)
            plan = plans.pop()
            blocks = plan.grid[0] * plan.grid[1]
            assert sms * 0.9 <= blocks <= 3 * sms, (name, sms, plan)
            assert plan.cols == (64 if name == "v" else 128), (name, plan)


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


# K9 (q5k_q8_gemv) at the Mistral-7B Q5_K_M main path's Q5_K projections
Q5K_SHAPES = [("qk", 4096, 5120), ("o", 4096, 4096), ("gate|up", 4096, 28672),
              ("down", 14336, 4096)]


def check_rows_grid(B, O, sms, plan):
    """A rows plan's grid: row tiles fastest, each weight tile read by at
    most two blocks, K split only to fill one wave."""
    assert plan.cluster == 1 and plan.cols == 128, (B, plan)
    assert plan.rows == (64 if B <= 64 else 128), (B, plan)
    rtiles, ctiles, ks = plan.grid
    assert ctiles == -(-O // 128) and ks == plan.ksplit, (B, plan)
    assert rtiles <= 2 and (rtiles - 1) * plan.rows < B <= rtiles * plan.rows, (B, plan)
    assert ks == 1 or rtiles * ctiles * ks <= sms, (B, plan)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("name,K,O", Q5K_SHAPES)
def test_q5k_q8_plan(name, K, O, sms):
    """K9: its decode instantiation up to 16 rows (grid (K splits, column
    tiles, 1), a cluster of the splits, each split whole 256-element steps
    and none empty, the ring's stages of the 24 KB step at 128 columns,
    the decode workspace: x's codes of 16 rows, scales and sums per 32, no
    partials), K1's rows plan above, whose K splits take whole groups of 4
    pairs and none is empty at these shapes."""
    groups = K // 256
    for B in range(1, 257):
        plan = qm.q5k_q8_plan(B, K, O, sms)
        ks = plan.ksplit
        assert 1 <= ks <= groups, (B, plan)
        if B <= 16:
            assert plan.rows == 16 and plan.cols in (64, 128), (B, plan)
            assert plan.grid == (ks, -(-O // plan.cols), 1) and plan.cluster == ks <= 8, (B, plan)
            per = qm.dec_per_split(groups, ks, 1)
            assert (ks - 1) * per < groups <= ks * per, (B, plan)
            assert qm.Q5K_STEP_COL_BYTES == 128 + 32 + 2 * 8 * 2
            assert plan.stages == -(-32768 // (plan.cols * 192)), (B, plan)
            bpad, pieces, total = carve(B, K, O, 32, 32, ks, 16)
            assert bpad == 16 and "part" not in pieces and plan.ws_bytes == total, (B, plan)
            assert pieces["xq"][1] == 16 * K and pieces["xsum"][1] == (K // 32) * 16 * 4
            continue
        assert plan == qm.int8_gemv_plan(B, K, O, K // 64, 32, 32, sms)
        check_rows_grid(B, O, sms, plan)
        assert plan.stages == 0
        per = qm.q5k_rows_pairs_per_split(K, ks)
        assert per % 4 == 0 and (ks - 1) * per < K // 64 <= ks * per, (B, plan, per)
        check_row_tile_reads(B, K, 32, 32, plan)
        assert plan.ws_bytes == carve_bytes(B, K, O, 32, 32, ks, plan.rows)


def test_q5k_rows_split_covers_every_pair_once():
    """The pairs of a K split (whole groups of 4, run group by group: step s
    is pair (s % 4) * K/256 + s / 4) cover every sub-block pair once."""
    for K in (256, 1024, 4096, 14336):
        for ks in range(1, K // 256 + 1):
            per = qm.q5k_rows_pairs_per_split(K, ks)
            pairs = [(s % 4) * (K // 256) + s // 4 for z in range(ks)
                     for s in range(z * per, min(K // 64, (z + 1) * per))]
            assert sorted(pairs) == list(range(K // 64)), (K, ks)


# K10 (affine_gemv): the Q2_K path's q|k and gate|up, a GPTQ down
PLANE_SHAPES = [("qk", 4096, 5120), ("gate|up", 4096, 28672), ("down", 14336, 4096)]


def plane_stage_bytes(bits, rows, codes_in_tile=False, scale_bytes=2, parts=1, elems=None):
    """sizeof(PlaneRowStage) of csrc/plane_gemv.cuh written out again: x's
    chunk tiles (rows x the step's elements, bf16), the decoded bf16 tiles
    (the step's elements x 128 columns; two for Q4kFmt's hi and lo parts),
    the byte rows, the scale rows (the planes, or a row a 16 elements, of
    scale_bytes each), rounded up to the struct's 1 KB alignment.
    codes_in_tile: sizeof(Q6kRowStage), whose ql and qh bytes wait in the
    last 6 KB of the decoded tile (no byte rows of its own)."""
    per = 8 // bits
    elems = elems or (32 if bits == 8 else 64)
    size = (rows * elems * 2 + parts * elems * 128 * 2
            + (0 if codes_in_tile else elems // per * 128)
            + max(per, elems // 16) * 128 * scale_bytes)
    return -(-size // 1024) * 1024


def plane_dec_step(bits):
    """csrc/plane_gemv.cuh PlaneDecGeom written out again: (planes of a
    byte row, byte rows of a K step: 64 at 8 bits, 32 below)."""
    return 8 // bits, 64 if bits == 8 else 32


def check_plane_dec_plan(B, K, O, bits, group, sms, plan, scale_bytes=2, zs=True):
    """K8's and K10's decode plan (csrc/plane_gemv.cuh plane_dec_kernel) up
    to 16 rows, as K3's and K4's: one cluster of the K splits a column tile
    (at most 8), each column tile once in the grid, 128 columns a block or
    64 where clusters of the most splits at 128 would leave SMs idle, the
    splits over ceil(Kp / R) steps of R byte rows whole ring stages (a
    stage a step) that cover K with none empty, about three blocks an SM,
    the ring's stages from a stage's most weight bytes (the codes, a scale
    and zs row a 16 elements of every plane), no workspace."""
    per, R = plane_dec_step(bits)
    assert plan.rows == 16 and plan.cols in (64, 128), (B, plan)
    ks, ctiles, one = plan.grid
    assert one == 1 and ctiles == -(-O // plan.cols) and (ctiles - 1) * plan.cols < O, (B, plan)
    assert plan.cluster == plan.ksplit == ks and 1 <= ks <= 8, (B, plan)
    steps = -(-(K // per) // R)
    most = min(8, steps)
    assert plan.cols == (128 if -(-O // 128) * most >= sms else 64), (B, plan)
    assert ks <= most and (ks == 1 or ks * ctiles <= 3 * sms), (B, plan)
    assert ks == most or (ks + 1) * ctiles > 3 * sms or -(-steps // (ks + 1)) == -(-steps // ks)
    per_split = -(-steps // ks)  # a stage a step: whole stages
    assert per_split == qm.dec_per_split(steps, ks, 1)
    assert (ks - 1) * per_split < steps <= ks * per_split, (B, plan)  # no empty split
    weight = plan.cols * R + per * (R // 16) * plan.cols * (scale_bytes + (2 if zs else 0))
    assert plan.stages == -(-32768 // weight) >= 3, (B, plan)
    assert plan.ws_bytes == 0, (B, plan)
    assert (K // per) % group == 0  # every group inside one plane


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("group", [16, 64, 128])
def test_plane_gemv_plan(bits, group, sms):
    """K10: the decode plan up to 16 rows (plane_dec_plan, the same plan at
    every B); above, the rows kernel on a grid whose row tiles run fastest
    (each weight tile read by at most two blocks), K split at zs slices (32
    or 16 groups) only to fill one wave with none empty, at least 3 ring
    stages (a multiple of 3) in 226 KB, and the workspace of carve's tiled
    layout: the per-group sums, x's bf16 copy in the kernel's step order,
    the partials with more than one split."""
    per = 8 // bits
    elems = 32 if bits == 8 else 64
    for name, K, O in PLANE_SHAPES:
        kp = K // per
        assert qm.plane_rows_take(K, bits, group), (name, bits, group)
        slices = -(-(kp * per // elems) // ((32 if elems == 64 else 16) * group // elems))
        dec_plans = set()
        for B in range(1, 257):
            plan = qm.plane_gemv_plan(B, K, O, bits, group, sms)
            ks = plan.ksplit
            if B <= 16:
                check_plane_dec_plan(B, K, O, bits, group, sms, plan)
                assert plan == qm.plane_dec_plan(B, K, O, bits, group, sms)
                dec_plans.add(plan)
                continue
            check_rows_grid(B, O, sms, plan)
            per_split = -(-slices // ks)
            assert (ks - 1) * per_split < slices <= ks * per_split, (B, plan)
            stage = plane_stage_bytes(bits, plan.rows)
            assert plan.stages == min(12, (226 * 1024 - 1024) // stage) // 3 * 3 >= 3, (B, plan)
            bpad, pieces, total = carve(B, K, O, 0, group, ks, plan.rows, xcopy=True)
            assert plan.grid[0] * plan.rows <= bpad, (B, plan)
            assert pieces["xsum"] == (0, (K // group) * bpad * 4)
            assert pieces["xc"][1] == bpad * K * 2
            assert ("part" in pieces) == (ks > 1) and plan.ws_bytes == total, (B, plan)
        assert len(dec_plans) == 1, (name, dec_plans)


# K10's decode plan at the shapes affine_qmatmul sends it: Q2_K q|k and
# gate|up (group 16), GPTQ-8 down and gate|up (group 128), GPTQ-8 per
# channel at Mistral's down (group = K = 14336, not a power of two), HQQ-1
# (group 64), and groups that start inside a step (48)
K10_DEC_SHAPES = [(2, 16, 4096, 5120), (2, 16, 4096, 28672), (8, 128, 14336, 4096),
                  (8, 128, 4096, 28672), (8, 14336, 14336, 4096), (1, 64, 4096, 28672),
                  (8, 48, 4608, 4096), (4, 48, 3072, 272), (8, 1056, 1056, 272)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("bits,group,K,O", K10_DEC_SHAPES)
def test_plane_dec_plan(bits, group, K, O, sms):
    """K10's decode plan at 1-16 rows: the same plan at every B, checked
    field by field; a per-channel GPTQ-8 group (14336) and a group of 48
    take it as a power-of-two group does."""
    plans = set()
    for B in range(1, 17):
        plan = qm.plane_gemv_plan(B, K, O, bits, group, sms)
        check_plane_dec_plan(B, K, O, bits, group, sms, plan)
        plans.add(plan)
    assert len(plans) == 1, plans


@pytest.mark.parametrize("bits,group,K", [(1, 128, 512), (2, 48, 4096), (4, 96, 1024),
                                          (8, 48, 4096)])
def test_plane_dec_plan_raises_for_a_group_across_two_planes(bits, group, K):
    """A group that straddles two planes ((K/(8/bits)) % group != 0) has no
    box of [planes][Kp/group][O]: the decode plan raises (affine_qmatmul
    sends no such shape to K10); it also takes 1-16 rows only."""
    with pytest.raises(ValueError, match="inside one plane"):
        qm.plane_gemv_plan(4, K, 256, bits, group, 132)
    with pytest.raises(ValueError):
        qm.plane_dec_plan(17, 4096, 256, 2, 16, 132)


def test_plane_dec_rows_counts_the_groups_a_step_touches():
    """The scale rows a plane of a decode step's box (csrc/plane_gemv.cuh
    plane_dec_rows): the most groups R rows starting at a multiple of 16
    inside a group can touch, found by walking every start."""
    for bits in (1, 2, 4, 8):
        _, R = plane_dec_step(bits)
        for group in range(16, 400, 16):
            most = max((rem + R - 1) // group + 1 for rem in range(0, group, 16)
                       if R % group or rem == 0)
            if group % R == 0:
                most = 1
            assert qm.plane_dec_rows(bits, group) == most <= R // 16, (bits, group)


def test_plane_rows_take_and_the_row_rule():
    """The rows kernel takes a group that lies inside one plane and is a
    power of two; at 16 rows the plan is the 16-row kernel's, at 17 the
    rows kernel's."""
    assert qm.plane_rows_take(4096, 2, 16) and qm.plane_rows_take(4096, 8, 128)
    assert qm.plane_rows_take(4096, 8, 4096)  # per-channel GPTQ-8 at a power-of-two width
    assert not qm.plane_rows_take(512, 1, 128)  # 64 byte rows: a group spans two planes
    assert not qm.plane_rows_take(4608, 4, 48)  # not a power of two
    assert not qm.plane_rows_take(14336, 8, 14336)  # per-channel at Mistral's down width
    assert qm.plane_gemv_plan(16, 4096, 28672, 2, 16, 132).rows == 16
    assert qm.plane_gemv_plan(17, 4096, 28672, 2, 16, 132).rows == 64


# K3 (q6k_q8_gemv) and K4 (q6k_bf16_gemv) at the Q5_K_M path's Q6_K
# projections: v, the use_more_bits down, the padded lm_head
Q6K_SHAPES = [("v", 4096, 1024), ("down", 14336, 4096), ("lm_head", 4096, 32768)]


def check_q6k_decode_plan(B, K, O, G, sms, plan, ws_bytes):
    """K3's and K4's decode plan (csrc/q6k_gemv.cu) up to 16 rows: one
    cluster of the K splits a column tile (at most 8), each column tile
    once in the grid, 128 columns a block or 64 where clusters of the most
    splits at 128 would leave SMs idle, the splits over K/128 steps of 128
    elements whole ring stages (a stage a step) that cover K with none
    empty, about three blocks an SM, dec_stages(112 bytes a column) ring
    stages, and the workspace given (K3: the decode carve; K4: none)."""
    assert plan.rows == 16 and plan.cols in (64, 128), (B, plan)
    ks, ctiles, one = plan.grid
    assert one == 1 and ctiles == -(-O // plan.cols) and (ctiles - 1) * plan.cols < O, (B, plan)
    assert plan.cluster == plan.ksplit == ks and 1 <= ks <= 8, (B, plan)
    steps = K // 128
    most = min(8, steps)
    assert plan.cols == (128 if -(-O // 128) * most >= sms else 64), (B, plan)
    # as many splits as put about three blocks on an SM, at most `most`
    assert ks <= most and (ks == 1 or ks * ctiles <= 3 * sms), (B, plan)
    assert ks == most or (ks + 1) * ctiles > 3 * sms or -(-steps // (ks + 1)) == -(-steps // ks)
    per = -(-steps // ks)  # a stage a step: whole stages
    assert per == qm.dec_per_split(steps, ks, qm.Q6K_DEC_SUB) and qm.Q6K_DEC_SUB == 1
    assert (ks - 1) * per < steps <= ks * per, (B, plan)  # no empty split
    assert plan.stages == -(-32768 // (112 * plan.cols)) == (3 if plan.cols == 128 else 5)
    assert plan.ws_bytes == ws_bytes, (B, plan)
    assert K % (4 * G) == 0 and G % 32 == 0  # every step lies in one chunk


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("G", [128, 512])
def test_q6k_q8_plan(G, sms):
    """K3: the decode plan at 1-16 rows, the workspace of carve's decode
    layout with the per-16 sums (x's codes of 16 rows, xs per 32, xsum16;
    no partials), the same plan at every B."""
    for name, K, O in Q6K_SHAPES:
        plans = set()
        for B in range(1, 17):
            plan = qm.q6k_q8_plan(B, K, O, G, sms)
            bpad, pieces, total = carve(B, K, O, 32, 16, plan.ksplit, 16)
            assert bpad == 16 and pieces["xq"] == (0, 16 * K), (name, B)
            assert pieces["xsum"][1] == (K // 16) * 16 * 4 and "part" not in pieces
            check_q6k_decode_plan(B, K, O, G, sms, plan, total)
            plans.add(plan)
        assert len(plans) == 1, (name, plans)


@pytest.mark.parametrize("B", [17, 64, 256])
def test_q6k_q8_plan_raises_above_16_rows(B):
    """K3 runs at up to 16 rows only, as the JAX package routes it."""
    with pytest.raises(ValueError):
        qm.q6k_q8_plan(B, 4096, 1024, 512, 132)


@pytest.mark.parametrize("G", [32, 96, 384])
def test_q6k_decode_plan_takes_any_span_of_whole_steps(G):
    """A step is 32 t of one chunk, so the decode kernels take any span G
    that is a multiple of 32; another span is refused."""
    K = 4 * G * 4
    for plan_fn in (qm.q6k_q8_plan, qm.q6k_bf16_plan):
        assert plan_fn(16, K, 272, G, 132).rows == 16
        with pytest.raises(ValueError):
            plan_fn(16, 4 * 48 * 4, 272, 48, 132)


def test_q6k_decode_plan_fills_the_card_in_one_wave():
    """At the main path's shapes: v in 16 column tiles of 64 with clusters
    of 8 (128 blocks), down in 32 tiles of 128 with 8 (256), the lm_head in
    256 tiles of 128 with one split (256): between 0.9 and 3 blocks an SM,
    in one wave of three a SM."""
    want = {"v": ((8, 16, 1), 64), "down": ((8, 32, 1), 128), "lm_head": ((1, 256, 1), 128)}
    for name, K, O in Q6K_SHAPES:
        for plan in (qm.q6k_q8_plan(16, K, O, 512, 132), qm.q6k_bf16_plan(16, K, O, 512, 132)):
            assert (plan.grid, plan.cols) == want[name], (name, plan)
            blocks = plan.grid[0] * plan.grid[1]
            assert 132 * 0.9 <= blocks <= 3 * 132, (name, plan)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("G", [128, 512])
def test_q6k_bf16_plan(G, sms):
    """K4: its decode instantiation up to 16 rows (K3's decode plan, no
    workspace: x goes in by TMA as it is); above, the rows kernel on K10's
    2-bit grid (K split at slices of 128 r, only to fill one wave, none
    empty), Q6_K's ring stages (9 at 64 rows, 6 at 128) and carve's tiled
    workspace: the per-16 sums, x's copy in step order, the partials with
    more than one split."""
    for name, K, O in Q6K_SHAPES:
        assert qm.q6k_rows_take(K, G), (name, G)
        slices = K // 4 // 128
        for B in range(1, 257):
            plan = qm.q6k_bf16_plan(B, K, O, G, sms)
            ks = plan.ksplit
            if B <= 16:
                check_q6k_decode_plan(B, K, O, G, sms, plan, 0)
                assert plan == dataclasses.replace(qm.q6k_q8_plan(B, K, O, G, sms), ws_bytes=0)
                continue
            check_rows_grid(B, O, sms, plan)
            per_split = -(-slices // ks)
            assert (ks - 1) * per_split < slices <= ks * per_split, (B, plan)
            stage = plane_stage_bytes(2, plan.rows, codes_in_tile=True)
            assert plan.stages == min(12, (226 * 1024 - 1024) // stage) // 3 * 3, (B, plan)
            assert plan.stages == (9 if plan.rows == 64 else 6), (B, plan)
            bpad, pieces, total = carve(B, K, O, 0, 16, ks, plan.rows, xcopy=True)
            assert plan.grid[0] * plan.rows <= bpad, (B, plan)
            assert pieces["xsum"] == (0, (K // 16) * bpad * 4)
            assert pieces["xc"][1] == bpad * K * 2
            assert ("part" in pieces) == (ks > 1) and plan.ws_bytes == total, (B, plan)


def test_q6k_bf16_plan_splits_k_to_fill_a_wave():
    """attn_v's 8 column tiles and down's 32 leave SMs idle without a K
    split; the lm_head's 256 fill the card without one."""
    assert qm.q6k_bf16_plan(256, 4096, 1024, 512, 132).grid == (2, 8, 8)
    assert qm.q6k_bf16_plan(64, 4096, 1024, 512, 132).grid == (1, 8, 8)
    assert qm.q6k_bf16_plan(256, 14336, 4096, 512, 132).grid == (2, 32, 2)
    assert qm.q6k_bf16_plan(64, 14336, 4096, 512, 132).grid == (1, 32, 4)
    assert qm.q6k_bf16_plan(256, 4096, 32768, 512, 132).grid == (2, 256, 1)


@pytest.mark.parametrize("sms", [132, 114])
def test_q5k_hbit_bf16_plan(sms):
    """K9b's high-bit kernel: up to 16 rows none (the whole Q5_K product is
    one kernel there, q5k_bf16_plan), so the plan raises; above, the rows
    kernel at one bit without the zs term: K split at 4 main steps (K/256
    units), only to fill one wave and none empty, the ring stages of the
    1-bit stage, and a tiled workspace with x's copy in step order but no
    sums."""
    for name, K, O in Q5K_SHAPES:
        units = K // 256
        for B in range(1, 257):
            if B <= 16:
                with pytest.raises(ValueError):
                    qm.q5k_hbit_bf16_plan(B, K, O, sms)
                continue
            plan = qm.q5k_hbit_bf16_plan(B, K, O, sms)
            ks = plan.ksplit
            assert 1 <= ks <= units, (B, plan)
            assert plan == qm.plane_gemv_plan(B, K, O, 1, 32, sms, zs=False)
            check_rows_grid(B, O, sms, plan)
            per_split = -(-units // ks)
            assert (ks - 1) * per_split < units <= ks * per_split, (B, plan)
            stage = plane_stage_bytes(1, plan.rows)
            assert plan.stages == min(12, (226 * 1024 - 1024) // stage) // 3 * 3 == 6, (B, plan)
            bpad, pieces, total = carve(B, K, O, 0, 0, ks, plan.rows, xcopy=True)
            assert "xsum" not in pieces and pieces["xc"] == (0, bpad * K * 2)
            assert ("part" in pieces) == (ks > 1) and plan.ws_bytes == total, (B, plan)


def test_plane_slice_steps_without_the_zs_term():
    """Without the zs term (K9b) a K split's unit is 4 main steps at every
    width and group."""
    for bits in (1, 2, 4, 8):
        for group in (16, 32, 64, 128):
            assert qm.plane_slice_steps(bits, group, zs=False) == 4
    assert qm.plane_slice_steps(1, 32) == 16 and qm.plane_slice_steps(2, 16) == 8


@pytest.mark.parametrize("sms", [132, 114])
def test_q4k_bf16_plan(sms):
    """K5: K10's 4-bit decode plan at group 32 up to 16 rows (grid (K
    splits, column tiles, 1), a cluster of the splits over K/64 steps of 32
    byte rows, the ring stages of a 4-bit stage, no workspace); above, the
    rows kernel on
    K10's 4-bit grid at group 32 (K split at zs slices of 16 main steps,
    only to fill one wave, none empty), the ring stages of a stage with two
    decoded tiles (32-element steps: 6 at 128 rows, 9 at 64) and carve's
    tiled workspace: the
    per-32 sums, x's copy in step order, the partials with more than one
    split."""
    E = qm.Q4K_ROW_ELEMS
    for name, K, O in Q5K_SHAPES:
        assert qm.plane_rows_take(K, 4, 32), name
        slices = -(-(K // E) // (32 * 32 // E if E == 64 else 16))
        for B in range(1, 257):
            plan = qm.q4k_bf16_plan(B, K, O, sms)
            ks = plan.ksplit
            if B <= 16:
                assert plan == qm.plane_dec_plan(B, K, O, 4, 32, sms), (B, plan)
                assert plan.rows == 16 and plan.grid == (ks, -(-O // plan.cols), 1), (B, plan)
                assert plan.cluster == ks <= 8 and plan.ws_bytes == 0, (B, plan)
                per = qm.dec_per_split(K // 64, ks, 1)
                assert (ks - 1) * per < K // 64 <= ks * per, (B, plan)
                assert plan.stages == -(-32768 // (plan.cols * (32 + 2 * 2 * 2 * 2))), (B, plan)
                continue
            assert plan == qm.plane_gemv_plan(B, K, O, 4, 32, sms, parts=2, elems=E)
            check_rows_grid(B, O, sms, plan)
            per_split = -(-slices // ks)
            assert 1 <= ks and (ks - 1) * per_split < slices <= ks * per_split, (B, plan)
            stage = plane_stage_bytes(4, plan.rows, parts=2, elems=E)
            assert plan.stages == min(12, (226 * 1024 - 1024) // stage) // 3 * 3, (B, plan)
            assert plan.stages == (9 if plan.rows == 64 else 6), (B, plan)
            bpad, pieces, total = carve(B, K, O, 0, 32, ks, plan.rows, xcopy=True)
            assert plan.grid[0] * plan.rows <= bpad, (B, plan)
            assert pieces["xsum"] == (0, (K // 32) * bpad * 4)
            assert pieces["xc"][1] == bpad * K * 2
            assert ("part" in pieces) == (ks > 1) and plan.ws_bytes == total, (B, plan)


# K8 at the Q4_K_M path's rq8 projections (v, the use_more_bits down, the
# padded lm_head), wire Q8_0's lm_head, and an int8 weight at q|k and
# gate|up (the kernel phase's)
Q8_SHAPES = [("v", 4096, 1024, True), ("down", 14336, 4096, True),
             ("lm_head", 4096, 32768, True), ("lm_head wire", 4096, 32768, False),
             ("qk", 4096, 5120, True), ("gate|up wire", 4096, 28672, False)]


@pytest.mark.parametrize("sms", [132, 114])
def test_q8_0_bf16_plan(sms):
    """K8: the decode plan up to 16 rows (K10's at 8 bits, group 32, no zs
    term, the ring's stages at the scale's width; the same plan at every
    B); above, the rows kernel at 8 bits without the zs term (K split at 4
    main steps, only to fill one wave, none empty), the ring stages of its
    stage at the scale's width, and a tiled workspace with neither sums nor
    a copy of x (read in place): the partials with more than one split,
    else nothing."""
    E = qm.plane_row_geom(8)[1]
    for name, K, O, f32 in Q8_SHAPES:
        units = -(-(K // E) // 4)
        dec_plans = set()
        for B in range(1, 257):
            plan = qm.q8_0_bf16_plan(B, K, O, f32, sms)
            ks = plan.ksplit
            if B <= 16:
                check_plane_dec_plan(B, K, O, 8, 32, sms, plan, 4 if f32 else 2, zs=False)
                dec_plans.add(plan)
                continue
            check_rows_grid(B, O, sms, plan)
            per_split = -(-units // ks)
            assert 1 <= ks and (ks - 1) * per_split < units <= ks * per_split, (B, plan)
            stage = plane_stage_bytes(8, plan.rows, scale_bytes=4 if f32 else 2, elems=E)
            assert plan.stages == min(12, (226 * 1024 - 1024) // stage) // 3 * 3 >= 3, (B, plan)
            bpad, pieces, total = carve(B, K, O, 0, 0, ks, plan.rows)
            assert set(pieces) == ({"part"} if ks > 1 else set()), (B, plan)
            assert plan.ws_bytes == total, (B, plan)
        assert len(dec_plans) == 1, (name, dec_plans)


def test_k8_k10_decode_plans_at_the_main_path_shapes():
    """At 16 rows on 132 SMs: the grids, column widths and ring stages the
    card runs (K8's v in 16 column tiles of 64 with clusters of 8, down and
    q|k in clusters of 8 of 128 columns, gate|up and the lm_head unsplit;
    K10's Q2_K as K8's 8-bit shapes of the same width; 7 stages at 64
    columns, 4 at 128 but for 4 bits (6) and 1 bit (3))."""
    want = {("v", True): ((8, 16, 1), 64, 7), ("down", True): ((8, 32, 1), 128, 4),
            ("qk", True): ((8, 40, 1), 128, 4), ("gate|up", True): ((1, 224, 1), 128, 4),
            ("lm_head", True): ((1, 256, 1), 128, 4), ("lm_head", False): ((1, 256, 1), 128, 4)}
    shapes = {"v": (4096, 1024), "down": (14336, 4096), "qk": (4096, 5120),
              "gate|up": (4096, 28672), "lm_head": (4096, 32768)}
    for (name, f32), (grid, cols, stages) in want.items():
        plan = qm.q8_0_bf16_plan(16, *shapes[name], f32, 132)
        assert (plan.grid, plan.cols, plan.stages) == (grid, cols, stages), (name, plan)
    want = {(2, 16, 4096, 5120): ((8, 40, 1), 4), (2, 16, 4096, 28672): ((1, 224, 1), 4),
            (8, 128, 14336, 4096): ((8, 32, 1), 4), (8, 14336, 14336, 4096): ((8, 32, 1), 4),
            (4, 16, 4096, 28672): ((1, 224, 1), 6), (1, 64, 4096, 28672): ((1, 224, 1), 3)}
    for (bits, group, K, O), (grid, stages) in want.items():
        plan = qm.plane_gemv_plan(16, K, O, bits, group, 132)
        assert (plan.grid, plan.cols, plan.stages) == (grid, 128, stages), (bits, group, plan)


def test_k5_k8_rows_plans_at_the_main_path_shapes():
    """At 17, 64, 128 and 256 rows on 132 SMs: the grids, splits and ring
    stages the card runs (K5's gate|up and q|k fill the card unsplit at 256
    rows, o and down split; K8's lm_head unsplit, v in 8 or 16)."""
    want = {  # (B, K, O) -> grid, stages
        (17, 4096, 28672): ((1, 224, 1), 9), (256, 4096, 28672): ((2, 224, 1), 6),
        (256, 4096, 5120): ((2, 40, 1), 6), (64, 4096, 5120): ((1, 40, 3), 9),
        (256, 4096, 4096): ((2, 32, 2), 6), (128, 14336, 4096): ((1, 32, 4), 6)}
    for (B, K, O), (grid, stages) in want.items():
        plan = qm.q4k_bf16_plan(B, K, O, 132)
        assert (plan.grid, plan.stages) == (grid, stages), (B, K, O, plan)
    want = {(256, 4096, 32768): ((2, 256, 1), 9), (64, 4096, 32768): ((1, 256, 1), 12),
            (256, 4096, 1024): ((2, 8, 8), 9), (17, 4096, 1024): ((1, 8, 16), 12),
            (256, 14336, 4096): ((2, 32, 2), 9)}
    for (B, K, O), (grid, stages) in want.items():
        plan = qm.q8_0_bf16_plan(B, K, O, True, 132)
        assert (plan.grid, plan.stages) == (grid, stages), (B, K, O, plan)


def test_plane_stage_counts_the_scale_width():
    """The stage holds its scale rows at their own width: rq8's f32 scales
    take twice the bytes of bf16 ones (the rows kernel's sizeof, which the
    plan's stage count must match, or the C entry point refuses the
    plan)."""
    for rows in (64, 128):
        for elems in (32, 64):
            f32 = qm.plane_row_stage_bytes(8, rows, 4, elems=elems)
            bf16 = qm.plane_row_stage_bytes(8, rows, 2, elems=elems)
            assert f32 == plane_stage_bytes(8, rows, scale_bytes=4, elems=elems)
            assert bf16 == plane_stage_bytes(8, rows, scale_bytes=2, elems=elems)
            assert f32 - bf16 == (1024 if elems == 64 else 0), (rows, elems)
    assert qm.plane_row_stage_bytes(8, 128, 4, elems=64) == 43008  # 42 KB: 3 stages
    assert qm.plane_row_stages(8, 64, 4, elems=64) == 6
    assert qm.plane_row_stages(4, 128, parts=2) == 3 and qm.plane_row_stages(4, 128) == 6
    assert qm.plane_row_stages(4, 128, parts=2, elems=32) == 6


def test_k5_k8_take_their_plans_and_the_64_row_tiles_are_gone():
    """Nothing sizes the 16-row design's 64-row tiles any more, and each
    wrapper names both of its instantiations (K5's and K8's decode one:
    plane_dec_kernel)."""
    assert not hasattr(qm, "_plane_rows")
    for fn, small in ((qm.q4k_bf16_gemv, "decode instantiation (plane_dec_kernel"),
                      (qm.q8_0_bf16_gemv, "decode instantiation (plane_dec_kernel")):
        doc = " ".join(fn.__doc__.split())
        assert small in doc and "rows instantiation" in doc, fn
        assert "plane_rows_kernel" in doc, fn
    assert qm.q4k_bf16_plan(16, 4096, 28672, 132).rows == 16
    assert qm.q4k_bf16_plan(17, 4096, 28672, 132).rows == 64
    assert qm.q8_0_bf16_plan(16, 4096, 32768, True, 132).rows == 16
    assert qm.q8_0_bf16_plan(17, 4096, 32768, True, 132).rows == 64


def test_k5_k9_decode_plans_at_the_main_path_shapes():
    """At 1-16 rows on 132 SMs, the Q5_K projections' decode plans the card
    runs: q|k, o and down in clusters of 8 K splits, gate|up unsplit (224
    column tiles of 128 fill the card), 128 columns a block everywhere; K5
    on 4-bit 32-byte-row steps (K/64 of them, 6 stages), K9 on 256-element
    steps (K/256, 2 stages of 24 KB at 128 columns); no workspace for K5,
    K9's decode layout (no partials) for K9; neither plan depends on B."""
    want = {  # (K, O) -> K5's grid, K9's grid
        (4096, 5120): ((8, 40, 1), (8, 40, 1)), (4096, 4096): ((8, 32, 1), (8, 32, 1)),
        (4096, 28672): ((1, 224, 1), (1, 224, 1)), (14336, 4096): ((8, 32, 1), (8, 32, 1))}
    for (K, O), (g5, g9) in want.items():
        k5 = {qm.q4k_bf16_plan(B, K, O, 132) for B in range(1, 17)}
        k9 = {dataclasses.replace(qm.q5k_q8_plan(B, K, O, 132), ws_bytes=0) for B in range(1, 17)}
        assert len(k5) == len(k9) == 1, (K, O)
        p5, p9 = k5.pop(), k9.pop()
        assert (p5.grid, p5.cluster, p5.cols, p5.stages, p5.ws_bytes) == (g5, g5[0], 128, 6, 0)
        assert (p9.grid, p9.cluster, p9.cols, p9.stages) == (g9, g9[0], 128, 2)
        for B in (1, 16):
            ws = qm.q5k_q8_plan(B, K, O, 132).ws_bytes
            assert ws == carve(B, K, O, 32, 32, g9[0], 16)[2] == _align256(16 * K) + 2 * _align256(
                (K // 32) * 16 * 4)
