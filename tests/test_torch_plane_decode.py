"""The decode instantiation of K8 (q8_0_bf16_gemv), K10 (affine_gemv) and K5
(q4k_bf16_gemv) at 1-16 rows, csrc/plane_gemv.cuh plane_dec_kernel, walked
on the CPU: the
plan's clusters of K splits, each split's steps of R byte rows (64 at 8
bits, 32 below), the boxes of a step (q as [Kp][O]; scale and zs seen as
[planes][Kp/group][O], nr rows a plane from the step's first group; x seen
as [B][planes][Kp]), the walk that finds each 16 rows' scale row, the
weight pairs' bit tricks (prmt, the sign-extended select, one bf16 fma)
and the zs term as a second product with -zs, added over the cluster in
rank order, against the plain versions; for K5 (Q4kFmt, kScaleOnAcc) the
raw nibbles as the A operand, each 32-row group's fresh dots times the
column's scale on the sums, and the min term as x's group sums (an
all-ones product) times -minv. The kernel itself runs only on the
card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from mistralrs_tpu_torch.ops import quant_matmul as qm

ROWS = 16  # the decode tile's rows (mrt::kDecRows)


# ---- the weight pairs, bit by bit ----


def prmt(a, b, sel):
    """PTX prmt.b32 in its default mode on uint32 arrays: byte i of the
    result is byte (sel_i & 7) of (b:a), or that byte's sign bit replicated
    when sel_i & 8 (the mode __byte_perm leaves out)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    src = a | (b << np.uint64(32))
    out = np.zeros(np.broadcast(a, b).shape, dtype=np.uint64)
    for i in range(4):
        nib = (sel >> (4 * i)) & 0xF
        byte = (src >> np.uint64(8 * (nib & 7))) & np.uint64(0xFF)
        if nib & 8:
            byte = np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32)


def bf16_bits_to_f64(h):
    return (np.asarray(h, dtype=np.uint32) << np.uint32(16)).view(np.float32).astype(np.float64)


def round_bf16(v):
    """An exact value (at most 24 significant bits, so exact in f32) rounded
    once to bf16, as the bits of the result."""
    t = torch.from_numpy(np.asarray(v, dtype=np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF


def fma_bf16x2(a, b, c):
    """fma.rn.bf16x2 on uint32 pairs: a * b + c exactly, rounded once a half
    (every product and sum here is exact in f64)."""
    out = np.zeros(np.broadcast(np.asarray(a), np.asarray(b), np.asarray(c)).shape, dtype=np.uint32)
    for sh in (0, 16):
        f = [bf16_bits_to_f64((np.asarray(w, dtype=np.uint32) >> np.uint32(sh)) & 0xFFFF)
             for w in (a, b, c)]
        out |= round_bf16(f[0] * f[1] + f[2]) << np.uint32(sh)
    return out


def dec_code_pairs(cw, sp, bits, signed):
    """mrt::dec_code_pairs: the (lo, hi) A words of a code word cw (K rows
    4t..4t+3 in bytes 0..3) for the scale pair sp = (s, s)."""
    n128 = fma_bf16x2(sp, 0xC300C300, 0x80008000)
    n256 = fma_bf16x2(sp, 0xC380C380, 0x80008000)
    if bits < 8:
        return (fma_bf16x2(prmt(cw, 0x43, 0x4140), sp, n128),
                fma_bf16x2(prmt(cw, 0x43, 0x4342), sp, n128))
    low7 = cw & np.uint32(0x7F7F7F7F)
    words = []
    for sel, sext in ((0x4140, 0x9988), (0x4342, 0xBBAA)):
        top = prmt(cw, 0, sext)
        add = (top & n256) | (~top & n128) if signed else ~top & n128
        words.append(fma_bf16x2(prmt(low7, 0x43, sel), sp, add))
    return tuple(words)


def pair_values(words):
    """The 4 bf16 values of (lo, hi) words in K order (rows 4t..4t+3)."""
    lo, hi = words
    return np.stack([lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16], axis=-1)


SPREAD = np.concatenate([
    np.float32([0.001, 0.0042, -0.0031, 1.0, -1.0, 3.0e-4, 2.5e-38, -1.2e-38, 9.0e-41, 6.0e4,
                -1.5e33, 0.0]),
    np.random.default_rng(0).standard_normal(500).astype(np.float32) * 0.01,
    np.exp(np.random.default_rng(1).uniform(-80, 80, 500)).astype(np.float32)])


@pytest.mark.parametrize("bits,signed", [(8, True), (8, False), (4, False), (2, False),
                                         (1, False)])
def test_weight_pairs_are_bit_equal_to_the_plain_product(bits, signed):
    """Every code of `bits` bits (all 256 bytes at 8 bits, K8's signed and
    K10's unsigned) against a spread of bf16 scales (tiny, subnormal, large,
    negative, zero): the kernel's pair, built from prmt, the sign-extended
    select and one fma.rn.bf16x2, has the bits of bf16(c * bf16(s)) (up to
    the sign of a zero product), the plain version's weight."""
    n = 1 << bits
    codes = np.arange(n, dtype=np.uint32)
    c = codes.astype(np.int64) - 256 * (codes >= 128) if signed else codes.astype(np.int64)
    s_bits = round_bf16(SPREAD)  # rq8's f32 scale rounded to bf16 as read
    # word k holds codes k, k+1, k+2, k+3 (mod n), its bytes in K order
    words = np.stack([codes[(np.arange(n) + i) % n] for i in range(4)], axis=-1)
    cw = (words[:, 0] | (words[:, 1] << 8) | (words[:, 2] << 16) | (words[:, 3] << 24))
    sp = s_bits | (s_bits << 16)
    got = pair_values(dec_code_pairs(cw[:, None].astype(np.uint32), sp[None, :], bits, signed))
    s = torch.from_numpy(s_bits.astype(np.int32).astype(np.int16)).view(torch.bfloat16)
    for i in range(4):
        code = torch.from_numpy(c[(np.arange(n) + i) % n]).to(torch.bfloat16)  # exact: |c| < 256
        want = (code[:, None] * s[None, :]).view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
        got_i = got[..., i]
        zero = (want & 0x7FFF) == 0
        assert np.array_equal(np.where(zero, 0, got_i), np.where(zero, 0, want)), (bits, i)
        assert np.all((got_i & 0x7FFF)[zero] == 0)


# ---- the walk of a call ----


def _rows_of_step(rem, group, R):
    """PlaneGroupWalk.rows: the box row of each 16 rows of a step whose
    first row sits `rem` rows into its first group."""
    rows, nxt, r = [], group - rem, 0
    for h in range(R // 16):
        if 16 * h >= nxt:
            r += 1
            nxt += group
        rows.append(r)
    return rows


def _cols(t, col0, C):
    """t's columns col0..col0+C-1, zero past O (TMA's zero fill)."""
    out = torch.zeros(*t.shape[:-1], C, dtype=t.dtype)
    n = max(0, min(C, t.shape[-1] - col0))
    out[..., :n] = t[..., col0:col0 + n]
    return out


def _rows(t, r0, n):
    """t's rows r0..r0+n-1, zero past its end."""
    out = torch.zeros(n, *t.shape[1:], dtype=t.dtype)
    k = max(0, min(n, t.shape[0] - r0))
    out[:k] = t[r0:r0 + k]
    return out


def walk(x, q, scale, zs, bits, group, plan, signed, scale_on_acc=False):
    """What plane_dec_kernel computes under `plan`: y [B, O] f32. x [B, K]
    bf16, q [Kp, O] (int8 for K8), scale [K/group, O] bf16 or f32, zs
    [K/group, O] bf16 or None; scale_on_acc: K5's format (the codes
    themselves in the products, a group's dots times its scale, its x sums
    times -zs)."""
    B, K = x.shape
    Kp, O = q.shape
    per = 8 // bits
    R = 64 if bits == 8 else 32
    C, (splits, ctiles, _) = plan.cols, plan.grid
    steps = -(-Kp // R)
    nr = qm.plane_dec_rows(bits, group)
    gpp = Kp // group  # groups a plane
    assert Kp % group == 0 and nr <= R // 16
    per_split = qm.dec_per_split(steps, splits, 1)
    mask = (1 << bits) - 1
    qb = q.view(torch.uint8).to(torch.int64)
    xv = torch.cat([x, torch.zeros(ROWS - B, K, dtype=x.dtype)]).float().reshape(ROWS, per, Kp)
    sv = scale.to(torch.bfloat16).float().reshape(per, gpp, O)  # rounded once, as read
    zv = None if zs is None else zs.float().reshape(per, gpp, O)
    y = torch.zeros(B, O)
    for ct in range(ctiles):
        col0 = ct * C
        tiles = []
        for rank in range(splits):
            acc = torch.zeros(ROWS, C)
            r0 = rank * per_split * R
            g, rem = divmod(r0, group)  # PlaneGroupWalk at the split's first row
            for s in range(rank * per_split, min(steps, (rank + 1) * per_split)):
                assert s * R == r0 + (s - rank * per_split) * R
                srow = _rows_of_step(rem, group, R)
                for h in range(R // 16):  # the walk against a division
                    assert g + srow[h] == (s * R + 16 * h) // group and srow[h] < nr
                qbox = _cols(_rows(qb, s * R, R), col0, C)                    # [R][C]
                sbox = _cols(_rows(sv.transpose(0, 1), g, nr), col0, C)      # [nr][per][C]
                xbox = _rows(xv.permute(2, 0, 1), s * R, R).permute(1, 2, 0)  # [16][per][R]
                if zv is not None:
                    zbox = _cols(_rows(zv.transpose(0, 1), g, nr), col0, C)  # [nr][per][C]
                for j in range(per):
                    codes = ((qbox >> (bits * j)) & mask)
                    if signed:
                        codes = codes - 256 * (codes >= 128)
                    d = torch.zeros(ROWS, C)  # scale_on_acc: the group's fresh fragment
                    xs = torch.zeros(ROWS, 1)  # scale_on_acc: x's sums over the group
                    for h in range(R // 16):
                        xh = xbox[:, j, 16 * h:16 * h + 16]
                        if scale_on_acc:  # the exact codes; one group a step
                            assert srow[h] == 0
                            d += xh @ codes[16 * h:16 * h + 16].float()
                            xs += xh @ torch.ones(16, 1)  # A all ones
                            continue
                        sc = sbox[srow[h], j].to(torch.bfloat16)
                        acc += xh @ (codes[16 * h:16 * h + 16].to(torch.bfloat16) * sc).float()
                        if zv is not None:  # the second product: A = -zs
                            acc += xh @ (-zbox[srow[h], j]).expand(16, C)
                    if scale_on_acc:  # two FFMAs a (row, column, group)
                        acc += d * sbox[0, j] - xs * zbox[0, j]
                rem += R  # PlaneGroupWalk.step
                while rem >= group:
                    rem -= group
                    g += 1
            tiles.append(acc)
        total = tiles[0]
        for t in tiles[1:]:  # dec_reduce: rank order
            total = total + t
        n = min(C, O - col0)
        y[:, col0:col0 + n] = total[:B, :n]
    return y


def _affine(bits, group, K, O, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(0, 256, (K * bits // 8, O), dtype=np.uint8))
    scale = torch.from_numpy(rng.uniform(0.001, 0.005, (K // group, O)).astype(np.float32))
    zs = torch.from_numpy((rng.standard_normal((K // group, O)) * 0.01).astype(np.float32))
    return q, scale.to(torch.bfloat16), zs.to(torch.bfloat16)


def _x(B, K, seed):
    x = np.random.default_rng(seed).standard_normal((B, K)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


# K10: Q2_K (group 16: two scale rows a plane a step), HQQ-1 (8 planes),
# GPTQ-4 at a group of 48 (groups that start inside a step), GPTQ-8 at 128
# (a group across two steps), per channel at K % 64 == 32 (a last step of
# 32 rows, a group of all K that is no power of two)
K10_CASES = [(2, 16, 1024, 272), (1, 64, 4096, 144), (4, 48, 3072, 144), (8, 128, 2048, 272),
             (8, 1056, 1056, 144)]


@pytest.mark.parametrize("B", [1, 9, 16])
@pytest.mark.parametrize("bits,group,K,O", K10_CASES)
def test_k10_decode_walk_matches_plain(bits, group, K, O, B):
    """K10's boxes, bf16(q * s) weights, the zs term as a second product
    with -zs over x, added over the cluster in rank order: the plain
    version (per-group sums of x @ zs in f32) to 1e-4 of max |y|, with one
    split and with clusters."""
    q, scale, zs = _affine(bits, group, K, O, K + O + B + bits)
    x = _x(B, K, B + bits)
    want = qm.affine_gemv_plain(x, q, scale, zs, bits, group, torch.float32)
    for sms in (132, 4):  # the card's, and few SMs: more splits a column tile
        plan = qm.plane_gemv_plan(B, K, O, bits, group, sms)
        got = walk(x, q, scale, zs, bits, group, plan, signed=False)
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), plan


@pytest.mark.parametrize("B", [1, 9, 16])
@pytest.mark.parametrize("K,O,f32", [(2048, 272, True), (1056, 144, False), (4096, 64, True)])
def test_k8_decode_walk_matches_plain(K, O, f32, B):
    """K8's boxes (64-row steps, two scale rows of a group of 32 each; a
    last step of 32 rows at K 1056), signed codes, rq8's f32 scale rounded
    to bf16 as read: the plain version to 1e-4 of max |y|."""
    rng = np.random.default_rng(K + O + B)
    q = torch.from_numpy(rng.integers(-128, 128, (K, O), dtype=np.int8))
    s = torch.from_numpy(rng.uniform(1e-4, 4e-4, (K // 32, O)).astype(np.float32))
    s = s if f32 else s.to(torch.bfloat16)
    x = _x(B, K, B)
    want = qm.q8_0_bf16_gemv_plain(x, q, s, torch.float32)
    for sms in (132, 4):
        plan = qm.q8_0_bf16_plan(B, K, O, f32, sms)
        got = walk(x, q, s, None, 8, 32, plan, signed=True)
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), plan


@pytest.mark.parametrize("bits,group,K", [(2, 16, 1024), (8, 128, 2048), (4, 48, 3072),
                                          (8, 1056, 1056), (1, 64, 4096)])
def test_decode_steps_read_every_weight_byte_and_scale_row(bits, group, K):
    """Over a call's steps the q boxes cover q's rows once, and the scale
    boxes of nr rows a plane, from the step's first group, hold the group
    of every element of the step: element j*Kp + r0 + r takes scale row
    j*Kp/group + g + row(r // 16)."""
    per = 8 // bits
    Kp = K // per
    R = 64 if bits == 8 else 32
    nr = qm.plane_dec_rows(bits, group)
    seen = []
    g, rem = 0, 0
    for s in range(-(-Kp // R)):
        seen += [r for r in range(s * R, s * R + R) if r < Kp]
        rows = _rows_of_step(rem, group, R)
        for j in range(per):
            for r in range(R):
                e = j * Kp + s * R + r
                if s * R + r < Kp:
                    assert e // group == j * (Kp // group) + g + rows[r // 16] and rows[r // 16] < nr
        rem += R
        while rem >= group:
            rem -= group
            g += 1
    assert seen == list(range(Kp))


# ---- K5: the Q4_K format (kScaleOnAcc) ----


def test_k5_nibble_pairs_are_the_exact_codes():
    """K5's A words: the 0x43cc pair of a nibble (bf16 128 + c) times 1 plus
    -128 in one fma.rn.bf16x2 is bf16(c) exactly, for every code of every
    byte (low and high nibbles, shifted down and masked as the consumer
    does), in K order."""
    cw_all = np.arange(256, dtype=np.uint32)
    for shift in (0, 4):
        codes = (cw_all >> shift) & 0xF
        # word k: the codes of bytes k, k+1, k+2, k+3 (mod 256) in bytes 0..3
        words = np.stack([codes[(np.arange(256) + i) % 256] for i in range(4)], axis=-1)
        cw = words[:, 0] | (words[:, 1] << 8) | (words[:, 2] << 16) | (words[:, 3] << 24)
        lo = fma_bf16x2(prmt(cw, 0x43, 0x4140), 0x3F803F80, 0xC300C300)
        hi = fma_bf16x2(prmt(cw, 0x43, 0x4342), 0x3F803F80, 0xC300C300)
        got = pair_values((lo, hi))
        want = round_bf16(words.astype(np.float64))
        assert np.array_equal(got, want), shift


def _q4k(K, O, seed):
    rng = np.random.default_rng(seed)
    qs = torch.from_numpy(rng.integers(0, 256, (K // 2, O), dtype=np.uint8))
    scale = torch.from_numpy(rng.uniform(0.001, 0.005, (K // 32, O)).astype(np.float32))
    minv = torch.from_numpy(rng.uniform(0.0, 0.002, (K // 32, O)).astype(np.float32))
    return qs, scale.to(torch.bfloat16), minv.to(torch.bfloat16)


# K5 at the tests' shapes: one step a split and several, a partial column
# tile, 64- and 128-column blocks
K5_CASES = [(512, 272), (2048, 144), (1024, 64), (4096, 272)]


@pytest.mark.parametrize("B", [1, 4, 9, 16])
@pytest.mark.parametrize("K,O", K5_CASES)
def test_k5_decode_walk_matches_plain(K, O, B):
    """K5 on plane_dec_kernel: the paired nibbles as the 4-bit planes (qs
    row r: element r low, K/2 + r high), scale and minv seen as
    [2][K/64][O] (one row a plane a step), x as [B][2][K/2]; per plane and
    step the two halves' products of x with the raw nibbles into a fresh
    fragment, times the column's scale onto the sums, and the min term as
    x's sums over the group (an all-ones product) times -minv, added over
    the cluster in rank order:
    the plain version (each sub-block's f32 dot times its scale, minus the
    per-32 sums of x @ minv) to 1e-5 of max |y|, with one split and with
    clusters."""
    qs, scale, minv = _q4k(K, O, K + O + B)
    x = _x(B, K, B + 4)
    want = qm.q4k_bf16_gemv_plain(x, qs, scale, minv, torch.float32)
    splits = set()
    for sms in (132, 4):
        plan = qm.q4k_bf16_plan(B, K, O, sms)
        assert plan == qm.plane_dec_plan(B, K, O, 4, 32, sms) and qm.plane_dec_rows(4, 32) == 1
        splits.add(plan.ksplit)
        got = walk(x, qs, scale, minv, 4, 32, plan, signed=False, scale_on_acc=True)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), plan
    assert max(splits) > 1 or K == 512


def test_k5_rounded_weight_would_miss_the_tolerance():
    """Why K5 keeps the scale on the accumulator: K10's walk of the same
    arrays (the weight rounded to bf16(q * s)) moves y by more than K5's
    1e-4 of max |y| on random Q4_K codes, the walk with the scale on the
    accumulator by under 1e-5."""
    K, O, B = 4096, 272, 16
    qs, scale, minv = _q4k(K, O, 7)
    x = _x(B, K, 8)
    want = qm.q4k_bf16_gemv_plain(x, qs, scale, minv, torch.float32)
    plan = qm.q4k_bf16_plan(B, K, O, 132)
    top = float(want.abs().max())
    rounded = walk(x, qs, scale, minv, 4, 32, plan, signed=False)
    exact = walk(x, qs, scale, minv, 4, 32, plan, signed=False, scale_on_acc=True)
    assert float((rounded - want).abs().max()) > 1e-4 * top
    assert float((exact - want).abs().max()) <= 1e-5 * top
