"""K4's rows instantiation (q6k_bf16_gemv at 17-256 rows, csrc/plane_gemv.cuh
plane_rows_kernel with Q6kFmt) walked on the CPU: a model in torch of the box
coordinates the CUDA code computes for each block of the plan (the ql
halves' rows, the qh rows, the four spans' scale rows and x's step-order
positions of a main step; the sums' and scale rows of a slice's zs step),
the decode of each step into bf16(code * s16) and the products. For each
row tile the walk must touch every (element, column) once in a main step
and every (group of 16, column) once in a zs step, and its sum must equal
the plain version's. This is the index arithmetic that the card would
otherwise test first."""

import pytest
import torch

from mistralrs_tpu_torch.ops import quant_matmul as qm

KR, KE, Z = 16, 64, 8  # rows of a span a main step, elements a step, main steps a slice


def k4_rows_walk(x, ql, qh, scale, G, plan):
    """y [B, O] as the rows kernel computes it on `plan`'s grid, and how many
    times each (element, column) was decoded and each (group of 16,
    column) subtracted (once a row tile)."""
    B, K = x.shape
    O = ql.shape[1]
    Kq, C = K // 4, K // (4 * G)
    rows, (rtiles, ctiles, ks) = plan.rows, plan.grid
    sh, mask = G.bit_length() - 1, G - 1
    nslices = Kq // KR // Z
    per_split = -(-nslices // ks)
    # plane_prep_kernel: x in step order (element j*Kq + r of a row at
    # (r/16)*64 + j*16 + r%16) and the per-16 sums [K/16][bpad], rows past B zero
    bpad = rtiles * rows
    xp = torch.zeros(bpad, K)
    xp[:B] = x.float()
    e = torch.arange(K)
    xc = torch.zeros(bpad, K)
    xc[:, (e % Kq) // KR * KE + e // Kq * KR + e % KR] = xp
    xsum = xp.reshape(bpad, K // 16, 16).sum(2).T
    # the tensors as the kernel's maps see them
    ql3 = ql.reshape(2 * C, G, O)             # Maps::ql: [2C][G][O]
    sc3 = scale.reshape(4 * C, G // 16, O)    # Maps::sc, zmap: [4C][G/16][O]
    sum3 = xsum.reshape(4, Kq // 16, bpad)    # summap: [4][Kq/16][bpad]
    y = torch.zeros(B, O)
    seen = torch.zeros(K, O, dtype=torch.int32)
    zseen = torch.zeros(K // 16, O, dtype=torch.int32)
    for z in range(ks):
        s_begin = z * per_split * Z
        n_main = max(0, min(per_split * Z, Kq // KR - s_begin))
        for bx in range(rtiles):
            for by in range(ctiles):
                row0, col0 = bx * rows, by * 128
                cols = slice(col0, min(col0 + 128, O))
                acc = torch.zeros(rows, cols.stop - col0)
                for i in range(n_main):
                    s = s_begin + i
                    r0 = s * KR
                    c, t0 = r0 >> sh, r0 & mask
                    h = qh[r0:r0 + KR, cols].int()                    # (col0, r0)
                    lo = ql3[2 * c:2 * c + 2, t0:t0 + KR, cols].int()  # (col0, t0, 2c)
                    s16 = sc3[4 * c:4 * c + 4, t0 >> 4, cols]         # (col0, t0/16, 4c)
                    xt = xc[row0:row0 + rows, s * KE:(s + 1) * KE]    # (s*64, row0)
                    w = torch.empty(KE, cols.stop - col0)
                    for p in range(4):
                        code = (lo[p & 1] >> 4 * (p >> 1)) & 0xF | ((h >> 2 * p) & 3) << 4
                        w[KR * p:KR * (p + 1)] = (code.to(torch.bfloat16)
                                                  * s16[p].to(torch.bfloat16)).float()
                        seen[p * Kq + r0:p * Kq + r0 + KR, cols] += 1
                    acc += xt @ w
                    if (i + 1) % Z:
                        continue
                    # the slice's zs step: zs_row = 8 groups a plane a slice
                    zr = (z * per_split + i // Z) * (Z * KR // 16)
                    r = zr << 4
                    zc, z2 = (r & mask) >> 4, 4 * (r >> sh)
                    sums = sum3[:, zr:zr + 8, row0:row0 + rows]       # (row0, zr, 0)
                    zt = sc3[z2:z2 + 4, zc:zc + 8, cols].float()       # (col0, zc, z2)
                    acc -= (32.0 * sums).reshape(32, rows).T @ zt.reshape(32, -1)
                    for p in range(4):
                        zseen[p * (Kq // 16) + zr:p * (Kq // 16) + zr + 8, cols] += 1
                live = min(rows, B - row0)
                y[row0:row0 + live, cols] += acc[:live]
    return y, seen, zseen


def _q6k(K, O, G, seed, q3k=False):
    g = torch.Generator().manual_seed(seed)
    if q3k:  # Q3_K's codes 28..35 in Q6_K's layout (gguf_linear.pack_q3k)
        q = torch.randint(28, 36, (K, O), generator=g, dtype=torch.uint8)
        lo, hi = q & 0xF, q >> 4
        C = K // (4 * G)
        ln, hb = lo.reshape(4, C, G, O), hi.reshape(4, C, G, O)
        ql = torch.cat([ln[0] | ln[2] << 4, ln[1] | ln[3] << 4], dim=1).reshape(K // 2, O)
        qh = (hb[0] | hb[1] << 2 | hb[2] << 4 | hb[3] << 6).reshape(K // 4, O)
    else:
        ql = torch.randint(0, 256, (K // 2, O), generator=g, dtype=torch.uint8)
        qh = torch.randint(0, 256, (K // 4, O), generator=g, dtype=torch.uint8)
    scale = (torch.rand(K // 16, O, generator=g) * 0.004 + 0.001).to(torch.bfloat16)
    x = torch.randn(2 * 128, K, generator=g).to(torch.bfloat16)
    return ql, qh, scale, x


# (K, G): one and two chunks a span at each span the kernel takes
SPANS = [(512, 128), (1024, 128), (2048, 256), (4096, 512)]


@pytest.mark.parametrize("sms", [132, 2])  # many K splits, and one
@pytest.mark.parametrize("B", [17, 40, 64, 65, 200, 256])
@pytest.mark.parametrize("K,G", SPANS)
def test_k4_rows_walk_covers_once_and_matches_plain(K, G, B, sms):
    O = 272  # a column tile's tail
    ql, qh, scale, x = _q6k(K, O, G, K + B)
    x = x[:B]
    plan = qm.q6k_bf16_plan(B, K, O, G, sms)
    assert plan.rows == (64 if B <= 64 else 128)
    y, seen, zseen = k4_rows_walk(x, ql, qh, scale, G, plan)
    rtiles = plan.grid[0]
    assert bool((seen == rtiles).all()) and bool((zseen == rtiles).all()), plan
    want = qm.q6k_bf16_gemv_plain(x, ql, qh, scale, G, torch.float32)
    assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_k4_rows_walk_with_q3k_codes():
    """Q3_K's codes (28..35) through the same walk: the decode takes any code
    below 64."""
    K, O, G, B = 1024, 256, 256, 100
    ql, qh, scale, x = _q6k(K, O, G, 5, q3k=True)
    x = x[:B]
    plan = qm.q6k_bf16_plan(B, K, O, G, 132)
    y, seen, zseen = k4_rows_walk(x, ql, qh, scale, G, plan)
    assert bool((seen == plan.grid[0]).all()) and bool((zseen == plan.grid[0]).all())
    want = qm.q6k_bf16_gemv_plain(x, ql, qh, scale, G, torch.float32)
    assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_k4_decoded_weight_is_the_plain_versions():
    """The walk's decode (code from the nibble and the two high bits, then
    bf16(code * s16)) is bit-equal to the plain version's weight."""
    K, O, G = 1024, 128, 128
    ql, qh, scale, _ = _q6k(K, O, G, 3)
    q, s16 = qm._q6k_natural(ql, qh, scale, G)
    want = q.to(torch.bfloat16) * torch.repeat_interleave(s16.to(torch.bfloat16), 16, dim=0)
    Kq = K // 4
    got = torch.empty(K, O, dtype=torch.bfloat16)
    for r0 in range(0, Kq, KR):
        c, t0 = r0 // G, r0 % G
        lo = ql.reshape(-1, G, O)[2 * c:2 * c + 2, t0:t0 + KR].int()
        h = qh[r0:r0 + KR].int()
        for p in range(4):
            code = (lo[p & 1] >> 4 * (p >> 1)) & 0xF | ((h >> 2 * p) & 3) << 4
            s = scale.reshape(-1, G // 16, O)[4 * c + p, t0 // 16]
            got[p * Kq + r0:p * Kq + r0 + KR] = code.to(torch.bfloat16) * s
    assert torch.equal(got, want)


@pytest.mark.parametrize("G", [64, 96, 384])
def test_k4_rows_plan_refuses_spans_the_kernel_does_not_take(G):
    K = 4 * G * 4
    assert qm.q6k_bf16_plan(16, K, 256, G, 132).rows == 16  # the 16-row kernel takes any G
    with pytest.raises(ValueError):
        qm.q6k_bf16_plan(17, K, 256, G, 132)
