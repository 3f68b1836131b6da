"""K5's and K8's rows instantiations (q4k_bf16_gemv and q8_0_bf16_gemv at
17-256 rows, csrc/plane_gemv.cuh plane_rows_kernel with Q4kFmt and with
PlaneFmt at 8 signed bits) walked on the CPU: a model in torch of the box
coordinates the CUDA code computes for each block of the plan. K5: the
paired nibbles as two 4-bit planes, the scale rows of a main step, x's
step-order positions, the decode into the weight's exact hi and lo parts;
a slice's zs step (the sums' rows and minv's rows, 32-element groups). K8:
32-element steps in x's own order (x read in place), the f32 or bf16 scale
rows, the decode into bf16(q * bf16(s)). For each row tile the walk must
touch every (element, column) once in a main step and, for K5, every
(group, column) once in a zs step, and its sum must equal the plain
version's. This is the index arithmetic that the card would otherwise test
first; and a check of the split that K5's format is built on."""

import pytest
import torch

from mistralrs_tpu_torch.ops import quant_matmul as qm


def _slices(n_steps, unit, ks):
    """(units a split, [(first main step, main steps) of each K split]):
    whole units of `unit` steps, every split but the last the same
    (plane_rows_kernel's slices_per_split)."""
    per_split = -(-(-(-n_steps // unit)) // ks)
    return per_split, [(z * per_split * unit,
                        max(0, min(per_split * unit, n_steps - z * per_split * unit)))
                       for z in range(ks)]


def split_parts(q, s):
    """The decode's two parts of q * s (q exact codes, s bf16): hi =
    bf16(q * s), lo = bf16(q * s - hi), each from an exact f32."""
    w = q.float() * s.float()
    hi = w.to(torch.bfloat16)
    return hi, (w - hi.float()).to(torch.bfloat16)


def k5_rows_walk(x, qs, scale, minv, plan):
    """y [B, O] as the rows kernel computes it on `plan`'s grid, and how
    many times each (element, column) was decoded and each (group, column)
    subtracted."""
    B, K = x.shape
    O = qs.shape[1]
    E = qm.Q4K_ROW_ELEMS
    per, _, R = qm.plane_row_geom(4, E)
    Kp, gpp = K // 2, K // 64  # byte rows, groups a plane
    Z = qm.plane_slice_steps(4, 32, elems=E)
    zg = Z * R // 32  # groups a plane a slice
    rows, (rtiles, ctiles, ks) = plan.rows, plan.grid
    # plane_prep_kernel: x in step order (element j*Kp + r of a row at
    # (r/R)*E + j*R + r%R), the per-32 sums [K/32][bpad], rows past B zero
    bpad = rtiles * rows
    xp = torch.zeros(bpad, K)
    xp[:B] = x.float()
    e = torch.arange(K)
    xc = torch.zeros(bpad, K)
    xc[:, (e % Kp) // R * E + e // Kp * R + e % R] = xp
    xsum = xp.reshape(bpad, K // 32, 32).sum(2).T
    # the views of the maps, with the rows a slice's boxes read past the end
    # zero-filled (TMA's out-of-bounds fill)
    pad = -(-gpp // zg) * zg - gpp
    sc3 = scale.reshape(2, gpp, O)                                            # Maps::sc
    mv3 = torch.nn.functional.pad(minv.float().reshape(2, gpp, O), (0, 0, 0, pad))  # zmap
    sum3 = torch.nn.functional.pad(xsum.reshape(2, gpp, bpad), (0, 0, 0, pad))      # summap
    planes = [qs & 0xF, qs >> 4]
    y = torch.zeros(B, O)
    seen = torch.zeros(K, O, dtype=torch.int32)
    zseen = torch.zeros(K // 32, O, dtype=torch.int32)
    per_split, splits = _slices(Kp // R, Z, ks)
    for z, (s_begin, n_main) in enumerate(splits):
        for bx in range(rtiles):
            for by in range(ctiles):
                row0, col0 = bx * rows, by * 128
                cols = slice(col0, min(col0 + 128, O))
                acc = torch.zeros(rows, cols.stop - col0)
                for i in range(n_main):
                    s = s_begin + i
                    r0 = s * R
                    xt = xc[row0:row0 + rows, s * E:(s + 1) * E]         # (s*E, row0)
                    hi = torch.empty(E, cols.stop - col0)
                    lo = torch.empty(E, cols.stop - col0)
                    for p in range(per):
                        code = planes[p][r0:r0 + R, cols]                 # (col0, r0)
                        srow = sc3[p, r0 >> 5, cols]                      # (col0, r0/32, 0)
                        h, l = split_parts(code, srow)
                        hi[R * p:R * (p + 1)], lo[R * p:R * (p + 1)] = h.float(), l.float()
                        seen[p * Kp + r0:p * Kp + r0 + R, cols] += 1
                    acc += xt @ hi + xt @ lo  # the two parts, the same x tile
                    if (i + 1) % Z and i + 1 < n_main:
                        continue
                    # the slice's zs step: its first group of a plane
                    zr = (z * per_split + i // Z) * zg
                    sums = sum3[:, zr:zr + zg, row0:row0 + rows]          # (row0, zr, 0)
                    zt = mv3[:, zr:zr + zg, cols]                         # (col0 [+64], zr, 0)
                    acc -= sums.reshape(2 * zg, rows).T @ zt.reshape(2 * zg, -1)
                    for p in range(per):
                        g = slice(p * gpp + zr, p * gpp + min(zr + zg, gpp))
                        zseen[g, cols] += 1
                live = min(rows, B - row0)
                y[row0:row0 + live, cols] += acc[:live]
    return y, seen, zseen


def k8_rows_walk(x, q, s, plan):
    """y [B, O] of K8's rows kernel on `plan`'s grid (no zs term: K split at
    4 main steps, x read in place), and how many times each (element,
    column) was decoded."""
    B, K = x.shape
    O = q.shape[1]
    E = qm.plane_row_geom(8)[1]
    rows, (rtiles, ctiles, ks) = plan.rows, plan.grid
    y = torch.zeros(B, O)
    seen = torch.zeros(K, O, dtype=torch.int32)
    xp = torch.zeros(rtiles * rows, K)  # the x map's rows past B: TMA's zero fill
    xp[:B] = x.float()
    for s_begin, n_main in _slices(K // E, 4, ks)[1]:
        for bx in range(rtiles):
            for by in range(ctiles):
                row0, col0 = bx * rows, by * 128
                cols = slice(col0, min(col0 + 128, O))
                acc = torch.zeros(rows, cols.stop - col0)
                for st in range(s_begin, s_begin + n_main):
                    r0 = st * E
                    xt = xp[row0:row0 + rows, r0:r0 + E]                  # (r0, row0)
                    code = q[r0:r0 + E, cols]                             # (col0, r0)
                    w = torch.empty(E, cols.stop - col0)
                    for o in range(E // 32):  # a scale row a 32 rows
                        srow = s[(r0 >> 5) + o, cols].to(torch.bfloat16)  # (col0, r0/32, 0)
                        w[32 * o:32 * (o + 1)] = (code[32 * o:32 * (o + 1)].to(torch.bfloat16)
                                                  * srow).float()
                    seen[r0:r0 + E, cols] += 1
                    acc += xt @ w
                live = min(rows, B - row0)
                y[row0:row0 + live, cols] += acc[:live]
    return y, seen


def _q4k(K, O, seed):
    g = torch.Generator().manual_seed(seed)
    qs = torch.randint(0, 256, (K // 2, O), generator=g, dtype=torch.uint8)
    scale = (torch.rand(K // 32, O, generator=g) * 0.004 + 0.001).to(torch.bfloat16)
    minv = (torch.rand(K // 32, O, generator=g) * 0.002).to(torch.bfloat16)
    x = torch.randn(256, K, generator=g).to(torch.bfloat16)
    return qs, scale, minv, x


def _q8(K, O, sdt, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randint(-128, 128, (K, O), generator=g, dtype=torch.int8)
    s = (torch.rand(K // 32, O, generator=g) * 3e-4 + 1e-4).to(sdt)
    x = torch.randn(256, K, generator=g).to(torch.bfloat16)
    return q, s, x


def _close(y, want):
    assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max())


# (K, O): a partial zs slice (512), one slice, two, and a column tile's tail
K5_SHAPES = [(512, 272), (1024, 256), (2048, 144)]


@pytest.mark.parametrize("sms", [132, 2])  # many K splits, and one
@pytest.mark.parametrize("B", [17, 64, 65, 256])
@pytest.mark.parametrize("K,O", K5_SHAPES)
def test_k5_rows_walk_covers_once_and_matches_plain(K, O, B, sms):
    qs, scale, minv, x = _q4k(K, O, K + B)
    x = x[:B]
    plan = qm.q4k_bf16_plan(B, K, O, sms)
    assert plan.rows == (64 if B <= 64 else 128)
    y, seen, zseen = k5_rows_walk(x, qs, scale, minv, plan)
    rtiles = plan.grid[0]
    assert bool((seen == rtiles).all()) and bool((zseen == rtiles).all()), plan
    _close(y, qm.q4k_bf16_gemv_plain(x, qs, scale, minv, torch.float32))


@pytest.mark.parametrize("sms", [132, 2])
@pytest.mark.parametrize("B", [17, 64, 65, 256])
@pytest.mark.parametrize("K,O,sdt", [(512, 272, torch.float32), (1024, 256, torch.bfloat16),
                                     (160, 144, torch.float32)])
def test_k8_rows_walk_covers_once_and_matches_plain(K, O, sdt, B, sms):
    """K8 at f32 (rq8) and bf16 (wire Q8_0) scales, with a last K split of
    fewer than 4 steps (K = 160: 5 steps)."""
    q, s, x = _q8(K, O, sdt, K + B)
    x = x[:B]
    plan = qm.q8_0_bf16_plan(B, K, O, sdt == torch.float32, sms)
    assert plan.rows == (64 if B <= 64 else 128)
    y, seen = k8_rows_walk(x, q, s, plan)
    assert bool((seen == plan.grid[0]).all()), plan
    _close(y, qm.q8_0_bf16_gemv_plain(x, q, s, torch.float32))


def test_q4k_weight_splits_into_two_exact_bf16_parts():
    """Why K5 has a format of its own: for every 4-bit code and bf16 scales
    across the normal exponents, hi = bf16(q * s) and lo = bf16(q * s -
    hi) hold q * s exactly (hi + lo == q * s in f32, lo the remainder
    itself), while bf16(q * s) alone misses it for most scales."""
    g = torch.Generator().manual_seed(0)
    mant = torch.randint(0, 128, (4096,), generator=g)
    exps = torch.arange(-100, 101, 4)
    bits = ((exps[:, None] + 127) << 7 | mant[None, :]).reshape(-1).to(torch.int16)
    s = bits.view(torch.bfloat16)
    q = torch.arange(16, dtype=torch.uint8)
    qq, ss = torch.broadcast_tensors(q[:, None], s[None, :])
    exact = qq.float() * ss.float()  # exact in f32: 4 bits x 8 bits
    hi, lo = split_parts(qq, ss)
    assert torch.equal(hi.float() + lo.float(), exact)
    assert torch.equal(lo.float(), exact - hi.float())
    assert float((hi.float() != exact).float().mean()) > 0.5
