"""The decode instantiation of K9 (q5k_q8_gemv) at 1-16 rows,
csrc/q5k_q8_gemv.cu q5k_q8_dec_kernel, walked on the CPU: the plan's
clusters of K splits, each split's steps of 256 elements (the 32 qh rows
32r.. and the 4 qs row blocks m*K/8 + 32r.. whose high bits they hold),
the boxes of a step (qs seen as [4][K/8][O], qh's 32 rows, scale and minv
seen as [8][K/256][O]; x's codes in the quantize kernel's decode layout
seen as [8][K/256][512 bytes], its scales and sums as [8][K/256][16]), the
5-bit codes built from the transposed words as the consumer builds them,
exact int dots, K1's epilogue and the cluster's sum in rank order, against
the plain version. Every weight byte and scale row is read exactly once.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from mistralrs_tpu_torch.ops import quant_matmul as qm

ROWS = 16  # the decode tile's rows (mrt::kDecRows)


def decode_layout(xq):
    """The quantize kernel's decode layout of xq [16, K] (common.cuh
    decode_off): [K/32][16 rows][32 bytes], a row's two 16-byte halves
    swapped in rows 4-7 and 12-15."""
    K = xq.shape[1]
    b, k = np.meshgrid(np.arange(ROWS), np.arange(K), indexing="ij")
    off = (k >> 5) * 512 + b * 32 + ((((k >> 4) & 1) ^ ((b >> 2) & 1)) << 4) + (k & 15)
    buf = np.zeros(K * ROWS, dtype=np.int8)
    buf[off.ravel()] = xq.ravel()
    return buf


def x_codes(slice512):
    """A sub-block's codes [16 rows][32] as the consumer's x_frag reads them
    from its 512-byte slice (row rr, element k at rr*32 + (half ^ swz) * 16
    + k % 16)."""
    rr, k = np.meshgrid(np.arange(ROWS), np.arange(32), indexing="ij")
    return slice512[rr * 32 + ((((k >> 4) ^ ((rr >> 2) & 1))) << 4) + (k & 15)].astype(np.int64)


def words(box):
    """A [32][C] byte box as the uint32 words w_frags gives a lane: word i of
    column c holds rows 4i..4i+3 in bytes 0..3."""
    b = box.astype(np.uint32).reshape(8, 4, -1)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def unpack(w):
    """The inverse of words: [8][C] uint32 -> [32][C] bytes."""
    return np.stack([(w >> (8 * i)) & 0xFF for i in range(4)], axis=1).reshape(32, -1)


def code_words(w, h, J):
    """q5_dec_sub's code: the nibble (low for J < 4, high above) ORed with
    plane J's bit moved to bit 4 (hbit4<J>), on whole words."""
    nib = (w if J < 4 else w >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
    hb = (h << np.uint32(4 - J)) if J <= 4 else (h >> np.uint32(J - 4))
    return nib | (hb & np.uint32(0x10101010))


def _cols(a, col0, C):
    """a's columns col0..col0+C-1, zero past O (TMA's zero fill)."""
    out = np.zeros(a.shape[:-1] + (C,), dtype=a.dtype)
    n = max(0, min(C, a.shape[-1] - col0))
    out[..., :n] = a[..., col0:col0 + n]
    return out


def walk(x, qs, qh, scale, minv, plan):
    """What q5k_q8_dec_kernel computes under `plan`: y [B, O] f32, and the
    times each qs / qh byte, each scale / minv entry and each of x's
    sub-block slices was read."""
    B, K = x.shape
    O = qs.shape[1]
    k8, n8 = K // 8, K // 256
    C, (splits, ctiles, _) = plan.cols, plan.grid
    assert plan.cluster == splits and plan.rows == 16
    per_split = qm.dec_per_split(n8, splits, 1)
    xq, xs = qm._quantize_acts_q8(x)
    xsum = qm._xsum(x, 32)
    pad = ROWS - B  # the quantize kernel writes rows B..15 as zeros, xs of zeros
    xq = np.concatenate([xq.numpy(), np.zeros((pad, K), np.int8)])
    xs_t = np.concatenate([xs.numpy(), np.full((pad, K // 32), np.float32(1e-10) * np.float32(
        qm._INV127))]).T.copy()  # [K/32][16]
    xm_t = np.concatenate([xsum.numpy(), np.zeros((pad, K // 32), np.float32)]).T.copy()
    xbuf = decode_layout(xq)
    xq_view = xbuf.reshape(8, n8, 512)  # the x box's tensor map
    xs_view, xm_view = xs_t.reshape(8, n8, 16), xm_t.reshape(8, n8, 16)
    qs_np, qh_np = qs.numpy(), qh.numpy()
    sc_np, mn_np = scale.float().numpy(), minv.float().numpy()
    vals = qm._q5k_values(qs, qh).numpy()  # the plain version's 5-bit codes [K, O]
    reads = {"qs": np.zeros(qs_np.shape, int), "qh": np.zeros(qh_np.shape, int),
             "scale": np.zeros(sc_np.shape, int), "x": np.zeros(K // 32, int)}
    y = np.zeros((B, O), np.float32)
    for ct in range(ctiles):
        col0 = ct * C
        ncol = min(C, O - col0)
        tiles = []
        for rank in range(splits):
            acc = np.zeros((ROWS, C), np.float32)
            for r in range(rank * per_split, min(n8, (rank + 1) * per_split)):
                qs_box = np.stack([_cols(qs_np[m * k8 + 32 * r:m * k8 + 32 * r + 32], col0, C)
                                   for m in range(4)])  # [4][32][C]
                qh_box = _cols(qh_np[32 * r:32 * r + 32], col0, C)
                rows = [j * n8 + r for j in range(8)]
                sc_box, mn_box = _cols(sc_np[rows], col0, C), _cols(mn_np[rows], col0, C)
                for m in range(4):
                    reads["qs"][m * k8 + 32 * r:m * k8 + 32 * r + 32, col0:col0 + ncol] += 1
                reads["qh"][32 * r:32 * r + 32, col0:col0 + ncol] += 1
                reads["scale"][rows, col0:col0 + ncol] += 1
                reads["x"][rows] += 1
                hw = words(qh_box)
                for J in (0, 4, 1, 5, 2, 6, 3, 7):  # the consumer's order
                    codes = unpack(code_words(words(qs_box[J % 4]), hw, J)).astype(np.int64)
                    sub = J * n8 + r  # sub-block J*K/256 + r: elements 32*sub..
                    assert np.array_equal(codes[:, :ncol], vals[32 * sub:32 * sub + 32,
                                                                  col0:col0 + ncol])
                    xc = x_codes(xq_view[J, r])
                    d = xc @ codes  # exact int32 dots [16][C]
                    assert np.abs(d).max() < 1 << 22  # exact_f32's range
                    xsv, xmv = xs_view[J, r][:, None], xm_view[J, r][:, None]
                    acc = acc + d.astype(np.float32) * (xsv * sc_box[J][None, :])
                    acc = acc - xmv * mn_box[J][None, :]
            tiles.append(acc)
        total = tiles[0]
        for t in tiles[1:]:  # dec_reduce: rank order
            total = total + t
        y[:, col0:col0 + ncol] = total[:B, :ncol]
    return torch.from_numpy(y), reads


def _q5k(K, O, seed):
    rng = np.random.default_rng(seed)
    qs = torch.from_numpy(rng.integers(0, 256, (K // 2, O), dtype=np.uint8))
    qh = torch.from_numpy(rng.integers(0, 256, (K // 8, O), dtype=np.uint8))
    scale = torch.from_numpy(rng.uniform(0.001, 0.005, (K // 32, O)).astype(np.float32))
    minv = torch.from_numpy(rng.uniform(0.0, 0.002, (K // 32, O)).astype(np.float32))
    return qs, qh, scale.to(torch.bfloat16), minv.to(torch.bfloat16)


# one and two steps, a cluster of 8 and clusters with a shorter last split,
# partial column tiles of 128 and 64
K9_CASES = [(256, 144), (512, 272), (2048, 144), (4096, 272), (3584, 64), (2816, 144)]


@pytest.mark.parametrize("B", [1, 4, 9, 16])
@pytest.mark.parametrize("K,O", K9_CASES)
def test_k9_decode_walk_matches_plain(K, O, B):
    """K9's boxes, 5-bit codes, exact int dots, K1's epilogue and the
    cluster's rank-order sum: the plain version to 1e-5 of max |y| (the
    card's tolerance), with the card's plan and with few SMs (more splits
    a column tile, 64-column blocks); every qs and qh byte and every scale
    and minv entry read once, each of x's sub-block slices once a column
    tile."""
    qs, qh, scale, minv = _q5k(K, O, K + O + B)
    x = torch.from_numpy(np.random.default_rng(B).standard_normal((B, K)).astype(np.float32))
    x = (x * 2).to(torch.bfloat16)
    want = qm.q5k_q8_gemv_plain(x, qs, qh, scale, minv, torch.float32)
    for sms in (132, 8):
        plan = qm.q5k_q8_plan(B, K, O, sms)
        got, reads = walk(x, qs, qh, scale, minv, plan)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()) + 1e-5, plan
        for name in ("qs", "qh", "scale"):
            assert np.all(reads[name] == 1), (name, plan)
        assert np.all(reads["x"] == plan.grid[1]), plan


def test_k9_plans_split_whole_steps_and_use_both_column_widths():
    """The cases above reach clusters of one, several and 8 splits, a last
    split shorter than the others, and both 128- and 64-column blocks."""
    seen = set()
    for K, O in K9_CASES:
        for sms in (132, 8):
            p = qm.q5k_q8_plan(16, K, O, sms)
            n8, ks = K // 256, p.ksplit
            per = qm.dec_per_split(n8, ks, 1)
            seen.add((ks == 1, ks == 8, ks * per > n8, p.cols))
    assert {s[3] for s in seen} == {64, 128}
    assert any(s[0] for s in seen) and any(s[1] for s in seen) and any(s[2] for s in seen)


def test_k9_high_bit_shifts_keep_each_byte():
    """hbit4<J> on a word moves bit J of each byte to bit 4 of the same
    byte (the shift never carries a bit across bytes through the mask),
    for every plane and every byte value."""
    h = np.arange(256, dtype=np.uint32)
    w = h | ((255 - h) << 8) | (((h * 7) & 255) << 16) | (((h * 13) & 255) << 24)
    for J in range(8):
        got = code_words(np.zeros_like(w), w, J)
        for i in range(4):
            byte = (w >> np.uint32(8 * i)) & 0xFF
            assert np.array_equal((got >> np.uint32(8 * i)) & 0xFF, ((byte >> J) & 1) << 4), J
