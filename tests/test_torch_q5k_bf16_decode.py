"""K9b's decode instantiation (q5k_bf16_gemv: the whole Q5_K x bf16 product
at 1-16 rows), csrc/q5k_bf16_gemv.cu q5k_bf16_dec_kernel, walked on the
CPU: the plan's clusters of K splits, each split's steps of 256 elements
(the 32 qh rows 32r.. and the 4 qs row blocks m*K/8 + 32r.. whose high bits
they hold), the boxes of a step (qs seen as [4][K/8][O], qh's 32 rows,
scale and minv seen as [8][K/256][O], x seen as [B][8][K/8]), the A
operands built from the transposed words as the consumer builds them (the
nibble as K5's exact pair, the high bit as bf16 1.0 or 0), each
sub-block's two 16-element halves into fresh f32 sums times the column's
scale in two accumulator sets (y4 with the min term, yh), the cluster's
rank-order sum of both and JAX's epilogue, bf16(bf16(y4) + 16 * bf16(yh)),
against the plain version. Every weight byte and scale row is read exactly
once. The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from mistralrs_tpu_torch.ops import quant_matmul as qm

ROWS = 16  # the decode tile's rows (mrt::kDecRows)
BF16_RTOL = 2.0 ** -7  # tests/test_torch_bf16_gemv.py's bf16 bound: one bf16 ulp of max |y|


def words(box):
    """A [32][C] byte box as the uint32 words w_frags gives a lane: word i of
    column c holds rows 4i..4i+3 in bytes 0..3."""
    b = box.astype(np.uint32).reshape(8, 4, -1)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def unpack(w):
    """The inverse of words: [8][C] uint32 -> [32][C] bytes."""
    return np.stack([(w >> np.uint32(8 * i)) & 0xFF for i in range(4)], axis=1).reshape(32, -1)


def nib_words(w, J):
    """q5_bf16_sub's nibbles of sub-block J: the low nibbles for J < 4, the
    high ones above, on whole words."""
    return (w if J < 4 else w >> np.uint32(4)) & np.uint32(0x0F0F0F0F)


def hbit_words(h, J):
    """q5_bf16_sub's high bits of sub-block J: bit J of each byte, on whole
    words."""
    return (h >> np.uint32(J)) & np.uint32(0x01010101)


def hbit_pair(hb, sel_hi):
    """The A word of two high bits (bytes 0, 1 or 2, 3 of hb): the bytes
    moved to the halves by __byte_perm(hb, 0, 0x4140 / 0x4342), times
    0x3F80 (bf16 1.0)."""
    lo, hi = (2, 3) if sel_hi else (0, 1)
    pair = ((hb >> np.uint32(8 * lo)) & 0xFF) | (((hb >> np.uint32(8 * hi)) & 0xFF) << 16)
    return (pair * np.uint32(0x3F80)).astype(np.uint32)


def _cols(a, col0, C):
    """a's columns col0..col0+C-1, zero past O (TMA's zero fill)."""
    out = np.zeros(a.shape[:-1] + (C,), dtype=a.dtype)
    n = max(0, min(C, a.shape[-1] - col0))
    out[..., :n] = a[..., col0:col0 + n]
    return out


def f32(a):
    return np.asarray(a, dtype=np.float32)


def epilogue(y4, yh, out_dtype):
    """The kernel's q5_store4: bf16(bf16(y4) + 16 * bf16(yh)), or y4 + 16 * yh
    in f32."""
    y4, yh = torch.from_numpy(f32(y4)), torch.from_numpy(f32(yh))
    if out_dtype == torch.float32:
        return y4 + 16.0 * yh
    return (y4.to(torch.bfloat16).float() + 16.0 * yh.to(torch.bfloat16).float()).to(torch.bfloat16)


def walk(x, qs, qh, scale, minv, plan, one_sum=False):
    """What q5k_bf16_dec_kernel computes under `plan`: (y4, yh) f32 [B, O],
    and the times each qs / qh byte, each scale / minv entry and each of x's
    32-element pieces was read. one_sum: the design the kernel does not
    take, y4 + 16 * yh in one f32 sum (the epilogue's yh then 0)."""
    B, K = x.shape
    O = qs.shape[1]
    k8, n8 = K // 8, K // 256
    C, (splits, ctiles, _) = plan.cols, plan.grid
    assert plan.cluster == splits and plan.rows == 16 and plan.ws_bytes == 0
    per_split = qm.dec_per_split(n8, splits, 1)
    xb = np.zeros((ROWS, K), np.float32)  # TMA's box: rows past B zero
    xb[:B] = x.float().numpy()
    x_view = xb.reshape(ROWS, 8, k8)  # x seen as [B][8][K/8]
    qs_np, qh_np = qs.numpy(), qh.numpy()
    sc_np, mn_np = scale.float().numpy(), minv.float().numpy()
    nibs = torch.cat([qs & 0xF, qs >> 4], dim=0).numpy()  # the plain version's codes [K, O]
    bits = qm._affine_values(qh, 1).numpy()
    reads = {"qs": np.zeros(qs_np.shape, int), "qh": np.zeros(qh_np.shape, int),
             "scale": np.zeros(sc_np.shape, int), "x": np.zeros(K // 32, int)}
    y4 = np.zeros((B, O), np.float32)
    yh = np.zeros((B, O), np.float32)
    for ct in range(ctiles):
        col0 = ct * C
        ncol = min(C, O - col0)
        tiles = []
        for rank in range(splits):
            acc = np.zeros((ROWS, C), np.float32)
            acch = np.zeros((ROWS, C), np.float32)
            for r in range(rank * per_split, min(n8, (rank + 1) * per_split)):
                qs_box = np.stack([_cols(qs_np[m * k8 + 32 * r:m * k8 + 32 * r + 32], col0, C)
                                   for m in range(4)])  # [4][32][C]
                qh_box = _cols(qh_np[32 * r:32 * r + 32], col0, C)
                rows = [j * n8 + r for j in range(8)]
                sc_box, mn_box = _cols(sc_np[rows], col0, C), _cols(mn_np[rows], col0, C)
                x_box = x_view[:, :, 32 * r:32 * r + 32]  # [16][8][32]
                for m in range(4):
                    reads["qs"][m * k8 + 32 * r:m * k8 + 32 * r + 32, col0:col0 + ncol] += 1
                reads["qh"][32 * r:32 * r + 32, col0:col0 + ncol] += 1
                reads["scale"][rows, col0:col0 + ncol] += 1
                reads["x"][rows] += 1
                hw = words(qh_box)
                for J in (0, 4, 1, 5, 2, 6, 3, 7):  # the consumer's order
                    sub = J * n8 + r  # sub-block J*K/256 + r: elements 32*sub..
                    nib = unpack(nib_words(words(qs_box[J % 4]), J)).astype(np.float32)
                    hbw = hbit_words(hw, J)
                    hb = np.stack([hbit_pair(hbw, False), hbit_pair(hbw, True)], axis=1)
                    hb = np.stack([(hb >> np.uint32(16 * k)) & 0xFFFF for k in (0, 1)], axis=2)
                    hb = (hb.reshape(8, 4, -1) == 0x3F80).astype(np.float32).reshape(32, -1)
                    assert np.array_equal(nib[:, :ncol], nibs[32 * sub:32 * sub + 32,
                                                              col0:col0 + ncol])
                    assert np.array_equal(hb[:, :ncol], bits[32 * sub:32 * sub + 32,
                                                             col0:col0 + ncol])
                    xs_ = x_box[:, J, :]
                    # a sub-block's two 16-element halves into one fresh f32 sum
                    d = f32(xs_[:, :16] @ nib[:16]) + f32(xs_[:, 16:] @ nib[16:])
                    dh = f32(xs_[:, :16] @ hb[:16]) + f32(xs_[:, 16:] @ hb[16:])
                    xsum = f32(xs_[:, :16].sum(1)) + f32(xs_[:, 16:].sum(1))
                    if one_sum:
                        d = f32(d + np.float32(16) * dh)
                    acc = f32(acc + d * sc_box[J][None, :])
                    acc = f32(acc - xsum[:, None] * mn_box[J][None, :])
                    if not one_sum:
                        acch = f32(acch + dh * sc_box[J][None, :])
            tiles.append((acc, acch))
        t4, th = tiles[0]
        for a, h in tiles[1:]:  # the epilogue's sum: rank order
            t4, th = f32(t4 + a), f32(th + h)
        y4[:, col0:col0 + ncol] = t4[:B, :ncol]
        yh[:, col0:col0 + ncol] = th[:B, :ncol]
    return y4, yh, reads


def _q5k(K, O, seed):
    rng = np.random.default_rng(seed)
    qs = torch.from_numpy(rng.integers(0, 256, (K // 2, O), dtype=np.uint8))
    qh = torch.from_numpy(rng.integers(0, 256, (K // 8, O), dtype=np.uint8))
    scale = torch.from_numpy(rng.uniform(0.001, 0.005, (K // 32, O)).astype(np.float32))
    minv = torch.from_numpy(rng.uniform(0.0, 0.002, (K // 32, O)).astype(np.float32))
    return qs, qh, scale.to(torch.bfloat16), minv.to(torch.bfloat16)


def _x(B, K, seed):
    x = np.random.default_rng(seed).standard_normal((B, K)).astype(np.float32)
    return torch.from_numpy(x * 2).to(torch.bfloat16)


# one and two steps, a cluster of 8 and clusters with a shorter last split,
# partial column tiles of 128 and 64
CASES = [(256, 144), (512, 272), (2048, 144), (3584, 64), (2816, 144)]


@pytest.mark.parametrize("B", [1, 9, 16])
@pytest.mark.parametrize("K,O", CASES)
def test_q5k_bf16_decode_walk_matches_plain(K, O, B):
    """The walk's f32 out (y4 + 16 * yh) within 1e-6 of max |y| of the plain
    version's, with the card's plan and with few SMs (more splits a column
    tile, 64-column blocks); its two f32 sums within 1e-6 of the plain
    version's y4 (K5's) and yh (K9b's); the epilogue on the plain version's
    own sums gives the plain version's bf16 out bit for bit, and on the
    walk's sums the same bits wherever the two sums round to the same bf16
    (they differ only in their last f32 bits); every qs and qh byte and
    every scale and minv entry read once, each of x's pieces once a column
    tile."""
    qs, qh, scale, minv = _q5k(K, O, K + O + B)
    x = _x(B, K, B)
    want32 = qm.q5k_bf16_gemv_plain(x, qs, qh, scale, minv, torch.float32)
    want16 = qm.q5k_bf16_gemv_plain(x, qs, qh, scale, minv, torch.bfloat16)
    p4 = qm.q4k_bf16_gemv_plain(x, qs, scale, minv, torch.float32).numpy()
    ph = qm.q5k_hbit_bf16_gemv_plain(x, qh, scale, torch.float32).numpy()
    assert torch.equal(epilogue(p4, ph, torch.bfloat16), want16)
    assert torch.equal(epilogue(p4, ph, torch.float32), want32)
    top = float(want32.abs().max())
    for sms in (132, 8):
        plan = qm.q5k_bf16_plan(B, K, O, sms)
        y4, yh, reads = walk(x, qs, qh, scale, minv, plan)
        got32 = epilogue(y4, yh, torch.float32)
        assert float((got32 - want32).abs().max()) <= 1e-6 * top, plan
        assert np.abs(y4 - p4).max() <= 1e-6 * top and np.abs(yh - ph).max() <= 1e-6 * top
        same = ((torch.from_numpy(y4).to(torch.bfloat16) == torch.from_numpy(p4).to(torch.bfloat16))
                & (torch.from_numpy(yh).to(torch.bfloat16)
                   == torch.from_numpy(ph).to(torch.bfloat16)))
        got16 = epilogue(y4, yh, torch.bfloat16)
        assert torch.equal(got16[same], want16[same]), plan
        assert float((got16.float() - want16.float()).abs().max()) <= BF16_RTOL * top
        for name in ("qs", "qh", "scale"):
            assert np.all(reads[name] == 1), (name, plan)
        assert np.all(reads["x"] == plan.grid[1]), plan


def test_one_rounding_would_miss_the_bf16_tolerance():
    """Why the kernel keeps two sums and JAX's epilogue: y4 + 16 * yh in one
    f32 sum, rounded to bf16 once, is another function. On
    tests/test_torch_bf16_gemv.py's data recipe (a N(0, 0.09) weight
    quantized to Q5_K by the JAX package's quantizer, K 2048, O 256, x
    N(0, 0.49)) at seed 3 and one row, that design's walk is further than
    one bf16 ulp of max |y| (BF16_RTOL, that file's bound against JAX) from
    the plain version's bf16 out; the two-sum walk stays within it."""
    from mistralrs_tpu.gguf.reader import GGMLType
    from mistralrs_tpu.quant import kquants as jkquants
    from mistralrs_tpu_torch.quant import gguf_linear as tgl

    K, O, B, seed = 2048, 256, 1, 3
    w = (np.random.default_rng(seed).standard_normal((O, K)) * 0.3).astype(np.float32)
    raw = jkquants.quantize(w, GGMLType.Q5_K)
    d = tgl.linear_from_gguf(raw, int(GGMLType.Q5_K), (O, K), dtype=torch.bfloat16,
                             device="cpu").data
    qs, qh, scale, minv = d["qs"], d["qh"], d["scale"], d["minv"]
    x = np.random.default_rng(1000 + seed).standard_normal((B, K)) * 0.7
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    want = qm.q5k_bf16_gemv_plain(x, qs, qh, scale, minv, torch.bfloat16).float()
    top = float(want.abs().max())
    plan = qm.q5k_bf16_plan(B, K, O, 132)
    y, _, _ = walk(x, qs, qh, scale, minv, plan, one_sum=True)
    one = torch.from_numpy(y).to(torch.bfloat16).float()
    y4, yh, _ = walk(x, qs, qh, scale, minv, plan)
    two = epilogue(y4, yh, torch.bfloat16).float()
    assert float((two - want).abs().max()) <= BF16_RTOL * top
    assert float((one - want).abs().max()) > BF16_RTOL * top


def test_high_bit_pairs_are_exact_ones_and_zeros():
    """The high-bit A words: bit J of each byte moved to a bf16 half as 1.0
    (0x3F80) or 0, in K order (bytes 0, 1 in the lo word, 2, 3 in the hi
    one), for every byte value and plane; the shift never carries a bit
    across bytes through the mask."""
    h = np.arange(256, dtype=np.uint32)
    w = h | ((255 - h) << 8) | (((h * 7) & 255) << 16) | (((h * 13) & 255) << 24)
    for J in range(8):
        hb = hbit_words(w, J)
        for sel_hi, (b0, b1) in ((False, (0, 1)), (True, (2, 3))):
            pair = hbit_pair(hb, sel_hi)
            for half, byte in ((0, b0), (1, b1)):
                bit = (w >> np.uint32(8 * byte + J)) & 1
                assert np.array_equal((pair >> np.uint32(16 * half)) & 0xFFFF, bit * 0x3F80), J


@pytest.mark.parametrize("sms", [132, 114])
def test_q5k_bf16_plan(sms):
    """1-16 rows: K9's decode grid over K/256 steps (the same splits,
    columns and column tiles as q5k_q8_plan), a cluster of the splits, the
    ring stages of a 24 KB step at 128 columns (2) and 12 KB at 64 (3), no
    workspace; other row counts raise."""
    for K, O in ((4096, 5120), (4096, 4096), (4096, 28672), (14336, 4096), (512, 272)):
        for B in range(1, 17):
            plan = qm.q5k_bf16_plan(B, K, O, sms)
            k9 = qm.q5k_q8_plan(B, K, O, sms)
            assert (plan.rows, plan.grid, plan.ksplit, plan.cluster, plan.cols, plan.stages) == (
                k9.rows, k9.grid, k9.ksplit, k9.cluster, k9.cols, k9.stages), (B, plan)
            assert plan.ws_bytes == 0 and plan.cluster == plan.grid[0] <= 8
            assert plan.stages == {128: 2, 64: 3}[plan.cols]
            n8 = K // 256
            per = qm.dec_per_split(n8, plan.ksplit, 1)
            assert (plan.ksplit - 1) * per < n8 <= plan.ksplit * per
    for B in (0, 17, 64):
        with pytest.raises(ValueError):
            qm.q5k_bf16_plan(B, 4096, 4096, sms)


@pytest.fixture
def routes(monkeypatch):
    """Counts of the Q5_K bf16 route's wrappers, at their plain versions."""
    counts = {"q5k_bf16_gemv": 0, "q4k_bf16_gemv": 0, "q5k_hbit_bf16_gemv": 0}

    def counted(name, fn):
        def wrapped(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return wrapped

    for name in counts:
        monkeypatch.setattr(qm, name, counted(name, getattr(qm, name)))
    return counts


@pytest.mark.parametrize("rows,want", [(1, {"q5k_bf16_gemv": 1}), (16, {"q5k_bf16_gemv": 1}),
                                       (17, {"q4k_bf16_gemv": 1, "q5k_hbit_bf16_gemv": 1})])
def test_q5k_matmul_takes_one_kernel_up_to_16_rows(routes, rows, want):
    """With int8_act off, q5k_matmul calls the one-kernel Q5_K product at
    1-16 rows and K5 + K9b's rows instantiations above; the result is the
    plain composite's bit for bit either way."""
    from mistralrs_tpu_torch.quant.qlinear import Linear

    K, O = 512, 64
    qs, qh, scale, minv = _q5k(K, O, rows)
    lin = Linear("gguf_q5k", (K, O), dict(qs=qs, qh=qh, scale=scale, minv=minv), int8_act=False)
    x = _x(rows, K, rows + 1)
    y = qm.q5k_matmul(lin, x)
    assert {k: v for k, v in routes.items() if v} == want
    assert torch.equal(y, qm.q5k_bf16_gemv_plain(x, qs, qh, scale, minv, torch.bfloat16))
