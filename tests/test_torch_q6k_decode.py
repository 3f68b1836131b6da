"""The decode instantiations of K3 (q6k_q8_gemv) and K4 (q6k_bf16_gemv) at
1-16 rows, csrc/q6k_gemv.cu, walked on the CPU: the plan's clusters of K
splits, each split's steps of 32 t of one chunk, the three weight boxes of
a step (ql seen as [chunks][2][G][O], qh as [K/4][O], the scale as
[chunks][4][G/16][O]), x's pieces (K3: the four span slices of the
quantize kernel's decode layout and their scales and per-16 sums; K4: one
box of x seen as [B][4][K/4]) and the per-16 arithmetic of the consumer
warps, added over the cluster in rank order, against the plain versions.
The kernels themselves run only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from mistralrs_tpu_torch.ops import quant_matmul as qm

ROWS = 16  # the decode tile's rows (mrt::kDecRows)


def _arrays(K, O, seed):
    rng = np.random.default_rng(seed)
    ql = torch.from_numpy(rng.integers(0, 256, (K // 2, O), dtype=np.uint8))
    qh = torch.from_numpy(rng.integers(0, 256, (K // 4, O), dtype=np.uint8))
    scale = torch.from_numpy(rng.standard_normal((K // 16, O)).astype(np.float32) * 0.003)
    return ql, qh, scale.to(torch.bfloat16)


def _decode_layout(x):
    """The quantize kernel's decode layout for 16 rows: codes [K/32][16][32]
    (rows past B zero), xs [K/32][16], xsum16 [K/16][16]."""
    B, K = x.shape
    xq, xs = qm._quantize_acts_q8(x)
    xm = qm._xsum(x, 16)
    pad = lambda t: torch.cat([t, torch.zeros(ROWS - B, *t.shape[1:], dtype=t.dtype)])
    return (pad(xq).reshape(ROWS, K // 32, 32).transpose(0, 1), pad(xs).T, pad(xm).T)


def _boxes(ql, qh, scale, G, s, col0, C):
    """Step s's three weight boxes at columns col0.. (zero past O), as the
    TMA maps cut them: ql [2][32][C], qh [32][C], scale [4][2][C]."""
    K, O = 2 * ql.shape[0], ql.shape[1]
    chunks = K // (4 * G)
    c, t0 = s // (G // 32), 32 * (s % (G // 32))

    def cols(t):
        out = torch.zeros(*t.shape[:-1], C, dtype=t.dtype)
        n = min(C, O - col0)
        out[..., :n] = t[..., col0:col0 + n]
        return out

    lbox = cols(ql.reshape(chunks, 2, G, O)[c, :, t0:t0 + 32])
    hbox = cols(qh[G * c + t0:G * c + t0 + 32])
    sbox = cols(scale.reshape(chunks, 4, G // 16, O)[c, :, t0 // 16:t0 // 16 + 2])
    return c * G + t0, lbox.int(), hbox.int(), sbox.float()


def _codes(lbox, hbox, j):
    """Span j's 6-bit codes [32][C] of a step (mrt::q6_codes)."""
    return ((lbox[j & 1] >> (4 * (j >> 1))) & 0xF) | (((hbox >> (2 * j)) & 3) << 4)


def walk(x, ql, qh, scale, G, plan, int8):
    """What the decode kernel computes under `plan`: y [B, O] f32."""
    B, K = x.shape
    O = ql.shape[1]
    C, (splits, ctiles, _) = plan.cols, plan.grid
    steps, Kq = K // 128, K // 4
    per = qm.dec_per_split(steps, splits, qm.Q6K_DEC_SUB)
    if int8:
        xq, xs, xm = _decode_layout(x)
    else:
        xb = torch.cat([x, torch.zeros(ROWS - B, K, dtype=x.dtype)]).reshape(ROWS, 4, Kq)
    y = torch.zeros(B, O)
    for ct in range(ctiles):
        col0 = ct * C
        tiles = []
        for rank in range(splits):
            acc = torch.zeros(ROWS, C)
            for s in range(rank * per, min(steps, (rank + 1) * per)):
                e0, lbox, hbox, sbox = _boxes(ql, qh, scale, G, s, col0, C)
                for j in range(4):
                    q = _codes(lbox, hbox, j).float()
                    if int8:
                        sl = (j * Kq + e0) // 32  # the span's 32-element slice
                        codes, xsj = xq[sl].float(), xs[sl]
                        dl, dh = codes[:, :16] @ q[:16], codes[:, 16:] @ q[16:]
                        blk = dh * sbox[j, 1] + dl * sbox[j, 0]
                        acc += blk * xsj[:, None]
                        acc += (-32.0 * xm[2 * sl])[:, None] * sbox[j, 0]
                        acc += (-32.0 * xm[2 * sl + 1])[:, None] * sbox[j, 1]
                    else:
                        xv = xb[:, j, e0:e0 + 32].float()
                        for hf in range(2):
                            s16 = sbox[j, hf].to(torch.bfloat16)
                            w = (q[16 * hf:16 * hf + 16].to(torch.bfloat16) * s16).float()
                            acc += xv[:, 16 * hf:16 * hf + 16] @ w
                            acc += xv[:, 16 * hf:16 * hf + 16].sum(1, keepdim=True) * (
                                -32.0 * s16.float())
            tiles.append(acc)
        total = tiles[0]
        for t in tiles[1:]:  # dec_reduce: rank order
            total = total + t
        n = min(C, O - col0)
        y[:, col0:col0 + n] = total[:B, :n]
    return y


CASES = [(4096, 1024, 512), (1024, 272, 128), (2048, 272, 256), (1536, 144, 96)]


@pytest.mark.parametrize("B", [1, 5, 9, 16])
@pytest.mark.parametrize("K,O,G", CASES)
def test_k3_decode_walk_matches_plain(K, O, G, B):
    """K3's boxes and per-16 int dots, each 32-block's two dots scaled by
    their s16 before the xs multiply, the -32 term over xsum16: the plain
    version to 1e-5 of max |y| (exact int dots, f32 sums in another order),
    with one split and with clusters."""
    ql, qh, scale = _arrays(K, O, K + O + B)
    x = torch.from_numpy(np.random.default_rng(B).standard_normal((B, K)).astype(np.float32))
    for sms in (132, 4):  # the card's, and few SMs: more splits a column tile
        plan = qm.q6k_q8_plan(B, K, O, G, sms)
        got = walk(x, ql, qh, scale, G, plan, int8=True)
        want = qm.q6k_q8_gemv_plain(x, ql, qh, scale, G, torch.float32)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), plan


@pytest.mark.parametrize("B", [1, 9, 16])
@pytest.mark.parametrize("K,O,G", CASES)
def test_k4_decode_walk_matches_plain(K, O, G, B):
    """K4's boxes, bf16(q * s16) weights and the -32 term as a second
    product with -32 * s16: the plain version to 1e-4 of max |y|."""
    ql, qh, scale = _arrays(K, O, K + O + B + 1)
    x = torch.from_numpy(np.random.default_rng(B + 1).standard_normal((B, K)).astype(np.float32))
    x = x.to(torch.bfloat16)
    for sms in (132, 4):
        plan = qm.q6k_bf16_plan(B, K, O, G, sms)
        got = walk(x, ql, qh, scale, G, plan, int8=False)
        want = qm.q6k_bf16_gemv_plain(x, ql, qh, scale, G, torch.float32)
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), plan


@pytest.mark.parametrize("K,G", [(4096, 512), (1024, 128), (1536, 96)])
def test_decode_steps_read_every_weight_byte_once(K, G):
    """Over a call's steps the ql, qh and scale boxes cover their arrays
    exactly once, and span j's x slice of a step is the element that the
    packed position holds (element j*K/4 + c*G + t)."""
    O = 16
    Kq = K // 4
    ql = torch.arange(K // 2).repeat_interleave(O).reshape(K // 2, O)
    qh = torch.arange(Kq).repeat_interleave(O).reshape(Kq, O)
    sc = torch.arange(K // 16).repeat_interleave(O).reshape(K // 16, O).float()
    seen_l, seen_h, seen_s = [], [], []
    for s in range(K // 128):
        e0, lbox, hbox, sbox = _boxes(ql, qh, sc.to(torch.bfloat16).float(), G, s, 0, O)
        c, t0 = divmod(e0, G)
        seen_l += lbox[:, :, 0].flatten().tolist()
        seen_h += hbox[:, 0].tolist()
        seen_s += [int(v) for v in sc.reshape(-1, G // 16, O)[4 * c:4 * c + 4,
                                                              t0 // 16:t0 // 16 + 2, 0].flatten()]
        for j in range(4):
            for t in range(32):  # ql row of element j*Kq + e0 + t (pack_q6k)
                assert int(lbox[j & 1, t, 0]) == 2 * G * c + (j & 1) * G + t0 + t
    assert sorted(seen_l) == list(range(K // 2))
    assert sorted(seen_h) == list(range(Kq))
    assert sorted(seen_s) == list(range(K // 16))


def test_k4_weight_pairs_round_once():
    """K4 builds bf16(q * s16) as fma((128 + q), s, -128 s) in bf16x2: the
    code bytes with 0x43 above them are the bf16 128 + q (q < 128), and -128
    s and -32 s are exact in bf16, so the fma's one rounding of the exact
    q * s is the plain version's bf16 product."""
    q = torch.arange(64, dtype=torch.int32)
    pairs = (q | 0x4300).to(torch.int16).view(torch.bfloat16)
    assert torch.equal(pairs.float(), (128 + q).float())
    s = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    s = s.to(torch.bfloat16)
    for k in (-128.0, -32.0):
        assert torch.equal((s * k).double(), s.double() * k)
    exact = (128 + q[:, None]).double() * s.double() - 128 * s.double()  # = q * s
    assert torch.equal(exact, q[:, None].double() * s.double())
    assert torch.equal(exact.to(torch.float32).to(torch.bfloat16),
                       q[:, None].to(torch.bfloat16) * s)
