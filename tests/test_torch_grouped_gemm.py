"""The port's grouped GEMM (ops/grouped_gemm.py, K13's plain version on the
CPU) and MoE block (models/decoder.py `_moe_mlp`) against the JAX package,
in f32 on the CPU, on the same seeded numpy inputs.

- `grouped_matmul` against JAX `grouped_matmul` with backend "gmm" (the
  megablox kernel in Pallas interpret mode, as tests/test_ops.py runs it)
  and "ragged" (`lax.ragged_dot`), on tests/test_ops.py's three splits
  (empty groups, M not a multiple of the 128-row tile, one group) and a
  decode-sized split (M 32 over 8 groups, seeded skew): within 2e-5.
- `_moe_mlp` against JAX `_moe_mlp` in each of its three branches on the
  same params: the grouped dispatch (JAX under both MISTRALRS_MOE_BACKEND
  values), the dense every-expert einsum, and packed Q4_K experts stacked
  by the JAX GGUF loader's `_stack_linears` (the port's GEMV routes off,
  so both dequantize): within 2e-5; a Q4_K router, padded to 16 outputs
  by the port's fusion, routes as JAX's unpadded one does.
- Router logits with deliberate ties pick the same experts in both
  packages (the lower index first, as jax.lax.top_k does).
- K13's launch plan (`grouped_gemm_plan`, pure Python) at Mixtral's and
  the card tests' shapes: the instantiation threshold, the grid, shared
  memory, the tile multiples and the C entry point's argument order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.gguf.reader import GGMLType
from mistralrs_tpu.models import decoder as jd
from mistralrs_tpu.models.config import ModelConfig as JModelConfig
from mistralrs_tpu.ops.grouped_gemm import grouped_matmul as jgrouped_matmul
from mistralrs_tpu.pipeline.gguf import _stack_linears
from mistralrs_tpu.quant.qlinear import Linear as JLinear
from mistralrs_tpu_torch.models import decoder as td
from mistralrs_tpu_torch.ops import grouped_gemm as tgg
from mistralrs_tpu_torch.ops import quant_matmul as tqm
from mistralrs_tpu_torch.quant import fuse as tfuse
from torch_port_model import port_config, quantized

TOL = 2e-5
H, I, E, TOPK = 256, 512, 4, 2


def _skewed_sizes(M: int, G: int, seed: int) -> list[int]:
    """M rows over G groups with a seeded skew (some groups may be empty)."""
    p = np.random.default_rng(seed).dirichlet(np.full(G, 0.5))
    return np.bincount(np.random.default_rng(seed + 1).choice(G, M, p=p), minlength=G).tolist()


# tests/test_ops.py's three splits over 4 groups (K 96, N 160), and a
# decode step's 32 (token, expert) pairs over Mixtral's 8 experts
GROUPED_CASES = [([10, 0, 25, 15], 96, 160), ([32, 32, 32, 32], 96, 160),
                 ([0, 131, 0, 0], 96, 160), (_skewed_sizes(32, 8, 3), 128, 192)]


@pytest.mark.parametrize("backend", ["gmm", "ragged"])
@pytest.mark.parametrize("sizes,K,N", GROUPED_CASES)
def test_grouped_matmul_matches_jax(sizes, K, N, backend):
    rng = np.random.default_rng(11)
    M, G = sum(sizes), len(sizes)
    lhs = rng.standard_normal((M, K)).astype(np.float32)
    rhs = (rng.standard_normal((G, K, N)) * 0.1).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    want = np.asarray(jgrouped_matmul(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(gs),
                                      backend=backend))
    got = tgg.grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(rhs), torch.from_numpy(gs))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_grouped_matmul_refuses_mismatched_shapes():
    lhs, rhs = torch.zeros(4, 8), torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):
        tgg.grouped_matmul(lhs, rhs, torch.tensor([4], dtype=torch.int32))
    with pytest.raises(ValueError):
        tgg.grouped_matmul(lhs, torch.zeros(2, 9, 16), torch.tensor([2, 2], dtype=torch.int32))


# (M, K, N, G): Mixtral-8x7B's gate and down at a decode step (32 pairs),
# the 4 x 64-, 4 x 256-, 4 x 512- and 16 x 256-row first chunks (M 512,
# 2,048, 4,096, 8,192), and the card tests' small shapes
PLAN_SHAPES = [(32, 4096, 14336, 8), (32, 14336, 4096, 8), (512, 4096, 14336, 8),
               (512, 14336, 4096, 8), (2048, 4096, 14336, 8), (2048, 14336, 4096, 8),
               (4096, 4096, 14336, 8), (8192, 4096, 14336, 8), (8192, 14336, 4096, 8),
               (50, 96, 160, 4), (131, 96, 160, 4), (129, 128, 192, 1), (170, 96, 264, 3),
               (10240, 96, 72, 256), (1, 32, 8, 1), (33, 32, 8, 1)]


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("M,K,N,G", PLAN_SHAPES)
def test_grouped_gemm_plan_fits_the_card(M, K, N, G, sms):
    """K13's plan: the decode instantiation up to 32 rows a group on
    average, the tiles one above; a grid no larger than the SM count or the
    tiles group boundaries can make; at most 227 KB of shared memory; the
    tiles kernel's column tile and K step multiples of 64 (its 128-byte
    swizzled boxes)."""
    plan = tgg.grouped_gemm_plan(M, K, N, G, sms)
    assert plan.smem_bytes <= 227 * 1024
    if M <= 32 * G:
        assert plan.kind == "decode" and (plan.bm, plan.bn, plan.bk) == (16, 128, 32)
        assert plan.grid == (-(-N // 128), -(-M // 16) + G - 1, 1) and plan.threads == 128
        return
    tiles = min(-(-M // 128) + G - 1, M) * -(-N // plan.bn)
    assert plan.kind == "tiles" and plan.bm == 128 and plan.threads == 384
    assert plan.bn % 64 == 0 and plan.bk % 64 == 0
    assert 1 <= plan.grid[0] <= min(sms, tiles) and plan.grid[1:] == (1, 1)
    assert plan.grid[0] == min(sms, tiles)  # persistent: every SM, or every tile
    stage = (plan.bm + plan.bn) * plan.bk * 2
    assert plan.stages >= 4 and plan.stages * stage <= 200 * 1024 < (plan.stages + 1) * stage


@pytest.mark.parametrize("G", [1, 8, 256])
def test_grouped_gemm_plan_threshold_is_32_rows_a_group(G):
    assert tgg.grouped_gemm_plan(32 * G, 4096, 14336, G, 132).kind == "decode"
    assert tgg.grouped_gemm_plan(32 * G + 1, 4096, 14336, G, 132).kind == "tiles"


def test_grouped_gemm_plan_is_what_the_c_entry_point_checks():
    """The launch arguments in the C entry point's order: kind (0 decode, 1
    tiles), bm, bn, bk, stages, threads, the grid, shared memory."""
    plan = tgg.grouped_gemm_plan(2048, 4096, 14336, 8, 132)
    assert tgg.launch_args(plan) == (1, 128, tgg.TILES_BN, 64, plan.stages, 384, 132, 1, 1,
                                     plan.smem_bytes)
    dec = tgg.grouped_gemm_plan(32, 4096, 14336, 8, 132)
    assert tgg.launch_args(dec) == (0, 16, 128, 32, 4, 128, 112, 9, 1, 36864)
    for bad in ((0, 4096, 14336, 8), (32, 4096, 14336, 0), (32, 4096, 14336, 257),
                (32, 4096, 14336, 8)):
        with pytest.raises(ValueError):
            tgg.grouped_gemm_plan(*bad, 0 if bad == (32, 4096, 14336, 8) else 132)


def _dense(w: np.ndarray) -> JLinear:
    return JLinear(kind="dense", shape=(w.shape[-2], w.shape[-1]), data={"w": jnp.asarray(w)})


def _jcfg(**over) -> JModelConfig:
    kw = dict(arch="mixtral", vocab_size=64, hidden_size=H, intermediate_size=I, num_layers=1,
              num_heads=4, num_kv_heads=2, head_dim=64, num_experts=E, num_experts_per_tok=TOPK)
    return JModelConfig(**dict(kw, **over))


def _moe_inputs(seed: int = 5, packed: bool = False, q4k_router: bool = False):
    """(JAX mlp params, x [2, 9, H]) of one MoE layer: a router [H, E] and
    experts gate/up [E, H, I], down [E, I, H], dense f32 or Q4_K packed."""
    rng = np.random.default_rng(seed)
    if q4k_router:
        router = quantized(rng, GGMLType.Q4_K, E, H, 0.1)[1]
    else:
        router = _dense((rng.standard_normal((H, E)) * 0.1).astype(np.float32))
    if packed:
        def stack(out_f, in_f):
            return _stack_linears([quantized(rng, GGMLType.Q4_K, out_f, in_f, 0.05)[1]
                                   for _ in range(E)])
        experts = {"gate": stack(I, H), "up": stack(I, H), "down": stack(H, I)}
    else:
        def w(*shape):
            return (rng.standard_normal(shape) * 0.05).astype(np.float32)
        experts = {"gate": _dense(w(E, H, I)), "up": _dense(w(E, H, I)),
                   "down": _dense(w(E, I, H))}
    x = (rng.standard_normal((2, 9, H)) * 0.5).astype(np.float32)
    return {"router": router, "experts": experts}, x


def _port_mlp(jp):
    """The JAX mlp params as the port's (f32, CPU), through the loader's
    Linear conversion."""
    from mistralrs_tpu_torch.models.loader import _convert

    return _convert(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


def _both(jcfg, jp, x, tp=None):
    want = np.asarray(jd._moe_mlp(jcfg, jp, jnp.asarray(x)))
    got = td._moe_mlp(port_config(jcfg), tp or _port_mlp(jp), torch.from_numpy(x))
    return want, got.numpy()


@pytest.mark.parametrize("backend", ["ragged", "gmm"])
def test_moe_mlp_grouped_matches_jax(monkeypatch, backend):
    monkeypatch.setenv("MISTRALRS_MOE_BACKEND", backend)
    calls = []
    monkeypatch.setattr(td, "grouped_matmul", lambda *a: calls.append(1) or tgg.grouped_matmul(*a))
    jp, x = _moe_inputs()
    want, got = _both(_jcfg(moe_grouped=True), jp, x)
    assert len(calls) == 3  # gate, up, down
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_moe_mlp_dense_einsum_matches_jax(monkeypatch):
    monkeypatch.setattr(td, "grouped_matmul", None)  # not this branch
    jp, x = _moe_inputs()
    want, got = _both(_jcfg(moe_grouped=False), jp, x)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("moe_grouped", [True, False])
def test_moe_mlp_packed_q4k_experts_match_jax(monkeypatch, moe_grouped):
    """Packed experts take the every-expert branch whatever moe_grouped
    says; with the GEMV routes off both packages dequantize."""
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)
    monkeypatch.setattr(td, "grouped_matmul", None)
    jp, x = _moe_inputs(packed=True)
    tp = _port_mlp(jp)
    assert tp["experts"]["gate"].data["qs"].shape == (E, H // 2, I)
    want, got = _both(_jcfg(moe_grouped=moe_grouped), jp, x, tp)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_moe_mlp_packed_through_k1_within_q8_tolerance():
    """The same block with the GEMV routes on: K1's plain version rounds
    the activations to int8 per 32, before gate|up and again before down
    (measured 3.5% of the largest |out|; the router is dense, so the
    routing does not move)."""
    jp, x = _moe_inputs(packed=True)
    want, got = _both(_jcfg(), jp, x)
    assert 0 < np.abs(got - want).max() <= 0.05 * np.abs(want).max()


def test_padded_q4k_router_routes_as_jax(monkeypatch):
    """A Q4_K router of 8 outputs is padded to 16 by the port's fusion (the
    GEMVs' column chunk); the padding comes off before the top-k."""
    monkeypatch.setattr(tqm, "MAX_KERNEL_ROWS", -1)
    jp, x = _moe_inputs(seed=7, q4k_router=True)
    tp = _port_mlp(jp)
    from mistralrs_tpu_torch.models.decoder import DecoderParams

    fused = tfuse.fuse_decoder_params(DecoderParams(
        embed=torch.zeros(4, H), layers=[{"attn": {}, "mlp": tp}], final_norm={}))
    router = fused.layers[0]["mlp"]["router"]
    assert router.kind == "gguf_q4k" and router.shape == (H, 16)
    assert fused.layers[0]["mlp"]["experts"] is tp["experts"]
    want, got = _both(_jcfg(moe_grouped=True), jp, x, fused.layers[0]["mlp"])
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_router_ties_pick_the_lower_expert_first():
    """Router columns 1, 2 and 3 are equal, so every token's logits tie
    among them; both packages pick the same experts, lower index first."""
    rng = np.random.default_rng(9)
    col = rng.standard_normal((H, 1)).astype(np.float32)
    w = np.concatenate([col * 0.5, col, col, col], axis=1)  # [H, 4]
    x = np.abs(rng.standard_normal((2, 9, H))).astype(np.float32)
    x[..., :] *= np.sign(col[:, 0])  # x . col > 0, so experts 1-3 lead expert 0
    jp, _ = _moe_inputs()
    jp = dict(jp, router=_dense(w))
    jcfg = _jcfg(moe_grouped=True)
    logits = jnp.asarray(x.reshape(-1, H)) @ jnp.asarray(w)
    _, jidx = jax.lax.top_k(logits, TOPK)
    tw, tidx = td._route(port_config(jcfg), _port_mlp(jp), torch.from_numpy(x.reshape(-1, H)))
    assert (np.asarray(jidx) == [1, 2]).all()
    assert (tidx.numpy() == np.asarray(jidx)).all()
    np.testing.assert_allclose(tw.numpy(), 0.5, rtol=0, atol=0)
    want, got = _both(jcfg, jp, x)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
