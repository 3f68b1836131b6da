"""The plain version of the splash prefill kernel K11 (`splash_prefill`)
against the JAX package's `splash_prefill`, which runs the library Pallas
splash kernel, here in interpret mode, on the CPU where the port's wrapper
takes the plain version.

f32 cases: 1e-5 of the largest |output| (f32 sums in another order); the
cases cover windows inside a block (48), past the chunk (300) and none, the
soft cap 50 and none, 1 and 2 query heads per kv head, head dims 64 and
256, chunks of 128 and 256 rows. Each distinct (T, G, window, soft cap)
compiles a splash kernel once (~5 s). One bf16 case: 1e-2 (the two round
the scaled q, the probabilities and the output to bf16 at other places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistralrs_tpu.ops import splash as jsplash
from mistralrs_tpu_torch.ops import splash as tsplash

TIGHT = 1e-5
BF16 = 1e-2

# (B, T, Hq, Hkv, D, window, softcap)
CASES = [
    (1, 128, 4, 2, 64, None, 50.0),
    (2, 128, 2, 2, 256, 48, None),
    (1, 256, 4, 2, 256, 48, 50.0),
    (1, 256, 2, 2, 64, 300, 50.0),
    (1, 128, 4, 2, 256, None, None),
    (2, 256, 4, 2, 64, 100, None),
]


def _inputs(B, T, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    # |q| large enough that scale * q.k reaches the cap's bend
    q = (rng.standard_normal((B, T, Hq, D)) * 4).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    return q, k, v


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize("B,T,Hq,Hkv,D,window,cap", CASES)
def test_plain_matches_jax_splash_kernel(B, T, Hq, Hkv, D, window, cap):
    q, k, v = _inputs(B, T, Hq, Hkv, D, seed=T + D + Hq)
    scale = D ** -0.5
    want = jsplash.splash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
                                  sliding_window=window, logits_softcap=cap, interpret=True)
    before = tsplash.splash_prefill_launches
    got = tsplash.splash_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 scale=scale, sliding_window=window, logits_softcap=cap)
    # CPU tensors take the plain version: no kernel launch is counted
    assert tsplash.splash_prefill_launches == before
    assert got.dtype == torch.float32
    _close(got.numpy(), want, TIGHT)


def test_plain_matches_jax_splash_kernel_in_bf16():
    B, T, Hq, Hkv, D, window, cap = CASES[2]
    q, k, v = _inputs(B, T, Hq, Hkv, D, seed=7)
    scale = D ** -0.5
    want = jsplash.splash_prefill(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale=scale,
                                  sliding_window=window, logits_softcap=cap, interpret=True)
    got = tsplash.splash_prefill(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                                 scale=scale, sliding_window=window, logits_softcap=cap)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), BF16)


def test_window_of_one_keeps_only_the_diagonal():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 2, 1, 8, seed=1))
    out = tsplash.splash_prefill(q, k, v, scale=0.1, sliding_window=1)
    torch.testing.assert_close(out, v.expand(1, 16, 2, 8), rtol=0, atol=1e-6)


def test_plain_folds_the_scale_into_q_in_its_dtype():
    """A scale that bf16 cannot hold (144 ** -0.5): the plain version rounds
    q * bf16(scale) to bf16 first, as the JAX function and the kernel do."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 32, 2, 2, 16, seed=2))
    scale = 144 ** -0.5
    got = tsplash.splash_prefill_plain(q, k, v, scale=scale)
    qs = (q * torch.tensor(scale, dtype=torch.bfloat16)).float()
    want = tsplash.splash_prefill_plain(qs, k.float(), v.float(), scale=1.0)
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


def test_wrapper_checks_shapes_on_any_device():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 2, 8, seed=3))
    with pytest.raises(ValueError):  # 3 query heads over 2 kv heads
        tsplash.splash_prefill(q[:, :, :3], k, v, scale=0.1)
    with pytest.raises(ValueError):  # k and v of different lengths
        tsplash.splash_prefill(q, k, v[:, :8], scale=0.1)
    with pytest.raises(ValueError):  # a window of 0
        tsplash.splash_prefill(q, k, v, scale=0.1, sliding_window=0)
    with pytest.raises(ValueError):  # a negative cap
        tsplash.splash_prefill(q, k, v, scale=0.1, logits_softcap=-1.0)
