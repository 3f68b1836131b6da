"""The decoder's attention routes (models/decoder.py `_attention_route`).

On the CPU the JAX package's shape rules alone pick the kernel (the plain
versions take any shape). On "cuda" a kernel is picked only where its card
kernel takes the step (bf16, its head dims, a power-of-two page, its GQA
ratio); every other step takes the gather route, on a combined pool over
its split K/V views. Pure Python but the last test, which runs a tiny
model on the CPU through that gather route on a combined pool.
"""

import dataclasses

import pytest
import torch

from mistralrs_tpu_torch.models import decoder as td
from mistralrs_tpu_torch.models.config import ModelConfig
from mistralrs_tpu_torch.models.loader import make_rope
from mistralrs_tpu_torch.ops.paged_attention import PagedAttnMeta, PagedKVCache
from mistralrs_tpu_torch.quant.qlinear import Linear

BF16, F32 = torch.bfloat16, torch.float32


def _cfg(D=128, heads=32, kv_heads=8, cap=None, window=None, pattern="none"):
    return ModelConfig(arch="mistral", vocab_size=256, hidden_size=heads * D,
                       intermediate_size=512, num_layers=2, num_heads=heads,
                       num_kv_heads=kv_heads, head_dim=D, max_position_embeddings=8192,
                       attn_logit_softcap=cap, sliding_window=window,
                       sliding_window_pattern=pattern)


def _meta(first_chunk=False, head_major=False):
    z = torch.zeros(1, 1, dtype=torch.int64)
    return PagedAttnMeta(positions=z, slot_mapping=z, block_tables=z,
                         kv_lens=torch.ones(1, dtype=torch.int64), active=torch.ones(1),
                         first_chunk=first_chunk, head_major=head_major)


# (step, T, first chunk, head-major pool, span, combined pool): a first chunk
# of 128-row blocks, decode at span 4096 on a head-major pool, a continuation
# chunk at span 2048, and decode on a combined pool
STEPS = {"first": (256, True, False, 256, False),
         "decode": (1, False, True, 4096, False),
         "continuation": (128, False, False, 2048, False),
         "combined decode": (1, False, False, 4096, True)}
# the kernel each step takes where nothing refuses it
KERNEL = {"first": "flash", "decode": "decode", "continuation": "continuation",
          "combined decode": "ragged"}


def _route(cfg, step, device_type, dtype=BF16, kv_dtype=BF16, page=16):
    T, first, hm, span, combined = STEPS[step]
    return td._attention_route(cfg, T, _meta(first, hm), span, combined=combined,
                               device_type=device_type, dtype=dtype, kv_dtype=kv_dtype,
                               page=page)


@pytest.mark.parametrize("step", list(STEPS))
@pytest.mark.parametrize("D,dtype,kv_heads", [(128, BF16, 8), (64, BF16, 8), (128, F32, 8),
                                              (128, BF16, 1)])
def test_cpu_routes_are_the_shape_rules(step, D, dtype, kv_heads):
    """On the CPU a D 64, f32 or GQA-32 step takes the same kernel as a
    bf16 D 128 one: the plain versions take any shape."""
    cfg = _cfg(D=D, kv_heads=kv_heads)
    assert _route(cfg, step, "cpu", dtype, dtype) == KERNEL[step]
    # the default is the CPU's rule
    T, first, hm, span, combined = STEPS[step]
    assert td._attention_route(cfg, T, _meta(first, hm), span, combined) == KERNEL[step]


@pytest.mark.parametrize("step", list(STEPS))
def test_card_routes_keep_the_kernels_that_take_the_step(step):
    assert _route(_cfg(), step, "cuda") == KERNEL[step]


# what the card kernels refuse: (name, config keywords, dtype, kv dtype, page)
REFUSED = [("D 64", dict(D=64), BF16, BF16, 16),
           ("f32", {}, F32, F32, 16),
           ("f32 pool", {}, BF16, F32, 16),
           ("page 24", {}, BF16, BF16, 24)]


@pytest.mark.parametrize("step", list(STEPS))
@pytest.mark.parametrize("name,over,dtype,kv_dtype,page", REFUSED)
def test_card_routes_gather_what_the_kernels_refuse(step, name, over, dtype, kv_dtype, page):
    """On "cuda", D 64, f32 activations or pools, and a page that is not a
    power of two take the gather route (a combined pool's too, over its
    split views), but for a first chunk, whose flash kernel reads the
    chunk's own K/V, not the pool."""
    got = _route(_cfg(**over), step, "cuda", dtype, kv_dtype, page)
    kernel_reads_no_pool = step == "first" and name in ("f32 pool", "page 24")
    assert got == (KERNEL[step] if kernel_reads_no_pool else "gather"), (name, step)


def test_card_routes_by_gqa_ratio():
    """K7 takes at most 16 query heads a kv head, K12 a power of two up to
    16; K6 and K6' any ratio."""
    for heads, kv_heads, decode, ragged in [(32, 2, "decode", "ragged"),
                                            (32, 1, "gather", "gather"),
                                            (24, 2, "decode", "gather"),
                                            (12, 4, "decode", "gather")]:
        cfg = _cfg(heads=heads, kv_heads=kv_heads)
        assert _route(cfg, "decode", "cuda") == decode, (heads, kv_heads)
        assert _route(cfg, "combined decode", "cuda") == ragged, (heads, kv_heads)
        assert _route(cfg, "first", "cuda") == "flash"
        assert _route(cfg, "continuation", "cuda") == "continuation"


def test_card_routes_at_head_dim_256():
    """Gemma-2's D 256 with a soft cap: K11 on first chunks, K7 and K12 at
    decode, the gather route for a continuation chunk (K6' takes D 128
    only, and no cap); without a cap K6 refuses D 256, so the first chunk
    gathers on the card."""
    capped = _cfg(D=256, heads=16, kv_heads=8, cap=50.0)
    assert _route(capped, "first", "cuda") == "splash"
    assert _route(capped, "decode", "cuda") == "decode"
    assert _route(capped, "combined decode", "cuda") == "ragged"
    assert _route(capped, "continuation", "cuda") == "gather"
    plain = _cfg(D=256, heads=16, kv_heads=8)
    assert _route(plain, "first", "cuda") == "gather"
    assert _route(plain, "first", "cpu") == "flash"


def _tiny(D=64):
    """A tiny dense llama (2 layers, 4 heads of D over 2 kv heads) with
    seeded f32 weights on the CPU."""
    from mistralrs_tpu_torch.models.decoder import DecoderParams

    cfg = dataclasses.replace(_cfg(D=D, heads=4, kv_heads=2), hidden_size=256,
                              max_position_embeddings=1024)
    g = torch.Generator().manual_seed(0)
    H, I = cfg.hidden_size, cfg.intermediate_size

    def dense(i, o, std=0.05):
        return Linear("dense", (i, o), {"w": torch.randn(i, o, generator=g) * std})

    layers = [{"attn": {"q": dense(H, 4 * D), "k": dense(H, 2 * D), "v": dense(H, 2 * D),
                        "o": dense(4 * D, H)},
               "mlp": {"gate": dense(H, I), "up": dense(H, I), "down": dense(I, H)},
               "input_norm": {"w": torch.ones(H)}, "post_attn_norm": {"w": torch.ones(H)}}
              for _ in range(cfg.num_layers)]
    params = DecoderParams(embed=torch.randn(cfg.vocab_size, H, generator=g), layers=layers,
                           final_norm={"w": torch.ones(H)})
    return cfg, params


def test_gather_over_a_combined_pool_matches_the_ragged_route(monkeypatch):
    """The route a card takes for a step K12 refuses: a 3-row decode step
    on a combined pool, gathered over its split K/V views, gives the
    ragged route's hidden states (K12's plain version) on the CPU."""
    cfg, params = _tiny()
    rope = make_rope(cfg, 1024, device="cpu")
    B, page, n_pages = 3, 16, 4
    cache = PagedKVCache.create(cfg.num_layers, 1 + B * n_pages, page, cfg.num_kv_heads,
                                cfg.head_dim, F32, device="cpu", combined=True)
    g = torch.Generator().manual_seed(1)
    cache.k.copy_(torch.randn(cache.k.shape, generator=g))
    kv_lens = torch.tensor([5, 33, 60])
    tables = (1 + torch.arange(B * n_pages)).reshape(B, n_pages)
    pos = (kv_lens - 1)[:, None]
    meta = PagedAttnMeta(positions=pos, block_tables=tables, kv_lens=kv_lens,
                         slot_mapping=torch.gather(tables, 1, pos // page) * page + pos % page,
                         active=torch.ones(B))
    ids = torch.randint(1, cfg.vocab_size, (B, 1), generator=g)
    pool = cache.k.clone()
    want, _ = td.decoder_forward(params, cfg, rope, ids, cache, meta)
    routes = []
    real = td._attention_route

    def gather_route(*a, **kw):
        routes.append(real(*a, **kw))
        return "gather"

    monkeypatch.setattr(td, "_attention_route", gather_route)
    cache.k.copy_(pool)
    got, _ = td.decoder_forward(params, cfg, rope, ids, cache, meta)
    assert routes == ["ragged"]
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
