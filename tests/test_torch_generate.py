"""The port's generation samplers vs the JAX package's (CPU).

The same weights and numpy inputs go through both. Logits of
`forward_with_cond_scale` within 1e-4; greedy tokens (a `filter_thres` of
1.0 keeps one logit a row, so the two packages' different noise plays no
part) of the uncached `generate_images` oracle, of
`generate_images_cached` with priming and classifier-free guidance, and of
`generate_texts` identical. The samplers run dense on both sides (their
logic is what is held here; the kernels' parity is in the flash tests).
Also the cached decode of the pattern layers the engine tests do not
reach (axial_col, conv_like, sparse) against the JAX decode: logits of the
prefill and of 4 teacher-forced steps within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import dalle as jd
from dalle_pytorch_tpu.ops import sampling as jsampling
from dalle_pytorch_tpu_torch.models.dalle import (
    forward_with_cond_scale,
    generate_images,
    generate_images_cached,
    generate_texts,
    init_decode_cache,
)
from dalle_pytorch_tpu_torch.ops.sampling import gumbel_noise, keep_count, row_seed, top_k_filter
from test_torch_dalle import TINY, _dalle_pair, _text

torch.set_num_threads(2)
MODEL = dict(attn_types=("full", "axial_row"), shift_tokens=True, rotary_emb=True)
GREEDY = 1.0  # filter_thres keeping max(int(0 * V), 1) = 1 logit


@pytest.fixture(scope="module")
def pair():
    jm, variables, pm = _dalle_pair(seed=23, **MODEL)
    for attn in pm.transformer.attn.values():
        attn.attn_impl = "dense"
    return jm.clone(attn_impl="dense"), variables, pm


def _image(b, seed, n=16):
    return np.random.RandomState(seed).randint(0, TINY["num_image_tokens"], (b, n)).astype(np.int32)


@pytest.mark.parametrize("cond_scale", [1.0, 3.0])
def test_forward_with_cond_scale_logits(pair, cond_scale):
    jm, variables, pm = pair
    text, img = _text(2, seed=3), _image(2, seed=4, n=10)
    ref = jd.forward_with_cond_scale(jm, variables, jnp.asarray(text), jnp.asarray(img), cond_scale)
    with torch.inference_mode():
        out = forward_with_cond_scale(pm, torch.from_numpy(text), torch.from_numpy(img), cond_scale)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("primed", [None, 6])
def test_uncached_oracle_greedy_tokens(pair, primed):
    jm, variables, pm = pair
    text = _text(2, seed=5)
    init = _image(2, seed=6)
    kw = dict(init_image_tokens=init, num_init_img_tokens=primed) if primed else {}
    ref = jd.generate_images(jm, variables, jax.random.PRNGKey(0), jnp.asarray(text),
                             filter_thres=GREEDY, **{k: jnp.asarray(v) if k == "init_image_tokens" else v
                                                     for k, v in kw.items()})
    out = generate_images(pm, torch.from_numpy(text), seed=0, filter_thres=GREEDY, **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    if primed:
        np.testing.assert_array_equal(out.numpy()[:, :primed], init[:, :primed])


def test_cached_sampler_primed_with_guidance_greedy_tokens(pair):
    jm, variables, pm = pair
    text = _text(3, seed=7)
    init = _image(3, seed=8)
    ref = jd.generate_images_cached(
        jm, variables, jax.random.PRNGKey(0), jnp.asarray(text), filter_thres=GREEDY,
        cond_scale=3.0, init_image_tokens=jnp.asarray(init), num_init_img_tokens=5,
    )
    out = generate_images_cached(pm, torch.from_numpy(text), seed=0, filter_thres=GREEDY,
                                 cond_scale=3.0, init_image_tokens=init, num_init_img_tokens=5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy()[:, :5], init[:, :5])
    # the default priming length is the reference's 43.75% of the grid
    out_default = generate_images_cached(pm, torch.from_numpy(text), seed=0, filter_thres=GREEDY,
                                         init_image_tokens=init)
    np.testing.assert_array_equal(out_default.numpy()[:, :7], init[:, :7])


def test_generate_texts_greedy_tokens(pair):
    jm, variables, pm = pair
    text = _text(2, seed=9)
    text[:, 3:] = 0
    ref = jd.generate_texts(jm, variables, jax.random.PRNGKey(0), jnp.asarray(text), 3,
                            filter_thres=GREEDY)
    out = generate_texts(pm, torch.from_numpy(text), 3, seed=0, filter_thres=GREEDY)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy()[:, :3], text[:, :3])


def test_cached_and_uncached_samplers_draw_the_same_noise(pair):
    """Sampled (not greedy) tokens: the cached sampler and the uncached
    oracle key row r's noise at position p by (row_seed(seed, r), p) alike,
    and their logits agree to float32 rounding, so they sample the same
    tokens; per-row seeds given as a list match an int seed's rows."""
    _, _, pm = pair
    text = torch.from_numpy(_text(2, seed=10))
    cached = generate_images_cached(pm, text, seed=11, filter_thres=0.5, temperature=1.0)
    uncached, margins = generate_images(pm, text, seed=11, filter_thres=0.5, temperature=1.0,
                                        return_margins=True)
    np.testing.assert_array_equal(cached.numpy(), uncached.numpy())
    assert torch.isfinite(margins).all() and (margins >= 0).all()
    rows = [row_seed(11, r) for r in range(2)]
    np.testing.assert_array_equal(
        generate_images(pm, text, seed=rows, filter_thres=0.5).numpy(), uncached.numpy()
    )
    assert not np.array_equal(
        generate_images(pm, text, seed=12, filter_thres=0.5).numpy(), uncached.numpy()
    )


def test_top_k_filter_matches_the_reference():
    logits = np.random.RandomState(12).randn(3, 50).astype(np.float32)
    logits[1, :5] = logits[1, 5]  # ties with the k-th are kept
    for thres in (0.0, 0.5, 0.9, GREEDY):
        ref = jsampling.top_k_filter(jnp.asarray(logits), thres)
        out = top_k_filter(torch.from_numpy(logits), thres)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert keep_count(thres, 50) == max(int((1 - thres) * 50), 1)
    noise = gumbel_noise([1, 2], 3, 50, "cpu")
    np.testing.assert_array_equal(noise, gumbel_noise([1, 2], 3, 50, "cpu"))


@pytest.mark.parametrize("attn_type", ["axial_col", "conv_like", "sparse"])
def test_pattern_layers_decode_through_the_cache(attn_type):
    """The cached decode of a model with `attn_type` layers (dense under
    its pattern mask on both sides) against the JAX decode: logits of the
    prefill and 4 teacher-forced steps within 1e-4."""
    jm, variables, pm = _dalle_pair(seed=31, attn_types=("full", attn_type), shift_tokens=True,
                                    rotary_emb=True)
    b = 2
    text, img = _text(b, seed=13), _image(b, seed=14)
    prefill = jax.jit(lambda v, t, c: jm.apply(v, t, c, method=jd.DALLE.decode_prefill))
    step = jax.jit(lambda v, tok, i, c: jm.apply(v, tok, i, c, method=jd.DALLE.decode_image_step))
    jrow, jcache = prefill(variables, jnp.asarray(text), jd.init_decode_cache(jm, b))
    pcache = init_decode_cache(pm, b)
    with torch.inference_mode():
        prow, _ = pm.decode_prefill(torch.from_numpy(text), pcache)
        np.testing.assert_allclose(prow.numpy(), np.asarray(jrow), atol=1e-4, rtol=0)
        for i in range(4):
            jrow, jcache = step(variables, jnp.asarray(img[:, i]), jnp.int32(i), jcache)
            prow, _ = pm.decode_image_step(torch.from_numpy(img[:, i]), i, pcache)
            np.testing.assert_allclose(prow.numpy(), np.asarray(jrow), atol=1e-4, rtol=0)
