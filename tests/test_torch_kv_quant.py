"""The port's int8 KV cache vs the JAX package's (CPU).

Quantization: int8 values equal and scales within 1e-7 of the JAX
`_kv_quantize` (both fp32, round half to even). The plain int8 arm of
flash decode against the JAX Pallas kernel (interpret mode) on the same
int8 cache and scales: 1e-5 (fp32, summation order only). The tiny int8
model (the JAX model cloned with kv_dtype="int8", the port model with the
same attribute and weights): prefill and 16 teacher-forced step logits
within 1e-4, as the float cache's test holds them — full layers run the
flash arm, axial_row layers the dense arm over the dequantized cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.attention import _kv_quantize as j_quantize
from dalle_pytorch_tpu.models.dalle import DALLE as JDALLE
from dalle_pytorch_tpu.models.dalle import init_decode_cache as j_init_cache
from dalle_pytorch_tpu.ops.pallas_decode import flash_decode_attention as j_flash_decode
from dalle_pytorch_tpu_torch.models.attention import _kv_dequantize, _kv_quantize
from dalle_pytorch_tpu_torch.models.dalle import init_decode_cache
from dalle_pytorch_tpu_torch.models.transformer import make_decode_cache
from dalle_pytorch_tpu_torch.ops.flash_decode import (
    flash_decode_attention,
    flash_decode_attention_plain,
)
from test_torch_dalle import TINY, _dalle_pair, _text

torch.set_num_threads(2)


def _values(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.choice([0.05, 1.0, 4.0], size=shape[:-1] + (1,))).astype(
        np.float32
    )
    x[0, 0, 0] = 0.0  # an all-zero row
    x[0, 0, 1, 0] = 127.5 * np.abs(x[0, 0, 1]).max() / 127.0  # ties at the extreme
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_matches_reference(dtype):
    x = _values((2, 3, 7, 16), seed=0)
    x = torch.from_numpy(x).to(dtype).float().numpy()  # representable in both dtypes
    jq, js = j_quantize(jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
    q, s = _kv_quantize(torch.from_numpy(x).to(dtype))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (2, 3, 7)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-7)
    assert torch.equal(q[0, 0, 0], torch.zeros(16, dtype=torch.int8))
    back = _kv_dequantize(q, s)
    assert (back - torch.from_numpy(x)).abs().max() <= s.max() / 2 + 1e-6


def _int8_cache(b, h, s, d, seed):
    """An int8 cache and its scales, quantized once (by the JAX function)
    and handed to both packages."""
    k = _values((b, h, s, d), seed)
    v = _values((b, h, s, d), seed + 1)
    (kq, ks), (vq, vs) = (j_quantize(jnp.asarray(t)) for t in (k, v))
    return [np.array(t) for t in (kq, ks, vq, vs)]


@pytest.mark.parametrize(
    "b,h,n,s,d,lengths,block_k",
    [
        (4, 2, 1, 37, 16, [1, 9, 20, 37], 8),
        (3, 2, 5, 40, 32, [5, 17, 40], 16),
        (2, 4, 3, 70, 64, [33, 70], 16),
        (2, 2, 3, 40, 48, [17, 40], 8),
    ],
)
def test_int8_arm_matches_the_pallas_kernel(b, h, n, s, d, lengths, block_k):
    q = np.random.RandomState(7).randn(b, h, n, d).astype(np.float32)
    kq, ks, vq, vs = _int8_cache(b, h, s, d, seed=n)
    lengths = np.asarray(lengths, np.int32)
    ref = j_flash_decode(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(lengths),
        block_k=block_k, interpret=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
    )
    args = [torch.from_numpy(t) for t in (q, kq, vq, lengths, ks, vs)]
    out = flash_decode_attention(*args)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert torch.equal(out, flash_decode_attention_plain(*args))


def test_int8_arm_counts_no_launch_on_the_cpu_and_checks_its_inputs():
    q = torch.randn(1, 2, 1, 16)
    kq, ks, vq, vs = (torch.from_numpy(t) for t in _int8_cache(1, 2, 8, 16, seed=3))
    lengths = torch.tensor([8], dtype=torch.int32)
    before = (flash_decode_attention.launches, flash_decode_attention.int8_launches)
    flash_decode_attention(q, kq, vq, lengths, ks, vs)
    assert (flash_decode_attention.launches, flash_decode_attention.int8_launches) == before
    with pytest.raises(ValueError, match="both"):
        flash_decode_attention(q, kq, vq, lengths, ks, None)
    with pytest.raises(TypeError, match="int8"):
        flash_decode_attention(q, kq.float(), vq.float(), lengths, ks, vs)
    with pytest.raises(ValueError, match="scales"):
        flash_decode_attention(q, kq, vq, lengths, ks[..., :4].contiguous(), vs[..., :4].contiguous())


@pytest.mark.parametrize("per_row", [False, True])
def test_default_cache_has_no_scale_leaves(per_row):
    kw = dict(depth=2, batch=3, max_len=9, heads=2, dim_head=16, dim=32, image_fmap_size=2,
              shift_tokens=True, dtype=torch.bfloat16, per_row=per_row)
    plain = make_decode_cache(**kw)
    for layer in plain.values():
        assert set(layer["attn"]) == {"k", "v", "index"}
        assert layer["attn"]["k"].dtype == torch.bfloat16
        assert layer["shift_attn"].dtype == torch.bfloat16
    quant = make_decode_cache(**kw, kv_dtype="int8")
    for layer in quant.values():
        attn = layer["attn"]
        assert set(attn) == {"k", "v", "index", "k_scale", "v_scale"}
        assert attn["k"].dtype == attn["v"].dtype == torch.int8
        assert attn["k_scale"].shape == (3, 2, 9) and attn["k_scale"].dtype == torch.float32
        assert layer["shift_ff"].dtype == torch.bfloat16
        if per_row:
            assert attn["index"].shape == (3,) and attn["index"].dtype == torch.int32
        else:
            assert attn["index"] == 0
    with pytest.raises(ValueError, match="kv_dtype"):
        make_decode_cache(**kw, kv_dtype="fp8")


def _j_int8_cache_close(jcache, pcache):
    """Dequantized K/V of the two int8 caches agree within one step of
    the coarser scale (a rounding tie may land either side)."""
    for name, jl in jcache.items():
        ja, pa = jl["attn"], pcache[name]["attn"]
        for key in ("k", "v"):
            jd = np.asarray(ja[key], np.float32) * np.asarray(ja[f"{key}_scale"])[..., None]
            pd = _kv_dequantize(pa[key], pa[f"{key}_scale"]).numpy()
            step = np.asarray(ja[f"{key}_scale"]).max()
            np.testing.assert_allclose(pd, jd, atol=step + 1e-6, rtol=0)


@pytest.mark.parametrize(
    "config",
    [
        dict(attn_types=("full",), shift_tokens=True, rotary_emb=True),
        dict(attn_types=("full", "axial_row"), shift_tokens=True, rotary_emb=False),
    ],
    ids=["full-shift-rotary", "axial-shift"],
)
def test_int8_model_prefill_and_steps_match_the_reference(config):
    jm, variables, pm = _dalle_pair(seed=21, **config)
    jm = jm.clone(kv_dtype="int8")
    pm.kv_dtype = "int8"
    b = 2
    text = _text(b, seed=1)
    img = np.random.RandomState(2).randint(0, TINY["num_image_tokens"], (b, 16)).astype(np.int32)
    prefill = jax.jit(lambda v, t, c: jm.apply(v, t, c, method=JDALLE.decode_prefill))
    step = jax.jit(lambda v, tok, i, c: jm.apply(v, tok, i, c, method=JDALLE.decode_image_step))
    jrow, jcache = prefill(variables, jnp.asarray(text), j_init_cache(jm, b))
    pcache = init_decode_cache(pm, b)
    assert pcache["layer_0"]["attn"]["k"].dtype == torch.int8
    with torch.inference_mode():
        prow, _ = pm.decode_prefill(torch.from_numpy(text), pcache)
        np.testing.assert_allclose(prow.numpy(), np.asarray(jrow), atol=1e-4, rtol=0)
        for i in range(img.shape[1]):
            jrow, jcache = step(variables, jnp.asarray(img[:, i]), jnp.int32(i), jcache)
            prow, _ = pm.decode_image_step(torch.from_numpy(img[:, i]), i, pcache)
            np.testing.assert_allclose(prow.numpy(), np.asarray(jrow), atol=1e-4, rtol=0)
    _j_int8_cache_close(jcache, pcache)
