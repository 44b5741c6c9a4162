"""Port's DALLE cached decode and dVAE decode vs the JAX package (CPU).

The same weights (a JAX init, carried across by `weights.py`) and the same
numpy inputs go through both. Both sides run the cached flash-decode path
(`attn_impl="flash"`; the tiny cache is below the "auto" threshold): the
JAX side through the Pallas kernel in interpret mode, the port through its
plain version. Pattern-masked layers (axial_row) run dense on both sides.

Tolerances (float32, JAX at matmul precision "highest"): logits 1e-4 and
K/V cache entries 1e-5 absolute, at prefill and after each of the 16
teacher-forced steps; dVAE pixels 1e-5; token-shift rings 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.dalle import DALLE as JDALLE
from dalle_pytorch_tpu.models.dalle import init_decode_cache as j_init_cache
from dalle_pytorch_tpu.models.dvae import DiscreteVAE as JDVAE
from dalle_pytorch_tpu_torch.models.dalle import DALLE, init_decode_cache
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.weights import load_dalle_params, load_dvae_params

torch.set_num_threads(2)

TINY = dict(
    dim=64, depth=2, heads=4, dim_head=16, num_image_tokens=32,
    image_fmap_size=4, num_text_tokens=50, text_seq_len=8,
)
TINY_VAE = dict(image_size=32, num_layers=3, num_tokens=32, codebook_dim=16, hidden_dim=8)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dalle_pair(seed=0, **overrides):
    """(JAX DALLE with attn_impl="flash", its variables, port DALLE with the
    same weights). Initialized dense: parameters do not depend on it."""
    cfg = {**TINY, **overrides}
    dense = JDALLE(**cfg, attn_impl="dense")
    variables = jax.jit(dense.init)(
        jax.random.PRNGKey(seed),
        jnp.ones((1, cfg["text_seq_len"]), jnp.int32),
        jnp.zeros((1, cfg["image_fmap_size"] ** 2), jnp.int32),
    )
    port = DALLE(**cfg, attn_impl="flash")
    load_dalle_params(port, _numpy_tree(variables["params"]))
    return dense.clone(attn_impl="flash"), variables, port.eval()


def _vae_pair(seed=3, **overrides):
    cfg = {**TINY_VAE, **overrides}
    jv = JDVAE(**cfg)
    vparams = jax.jit(jv.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, cfg["image_size"], cfg["image_size"], 3))
    )
    port = DiscreteVAE(**cfg)
    load_dvae_params(port, _numpy_tree(vparams["params"]))
    return jv, vparams, port.eval()


def _text(b, seed):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, TINY["num_text_tokens"], (b, TINY["text_seq_len"])).astype(np.int32)
    text[:, 5:] = 0  # padding positions become unique pad ids
    return text


def _assert_cache_close(jcache, pcache):
    for name, jl in jcache.items():
        pl = pcache[name]
        assert pl["attn"]["index"] == int(jl["attn"]["index"])
        for key in ("k", "v"):
            np.testing.assert_allclose(
                pl["attn"][key].numpy(), np.asarray(jl["attn"][key]), atol=1e-5, rtol=0
            )
        for key in ("shift_attn", "shift_ff"):
            if key in jl:
                np.testing.assert_allclose(
                    pl[key].numpy(), np.asarray(jl[key]), atol=1e-5, rtol=0
                )


CONFIGS = {
    "full-shift-rotary": dict(attn_types=("full",), shift_tokens=True, rotary_emb=True),
    "full-plain": dict(attn_types=("full",), shift_tokens=False, rotary_emb=False),
    "axial-shift": dict(attn_types=("full", "axial_row"), shift_tokens=True, rotary_emb=False),
    "axial-rotary-stable-sandwich": dict(
        attn_types=("full", "axial_row"), shift_tokens=False, rotary_emb=True,
        stable=True, sandwich_norm=True,
    ),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_teacher_forced_steps(name):
    jm, variables, pm = _dalle_pair(seed=len(name), **CONFIGS[name])
    b = 2
    text = _text(b, seed=1)
    img = np.random.RandomState(2).randint(0, TINY["num_image_tokens"], (b, 16)).astype(np.int32)

    prefill = jax.jit(lambda v, t, c: jm.apply(v, t, c, method=JDALLE.decode_prefill))
    step = jax.jit(lambda v, tok, i, c: jm.apply(v, tok, i, c, method=JDALLE.decode_image_step))
    jrow, jcache = prefill(variables, jnp.asarray(text), j_init_cache(jm, b))
    pcache = init_decode_cache(pm, b)
    with torch.inference_mode():
        prow, _ = pm.decode_prefill(torch.from_numpy(text), pcache)
        np.testing.assert_allclose(prow.numpy(), np.asarray(jrow), atol=1e-4, rtol=0)
        _assert_cache_close(jcache, pcache)
        for i in range(img.shape[1]):
            jrow, jcache = step(variables, jnp.asarray(img[:, i]), jnp.int32(i), jcache)
            prow, _ = pm.decode_image_step(torch.from_numpy(img[:, i]), i, pcache)
            np.testing.assert_allclose(prow.numpy(), np.asarray(jrow), atol=1e-4, rtol=0)
        _assert_cache_close(jcache, pcache)


@pytest.mark.parametrize("res_blocks", [0, 1])
def test_dvae_decode_pixels(res_blocks):
    jv, vparams, pv = _vae_pair(num_resnet_blocks=res_blocks)
    toks = np.random.RandomState(4).randint(0, TINY_VAE["num_tokens"], (2, 16)).astype(np.int32)
    ref = jv.apply(vparams, jnp.asarray(toks), method=JDVAE.decode)
    with torch.inference_mode():
        out = pv.decode(torch.from_numpy(toks))
    assert out.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_weight_loader_names_mismatched_leaves():
    _, variables, pm = _dalle_pair(seed=7)
    tree = _numpy_tree(variables["params"])
    extra = copy.deepcopy(tree)
    extra["bogus"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="bogus"):
        load_dalle_params(pm, extra)
    missing = copy.deepcopy(tree)
    del missing["logits_dense"]["bias"]
    with pytest.raises(ValueError, match="logits_dense/bias"):
        load_dalle_params(pm, missing)
    scan = copy.deepcopy(tree)
    scan["transformer"] = {"scan_stack": {}}
    with pytest.raises(ValueError, match="scan-layout"):
        load_dalle_params(pm, scan)
    bad_shape = copy.deepcopy(tree)
    bad_shape["text_emb"]["embedding"] = bad_shape["text_emb"]["embedding"][:-1]
    with pytest.raises(ValueError, match="text_emb/embedding"):
        load_dalle_params(pm, bad_shape)
