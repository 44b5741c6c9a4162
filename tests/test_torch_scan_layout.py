"""Scan-layout checkpoints between the JAX package and the port (CPU).

The JAX package's `executor="scan"` keeps a transformer's layers as one
depth-stacked parameter collection. The port trains unrolled modules and
converts at its edges (`models/transformer.py:scan_params_to_unrolled` /
`unrolled_params_to_scan`, `weights.py`).

* A JAX scan DALLE and a JAX scan CLIP, initialized as such, load into the
  port and give JAX's logits (1e-4) and scores (1e-5).
* The port's scan exports load into the JAX scan models with the same
  outputs, and equal the JAX conversion of the unrolled export exactly.
* The Adam leaves in the scan layout: a JAX scan step's state loads into
  the port and exports back bit for bit, its moments land on the right
  weights (the JAX conversion of its mu / nu trees, exactly), and the
  port's leaves pass the JAX `restore_opt_state` with no warning.
* A configuration the JAX scan executor refuses is refused by the port's
  scan export with the same words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training import train_state

from dalle_pytorch_tpu.models.clip import CLIP as JCLIP
from dalle_pytorch_tpu.models.dalle import DALLE as JDALLE
from dalle_pytorch_tpu.models.transformer import Transformer as JTransformer
from dalle_pytorch_tpu.models.transformer import scan_params_to_unrolled as j_to_unrolled
from dalle_pytorch_tpu.models.transformer import unrolled_params_to_scan as j_to_scan
from dalle_pytorch_tpu.training import pipeline as jpipeline
from dalle_pytorch_tpu.training import steps as jsteps
from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.training.pipeline import load_clip_checkpoint, save_clip_checkpoint
from dalle_pytorch_tpu_torch.training.steps import make_dalle_train_step, make_optimizer
from dalle_pytorch_tpu_torch.weights import (
    dalle_tree_layout,
    export_clip_params,
    export_dalle_opt_state,
    export_dalle_params,
    load_clip_params,
    load_dalle_opt_state,
    load_dalle_params,
)
from test_torch_dalle import TINY, _text

torch.set_num_threads(2)

CONFIGS = {
    "full-shift-rotary": dict(shift_tokens=True, rotary_emb=True, attn_impl="flash"),
    "axial-sandwich-dense": dict(attn_types=("full", "axial_row"), sandwich_norm=True,
                                 attn_impl="dense"),
}
CLIP_CFG = dict(dim_text=32, dim_image=32, dim_latent=16, num_text_tokens=40, text_enc_depth=2,
                text_seq_len=8, text_heads=2, visual_enc_depth=2, visual_heads=2,
                visual_image_size=16, visual_patch_size=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _image(seed, b=2):
    return np.random.RandomState(seed).randint(0, TINY["num_image_tokens"], (b, 16)).astype(np.int32)


def _jax_scan_dalle(cfg, seed):
    model = JDALLE(**TINY, **cfg, executor="scan")
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(_text(1, 0)),
                        jnp.asarray(_image(0, 1)))["params"]
    return model, _np(params)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_a_jax_scan_dalle_loads_with_its_logits(name):
    jm, params = _jax_scan_dalle(CONFIGS[name], seed=len(name))
    assert dalle_tree_layout(params) == "scan"
    model = load_dalle_params(DALLE(**TINY, **CONFIGS[name]), params).eval()
    text, img = _text(2, 5), _image(6)
    ref = jm.apply({"params": params}, jnp.asarray(text), jnp.asarray(img))
    with torch.no_grad():
        out = model(torch.from_numpy(text), torch.from_numpy(img))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_port_scan_export_loads_in_the_jax_scan_model(name):
    torch.manual_seed(len(name))
    model = DALLE(**TINY, **CONFIGS[name]).eval()
    tree = export_dalle_params(model, layout="scan")
    unrolled = export_dalle_params(model)
    expect = _flat({**unrolled, "transformer": j_to_scan(unrolled["transformer"], TINY["depth"])})
    got = _flat(tree)
    assert sorted(got) == sorted(expect)
    for path, leaf in expect.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)

    jm = JDALLE(**TINY, **CONFIGS[name], executor="scan")
    text, img = _text(2, 7), _image(8)
    ref = jm.apply({"params": tree}, jnp.asarray(text), jnp.asarray(img))
    with torch.no_grad():
        out = model(torch.from_numpy(text), torch.from_numpy(img))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    # and back: the scan tree loads into a fresh port model bit for bit
    again = load_dalle_params(DALLE(**TINY, **CONFIGS[name]), tree)
    for a, b in zip(again.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)


def _jax_scan_state(seed=3):
    jm, params = _jax_scan_dalle(CONFIGS["full-shift-rotary"], seed)
    state = train_state.TrainState.create(apply_fn=None, params=params,
                                          tx=jsteps.make_optimizer(1e-3, clip_grad_norm=0.5))
    step = jax.jit(jsteps.make_dalle_train_step(jm))
    for i in range(2):
        batch = {"text": jnp.asarray(_text(2, 10 + i)), "image_tokens": jnp.asarray(_image(20 + i))}
        state, _ = step(state, batch, jax.random.PRNGKey(i))
    return state


def test_jax_scan_adam_leaves_load_in_the_port_and_export_back():
    state = _jax_scan_state()
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(state.opt_state)]
    model = load_dalle_params(DALLE(**TINY, **CONFIGS["full-shift-rotary"]), _np(state.params))
    opt = make_optimizer(model.parameters(), 5e-2, clip_grad_norm=0.5)
    load_dalle_opt_state(model, opt, leaves, layout="scan")
    back = export_dalle_opt_state(model, opt, layout="scan")
    assert len(back) == len(leaves)
    for a, b in zip(back, leaves):
        assert a.shape == b.shape and np.array_equal(a, b)

    # each moment landed on its own weight: the unrolled export equals the
    # JAX conversion of the JAX moment trees
    adam = state.opt_state.inner_state[1][0]
    unrolled = export_dalle_opt_state(model, opt)[3:]
    expect = []
    for tree in (adam.mu, adam.nu):
        tree = _np(tree)
        tree = {**tree, "transformer": j_to_unrolled(tree["transformer"], TINY["depth"])}
        expect += [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
    assert len(unrolled) == len(expect)
    for a, b in zip(unrolled, expect):
        np.testing.assert_array_equal(a, b)


def test_port_scan_adam_leaves_restore_in_the_jax_package(capsys):
    _, params = _jax_scan_dalle(CONFIGS["full-shift-rotary"], seed=4)
    model = load_dalle_params(DALLE(**TINY, **CONFIGS["full-shift-rotary"]), params)
    opt = make_optimizer(model.parameters(), 1e-3, clip_grad_norm=0.5)
    step = make_dalle_train_step(model, opt, autocast_dtype=None)
    for i in range(2):
        step({"text": torch.from_numpy(_text(2, 30 + i)),
              "image_tokens": torch.from_numpy(_image(40 + i))})
    leaves = export_dalle_opt_state(model, opt, layout="scan")
    tree = export_dalle_params(model, layout="scan")
    fresh = train_state.TrainState.create(apply_fn=None, params=tree,
                                          tx=jsteps.make_optimizer(3e-4, clip_grad_norm=0.5))
    capsys.readouterr()
    restored = jpipeline.restore_opt_state(fresh.opt_state, leaves)
    assert "WARNING" not in capsys.readouterr().out
    assert int(restored.count) == 2
    mu = _flat(_np(restored.inner_state[1][0].mu))
    for i in range(TINY["depth"]):
        m = opt.adam.state[model.transformer.attn[str(i)].to_qkv.weight]["exp_avg"]
        np.testing.assert_array_equal(
            mu["transformer/scan_stack/layers/attn/to_qkv/kernel"][i], m.t().numpy())


def test_clip_scan_checkpoints_both_ways(tmp_path):
    jclip = JCLIP(**CLIP_CFG, executor="scan")
    rng = np.random.RandomState(0)
    text = rng.randint(1, 40, (3, 8)).astype(np.int32)
    images = rng.rand(3, 16, 16, 3).astype(np.float32)
    params = _np(jclip.init(jax.random.PRNGKey(1), jnp.asarray(text), jnp.asarray(images))["params"])
    clip = load_clip_params(CLIP(**CLIP_CFG, executor="scan"), params).eval()
    ref = jclip.apply({"params": params}, jnp.asarray(text), jnp.asarray(images))
    with torch.no_grad():
        out = clip(torch.from_numpy(text), torch.from_numpy(images))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)

    path = tmp_path / "clip.npz"
    save_clip_checkpoint(str(path), clip)
    jloaded, jparams = jpipeline.load_clip_checkpoint(str(path))
    assert jloaded.executor == "scan"
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    loaded = load_clip_checkpoint(str(path))
    assert loaded.executor == "scan"
    assert sorted(_flat(export_clip_params(loaded, "scan"))) == sorted(_flat(params))


UNSUPPORTED = {
    "shared": dict(shared_attn_ids=(0, 0), shared_ff_ids=(0, 0)),
    "revnet": dict(reversible=True, reversible_impl="revnet"),
    "flash-masked": dict(attn_types=("full", "axial_row"), attn_impl="flash"),
}


@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_unsupported_configs_are_refused_with_the_jax_reason(name):
    kw = UNSUPPORTED[name]
    jtr = JTransformer(dim=32, depth=2, seq_len=24, heads=2, dim_head=8, image_fmap_size=4,
                       executor="scan", **kw)
    with pytest.raises(ValueError) as jerr:
        jtr.init(jax.random.PRNGKey(0), jnp.zeros((1, 24, 32)))
    model = DALLE(**TINY, **{"attn_impl": "dense", **kw})
    with pytest.raises(ValueError) as perr:
        export_dalle_params(model, layout="scan")
    assert str(perr.value) == str(jerr.value)
