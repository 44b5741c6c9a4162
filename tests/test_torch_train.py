"""The port's DALLE training loss and gradients vs the JAX package's step.

The same weights (a JAX init, carried across by `weights.py`) and the same
numpy batch go through both. The JAX side is the package's own
`make_dalle_train_step`, given an optimizer that returns the gradients it
receives as its state, so the gradients compared are exactly what its
step would apply (its loss composition and microbatch averaging
included). The port side is `training/steps.py`'s loss and
`accumulate_gradients`, its gradients exported back into a reference tree.

Both sides run the flash-attention path (`attn_impl="flash"`; n = 24 is
under the "auto" threshold): JAX through the Pallas kernels in interpret
mode, the port through their plain versions. Tolerances (float32, JAX at
matmul precision "highest"): loss 1e-5, accuracy exact, every gradient
leaf 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from dalle_pytorch_tpu.models.dalle import DALLE as JDALLE
from dalle_pytorch_tpu.training.steps import make_dalle_train_step as jax_train_step
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.training.steps import MODES, accumulate_gradients, make_dalle_loss
from dalle_pytorch_tpu_torch.weights import export_dalle_params, load_dalle_params

torch.set_num_threads(2)

TINY = dict(
    dim=64, depth=2, heads=4, dim_head=16, num_image_tokens=32,
    image_fmap_size=4, num_text_tokens=50, text_seq_len=8,
)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _batch(seed=0, b=4):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, TINY["num_text_tokens"], (b, TINY["text_seq_len"])).astype(np.int32)
    text[:, 5:] = 0  # padding positions become unique pad ids
    img = rng.randint(0, TINY["num_image_tokens"], (b, 16)).astype(np.int32)
    return text, img


def _capture_grads():
    """An optax transformation whose new state is the gradient it got."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


def _jax_grads(cfg, params, text, img, mode, grad_accum, null_cond_prob, fused_ce):
    model = JDALLE(**cfg, attn_impl="flash", fused_ce=fused_ce)
    state = train_state.TrainState.create(apply_fn=None, params=params, tx=_capture_grads())
    step = jax_train_step(model, mode=mode, grad_accum=grad_accum, null_cond_prob=null_cond_prob)
    new_state, metrics = jax.jit(step)(
        state, {"text": jnp.asarray(text), "image_tokens": jnp.asarray(img)},
        jax.random.PRNGKey(1),
    )
    return _flat(new_state.opt_state), {k: np.asarray(v) for k, v in metrics.items()}


def _port_grads(cfg, params, text, img, mode, grad_accum, null_cond_prob, fused_ce):
    model = DALLE(**cfg, attn_impl="flash", fused_ce=fused_ce)
    load_dalle_params(model, params)
    loss_fn = make_dalle_loss(model, mode, null_cond_prob)
    batch = {"text": torch.from_numpy(text), "image_tokens": torch.from_numpy(img)}
    metrics = accumulate_gradients(model, loss_fn, batch, grad_accum)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)  # export the gradients through the weight mapping
    return _flat(export_dalle_params(model)), {k: v.numpy() for k, v in metrics.items()}


CASES = {
    # mode, fused_ce, null_cond_prob, grad_accum, extra model config
    "forward_only": ("forward_only", False, 0.0, 1, {}),
    "forward_only-fused-null": ("forward_only", True, 1.0, 1, {}),
    "forward_forward-null": ("forward_forward", False, 1.0, 1, {}),
    "forward_reverse_partial-accum2-fused": ("forward_reverse_partial", True, 0.0, 2, {}),
    "reverse_only-fused": ("reverse_only", True, 0.0, 1, {}),
    "reverse_only-axial-stable-sandwich": (
        "reverse_only", False, 0.0, 1,
        dict(attn_types=("full", "axial_row"), stable=True, sandwich_norm=True),
    ),
}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_every_gradient_match_the_reference(name):
    mode, fused_ce, null_cond_prob, grad_accum, extra = CASES[name]
    cfg = {**TINY, **extra}
    text, img = _batch(seed=len(name))
    params = JDALLE(**cfg, attn_impl="dense").init(
        jax.random.PRNGKey(0), jnp.asarray(text[:1]), jnp.asarray(img[:1])
    )["params"]
    params = jax.tree.map(np.asarray, params)
    args = (cfg, params, text, img, mode, grad_accum, null_cond_prob, fused_ce)
    jgrads, jmetrics = _jax_grads(*args)
    pgrads, pmetrics = _port_grads(*args)
    np.testing.assert_allclose(pmetrics["loss"], jmetrics["loss"], atol=1e-5, rtol=0)
    if "accuracy" in pmetrics:
        assert pmetrics["accuracy"] == jmetrics["accuracy"]
    assert sorted(pgrads) == sorted(jgrads)
    for path, jg in jgrads.items():
        np.testing.assert_allclose(pgrads[path], jg, atol=1e-5, rtol=0, err_msg=path)


def test_key_padding_mask_matches_the_reference_dense_arm():
    """A key-padding mask [B, n] through `Transformer.forward` (full and
    axial_row layers) gives the reference trunk's output and input
    gradient (1e-5); "auto" keeps a key-masked layer dense on both sides,
    "flash" refuses the mask."""
    cfg = {**TINY, "attn_types": ("full", "axial_row")}
    text, img = _batch(seed=11, b=2)
    params = JDALLE(**cfg, attn_impl="dense").init(
        jax.random.PRNGKey(2), jnp.asarray(text[:1]), jnp.asarray(img[:1])
    )["params"]
    params = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(12)
    x = rng.randn(2, 24, TINY["dim"]).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    key_mask = np.ones((2, 24), bool)
    key_mask[0, 3:7] = False
    key_mask[1, 15:19] = False

    def jtrunk(x_):
        out = JDALLE(**cfg, attn_impl="auto").apply(
            {"params": params}, x_, jnp.asarray(key_mask),
            method=lambda m, x_, km: m.transformer(x_, key_mask=km),
        )
        return jnp.sum(out * g), out

    (_, jout), jgrad = jax.value_and_grad(jtrunk, has_aux=True)(jnp.asarray(x))
    model = load_dalle_params(DALLE(**cfg, attn_impl="auto"), params)
    tx = torch.tensor(x, requires_grad=True)
    out = model.transformer(tx, key_mask=torch.from_numpy(key_mask))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), atol=1e-5, rtol=0)
    assert not np.allclose(
        out.detach().numpy(), model.transformer(tx).detach().numpy(), atol=1e-3
    )
    flash = load_dalle_params(DALLE(**cfg, attn_impl="flash"), params)
    with pytest.raises(ValueError, match="key-padding"):
        flash.transformer(tx, key_mask=torch.from_numpy(key_mask))


def test_every_mode_is_covered():
    assert {case[0] for case in CASES.values()} == set(MODES)
