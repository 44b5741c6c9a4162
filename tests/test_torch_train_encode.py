"""The DALLE training step with the in-step dVAE encode vs the JAX
package's `make_dalle_train_step(vae=...)`.

The same weights (JAX inits, carried by `weights.py`) and the same numpy
text and images go through both steps; tiny models as in
`test_torch_train_cli.py` (`attn_impl="flash"`: JAX's Pallas kernels in
interpret mode, the port's plain versions), float32, JAX at matmul
precision "highest". The JAX gradients are captured by an optax
transformation whose state is the gradient it receives
(`test_torch_train.py`'s technique), the port's are left in `.grad` by
an optimizer that does nothing. Held: the loss within 1e-5, every
gradient leaf within 1e-5 absolute, the frozen dVAE without gradient;
the two encodes' tokens must agree, and every top-2 logit gap of this
data is asserted above 2e-5 (twice the fp32 logit tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from dalle_pytorch_tpu.models.dalle import DALLE as JDALLE
from dalle_pytorch_tpu.models.dvae import DiscreteVAE as JDVAE
from dalle_pytorch_tpu.training import steps as jsteps
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.training.steps import make_dalle_train_step
from dalle_pytorch_tpu_torch.weights import export_dalle_params, load_dalle_params, load_dvae_params

torch.set_num_threads(2)

TINY = dict(
    dim=64, depth=2, heads=4, dim_head=16, num_image_tokens=32,
    image_fmap_size=4, num_text_tokens=50, text_seq_len=8,
)
TINY_VAE = dict(image_size=32, num_layers=3, num_tokens=32, codebook_dim=16, hidden_dim=8)
GAP = 2e-5  # twice the fp32 logit tolerance


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _capture_grads():
    """An optax transformation whose new state is the gradient it got."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


class _KeepGrads:
    """An optimizer that leaves each parameter's .grad for the test."""

    def step(self):
        return None


@pytest.mark.parametrize("mode, grad_accum", [("forward_only", 1), ("forward_reverse_partial", 2)])
def test_in_step_encode_gradients_match_the_reference(mode, grad_accum):
    params = JDALLE(**TINY, attn_impl="dense").init(
        jax.random.PRNGKey(1), jnp.ones((1, 8), jnp.int32), jnp.zeros((1, 16), jnp.int32)
    )["params"]
    params = jax.tree.map(np.asarray, params)
    jv = JDVAE(**TINY_VAE)
    vparams = jax.jit(jv.init)(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))["params"]
    vparams = jax.tree.map(np.asarray, vparams)
    vae = load_dvae_params(DiscreteVAE(**TINY_VAE), vparams).eval()
    images = np.random.RandomState(4).rand(4, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        logits = vae.encode_logits(torch.from_numpy(images)).numpy().reshape(4, 16, -1)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > GAP  # no near-tie: the tokens must agree
    text = np.random.RandomState(2).randint(1, TINY["num_text_tokens"], (4, 8)).astype(np.int32)
    text[:, 5:] = 0
    batch = {"text": text, "images": images}
    state = train_state.TrainState.create(apply_fn=None, params=params, tx=_capture_grads())
    jstep = jsteps.make_dalle_train_step(JDALLE(**TINY, attn_impl="flash"), vae=jv, mode=mode,
                                         grad_accum=grad_accum)
    new_state, jmetrics_ = jax.jit(jstep)(state, jax.tree.map(jnp.asarray, batch),
                                          jax.random.PRNGKey(1), vparams)
    jgrads = new_state.opt_state

    model = load_dalle_params(DALLE(**TINY, attn_impl="flash"), params)
    step = make_dalle_train_step(model, _KeepGrads(), mode=mode, grad_accum=grad_accum,
                                 autocast_dtype=None, vae=vae)
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jmetrics_["loss"]), atol=1e-5,
                               rtol=0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    pgrads, ref = _flat(export_dalle_params(model)), _flat(jgrads)
    assert sorted(pgrads) == sorted(ref)
    for path, g in ref.items():
        np.testing.assert_allclose(pgrads[path], g, atol=1e-5, rtol=0, err_msg=path)
    assert all(not p.requires_grad for p in vae.parameters())
