"""The port's Gumbel-softmax, dVAE training forward and losses, and its dVAE
and CLIP train steps vs the JAX package's (CPU, float32; JAX at matmul
precision "highest").

The Gumbel noise is JAX's: `jax.random.gumbel` for the op, and for the
dVAE the noise the JAX model drew, captured by wrapping
`dalle_pytorch_tpu.models.dvae.gumbel_softmax` (pytest's monkeypatch; the
wrapper draws the same samples from the same key and hands them out
through `jax.debug.callback`), then handed to the port. Tolerances:

* `gumbel_softmax` soft, hard (straight-through) and ReinMax: forward and
  VJP 1e-6 absolute;
* the dVAE loss (MSE and smooth L1, with the KL term, plain, hard and
  ReinMax sampling) and its reconstruction: 1e-5 absolute, gradients
  1e-5;
* one `make_vae_train_step` and one `make_clip_train_step` (Adam, the
  CLIP one clipped at 1) against the JAX steps: every parameter after the
  update within 1e-5, a tenth of the learning rate (a first Adam step
  moves a weight by lr * g / (|g| + 1e-8), about the learning rate, so
  this holds each update's sign and size; where |g| is near Adam's
  epsilon that ratio magnifies the two packages' last-bit gradient
  differences, which is why the bound is not tighter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training import train_state

from dalle_pytorch_tpu.models import dvae as jdvae
from dalle_pytorch_tpu.models.clip import CLIP as JCLIP
from dalle_pytorch_tpu.ops.gumbel import gumbel_softmax as j_gumbel_softmax
from dalle_pytorch_tpu.training import steps as jsteps
from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE, mse_loss, smooth_l1_loss
from dalle_pytorch_tpu_torch.ops.gumbel import gumbel_noise, gumbel_softmax
from dalle_pytorch_tpu_torch.training.steps import (
    make_clip_train_step,
    make_optimizer,
    make_vae_train_step,
)
from dalle_pytorch_tpu_torch.weights import (
    export_clip_params,
    export_dvae_params,
    load_clip_params,
    load_dvae_params,
)

torch.set_num_threads(2)

TINY_VAE = dict(image_size=16, num_layers=2, num_tokens=16, codebook_dim=8, hidden_dim=8)
MODES = {"soft": (False, False), "hard": (True, False), "reinmax": (True, True)}


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_gumbel_softmax_forward_and_vjp(mode):
    hard, reinmax = MODES[mode]
    key = jax.random.PRNGKey(3)
    logits = np.random.RandomState(0).randn(2, 3, 5, 7).astype(np.float32)
    ct = np.random.RandomState(1).randn(*logits.shape).astype(np.float32)
    noise = np.array(jax.random.gumbel(key, logits.shape, dtype=jnp.float32))

    def jfn(lg):
        return j_gumbel_softmax(key, lg, tau=0.7, hard=hard, reinmax=reinmax)

    ref, vjp = jax.vjp(jfn, jnp.asarray(logits))
    (ref_grad,) = vjp(jnp.asarray(ct))
    lg = torch.from_numpy(logits).requires_grad_()
    out = gumbel_softmax(lg, torch.from_numpy(noise), tau=0.7, hard=hard, reinmax=reinmax)
    (grad,) = torch.autograd.grad(out, lg, torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=1e-6, rtol=0)
    if hard:
        assert set(np.unique(out.detach().numpy()).round(6)) <= {0.0, 1.0}


def test_gumbel_noise_is_standard_gumbel_from_its_generator():
    a = gumbel_noise((4096,), torch.Generator().manual_seed(5))
    b = gumbel_noise((4096,), torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert abs(float(a.mean()) - 0.5772) < 0.05  # the Euler-Mascheroni constant


def test_the_losses_are_the_reference_definitions():
    rng = np.random.RandomState(2)
    a, b = (rng.randn(3, 8).astype(np.float32) * 2 for _ in range(2))
    for port, ref in ((smooth_l1_loss, jdvae.smooth_l1_loss), (mse_loss, jdvae.mse_loss)):
        np.testing.assert_allclose(float(port(torch.from_numpy(a), torch.from_numpy(b))),
                                   float(ref(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)


@pytest.fixture
def captured_noise(monkeypatch):
    """Every Gumbel noise the JAX dVAE draws, in order."""
    drawn = []
    orig = jdvae.gumbel_softmax

    def spy(rng, logits, **kw):
        noise = jax.random.gumbel(rng, logits.shape, dtype=logits.dtype)
        jax.debug.callback(lambda g: drawn.append(np.array(g)), noise)
        return orig(rng, logits, **kw)

    monkeypatch.setattr(jdvae, "gumbel_softmax", spy)
    return drawn


def _vae_pair(**kw):
    cfg = {**TINY_VAE, **kw}
    jv = jdvae.DiscreteVAE(**cfg)
    params = jax.tree.map(np.asarray, jv.init(
        {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
        jnp.zeros((1, 16, 16, 3)))["params"])
    return jv, params, load_dvae_params(DiscreteVAE(**cfg), params)


def _images(seed, b=2):
    return np.random.RandomState(seed).rand(b, 16, 16, 3).astype(np.float32)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_dvae_loss_and_gradients_match_the_reference(captured_noise, smooth, mode):
    hard, reinmax = MODES[mode]
    jv, params, pv = _vae_pair(smooth_l1_loss=smooth, straight_through=hard, reinmax=reinmax,
                               kl_div_loss_weight=0.3)
    images = _images(4)

    def jloss(p):
        return jv.apply({"params": p}, jnp.asarray(images), return_loss=True,
                        return_recons=True, temp=0.8, rngs={"gumbel": jax.random.PRNGKey(9)})

    drawn = len(captured_noise)  # the init drew one too
    (ref, ref_out), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    assert len(captured_noise) == drawn + 1
    loss, out = pv(torch.from_numpy(images), return_loss=True, return_recons=True, temp=0.8,
                   noise=torch.from_numpy(captured_noise[-1]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-5, rtol=0)
    with torch.no_grad():
        for p in pv.parameters():
            p.copy_(p.grad)
    pgrads, jg = _flat(export_dvae_params(pv)), _flat(jgrads)
    assert sorted(pgrads) == sorted(jg)
    for path, g in jg.items():
        np.testing.assert_allclose(pgrads[path], g, atol=1e-5, rtol=0, err_msg=path)


def test_one_vae_train_step_matches_the_reference(captured_noise):
    jv, params, pv = _vae_pair(straight_through=True, reinmax=True, kl_div_loss_weight=0.1)
    images = _images(5, b=4)
    state = train_state.TrainState.create(apply_fn=None, params=params,
                                          tx=jsteps.make_optimizer(1e-4))
    drawn = len(captured_noise)
    new_state, jmetrics = jax.jit(jsteps.make_vae_train_step(jv))(
        state, jnp.asarray(images), jax.random.PRNGKey(2), jnp.float32(0.75))
    assert len(captured_noise) == drawn + 1
    opt = make_optimizer(pv.parameters(), 1e-4)
    metrics = make_vae_train_step(pv, opt)(
        {"images": torch.from_numpy(images), "noise": torch.from_numpy(captured_noise[-1])}, 0.75)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), atol=1e-5)
    ref = _flat(new_state.params)
    got = _flat(export_dvae_params(pv))
    for path, leaf in ref.items():
        np.testing.assert_allclose(got[path], leaf, atol=1e-5, rtol=0, err_msg=path)


def test_one_clip_train_step_matches_the_reference():
    cfg = dict(dim_text=32, dim_image=32, dim_latent=16, num_text_tokens=40, text_enc_depth=1,
               text_seq_len=8, text_heads=2, visual_enc_depth=1, visual_heads=2,
               visual_image_size=16, visual_patch_size=8)
    rng = np.random.RandomState(6)
    batch = {"text": rng.randint(1, 40, (4, 8)).astype(np.int32),
             "images": rng.rand(4, 16, 16, 3).astype(np.float32)}
    jclip = JCLIP(**cfg)
    params = jax.tree.map(np.asarray, jclip.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["text"]), jnp.asarray(batch["images"]))["params"])
    state = train_state.TrainState.create(apply_fn=None, params=params,
                                          tx=jsteps.make_optimizer(1e-4, clip_grad_norm=1.0))
    new_state, jmetrics = jax.jit(jsteps.make_clip_train_step(jclip))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    clip = load_clip_params(CLIP(**cfg), params)
    opt = make_optimizer(clip.parameters(), 1e-4, clip_grad_norm=1.0)
    metrics = make_clip_train_step(clip, opt)({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), atol=1e-5)
    ref, got = _flat(new_state.params), _flat(export_clip_params(clip))
    for path, leaf in ref.items():
        np.testing.assert_allclose(got[path], leaf, atol=1e-5, rtol=0, err_msg=path)
