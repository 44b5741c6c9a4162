"""The port's RevNet executor vs the JAX package's (CPU).

`reversible_impl="revnet"` computes the two-stream function (x1 += f(x2),
x2 += g(x1) over the layers from x1 = x2 = x, output (y1 + y2) / 2) and
rebuilds each layer's inputs from its outputs in its backward pass.

* Logits of both layer orders, and every parameter gradient of the
  forward and the reversed-order objectives, against the JAX `revnet`
  (its `custom_vjp`) on the same weights and batch, float32 on both sides
  (JAX at matmul precision "highest", its Pallas kernels in interpret
  mode): logits 1e-4, loss 1e-5, every gradient leaf 1e-5 absolute, the
  tolerances of the plain stack's training parity.
* The port's custom backward against its own `revnet_naive` (autograd
  through the same forward): float32 1e-5 absolute on the input and every
  parameter; under bfloat16 autocast each parameter's gradient within a
  relative norm of 2e-2 (the two round the recompute differently).
* Refusals: a key mask, and dropout in training mode (ValueError).
* Cached decode through the two-stream branch: prefill and 16
  teacher-forced steps give JAX's logits (1e-4) and K/V (1e-5); the
  greedy cached sampler gives JAX's tokens.
* The slotted and paged continuous engines give the micro engine's
  sampled tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training import train_state

from dalle_pytorch_tpu.models import dalle as jd
from dalle_pytorch_tpu.models.dalle import DALLE as JDALLE
from dalle_pytorch_tpu.models.dalle import init_decode_cache as j_init_cache
from dalle_pytorch_tpu.training.steps import make_dalle_train_step as jax_train_step
from dalle_pytorch_tpu_torch.models.dalle import DALLE, generate_images_cached, init_decode_cache
from dalle_pytorch_tpu_torch.models.transformer import Transformer
from dalle_pytorch_tpu_torch.serving.engine import (
    ContinuousEngine,
    GenerationEngine,
    PagedContinuousEngine,
    SampleSpec,
)
from dalle_pytorch_tpu_torch.training.steps import accumulate_gradients, make_dalle_loss
from dalle_pytorch_tpu_torch.weights import export_dalle_params, load_dalle_params
from test_torch_dalle import TINY, _assert_cache_close, _dalle_pair, _text
from test_torch_train import _capture_grads, _flat

torch.set_num_threads(2)

REV = dict(reversible=True, reversible_impl="revnet", shift_tokens=True, rotary_emb=True)
IMG_SEQ = TINY["image_fmap_size"] ** 2
GREEDY = 1.0


@pytest.fixture(scope="module")
def pair():
    return _dalle_pair(seed=31, **REV)


def _image(b, seed):
    return np.random.RandomState(seed).randint(0, TINY["num_image_tokens"], (b, IMG_SEQ)).astype(np.int32)


@pytest.mark.parametrize("reverse_model", [False, True])
def test_logits_of_both_orders_match_the_reference(pair, reverse_model):
    jm, variables, pm = pair
    text, img = _text(2, seed=3), _image(2, seed=4)
    ref = jm.apply(variables, jnp.asarray(text), jnp.asarray(img), reverse_model=reverse_model)
    with torch.no_grad():
        out = pm(torch.from_numpy(text), torch.from_numpy(img), reverse_model=reverse_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["forward_only", "forward_reverse_partial"])
def test_every_gradient_matches_the_reference_custom_vjp(pair, mode):
    jm, variables, _ = pair
    params = jax.tree.map(np.asarray, variables["params"])
    text, img = _text(4, seed=5), _image(4, seed=6)
    state = train_state.TrainState.create(apply_fn=None, params=params, tx=_capture_grads())
    new_state, jmetrics = jax.jit(jax_train_step(jm, mode=mode))(
        state, {"text": jnp.asarray(text), "image_tokens": jnp.asarray(img)}, jax.random.PRNGKey(1))
    jgrads = _flat(new_state.opt_state)

    model = load_dalle_params(DALLE(**TINY, **REV, attn_impl="flash"), params)
    batch = {"text": torch.from_numpy(text), "image_tokens": torch.from_numpy(img)}
    metrics = accumulate_gradients(model, make_dalle_loss(model, mode), batch)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    pgrads = _flat(export_dalle_params(model))
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jmetrics["loss"]), atol=1e-5)
    assert sorted(pgrads) == sorted(jgrads)
    for path, jg in jgrads.items():
        np.testing.assert_allclose(pgrads[path], jg, atol=1e-5, rtol=0, err_msg=path)


STACK = dict(dim=32, depth=3, seq_len=13, heads=2, dim_head=8, image_fmap_size=3,
             reversible=True, attn_impl="flash")


def _stack_pair(**kw):
    torch.manual_seed(0)
    rev = Transformer(**STACK, **kw, reversible_impl="revnet")
    naive = Transformer(**STACK, **kw, reversible_impl="revnet_naive")
    naive.load_state_dict(rev.state_dict())
    return rev, naive


def _grads(model, x, reverse_model, autocast):
    model.zero_grad()
    x = x.clone().requires_grad_()
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        y = model(x, reverse_model=reverse_model)
    (y.float() ** 2).sum().backward()
    return y.detach(), x.grad, [p.grad for p in model.parameters()]


@pytest.mark.parametrize("kw", [
    dict(shift_tokens=True, rotary_emb=True, sandwich_norm=True),
    dict(attn_types=("full", "axial_row"), shared_attn_ids=(0, 1, 0), shared_ff_ids=(0, 0, 1),
         rotary_emb=False),
])
@pytest.mark.parametrize("reverse_model", [False, True])
def test_the_custom_backward_gives_autograds_gradients(kw, reverse_model):
    rev, naive = _stack_pair(**kw)
    x = torch.randn(2, 13, 32, generator=torch.Generator().manual_seed(1))
    (y, dx, g), (y_ref, dx_ref, g_ref) = (_grads(m, x, reverse_model, False) for m in (rev, naive))
    assert torch.equal(y, y_ref)
    torch.testing.assert_close(dx, dx_ref, atol=1e-5, rtol=0)
    for a, b in zip(g, g_ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)

    # bfloat16 autocast: the backward re-enters the forward's autocast, so
    # the recompute rounds as the forward did
    (_, _, g), (_, _, g_ref) = (_grads(m, x, reverse_model, True) for m in (rev, naive))
    for a, b in zip(g, g_ref):
        assert a.dtype == torch.float32
        assert float((a - b).norm() / b.norm()) < 2e-2


def test_refusals():
    rev, _ = _stack_pair()
    x = torch.randn(1, 13, 32)
    with pytest.raises(ValueError, match="key-mask"):
        rev(x, key_mask=torch.ones(1, 13, dtype=torch.bool))
    dropped = Transformer(**STACK, reversible_impl="revnet", ff_dropout=0.1)
    with pytest.raises(ValueError, match="no dropout"):
        dropped.train()(x)
    dropped.eval()(x)  # evaluation runs without dropout
    with pytest.raises(ValueError, match="reversible_impl"):
        Transformer(**STACK, reversible_impl="bogus")


def test_cached_decode_follows_the_reference_two_streams(pair):
    jm, variables, pm = pair
    b = 2
    text, img = _text(b, seed=7), _image(b, seed=8)
    prefill = jax.jit(lambda v, t, c: jm.apply(v, t, c, method=JDALLE.decode_prefill))
    step = jax.jit(lambda v, tok, i, c: jm.apply(v, tok, i, c, method=JDALLE.decode_image_step))
    jrow, jcache = prefill(variables, jnp.asarray(text), j_init_cache(jm, b))
    pcache = init_decode_cache(pm, b)
    with torch.inference_mode():
        prow, _ = pm.decode_prefill(torch.from_numpy(text), pcache)
        np.testing.assert_allclose(prow.numpy(), np.asarray(jrow), atol=1e-4, rtol=0)
        for i in range(IMG_SEQ):
            jrow, jcache = step(variables, jnp.asarray(img[:, i]), jnp.int32(i), jcache)
            prow, _ = pm.decode_image_step(torch.from_numpy(img[:, i]), i, pcache)
            np.testing.assert_allclose(prow.numpy(), np.asarray(jrow), atol=1e-4, rtol=0)
    _assert_cache_close(jcache, pcache)

    ref = jd.generate_images_cached(jm, variables, jax.random.PRNGKey(0), jnp.asarray(text),
                                    filter_thres=GREEDY)
    out = generate_images_cached(pm, torch.from_numpy(text), seed=0, filter_thres=GREEDY)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _spec(seed):
    return SampleSpec(_text(1, seed=seed % 7)[0], seed=seed, temperature=1.0, top_k=0.5)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_continuous_engines_give_the_micro_tokens(pair, layout):
    _, _, pm = pair
    micro = GenerationEngine(pm, batch_shapes=(3,), device="cpu")
    ref, _ = micro.generate([_spec(s) for s in (41, 42, 43)])
    common = dict(max_batch=4, chunk_tokens=4, prefill_batch=2, device="cpu")
    cont = (ContinuousEngine(pm, **common) if layout == "slot"
            else PagedContinuousEngine(pm, page_size=4, **common))
    cont.prefill_slots([(0, _spec(41)), (2, _spec(42))])
    cont.step_chunk()
    cont.prefill_slot(3, _spec(43))  # admitted mid-flight
    for _ in range(16):
        pos, act = cont.step_chunk()
        if (pos[act] >= IMG_SEQ).all():
            break
    np.testing.assert_array_equal(cont.harvest([0, 2, 3]), ref)
