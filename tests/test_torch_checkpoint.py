"""The port's optimizer, weight export and checkpoint writer vs the JAX
package, and the port's rematerialized layers.

* Adam with global-norm clipping, fed the same gradients as the JAX
  package's optax chain, gives the same parameters (1e-6), clipped and
  unclipped, across a learning-rate change.
* `export_dalle_params` is the exact inverse of `load_dalle_params`.
* A checkpoint the port writes loads in the JAX `load_dalle_checkpoint`
  (its config rebuilds the same model: logits 1e-4) and in the port's
  `engine_from_checkpoint`.
* `reversible=True` (recompute in the backward pass) gives the gradients
  of the plain stack; `reversible_impl="revnet"` (the two-stream RevNet,
  rebuilding its inputs in the backward pass) gives those of autograd
  through its own forward (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training import train_state

from dalle_pytorch_tpu.models.dalle import DALLE as JDALLE
from dalle_pytorch_tpu.training import pipeline as jpipeline
from dalle_pytorch_tpu.training import steps as jsteps
from dalle_pytorch_tpu_torch.data import tokenizer as port_tokenizer
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.serving.engine import engine_from_checkpoint
from dalle_pytorch_tpu_torch.training.pipeline import (
    dalle_config,
    dalle_from_config,
    dvae_hparams,
    save_dalle_checkpoint,
)
from dalle_pytorch_tpu_torch.training.steps import (
    accumulate_gradients,
    get_learning_rate,
    make_dalle_loss,
    make_optimizer,
    set_learning_rate,
)
from dalle_pytorch_tpu_torch.weights import (
    export_dalle_params,
    export_dvae_params,
    load_dalle_params,
    load_dvae_params,
)

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


def _jax_params(cfg, seed=0):
    text = jnp.ones((1, cfg["text_seq_len"]), jnp.int32)
    img = jnp.zeros((1, cfg["image_fmap_size"] ** 2), jnp.int32)
    params = JDALLE(**cfg, attn_impl="dense").init(jax.random.PRNGKey(seed), text, img)["params"]
    return jax.tree.map(np.asarray, params)


def _batch(seed=0, b=2):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, TINY["num_text_tokens"], (b, TINY["text_seq_len"])).astype(np.int32)
    text[:, 6:] = 0
    img = rng.randint(0, TINY["num_image_tokens"], (b, 16)).astype(np.int32)
    return text, img


@pytest.mark.parametrize("clip", [None, 0.5, 1e3])
def test_adam_and_clipping_match_optax(clip):
    """Three steps, the learning rate changed before the third; clip 0.5
    scales every step's gradients, 1e3 never does."""
    rng = np.random.RandomState(7)
    params = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    grads = [
        {k: (rng.randn(*v.shape) * 2).astype(np.float32) for k, v in params.items()}
        for _ in range(3)
    ]
    state = train_state.TrainState.create(
        apply_fn=None, params=jax.tree.map(jnp.asarray, params),
        tx=jsteps.make_optimizer(1e-2, clip),
    )
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(tparams.values(), 1e-2, clip)
    for i, g in enumerate(grads):
        if i == 2:
            state = jsteps.set_learning_rate(state, 3e-3)
            set_learning_rate(opt, 3e-3)
        state = state.apply_gradients(grads=jax.tree.map(jnp.asarray, g))
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(state.params[k]), atol=1e-6, rtol=0
            )
    assert get_learning_rate(opt) == pytest.approx(jsteps.get_learning_rate(state))


@pytest.mark.parametrize("extra", [
    dict(attn_types=("full", "axial_row")),
    dict(rotary_emb=False, sandwich_norm=True, shared_attn_ids=(0, 0), shared_ff_ids=(0, 1)),
    dict(share_input_output_emb=True, shift_tokens=False),
])
def test_export_is_the_exact_inverse_of_load(extra):
    cfg = {**TINY, **extra}
    tree = _jax_params(cfg, seed=3)
    model = load_dalle_params(DALLE(**cfg), tree)
    out = _flat(export_dalle_params(model))
    ref = _flat(tree)
    assert sorted(out) == sorted(ref)
    for path, leaf in ref.items():
        assert out[path].dtype == np.float32 and np.array_equal(out[path], leaf), path


def test_dvae_export_round_trips_and_carries_the_encoder():
    cfg = dict(image_size=32, num_layers=3, num_tokens=32, codebook_dim=16, hidden_dim=8,
               num_resnet_blocks=1)
    vae = DiscreteVAE(**cfg)
    tree = export_dvae_params(vae)
    again = load_dvae_params(DiscreteVAE(**cfg), tree)
    for a, b in zip(vae.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    with torch.no_grad():  # the encoder's weights travel with the tree
        vae.enc_head.weight.fill_(1.0)
        vae.enc_head.bias.fill_(1.0)
    carried = export_dvae_params(vae)
    assert np.array_equal(carried["enc_head"]["kernel"], np.ones((1, 1, 8, 32), np.float32))
    assert np.array_equal(carried["enc_head"]["bias"], np.ones(32, np.float32))


def _byte_default_vocabulary(monkeypatch):
    """A machine whose default vocabulary cannot load (no C++ toolchain):
    the port's default probe falls back to the byte tokenizer, the
    vocabulary this checkpoint was trained with."""
    monkeypatch.setattr(port_tokenizer, "default_vocabularies", lambda: [])
    monkeypatch.setattr(port_tokenizer, "_default_decision", None)
    monkeypatch.setattr(port_tokenizer, "_warned_default_probe", True)


def test_checkpoint_loads_in_the_reference_and_in_the_port_engine(tmp_path, monkeypatch):
    """The engine takes the tokenizer the config names (here none: the
    default probe, falling back to the byte tokenizer), so the checkpoint
    carries the byte vocabulary."""
    cfg = {**TINY, "num_text_tokens": 257, "attn_types": ("full", "axial_row")}
    model = load_dalle_params(DALLE(**cfg, attn_impl="flash"), _jax_params(cfg, seed=5))
    vae_cfg = dict(image_size=32, num_layers=3, num_tokens=32, codebook_dim=16, hidden_dim=8)
    vae = DiscreteVAE(**vae_cfg)
    path = tmp_path / "dalle.npz"
    save_dalle_checkpoint(
        str(path), dalle_config(model, bf16=False), model,
        vae_params=export_dvae_params(vae), epoch=3, vae_hparams=dvae_hparams(vae),
    )

    jcfg, jparams, jvae, meta, opt = jpipeline.load_dalle_checkpoint(str(path))
    assert meta["type"] == "DALLE" and meta["epoch"] == 3 and opt is None and jvae is not None
    jmodel = jpipeline.dalle_from_config(
        jcfg, num_image_tokens=32, image_fmap_size=4, vocab_size=cfg["num_text_tokens"]
    )
    text, img = _batch(seed=1)
    jlogits = jmodel.apply({"params": jparams}, jnp.asarray(text), jnp.asarray(img))
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(text), torch.from_numpy(img))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)

    _byte_default_vocabulary(monkeypatch)
    engine = engine_from_checkpoint(str(path), batch_shapes=(1,), device="cpu")
    assert engine.model.dim == 64 and engine.model.attn_types == ("full", "axial_row")
    for a, b in zip(engine.model.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)


def test_config_keeps_the_port_kernels_and_maps_the_library_one():
    """"lib_flash" trains through the port's flash kernels and decodes
    dense, as the reference's `_use_flash` / `_use_flash_decode` do; "ring"
    becomes "auto"."""
    model = DALLE(**TINY, attn_impl="flash")
    config = dalle_config(model)
    cases = (("lib_flash", "lib_flash"), ("auto", "auto"), ("dense", "dense"), ("ring", "auto"))
    for impl, expect in cases:
        config["model"]["attn_impl"] = impl
        built, dtype = dalle_from_config(config, 32, 4, TINY["num_text_tokens"])
        assert built.attn_impl == expect and dtype == torch.bfloat16
    attn = built.transformer.attn["0"]
    for impl, train, decode in (("lib_flash", True, False), ("flash", True, True), ("auto", True, True)):
        attn.attn_impl = impl
        assert attn.use_flash(1280, None) == train and attn.use_flash_decode(1281) == decode
    attn.attn_impl = "lib_flash"
    with pytest.raises(ValueError, match="lib_flash"):
        attn.use_flash(1280, torch.ones(1, 1280, dtype=torch.bool))


def test_remat_gives_the_gradients_of_the_plain_stack():
    tree = _jax_params(TINY, seed=9)
    text, img = _batch(seed=2)
    batch = {"text": torch.from_numpy(text), "image_tokens": torch.from_numpy(img)}
    grads = []
    for reversible in (False, True):
        model = load_dalle_params(
            DALLE(**TINY, attn_impl="flash", reversible=reversible, ff_dropout=0.1), tree
        )
        torch.manual_seed(0)  # the same dropout masks in both runs
        accumulate_gradients(model, make_dalle_loss(model, "forward_reverse_partial"), batch)
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)


def test_revnet_gives_the_gradients_of_autograd_through_its_forward():
    tree = _jax_params(TINY, seed=9)
    text, img = _batch(seed=3)
    batch = {"text": torch.from_numpy(text), "image_tokens": torch.from_numpy(img)}
    grads = []
    for impl in ("revnet", "revnet_naive"):
        model = load_dalle_params(
            DALLE(**TINY, attn_impl="flash", reversible=True, reversible_impl=impl), tree
        )
        accumulate_gradients(model, make_dalle_loss(model, "forward_reverse_partial"), batch)
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
