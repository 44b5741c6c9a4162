"""The port's dVAE encoder vs the JAX package's.

The same JAX-initialized weights (loaded by `weights.py`: HWIO -> OIHW)
and the same numpy images go through both. Held (float32, JAX at matmul
precision "highest"):

* `encode_logits` within 1e-5 absolute (logits are O(1));
* `get_codebook_indices` identical at every position whose top-2 logit
  gap exceeds 2e-5 (twice that tolerance), and such positions are
  asserted to be the great majority;
* the encode runs without TF32 whatever the process set (torch lets
  cuDNN use it by default), and restores the process's settings;
* the encoder and decoder leaves round-trip exactly through
  `load_dvae_params` / `export_dvae_params`, and a dVAE checkpoint
  written by either package loads in the other with the same
  hyperparameters and leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.dvae import DiscreteVAE as JDVAE
from dalle_pytorch_tpu.training import pipeline as jpipeline
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.training.pipeline import load_vae_checkpoint, save_vae_checkpoint
from dalle_pytorch_tpu_torch.weights import export_dvae_params, load_dvae_params

torch.set_num_threads(2)

LOGIT_TOL = 1e-5

CASES = {
    "plain": dict(image_size=32, num_layers=3, num_tokens=64, codebook_dim=16, hidden_dim=16),
    "resblocks": dict(image_size=32, num_layers=2, num_tokens=48, codebook_dim=8, hidden_dim=12,
                      num_resnet_blocks=2),
    "one-layer-gray": dict(image_size=16, num_layers=1, num_tokens=32, codebook_dim=8,
                           hidden_dim=8, channels=1),
}


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _pair(cfg, seed=0):
    jv = JDVAE(**cfg)
    size, chans = cfg["image_size"], cfg.get("channels", 3)
    params = jax.jit(jv.init)(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, chans)))["params"]
    params = jax.tree.map(np.asarray, params)
    return jv, params, load_dvae_params(DiscreteVAE(**cfg), params).eval()


def _images(cfg, b=3, seed=1):
    size, chans = cfg["image_size"], cfg.get("channels", 3)
    return np.random.RandomState(seed).rand(b, size, size, chans).astype(np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_encode_logits_and_indices_match(name):
    cfg = CASES[name]
    jv, params, vae = _pair(cfg, seed=len(name))
    images = _images(cfg)
    ref = np.asarray(jv.apply({"params": params}, jnp.asarray(images), method=JDVAE.encode_logits))
    ref_idx = np.asarray(jv.apply({"params": params}, jnp.asarray(images),
                                  method=JDVAE.get_codebook_indices))
    with torch.no_grad():
        logits = vae.encode_logits(torch.from_numpy(images)).numpy()
        idx = vae.get_codebook_indices(torch.from_numpy(images)).numpy()
    fmap = cfg["image_size"] // 2 ** cfg["num_layers"]
    assert logits.shape == ref.shape == (3, fmap, fmap, cfg["num_tokens"])
    np.testing.assert_allclose(logits, ref, atol=LOGIT_TOL, rtol=0)
    assert idx.shape == ref_idx.shape == (3, fmap * fmap)
    top2 = np.sort(logits.reshape(3, fmap * fmap, -1), axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_TOL
    assert clear.mean() > 0.9
    assert np.array_equal(idx[clear], ref_idx[clear])


def test_encode_refuses_another_image_size():
    cfg = CASES["plain"]
    with pytest.raises(ValueError, match="image size"):
        DiscreteVAE(**cfg).encode_logits(torch.zeros(1, 16, 16, 3))


@pytest.mark.parametrize("cudnn_tf32", [True, False])
def test_encode_runs_without_tf32_and_restores_the_settings(monkeypatch, cudnn_tf32):
    """Every encoder convolution sees TF32 off in cuDNN and cuBLAS; the
    process's own settings are back after the encode."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", cudnn_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    vae = DiscreteVAE(**CASES["resblocks"]).eval()
    seen = []
    for conv in [*vae.enc_convs, vae.enc_head]:
        conv.register_forward_hook(lambda *_: seen.append(
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    with torch.no_grad():
        vae.get_codebook_indices(torch.from_numpy(_images(CASES["resblocks"])))
    assert seen == [(False, False)] * (len(vae.enc_convs) + 1)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (cudnn_tf32, True)


@pytest.mark.parametrize("name", list(CASES))
def test_encoder_leaves_round_trip(name):
    cfg = CASES[name]
    _, params, vae = _pair(cfg, seed=7)
    out, ref = _flat(export_dvae_params(vae)), _flat(params)
    assert sorted(out) == sorted(ref)
    assert any(k.startswith("enc_convs_0/") for k in out) and "enc_head/kernel" in out
    for path, leaf in ref.items():
        assert out[path].dtype == np.float32 and np.array_equal(out[path], leaf), path


def test_vae_checkpoints_load_across_packages(tmp_path):
    cfg = CASES["resblocks"]
    jv, params, vae = _pair(cfg, seed=5)
    ours = tmp_path / "port_vae.npz"
    save_vae_checkpoint(str(ours), vae, epoch=2)
    jvae, jparams = jpipeline.load_vae_checkpoint(str(ours))
    assert jpipeline.dvae_hparams(jvae) == jpipeline.dvae_hparams(jv)
    for path, leaf in _flat(params).items():
        assert np.array_equal(_flat(jparams)[path], leaf), path

    theirs = tmp_path / "jax_vae"
    jpipeline.save_vae_checkpoint(str(theirs), jv, params, epoch=1)
    back = load_vae_checkpoint(str(theirs) + ".npz")
    from dalle_pytorch_tpu_torch.training.pipeline import dvae_hparams

    assert dvae_hparams(back) == jpipeline.dvae_hparams(jv)
    for a, b in zip(back.state_dict().values(), vae.state_dict().values()):
        assert torch.equal(a, b)
