"""The port's pretrained-VAE wrappers (`models/vae_io.py`) vs the JAX
package's, and the trainer and the engine over them (CPU, float32).

Synthetic checkpoints only (no released weights are here): the OpenAI
dVAE's pickles from the dall_e-layout golden model of
`tests/test_openai_vae.py` (32 codes, f/8), the VQGAN's from the
taming-layout golden model of `tests/test_vqgan.py` (16 px, f/2, 16
codes), and a Gumbel-quantizer variant of it. Held:

* each wrapper against the JAX wrapper on the same files: the scores its
  argmax takes (the OpenAI logits; the VQGAN's negated distances or
  Gumbel logits) within 1e-4 absolute, indices identical wherever the
  JAX scores' top-2 gap exceeds 1e-3, the decode within 1e-5, the
  geometry equal;
* the VQGAN config read as JSON with PyYAML's import masked, and a YAML
  config then refused with an error naming PyYAML;
* `chip_smoke.py`'s synthetic state dicts at the released geometries have
  the golden models' keys and shapes, and its VQGAN ddconfig is the
  committed config's;
* the DALLE trainer twin with `--taming` and with neither `--vae_path`
  nor `--taming` (the OpenAI dVAE from `vae_io.CACHE_PATH`, pointed at a
  temporary directory): the exports carry no VAE weights and name the
  wrapper, the JAX `load_dalle_checkpoint` reads them, and
  `engine_from_checkpoint` rebuilds the wrapper from the config and
  serves (the VQGAN run: a generated image in [0, 1]; the OpenAI run:
  its pixel decode equal to the wrapper's).
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from dalle_pytorch_tpu.models import vae_io as jvae_io
from dalle_pytorch_tpu.training import pipeline as jpipeline
from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.models import vae_io
from dalle_pytorch_tpu_torch.serving.engine import SampleSpec, engine_from_checkpoint
from test_openai_vae import TDecoder, TEncoder
from test_torch_train_cli import _byte_default_vocabulary, trainer_args
from test_vqgan import DD, TVQGAN, make_taming_ckpt

torch.set_num_threads(2)

SCORE_TOL, DECODE_TOL = 1e-4, 1e-5


def _openai_dir(tmp_path, seed=0):
    torch.manual_seed(seed)
    d = tmp_path / "openai"
    d.mkdir()
    torch.save(TEncoder(vocab=32).state_dict(), d / "encoder.pkl")
    torch.save(TDecoder(vocab=32).state_dict(), d / "decoder.pkl")
    return d


def _hold_indices(got_scores, ref_scores, got_idx):
    ref_scores = np.asarray(ref_scores)
    np.testing.assert_allclose(got_scores, ref_scores, atol=SCORE_TOL, rtol=0)
    top2 = np.sort(ref_scores, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 10 * SCORE_TOL
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(np.asarray(got_idx)[clear], ref_scores.argmax(-1)[clear])


def test_openai_wrapper_matches_the_reference(tmp_path):
    d = _openai_dir(tmp_path)
    jv, pv = jvae_io.OpenAIDiscreteVAE(cache_dir=d), vae_io.OpenAIDiscreteVAE(cache_dir=d)
    assert (pv.num_tokens, pv.num_layers, pv.image_size, pv.fmap_size) == (32, 3, 256, 32)
    assert (jv.num_tokens, jv.num_layers) == (pv.num_tokens, pv.num_layers)
    images = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    g = jv._graph
    ref = g.encode_logits(g.enc, jv.map_pixels(jnp.asarray(images))).reshape(2, -1, 32)
    with torch.no_grad():
        scores = pv.encode_scores(torch.from_numpy(images))
        idx = pv.get_codebook_indices(torch.from_numpy(images))
    _hold_indices(scores.numpy(), ref, idx.numpy())
    codes = np.random.RandomState(1).randint(0, 32, (2, 16)).astype(np.int32)
    with torch.no_grad():
        pixels = pv.decode(torch.from_numpy(codes))
    np.testing.assert_allclose(pixels.numpy(), np.asarray(jv.decode(jnp.asarray(codes))),
                               atol=DECODE_TOL, rtol=0)


def _gumbel_ckpt(d, seed=0):
    """A Gumbel-quantizer VQGAN (taming's GumbelVQ layout) from the golden
    model: `quantize.embed` and a 1x1 `quantize.proj` to the codes."""
    torch.manual_seed(seed)
    state = TVQGAN().state_dict()
    state["quantize.embed.weight"] = state.pop("quantize.embedding.weight")
    state["quantize.proj.weight"] = torch.randn(16, DD["z_channels"], 1, 1) * 0.3
    state["quantize.proj.bias"] = torch.randn(16) * 0.1
    del state["quant_conv.weight"], state["quant_conv.bias"]
    torch.save({"state_dict": state}, d / "model.ckpt")
    config = {"model": {"target": "taming.models.vqgan.GumbelVQ",
                        "params": {"ddconfig": DD, "n_embed": 16, "embed_dim": 8}}}
    (d / "config.yaml").write_text(yaml.safe_dump(config))
    return d / "model.ckpt", d / "config.yaml"


@pytest.mark.parametrize("gumbel", [False, True])
def test_vqgan_wrapper_matches_the_reference(tmp_path, gumbel):
    if gumbel:
        model_path, config_path = _gumbel_ckpt(tmp_path)
    else:
        _, model_path, config_path = make_taming_ckpt(tmp_path)
    jv = jvae_io.VQGanVAE(str(model_path), str(config_path))
    pv = vae_io.VQGanVAE(str(model_path), str(config_path))
    assert pv.is_gumbel == gumbel == jv.is_gumbel
    assert (pv.image_size, pv.num_layers, pv.num_tokens) == (jv.image_size, jv.num_layers, jv.num_tokens)
    images = np.random.RandomState(2).rand(2, 16, 16, 3).astype(np.float32)
    g = jv._graph
    z = g.encode_z(g.p, 2.0 * jnp.asarray(images) - 1.0)
    if gumbel:
        ref = g._conv(g.p, "quantize.proj", z).reshape(2, -1, 16)
    else:
        emb = g.p["quantize.embedding.weight"]
        flat = z.reshape(2, -1, z.shape[-1])
        ref = -((flat**2).sum(-1, keepdims=True) - 2 * flat @ emb.T + (emb**2).sum(-1))
    with torch.no_grad():
        scores = pv.encode_scores(torch.from_numpy(images))
        idx = pv.get_codebook_indices(torch.from_numpy(images))
    _hold_indices(scores.numpy(), ref, idx.numpy())
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jv.get_codebook_indices(jnp.asarray(images))))
    codes = np.random.RandomState(3).randint(0, 16, (2, 64)).astype(np.int32)
    with torch.no_grad():
        pixels = pv.decode(torch.from_numpy(codes))
    np.testing.assert_allclose(pixels.numpy(), np.asarray(jv.decode(jnp.asarray(codes))),
                               atol=DECODE_TOL, rtol=0)


def test_a_json_config_needs_no_pyyaml(tmp_path, monkeypatch):
    _, model_path, config_path = make_taming_ckpt(tmp_path)
    json_path = tmp_path / "config.json"
    json_path.write_text(json.dumps(yaml.safe_load(config_path.read_text())))
    monkeypatch.setitem(sys.modules, "yaml", None)  # `import yaml` raises ImportError
    vae = vae_io.VQGanVAE(str(model_path), str(json_path))
    assert (vae.image_size, vae.num_layers, vae.num_tokens) == (16, 1, 16)
    with pytest.raises(ImportError, match="PyYAML"):
        vae_io.VQGanVAE(str(model_path), str(config_path))


def test_chip_smoke_synthetic_states_have_the_golden_layouts():
    enc, dec = chip_smoke.openai_vae_states(torch, n_hid=8, n_init=16, vocab=32, groups=4, blocks=1,
                                            device="cpu")
    for ours, golden in ((enc, TEncoder(vocab=32)), (dec, TDecoder(vocab=32))):
        ref = golden.state_dict()
        assert {k: tuple(v.shape) for k, v in ours.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    state = chip_smoke.vqgan_state(torch, DD, n_embed=16, embed_dim=8, device="cpu")
    ref = TVQGAN().state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    committed = yaml.safe_load((chip_smoke.REPO / "configs" / "vqgan_imagenet_f16_16384.yaml").read_text())
    params = committed["model"]["params"]
    assert chip_smoke.VQGAN_F16["ddconfig"] == params["ddconfig"]
    assert (chip_smoke.VQGAN_F16["n_embed"], chip_smoke.VQGAN_F16["embed_dim"]) == (
        params["n_embed"], params["embed_dim"])


def _taming_args(tmp_path, model_path, config_path):
    args = trainer_args(tmp_path / "run", "", "--epochs", "1", "--image_text_folder", "rainbow:8",
                        "--taming", "--set", f"vqgan_model_path={model_path}",
                        "--set", f"vqgan_config_path={config_path}")
    return args


def test_the_trainer_and_the_engine_take_the_vqgan(tmp_path, monkeypatch):
    _byte_default_vocabulary(monkeypatch)
    _, model_path, config_path = make_taming_ckpt(tmp_path)
    summary = train_dalle.main(_taming_args(tmp_path, model_path, config_path))
    assert summary["global_step"] == 2 and np.isfinite(summary["last_loss"])
    cfg, jparams, jvae, meta, _ = jpipeline.load_dalle_checkpoint(summary["out_file"])
    assert jvae is None and meta["vae_class_name"] == "VQGanVAE" and cfg.taming
    engine = engine_from_checkpoint(summary["out_file"], batch_shapes=(1,), device="cpu")
    assert isinstance(engine.vae, vae_io.VQGanVAE) and engine.model.image_fmap_size == 8
    text = np.zeros(8, np.int32)
    toks, pixels = engine.generate([SampleSpec(text, seed=3)])
    assert toks.shape == (1, 64) and pixels.shape == (1, 16, 16, 3)
    assert 0.0 <= pixels.min() and pixels.max() <= 1.0
    with torch.no_grad():
        ref = engine.vae.decode(torch.from_numpy(toks)).float().numpy()
    np.testing.assert_allclose(pixels, ref, atol=1e-6, rtol=0)


def test_the_trainer_defaults_to_the_openai_dvae(tmp_path, monkeypatch):
    _byte_default_vocabulary(monkeypatch)
    monkeypatch.setattr(vae_io, "CACHE_PATH", _openai_dir(tmp_path))
    args = trainer_args(tmp_path / "run", "", "--epochs", "1", "--image_text_folder", "rainbow:4")
    summary = train_dalle.main(args)
    assert summary["global_step"] == 1 and np.isfinite(summary["last_loss"])
    _, _, jvae, meta, _ = jpipeline.load_dalle_checkpoint(summary["out_file"])
    assert jvae is None and meta["vae_class_name"] == "OpenAIDiscreteVAE"
    engine = engine_from_checkpoint(summary["out_file"], mode="continuous", batch_shapes=(2,),
                                    device="cpu")
    assert isinstance(engine.vae, vae_io.OpenAIDiscreteVAE) and engine.model.image_fmap_size == 32
    toks = np.random.RandomState(4).randint(0, 32, (2, 1024)).astype(np.int32)
    pixels = engine.decode_pixels(toks)
    with torch.no_grad():
        ref = engine.vae.decode(torch.from_numpy(toks)).float().numpy()
    np.testing.assert_allclose(pixels, ref, atol=1e-6, rtol=0)
    assert engine.preview_fill_token() == 0
