"""The generation CLIs end to end, the port's against the repository's
`generate.py` (CPU), and the engine's tokenizer taken from the config.

A tiny checkpoint written by the JAX package's `save_dalle_checkpoint`
whose config names no vocabulary (so both engines take the default 32k
native BPE), with its dVAE, and a CLIP checkpoint written by the JAX
package's `save_clip_checkpoint`. Both CLIs run greedy (`--top_k 1.0`
keeps one logit, so the packages' different noise plays no part; their
`--gentxt` completion is made greedy the same way) on two prompts, with
CLIP reranking, through the cached engine and through `--no_cache` with
`--gentxt`: the same files in the same directories, whose pixels (the
reference's written by PIL, the port's with zlib) agree within one uint8
step, and the same completed texts.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dalle_pytorch_tpu.data.tokenizer import get_tokenizer as j_get_tokenizer
from dalle_pytorch_tpu.models import dalle as jd
from dalle_pytorch_tpu.models.clip import CLIP as JCLIP
from dalle_pytorch_tpu.models.dvae import DiscreteVAE as JDVAE
from dalle_pytorch_tpu.serving.engine import engine_from_checkpoint as j_engine_from_checkpoint
from dalle_pytorch_tpu.training import pipeline as jpipeline
from dalle_pytorch_tpu.training.config import TrainConfig
from dalle_pytorch_tpu_torch import generate as port_generate
from dalle_pytorch_tpu_torch.data.tokenizer import NativeBPETokenizer
from dalle_pytorch_tpu_torch.serving.engine import engine_from_checkpoint
from dalle_pytorch_tpu_torch.utils.images import read_png

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
PROMPTS = "a red cube|a blue sphere"
VAE = dict(image_size=32, num_layers=3, num_tokens=32, codebook_dim=16, hidden_dim=8)


def _checkpoint(path, vocab, seed=0, **flags):
    """A tiny DALLE checkpoint of text vocabulary `vocab` written by the
    JAX package; `flags` set the config's tokenizer fields."""
    cfg = TrainConfig()
    for key, val in dict(dim=32, depth=2, heads=2, dim_head=16, text_seq_len=8, attn_types="full",
                         shift_tokens=True, rotary_emb=True).items():
        setattr(cfg.model, key, val)
    for key, val in flags.items():
        setattr(cfg, key, val)
    cfg.bf16 = False
    jm = jpipeline.dalle_from_config(cfg, num_image_tokens=32, image_fmap_size=4, vocab_size=vocab)
    params = jm.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32),
                     jnp.zeros((1, 16), jnp.int32))["params"]
    jv = JDVAE(**VAE)
    vparams = jv.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, 32, 32, 3)))["params"]
    jpipeline.save_dalle_checkpoint(
        str(path), cfg, params, vparams, epoch=0, vae_class_name="DiscreteVAE",
        vae_hparams=jpipeline.dvae_hparams(jv),
    )
    return path


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    folder = tmp_path_factory.mktemp("cli")
    vocab = j_get_tokenizer().vocab_size
    dalle = _checkpoint(folder / "dalle.npz", vocab)
    clip = JCLIP(dim_text=32, dim_image=32, dim_latent=16, num_text_tokens=vocab,
                 text_enc_depth=1, text_seq_len=8, text_heads=2, visual_enc_depth=1,
                 visual_heads=2, visual_image_size=32, visual_patch_size=8)
    cparams = clip.init(jax.random.PRNGKey(3), jnp.ones((1, 8), jnp.int32),
                        jnp.zeros((1, 32, 32, 3)))["params"]
    jpipeline.save_clip_checkpoint(str(folder / "clip.npz"), clip, cparams)
    return dalle, folder / "clip.npz"


def _reference_cli():
    spec = importlib.util.spec_from_file_location("reference_generate_cli", REPO / "generate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _greedy_texts(monkeypatch):
    """Both CLIs' `--gentxt` completion, greedy."""
    j_real, p_real = jd.generate_texts, port_generate.generate_texts
    monkeypatch.setattr(jd, "generate_texts", lambda *a, **k: j_real(*a, **k, filter_thres=1.0))
    monkeypatch.setattr(port_generate, "generate_texts",
                        lambda *a, **k: p_real(*a, **k, filter_thres=1.0))


@pytest.mark.parametrize("mode", ["cached", "no_cache_gentxt"])
def test_both_clis_write_the_same_images(checkpoints, tmp_path, monkeypatch, capsys, mode):
    dalle, clip = checkpoints
    args = ["--dalle_path", str(dalle), "--text", PROMPTS, "--num_images", "3", "--batch_size",
            "2", "--top_k", "1.0", "--clip_path", str(clip), "--seed", "4"]
    if mode != "cached":
        args += ["--no_cache", "--gentxt"]
        _greedy_texts(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["generate.py", *args, "--outputs_dir", str(tmp_path / "ref")])
    _reference_cli().main()
    ref_out = capsys.readouterr().out
    summary = port_generate.main([*args, "--outputs_dir", str(tmp_path / "port"), "--device", "cpu"])
    port_out = capsys.readouterr().out

    ref_files = sorted(p.relative_to(tmp_path / "ref") for p in (tmp_path / "ref").rglob("*.png"))
    port_files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.png"))
    assert port_files == ref_files and len(port_files) == 2 * (3 + 1)
    for rel in ref_files:
        ref = np.asarray(Image.open(tmp_path / "ref" / rel)).astype(int)
        port = read_png(tmp_path / "port" / rel).astype(int)
        assert port.shape == ref.shape
        assert np.abs(port - ref).max() <= 1, rel
    completed = lambda out: [ln for ln in out.splitlines() if ln.startswith("completed text:")]
    assert completed(port_out) == completed(ref_out)
    assert len(completed(port_out)) == (0 if mode == "cached" else 2)
    for entry in summary["prompts"]:
        assert sorted(entry["order"]) == [0, 1, 2]
        assert entry["scores"] == sorted(entry["scores"], reverse=True)
        assert entry["tokens"].shape == (3, 16)
    assert port_out.count("clip scores (best first):") == ref_out.count("clip scores (best first):") == 2


def test_engine_tokenizer_comes_from_the_config(checkpoints, tmp_path):
    """The engine builds the tokenizer its checkpoint's config names, as
    the reference's does: the default vocabulary, or the 8k one named by
    `native` + `bpe_path`; an embedding of another size raises."""
    dalle, _ = checkpoints
    port = engine_from_checkpoint(str(dalle), batch_shapes=(1,), device="cpu")
    ref = j_engine_from_checkpoint(str(dalle), batch_shapes=(1,))
    assert isinstance(port.tokenizer, NativeBPETokenizer) and port.tokenizer.vocab_size == 32768
    assert port.cfg["model"]["dim"] == 32 and port.clip is None
    for prompt in ("a red cube", "ünïcödé ☃ 日本", "", "words " * 40):
        np.testing.assert_array_equal(port.tokenize(prompt), ref.tokenize(prompt))

    model_8k = REPO / "dalle_pytorch_tpu" / "data" / "default_bpe_8k.model"
    named = _checkpoint(tmp_path / "named.npz", 8192, seed=5, native=True, bpe_path=str(model_8k))
    port = engine_from_checkpoint(str(named), batch_shapes=(1,), device="cpu")
    ref = j_engine_from_checkpoint(str(named), batch_shapes=(1,))
    assert port.tokenizer.vocab_size == ref.tokenizer.vocab_size == 8192
    np.testing.assert_array_equal(port.tokenize("a blue sphere"), ref.tokenize("a blue sphere"))

    wrong = _checkpoint(tmp_path / "wrong.npz", 50, seed=6)
    with pytest.raises(ValueError, match="text embedding has 58 rows"):
        engine_from_checkpoint(str(wrong), batch_shapes=(1,), device="cpu")
