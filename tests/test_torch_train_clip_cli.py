"""The port's CLIP trainer (`dalle_pytorch_tpu_torch/train_clip.py`, the
twin of the repository's `train_clip.py`) on the CPU.

Tiny runs (rainbow:16, 16 px images in 8 px patches, 8 text tokens, dim
32, depth 1, 2 heads; the byte tokenizer) in both layouts, with and
without windows of `--steps_per_dispatch`: the export loads in the JAX
`load_clip_checkpoint` (in the layout `--executor` names, "scan" for the
JAX scan executor), and the JAX model's scores on the same pairs equal
the port's `clip_scores` (1e-5, float32); the port's loader reads it
back to the same weights, and the port's `engine_from_checkpoint`
takes it as its `clip_path`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.training import pipeline as jpipeline
from dalle_pytorch_tpu_torch import train_clip, train_dalle
from dalle_pytorch_tpu_torch.models.clip import clip_scores
from dalle_pytorch_tpu_torch.serving.engine import engine_from_checkpoint
from dalle_pytorch_tpu_torch.training.pipeline import load_clip_checkpoint
from test_torch_train_cli import _byte_default_vocabulary, _vae_file, trainer_args

torch.set_num_threads(2)


@pytest.mark.parametrize("executor, spd", [("unrolled", 1), ("scan", 3)])
def test_the_export_loads_in_the_reference_with_the_same_scores(tmp_path, monkeypatch,
                                                                 executor, spd):
    _byte_default_vocabulary(monkeypatch)
    out = tmp_path / "clip.npz"
    summary = train_clip.main([
        "--device", "cpu", "--image_text_folder", "rainbow:16", "--output", str(out),
        "--epochs", "2", "--batch_size", "4", "--image_size", "16", "--patch_size", "8",
        "--text_seq_len", "8", "--dim", "32", "--dim_latent", "16", "--depth", "1",
        "--heads", "2", "--executor", executor, "--steps_per_dispatch", str(spd),
    ])
    assert summary["global_step"] == 8 and np.isfinite(summary["last_loss"])
    assert len(summary["step_ms"]) == 8

    jclip, jparams = jpipeline.load_clip_checkpoint(str(out))
    assert jclip.executor == executor
    assert ("scan_stack" in jparams["text_transformer"]) == (executor == "scan")
    clip = load_clip_checkpoint(str(out)).eval()
    assert clip.executor == executor
    rng = np.random.RandomState(0)
    text = rng.randint(1, clip.num_text_tokens, (3, 8)).astype(np.int32)
    images = rng.rand(3, 16, 16, 3).astype(np.float32)
    ref = jclip.apply({"params": jparams}, jnp.asarray(text), jnp.asarray(images))
    scores = clip_scores(clip, torch.from_numpy(text), torch.from_numpy(images))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref), atol=1e-5, rtol=0)

    if executor == "scan":  # the reranker of a serving engine
        dalle = train_dalle.main(trainer_args(tmp_path / "run", _vae_file(tmp_path), "--epochs", "1",
                                              "--image_text_folder", "rainbow:4"))
        engine = engine_from_checkpoint(dalle["out_file"], batch_shapes=(1,), clip_path=str(out),
                                        device="cpu")
        for a, b in zip(engine.clip.state_dict().values(), clip.state_dict().values()):
            assert torch.equal(a, b)
