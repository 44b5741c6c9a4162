"""The port's dVAE trainer (`dalle_pytorch_tpu_torch/train_vae.py`, the twin
of the repository's `train_vae.py`) on the CPU.

* A tiny run (rainbow:16, 16 px, 2 layers, 16 codes, 2 epochs) writes an
  export that the JAX `load_vae_checkpoint` reads: its logits equal the
  port's (1e-5, float32), so the codes and the decode agree, and the
  hyperparameters round-trip.
* The anneal and the learning-rate decay: with `steps_per_dispatch` 3
  over epochs of 40 one-image batches (13 windows and a one-step tail an
  epoch), and with windows of 150 steps (one of which crosses two
  boundaries), the temperatures and learning rates the run logs at each
  crossing of a multiple of 100 steps equal the reference loop's
  schedule (`train_vae.py:222-236`: one anneal and one decay step per
  crossed boundary, at the boundary's own step value), computed here
  from its formula, exactly in float64 / float32.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models.dvae import DiscreteVAE as JDVAE
from dalle_pytorch_tpu.training import pipeline as jpipeline
from dalle_pytorch_tpu_torch import train_vae
from dalle_pytorch_tpu_torch.training.pipeline import load_vae_checkpoint
from test_torch_train_cli import _byte_default_vocabulary

torch.set_num_threads(2)

TINY = ["--set", "vae.image_size=16", "--set", "vae.num_layers=2", "--set", "vae.num_tokens=16",
        "--set", "vae.codebook_dim=8", "--set", "vae.hidden_dim=8"]


def _args(tmp_path, *extra):
    return ["--device", "cpu", "--output", str(tmp_path / "vae.npz"),
            "--set", f"output_dir={tmp_path}", *TINY, *extra]


def test_the_export_loads_in_the_reference_with_the_same_outputs(tmp_path, monkeypatch):
    _byte_default_vocabulary(monkeypatch)
    summary = train_vae.main(_args(tmp_path, "--image_folder", "rainbow:16", "--batch_size", "4",
                                   "--epochs", "2", "--set", "vae.straight_through=true",
                                   "--set", "vae.reinmax=true"))
    assert summary["global_step"] == 8 and np.isfinite(summary["last_loss"])
    jvae, jparams = jpipeline.load_vae_checkpoint(summary["out_file"])
    assert jvae.straight_through and jvae.reinmax and jvae.num_tokens == 16
    vae = load_vae_checkpoint(summary["out_file"]).eval()
    images = np.random.RandomState(0).rand(3, 16, 16, 3).astype(np.float32)
    ref = jvae.apply({"params": jparams}, jnp.asarray(images), return_logits=True)
    with torch.no_grad():
        logits = vae(torch.from_numpy(images), return_logits=True)
        pixels = vae.decode(logits.argmax(-1).reshape(3, -1))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    codes = np.asarray(ref).argmax(-1).reshape(3, -1)
    jpixels = jvae.apply({"params": jparams}, jnp.asarray(codes), method=JDVAE.decode)
    np.testing.assert_allclose(pixels.numpy(), np.asarray(jpixels), atol=1e-5, rtol=0)


def _reference_schedule(temp, lr, anneal_rate, temp_min, gamma, epochs, per_epoch, spd):
    """The reference loop's (step, temperature, learning rate) at each
    crossing of a multiple of 100, for windows of `spd` steps (an epoch's
    tail of fewer runs step by step and is checked once after it)."""
    out, step = [], 0
    lr = float(np.float32(lr))
    for _ in range(epochs):
        left = per_epoch
        while left:
            n = spd if left >= spd else left
            prev, step, left = step, step + n, left - n
            if step // 100 > prev // 100:
                for boundary in range(prev // 100 + 1, step // 100 + 1):
                    temp = max(temp * math.exp(-anneal_rate * boundary * 100), temp_min)
                    lr = float(np.float32(lr * gamma))
                out.append((step, temp, lr))
    return out


@pytest.mark.parametrize("spd, per_epoch, epochs, crossings", [
    (3, 40, 6, [101, 200]),  # a window steps over 100, an epoch's tail lands on 200
    (150, 320, 1, [150, 300]),  # the window 150..300 crosses 200 and 300
])
def test_anneal_and_decay_at_crossed_boundaries_with_windows(
        tmp_path, monkeypatch, spd, per_epoch, epochs, crossings):
    _byte_default_vocabulary(monkeypatch)
    summary = train_vae.main(_args(
        tmp_path, "--image_folder", f"rainbow:{per_epoch}", "--batch_size", "1",
        "--epochs", str(epochs), "--learning_rate", "1e-3", "--lr_decay_rate", "0.9",
        "--set", "lr_decay=true", "--set", f"steps_per_dispatch={spd}",
        "--set", "vae.anneal_rate=1e-3", "--set", "vae.temp_min=0.3",
        "--set", "vae.temperature=0.9"))
    assert summary["global_step"] == per_epoch * epochs
    expect = _reference_schedule(0.9, 1e-3, 1e-3, 0.3, 0.9, epochs, per_epoch, spd)
    assert [s for s, _, _ in expect] == crossings
    assert summary["temperatures"] == [(s, t) for s, t, _ in expect]
    got_lr = [lr for _, lr in summary["learning_rates"]]
    assert got_lr == pytest.approx([lr for _, _, lr in expect], rel=1e-6)
    assert summary["temperature"] == expect[-1][1]
    assert all(0 < u <= 1 for _, u in summary["usage"])
    assert (tmp_path / "vae_logs" / f"recons_{crossings[0]}.png").exists()
