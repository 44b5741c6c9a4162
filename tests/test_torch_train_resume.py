"""Resuming the port's trainer (`train_dalle.py` twin) is the run that did
not stop, bit for bit on the CPU.

Each case trains a tiny DALLE (dim 64, depth 2, 4 heads of 16, 8 text +
16 image tokens, `attn_impl="flash"` through the plain versions, float32)
on rainbow:16 with a seeded 32 px dVAE (the in-step encode), batch 4 (4
steps an epoch), for 2 epochs, three times: uninterrupted; then 1 epoch
with a step checkpoint at step 3; then `--resume --epochs 2` from that
run's directory, which restores step 3 (mid-epoch: it skips 3 batches
and carries the epoch's losses) and runs to step 8. The resumed run's
final export equals the uninterrupted run's exactly: every DALLE leaf,
every optimizer leaf (Adam's moments, counts, learning rate), the global
step and the plateau state. Cases: the plain step; `steps_per_dispatch=3`
(a window of 3 steps, then the epoch tail alone; the checkpoint at the
window's end); dropout and null conditioning on (the step key seeds
them); and the same three stopping and resuming through the export of
`--dalle_path` at an epoch's end. Windows of 2 and 3 steps also end
where the one-step loop ends (the plateau state aside: it sees the
windows' mean losses, as the reference's does); training from
`precompute_tokens`' artifact ends where the in-step encode ends; and an
export is a copy of the live state, never a view.
"""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch import train_dalle
from dalle_pytorch_tpu_torch.data import tokenizer as port_tokenizer
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.training.checkpoint import load_params_npz
from dalle_pytorch_tpu_torch.training.pipeline import save_vae_checkpoint

torch.set_num_threads(2)

TINY_VAE = dict(image_size=32, num_layers=3, num_tokens=32, codebook_dim=16, hidden_dim=8)

CASES = {
    "plain": [],
    "steps_per_dispatch_3": ["--set", "steps_per_dispatch=3"],
    "dropout_null_cond": ["--set", "model.attn_dropout=0.2", "--set", "model.ff_dropout=0.2",
                          "--set", "null_cond_prob=0.5", "--exp", "r"],
}


@pytest.fixture(autouse=True)
def _byte_default_vocabulary(monkeypatch):
    """The byte tokenizer as the default vocabulary: a small embedding."""
    monkeypatch.setattr(port_tokenizer, "default_vocabularies", lambda: [])
    monkeypatch.setattr(port_tokenizer, "_default_decision", None)
    monkeypatch.setattr(port_tokenizer, "_warned_default_probe", True)


def _args(out_dir, vae_path, *extra):
    return [
        "--device", "cpu", "--image_text_folder", "rainbow:16", "--vae_path", str(vae_path),
        "--batch_size", "4", "--learning_rate", "1e-3",
        "--set", "model.dim=64", "--set", "model.depth=2", "--set", "model.heads=4",
        "--set", "model.dim_head=16", "--set", "model.text_seq_len=8",
        "--set", "model.attn_impl=flash", "--set", "bf16=false", "--set", "lr_decay=true",
        "--set", "save_every_n_steps=3", "--set", "log_images_freq=0",
        "--set", f"output_dir={out_dir}", *extra,
    ]


def _export(path):
    params, meta = load_params_npz(path)
    return params, meta


def _same_tree(x, y, where=""):
    assert sorted(x) == sorted(y), where
    for k in x:
        if isinstance(x[k], dict):
            _same_tree(x[k], y[k], f"{where}/{k}")
        else:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), f"{where}/{k}"


def _assert_identical(a, b):
    (pa, ma), (pb, mb) = a, b
    assert ma["train"] == mb["train"] and ma["epoch"] == mb["epoch"]
    _same_tree(pa, pb)
    assert "opt" in pa and len(pa["opt"]) > 3


@pytest.mark.parametrize("name", list(CASES))
def test_resume_from_a_step_checkpoint_is_the_uninterrupted_run(tmp_path, name):
    torch.manual_seed(0)
    vae_path = tmp_path / "vae.npz"
    save_vae_checkpoint(str(vae_path), DiscreteVAE(**TINY_VAE))
    extra = CASES[name]
    full = train_dalle.main(_args(tmp_path / "full", vae_path, "--epochs", "2", *extra))
    first = train_dalle.main(_args(tmp_path / "cut", vae_path, "--epochs", "1", *extra))
    assert first["global_step"] == 4
    resumed = train_dalle.main(_args(tmp_path / "cut", vae_path, "--epochs", "2", "--resume", *extra))
    assert resumed["resumed_step"] == 3 and resumed["global_step"] == full["global_step"] == 8
    assert resumed["plateau"] == full["plateau"]
    _assert_identical(_export(full["out_file"]), _export(resumed["out_file"]))


@pytest.mark.parametrize("name", ["plain", "dropout_null_cond"])
def test_resume_from_an_epoch_export_is_the_uninterrupted_run(tmp_path, name):
    """`--dalle_path` at the end of epoch 1 carries the weights, the Adam
    state, the global step and the plateau state; the run goes on with
    epoch 2 as the uninterrupted one does."""
    torch.manual_seed(0)
    vae_path = tmp_path / "vae.npz"
    save_vae_checkpoint(str(vae_path), DiscreteVAE(**TINY_VAE))
    extra = CASES[name]
    full = train_dalle.main(_args(tmp_path / "full", vae_path, "--epochs", "2", *extra))
    first = train_dalle.main(_args(tmp_path / "cut", vae_path, "--epochs", "1", *extra))
    resumed = train_dalle.main(_args(tmp_path / "again", vae_path, "--epochs", "2",
                                     "--dalle_path", first["out_file"], *extra))
    assert resumed["global_step"] == 8
    _assert_identical(_export(full["out_file"]), _export(resumed["out_file"]))


@pytest.mark.parametrize("window", [2, 3])
def test_steps_per_dispatch_is_the_one_step_run(tmp_path, window):
    """A window of steps (`make_multi_step`, one key a step), and the
    epoch tail a window leaves, run the steps the one-step loop runs."""
    torch.manual_seed(0)
    vae_path = tmp_path / "vae.npz"
    save_vae_checkpoint(str(vae_path), DiscreteVAE(**TINY_VAE))
    extra = ["--epochs", "2", *CASES["dropout_null_cond"]]
    one = train_dalle.main(_args(tmp_path / "one", vae_path, *extra))
    windowed = train_dalle.main(_args(tmp_path / "win", vae_path, *extra,
                                      "--set", f"steps_per_dispatch={window}"))
    assert one["global_step"] == windowed["global_step"] == 8
    assert len(one["step_ms"]) == len(windowed["step_ms"]) == 8  # each step timed
    (pa, ma), (pb, mb) = _export(one["out_file"]), _export(windowed["out_file"])
    assert ma["train"]["global_step"] == mb["train"]["global_step"]
    _same_tree({k: pa[k] for k in ("dalle", "opt")}, {k: pb[k] for k in ("dalle", "opt")})


def test_training_from_precomputed_tokens_is_the_in_step_encode_run(tmp_path):
    """`precompute_tokens` then `--tokens_path` trains what the in-step
    encode trains: the same captions in the same order, the same tokens
    (one encode function), so the same weights and Adam state."""
    from dalle_pytorch_tpu_torch import precompute_tokens

    torch.manual_seed(0)
    vae_path = tmp_path / "vae.npz"
    save_vae_checkpoint(str(vae_path), DiscreteVAE(**TINY_VAE))
    tokens = tmp_path / "tokens.npz"
    precompute_tokens.main(["--device", "cpu", "--image_text_folder", "rainbow:16",
                            "--vae_path", str(vae_path), "--output", str(tokens)])
    extra = ["--epochs", "2", *CASES["dropout_null_cond"]]
    encoded = train_dalle.main(_args(tmp_path / "enc", vae_path, *extra))
    from_tokens = train_dalle.main(_args(tmp_path / "tok", vae_path, *extra,
                                         "--tokens_path", str(tokens)))
    (pa, ma), (pb, mb) = _export(encoded["out_file"]), _export(from_tokens["out_file"])
    assert "vae" in pa and "vae" not in pb and ma["train"] == mb["train"]
    _same_tree({k: pa[k] for k in ("dalle", "opt")}, {k: pb[k] for k in ("dalle", "opt")})


def test_exports_are_copies_of_the_live_state():
    """A step checkpoint is written in the background while training goes
    on: its arrays must not be views of the parameters or the moments."""
    from dalle_pytorch_tpu_torch.models.dalle import DALLE
    from dalle_pytorch_tpu_torch.training.steps import make_dalle_train_step, make_optimizer
    from dalle_pytorch_tpu_torch.weights import export_dalle_opt_state, export_dalle_params

    torch.manual_seed(0)
    model = DALLE(dim=32, depth=1, heads=2, dim_head=16, num_image_tokens=16, image_fmap_size=2,
                  num_text_tokens=20, text_seq_len=4)
    opt = make_optimizer(model.parameters(), 1e-2)
    batch = {"text": torch.randint(1, 20, (2, 4)), "image_tokens": torch.randint(0, 16, (2, 4))}
    step = make_dalle_train_step(model, opt, autocast_dtype=None)
    step(batch)
    params, leaves = export_dalle_params(model), export_dalle_opt_state(model, opt)
    kept = ({k: v.copy() for k, v in params.items() if not isinstance(v, dict)},
            [x.copy() for x in leaves])
    step(batch)
    for k, v in kept[0].items():
        assert np.array_equal(params[k], v), k
    for a, b in zip(leaves, kept[1]):
        assert np.array_equal(a, b)
