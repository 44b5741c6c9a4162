"""The port's trainer (`train_dalle.py` twin, Adam state in checkpoints,
the cadences, `precompute_tokens`) vs the JAX package's; the in-step
encode's step is in `test_torch_train_encode.py`, resuming in
`test_torch_train_resume.py`.

Tiny models (DALLE dim 64, depth 2, 4 heads of 16, 8 text + 16 image
tokens, `attn_impl="flash"`: JAX runs its Pallas kernels in interpret
mode, the port their plain versions; dVAE 32 px, 3 layers, 32 codes),
float32, JAX at matmul precision "highest". Held:

* Adam state both ways: the JAX state after 2 steps resumes in the port
  (`restore_opt_state`), and the port's `opt` leaves in the JAX
  package's `restore_opt_state` with no mismatch warning, the leaves
  equal; then one more update with the same gradient (the JAX step's,
  dense attention: the state transfer is what is held) in each package:
  parameters and every optimizer leaf within 1e-6, counts exact;
* the twin end to end on the CPU (rainbow:16, 2 epochs): its export
  loads in JAX `load_dalle_checkpoint` (logits 1e-4, its Adam count 8)
  and in the port's `engine_from_checkpoint`;
* the cadences of JAX `tests/test_training.py:187-258` (throughput meter,
  profiler hook) with the same fake clock and steps, equal to JAX's;
* the windows of `steps_per_dispatch`: `window_iter` and `stack_batches`
  equal to JAX's, and `make_multi_step` running its batches in turn,
  each with its key, to their mean metrics;
* the trainer's up-front refusals (a scan-layout export of a model the
  JAX scan executor does not run, a RevNet with dropout, `--taming`
  without the VQGAN's paths), and the runs it takes: a RevNet trained
  in both layer orders and a scan-layout run, whose exports load in the
  JAX package (logits 1e-4, Adam count) and, for the scan run, resume
  through `--dalle_path`;
* FLOPs a sample equal to JAX's in every mode; MFU only on an H100;
* the `precompute_tokens` twin's artifact equal to the JAX CLI's on the
  same dataset and dVAE (tokens identical at gaps above 2e-5, asserted
  to be all of them here).
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from dalle_pytorch_tpu.models.dalle import DALLE as JDALLE
from dalle_pytorch_tpu.models.dvae import DiscreteVAE as JDVAE
from dalle_pytorch_tpu.training import config as jconfig
from dalle_pytorch_tpu.training import metrics as jmetrics
from dalle_pytorch_tpu.training import pipeline as jpipeline
from dalle_pytorch_tpu.training import steps as jsteps
from dalle_pytorch_tpu.utils import flops as jflops
from dalle_pytorch_tpu_torch import precompute_tokens, train_dalle
from dalle_pytorch_tpu_torch.data import tokenizer as port_tokenizer
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
from dalle_pytorch_tpu_torch.serving.engine import engine_from_checkpoint
from dalle_pytorch_tpu_torch.training import metrics as pmetrics
from dalle_pytorch_tpu_torch.training.pipeline import (
    dalle_config,
    dalle_from_config,
    load_dalle_checkpoint,
    restore_opt_state,
    save_dalle_checkpoint,
    save_vae_checkpoint,
)
from dalle_pytorch_tpu_torch.training.steps import (
    MODES,
    get_learning_rate,
    make_dalle_train_step,
    make_multi_step,
    make_optimizer,
    stack_batches,
    window_iter,
    window_keys,
)
from dalle_pytorch_tpu_torch.utils import flops as pflops
from dalle_pytorch_tpu_torch.weights import (
    export_dalle_opt_state,
    export_dalle_params,
    load_dalle_params,
    load_dvae_params,
)

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


def _jax_params(seed=0):
    params = JDALLE(**TINY, attn_impl="dense").init(
        jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32), jnp.zeros((1, 16), jnp.int32)
    )["params"]
    return jax.tree.map(np.asarray, params)


def _vae_pair(seed=3):
    jv = JDVAE(**TINY_VAE)
    params = jax.jit(jv.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    return jv, params, load_dvae_params(DiscreteVAE(**TINY_VAE), params).eval()


def _text(seed, b=4):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, TINY["num_text_tokens"], (b, 8)).astype(np.int32)
    text[:, 5:] = 0
    return text


def _tokens(seed, b=4):
    return np.random.RandomState(seed + 100).randint(0, 32, (b, 16)).astype(np.int32)


def _capture_grads():
    """An optax transformation whose new state is the gradient it got."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


def _jax_grads(params, batch):
    """The JAX step's gradient (dense attention: the optimizer state is
    what these tests hold)."""
    model = JDALLE(**TINY, attn_impl="dense")
    state = train_state.TrainState.create(apply_fn=None, params=params, tx=_capture_grads())
    step = jsteps.make_dalle_train_step(model)
    new_state, _ = jax.jit(step)(state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(1))
    return jax.tree.map(np.asarray, new_state.opt_state)


def _grad_model(grads):
    """Port parameters holding `grads` (a reference-layout tree)."""
    return load_dalle_params(DALLE(**TINY, attn_impl="flash"), grads)


def _apply_same_gradient(model, opt, state, grads):
    """One update with `grads` in both packages."""
    state = state.apply_gradients(grads=jax.tree.map(jnp.asarray, grads))
    for p, g in zip(model.parameters(), _grad_model(grads).parameters()):
        p.grad = g.detach().clone()
    opt.step()
    return state


def _assert_same_state(model, opt, state):
    ours, ref = _flat(export_dalle_params(model)), _flat(state.params)
    for path, leaf in ref.items():
        np.testing.assert_allclose(ours[path], leaf, atol=1e-6, rtol=0, err_msg=path)
    leaves = export_dalle_opt_state(model, opt)
    ref_leaves = jax.tree_util.tree_leaves(state.opt_state)
    assert len(leaves) == len(ref_leaves)
    assert int(leaves[0]) == int(ref_leaves[0]) and int(leaves[2]) == int(ref_leaves[2])
    assert float(leaves[1]) == float(ref_leaves[1])
    for a, b in zip(leaves[3:], ref_leaves[3:]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)


def _jax_cfg():
    cfg = jconfig.TrainConfig()
    for k in ("dim", "depth", "heads", "dim_head", "text_seq_len"):
        setattr(cfg.model, k, TINY[k])
    cfg.bf16 = False
    return cfg


def test_reference_adam_state_resumes_in_the_port(tmp_path):
    params = _jax_params(seed=2)
    jmodel = JDALLE(**TINY, attn_impl="dense")  # the state transfer is what is held here
    state = train_state.TrainState.create(apply_fn=None, params=params,
                                          tx=jsteps.make_optimizer(1e-3, clip_grad_norm=0.5))
    jstep = jax.jit(jsteps.make_dalle_train_step(jmodel))
    for i in range(2):
        batch = {"text": jnp.asarray(_text(i)), "image_tokens": jnp.asarray(_tokens(i))}
        state, _ = jstep(state, batch, jax.random.PRNGKey(i))
    path = tmp_path / "jax_dalle.npz"
    jpipeline.save_dalle_checkpoint(str(path), _jax_cfg(), state.params, None, 1, "DiscreteVAE",
                                    opt_state=state.opt_state, train_meta={"global_step": 2})

    config, tree, vae_tree, meta, leaves = load_dalle_checkpoint(str(path))
    assert vae_tree is None and meta["train"]["global_step"] == 2 and len(leaves) > 3
    model = load_dalle_params(DALLE(**TINY, attn_impl="flash"), tree)
    opt = make_optimizer(model.parameters(), 5e-2, clip_grad_norm=0.5)
    assert restore_opt_state(model, opt, leaves)
    assert get_learning_rate(opt) == float(np.float32(1e-3))
    _assert_same_state(model, opt, state)

    grads = _jax_grads(jax.tree.map(np.asarray, state.params),
                       {"text": _text(5), "image_tokens": _tokens(5)})
    state = _apply_same_gradient(model, opt, state, grads)
    _assert_same_state(model, opt, state)


def test_port_adam_state_resumes_in_the_reference(tmp_path, capsys):
    params = _jax_params(seed=3)
    model = load_dalle_params(DALLE(**TINY, attn_impl="flash"), params)
    opt = make_optimizer(model.parameters(), 1e-3, clip_grad_norm=0.5)
    step = make_dalle_train_step(model, opt, autocast_dtype=None)
    for i in range(2):
        step({"text": torch.from_numpy(_text(i)), "image_tokens": torch.from_numpy(_tokens(i))})
    leaves = export_dalle_opt_state(model, opt)
    path = tmp_path / "port_dalle.npz"
    save_dalle_checkpoint(str(path), dalle_config(model, bf16=False), model, opt_state=leaves,
                          train_meta={"global_step": 2})

    cfg, jparams, _, meta, jleaves = jpipeline.load_dalle_checkpoint(str(path))
    fresh = train_state.TrainState.create(
        apply_fn=None, params=jparams, tx=jsteps.make_optimizer(3e-4, clip_grad_norm=0.5))
    capsys.readouterr()
    restored = jpipeline.restore_opt_state(fresh.opt_state, jleaves)
    assert "WARNING" not in capsys.readouterr().out
    for a, b in zip(jax.tree_util.tree_leaves(restored), leaves):
        assert np.array_equal(np.asarray(a), b)
    state = fresh.replace(opt_state=restored)
    _assert_same_state(model, opt, state)

    grads = _jax_grads(jax.tree.map(np.asarray, jparams),
                       {"text": _text(6), "image_tokens": _tokens(6)})
    state = _apply_same_gradient(model, opt, state, grads)
    _assert_same_state(model, opt, state)


def test_mismatched_adam_state_is_refused_as_the_reference_refuses(capsys):
    model = load_dalle_params(DALLE(**TINY, attn_impl="flash"), _jax_params(seed=4))
    opt = make_optimizer(model.parameters(), 1e-3)
    leaves = export_dalle_opt_state(model, opt)
    assert not restore_opt_state(model, opt, leaves[:-1])
    assert "WARNING" in capsys.readouterr().out and not opt.adam.state


# ---------------------------------------------------------------- the twin


def _byte_default_vocabulary(monkeypatch):
    """The default vocabulary unavailable: the byte tokenizer (257 ids)
    is the default, a small text embedding for these runs."""
    monkeypatch.setattr(port_tokenizer, "default_vocabularies", lambda: [])
    monkeypatch.setattr(port_tokenizer, "_default_decision", None)
    monkeypatch.setattr(port_tokenizer, "_warned_default_probe", True)


def _vae_file(tmp_path, seed=0):
    torch.manual_seed(seed)
    path = tmp_path / "vae.npz"
    save_vae_checkpoint(str(path), DiscreteVAE(**TINY_VAE))
    return path


def trainer_args(out_dir, vae_path, *extra):
    return [
        "--device", "cpu", "--image_text_folder", "rainbow:16", "--vae_path", str(vae_path),
        "--batch_size", "4",
        "--set", "model.dim=64", "--set", "model.depth=2", "--set", "model.heads=4",
        "--set", "model.dim_head=16", "--set", "model.text_seq_len=8",
        "--set", "model.attn_impl=flash", "--set", "bf16=false",
        "--set", f"output_dir={out_dir}", *extra,
    ]


def test_trainer_export_loads_in_the_reference_and_the_engine(tmp_path, monkeypatch, capsys):
    _byte_default_vocabulary(monkeypatch)
    vae_path = _vae_file(tmp_path)
    summary = train_dalle.main(trainer_args(
        tmp_path / "run", vae_path, "--epochs", "2", "--exp", "ff", "--set", "lr_decay=true",
        "--set", "save_every_n_steps=3", "--set", "log_images_freq=5",
    ))
    assert summary["global_step"] == 8 and summary["losses"] == []
    assert (tmp_path / "run" / "logs" / "image_5.png").exists()
    assert sorted(p.name for p in (tmp_path / "run" / "dalle_ckpt").iterdir()) == [
        "step_00000003.npz", "step_00000006.npz"]

    cfg, jparams, jvae, meta, leaves = jpipeline.load_dalle_checkpoint(summary["out_file"])
    assert meta["epoch"] == 2 and meta["train"]["global_step"] == 8 and jvae is not None
    assert cfg.mode == "forward_forward" and meta["train"]["plateau"] is not None
    fresh = train_state.TrainState.create(
        apply_fn=None, params=jparams,
        tx=jsteps.make_optimizer(cfg.learning_rate, clip_grad_norm=cfg.clip_grad_norm))
    capsys.readouterr()
    restored = jpipeline.restore_opt_state(fresh.opt_state, leaves)
    assert "WARNING" not in capsys.readouterr().out and int(restored.count) == 8

    vocab = jparams["text_emb"]["embedding"].shape[0] - 8
    jmodel = jpipeline.dalle_from_config(cfg, num_image_tokens=32, image_fmap_size=4, vocab_size=vocab)
    config, tree, _, _, _ = load_dalle_checkpoint(summary["out_file"])
    model, _ = dalle_from_config(config, 32, 4, vocab)
    load_dalle_params(model, tree)
    text, img = _text(7, b=2) % vocab, _tokens(7, b=2)
    ref = jmodel.apply({"params": jparams}, jnp.asarray(text), jnp.asarray(img))
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(text), torch.from_numpy(img))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-4, rtol=0)

    engine = engine_from_checkpoint(summary["out_file"], batch_shapes=(1,), device="cpu")
    for a, b in zip(engine.model.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name, extra, error", [
    ("ga_steps", ["--set", "ga_steps=3"], (ValueError, "ga_steps=3 must divide")),
    # dp, fsdp, tp, sp (the ring) and pp train over processes (tests/test_torch_launch.py,
    # test_torch_parallel_train.py, test_torch_ring.py, test_torch_tp_pp_train.py); refused:
    # fsdp with the revnet, the JAX trainer's pp checks (the scan executor first), and a
    # mesh the run's processes do not fill
    ("fsdp", ["--set", "mesh.fsdp=2", "--set", "model.reversible=true",
              "--set", "model.reversible_impl=revnet"], (NotImplementedError, "item 8")),
    ("dp", ["--set", "mesh.dp=2"], (ValueError, r"mesh 2x1x1x1x1 != 1 processes")),
    ("pp", ["--set", "mesh.pp=2"], (ValueError, "mesh.pp > 1 requires model.executor=scan")),
    ("ring", ["--set", "model.attn_impl=ring", "--set", "mesh.sp=2"],
     (ValueError, r"1 processes not divisible by fsdp\*tp\*sp\*pp=2")),
    ("tp", ["--set", "mesh.tp=2"], (ValueError, r"1 processes not divisible by fsdp\*tp\*sp\*pp=2")),
    ("scan", ["--set", "model.executor=scan", "--set", "model.shared_attn_ids=0,0"],
     (ValueError, 'executor="scan" does not support cross-layer weight sharing')),
    ("revnet", ["--set", "model.reversible=true", "--set", "model.reversible_impl=revnet",
                "--set", "model.ff_dropout=0.1"], (ValueError, "no dropout")),
    ("taming", ["--taming"], (ValueError, "vqgan_model_path")),
])
def test_trainer_refuses_up_front(tmp_path, monkeypatch, name, extra, error):
    def never(*a, **k):
        raise AssertionError("a model was built before the check")

    monkeypatch.setattr(train_dalle, "dalle_from_config", never)
    vae_path = _vae_file(tmp_path)
    args = trainer_args(tmp_path / "run", vae_path, *extra)
    if name == "taming":
        args[args.index("--vae_path") + 1] = ""
    kind, match = error
    with pytest.raises(kind, match=match):
        train_dalle.main(args)


@pytest.mark.parametrize("name", ["scan", "revnet"])
def test_trainer_runs_scan_and_revnet_models(tmp_path, monkeypatch, capsys, name):
    _byte_default_vocabulary(monkeypatch)
    vae_path = _vae_file(tmp_path)
    extra = {
        "scan": ["--set", "model.executor=scan", "--set", "model.shift_tokens=true",
                 "--set", "model.rotary_emb=true"],
        "revnet": ["--set", "model.reversible=true", "--set", "model.reversible_impl=revnet",
                   "--exp", "r", "--set", "model.shift_tokens=true"],
    }[name]
    args = trainer_args(tmp_path / "run", vae_path, "--epochs", "1",
                        "--image_text_folder", "rainbow:8", *extra)
    summary = train_dalle.main(args)
    assert summary["global_step"] == 2 and np.isfinite(summary["last_loss"])

    cfg, jparams, _, meta, leaves = jpipeline.load_dalle_checkpoint(summary["out_file"])
    assert ("scan_stack" in jparams["transformer"]) == (name == "scan")
    fresh = train_state.TrainState.create(
        apply_fn=None, params=jparams,
        tx=jsteps.make_optimizer(cfg.learning_rate, clip_grad_norm=cfg.clip_grad_norm))
    capsys.readouterr()
    restored = jpipeline.restore_opt_state(fresh.opt_state, leaves)
    assert "WARNING" not in capsys.readouterr().out and int(restored.count) == 2
    vocab = jparams["text_emb"]["embedding"].shape[0] - 8
    jmodel = jpipeline.dalle_from_config(cfg, num_image_tokens=32, image_fmap_size=4, vocab_size=vocab)
    config, tree, _, _, _ = load_dalle_checkpoint(summary["out_file"])
    model, _ = dalle_from_config(config, 32, 4, vocab)
    load_dalle_params(model, tree)
    text, img = _text(8, b=2) % vocab, _tokens(8, b=2)
    for reverse_model in (False, True):
        ref = jmodel.apply({"params": jparams}, jnp.asarray(text), jnp.asarray(img),
                           reverse_model=reverse_model)
        with torch.no_grad():
            logits = model.eval()(torch.from_numpy(text), torch.from_numpy(img),
                                  reverse_model=reverse_model)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-4, rtol=0)

    if name == "scan":  # the scan export resumes, with its Adam state
        again = train_dalle.main(trainer_args(
            tmp_path / "run2", vae_path, "--epochs", "2", "--image_text_folder", "rainbow:8",
            "--dalle_path", summary["out_file"]))
        assert again["global_step"] == 4
        _, _, _, meta, leaves = load_dalle_checkpoint(again["out_file"])
        assert int(leaves[2]) == 4 and meta["config"]["model"]["executor"] == "scan"


def test_trainer_needs_a_card_unless_told_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = trainer_args(tmp_path / "run", _vae_file(tmp_path))
    args[args.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        train_dalle.main(args)


# ---------------------------------------------------------------- cadences


def _fake_time(monkeypatch, module, t):
    monkeypatch.setattr(module, "time", types.SimpleNamespace(time=lambda: t[0]))


def test_throughput_meter_fires_on_crossings_as_the_reference(monkeypatch):
    t = [100.0]
    _fake_time(monkeypatch, jmetrics, t)
    _fake_time(monkeypatch, pmetrics, t)
    for steps in ([3, 6, 11, 14, 21, 23, 30, 33], list(range(1, 31))):
        ref, ours = jmetrics.ThroughputMeter(10), pmetrics.ThroughputMeter(10)
        fired = []
        for step in steps:
            t[0] += 0.5 + step % 3
            a, b = ref.update(step, 8), ours.update(step, 8)
            assert a == b
            fired += [step] if b is not None else []
        assert fired and all(s >= 10 for s in fired)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_windows_group_and_stack_as_the_reference(n):
    """Ten batches in windows of n: the same groups and tails as JAX's
    `window_iter`, and each full window stacked as JAX's `stack_batches`."""
    rng = np.random.RandomState(n)
    batches = [{"text": rng.randint(0, 9, (2, 3)), "images": rng.rand(2, 4, 4, 3)} for _ in range(10)]
    ours, ref = list(window_iter(iter(batches), n)), list(jsteps.window_iter(iter(batches), n))
    assert [len(w) for w in ours] == [len(w) for w in ref] == [n] * (10 // n) + [10 % n] * bool(10 % n)
    for win, jwin in zip(ours, ref):
        assert all(a is b for a, b in zip(win, jwin))
        if len(win) == n:
            got, want = stack_batches(win), jsteps.stack_batches(jwin)
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k].shape == (n, *batches[0][k].shape) and np.array_equal(got[k], want[k])


def test_multi_step_runs_its_batches_in_turn_with_their_keys():
    """A window's steps see its batches and keys in order; the window
    reports their mean metrics; a window of another length is refused."""
    seen = []

    def step(batch, key):
        seen.append((batch["x"], key))
        return {"loss": torch.tensor(float(batch["x"])), "n": torch.tensor(1.0)}

    multi = make_multi_step(step, 3)
    keys = window_keys(7, 12, 3)
    metrics = multi([{"x": 1}, {"x": 2}, {"x": 6}], keys)
    assert seen == [(1, keys[0]), (2, keys[1]), (6, keys[2])] and len(set(keys)) == 3
    assert metrics["loss"].item() == 3.0 and metrics["n"].item() == 1.0
    assert window_keys(7, 13, 2) == keys[1:]
    with pytest.raises(ValueError, match="3 steps"):
        multi([{"x": 1}], keys[:1])


def test_profiler_hook_traces_the_first_step_at_or_after_its_step(monkeypatch, tmp_path):
    """A window stride steps over profile_step: the hook traces the first
    dispatch at or after it, then says stop, once (JAX's cadence)."""
    calls = []

    class FakeProfile:
        def __init__(self, activities):
            calls.append("init")

        def __enter__(self):
            calls.append("start")

        def __exit__(self, *exc):
            calls.append("stop")

        def export_chrome_trace(self, path):
            calls.append(("export", path))

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    hook = pmetrics.ProfilerHook(True, profile_step=200, out_dir=str(tmp_path / "p"))
    hook.before_step(198)
    assert not calls and hook.after_step(201) is False
    hook.before_step(201)
    assert calls == ["init", "start"]
    assert hook.after_step(204) is True
    assert calls[2:] == ["stop", ("export", str(tmp_path / "p" / "trace_step_204.json"))]
    hook.before_step(204)
    assert len(calls) == 4
    off = pmetrics.ProfilerHook(False, profile_step=0)
    off.before_step(5)
    assert off.after_step(5) is False and len(calls) == 4


# ---------------------------------------------------------------- FLOPs


@pytest.mark.parametrize("mode", MODES)
def test_flops_per_sample_match_the_reference(mode):
    cfg = dict(TINY, num_text_tokens=300)
    jmodel = JDALLE(**cfg)
    model = DALLE(**cfg)
    assert pflops.dalle_train_flops_per_sample(model, mode) == jflops.dalle_train_flops_per_sample(
        jmodel, mode)
    assert pflops.transformer_train_flops(1024, 12, 16, 64, 1280, vocab=40000) == (
        jflops.transformer_train_flops(1024, 12, 16, 64, 1280, vocab=40000))


def test_mfu_only_against_an_h100_peak():
    assert pflops.mfu(10.0, 1e12, "cpu") is None
    assert pflops.mfu(10.0, 1e12, "NVIDIA A100-SXM4-80GB") is None
    assert pflops.mfu(10.0, 1e12, "NVIDIA H100 80GB HBM3") == pytest.approx(1e13 / 989e12)
    assert pflops.mfu(10.0, 1e12, "NVIDIA H100 PCIe") == pytest.approx(1e13 / 756e12)
    assert pflops.mfu(10.0, 1e12, "NVIDIA H100 NVL", 2) == pytest.approx(1e13 / (2 * 835e12))


# ---------------------------------------------------------------- precompute


def test_precompute_tokens_artifact_equals_the_reference(tmp_path, monkeypatch):
    jv, vparams, vae = _vae_pair(seed=8)
    vae_path = tmp_path / "vae.npz"
    save_vae_checkpoint(str(vae_path), vae)
    ours = tmp_path / "ours.npz"
    tokens = precompute_tokens.main([
        "--image_text_folder", "rainbow:10", "--vae_path", str(vae_path), "--batch_size", "4",
        "--output", str(ours), "--device", "cpu",
    ])
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "jax_precompute_tokens", Path(__file__).resolve().parent.parent / "precompute_tokens.py")
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    theirs = tmp_path / "theirs.npz"
    monkeypatch.setattr(sys, "argv", [
        "precompute_tokens.py", "--image_text_folder", "rainbow:10", "--vae_path", str(vae_path),
        "--batch_size", "4", "--output", str(theirs)])
    jcli.main()

    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            if key != "image_tokens":
                assert np.array_equal(a[key], b[key]), key
        assert a["image_tokens"].dtype == b["image_tokens"].dtype == np.int32
        assert np.array_equal(a["image_tokens"], tokens)
        from dalle_pytorch_tpu_torch.data.rainbow import RainbowDataset

        images = np.stack([RainbowDataset(num_samples=10, image_size=32).image(i) for i in range(10)])
        with torch.no_grad():
            logits = vae.encode_logits(torch.from_numpy(images)).numpy().reshape(10, 16, -1)
        top2 = np.sort(logits, axis=-1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0]).min() > GAP
        assert np.array_equal(a["image_tokens"], b["image_tokens"])
