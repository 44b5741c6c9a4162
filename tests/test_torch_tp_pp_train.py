"""Tensor- and pipeline-parallel training steps over processes
(`parallel/tensor_parallel.py:TrainingShards`, `parallel/gpipe.py`,
`make_dalle_train_step(..., mesh=, pp_micro=)`) against the port's
single-process step and the JAX package's step, and the GPipe schedule
against the JAX `gpipe_apply`.

Four ranks over Gloo on the CPU, started by the launcher twin (this file
is their script: run as `python test_torch_tp_pp_train.py OUT`, it
imports no JAX), each scenario on its own FileStore: ranks 0-1 tp = 2
while ranks 2-3 pp = 2 in 2 microbatches; all four dp = 2 x tp = 2, then
fsdp = 2 x tp = 2; ranks 0-1 pp = 2 in 4 microbatches while ranks 2-3 tp
= 2 on a model whose head is tied to the embeddings and takes the fused
loss (the head's weights gathered over tp), then pp = 2 on the remat
executor (each layer recomputed in a stage's backward); all four tp = 2
x sp = 2 with `attn_impl="ring"` (the ring runs over each tp rank's
heads). Then the trainer twin itself: `train_dalle.main` at `mesh.tp=2`
on ranks 0-1 while ranks 2-3 run `mesh.pp=2` (`model.executor=scan`,
`--exp ff`, `mesh.pp_micro=2`), then on all four at `mesh.dp=2
mesh.tp=2` and at `mesh.fsdp=2 mesh.tp=2` (2 rows a data rank). The
tiny DALLE of `test_torch_parallel_train.py` (dim 64, depth 2, 4 heads of
16, 8 text + 16 image tokens, dense attention, float32), the same weights
everywhere, the same global batch of 8 rows, null-conditioning 0.5, Adam
1e-3 with clipping at 0.5; tp runs forward_reverse_partial, pp
forward_forward (pp refuses the reversed order). Held:

* 2 steps against the single-process step on the global batch: losses
  rtol 1e-5, every parameter and Adam leaf rtol 1e-4 / atol 1e-5
  (`tests/test_parallel.py:180-187`'s tolerances);
* the first averaged gradient (null-conditioning 0) against the JAX
  step's, atol 1e-5;
* each rank's parameters and Adam moments have the shapes `tp_dims`
  (then `fsdp_dims`) give;
* the trainer's exports load in the JAX package with whole tensors and
  their mesh in the config, and match the one-process run of 4 rows a
  step; the tp and pp exports resume in one process (`--dalle_path`) as
  the one-process run's export resumes.

In-process: the port's schedule (`gpipe_apply` over P stages, each a
thread with its own parameters and an in-memory pipe) against the JAX
`gpipe_apply` on `tests/test_gpipe.py`'s residual MLP on the 8-device
virtual CPU mesh, forward and gradients, at pp 2 and 4 and M 1, 2 and 4
(with a key-mask-like side input riding the schedule); and the trainer's
refusals (`check_pipeline`, tp with the revnet executor).
"""

import json
import os
import queue
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from dalle_pytorch_tpu_torch.models.dalle import DALLE  # noqa: E402
from dalle_pytorch_tpu_torch.training.checkpoint import load_params_npz, save_params_npz  # noqa: E402
from dalle_pytorch_tpu_torch.training.steps import make_dalle_train_step, make_optimizer  # noqa: E402
from dalle_pytorch_tpu_torch.weights import (  # noqa: E402
    export_dalle_opt_state,
    export_dalle_params,
    load_dalle_params,
)

TINY = dict(dim=64, depth=2, heads=4, dim_head=16, num_image_tokens=32, image_fmap_size=4,
            num_text_tokens=50, text_seq_len=8, attn_impl="dense")
GLOBAL_B = 8
STEPS = 2
NULL_COND = 0.5
FRP, FF = "forward_reverse_partial", "forward_forward"
VARIANTS = {"base": {}, "tied": dict(rotary_emb=False, share_input_output_emb=True, fused_ce=True),
            "ring": dict(attn_impl="ring"), "remat": dict(reversible=True)}
#: name -> (mesh axes, the global ranks that run it, the model variant,
#: the objective, pp microbatches)
SCENARIOS = {
    "tp2": (dict(tp=2), (0, 1), "base", FRP, 1),
    "pp2_m2": (dict(pp=2), (2, 3), "base", FF, 2),
    "dp2xtp2": (dict(dp=2, tp=2), (0, 1, 2, 3), "base", FRP, 1),
    "fsdp2xtp2": (dict(fsdp=2, tp=2), (0, 1, 2, 3), "base", FRP, 1),
    "pp2_m4": (dict(pp=2), (0, 1), "base", FF, 4),
    "tp2_tied": (dict(tp=2), (2, 3), "tied", FRP, 1),
    "pp2_remat": (dict(pp=2), (2, 3), "remat", FF, 2),
    "tp2xsp2_ring": (dict(tp=2, sp=2), (0, 1, 2, 3), "ring", FRP, 1),
}
#: the trainer twin's runs: name -> (the global ranks, its flags)
TRAINER = [
    "--device", "cpu", "--image_text_folder", "rainbow:8", "--epochs", "1", "--batch_size", "4",
    "--set", "model.dim=64", "--set", "model.depth=2", "--set", "model.heads=4",
    "--set", "model.dim_head=16", "--set", "model.text_seq_len=8", "--set", "model.attn_impl=dense",
    "--set", "bf16=false", "--set", "native=true",
    "--set", "bpe_path=dalle_pytorch_tpu_torch/data/default_bpe_8k.model",
    "--set", "save_every_n_steps=0", "--set", "log_images_freq=0",
]
TP_RUN, PP_RUN = ["--exp", "r"], ["--exp", "ff", "--set", "model.executor=scan"]
#: name -> (the global ranks, the run's objective flags, its mesh flags);
#: a data rank of dp x tp or fsdp x tp takes 2 of the 4 rows a step
CLI = {
    "cli_tp2": ((0, 1), TP_RUN, ["--set", "mesh.tp=2"]),
    "cli_pp2": ((2, 3), PP_RUN, ["--set", "mesh.pp=2", "--set", "mesh.pp_micro=2"]),
    "cli_dp2xtp2": ((0, 1, 2, 3), TP_RUN, ["--batch_size", "2", "--set", "mesh.dp=2", "--set", "mesh.tp=2"]),
    "cli_fsdp2xtp2": ((0, 1, 2, 3), TP_RUN, ["--batch_size", "2", "--set", "mesh.fsdp=2", "--set", "mesh.tp=2"]),
}


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _batches():
    rng = np.random.RandomState(7)
    out = []
    for _ in range(STEPS):
        text = rng.randint(1, TINY["num_text_tokens"], (GLOBAL_B, TINY["text_seq_len"])).astype(np.int64)
        text[:, 5:] = 0
        img = rng.randint(0, TINY["num_image_tokens"], (GLOBAL_B, 16)).astype(np.int64)
        out.append({"text": text, "image_tokens": img})
    return out


def _model(out, variant, mesh=None):
    """The variant's DALLE with the run's weights (the ring over `mesh`, a
    one-rank `TrainMesh` by default: dense attention)."""
    from dalle_pytorch_tpu_torch.parallel.mesh import TrainMesh

    kw = {**TINY, **VARIANTS[variant]}
    if kw["attn_impl"] == "ring":
        kw["sp_mesh"] = mesh or TrainMesh()
    model = DALLE(**kw)
    weights = "tied" if variant == "tied" else "base"
    load_dalle_params(model, load_params_npz(str(out / f"weights_{weights}.npz"))[0]["dalle"])
    return model


def _local(batch, mesh):
    if mesh is None:
        return {k: torch.from_numpy(v) for k, v in batch.items()}
    b = GLOBAL_B // mesh.data_world
    return {k: torch.from_numpy(v[mesh.data_rank * b:(mesh.data_rank + 1) * b]) for k, v in batch.items()}


def _export_grads(model):
    """The model's .grad as a reference tree (whole tensors, through the
    weight mapping)."""
    from dalle_pytorch_tpu_torch.parallel.fsdp import gathered

    kept = [p.data for p in model.parameters()]
    for p in model.parameters():
        p.data = p.grad.detach().clone()
    with gathered(model):
        tree = export_dalle_params(model)
    for p, data in zip(model.parameters(), kept):
        p.data = data
    return tree


def _first_gradient(model, batch, mode, mesh=None, micro=1):
    """The averaged gradient of one step (null-conditioning 0), taken where
    the optimizer would clip it."""
    opt = make_optimizer(model.parameters(), 1e-3)
    step = make_dalle_train_step(model, opt, mode=mode, autocast_dtype=None, mesh=mesh, pp_micro=micro)
    store = {}
    opt.step = lambda grad_norm=None: store.setdefault("grads", _export_grads(model))
    step(_local(batch, mesh), torch.Generator().manual_seed(99))
    return store["grads"]


def _train(model, batches, mode, mesh=None, micro=1):
    """(losses, optimizer) of STEPS steps; with a mesh on this data rank's rows."""
    opt = make_optimizer(model.parameters(), 1e-3, clip_grad_norm=0.5)
    step = make_dalle_train_step(model, opt, mode=mode, null_cond_prob=NULL_COND, autocast_dtype=None,
                                 mesh=mesh, pp_micro=micro)
    losses = [float(step(_local(b, mesh), torch.Generator().manual_seed(100 + i))["loss"])
              for i, b in enumerate(batches)]
    return losses, opt


def rank_main(out: Path) -> None:
    """One rank of the four: its scenarios in turn, then its trainer run."""
    import torch.distributed as dist

    from dalle_pytorch_tpu_torch import train_dalle
    from dalle_pytorch_tpu_torch.parallel.fsdp import gathered
    from dalle_pytorch_tpu_torch.parallel.mesh import initialize_distributed, make_train_mesh

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    batches = _batches()

    def join(name, ranks):
        initialize_distributed(num_processes=len(ranks), process_id=ranks.index(rank),
                               init_method=f"file://{out / ('store_' + name)}", timeout_s=120)

    for name, (axes, ranks, variant, mode, micro) in SCENARIOS.items():
        if rank not in ranks:
            continue
        join(name, ranks)
        mesh = make_train_mesh(**axes)
        grads = _first_gradient(_model(out, variant, mesh), batches[0], mode, mesh, micro)
        model = _model(out, variant, mesh)
        losses, opt = _train(model, batches, mode, mesh, micro)
        shapes = {n: [list(p.shape), list(opt.adam.state[p]["exp_avg"].shape),
                      list(opt.adam.state[p]["exp_avg_sq"].shape)] for n, p in model.named_parameters()}
        (out / f"{name}_rank{mesh.rank}.json").write_text(json.dumps(
            {"shapes": shapes, "losses": losses, "staged": dict(mesh.comm.staged),
             "calls": dict(mesh.comm.calls)}))
        with gathered(model, opt):
            if mesh.rank == 0:
                save_params_npz(str(out / f"{name}.npz"), {
                    "dalle": export_dalle_params(model), "grads": grads,
                    "opt": {f"{i:04d}": leaf for i, leaf in enumerate(export_dalle_opt_state(model, opt))},
                })
        dist.destroy_process_group()
    for name, (ranks, run, mesh_flags) in CLI.items():
        if rank not in ranks:
            continue
        join(name, ranks)
        summary = train_dalle.main([*TRAINER, "--vae_path", str(out / "vae.npz"), *run, *mesh_flags,
                                    "--set", f"output_dir={out / name}"])
        (out / f"{name}_rank{summary['rank']}.json").write_text(json.dumps(
            {k: summary[k] for k in ("mesh", "global_step", "step_losses", "staged_calls", "collective_calls")}))
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
    from dalle_pytorch_tpu_torch.training.pipeline import save_vae_checkpoint

    out = tmp_path_factory.mktemp("tp_pp_train")
    for name in ("base", "tied"):
        torch.manual_seed(0)
        save_params_npz(str(out / f"weights_{name}.npz"),
                        {"dalle": export_dalle_params(DALLE(**TINY, **VARIANTS[name]))})
    torch.manual_seed(0)
    save_vae_checkpoint(str(out / "vae.npz"), DiscreteVAE(image_size=32, num_layers=3, num_tokens=32,
                                                          codebook_dim=16, hidden_dim=8))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "dalle_pytorch_tpu_torch.launch", "--nproc_per_host", "4", "--",
         str(Path(__file__).resolve()), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    single = {}
    for variant, mode in {("base", FRP), ("base", FF), ("tied", FRP), ("ring", FRP), ("remat", FF)}:
        ref = _model(out, variant)
        losses, opt = _train(ref, _batches(), mode)
        single[variant, mode] = {"losses": losses, "dalle": _flat(export_dalle_params(ref)),
                                 "opt": export_dalle_opt_state(ref, opt)}
    return out, single


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_parallel_steps_match_the_single_process_step(runs, name):
    out, single = runs
    axes, ranks, variant, mode, _ = SCENARIOS[name]
    single = single[variant, mode]
    got = [json.loads((out / f"{name}_rank{r}.json").read_text()) for r in range(len(ranks))]
    for g in got:
        np.testing.assert_allclose(g["losses"], single["losses"], rtol=1e-5)
    tree, _ = load_params_npz(str(out / f"{name}.npz"))
    params = _flat(tree["dalle"])
    assert sorted(params) == sorted(single["dalle"])
    for path, want in single["dalle"].items():
        np.testing.assert_allclose(params[path], want, rtol=1e-4, atol=1e-5, err_msg=path)
    opt = [tree["opt"][k] for k in sorted(tree["opt"])]
    assert len(opt) == len(single["opt"])
    assert int(opt[0]) == STEPS == int(single["opt"][0])
    for i, (a, b) in enumerate(zip(opt, single["opt"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=f"opt leaf {i}")
    assert got[0]["staged"] == {}  # CPU tensors: Gloo stages nothing
    if "pp" in axes:  # one hop a microbatch each way, two objectives a step (and the gradient's)
        micro = SCENARIOS[name][4]
        assert [g["calls"]["pipe_shift"] for g in got] == [2 * 2 * (STEPS + 1) * micro] * 2


@pytest.fixture(scope="module")
def jax_gradient(runs):
    """gradient(variant, mode) -> the JAX step's gradient (flat) on the
    first batch from the variant's weights."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax.training import train_state

    from dalle_pytorch_tpu.models.dalle import DALLE as JDALLE
    from dalle_pytorch_tpu.training.steps import make_dalle_train_step as jax_train_step

    out, _ = runs
    done = {}

    def gradient(variant, mode):
        if (variant, mode) not in done:
            # the ring on one device is dense attention: the reference's dense arm
            cfg = {**TINY, **VARIANTS[variant], "attn_impl": "dense"}
            weights = "tied" if variant == "tied" else "base"
            params = jax.tree.map(jnp.asarray, load_params_npz(str(out / f"weights_{weights}.npz"))[0]["dalle"])
            capture = optax.GradientTransformation(
                lambda p: jax.tree.map(jnp.zeros_like, p),
                lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g),
            )
            state = train_state.TrainState.create(apply_fn=None, params=params, tx=capture)
            step = jax_train_step(JDALLE(**cfg), mode=mode)
            batch = {k: jnp.asarray(v, jnp.int32) for k, v in _batches()[0].items()}
            new_state, _ = jax.jit(step)(state, batch, jax.random.PRNGKey(1))
            done[variant, mode] = _flat(jax.tree.map(np.asarray, new_state.opt_state))
        return done[variant, mode]

    return gradient


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_parallel_gradient_matches_the_jax_step(runs, jax_gradient, name):
    out, _ = runs
    _, _, variant, mode, _ = SCENARIOS[name]
    want = jax_gradient(variant, mode)
    got = _flat(load_params_npz(str(out / f"{name}.npz"))[0]["grads"])
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=1e-5, rtol=0, err_msg=path)


@pytest.mark.parametrize("name", ["tp2", "dp2xtp2", "fsdp2xtp2", "tp2_tied", "tp2xsp2_ring", "pp2_m2"])
def test_each_rank_holds_its_shard(runs, name):
    from dalle_pytorch_tpu_torch.parallel.mesh import TrainMesh
    from dalle_pytorch_tpu_torch.parallel.partition import fsdp_dims, tp_dims

    out, _ = runs
    axes, ranks, variant, _, _ = SCENARIOS[name]
    model = DALLE(**{**TINY, **VARIANTS[variant]}, sp_mesh=TrainMesh())
    full = {n: list(p.shape) for n, p in model.named_parameters()}
    mesh = TrainMesh(**axes)
    t_dims, f_dims = tp_dims(model, mesh), fsdp_dims(model, mesh)
    if "tp" in axes:
        assert t_dims["transformer.attn.0.to_qkv.weight"] == 0 and t_dims["transformer.attn.0.to_out.weight"] == 1
        assert t_dims["transformer.ff.0.dense_0.bias"] == 0 and t_dims["transformer.ff.0.dense_1.bias"] is None
        assert t_dims["text_emb.weight"] == 0 and t_dims["transformer.attn_norms.0.weight"] is None
    for r in range(len(ranks)):
        shapes = json.loads((out / f"{name}_rank{r}.json").read_text())["shapes"]
        for n, (param, mu, nu) in shapes.items():
            want = list(full[n])
            if t_dims[n] is not None:
                want[t_dims[n]] //= axes.get("tp", 1)
            if f_dims[n] is not None and axes.get("fsdp", 1) > 1:
                want[f_dims[n]] //= axes["fsdp"]
            assert param == mu == nu == want, (r, n)


# ------------------------------------------------------------ the trainer


def _cli_world1(out, name, *extra):
    """The trainer in this process on `name`'s objective flags, 4 rows a
    step."""
    from dalle_pytorch_tpu_torch import train_dalle

    return train_dalle.main([*TRAINER, "--vae_path", str(out / "vae.npz"), *CLI[name][1], *extra])


def _one_process(out, name) -> dict:
    """The one-process run of `name`'s objective (made once; its losses
    kept beside its export)."""
    one = out / ("one_" + CLI[name][1][1])
    if not (one / "summary.json").exists():
        summary = _cli_world1(out, name, "--set", f"output_dir={one}")
        (one / "summary.json").write_text(json.dumps({"step_losses": summary["step_losses"]}))
    return {"dir": one, **json.loads((one / "summary.json").read_text())}


def _assert_close(a, b, skip=()):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k, want in fb.items():
        if any(k.startswith(s) for s in skip):
            continue
        if want.dtype.kind == "f":
            np.testing.assert_allclose(fa[k], want, rtol=1e-4, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(fa[k], want, err_msg=k)


@pytest.mark.parametrize("name", list(CLI))
def test_trainer_export_loads_in_jax_and_matches_one_process(runs, name):
    from dalle_pytorch_tpu.training.pipeline import load_dalle_checkpoint as jax_load

    out, _ = runs
    path = out / name / "dalle.npz"
    config, params, _, meta, leaves = jax_load(str(path))
    assert meta["epoch"] == 1 and int(leaves[2]) == 2  # 8 rows, 4 a step: 2 steps
    flat = _flat(params)
    qkv = [v.shape for k, v in flat.items() if k.endswith("to_qkv/kernel")]
    mesh = {f.split("=")[0][5:]: int(f.split("=")[1]) for f in CLI[name][2] if f.startswith("mesh.")}
    assert {k: getattr(config.mesh, k) for k in mesh} == mesh
    if name == "cli_pp2":
        assert config.model.executor == "scan"
        assert qkv == [(2, 64, 192)]  # the scan layout, whole tensors
    else:
        assert qkv == [(64, 192)] * 2  # whole tensors, not tp shards or fsdp pieces
    got = [json.loads((out / f"{name}_rank{r}.json").read_text()) for r in range(len(CLI[name][0]))]
    assert all(g["step_losses"] == got[0]["step_losses"] and g["global_step"] == 2 for g in got)
    one = _one_process(out, name)
    np.testing.assert_allclose(got[0]["step_losses"], one["step_losses"], rtol=1e-5)
    a, _ = load_params_npz(str(path))
    b, _ = load_params_npz(str(one["dir"] / "dalle.npz"))
    _assert_close(a, b, skip=("config", "meta"))


@pytest.mark.parametrize("name", ["cli_tp2", "cli_pp2"])
def test_trainer_export_resumes_in_one_process(runs, name):
    out, _ = runs
    sources = (out / name, _one_process(out, name)["dir"])
    summaries = {}
    for src in sources:
        # the export's config carries its mesh: world 1 sets it back
        summaries[src] = _cli_world1(out, name, "--dalle_path", str(src / "dalle.npz"), "--epochs", "2",
                                     "--set", "mesh.tp=1", "--set", "mesh.pp=1",
                                     "--set", f"output_dir={src}_resumed")
        assert summaries[src]["global_step"] == 4
    sharded, one = sources
    np.testing.assert_allclose(summaries[sharded]["step_losses"], summaries[one]["step_losses"], rtol=1e-5)
    a, _ = load_params_npz(f"{sharded}_resumed/dalle.npz")
    b, _ = load_params_npz(f"{one}_resumed/dalle.npz")
    _assert_close(a, b, skip=("config", "meta"))


# ----------------------------------------------------- the GPipe schedule

DEPTH, DIM, BATCH, SEQ = 8, 16, 8, 4


class ThreadPipe:
    """A stage's pipe between threads of one process (`parallel/gpipe.py`'s
    pipe protocol): queues for the hops, a shared slot for `share`."""

    def __init__(self, stage, stages, links, board, barrier):
        self.stage, self.stages = stage, stages
        self.links, self.board, self.barrier = links, board, barrier
        self.hops = 0

    def shift(self, t, like, reverse=False):
        step = -1 if reverse else 1
        nxt, prev = self.stage + step, self.stage - step
        if t is not None and 0 <= nxt < self.stages:
            self.links[(self.stage, nxt)].put(t.detach().clone())
            self.hops += 1
        if like is not None and 0 <= prev < self.stages:
            return self.links[(prev, self.stage)].get(timeout=60)
        return None

    def share(self, t, like, stage):
        if self.stage == stage:
            self.board["value"] = t.detach().clone()
        self.barrier.wait(timeout=60)
        value = self.board["value"].clone()
        self.barrier.wait(timeout=60)
        return value


def _mlp_params():
    rng = np.random.RandomState(0)
    scale = 1.0 / np.sqrt(DIM)
    return ((rng.standard_normal((DEPTH, DIM, 2 * DIM)) * scale).astype(np.float32),
            (rng.standard_normal((DEPTH, 2 * DIM, DIM)) * scale).astype(np.float32))


def _run_stages(pp, n_micro, x, mask):
    """Each stage's (output, dL/dx, dL/dw1, dL/dw2) of the port's schedule,
    one thread a stage, loss = mean(out^2 * mask)."""
    from dalle_pytorch_tpu_torch.parallel.gpipe import gpipe_apply

    w1, w2 = _mlp_params()
    links = {(a, b): queue.Queue() for a in range(pp) for b in range(pp) if abs(a - b) == 1}
    board, barrier = {}, threading.Barrier(pp)
    results, errors = [None] * pp, []

    def stage(s):
        try:
            pipe = ThreadPipe(s, pp, links, board, barrier)
            p1, p2 = (torch.from_numpy(w).requires_grad_() for w in (w1, w2))
            xs = torch.from_numpy(x).requires_grad_()

            def layer(i, h, aux):
                return h + torch.tanh(h @ p1[i]) @ p2[i] * aux

            out = gpipe_apply(pipe, layer, DEPTH, xs, n_micro, aux=torch.from_numpy(mask),
                              layer_params=lambda i: (p1, p2))
            (out ** 2).mean().backward()
            results[s] = [t.detach().numpy() for t in (out, xs.grad, p1.grad, p2.grad)] + [pipe.hops]
        except Exception as exc:  # surfaced below
            errors.append(exc)
            barrier.abort()

    threads = [threading.Thread(target=stage, args=(s,)) for s in range(pp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    return results


@pytest.mark.parametrize("pp", [2, 4])
@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_schedule_matches_jax_gpipe(pp, n_micro):
    import jax
    import jax.numpy as jnp

    from dalle_pytorch_tpu.parallel.gpipe import gpipe_apply as jax_gpipe, make_pp_mesh

    rng = np.random.RandomState(1)
    x = rng.standard_normal((BATCH, SEQ, DIM)).astype(np.float32)
    mask = (rng.uniform(size=(BATCH, SEQ, 1)) > 0.3).astype(np.float32)  # a per-row side input
    w1, w2 = _mlp_params()
    mesh = make_pp_mesh(pp)

    def layer(lp, h, aux):
        return h + jnp.tanh(h @ lp["w1"]) @ lp["w2"] * aux

    def loss(params, x):
        out = jax_gpipe(mesh, params, layer, x, n_micro, aux=jnp.asarray(mask))
        return (out ** 2).mean(), out

    (_, want_out), (g_params, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}, jnp.asarray(x))
    results = _run_stages(pp, n_micro, x, mask)
    for out, dx, _, _, hops in results:
        np.testing.assert_allclose(out, np.asarray(want_out), atol=1e-5)
        np.testing.assert_allclose(dx, np.asarray(g_x), atol=1e-5)
    # each layer's gradient comes from its own stage: the sum over stages
    np.testing.assert_allclose(sum(r[2] for r in results), np.asarray(g_params["w1"]), atol=1e-5)
    np.testing.assert_allclose(sum(r[3] for r in results), np.asarray(g_params["w2"]), atol=1e-5)
    per = DEPTH // pp
    for s, r in enumerate(results):  # no stage gives a gradient to another's layers
        others = [i for i in range(DEPTH) if not s * per <= i < (s + 1) * per]
        assert not r[2][others].any() and not r[3][others].any()
    # one hop a microbatch forward (all but the last stage), one back (all but the first)
    assert [r[4] for r in results] == [n_micro * ((s < pp - 1) + (s > 0)) for s in range(pp)]


# ------------------------------------------------------------ refusals


def _cfg(**sets):
    from dalle_pytorch_tpu_torch.training.config import load_config

    return load_config(None, [f"{k}={v}" for k, v in sets.items()]).resolve()


@pytest.mark.parametrize("sets, match", [
    ({"mesh.pp": 2}, "requires model.executor=scan"),
    ({"mesh.pp": 2, "model.executor": "scan", "model.attn_dropout": 0.1}, "attn_dropout=ff_dropout=0"),
    ({"mesh.pp": 2, "model.executor": "scan", "model.ff_dropout": 0.1}, "attn_dropout=ff_dropout=0"),
    ({"mesh.pp": 2, "model.executor": "scan", "exp": "r"}, "cannot run forward_reverse_partial"),
    ({"mesh.pp": 2, "model.executor": "scan", "exp": "ff", "model.depth": 3}, "not divisible by mesh.pp=2"),
    ({"mesh.pp": 2, "model.executor": "scan", "exp": "ff", "model.depth": 2, "batch_size": 6,
      "mesh.pp_micro": 4}, "must divide the per-accum-step batch"),
    ({"mesh.pp": 2, "model.executor": "scan", "exp": "ff", "model.depth": 2, "batch_size": 4,
      "mesh.pp_micro": 2, "mesh.tp": 2}, "is a pure-pp mesh"),
    ({"mesh.pp": 2, "model.executor": "scan", "exp": "ff", "model.depth": 2, "batch_size": 4,
      "mesh.pp_micro": 2, "mesh.dp": 2}, "is a pure-pp mesh"),
])
def test_pipeline_refusals(sets, match):
    from dalle_pytorch_tpu_torch.train_dalle import check_config

    with pytest.raises(ValueError, match=match):
        check_config(_cfg(**sets))


def test_tp_refuses_the_revnet_executor():
    from dalle_pytorch_tpu_torch.parallel.mesh import TrainMesh
    from dalle_pytorch_tpu_torch.parallel.tensor_parallel import TrainingShards
    from dalle_pytorch_tpu_torch.train_dalle import check_config

    with pytest.raises(NotImplementedError, match="revnet executor.*ROADMAP Queue 1 item 8"):
        check_config(_cfg(**{"mesh.tp": 2, "model.reversible": "true", "model.reversible_impl": "revnet"}))
    check_config(_cfg(**{"mesh.tp": 2, "model.reversible": "true"}))  # remat trains under tp
    model = DALLE(**TINY, reversible=True, reversible_impl="revnet")
    with pytest.raises(ValueError, match="tp > 1 does not run the revnet executor"):
        TrainingShards(model, TrainMesh(tp=2))


def test_pipeline_trunk_refuses_dropout_and_reversed_order():
    from dalle_pytorch_tpu_torch.models.transformer import make_pipeline_trunk
    from dalle_pytorch_tpu_torch.parallel.mesh import TrainMesh

    with pytest.raises(ValueError, match="deterministic only"):
        make_pipeline_trunk(DALLE(**TINY, ff_dropout=0.1).transformer, TrainMesh(pp=2), 2)
    with pytest.raises(ValueError, match="cross-layer weight sharing"):
        make_pipeline_trunk(DALLE(**TINY, shared_attn_ids=(0, 0)).transformer, TrainMesh(pp=2), 2)
    model = DALLE(**TINY)
    with pytest.raises(ValueError, match="reversed layer order"):
        make_dalle_train_step(model, make_optimizer(model.parameters(), 1e-3), mode=FRP,
                              mesh=TrainMesh(pp=2), pp_micro=2)


if __name__ == "__main__":
    rank_main(Path(sys.argv[1]))
