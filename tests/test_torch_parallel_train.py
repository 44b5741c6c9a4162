"""Data-parallel and fully sharded training steps over processes
(`parallel/fsdp.py`, `make_dalle_train_step(..., mesh=)`) against the
port's single-process step and the JAX package's step.

Four ranks over Gloo on the CPU, started by the launcher twin (this file
is their script: run as `python test_torch_parallel_train.py OUT`, it
imports no JAX): ranks 0-1 run dp = 2 and ranks 2-3 fsdp = 2 at the same
time, then all four dp = 2 x fsdp = 2, then ranks 0-1 fsdp = 2 on a model
whose parameters the DALLE reads outside their modules (text positions,
embeddings tied to the logits head, the fused loss) while ranks 2-3 run
fsdp = 2 on the remat executor (each layer recomputed in the backward),
then all four dp = 2 x sp = 2 with `attn_impl="ring"`; each group rendezvouses on its own
FileStore. A tiny DALLE (dim 64, depth 2, 4 heads of 16, 8 text + 16
image tokens, dense attention, float32), the same weights everywhere (an
export), the same global batch of 8 rows (each data rank takes its
`data_rank` block), forward_reverse_partial (the model runs twice a
step), null-conditioning 0.5, Adam 1e-3 with clipping at 0.5. Held:

* 2 steps against the single-process step on the global batch: losses
  rtol 1e-5, every parameter and Adam leaf rtol 1e-4 / atol 1e-5 (the JAX
  sharded-step test's, `tests/test_parallel.py:180-187`); the per-row
  null-conditioning draws are the one-device ones, or the losses would
  differ;
* the averaged gradient of one step (null-conditioning 0) against the JAX
  step's (captured as `test_torch_train.py` does), atol 1e-5 (that test's
  tolerance);
* each rank's Adam moments have its parameter's fsdp piece's shape, the
  piece of `fsdp_dims`' dimension, and the leaves the table keeps whole
  are whole.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from dalle_pytorch_tpu_torch.models.dalle import DALLE  # noqa: E402
from dalle_pytorch_tpu_torch.training.checkpoint import load_params_npz, save_params_npz  # noqa: E402
from dalle_pytorch_tpu_torch.training.steps import (  # noqa: E402
    accumulate_gradients,
    make_dalle_loss,
    make_dalle_train_step,
    make_optimizer,
)
from dalle_pytorch_tpu_torch.weights import (  # noqa: E402
    export_dalle_opt_state,
    export_dalle_params,
    load_dalle_params,
)

TINY = dict(dim=64, depth=2, heads=4, dim_head=16, num_image_tokens=32, image_fmap_size=4,
            num_text_tokens=50, text_seq_len=8, attn_impl="dense")
GLOBAL_B = 8
STEPS = 2
MODE = "forward_reverse_partial"
NULL_COND = 0.5
#: model variants: the parameters the DALLE reads outside their modules
#: (`DALLE.weights_read_outside_modules`), and the ring
VARIANTS = {"base": {}, "tied": dict(rotary_emb=False, share_input_output_emb=True, fused_ce=True),
            "remat": dict(reversible=True), "ring": dict(attn_impl="ring")}
#: name -> (mesh axes, the global ranks that run it, the model variant)
SCENARIOS = {
    "dp2": (dict(dp=2), (0, 1), "base"),
    "fsdp2": (dict(fsdp=2), (2, 3), "base"),
    "dp2xfsdp2": (dict(dp=2, fsdp=2), (0, 1, 2, 3), "base"),
    "fsdp2_tied": (dict(fsdp=2), (0, 1), "tied"),
    "fsdp2_remat": (dict(fsdp=2), (2, 3), "remat"),
    "dp2xsp2_ring": (dict(dp=2, sp=2), (0, 1, 2, 3), "ring"),
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


def _model(out, variant, sp_mesh=None):
    """The variant's DALLE with the run's weights (the ring over `sp_mesh`,
    a one-rank `TrainMesh` by default)."""
    from dalle_pytorch_tpu_torch.parallel.mesh import TrainMesh

    kw = {**TINY, **VARIANTS[variant]}
    if kw["attn_impl"] == "ring":
        kw["sp_mesh"] = sp_mesh or TrainMesh()
    model = DALLE(**kw)
    name = "tied" if variant == "tied" else "base"
    load_dalle_params(model, load_params_npz(str(out / f"weights_{name}.npz"))[0]["dalle"])
    return model


def _export_grads(model):
    """The model's .grad as a reference tree (through the weight mapping)."""
    from dalle_pytorch_tpu_torch.parallel.fsdp import gathered

    kept = [p.data for p in model.parameters()]
    for p in model.parameters():
        p.data = p.grad.detach().clone()
    with gathered(model):
        tree = export_dalle_params(model)
    for p, data in zip(model.parameters(), kept):
        p.data = data
    return tree


def _train(model, batches, mesh=None):
    """(losses, step) of STEPS steps; with a mesh on this data rank's rows."""
    opt = make_optimizer(model.parameters(), 1e-3, clip_grad_norm=0.5)
    step = make_dalle_train_step(model, opt, mode=MODE, null_cond_prob=NULL_COND, autocast_dtype=None,
                                 mesh=mesh)
    losses = []
    for i, batch in enumerate(batches):
        if mesh is not None:
            b = GLOBAL_B // mesh.data_world
            batch = {k: v[mesh.data_rank * b:(mesh.data_rank + 1) * b] for k, v in batch.items()}
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        losses.append(float(step(batch, torch.Generator().manual_seed(100 + i))["loss"]))
    return losses, opt, step


def _one_gradient(model, batch, mesh=None):
    """The averaged gradient of one step on `batch` (null-conditioning 0)."""
    loss_fn = make_dalle_loss(model, MODE, 0.0)
    if mesh is not None:
        b = GLOBAL_B // mesh.data_world
        batch = {k: v[mesh.data_rank * b:(mesh.data_rank + 1) * b] for k, v in batch.items()}
    accumulate_gradients(model, loss_fn, {k: torch.from_numpy(v) for k, v in batch.items()}, mesh=mesh)


def rank_main(out: Path) -> None:
    """One rank of the four: its 2-rank scenario, then the 4-rank one."""
    import torch.distributed as dist

    from dalle_pytorch_tpu_torch.parallel.fsdp import fsdp_of, gathered
    from dalle_pytorch_tpu_torch.parallel.mesh import initialize_distributed, make_train_mesh

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    batches = _batches()
    for name, (axes, ranks, variant) in SCENARIOS.items():
        if rank not in ranks:
            continue
        initialize_distributed(num_processes=len(ranks), process_id=ranks.index(rank),
                               init_method=f"file://{out / ('store_' + name)}", timeout_s=120)
        mesh = make_train_mesh(**axes)
        model = _model(out, variant, mesh)
        make_dalle_train_step(model, make_optimizer(model.parameters(), 1e-3), mesh=mesh)
        _one_gradient(model, batches[0], mesh)
        fsdp_of(model).reduce_gradients()
        grads = _export_grads(model)
        model = _model(out, variant, mesh)
        losses, opt, step = _train(model, batches, mesh)
        shapes = {n: [list(p.shape), list(opt.adam.state[p]["exp_avg"].shape),
                      list(opt.adam.state[p]["exp_avg_sq"].shape)] for n, p in model.named_parameters()}
        (out / f"{name}_rank{mesh.rank}.json").write_text(json.dumps(
            {"shapes": shapes, "losses": losses, "staged": dict(mesh.comm.staged)}))
        with gathered(model, opt):
            if mesh.rank == 0:
                save_params_npz(str(out / f"{name}.npz"), {
                    "dalle": export_dalle_params(model), "grads": grads,
                    "opt": {f"{i:04d}": leaf for i, leaf in enumerate(export_dalle_opt_state(model, opt))},
                })
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_train")
    for name in ("base", "tied"):
        torch.manual_seed(0)
        model = DALLE(**TINY, **VARIANTS[name])
        save_params_npz(str(out / f"weights_{name}.npz"), {"dalle": export_dalle_params(model)})
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "dalle_pytorch_tpu_torch.launch", "--nproc_per_host", "4", "--",
         str(Path(__file__).resolve()), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    # the single-process reference of each variant on the global batch
    single = {}
    for variant in VARIANTS:
        ref = _model(out, variant)
        losses, opt, _ = _train(ref, _batches())
        single[variant] = {"losses": losses, "dalle": _flat(export_dalle_params(ref)),
                           "opt": export_dalle_opt_state(ref, opt)}
    return out, single


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_steps_match_the_single_process_step(runs, name):
    out, single = runs
    single = single[SCENARIOS[name][2]]
    got = json.loads((out / f"{name}_rank0.json").read_text())
    np.testing.assert_allclose(got["losses"], single["losses"], rtol=1e-5)
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
    assert got["staged"] == {}  # CPU tensors: Gloo stages nothing


@pytest.fixture(scope="module")
def jax_gradient(runs):
    """gradient(variant) -> the JAX step's gradient (flat) on the first
    batch from the variant's weights, computed once a model config."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax.training import train_state

    from dalle_pytorch_tpu.models.dalle import DALLE as JDALLE
    from dalle_pytorch_tpu.training.steps import make_dalle_train_step as jax_train_step

    out, _ = runs
    done = {}

    def gradient(variant):
        # the ring on one device is dense attention: the reference's dense arm
        cfg = {k: v for k, v in {**TINY, **VARIANTS[variant]}.items() if k != "attn_impl"}
        key = tuple(sorted(cfg.items()))
        if key not in done:
            weights = out / f"weights_{'tied' if variant == 'tied' else 'base'}.npz"
            params = jax.tree.map(jnp.asarray, load_params_npz(str(weights))[0]["dalle"])
            capture = optax.GradientTransformation(
                lambda p: jax.tree.map(jnp.zeros_like, p),
                lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g),
            )
            state = train_state.TrainState.create(apply_fn=None, params=params, tx=capture)
            step = jax_train_step(JDALLE(**cfg, attn_impl="dense"), mode=MODE)
            batch = {k: jnp.asarray(v, jnp.int32) for k, v in _batches()[0].items()}
            new_state, _ = jax.jit(step)(state, batch, jax.random.PRNGKey(1))
            done[key] = _flat(jax.tree.map(np.asarray, new_state.opt_state))
        return done[key]

    return gradient


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_gradient_matches_the_jax_step(runs, jax_gradient, name):
    out, _ = runs
    want = jax_gradient(SCENARIOS[name][2])
    got = _flat(load_params_npz(str(out / f"{name}.npz"))[0]["grads"])
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=1e-5, rtol=0, err_msg=path)


@pytest.mark.parametrize("name", ["fsdp2", "dp2xfsdp2", "fsdp2_tied", "fsdp2_remat"])
def test_adam_state_is_the_parameters_fsdp_piece(runs, name):
    from dalle_pytorch_tpu_torch.parallel.mesh import TrainMesh
    from dalle_pytorch_tpu_torch.parallel.partition import fsdp_dims

    out, _ = runs
    axes, ranks, variant = SCENARIOS[name]
    fsdp = axes["fsdp"]
    model = DALLE(**TINY, **VARIANTS[variant])
    full = {n: list(p.shape) for n, p in model.named_parameters()}
    dims = fsdp_dims(model, TrainMesh(**axes))
    assert dims["transformer.attn.0.to_qkv.weight"] == 1 and dims["transformer.ff.0.dense_1.weight"] == 0
    assert dims["text_emb.weight"] == 1
    assert dims.get("logits_dense.bias", dims.get("logits_bias")) is None
    if variant == "tied":
        assert dims["text_pos_emb.weight"] == 1
    for r in range(len(ranks)):
        shapes = json.loads((out / f"{name}_rank{r}.json").read_text())["shapes"]
        for n, (param, mu, nu) in shapes.items():
            want = list(full[n])
            if dims[n] is not None:
                want[dims[n]] //= fsdp
            assert param == mu == nu == want, (r, n)


if __name__ == "__main__":
    rank_main(Path(sys.argv[1]))
