"""The dVAE trainer twin over a data mesh of processes
(`dalle_pytorch_tpu_torch/train_vae.py`, `make_vae_train_step(..., mesh=)`)
against one process and against the JAX dVAE step.

Two ranks over Gloo on the CPU, started by the launcher twin (this file
is their script: run as `python test_torch_vae_mesh.py OUT`, it imports
no JAX), in one process group: `train_vae.main` at `mesh.dp=2`, then at
`mesh.fsdp=2`, each rank 2 rows of a global batch of 4 (rainbow:8, two
steps of a 16 px, 2-layer dVAE with 16 codes), each step's rows,
temperature and generator seed recorded (`recording`); then one step of
the step function alone at dp = 2 and at fsdp = 2, whose averaged
gradient and Adam moments are kept. The Gumbel noise is the step key's
draw for the global batch, sliced by rank. Held:

* the step's averaged gradient against one process on the same 4 rows,
  rtol 1e-4 / atol 1e-7, and against the JAX `make_vae_train_step`'s on
  the same dVAE, rows and noise (the JAX op's own draw replaced by the
  port's), atol 1e-5;
* each trainer run against one process replaying its global batches:
  the data ranks' rows (in rank order, the JAX `put_host_batch` order)
  stepped by `make_vae_train_step` in one process from the trainer's
  initial parameters, with each step's temperature and generator seed.
  A step's global rows are the one-process trainer's rows of that step
  (the interleaved shard of the JAX loader orders them differently, and
  the Gumbel noise follows a row's place, so the one-process trainer
  itself is not the reference); both steps' losses agree, rtol 1e-4, and
  so does the export's change over the run: the worst parameter's
  relative 2-norm ||mesh - one|| / ||one|| is at most UPDATE_RTOL. Adam's
  first update is about lr * sign(g) whatever the gradient's scale, so
  the change is held by its direction (readings at UPDATE_RTOL); the
  loss alone is a weak check (a rank drawing the wrong rows' noise moves
  it by 4.2e-4 relative on the CPU);
* under fsdp the conv kernels' and the codebook's Adam moments are
  pieces of `vae_fsdp_dims`' dimension, the biases whole;
* the trainer's refusal of tp, sp and pp above 1.
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

from dalle_pytorch_tpu_torch import train_vae  # noqa: E402

TINY = ["--set", "vae.image_size=16", "--set", "vae.num_layers=2", "--set", "vae.num_tokens=16",
        "--set", "vae.codebook_dim=8", "--set", "vae.hidden_dim=8", "--set", "native=true",
        "--set", "bpe_path=dalle_pytorch_tpu_torch/data/default_bpe_8k.model"]
MESHES = {"dp2": "mesh.dp=2", "fsdp2": "mesh.fsdp=2"}
#: the export's change over a trainer run against its one-process replay,
#: the worst parameter's relative 2-norm: a sound run reads 7.3e-7 on the
#: CPU; planted faults read 0.83 (no gradient all-reduce) and 0.90 (every
#: rank the first rows' Gumbel noise)
UPDATE_RTOL = 1e-2


def _args(out, name, rows, *extra):
    return ["--device", "cpu", "--image_folder", "rainbow:8", "--epochs", "1",
            "--batch_size", str(rows), "--output", str(out / f"{name}.npz"),
            "--set", f"output_dir={out / name}", *TINY, *extra]


class recording:
    """Inside the block `train_vae`'s step records in `store` the dVAE's
    initial parameters (`start`, the export's tree, before any split),
    its learning rate (`lr`) and each call's (this rank's images,
    temperature, generator seed) (`steps`)."""

    def __init__(self, store):
        self.store = store

    def __enter__(self):
        from dalle_pytorch_tpu_torch.training.steps import get_learning_rate
        from dalle_pytorch_tpu_torch.weights import export_dvae_params

        store, made = self.store, train_vae.make_vae_train_step
        self.made = made

        def making(vae, opt, *args, **kwargs):
            store.update(start=export_dvae_params(vae), lr=get_learning_rate(opt), steps=[])
            step = made(vae, opt, *args, **kwargs)

            def recorded(batch, temp, generator=None):
                store["steps"].append((batch["images"].cpu().numpy().copy(), float(temp),
                                       generator.initial_seed()))
                return step(batch, temp, generator)

            return recorded

        train_vae.make_vae_train_step = making
        return store

    def __exit__(self, *exc):
        train_vae.make_vae_train_step = self.made


def _save_recording(path, store):
    from dalle_pytorch_tpu_torch.training.checkpoint import save_params_npz

    images, temps, seeds = zip(*store["steps"])
    save_params_npz(str(path), {"start": store["start"], "images": np.stack(images)},
                    metadata={"lr": store["lr"], "temps": temps, "seeds": seeds})


def _load_recording(path):
    from dalle_pytorch_tpu_torch.training.checkpoint import load_params_npz

    tree, meta = load_params_npz(str(path))
    return {"start": tree["start"], "images": tree["images"], **meta}


def rank_main(out: Path) -> None:
    import torch.distributed as dist

    from dalle_pytorch_tpu_torch.parallel.mesh import initialize_distributed, make_train_mesh

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    initialize_distributed(num_processes=2, process_id=rank, init_method=f"file://{out / 'store'}",
                           timeout_s=120)
    for name, axis in MESHES.items():
        with recording({}) as store:
            summary = train_vae.main(_args(out, name, 2, "--set", axis))
        _save_recording(out / f"{name}_steps_rank{rank}.npz", store)
        (out / f"{name}_rank{rank}.json").write_text(json.dumps(
            {k: summary[k] for k in ("mesh", "global_step", "step_losses", "staged_calls")}))
    for name, axis in MESHES.items():
        k, v = axis.split("=")
        grads, opt, vae = _vae_step(make_train_mesh(**{k.split(".")[1]: int(v)}))
        if rank == 0:
            np.savez(out / f"{name}_grads.npz", **grads)
        (out / f"{name}_moments_rank{rank}.json").write_text(json.dumps(
            {n: [list(opt.adam.state[p][k].shape) for k in ("exp_avg", "exp_avg_sq")]
             for n, p in vae.named_parameters()}))
    dist.destroy_process_group()


def _vae():
    """The fresh seeded dVAE of `_vae_step`."""
    from dalle_pytorch_tpu_torch.training.config import load_config
    from dalle_pytorch_tpu_torch.training.pipeline import vae_from_config

    torch.manual_seed(0)
    return vae_from_config(load_config(None, [a for a in TINY if a != "--set"]).resolve().vae)


def _images():
    """`_vae_step`'s 4 seeded images [4, 16, 16, 3]."""
    return torch.rand((4, 16, 16, 3), generator=torch.Generator().manual_seed(3))


#: `_vae_step`'s generator seed: the Gumbel noise is its first draw
NOISE_SEED = 1


def _vae_step(mesh=None):
    """(the averaged gradient of one step, whole tensors; the optimizer;
    the dVAE) of `_vae()` on `_images()` (this data rank's rows with a
    mesh)."""
    from dalle_pytorch_tpu_torch.parallel.fsdp import fsdp_of
    from dalle_pytorch_tpu_torch.training.steps import make_optimizer, make_vae_train_step

    vae = _vae()
    opt = make_optimizer(vae.parameters(), 1e-3)
    step = make_vae_train_step(vae, opt, mesh=mesh)
    fsdp, stepping, grads = fsdp_of(vae), opt.step, {}

    def first(*a, **kw):
        for n, p in vae.named_parameters():
            grads[n] = (fsdp.full(p, p.grad) if fsdp is not None else p.grad).numpy().copy()
        return stepping(*a, **kw)

    opt.step = first
    images = _images()
    if mesh is not None:
        images = images[mesh.data_rank * 2:(mesh.data_rank + 1) * 2]
    step({"images": images}, 1.0, torch.Generator().manual_seed(NOISE_SEED))
    return grads, opt, vae


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("vae_mesh")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "dalle_pytorch_tpu_torch.launch", "--nproc_per_host", "2", "--",
         str(Path(__file__).resolve()), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    with recording({}) as one:
        train_vae.main(_args(out, "one", 4))
    return out, one


def _replay(rec):
    """(each step's loss, the export) of the recorded global batches
    stepped in one process: `rec[r]` is data rank r's recording."""
    from dalle_pytorch_tpu_torch.training.steps import make_optimizer, make_vae_train_step
    from dalle_pytorch_tpu_torch.weights import export_dvae_params, load_dvae_params

    vae = load_dvae_params(_vae(), rec[0]["start"])
    step = make_vae_train_step(vae, make_optimizer(vae.parameters(), rec[0]["lr"]))
    losses = []
    for k, (temp, seed) in enumerate(zip(rec[0]["temps"], rec[0]["seeds"])):
        images = torch.from_numpy(np.concatenate([r["images"][k] for r in rec]))
        losses.append(float(step({"images": images}, temp, torch.Generator().manual_seed(seed))["loss"]))
    return losses, _flat(export_dvae_params(vae))


def _rows(images):
    """A batch's rows as a sorted list of bytes (its rows, not their order)."""
    return sorted(row.tobytes() for row in images)


def _worst_change(got, want, start):
    """(name, ||got - want|| / ||want - start||) of the worst parameter."""
    rel = {k: float(np.linalg.norm(got[k] - w) / np.linalg.norm(w - start[k]))
           for k, w in want.items() if w.dtype.kind == "f" and np.any(w != start[k])}
    worst = max(rel, key=rel.get)
    return worst, rel[worst]


@pytest.mark.parametrize("name", list(MESHES))
def test_data_mesh_matches_one_process(runs, name):
    from dalle_pytorch_tpu_torch.training.checkpoint import load_params_npz

    out, one = runs
    got = [json.loads((out / f"{name}_rank{r}.json").read_text()) for r in range(2)]
    rec = [_load_recording(out / f"{name}_steps_rank{r}.npz") for r in range(2)]
    assert all(g["global_step"] == 2 for g in got) and len(one["steps"]) == 2
    assert got[0]["mesh"][name[:-1]] == 2 and got[0]["staged_calls"] == {}
    assert rec[0]["seeds"] == rec[1]["seeds"] == [s for _, _, s in one["steps"]]
    for k, (images, _, _) in enumerate(one["steps"]):
        assert _rows(np.concatenate([r["images"][k] for r in rec])) == _rows(images), k
    losses, want = _replay(rec)
    for g in got:
        np.testing.assert_allclose(g["step_losses"], losses, rtol=1e-4)
    start = _flat(rec[0]["start"])
    params = _flat(load_params_npz(str(out / f"{name}.npz"))[0])
    assert sorted(params) == sorted(want)
    worst, rel = _worst_change(params, want, start)
    assert rel <= UPDATE_RTOL, (worst, rel)


@pytest.mark.parametrize("name", list(MESHES))
def test_data_mesh_gradient_matches_one_process(runs, name):
    out, _ = runs
    want, _, _ = _vae_step()
    with np.load(out / f"{name}_grads.npz") as got:
        assert sorted(got.files) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def jax_gradient():
    """The JAX dVAE step's gradient (export names) on `_vae()`, `_images()`
    and the port's Gumbel noise, captured as the optimizer's input."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax.training import train_state

    from dalle_pytorch_tpu.models import dvae as jdvae
    from dalle_pytorch_tpu.training.steps import make_vae_train_step as jax_vae_step
    from dalle_pytorch_tpu_torch.ops.gumbel import gumbel_noise
    from dalle_pytorch_tpu_torch.training.pipeline import dvae_hparams
    from dalle_pytorch_tpu_torch.weights import export_dvae_params

    vae = _vae()
    h = vae.fmap_size
    noise = jnp.asarray(gumbel_noise((4, h, h, vae.num_tokens),
                                     torch.Generator().manual_seed(NOISE_SEED)).numpy())
    orig = jdvae.gumbel_softmax

    def ports_noise(rng, logits, **kw):
        # the JAX op on the port's draw: its own draw cancelled
        return orig(rng, logits + (noise - jax.random.gumbel(rng, logits.shape, logits.dtype)), **kw)

    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g),
    )
    params = jax.tree.map(jnp.asarray, export_dvae_params(vae))
    state = train_state.TrainState.create(apply_fn=None, params=params, tx=capture)
    jdvae.gumbel_softmax = ports_noise
    try:
        step = jax.jit(jax_vae_step(jdvae.DiscreteVAE(**dvae_hparams(vae))))
        new_state, _ = step(state, jnp.asarray(_images().numpy()), jax.random.PRNGKey(0),
                            jnp.float32(1.0))
    finally:
        jdvae.gumbel_softmax = orig
    return _flat(jax.tree.map(np.asarray, new_state.opt_state))


@pytest.mark.parametrize("name", list(MESHES))
def test_data_mesh_gradient_matches_the_jax_step(runs, jax_gradient, name):
    from dalle_pytorch_tpu_torch.weights import export_dvae_params

    out, _ = runs
    vae = _vae()
    with np.load(out / f"{name}_grads.npz") as got, torch.no_grad():
        for n, p in vae.named_parameters():
            p.copy_(torch.from_numpy(got[n]))
    got = _flat(export_dvae_params(vae))
    assert sorted(got) == sorted(jax_gradient)
    for k, w in jax_gradient.items():
        np.testing.assert_allclose(got[k], w, atol=1e-5, rtol=0, err_msg=k)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def test_conv_moments_are_fsdp_pieces(runs):
    from dalle_pytorch_tpu_torch.parallel.mesh import TrainMesh
    from dalle_pytorch_tpu_torch.parallel.partition import vae_fsdp_dims
    from dalle_pytorch_tpu_torch.training.config import load_config
    from dalle_pytorch_tpu_torch.training.pipeline import vae_from_config

    out, _ = runs
    vae = vae_from_config(load_config(None, [a for a in TINY if a != "--set"]).resolve().vae)
    dims = vae_fsdp_dims(vae, TrainMesh(fsdp=2))
    assert dims["enc_convs.0.weight"] == 0 and dims["dec_convs.0.weight"] == 1
    assert dims["codebook.weight"] == 1 and dims["enc_convs.0.bias"] is None
    assert dims["dec_head.weight"] is None  # 3 output channels: fsdp does not divide them
    for r in range(2):
        moments = json.loads((out / f"fsdp2_moments_rank{r}.json").read_text())
        for n, p in vae.named_parameters():
            want = list(p.shape)
            if dims[n] is not None:
                want[dims[n]] //= 2
            assert moments[n] == [want, want], (r, n)


@pytest.mark.parametrize("axis", ["tp", "sp", "pp"])
def test_the_dvae_refuses_the_model_axes(tmp_path, axis):
    with pytest.raises(ValueError, match=f"the dVAE has no {axis} split"):
        train_vae.main(_args(tmp_path, "refused", 4, "--set", f"mesh.{axis}=2"))


if __name__ == "__main__":
    rank_main(Path(sys.argv[1]))
