"""Ring attention (`parallel/ring.py`) and `attn_impl="ring"` in the DALLE
against dense attention and the JAX package's ring.

Four ranks over Gloo on the CPU, started by the launcher twin (this file
is their script: run as `python test_torch_ring.py OUT`, it imports no
JAX): ranks 0-1 run the ring at sp = 2 while ranks 2-3 run the tiny ring
DALLE at sp = 2, then all four the ring at sp = 4. Held:

* `ring_attention_sharded` at sp = 2 and 4, causal and full (B 2, H 2,
  N 16, D 8, float32): the output and dq / dk / dv of a weighted sum
  against dense attention under autograd, rtol 2e-4 / atol 2e-5 (the JAX
  ring test's, `tests/test_parallel.py:130-140`), the same on every rank;
* the DALLE of `tests/test_parallel.py:TestRingInModel` (dim 32, depth 2,
  2 heads of 16, shift and rotary) with `attn_impl="ring"` at sp = 2
  against the JAX `DALLE(attn_impl="ring", sp_mesh=make_mesh(dp=1,
  sp=2))` on two of the virtual CPU devices, from the same weights: loss
  rtol 2e-5, every gradient rtol 2e-4 / atol 2e-5 (that test's), the
  gradients the same on both ranks;
* the four refusals of the JAX module (no sp_mesh, a static or key mask,
  `stable`, a length the sp axis does not divide) as ValueErrors, before
  any communication.
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

from dalle_pytorch_tpu_torch.models.attention import Attention  # noqa: E402
from dalle_pytorch_tpu_torch.models.dalle import DALLE  # noqa: E402
from dalle_pytorch_tpu_torch.parallel.mesh import TrainMesh  # noqa: E402
from dalle_pytorch_tpu_torch.training.checkpoint import load_params_npz, save_params_npz  # noqa: E402
from dalle_pytorch_tpu_torch.weights import export_dalle_params, load_dalle_params  # noqa: E402

SHAPE = (2, 2, 16, 8)  # B, H, N, D
MODEL = dict(dim=32, depth=2, heads=2, dim_head=16, num_image_tokens=32, image_fmap_size=4,
             num_text_tokens=30, text_seq_len=8, shift_tokens=True, rotary_emb=True)
#: name -> (sp, the global ranks that run it, what)
SCENARIOS = {"ring_sp2": (2, (0, 1), "ring"), "dalle_sp2": (2, (2, 3), "dalle"),
             "ring_sp4": (4, (0, 1, 2, 3), "ring")}


def _qkvw(seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def _dalle_inputs():
    text = np.random.RandomState(0).randint(1, 30, size=(2, 8)).astype(np.int64)
    toks = np.random.RandomState(1).randint(0, 32, size=(2, 16)).astype(np.int64)
    return torch.from_numpy(text), torch.from_numpy(toks)


def _ring_case(mesh, causal):
    """(out, dq, dk, dv) of the ring on the whole inputs of seed `causal`."""
    from dalle_pytorch_tpu_torch.parallel.ring import ring_attention_sharded

    q, k, v, w = (torch.from_numpy(a) for a in _qkvw(int(causal)))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = ring_attention_sharded(mesh, q, k, v, causal=causal)
    (out * w).sum().backward()
    return [t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)]


def rank_main(out: Path) -> None:
    import torch.distributed as dist

    from dalle_pytorch_tpu_torch.parallel.mesh import initialize_distributed, make_train_mesh

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    for name, (sp, ranks, what) in SCENARIOS.items():
        if rank not in ranks:
            continue
        initialize_distributed(num_processes=len(ranks), process_id=ranks.index(rank),
                               init_method=f"file://{out / ('store_' + name)}", timeout_s=120)
        mesh = make_train_mesh(dp=1, sp=sp)
        result = {}
        if what == "ring":
            for causal in (True, False):
                for label, arr in zip(("out", "dq", "dk", "dv"), _ring_case(mesh, causal)):
                    result[f"{label}_{int(causal)}"] = arr
        else:
            model = DALLE(**MODEL, attn_impl="ring", sp_mesh=mesh)
            load_dalle_params(model, load_params_npz(str(out / "dalle.npz"))[0]["dalle"])
            loss, _ = model(*_dalle_inputs(), return_loss=True)
            loss.backward()
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(p.grad)
            result = {"loss": np.asarray(float(loss)), "grads": export_dalle_params(model)}
        save_params_npz(str(out / f"{name}_rank{mesh.rank}.npz"), result)
        (out / f"{name}_rank{mesh.rank}.json").write_text(json.dumps(
            {"calls": dict(mesh.comm.calls), "staged": dict(mesh.comm.staged)}))
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    torch.manual_seed(0)
    save_params_npz(str(out / "dalle.npz"), {"dalle": export_dalle_params(DALLE(**MODEL, attn_impl="dense"))})
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "dalle_pytorch_tpu_torch.launch", "--nproc_per_host", "4", "--",
         str(Path(__file__).resolve()), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    return out


def _dense(causal):
    q, k, v, w = (torch.from_numpy(a).double() for a in _qkvw(int(causal)))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    s = q @ k.transpose(-1, -2) * SHAPE[-1] ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(SHAPE[2], SHAPE[2], dtype=torch.bool).tril(), float("-inf"))
    out = s.softmax(-1) @ v
    (out * w).sum().backward()
    return [t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("name", ["ring_sp2", "ring_sp4"])
def test_ring_matches_dense_attention_forward_and_backward(runs, name, causal):
    want = dict(zip(("out", "dq", "dk", "dv"), _dense(causal)))
    sp = SCENARIOS[name][0]
    for r in range(sp):
        got, _ = load_params_npz(str(runs / f"{name}_rank{r}.npz"))
        for label, w in want.items():
            np.testing.assert_allclose(got[f"{label}_{int(causal)}"], w, rtol=2e-4, atol=2e-5,
                                       err_msg=f"rank {r} {label}")
    counts = json.loads((runs / f"{name}_rank0.json").read_text())
    # causal and full: sp - 1 hops forward and sp hops backward each
    assert counts["calls"]["ring_shift"] == 2 * (2 * sp - 1)
    assert counts["staged"] == {}


def test_ring_dalle_matches_the_jax_ring_dalle(runs):
    import jax
    import jax.numpy as jnp

    from dalle_pytorch_tpu.models.dalle import DALLE as JDALLE
    from dalle_pytorch_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(dp=1, sp=2, devices=jax.devices()[:2])
    model = JDALLE(attn_impl="ring", sp_mesh=mesh, **MODEL)
    params = jax.tree.map(jnp.asarray, load_params_npz(str(runs / "dalle.npz"))[0]["dalle"])
    text, toks = (jnp.asarray(t.numpy(), jnp.int32) for t in _dalle_inputs())

    def loss(p):
        return model.apply({"params": p}, text, toks, return_loss=True)[0]

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss))(params)
    flat_want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
                 for path, leaf in jax.tree_util.tree_leaves_with_path(j_grads)}
    for r in range(2):
        got, _ = load_params_npz(str(runs / f"dalle_sp2_rank{r}.npz"))
        np.testing.assert_allclose(float(got["loss"]), float(j_loss), rtol=2e-5)
        flat_got = {}

        def walk(tree, prefix=""):
            for key, val in tree.items():
                if isinstance(val, dict):
                    walk(val, f"{prefix}{key}/")
                else:
                    flat_got[f"{prefix}{key}"] = np.asarray(val)

        walk(got["grads"])
        assert sorted(flat_got) == sorted(flat_want)
        for path, w in flat_want.items():
            np.testing.assert_allclose(flat_got[path], w, rtol=2e-4, atol=2e-5, err_msg=f"rank {r} {path}")


def _attention(**kw):
    return Attention(32, heads=2, dim_head=16, attn_impl="ring", **kw)


REFUSALS = {
    "no_mesh": (lambda: _attention(), None, 8, "needs sp_mesh"),
    "static_mask": (lambda: _attention(sp_mesh=TrainMesh(sp=2), static_mask=np.tril(np.ones((8, 8), bool))),
                    None, 8, "plain causal/full"),
    "key_mask": (lambda: _attention(sp_mesh=TrainMesh(sp=2)), torch.ones(1, 8, dtype=torch.bool), 8,
                 "plain causal/full"),
    "stable": (lambda: _attention(sp_mesh=TrainMesh(sp=2), stable=True), None, 8, "stable="),
    "length": (lambda: _attention(sp_mesh=TrainMesh(sp=2)), None, 7, "divisible by the sp axis"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_ring_refusals(case):
    make, key_mask, n, match = REFUSALS[case]
    x = torch.randn(1, n, 32)
    with pytest.raises(ValueError, match=match):
        make()(x, key_mask=key_mask)


if __name__ == "__main__":
    rank_main(Path(sys.argv[1]))
