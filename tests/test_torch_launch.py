"""The launcher twin (`dalle_pytorch_tpu_torch/launch.py`) and the trainer
launched by it over two processes.

The JAX `tests/test_launch.py` cases for the twin: the rendezvous
variables (the JAX launcher's and torch's), one child a GPU with its
global rank host_id * nproc_per_host + local rank, SLURM defaults and
hostname parsing, requeue then success, no requeue on a real failure,
SIGTERM forwarded and requeued; a failing child stops its siblings; and
`initialize_distributed` does nothing at one process.

Then `python -m dalle_pytorch_tpu_torch.launch --nproc_per_host 2 --
-m dalle_pytorch_tpu_torch.train_dalle --device cpu ... --set
mesh.fsdp=2` on a tiny model (dim 64, depth 2, rainbow:16, 2 rows a rank,
step checkpoints at 2 and 4): its export loads in the JAX package
(`load_dalle_checkpoint`, Adam count 4) and in the port; the same run at
world 1 (4 rows, one process) ends within 1e-5 / rtol 1e-4 of it; and the
fsdp = 2 step checkpoint at step 2, resumed at world 1 (`--resume`),
reaches the fsdp = 2 run's step 4 within the same tolerance.
"""

import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
ENV_KEYS = ("DALLE_TPU_COORDINATOR", "DALLE_TPU_NUM_PROCS", "DALLE_TPU_PROC_ID", "MASTER_ADDR",
            "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
PROBE = "import os; print(' '.join(os.environ[k] for k in {keys!r}), flush=True)\n".format(keys=ENV_KEYS)
# several children: each writes its own file (their prints would interleave)
RANK_PROBE = ("import os, pathlib, sys; pathlib.Path(sys.argv[1], 'env_' + os.environ['RANK']).write_text("
              "' '.join(os.environ[k] for k in {keys!r}))\n").format(keys=ENV_KEYS)


def _rank_lines(tmp_path):
    return sorted(p.read_text().split() for p in tmp_path.glob("env_*"))


def run_launch(*args, env_extra=None, timeout=60):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "dalle_pytorch_tpu_torch.launch", *args],
        capture_output=True, text=True, env=env, timeout=timeout, cwd=REPO,
    )


def test_env_wiring(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(PROBE)
    r = run_launch("--coordinator", "10.0.0.1:1234", "--num-hosts", "4", "--host-id", "2",
                   "--nproc_per_host", "1", "--", str(probe))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["10.0.0.1:1234", "4", "2", "10.0.0.1", "1234", "2", "4", "0", "1"]


def test_one_child_a_gpu_with_global_ranks(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(RANK_PROBE)
    r = run_launch("--coordinator", "10.0.0.1:1234", "--num-hosts", "2", "--host-id", "1",
                   "--nproc_per_host", "3", "--", str(probe), str(tmp_path))
    assert r.returncode == 0, r.stderr
    lines = _rank_lines(tmp_path)
    assert [(l[2], l[5], l[6], l[7], l[8]) for l in lines] == [
        ("3", "3", "6", "0", "3"), ("4", "4", "6", "1", "3"), ("5", "5", "6", "2", "3")]


def test_one_host_takes_a_free_local_port(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(RANK_PROBE)
    r = run_launch("--nproc_per_host", "2", "--", str(probe), str(tmp_path), env_extra={"SLURM_PROCID": ""})
    assert r.returncode == 0, r.stderr
    a, b = _rank_lines(tmp_path)
    assert a[0] == b[0] and a[0].startswith("127.0.0.1:") and int(a[4]) > 0
    assert (a[1], a[2], b[2]) == ("2", "0", "1")


def test_slurm_defaults(monkeypatch):
    from dalle_pytorch_tpu_torch.launch import slurm_defaults

    for k in ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_NODELIST", "SLURM_STEP_NODELIST"):
        monkeypatch.delenv(k, raising=False)
    assert slurm_defaults() == {}
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_NODELIST", "node[1-4]")
    d = slurm_defaults()
    assert d["host_id"] == 3 and d["num_hosts"] == 4
    assert d["coordinator"] == "node1:12345"


def test_slurm_hostname_parsing():
    from dalle_pytorch_tpu_torch.launch import first_slurm_host

    assert first_slurm_host("node[1-4]") == "node1"
    assert first_slurm_host("gpu-node-[01-04]") == "gpu-node-01"
    assert first_slurm_host("gpu-node-[01,07]") == "gpu-node-01"
    assert first_slurm_host("hosta,hostb") == "hosta"
    assert first_slurm_host("single-host") == "single-host"
    assert first_slurm_host("") == ""


def test_requeue_then_success(tmp_path):
    """The first run exits 143 (preemption-style); the requeue reruns it
    and the second run succeeds."""
    marker = tmp_path / "marker"
    script = tmp_path / "flaky.py"
    script.write_text(
        "import pathlib, sys\n"
        f"m = pathlib.Path({str(marker)!r})\n"
        "if not m.exists():\n"
        "    m.write_text('x'); sys.exit(143)\n"
        "print('recovered'); sys.exit(0)\n"
    )
    r = run_launch("--nproc_per_host", "1", "--requeue", "--", str(script))
    assert r.returncode == 0
    assert "recovered" in r.stdout
    assert "requeue 1/" in r.stderr


def test_no_requeue_on_real_failure(tmp_path):
    script = tmp_path / "bad.py"
    script.write_text("import sys; sys.exit(7)\n")
    r = run_launch("--nproc_per_host", "1", "--requeue", "--", str(script))
    assert r.returncode == 7


def test_a_failing_child_stops_the_others(tmp_path):
    script = tmp_path / "one_fails.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['LOCAL_RANK'] == '1':\n"
        "    sys.exit(5)\n"
        "time.sleep(60)\n"
    )
    t0 = time.monotonic()
    r = run_launch("--nproc_per_host", "2", "--", str(script))
    assert r.returncode == 5
    assert time.monotonic() - t0 < 30


def test_sigterm_forwarded_and_requeued(tmp_path):
    """Preemption signals the launcher: it survives, forwards the signal
    to its children and requeues."""
    marker = tmp_path / "marker"
    script = tmp_path / "slow.py"
    script.write_text(
        "import pathlib, time, sys\n"
        f"m = pathlib.Path({str(marker)!r})\n"
        "if m.exists():\n"
        "    print('recovered', flush=True); sys.exit(0)\n"
        "m.write_text('x')\n"
        "print('ready', flush=True)\n"
        "time.sleep(30)\n"
    )
    proc = subprocess.Popen(
        [sys.executable, "-m", "dalle_pytorch_tpu_torch.launch", "--nproc_per_host", "1", "--requeue",
         "--", str(script)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    deadline = time.time() + 30
    while time.time() < deadline and not marker.exists():
        time.sleep(0.1)
    assert marker.exists()
    time.sleep(0.5)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, (out, err)
    assert "recovered" in out
    assert "requeue 1/" in err


def test_single_process_init_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    from dalle_pytorch_tpu_torch.parallel.mesh import initialize_distributed, is_root, make_train_mesh

    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is None
    assert not dist.is_initialized() and is_root()
    mesh = make_train_mesh()
    assert mesh.world == 1 and mesh.data_world == 1 and mesh.group("dp", "fsdp") is None


# --------------------------------------------------------------- the trainer

TRAINER = [
    "--device", "cpu", "--image_text_folder", "rainbow:16", "--epochs", "1",
    "--set", "model.dim=64", "--set", "model.depth=2", "--set", "model.heads=4",
    "--set", "model.dim_head=16", "--set", "model.text_seq_len=8", "--set", "model.attn_impl=flash",
    "--set", "bf16=false", "--set", "native=true",
    "--set", "bpe_path=dalle_pytorch_tpu_torch/data/default_bpe_8k.model",
    "--set", "save_every_n_steps=2", "--set", "log_images_freq=3",
]


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _assert_close(path_a, path_b):
    from dalle_pytorch_tpu_torch.training.checkpoint import load_params_npz

    a, _ = load_params_npz(str(path_a))
    b, _ = load_params_npz(str(path_b))
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k, want in fb.items():
        if want.dtype.kind == "f":
            np.testing.assert_allclose(fa[k], want, rtol=1e-4, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(fa[k], want, err_msg=k)


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    import torch

    from dalle_pytorch_tpu_torch.models.dvae import DiscreteVAE
    from dalle_pytorch_tpu_torch.training.pipeline import save_vae_checkpoint

    tmp = tmp_path_factory.mktemp("launch_train")
    torch.manual_seed(0)
    save_vae_checkpoint(str(tmp / "vae.npz"), DiscreteVAE(image_size=32, num_layers=3, num_tokens=32,
                                                           codebook_dim=16, hidden_dim=8))
    r = run_launch("--nproc_per_host", "2", "--", "-m", "dalle_pytorch_tpu_torch.train_dalle", *TRAINER,
                   "--vae_path", str(tmp / "vae.npz"), "--batch_size", "2", "--set", "mesh.fsdp=2",
                   "--set", f"output_dir={tmp / 'fsdp'}", env_extra={"OMP_NUM_THREADS": "1"}, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "backend gloo" in r.stdout and "mesh {'dp': 1, 'fsdp': 2" in r.stdout
    return tmp


def test_fsdp_export_loads_in_both_packages(fsdp_run):
    from dalle_pytorch_tpu.training.pipeline import load_dalle_checkpoint as jax_load
    from dalle_pytorch_tpu_torch.training.pipeline import load_dalle_checkpoint

    path = fsdp_run / "fsdp" / "dalle.npz"
    config, params, vae, meta, leaves = jax_load(str(path))
    assert config.mesh.fsdp == 2 and meta["epoch"] == 1
    assert int(leaves[2]) == 4  # the Adam count: 4 steps of 2 rows x 2 ranks
    qkv = [v.shape for k, v in _flat(params).items() if k.endswith("to_qkv/kernel")]
    assert qkv == [(64, 192)] * 2  # full tensors, not fsdp pieces
    config, params, _, _, leaves = load_dalle_checkpoint(str(path))
    assert int(leaves[2]) == 4 and all(np.isfinite(v).all() for v in _flat(params).values())
    assert (fsdp_run / "fsdp" / "logs" / "image_3.png").exists()  # rank 0 logged the sample


def test_fsdp_run_matches_one_process(fsdp_run):
    from dalle_pytorch_tpu_torch import train_dalle

    summary = train_dalle.main([*TRAINER, "--vae_path", str(fsdp_run / "vae.npz"), "--batch_size", "4",
                                "--set", f"output_dir={fsdp_run / 'one'}"])
    assert summary["global_step"] == 4 and summary["mesh"]["fsdp"] == 1
    _assert_close(fsdp_run / "fsdp" / "dalle.npz", fsdp_run / "one" / "dalle.npz")


def test_fsdp_step_checkpoint_resumes_at_world_one(fsdp_run):
    from dalle_pytorch_tpu_torch import train_dalle

    run = fsdp_run / "resumed"
    (run / "dalle_ckpt").mkdir(parents=True)
    shutil.copy(fsdp_run / "fsdp" / "dalle_ckpt" / "step_00000002.npz", run / "dalle_ckpt")
    summary = train_dalle.main([*TRAINER, "--vae_path", str(fsdp_run / "vae.npz"), "--batch_size", "4",
                                "--resume", "--set", f"output_dir={run}"])
    assert summary["resumed_step"] == 2 and summary["global_step"] == 4
    _assert_close(run / "dalle_ckpt" / "step_00000004.npz", fsdp_run / "fsdp" / "dalle_ckpt" / "step_00000004.npz")
