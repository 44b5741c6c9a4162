"""Multi-process launcher for GPU hosts (the port's twin of the
repository's `launch.py`), one process a GPU.

The JAX launcher runs one process a host, which drives every local
device. Here each host runs one child a GPU (`--nproc_per_host`, default
the visible GPU count, at least one), the PyTorch idiom; the rest is the
JAX launcher's: run the same command on every host, wire the rendezvous
(flags, else SLURM's variables), and requeue on preemption with
`--requeue` (a `--resume` run continues exactly).

Usage, on every host of the fleet (rank and count from SLURM when
present, else flags):

  python -m dalle_pytorch_tpu_torch.launch --coordinator 10.0.0.1:1234 \\
      --num-hosts 4 --host-id 0 -- -m dalle_pytorch_tpu_torch.train_dalle ...

  # one host, two GPUs (the coordinator is a free port on 127.0.0.1):
  python -m dalle_pytorch_tpu_torch.launch --nproc_per_host 2 -- \\
      -m dalle_pytorch_tpu_torch.train_dalle ... --set mesh.fsdp=2

  # SLURM (one task a host); requeue on preemption:
  srun python -m dalle_pytorch_tpu_torch.launch --requeue -- \\
      -m dalle_pytorch_tpu_torch.train_dalle ... --resume

Each child runs `python <command>` with DALLE_TPU_COORDINATOR /
DALLE_TPU_NUM_PROCS / DALLE_TPU_PROC_ID (the JAX launcher's variables,
here counting processes, not hosts) and torch's MASTER_ADDR / MASTER_PORT
/ RANK / WORLD_SIZE / LOCAL_RANK / LOCAL_WORLD_SIZE; the global rank is
host_id * nproc_per_host + the local rank. The trainers call
`parallel/mesh.py:initialize_distributed()`, which reads them. With
several children on a host with the CUDA toolkit, the port's kernels
are built here first, so the children load them instead of each running
nvcc. SIGTERM and SIGINT are forwarded to every child; when one child
fails the others are stopped, and the launcher exits with the first
failure's code.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

# exit codes that mean "the scheduler preempted us", worth a requeue
_PREEMPT_CODES = {-signal.SIGTERM, -signal.SIGINT, 143, 130}
#: seconds a child has to exit after SIGTERM before it is killed
STOP_GRACE_S = 10.0


def first_slurm_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist expression: plain lists ("a,b"),
    bracket ranges ("node[1-4]") and hyphenated names with ranges
    ("gpu-node-[01-04,07]")."""
    if not nodelist:
        return ""
    head = nodelist.split(",")[0] if "[" not in nodelist else nodelist
    if "[" in head:
        prefix, rest = head.split("[", 1)
        first_idx = rest.split(",")[0].split("-")[0].rstrip("]")
        return prefix + first_idx
    return head


def slurm_defaults() -> dict:
    """Rendezvous info from SLURM's variables (one task a host)."""
    env = os.environ
    if not env.get("SLURM_PROCID"):  # absent or empty (cleared)
        return {}
    nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
    first = first_slurm_host(nodelist)
    return {
        "host_id": int(env["SLURM_PROCID"]),
        "num_hosts": int(env.get("SLURM_NTASKS", "1")),
        "coordinator": f"{first}:12345" if first else None,
    }


def visible_gpus() -> int:
    """The GPUs this host's children may take (0 without torch's CUDA)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now (bound to 0, then released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(base: dict, coordinator: str, world: int, rank: int, local_rank: int, nproc: int) -> dict:
    """The environment of the child with global rank `rank`."""
    addr, _, port = coordinator.rpartition(":")
    env = dict(base)
    env.update(
        DALLE_TPU_COORDINATOR=coordinator, DALLE_TPU_NUM_PROCS=str(world), DALLE_TPU_PROC_ID=str(rank),
        MASTER_ADDR=addr, MASTER_PORT=port, RANK=str(rank), WORLD_SIZE=str(world),
        LOCAL_RANK=str(local_rank), LOCAL_WORLD_SIZE=str(nproc),
    )
    return env


def prebuild_kernels() -> None:
    """Build every kernel source of the checkout once, before the children
    start (each would otherwise run nvcc for the same sources); nothing
    on a host without the CUDA toolkit."""
    from dalle_pytorch_tpu_torch import kernels

    try:
        kernels.find_nvcc()
    except RuntimeError:
        return
    kernels.build(sorted(p.stem for p in kernels.CSRC.glob("*.cu")))


def _stop(procs, signum=signal.SIGTERM) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signum)
    deadline = time.monotonic() + STOP_GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (default on one host: a free port on 127.0.0.1)")
    ap.add_argument("--num-hosts", type=int, default=None)
    ap.add_argument("--host-id", type=int, default=None)
    ap.add_argument("--nproc_per_host", type=int, default=None,
                    help="children a host, one a GPU (default: the visible GPUs, at least 1)")
    ap.add_argument("--requeue", action="store_true",
                    help="relaunch the command after preemption-style exits (SIGTERM/SIGINT); "
                         "combine with --resume for exact continuation")
    ap.add_argument("--max-requeues", type=int, default=100)
    ap.add_argument("command", nargs=argparse.REMAINDER, help="-- script.py args... or -- -m module args...")
    args = ap.parse_args(argv)

    cmd = list(args.command)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given; usage: launch [flags] -- -m dalle_pytorch_tpu_torch.train_dalle ...")

    slurm = slurm_defaults()
    coordinator = args.coordinator or slurm.get("coordinator")
    num_hosts = args.num_hosts if args.num_hosts is not None else slurm.get("num_hosts", 1)
    host_id = args.host_id if args.host_id is not None else slurm.get("host_id", 0)
    nproc = args.nproc_per_host if args.nproc_per_host is not None else max(1, visible_gpus())
    world = num_hosts * nproc
    if nproc > 1:
        prebuild_kernels()

    # Schedulers preempt by signalling the whole process group; without a
    # handler the launcher would die alongside the children and the
    # requeue loop below would never run. Forward the signal, reap the
    # children, then decide to requeue.
    pending_sig = []
    children = []

    def forward(signum, frame):
        pending_sig.append(signum)
        for p in children:
            if p.poll() is None:
                p.send_signal(signum)

    old_handlers = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
    attempts = 0
    try:
        while True:
            pending_sig.clear()
            addr = coordinator or f"127.0.0.1:{free_port()}"
            children[:] = [
                subprocess.Popen([sys.executable, *cmd],
                                 env=child_env(os.environ, addr, world, host_id * nproc + i, i, nproc))
                for i in range(nproc)
            ]
            rc = None
            while rc is None:
                rcs = [p.poll() for p in children]
                failed = [r for r in rcs if r not in (None, 0)]
                if failed:
                    rc = failed[0]
                    _stop(children)  # the others would wait on it in a collective
                elif all(r == 0 for r in rcs):
                    rc = 0
                else:
                    time.sleep(0.05)
            if rc == 0:
                return 0
            preempted = rc in _PREEMPT_CODES or bool(pending_sig)
            if not args.requeue or not preempted:
                return rc
            attempts += 1
            if attempts > args.max_requeues:
                print(f"launch: giving up after {attempts - 1} requeues", file=sys.stderr)
                return rc
            print(f"launch: command exited {rc} (preemption-style); requeue {attempts}/{args.max_requeues}",
                  file=sys.stderr)
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)


if __name__ == "__main__":
    sys.exit(main())
