"""Which torch.distributed calls take CUDA tensors under each backend.

    python3 scripts/torch_collectives_probe.py

Starts two Gloo ranks on cuda:0 (a FileStore in a temporary directory)
and runs each call that `dalle_pytorch_tpu_torch/parallel/collectives.py`
makes (all-reduce, all-gather, reduce-scatter, broadcast, the ring's
`batch_isend_irecv`) once on a CUDA tensor and once on a CPU tensor,
checking the values; then the same calls in a one-rank NCCL group in this
process (the ring exchange as a send to itself). Prints one JSON line a
backend: {call: "ok" | the error}. Needs a card; about 30 s.
"""

from __future__ import annotations

import datetime
import json
import subprocess
import sys
import tempfile
from pathlib import Path

CALLS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast", "batch_isend_irecv")


def probe(dist, torch, device, rank: int, world: int) -> dict:
    """{call: "ok" | error} for each call on `device` tensors."""
    out = {}
    x = torch.arange(4, dtype=torch.float32, device=device) + rank

    def check(got, want):
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"got {got.tolist()}, want {want.tolist()}")

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        check(y, sum(torch.arange(4.0) + r for r in range(world)))

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        check(torch.cat(parts), torch.cat([torch.arange(4.0) + r for r in range(world)]))

    def reduce_scatter():
        y = torch.empty_like(x)
        dist.reduce_scatter(y, [x.clone() for _ in range(world)])
        check(y, world * (torch.arange(4.0)) + sum(range(world)))

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        check(y, torch.arange(4.0))

    def batch_isend_irecv():
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world), dist.P2POp(dist.irecv, y, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        check(y, torch.arange(4.0) + (rank - 1) % world)

    for name, fn in zip(CALLS, (all_reduce, all_gather, reduce_scatter, broadcast, batch_isend_irecv)):
        try:
            fn()
            if device != "cpu":
                torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as exc:  # the probe's purpose: record what refuses
            out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
    return out


def rank_main(rank: int, world: int, store: str) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    result = {"cuda": probe(dist, torch, "cuda:0", rank, world), "cpu": probe(dist, torch, "cpu", rank, world)}
    if rank == 0:
        print("gloo, two ranks on cuda:0: " + json.dumps(result), flush=True)
    dist.destroy_process_group()


def main() -> int:
    if len(sys.argv) == 4:
        rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
        return 0
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("torch_collectives_probe: no card", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "store")
        procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", store]) for r in range(2)]
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=300))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append("timeout")
        print(f"gloo ranks exited {rcs}", flush=True)
        dist.init_process_group("nccl", store=dist.FileStore(str(Path(tmp) / "nccl"), 1), rank=0,
                                world_size=1, device_id=torch.device("cuda:0"),
                                timeout=datetime.timedelta(seconds=60))
        print("nccl, one rank: " + json.dumps(probe(dist, torch, "cuda:0", 0, 1)), flush=True)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
